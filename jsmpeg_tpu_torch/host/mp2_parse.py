"""MP2 (MPEG-1 Audio Layer II) bitstream parser (host frontend).

Walks frame header / allocation / scfsi / scale factors / sample bits
(semantics of jsmpeg/src/mp2.js:77-344) and emits the dequantized
subband samples as a dense int32 tensor [36, 2, 32] (sub-block, channel,
subband) per frame.  All sample math is int32-exact; the polyphase
synthesis consuming these lives in ops/mp2_synth.py.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from .. import tables as T
from .bits import BitReader


@dataclass
class MP2Frame:
    samples: np.ndarray     # int32 [36, 2, 32]
    sample_rate: int
    frame_size: int         # bytes consumed from the frame start


class MP2Parser:
    """Incremental frame parser over an append-only byte buffer."""

    def __init__(self):
        self.bits = BitReader(capacity=1 << 18)
        self.sample_rate = 44100

    def write(self, data) -> None:
        self.bits.append(data)

    def parse_frame(self) -> Optional[MP2Frame]:
        """Parse one frame if fully buffered; advances exactly frame_size
        bytes from the frame start (reference: bits.index = (pos+size)<<3)."""
        bits = self.bits
        pos = bits.index >> 3
        if pos >= bits.byte_length:
            return None
        bits.index = pos << 3
        frame = self._decode(bits)
        if frame is None:
            return None
        bits.index = (pos + frame.frame_size) << 3
        self.sample_rate = frame.sample_rate
        return frame

    def _decode(self, bits: BitReader) -> Optional[MP2Frame]:
        start_byte = bits.index >> 3
        if not bits.has(48):
            return None
        if bits.read(11) != T.MP2_FRAME_SYNC:
            return None
        version = bits.read(2)
        layer = bits.read(2)
        has_crc = not bits.read(1)
        if version != 0x3 or layer != 0x2:
            return None
        bitrate_index = bits.read(4) - 1
        if bitrate_index > 13 or bitrate_index < 0:
            return None
        sample_rate_index = bits.read(2)
        if sample_rate_index == 3:
            return None
        padding = bits.read(1)
        bits.read(1)
        mode = bits.read(2)
        if mode == T.MP2_MODE_JOINT_STEREO:
            bound = (bits.read(2) + 1) << 2
        else:
            bits.skip(2)
            bound = 0 if mode == T.MP2_MODE_MONO else 32
        bits.skip(4)
        if has_crc:
            bits.skip(16)

        bitrate = T.MP2_BIT_RATE[bitrate_index]
        sample_rate = T.MP2_SAMPLE_RATE[sample_rate_index]
        frame_size = 144000 * bitrate // sample_rate + padding
        # whole frame must be buffered before we commit to parsing it
        if bits.byte_length - start_byte < frame_size:
            return None

        tab1 = 0 if mode == T.MP2_MODE_MONO else 1
        tab2 = T.MP2_QUANT_LUT_STEP_1[tab1][bitrate_index]
        tab3 = T.MP2_QUANT_LUT_STEP_2[tab2][sample_rate_index]
        sblimit = tab3 & 63
        tab3 >>= 6
        bound = min(bound, sblimit)
        channels = 1 if mode == T.MP2_MODE_MONO else 2

        def read_allocation(sb):
            tab4 = T.MP2_QUANT_LUT_STEP_3[tab3][sb]
            qtab = T.MP2_QUANT_LUT_STEP_4[tab4 & 15][bits.read(tab4 >> 4)]
            return T.MP2_QUANT_TAB[qtab - 1] if qtab else None

        alloc = [[None] * 32, [None] * 32]
        for sb in range(bound):
            alloc[0][sb] = read_allocation(sb)
            alloc[1][sb] = read_allocation(sb)
        for sb in range(bound, sblimit):
            alloc[0][sb] = alloc[1][sb] = read_allocation(sb)

        scfsi = [[0] * 32, [0] * 32]
        for sb in range(sblimit):
            for ch in range(channels):
                if alloc[ch][sb]:
                    scfsi[ch][sb] = bits.read(2)
            if mode == T.MP2_MODE_MONO:
                scfsi[1][sb] = scfsi[0][sb]

        # resolved scale factors (the (sf/3, sf%3) fixed-point form)
        sf_res = np.zeros((2, 32, 3), dtype=np.int64)
        for sb in range(sblimit):
            for ch in range(channels):
                if alloc[ch][sb]:
                    sel = scfsi[ch][sb]
                    if sel == 0:
                        raw = [bits.read(6), bits.read(6), bits.read(6)]
                    elif sel == 1:
                        a = bits.read(6)
                        raw = [a, a, bits.read(6)]
                    elif sel == 2:
                        a = bits.read(6)
                        raw = [a, a, a]
                    else:
                        a = bits.read(6)
                        b = bits.read(6)
                        raw = [a, b, b]
                    for part in range(3):
                        sf_res[ch, sb, part] = self._resolve_sf(raw[part])
            if mode == T.MP2_MODE_MONO:
                sf_res[1, sb] = sf_res[0, sb]

        samples = np.zeros((36, 2, 32), dtype=np.int32)
        for part in range(3):
            for granule in range(4):
                g = part * 4 + granule
                raw = np.zeros((2, 32, 3), dtype=np.int64)
                for sb in range(bound):
                    self._read_raw(bits, alloc[0][sb], raw[0, sb])
                    self._read_raw(bits, alloc[1][sb], raw[1, sb])
                for sb in range(bound, sblimit):
                    self._read_raw(bits, alloc[0][sb], raw[0, sb])
                    raw[1, sb] = raw[0, sb]
                # dequantize (exact int math).  For shared bands (sb >=
                # bound) the reference copies channel 0's POST-multiplied
                # samples to channel 1 -- channel 1's scale factor is read
                # from the stream but unused (src/mp2.js:224-229).
                for ch in range(2):
                    for sb in range(sblimit):
                        q = alloc[ch][sb]
                        if not q:
                            continue
                        if ch == 1 and sb >= bound:
                            samples[g * 3:g * 3 + 3, 1, sb] = \
                                samples[g * 3:g * 3 + 3, 0, sb]
                            continue
                        levels = q[0]
                        sf = int(sf_res[ch, sb, part])
                        scale = 65536 // (levels + 1)
                        adj = ((levels + 1) >> 1) - 1
                        for k in range(3):
                            val = (adj - int(raw[ch, sb, k])) * scale
                            samples[g * 3 + k, ch, sb] = (
                                (val * (sf >> 12) +
                                 ((val * (sf & 4095) + 2048) >> 12)) >> 12)
        return MP2Frame(samples, sample_rate, frame_size)

    @staticmethod
    def _resolve_sf(sf: int) -> int:
        if sf == 63:
            return 0
        shift = sf // 3
        return (T.MP2_SCALEFACTOR_BASE[sf % 3] + ((1 << shift) >> 1)) >> shift

    @staticmethod
    def _read_raw(bits: BitReader, q, out) -> None:
        if not q:
            out[:] = 0
            return
        levels, group, nbits = q
        if group:
            val = bits.read(nbits)
            out[0] = val % levels
            val //= levels
            out[1] = val % levels
            out[2] = val // levels
        else:
            out[0] = bits.read(nbits)
            out[1] = bits.read(nbits)
            out[2] = bits.read(nbits)

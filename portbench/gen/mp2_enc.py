"""Minimal MP2 (MPEG-1 Layer II) encoder: a frozen copy of the port's
`testing/mp2_enc.py`, the benchmark's audio source.

Emits legal frames with randomized allocation / scale factors / samples to
cover the decode paths: grouped and direct quantizers, scfsi share modes,
sf==63 quirk, mono / stereo / joint-stereo bounds.  Audio quality is not a
goal; legality and coverage are."""

from __future__ import annotations

import numpy as np

from .. import tables as T
from .bitwriter import BitWriter


def _nbal_row(tab3: int, sb: int):
    tab4 = T.MP2_QUANT_LUT_STEP_3[tab3][sb]
    return tab4 >> 4, tab4 & 15


def encode_frame(rng, bitrate_index: int = 13, sample_rate_index: int = 0,
                 mode: int = T.MP2_MODE_STEREO, density: float = 0.5,
                 sf_range: tuple = (0, 63)) -> bytes:
    """One MP2 frame. bitrate_index is the 0-based index into MP2_BIT_RATE
    (13 = 384 kbit/s)."""
    w = BitWriter()
    bitrate = T.MP2_BIT_RATE[bitrate_index]
    sample_rate = T.MP2_SAMPLE_RATE[sample_rate_index]
    padding = 0
    frame_size = 144000 * bitrate // sample_rate + padding

    w.write(T.MP2_FRAME_SYNC, 11)
    w.write(0x3, 2)                        # MPEG-1
    w.write(0x2, 2)                        # Layer II
    w.write(1, 1)                          # no CRC
    w.write(bitrate_index + 1, 4)
    w.write(sample_rate_index, 2)
    w.write(padding, 1)
    w.write(0, 1)                          # private
    w.write(mode, 2)
    mode_ext = int(rng.integers(0, 4))
    w.write(mode_ext, 2)
    w.write(0, 4)                          # copyright/original/emphasis

    if mode == T.MP2_MODE_JOINT_STEREO:
        bound = (mode_ext + 1) << 2
    else:
        bound = 0 if mode == T.MP2_MODE_MONO else 32

    tab1 = 0 if mode == T.MP2_MODE_MONO else 1
    tab2 = T.MP2_QUANT_LUT_STEP_1[tab1][bitrate_index]
    tab3 = T.MP2_QUANT_LUT_STEP_2[tab2][sample_rate_index] >> 6
    sblimit = T.MP2_QUANT_LUT_STEP_2[tab2][sample_rate_index] & 63
    if bound > sblimit:
        bound = sblimit
    channels = 1 if mode == T.MP2_MODE_MONO else 2

    # choose allocation indices, then shrink until the frame fits
    header_bits = w._nbits + len(w._out) * 8
    while True:
        alloc_idx = np.zeros((2, 32), dtype=np.int64)
        for sb in range(sblimit):
            nbal, row = _nbal_row(tab3, sb)
            hi = (1 << nbal)
            for ch in range(2 if sb < bound else 1):
                if rng.random() < density:
                    alloc_idx[ch, sb] = int(rng.integers(1, hi))
            if sb >= bound:
                alloc_idx[1, sb] = alloc_idx[0, sb]

        def spec(ch, sb):
            nbal, row = _nbal_row(tab3, sb)
            q = T.MP2_QUANT_LUT_STEP_4[row][alloc_idx[ch, sb]]
            return T.MP2_QUANT_TAB[q - 1] if q else None

        bits = 0
        for sb in range(sblimit):
            nbal, _ = _nbal_row(tab3, sb)
            bits += nbal * (2 if sb < bound else 1)
            for ch in range(channels):
                if spec(ch, sb):
                    bits += 2 + 18          # scfsi + up to 3 scale factors
        for g in range(12):
            for sb in range(sblimit):
                nch = 2 if sb < bound else 1
                for ch in range(nch):
                    s = spec(ch, sb)
                    if s:
                        bits += s[2] if s[1] else 3 * s[2]
        if header_bits + bits <= frame_size * 8 - 16:
            break
        density *= 0.6

    # allocation
    for sb in range(bound):
        nbal, _ = _nbal_row(tab3, sb)
        w.write(int(alloc_idx[0, sb]), nbal)
        w.write(int(alloc_idx[1, sb]), nbal)
    for sb in range(bound, sblimit):
        nbal, _ = _nbal_row(tab3, sb)
        w.write(int(alloc_idx[0, sb]), nbal)

    # scfsi
    scfsi = np.zeros((2, 32), dtype=np.int64)
    for sb in range(sblimit):
        for ch in range(channels):
            if spec(ch, sb):
                scfsi[ch, sb] = int(rng.integers(0, 4))
                w.write(int(scfsi[ch, sb]), 2)

    # scale factors (include the sf==63 quirk sometimes).  Full-range scale
    # factors drive the reference's int32 U accumulator into wraparound
    # (its ToInt32 per step) -- the exact path reproduces that, the float
    # device path cannot; pass a tamer sf_range (e.g. (20, 63)) for fixtures
    # meant to stay in the linear region like real audio does.
    lo, hi = sf_range

    def rand_sf():
        return 63 if rng.random() < 0.05 else int(rng.integers(lo, min(hi, 63)))

    for sb in range(sblimit):
        for ch in range(channels):
            if spec(ch, sb):
                sel = scfsi[ch, sb]
                n = {0: 3, 1: 2, 2: 1, 3: 2}[int(sel)]
                for _ in range(n):
                    w.write(rand_sf(), 6)

    # samples
    for part in range(3):
        for granule in range(4):
            for sb in range(sblimit):
                nch = 2 if sb < bound else 1
                for ch in range(nch):
                    s = spec(ch, sb)
                    if not s:
                        continue
                    levels, group, nbits = s
                    if group:
                        v = (int(rng.integers(0, levels)) +
                             levels * int(rng.integers(0, levels)) +
                             levels * levels * int(rng.integers(0, levels)))
                        w.write(v, nbits)
                    else:
                        for _ in range(3):
                            w.write(int(rng.integers(0, levels)), nbits)

    w.align()
    out = bytearray(w.getvalue())
    assert len(out) <= frame_size, (len(out), frame_size)
    out.extend(b'\x00' * (frame_size - len(out)))
    return bytes(out)


def encode_stream(n_frames: int, seed: int = 0, **kw) -> tuple[bytes, list[bytes]]:
    rng = np.random.default_rng(seed)
    frames = [encode_frame(rng, **kw) for _ in range(n_frames)]
    return b''.join(frames), frames

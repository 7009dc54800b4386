"""MPEG-1 video bitstream parser (host frontend, Python reference build).

This is the serial/branchy half of the TPU-native decoder: it walks the
sequence/picture/slice/macroblock/block layers (semantics of
jsmpeg/src/mpeg1.js:78-457,698-811 — re-implemented, not ported)
and emits **dense, fixed-shape per-frame tensors** that the device pipeline
(jsmpeg_tpu_torch/models/mpeg1.py) consumes:

  coef    int32 [n_mb, 6, 64]  premultiplied dequantized coefficients in
                               raster (de-zigzagged) order.  For blocks that
                               took the reference's DC-only fast path the
                               array holds only the DC term, which is
                               IDCT-identical to the fast fill.
  coded   bool  [n_mb, 6]      block residual present
  intra   bool  [n_mb]         macroblock is intra (residual overwrites)
  written bool  [n_mb]         motion-compensated prediction write occurred
  mv      int32 [n_mb, 2]      (h, v) forward motion in luma half-pel units

Dequantization happens here (cheap scalar math interleaved with the VLC
walk) so that the reference's *persistent block-data* behaviour is exact:
its 64-entry coefficient scratch is only partially cleared on the DC-only
path (src/mpeg1.js:839-858), so a stale coefficient can leak into a later
block.  We reproduce that with the same persistent array.  A faster
device-side dequant path can be layered on when no leak occurs
(`self.quirk_leaks` counts occurrences).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from .. import tables as T
from .bits import BitReader


def _i32(x: int) -> int:
    """Reduce to int32 two's complement (JS ToInt32 / C int32 store)."""
    x &= 0xFFFFFFFF
    return x - 0x100000000 if x >= 0x80000000 else x


@dataclass
class SequenceInfo:
    width: int
    height: int
    mb_width: int
    mb_height: int
    frame_rate: float
    intra_quant_matrix: np.ndarray
    non_intra_quant_matrix: np.ndarray

    @property
    def mb_size(self) -> int:
        return self.mb_width * self.mb_height

    @property
    def coded_width(self) -> int:
        return self.mb_width << 4

    @property
    def coded_height(self) -> int:
        return self.mb_height << 4


@dataclass
class FrameData:
    """Dense per-frame tensors (host -> device contract)."""
    pic_type: int
    coef: np.ndarray      # int32 [n_mb, 6, 64]
    coded: np.ndarray     # bool  [n_mb, 6]
    intra: np.ndarray     # bool  [n_mb]
    written: np.ndarray   # bool  [n_mb]
    mv: np.ndarray        # int32 [n_mb, 2]  (h, v)


_BOUNDARY_CODES = (T.START_PICTURE, T.START_SEQUENCE, T.START_GROUP,
                   T.START_SEQUENCE_END)


class MPEG1Parser:
    """Incremental picture parser over an append-only byte buffer."""

    def __init__(self):
        self.bits = BitReader(capacity=1 << 20)
        self.seq: Optional[SequenceInfo] = None
        self._block_data = [0] * 64   # persistent scratch (quirk-exact)
        self.quirk_leaks = 0          # DC-only fast paths with run>0 coeff
        self.frames_parsed = 0
        # picture-layer state
        self._qscale = 0
        self._pic_type = 0
        self._full_pel = False
        self._fw_f = 0
        self._fw_r_size = 0

    # ------------------------------------------------------------------ I/O

    def write(self, data) -> None:
        self.bits.append(data)
        if self.seq is None:
            self._try_sequence_header()

    @property
    def has_sequence_header(self) -> bool:
        return self.seq is not None

    def _try_sequence_header(self) -> None:
        saved = self.bits.index
        if self.bits.find_start_code(T.START_SEQUENCE) == -1 or \
                not self._sequence_header_buffered():
            # decode the header only once all of it is buffered: jsmpeg
            # (and jsmpeg_tpu) decode a header split across writes from
            # the zero pad past the buffered bytes
            self.bits.index = saved
            return
        self._decode_sequence_header()

    def _sequence_header_buffered(self) -> bool:
        """True when the sequence header after the start code at the
        bit index is buffered: 62 bits of fields, a flag, 512 bits of
        intra matrix if set, a flag, 512 bits of non-intra matrix if
        set."""
        bits = self.bits
        avail = (bits.byte_length << 3) - bits.index
        need = 63
        if avail < need:
            return False
        if bits.peek(need) & 1:
            need += 512
        need += 1
        if avail < need:
            return False
        if bits.peek(need) & 1:
            need += 512
        return avail >= need

    def _decode_sequence_header(self) -> None:
        bits = self.bits
        width = bits.read(12)
        height = bits.read(12)
        bits.skip(4)                       # pixel aspect ratio
        frame_rate = T.PICTURE_RATE[bits.read(4)]
        bits.skip(18 + 1 + 10 + 1)         # bitrate, marker, vbv size, const.

        intra_q = T.DEFAULT_INTRA_QUANT_MATRIX
        non_intra_q = T.DEFAULT_NON_INTRA_QUANT_MATRIX
        if bits.read(1):                   # load_intra_quantizer_matrix
            m = np.zeros(64, dtype=np.int32)
            for i in range(64):
                m[T.ZIG_ZAG[i]] = bits.read(8)
            intra_q = m
        if bits.read(1):                   # load_non_intra_quantizer_matrix
            m = np.zeros(64, dtype=np.int32)
            for i in range(64):
                m[T.ZIG_ZAG[i]] = bits.read(8)
            non_intra_q = m

        mb_w = (width + 15) >> 4
        mb_h = (height + 15) >> 4
        self.seq = SequenceInfo(width, height, mb_w, mb_h, frame_rate,
                                intra_q, non_intra_q)

    # --------------------------------------------------------------- frames

    def _picture_complete(self) -> bool:
        """True if a full picture (terminated by the next picture/sequence/
        group boundary code) is buffered after the current position."""
        b = self.bits.bytes
        n = self.bits.byte_length
        i = (self.bits.index + 7 >> 3)
        w = b[i:n]
        if len(w) < 8:
            return False
        starts = np.flatnonzero((w[:-3] == 0) & (w[1:-2] == 0) & (w[2:-1] == 1))
        codes = w[starts + 3] if starts.size else np.empty(0, dtype=np.uint8)
        # first start code must be a PICTURE (possibly preceded by seq/gop);
        # require at least one later boundary code to know the picture ended.
        seen_picture = False
        for c in codes:
            if not seen_picture:
                if c == T.START_PICTURE:
                    seen_picture = True
                continue
            if int(c) in _BOUNDARY_CODES:
                return True
        return False

    def seek_iframe(self) -> bool:
        """Advance to the next I-picture start code at or after the
        current bit position (GOP-aligned clean resume; the reference
        seeks to raw bytes and shows artifacts until the next I refresh,
        src/decoder.js:49-71).  Returns True if one was found."""
        bits = self.bits
        while True:
            code = bits.find_next_start_code()
            if code == -1:
                return False
            if code != T.START_PICTURE:
                continue
            saved = bits.index
            bits.skip(10)
            pic_type = bits.read(3) if bits.has(3) else 0
            bits.index = saved
            if pic_type == T.PIC_I:
                bits.rewind(32)
                return True

    def parse_frame(self, eof: bool = False) -> Optional[FrameData]:
        """Decode the next picture into dense tensors.

        Returns None when no complete picture is buffered (or, at eof, none
        remains).  B/D pictures and zero-f_code P pictures are consumed and
        skipped exactly like the reference (no output, no plane rotation).
        """
        if self.seq is None:
            return None
        while True:
            if not eof and not self._picture_complete():
                return None
            saved = self.bits.index
            if self.bits.find_start_code(T.START_PICTURE) == -1:
                self.bits.index = saved
                return None
            frame = self._decode_picture()
            if frame is not None:
                self.frames_parsed += 1
                return frame
            if eof and not self.bits.has(32):
                return None
            # skipped picture type: loop on to the next picture

    # ------------------------------------------------------ picture layer

    def _decode_picture(self) -> Optional[FrameData]:
        bits = self.bits
        seq = self.seq
        bits.skip(10)                       # temporal reference
        self._pic_type = bits.read(3)
        bits.skip(16)                       # vbv_delay

        if self._pic_type <= 0 or self._pic_type >= T.PIC_B:
            return None                     # skip B/D/unknown like reference

        if self._pic_type == T.PIC_P:
            self._full_pel = bool(bits.read(1))
            f_code = bits.read(3)
            if f_code == 0:
                return None                 # zero forward_f_code: skip
            self._fw_r_size = f_code - 1
            self._fw_f = 1 << self._fw_r_size

        n_mb = seq.mb_size
        self._coef = np.zeros((n_mb, 6, 64), dtype=np.int32)
        self._coded = np.zeros((n_mb, 6), dtype=bool)
        self._intra = np.zeros(n_mb, dtype=bool)
        self._written = np.zeros(n_mb, dtype=bool)
        self._mv = np.zeros((n_mb, 2), dtype=np.int32)

        code = bits.find_next_start_code()
        while code in (T.START_EXTENSION, T.START_USER_DATA):
            code = bits.find_next_start_code()

        while T.START_SLICE_FIRST <= code <= T.START_SLICE_LAST:
            self._decode_slice(code & 0xFF)
            code = bits.find_next_start_code()

        if code != -1:
            bits.rewind(32)   # let the caller's scan find it again

        return FrameData(self._pic_type, self._coef, self._coded,
                         self._intra, self._written, self._mv)

    # -------------------------------------------------------- slice layer

    def _decode_slice(self, slice_no: int) -> None:
        bits = self.bits
        self._slice_begin = True
        self._mb_address = (slice_no - 1) * self.seq.mb_width - 1

        self._motion_h = self._motion_h_prev = 0
        self._motion_v = self._motion_v_prev = 0
        self._dc_y = 128
        self._dc_cr = 128
        self._dc_cb = 128

        self._qscale = bits.read(5)
        while bits.read(1):                  # extra_information_slice
            bits.skip(8)

        while True:
            self._decode_macroblock()
            if bits.next_bytes_are_start_code():
                break

    # ---------------------------------------------------- macroblock layer

    def _vlc(self, table: T.VLCTable) -> int:
        return table.decode(self.bits.peek, self.bits.skip)

    def _decode_macroblock(self) -> None:
        seq = self.seq
        increment = 0
        t = self._vlc(T.VLC_MB_INCR)
        while t == 34:                       # stuffing
            t = self._vlc(T.VLC_MB_INCR)
        while t == 35:                       # escape
            increment += 33
            t = self._vlc(T.VLC_MB_INCR)
        increment += t

        if self._slice_begin:
            # first increment is relative to (slice_row-1) end
            self._slice_begin = False
            self._mb_address += increment
        else:
            if self._mb_address + increment >= seq.mb_size:
                return                       # illegal increment: bail
            if increment > 1:
                # skipped MBs reset DC predictors (and MVs in P pictures)
                self._dc_y = self._dc_cr = self._dc_cb = 128
                if self._pic_type == T.PIC_P:
                    self._motion_h = self._motion_h_prev = 0
                    self._motion_v = self._motion_v_prev = 0
            while increment > 1:
                self._mb_address += 1
                addr = self._mb_address
                if 0 <= addr < seq.mb_size:
                    self._written[addr] = True
                    self._mv[addr] = (self._motion_h, self._motion_v)
                increment -= 1
            self._mb_address += 1

        addr = self._mb_address
        in_range = 0 <= addr < seq.mb_size

        mb_type = self._vlc(T.VLC_MB_TYPE[self._pic_type])
        intra = bool(mb_type & T.MB_INTRA)
        mot_fw = bool(mb_type & T.MB_MOT_FW)

        if mb_type & T.MB_QUANT:
            self._qscale = self.bits.read(5)

        if intra:
            self._motion_h = self._motion_h_prev = 0
            self._motion_v = self._motion_v_prev = 0
            if in_range:
                self._intra[addr] = True
        else:
            self._dc_y = self._dc_cr = self._dc_cb = 128
            self._decode_motion_vectors(mot_fw)
            if in_range:
                self._written[addr] = True
                self._mv[addr] = (self._motion_h, self._motion_v)

        if mb_type & T.MB_PATTERN:
            cbp = self._vlc(T.VLC_CBP)
        else:
            cbp = 0x3F if intra else 0

        mask = 0x20
        for block in range(6):
            if cbp & mask:
                self._decode_block(block, intra, addr if in_range else -1)
            mask >>= 1

    def _decode_motion_vectors(self, mot_fw: bool) -> None:
        bits = self.bits
        if mot_fw:
            for axis in (0, 1):
                code = self._vlc(T.VLC_MOTION)
                if code != 0 and self._fw_f != 1:
                    r = bits.read(self._fw_r_size)
                    d = ((abs(code) - 1) << self._fw_r_size) + r + 1
                    if code < 0:
                        d = -d
                else:
                    d = code
                if axis == 0:
                    self._motion_h_prev += d
                    if self._motion_h_prev > (self._fw_f << 4) - 1:
                        self._motion_h_prev -= self._fw_f << 5
                    elif self._motion_h_prev < -(self._fw_f << 4):
                        self._motion_h_prev += self._fw_f << 5
                    self._motion_h = self._motion_h_prev
                    if self._full_pel:
                        self._motion_h <<= 1
                else:
                    self._motion_v_prev += d
                    if self._motion_v_prev > (self._fw_f << 4) - 1:
                        self._motion_v_prev -= self._fw_f << 5
                    elif self._motion_v_prev < -(self._fw_f << 4):
                        self._motion_v_prev += self._fw_f << 5
                    self._motion_v = self._motion_v_prev
                    if self._full_pel:
                        self._motion_v <<= 1
        elif self._pic_type == T.PIC_P:
            self._motion_h = self._motion_h_prev = 0
            self._motion_v = self._motion_v_prev = 0

    # -------------------------------------------------------- block layer

    def _decode_block(self, block: int, intra: bool, addr: int) -> None:
        bits = self.bits
        bd = self._block_data
        n = 0

        if intra:
            if block < 4:
                predictor = self._dc_y
                dct_size = self._vlc(T.VLC_DC_SIZE_LUMA)
            else:
                predictor = self._dc_cr if block == 4 else self._dc_cb
                dct_size = self._vlc(T.VLC_DC_SIZE_CHROMA)
            if dct_size > 0:
                differential = bits.read(dct_size)
                if differential & (1 << (dct_size - 1)):
                    bd[0] = predictor + differential
                else:
                    bd[0] = predictor + (_i32(-1 << dct_size) | (differential + 1))
            else:
                bd[0] = predictor
            if block < 4:
                self._dc_y = bd[0]
            elif block == 4:
                self._dc_cr = bd[0]
            else:
                self._dc_cb = bd[0]
            bd[0] = _i32(bd[0] << 8)          # dequant + premultiply (<<3+5)
            quant = self.seq.intra_quant_matrix
            n = 1
        else:
            quant = self.seq.non_intra_quant_matrix

        qscale = self._qscale
        zz = T.ZIG_ZAG
        premult = T.PREMULTIPLIER_MATRIX

        while True:
            packed = self._vlc(T.VLC_DCT_COEFF)
            if packed == 0x0001 and n > 0 and bits.read(1) == 0:
                break                          # end_of_block
            if packed == 0xFFFF:               # escape
                run = bits.read(6)
                level = bits.read(8)
                if level == 0:
                    level = bits.read(8)
                elif level == 128:
                    level = bits.read(8) - 256
                elif level > 128:
                    level = level - 256
            else:
                run = packed >> 8
                level = packed & 0xFF
                if bits.read(1):
                    level = -level

            n += run
            if n > 63:
                raise ValueError('dct coefficient run past end of block')
            dez = int(zz[n])
            n += 1

            level = level << 1
            if not intra:
                level += -1 if level < 0 else 1
            level = _i32((level * qscale * int(quant[dez])) >> 4)
            if (level & 1) == 0:
                level -= 1 if level > 0 else -1
            if level > 2047:
                level = 2047
            elif level < -2048:
                level = -2048
            bd[dez] = _i32(level * int(premult[dez]))

        if addr >= 0:
            self._coded[addr, block] = True
        if n == 1:
            # DC-only fast path: IDCT-equivalent is a pure-DC block.  Stale
            # coefficients (if the single coeff had run>0) stay in bd --
            # exactly the reference's partial clear.
            if addr >= 0:
                self._coef[addr, block, 0] = bd[0]
            if any(bd[1:]):
                # stale non-DC entries survive the fast path's partial clear
                self.quirk_leaks += 1
            bd[0] = 0
        else:
            if addr >= 0:
                self._coef[addr, block, :] = bd
            bd[:] = [0] * 64

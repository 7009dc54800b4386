"""Minimal MPEG-1 video encoder: a frozen copy of the port's
`testing/mpeg1_enc.py`, under the benchmark's stream generator.

Produces legal elementary streams with I and P pictures covering the decode
paths the framework must match bit-exactly: custom quant matrices, mid-slice
quantizer changes, skipped macroblocks, MV-only macroblocks, intra-in-P,
all four half-pel parities, AC escape codes, DC-only blocks.  Quality is
irrelevant; legality and coverage are the point.
"""

from __future__ import annotations

import numpy as np

from .. import tables as T
from .bitwriter import BitWriter

# inverted VLC maps: value -> bitstring
_INC_CODE = {v: k for k, v in T.MACROBLOCK_ADDRESS_INCREMENT.items()}
_TYPE_I_CODE = {v: k for k, v in T.MACROBLOCK_TYPE_I.items()}
_TYPE_P_CODE = {v: k for k, v in T.MACROBLOCK_TYPE_P.items()}
_CBP_CODE = {v: k for k, v in T.CODE_BLOCK_PATTERN.items()}
_MOTION_CODE = {v: k for k, v in T.MOTION.items()}
_DC_LUMA_CODE = {v: k for k, v in T.DCT_DC_SIZE_LUMINANCE.items()}
_DC_CHROMA_CODE = {v: k for k, v in T.DCT_DC_SIZE_CHROMINANCE.items()}
_COEFF_CODE = {v: k for k, v in T.DCT_COEFF.items()}

_RATE_CODE = {23.976: 1, 24.0: 2, 25.0: 3, 29.97: 4, 30.0: 5,
              50.0: 6, 59.94: 7, 60.0: 8}


def _fdct2(block: np.ndarray) -> np.ndarray:
    """Orthonormal-ish 2D DCT matching the decoder's scaling: the decoder's
    integer IDCT reconstructs pixel = sum c_i c_j /4 * coef * cos... with
    the premultiplier folded in.  We only need approximate levels, so use
    the standard DCT-II with the MPEG scale (output 'dequantized coefficient'
    domain where DC = 8 * mean)."""
    N = 8
    x = block.astype(np.float64)
    c = np.array([np.sqrt(0.5)] + [1.0] * 7)
    basis = np.cos((2 * np.arange(N)[None, :] + 1) * np.arange(N)[:, None]
                   * np.pi / (2 * N))
    coef = basis @ x @ basis.T
    coef = coef * np.outer(c, c) / 4.0
    return coef  # DC = 8*mean(block)


class MB:
    """Encoder-side macroblock description."""
    __slots__ = ('mode', 'mv', 'levels', 'qscale')

    def __init__(self, mode: str, mv=(0, 0), levels=None, qscale=None):
        self.mode = mode          # 'intra' | 'skip' | 'mc' | 'mc_coded'
        self.mv = mv              # absolute (h, v) half-pel
        self.levels = levels      # [6][64] int zig-zag-ordered levels or None
        self.qscale = qscale      # set to force a quantizer change


class MPEG1Encoder:
    def __init__(self, width: int, height: int, frame_rate: float = 25.0,
                 qscale: int = 8, f_code: int = 2,
                 intra_q: np.ndarray | None = None,
                 non_intra_q: np.ndarray | None = None):
        self.width = width
        self.height = height
        self.mb_w = (width + 15) >> 4
        self.mb_h = (height + 15) >> 4
        self.frame_rate = frame_rate
        self.qscale = qscale
        self.f_code = f_code
        self.intra_q = (T.DEFAULT_INTRA_QUANT_MATRIX if intra_q is None
                        else np.asarray(intra_q, dtype=np.int32))
        self.non_intra_q = (T.DEFAULT_NON_INTRA_QUANT_MATRIX
                            if non_intra_q is None
                            else np.asarray(non_intra_q, dtype=np.int32))
        self._custom_intra = intra_q is not None
        self._custom_non_intra = non_intra_q is not None
        self.w = BitWriter()
        self._temporal_ref = 0
        # (picture, slice row) of every slice whose last macroblock a
        # decoder following the reference leaves undecoded (_encode_slice)
        self.unvisited: list = []

    # ------------------------------------------------------------- headers

    def sequence_header(self) -> None:
        w = self.w
        w.start_code(T.START_SEQUENCE)
        w.write(self.width, 12)
        w.write(self.height, 12)
        w.write(1, 4)                       # pixel aspect: square
        w.write(_RATE_CODE[self.frame_rate], 4)
        w.write(0x3FFFF, 18)                # bit rate: variable
        w.write(1, 1)                       # marker
        w.write(0, 10)                      # vbv buffer size
        w.write(0, 1)                       # constrained flag
        w.write(1 if self._custom_intra else 0, 1)
        if self._custom_intra:
            for i in range(64):
                w.write(int(self.intra_q[T.ZIG_ZAG[i]]), 8)
        w.write(1 if self._custom_non_intra else 0, 1)
        if self._custom_non_intra:
            for i in range(64):
                w.write(int(self.non_intra_q[T.ZIG_ZAG[i]]), 8)

    def gop_header(self) -> None:
        w = self.w
        w.start_code(T.START_GROUP)
        w.write(0, 25)                      # time code
        w.write(1, 1)                       # closed gop
        w.write(0, 1)                       # broken link
        w.align()

    def sequence_end(self) -> None:
        self.w.start_code(T.START_SEQUENCE_END)

    def user_data(self, payload: bytes) -> None:
        """user_data segment (00 00 01 B2 ...); the payload must not
        contain start-code prefixes (callers pass nonzero bytes)."""
        w = self.w
        w.start_code(T.START_USER_DATA)
        for b in payload:
            assert b != 0, 'user data must not form start codes'
            w.write(b, 8)
        w.align()

    # ------------------------------------------------------------ pictures

    def encode_picture(self, pic_type: int, mbs: list[MB],
                       full_pel: bool = False,
                       stuffing_rng=None) -> None:
        """mbs: mb_w*mb_h MB objects in raster order.

        full_pel=True writes full_pel_forward=1: motion vectors transmit
        in full-pel units and the decoder doubles them at use (reference
        src/mpeg1.js:187-196,414-418) -- every MB.mv must be even.
        stuffing_rng sprinkles macroblock_stuffing codes (VLC 34, consumed
        and ignored by decoders) before address increments."""
        assert len(mbs) == self.mb_w * self.mb_h
        w = self.w
        w.start_code(T.START_PICTURE)
        w.write(self._temporal_ref & 0x3FF, 10)
        self._temporal_ref += 1
        w.write(pic_type, 3)
        w.write(0xFFFF, 16)                 # vbv_delay
        if pic_type == T.PIC_P:
            w.write(1 if full_pel else 0, 1)
            w.write(self.f_code, 3)
        w.align()

        for row in range(self.mb_h):
            self._encode_slice(row, pic_type,
                               mbs[row * self.mb_w:(row + 1) * self.mb_w],
                               full_pel=full_pel, stuffing_rng=stuffing_rng)

    def encode_skipped_picture(self, pic_type: int = T.PIC_B,
                               rng=None) -> None:
        """A B or D picture stub: decoders must skip it and continue at
        the next picture start code (reference src/mpeg1.js:182-184).
        The slice payload is arbitrary nonzero bytes (no start codes)."""
        w = self.w
        w.start_code(T.START_PICTURE)
        w.write(self._temporal_ref & 0x3FF, 10)
        self._temporal_ref += 1
        w.write(pic_type, 3)
        w.write(0xFFFF, 16)                 # vbv_delay
        if pic_type == T.PIC_B:
            w.write(0, 1)                   # full_pel_forward
            w.write(self.f_code, 3)
            w.write(0, 1)                   # full_pel_backward
            w.write(self.f_code, 3)
        elif pic_type == T.PIC_D:
            pass                            # D pictures: nothing extra here
        w.align()
        w.start_code(T.START_SLICE_FIRST)
        n = 24 if rng is None else int(rng.integers(8, 48))
        for i in range(n):
            w.write(0x55 + (i * 7) % 0xAA, 8)   # nonzero filler
        w.align()

    def _encode_slice(self, row: int, pic_type: int, mbs: list[MB],
                      full_pel: bool = False, stuffing_rng=None) -> None:
        w = self.w
        w.start_code(T.START_SLICE_FIRST + row)
        qscale = self.qscale
        w.write(qscale, 5)
        w.write(0, 1)                       # no extra information

        # state mirrored with the decoder
        dc_pred = [128, 128, 128]
        mv_prev = [0, 0]
        pending_skip = 0
        first = True

        for idx, mb in enumerate(mbs):
            if mb.mode == 'skip' and not first and idx != len(mbs) - 1:
                pending_skip += 1
                continue
            if idx == len(mbs) - 1:
                last_at = len(w._out) * 8 + w._nbits

            if stuffing_rng is not None and stuffing_rng.random() < 0.2:
                for _ in range(int(stuffing_rng.integers(1, 4))):
                    w.write_bits(_INC_CODE[34])     # macroblock_stuffing
            increment = pending_skip + 1
            pending_skip = 0
            while increment > 33:
                w.write_bits(_INC_CODE[35])     # escape
                increment -= 33
            w.write_bits(_INC_CODE[increment])

            if increment > 1:
                dc_pred = [128, 128, 128]
                if pic_type == T.PIC_P:
                    mv_prev = [0, 0]

            force_q = mb.qscale is not None and mb.qscale != qscale
            if mb.mode == 'intra':
                code = 0x11 if force_q else 0x01
                table = _TYPE_I_CODE if pic_type == T.PIC_I else _TYPE_P_CODE
                w.write_bits(table[code])
                if force_q:
                    qscale = mb.qscale
                    w.write(qscale, 5)
                mv_prev = [0, 0]
                dc_pred = self._encode_intra_blocks(mb.levels, dc_pred)
            else:
                assert pic_type == T.PIC_P
                has_coef = (mb.mode == 'mc_coded' and mb.levels is not None
                            and any(np.any(np.asarray(l)) for l in mb.levels))
                if has_coef:
                    code = (0x1A if force_q else 0x0A)
                else:
                    code = 0x08
                    force_q = False
                w.write_bits(_TYPE_P_CODE[code])
                if force_q:
                    qscale = mb.qscale
                    w.write(qscale, 5)
                if full_pel:
                    # transmit in full-pel units; the decoder's predictor
                    # lives in transmitted units and doubles at use
                    assert mb.mv[0] % 2 == 0 and mb.mv[1] % 2 == 0, mb.mv
                    self._encode_motion((mb.mv[0] >> 1, mb.mv[1] >> 1),
                                        mv_prev)
                else:
                    self._encode_motion(mb.mv, mv_prev)
                dc_pred = [128, 128, 128]
                if has_coef:
                    cbp = 0
                    for b in range(6):
                        if np.any(np.asarray(mb.levels[b])):
                            cbp |= 0x20 >> b
                    w.write_bits(_CBP_CODE[cbp])
                    for b in range(6):
                        if cbp & (0x20 >> b):
                            self._encode_nonintra_block(mb.levels[b])
            first = False
        end = len(w._out) * 8 + w._nbits
        if len(mbs) > 1 and (last_at + 7) >> 3 == (end + 7) >> 3:
            # the slice's last macroblock ends inside the byte where the
            # one before it ended: a decoder that stops a slice where the
            # next aligned bytes are a start code (the jsmpeg reference,
            # src/mpeg1.js decodeSlice) never decodes it
            self.unvisited.append((self._temporal_ref - 1, row))
        w.align()

    # ------------------------------------------------------------- blocks

    def _encode_intra_blocks(self, levels, dc_pred):
        """levels: [6][64] zig-zag-ordered; levels[b][0] is the absolute DC."""
        w = self.w
        for b in range(6):
            lv = np.asarray(levels[b], dtype=np.int64)
            pi = 0 if b < 4 else (1 if b == 4 else 2)
            dc = int(lv[0])
            diff = dc - dc_pred[pi]
            assert -255 <= diff <= 255
            dc_pred[pi] = dc
            size = diff.bit_length() if diff else 0
            code_table = _DC_LUMA_CODE if b < 4 else _DC_CHROMA_CODE
            w.write_bits(code_table[size])
            if size > 0:
                if diff > 0:
                    w.write(diff, size)
                else:
                    w.write(((1 << size) - 1) + diff, size)
            self._encode_ac(lv, start=1, first_coeff=False)
            w.write_bits('10')              # end of block
        return dc_pred

    def _encode_nonintra_block(self, levels) -> None:
        lv = np.asarray(levels, dtype=np.int64)
        self._encode_ac(lv, start=0, first_coeff=True)
        self.w.write_bits('10')             # end of block

    def _encode_ac(self, lv: np.ndarray, start: int, first_coeff: bool) -> None:
        w = self.w
        run = 0
        first = first_coeff
        for n in range(start, 64):
            level = int(lv[n])
            if level == 0:
                run += 1
                continue
            alevel = abs(level)
            key = (run, alevel)
            if key in _COEFF_CODE and alevel <= 255:
                code = _COEFF_CODE[key]
                if code == '1' and not first:
                    code = '11'
                w.write_bits(code)
                w.write(1 if level < 0 else 0, 1)
            else:
                assert -255 <= level <= 255 and level != 0
                w.write_bits(T.DCT_COEFF_ESCAPE)
                w.write(run, 6)
                if 1 <= level <= 127:
                    w.write(level, 8)
                elif -127 <= level <= -1:
                    w.write(level + 256, 8)
                elif 128 <= level <= 255:
                    w.write(0, 8)
                    w.write(level, 8)
                else:                        # -255..-128
                    w.write(128, 8)
                    w.write(level + 256, 8)
            run = 0
            first = False

    def _encode_motion(self, mv, mv_prev) -> None:
        f = 1 << (self.f_code - 1)
        for axis in (0, 1):
            d = mv[axis] - mv_prev[axis]
            # exploit the decoder's wraparound to bring d into range
            if d > (f << 4) - 1:
                d -= f << 5
            elif d < -(f << 4):
                d += f << 5
            assert -(f << 4) <= d <= (f << 4) - 1
            if f == 1:
                code, r = d, 0
            else:
                if d == 0:
                    code, r = 0, 0
                else:
                    mag = abs(d) - 1
                    code = (mag >> (self.f_code - 1)) + 1
                    r = mag & (f - 1)
                    if d < 0:
                        code = -code
            self.w.write_bits(_MOTION_CODE[code])
            if code != 0 and f != 1:
                self.w.write(r, self.f_code - 1)
            # replicate the decoder's predictor update incl. wraparound
            mv_prev[axis] += d
            if mv_prev[axis] > (f << 4) - 1:
                mv_prev[axis] -= f << 5
            elif mv_prev[axis] < -(f << 4):
                mv_prev[axis] += f << 5

    def getvalue(self) -> bytes:
        return self.w.getvalue()


# ---------------------------------------------------------------------------
# Level generation helpers: turn images into plausible quantized levels
# ---------------------------------------------------------------------------

def quantize_intra(block: np.ndarray, qscale: int,
                   quant: np.ndarray) -> np.ndarray:
    """Return 64 zig-zag-ordered intra levels for an 8x8 pixel block."""
    coef = _fdct2(block)                    # raster order, DC = 8*mean
    out = np.zeros(64, dtype=np.int64)
    dc = int(np.clip(round(coef[0, 0] / 8.0), 1, 255))
    out[0] = dc
    flat = coef.reshape(64)
    for n in range(1, 64):
        r = int(T.ZIG_ZAG[n])
        denom = qscale * int(quant[r])
        level = int(round(flat[r] * 8.0 / denom)) if denom else 0
        out[n] = int(np.clip(level, -255, 255))
    return out


def quantize_nonintra(residual: np.ndarray, qscale: int,
                      quant: np.ndarray) -> np.ndarray:
    """Return 64 zig-zag-ordered non-intra levels for an 8x8 residual."""
    coef = _fdct2(residual + 128.0)          # recentre: fdct DC=8*mean
    coef[0, 0] -= 8 * 128.0
    out = np.zeros(64, dtype=np.int64)
    flat = coef.reshape(64)
    for n in range(64):
        r = int(T.ZIG_ZAG[n])
        denom = qscale * int(quant[r])
        level = int(round(flat[r] * 8.0 / denom)) if denom else 0
        out[n] = int(np.clip(level, -255, 255))
    return out

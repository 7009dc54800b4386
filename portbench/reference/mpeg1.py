"""The plain reference MPEG-1 video decoder of the benchmark: plain Python
and NumPy, importing nothing of the program.

A frozen copy of the repository's test oracle `tests/oracle/ref_mpeg1.py`
(an independent re-implementation of the jsmpeg reference's exact integer
semantics, jsmpeg/src/mpeg1.js), made fast enough to run after every
benchmark window:

- the bitstream is read through lookup tables (one peek and one table
  index per variable-length code) in place of the oracle's bit-at-a-time
  tree walks;
- a picture's motion compensation and its blocks' IDCTs run after its
  slices are parsed, vectorised over the picture.  Each macroblock of a
  picture is visited once, so its prediction (read from the forward
  picture only) and its blocks (each on its own 8x8 region) do not depend
  on the order of the others; a picture that visits a macroblock twice is
  applied in stream order, as the oracle does.

The arithmetic is the oracle's, operation for operation: the dequantiser
on Python integers with its int32 reductions, the fixed-point IDCT with
ToInt32 at its shifts, the half-pel averages and the clamps.  The decoder
also counts, per picture, the work the program's kernels must do for it
(`PictureWork`).
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np

from .. import tables as T

MASK32 = 0xFFFFFFFF


def i32(x: int) -> int:
    x &= MASK32
    return x - 0x100000000 if x >= 0x80000000 else x


def _table(codes: dict):
    """{bitstring: value} -> (bits, [(value, length)] indexed by the next
    `bits` bits of the stream)."""
    bits = max(len(k) for k in codes)
    tab = [None] * (1 << bits)
    for code, val in codes.items():
        n = len(code)
        base = int(code, 2) << (bits - n)
        for k in range(1 << (bits - n)):
            tab[base + k] = (val, n)
    return bits, tab


_TABLES = {
    'inc': _table(T.MACROBLOCK_ADDRESS_INCREMENT),
    'type_i': _table(T.MACROBLOCK_TYPE_I),
    'type_p': _table(T.MACROBLOCK_TYPE_P),
    'cbp': _table(T.CODE_BLOCK_PATTERN),
    'motion': _table(T.MOTION),
    'dc_luma': _table(T.DCT_DC_SIZE_LUMINANCE),
    'dc_chroma': _table(T.DCT_DC_SIZE_CHROMINANCE),
    'coeff': _table({**{k: (v[0] << 8) | v[1]
                        for k, v in T.DCT_COEFF.items()},
                     T.DCT_COEFF_ESCAPE: 0xFFFF}),
}
_ZZ = [int(v) for v in T.ZIG_ZAG]
_PREMUL = [int(v) for v in T.PREMULTIPLIER_MATRIX]


class Bits:
    """Big-endian bit reader; reads past the end give zero bits."""

    def __init__(self, data: bytes):
        self.d = bytes(data) + bytes(8)
        self.n = len(data)
        self.i = 0   # bit index

    def read(self, count: int) -> int:
        if count == 0:
            return 0
        i = self.i
        j = i >> 3
        w = int.from_bytes(self.d[j:j + 5], 'big')
        self.i = i + count
        return (w >> (40 - (i & 7) - count)) & ((1 << count) - 1)

    def skip(self, count: int) -> None:
        self.i += count

    def rewind(self, count: int) -> None:
        self.i = max(self.i - count, 0)

    def vlc(self, table):
        bits, tab = table
        i = self.i
        j = i >> 3
        w = int.from_bytes(self.d[j:j + 4], 'big')
        val, n = tab[(w >> (32 - (i & 7) - bits)) & ((1 << bits) - 1)]
        self.i = i + n
        return val

    def next_bytes_are_start_code(self) -> bool:
        j = (self.i + 7) >> 3
        if j >= self.n:
            return True
        return (j + 2 < self.n and self.d[j] == 0 and self.d[j + 1] == 0
                and self.d[j + 2] == 1)

    def find_next_start_code(self) -> int:
        j = self.d.find(b'\x00\x00\x01', (self.i + 7) >> 3, self.n)
        if j < 0:
            self.i = self.n << 3
            return -1
        self.i = (j + 4) << 3
        return self.d[j + 3] if j + 3 < self.n else 0

    def find_start_code(self, code: int) -> int:
        while True:
            c = self.find_next_start_code()
            if c == code or c == -1:
                return c


class PictureWork(NamedTuple):
    """What one decoded picture asks of the program's kernels, counted
    from the stream: coded blocks, their non-zero levels (an intra DC of
    value 0 is not one), macroblocks with a coded block, coded blocks of
    intra macroblocks, and macroblocks whose prediction is written from
    the forward picture (skipped or motion-compensated)."""
    coded_blocks: int
    nonzero_levels: int
    coded_mbs: int
    intra_coded_blocks: int
    written_mbs: int


class ReferenceMPEG1:
    """Decode a whole elementary stream; call decode() repeatedly."""

    def __init__(self, data: bytes, idct=None):
        self.idct = idct or idct_int
        self.bits = Bits(data)
        self.has_seq = False
        self.work: List[PictureWork] = []
        if self.bits.find_start_code(T.START_SEQUENCE) != -1:
            self._sequence_header()

    def _sequence_header(self):
        b = self.bits
        self.width = b.read(12)
        self.height = b.read(12)
        b.skip(4)
        self.frame_rate = T.PICTURE_RATE[b.read(4)]
        b.skip(18 + 1 + 10 + 1)
        self.intra_q = [int(v) for v in T.DEFAULT_INTRA_QUANT_MATRIX]
        self.non_intra_q = [int(v) for v in T.DEFAULT_NON_INTRA_QUANT_MATRIX]
        if b.read(1):
            m = [0] * 64
            for i in range(64):
                m[_ZZ[i]] = b.read(8)
            self.intra_q = m
        if b.read(1):
            m = [0] * 64
            for i in range(64):
                m[_ZZ[i]] = b.read(8)
            self.non_intra_q = m
        self.mb_w = (self.width + 15) >> 4
        self.mb_h = (self.height + 15) >> 4
        self.mb_size = self.mb_w * self.mb_h
        self.cw = self.mb_w << 4
        self.ch = self.mb_h << 4
        z = lambda h, w: np.zeros((h, w), dtype=np.int64)
        self.cur = {'y': z(self.ch, self.cw),
                    'cr': z(self.ch >> 1, self.cw >> 1),
                    'cb': z(self.ch >> 1, self.cw >> 1)}
        self.fwd = {'y': z(self.ch, self.cw),
                    'cr': z(self.ch >> 1, self.cw >> 1),
                    'cb': z(self.ch >> 1, self.cw >> 1)}
        self.has_seq = True

    # ------------------------------------------------------------------

    def decode(self):
        """Decode the next picture.  Returns (y, cr, cb) uint8 copies, the
        string 'skipped' for consumed-but-not-rendered pictures, or None at
        end of stream."""
        if not self.has_seq:
            return None
        if self.bits.find_start_code(T.START_PICTURE) == -1:
            return None
        return self._picture()

    def decode_all(self):
        frames = []
        while True:
            out = self.decode()
            if out is None:
                return frames
            if out != 'skipped':
                frames.append(out)

    def _picture(self):
        b = self.bits
        b.skip(10)
        self.pic_type = b.read(3)
        b.skip(16)
        if self.pic_type <= 0 or self.pic_type >= T.PIC_B:
            return 'skipped'
        if self.pic_type == T.PIC_P:
            self.full_pel = b.read(1)
            f_code = b.read(3)
            if f_code == 0:
                return 'skipped'
            self.fw_r_size = f_code - 1
            self.fw_f = 1 << self.fw_r_size

        # the picture's operations in stream order: ('copy', addr, mh,
        # mv) and ('block', addr, block, intra, n, levels as {pos: value})
        self.ops = []
        self.nonzero = 0
        code = b.find_next_start_code()
        while code in (T.START_EXTENSION, T.START_USER_DATA):
            code = b.find_next_start_code()
        while T.START_SLICE_FIRST <= code <= T.START_SLICE_LAST:
            self._slice(code & 0xFF)
            code = b.find_next_start_code()
        if code != -1:
            b.rewind(32)
        self._apply(self.ops)
        self.work.append(self._count(self.ops))

        out = (self.cur['y'].astype(np.uint8),
               self.cur['cr'].astype(np.uint8),
               self.cur['cb'].astype(np.uint8))
        if self.pic_type in (T.PIC_I, T.PIC_P):
            self.cur, self.fwd = self.fwd, self.cur
        return out

    def _count(self, ops) -> PictureWork:
        blocks = [op for op in ops if op[0] == 'block']
        return PictureWork(
            coded_blocks=len(blocks), nonzero_levels=self.nonzero,
            coded_mbs=len({op[1] for op in blocks}),
            intra_coded_blocks=sum(1 for op in blocks if op[3]),
            written_mbs=sum(1 for op in ops if op[0] == 'copy'))

    def _slice(self, slice_no: int):
        b = self.bits
        self.slice_begin = True
        self.mb_addr = (slice_no - 1) * self.mb_w - 1
        self.mot_h = self.mot_h_prev = 0
        self.mot_v = self.mot_v_prev = 0
        self.dc_y = self.dc_cr = self.dc_cb = 128
        self.qscale = b.read(5)
        while b.read(1):
            b.skip(8)
        while True:
            self._macroblock()
            if b.next_bytes_are_start_code():
                break

    def _macroblock(self):
        b = self.bits
        increment = 0
        t = b.vlc(_TABLES['inc'])
        while t == 34:
            t = b.vlc(_TABLES['inc'])
        while t == 35:
            increment += 33
            t = b.vlc(_TABLES['inc'])
        increment += t

        if self.slice_begin:
            self.slice_begin = False
            self.mb_addr += increment
        else:
            if self.mb_addr + increment >= self.mb_size:
                return
            if increment > 1:
                self.dc_y = self.dc_cr = self.dc_cb = 128
                if self.pic_type == T.PIC_P:
                    self.mot_h = self.mot_h_prev = 0
                    self.mot_v = self.mot_v_prev = 0
            while increment > 1:
                self.mb_addr += 1
                self.ops.append(('copy', self.mb_addr, self.mot_h,
                                 self.mot_v))
                increment -= 1
            self.mb_addr += 1

        tree = (_TABLES['type_i'] if self.pic_type == T.PIC_I
                else _TABLES['type_p'])
        mb_type = b.vlc(tree)
        self.mb_intra = bool(mb_type & 0x01)
        mot_fw = bool(mb_type & 0x08)
        if mb_type & 0x10:
            self.qscale = b.read(5)

        if self.mb_intra:
            self.mot_h = self.mot_h_prev = 0
            self.mot_v = self.mot_v_prev = 0
        else:
            self.dc_y = self.dc_cr = self.dc_cb = 128
            self._motion_vectors(mot_fw)
            self.ops.append(('copy', self.mb_addr, self.mot_h, self.mot_v))

        if mb_type & 0x02:
            cbp = b.vlc(_TABLES['cbp'])
        else:
            cbp = 0x3F if self.mb_intra else 0

        mask = 0x20
        for block in range(6):
            if cbp & mask:
                self._block(block)
            mask >>= 1

    def _motion_vectors(self, mot_fw):
        b = self.bits
        if mot_fw:
            for axis in range(2):
                code = b.vlc(_TABLES['motion'])
                if code != 0 and self.fw_f != 1:
                    r = b.read(self.fw_r_size)
                    d = ((abs(code) - 1) << self.fw_r_size) + r + 1
                    if code < 0:
                        d = -d
                else:
                    d = code
                if axis == 0:
                    p = self.mot_h_prev + d
                    if p > (self.fw_f << 4) - 1:
                        p -= self.fw_f << 5
                    elif p < -(self.fw_f << 4):
                        p += self.fw_f << 5
                    self.mot_h_prev = p
                    self.mot_h = p << 1 if self.full_pel else p
                else:
                    p = self.mot_v_prev + d
                    if p > (self.fw_f << 4) - 1:
                        p -= self.fw_f << 5
                    elif p < -(self.fw_f << 4):
                        p += self.fw_f << 5
                    self.mot_v_prev = p
                    self.mot_v = p << 1 if self.full_pel else p
        elif self.pic_type == T.PIC_P:
            self.mot_h = self.mot_h_prev = 0
            self.mot_v = self.mot_v_prev = 0

    # --------------------------------------------------------- block layer

    def _block(self, block: int):
        b = self.bits
        bd = {}
        n = 0
        if self.mb_intra:
            if block < 4:
                predictor = self.dc_y
                size = b.vlc(_TABLES['dc_luma'])
            else:
                predictor = self.dc_cr if block == 4 else self.dc_cb
                size = b.vlc(_TABLES['dc_chroma'])
            if size > 0:
                diff = b.read(size)
                if diff & (1 << (size - 1)):
                    dc = predictor + diff
                else:
                    dc = predictor + (i32(-1 << size) | (diff + 1))
            else:
                dc = predictor
            if block < 4:
                self.dc_y = dc
            elif block == 4:
                self.dc_cr = dc
            else:
                self.dc_cb = dc
            if dc:
                self.nonzero += 1
            bd[0] = i32(dc << 8)
            quant = self.intra_q
            n = 1
        else:
            quant = self.non_intra_q

        coeff_table = _TABLES['coeff']
        intra = self.mb_intra
        qscale = self.qscale
        while True:
            coeff = b.vlc(coeff_table)
            if coeff == 0x0001 and n > 0 and b.read(1) == 0:
                break
            if coeff == 0xFFFF:
                run = b.read(6)
                level = b.read(8)
                if level == 0:
                    level = b.read(8)
                elif level == 128:
                    level = b.read(8) - 256
                elif level > 128:
                    level -= 256
            else:
                run = coeff >> 8
                level = coeff & 0xFF
                if b.read(1):
                    level = -level
            if level:
                self.nonzero += 1
            n += run
            dez = _ZZ[n]
            n += 1
            level <<= 1
            if not intra:
                level += -1 if level < 0 else 1
            level = i32(level * qscale * quant[dez]) >> 4
            if (level & 1) == 0:
                level -= 1 if level > 0 else -1
            level = min(max(level, -2048), 2047)
            bd[dez] = i32(level * _PREMUL[dez])
        self.ops.append(('block', self.mb_addr, block, intra, n, bd))

    # ------------------------------------------------- picture application

    def _apply(self, ops) -> None:
        addrs = [op[1] for op in ops if op[0] == 'copy']
        if len(set(addrs)) != len(addrs) or len(
                {op[1:3] for op in ops if op[0] == 'block'}) != sum(
                1 for op in ops if op[0] == 'block'):
            # a macroblock visited twice: one operation at a time, in order
            for op in ops:
                self._apply_ops([op])
            return
        self._apply_ops(ops)

    def _apply_ops(self, ops) -> None:
        copies = np.array([op[1:] for op in ops if op[0] == 'copy'],
                          dtype=np.int64).reshape(-1, 3)
        if len(copies):
            row, col = np.divmod(copies[:, 0], self.mb_w)
            mh, mv = copies[:, 1], copies[:, 2]
            _predict(self.fwd['y'], self.cur['y'], row << 4, col << 4, 16,
                     mh, mv)
            # truncate toward zero, like JS (x/2)|0
            ch = np.where(mh < 0, -((-mh) >> 1), mh >> 1)
            cv = np.where(mv < 0, -((-mv) >> 1), mv >> 1)
            for p in ('cr', 'cb'):
                _predict(self.fwd[p], self.cur[p], row << 3, col << 3, 8,
                         ch, cv)
        blocks = [op for op in ops if op[0] == 'block']
        if not blocks:
            return
        m = len(blocks)
        coef = np.zeros((m, 64), dtype=np.int64)
        for k, op in enumerate(blocks):
            for pos, v in op[5].items():
                coef[k, pos] = v
        addr = np.array([op[1] for op in blocks], dtype=np.int64)
        blk = np.array([op[2] for op in blocks], dtype=np.int64)
        intra = np.array([op[3] for op in blocks], dtype=bool)
        dc_only = np.array([op[4] == 1 for op in blocks], dtype=bool)
        row, col = np.divmod(addr, self.mb_w)
        pix = np.empty((m, 8, 8), dtype=np.int64)
        pix[dc_only] = ((coef[dc_only, 0] + 128) >> 8)[:, None, None]
        full = ~dc_only
        if full.any():
            pix[full] = self.idct(coef[full].reshape(-1, 8, 8))
        r8 = np.arange(8)
        for plane, sel, r0, c0 in (
                ('y', blk < 4, (row << 4) + np.where(blk & 2, 8, 0),
                 (col << 4) + np.where(blk & 1, 8, 0)),
                ('cb', blk == 4, row << 3, col << 3),
                ('cr', blk == 5, row << 3, col << 3)):
            if not sel.any():
                continue
            rr = (r0[sel][:, None] + r8)[:, :, None]
            cc = (c0[sel][:, None] + r8)[:, None, :]
            dest = self.cur[plane]
            add = np.where(intra[sel][:, None, None], 0, dest[rr, cc])
            dest[rr, cc] = np.clip(add + pix[sel], 0, 255)


def _predict(src: np.ndarray, dst: np.ndarray, dr: np.ndarray,
             dc: np.ndarray, size: int, motion_h: np.ndarray,
             motion_v: np.ndarray) -> None:
    """The oracle's `_copy_plane_block` for many blocks at once: each
    size x size block at (dr, dc) of `dst` predicted from `src` at the
    half-pel vector (motion_h, motion_v)."""
    h_pel, v_pel = motion_h >> 1, motion_v >> 1
    odd_h = ((motion_h & 1) == 1)[:, None, None]
    odd_v = ((motion_v & 1) == 1)[:, None, None]
    k = np.arange(size + 1)
    # a neighbour past the picture is read only by a parity that does
    # not use it: clamped, its value is never selected
    rr = np.clip((dr + v_pel)[:, None] + k, 0, src.shape[0] - 1)
    cc = np.clip((dc + h_pel)[:, None] + k, 0, src.shape[1] - 1)
    win = src[rr[:, :, None], cc[:, None, :]]
    a = win[:, :size, :size]
    b = win[:, :size, 1:]
    c = win[:, 1:, :size]
    d = win[:, 1:, 1:]
    out = np.where(odd_h & odd_v, (a + b + c + d + 2) >> 2,
                   np.where(odd_h, (a + b + 1) >> 1,
                            np.where(odd_v, (a + c + 1) >> 1, a)))
    k = np.arange(size)
    dst[(dr[:, None] + k)[:, :, None], (dc[:, None] + k)[:, None, :]] = out


def _wrap32(x: np.ndarray) -> np.ndarray:
    return ((x + 0x80000000) & MASK32) - 0x80000000


def _shr8_round(x: np.ndarray) -> np.ndarray:
    """(ToInt32(x) + 0) >> 8 on already +128'd input."""
    return _wrap32(x) >> 8


def idct_int(blk: np.ndarray) -> np.ndarray:
    """The reference's fixed-point 8x8 IDCT over [..., 8, 8] blocks,
    columns then rows, with JS ToInt32 reduction applied exactly at '>>'
    sites and Int32Array stores."""
    out = blk.astype(np.int64)

    for axis in (0, 1):
        # m[k]: row k (the column pass), then column k (the row pass)
        m = [out[..., k, :] if axis == 0 else out[..., :, k]
             for k in range(8)]
        b1 = m[4]
        b3 = m[2] + m[6]
        b4 = m[5] - m[3]
        tmp1 = m[1] + m[7]
        tmp2 = m[3] + m[5]
        b6 = m[1] - m[7]
        b7 = tmp1 + tmp2
        m0 = m[0]
        x4 = _shr8_round(b6 * 473 - b4 * 196 + 128) - b7
        x0 = x4 - _shr8_round((tmp1 - tmp2) * 362 + 128)
        x1 = m0 - b1
        x2 = _shr8_round((m[2] - m[6]) * 362 + 128) - b3
        x3 = m0 + b1
        y3 = x1 + x2
        y4 = x3 + b3
        y5 = x1 - x2
        y6 = x3 - b3
        y7 = -x0 - _shr8_round(b4 * 473 + b6 * 196 + 128)
        if axis == 0:
            rows = [b7 + y4, x4 + y3, y5 - x0, y6 - y7,
                    y6 + y7, x0 + y5, y3 - x4, y4 - b7]
            out = _wrap32(np.stack(rows, axis=-2))
        else:
            rows = [_wrap32(b7 + y4 + 128) >> 8,
                    _wrap32(x4 + y3 + 128) >> 8,
                    _wrap32(y5 - x0 + 128) >> 8,
                    _wrap32(y6 - y7 + 128) >> 8,
                    _wrap32(y6 + y7 + 128) >> 8,
                    _wrap32(x0 + y5 + 128) >> 8,
                    _wrap32(y3 - x4 + 128) >> 8,
                    _wrap32(y4 - b7 + 128) >> 8]
            out = _wrap32(np.stack(rows, axis=-1))
    return out


def idct_float32(blk: np.ndarray) -> np.ndarray:
    """The same butterflies in float32, each fixed-point product's
    shift a division and the output rounded to nearest: the IDCT one
    precision below the exact one, for the correctness control."""
    m = [x for x in np.moveaxis(blk.astype(np.float32), -2, 0)]
    f = np.float32

    def passes(m):
        b1, b3, b4 = m[4], m[2] + m[6], m[5] - m[3]
        tmp1, tmp2, b6 = m[1] + m[7], m[3] + m[5], m[1] - m[7]
        b7 = tmp1 + tmp2
        x4 = (b6 * f(473) - b4 * f(196)) / f(256) - b7
        x0 = x4 - (tmp1 - tmp2) * f(362) / f(256)
        x1, x3 = m[0] - b1, m[0] + b1
        x2 = (m[2] - m[6]) * f(362) / f(256) - b3
        y3, y4, y5, y6 = x1 + x2, x3 + b3, x1 - x2, x3 - b3
        y7 = -x0 - (b4 * f(473) + b6 * f(196)) / f(256)
        return [b7 + y4, x4 + y3, y5 - x0, y6 - y7,
                y6 + y7, x0 + y5, y3 - x4, y4 - b7]

    cols = np.stack(passes(m), axis=-2)         # [..., 8 rows, 8]
    rows = passes([cols[..., :, k] for k in range(8)])
    out = np.stack(rows, axis=-1) / f(256)
    return np.rint(out).astype(np.int64)

"""The plain reference MP2 (MPEG-1 Layer II) decoder: a frozen copy of the
repository's test oracle `tests/oracle/ref_mp2.py`.

Independent re-implementation of the reference decoder's exact arithmetic
(jsmpeg/src/mp2.js, itself kjmp2-derived): int32 sample dequant,
float64 matrixing stored to float32 V, int32-truncating windowed
accumulation, /2147418112 float32 output.  Used as the golden side of
differential tests.
"""

from __future__ import annotations

import numpy as np

from .. import tables as T

MASK32 = 0xFFFFFFFF


def to_i32(x: float) -> int:
    """JS ToInt32: truncate toward zero, wrap mod 2^32."""
    t = int(x)   # Python int() truncates toward zero
    t &= MASK32
    return t - 0x100000000 if t >= 0x80000000 else t


class Bits:
    def __init__(self, data: bytes):
        self.b = np.frombuffer(bytes(data), dtype=np.uint8)
        self.n = len(self.b)
        self.i = 0

    def read(self, count: int) -> int:
        v = 0
        for _ in range(count):
            byte = int(self.b[self.i >> 3]) if (self.i >> 3) < self.n else 0
            v = (v << 1) | ((byte >> (7 - (self.i & 7))) & 1)
            self.i += 1
        return v

    def skip(self, count: int) -> None:
        self.i += count


class OracleMP2:
    def __init__(self, data: bytes):
        self.data = bytes(data)
        self.pos = 0                     # byte position of next frame
        self.sample_rate = 44100
        self.V = [np.zeros(1024, dtype=np.float32),
                  np.zeros(1024, dtype=np.float32)]
        self.VPos = 0
        D = np.zeros(1024, dtype=np.float32)
        D[:512] = T.MP2_SYNTHESIS_WINDOW
        D[512:] = T.MP2_SYNTHESIS_WINDOW
        self.D = D
        self.allocation = [[None] * 32, [None] * 32]
        self.scfsi = [[0] * 32, [0] * 32]
        self.scale_factor = [[[0, 0, 0] for _ in range(32)] for _ in range(2)]
        self.sample = [[[0, 0, 0] for _ in range(32)] for _ in range(2)]

    def decode(self):
        """Decode the next frame; returns (left, right) float32[1152] or None."""
        if self.pos >= len(self.data):
            return None
        b = Bits(self.data[self.pos:])
        left = np.zeros(1152, dtype=np.float32)
        right = np.zeros(1152, dtype=np.float32)
        size = self._frame(b, left, right)
        if not size:
            return None
        self.pos += size
        return left, right

    def decode_all(self):
        out = []
        while True:
            f = self.decode()
            if f is None:
                return out
            out.append(f)

    def _read_allocation(self, b: Bits, sb: int, tab3: int):
        tab4 = T.MP2_QUANT_LUT_STEP_3[tab3][sb]
        qtab = T.MP2_QUANT_LUT_STEP_4[tab4 & 15][b.read(tab4 >> 4)]
        return T.MP2_QUANT_TAB[qtab - 1] if qtab else None

    def _frame(self, b: Bits, left, right) -> int:
        if b.read(11) != T.MP2_FRAME_SYNC:
            return 0
        version = b.read(2)
        layer = b.read(2)
        has_crc = not b.read(1)
        if version != 0x3 or layer != 0x2:
            return 0
        bitrate_index = b.read(4) - 1
        if bitrate_index > 13:
            return 0
        sample_rate_index = b.read(2)
        if sample_rate_index == 3:
            return 0
        padding = b.read(1)
        b.read(1)                          # private
        mode = b.read(2)
        if mode == T.MP2_MODE_JOINT_STEREO:
            bound = (b.read(2) + 1) << 2
        else:
            b.skip(2)
            bound = 0 if mode == T.MP2_MODE_MONO else 32
        b.skip(4)
        if has_crc:
            b.skip(16)

        bitrate = T.MP2_BIT_RATE[bitrate_index]
        sample_rate = T.MP2_SAMPLE_RATE[sample_rate_index]
        frame_size = (144000 * bitrate // sample_rate) + padding

        tab1 = 0 if mode == T.MP2_MODE_MONO else 1
        tab2 = T.MP2_QUANT_LUT_STEP_1[tab1][bitrate_index]
        tab3 = T.MP2_QUANT_LUT_STEP_2[tab2][sample_rate_index]
        sblimit = tab3 & 63
        tab3 >>= 6
        if bound > sblimit:
            bound = sblimit

        alloc = self.allocation
        for sb in range(bound):
            alloc[0][sb] = self._read_allocation(b, sb, tab3)
            alloc[1][sb] = self._read_allocation(b, sb, tab3)
        for sb in range(bound, sblimit):
            alloc[0][sb] = alloc[1][sb] = self._read_allocation(b, sb, tab3)

        channels = 1 if mode == T.MP2_MODE_MONO else 2
        for sb in range(sblimit):
            for ch in range(channels):
                if alloc[ch][sb]:
                    self.scfsi[ch][sb] = b.read(2)
            if mode == T.MP2_MODE_MONO:
                self.scfsi[1][sb] = self.scfsi[0][sb]

        for sb in range(sblimit):
            for ch in range(channels):
                if alloc[ch][sb]:
                    sf = self.scale_factor[ch][sb]
                    sel = self.scfsi[ch][sb]
                    if sel == 0:
                        sf[0] = b.read(6)
                        sf[1] = b.read(6)
                        sf[2] = b.read(6)
                    elif sel == 1:
                        sf[0] = sf[1] = b.read(6)
                        sf[2] = b.read(6)
                    elif sel == 2:
                        sf[0] = sf[1] = sf[2] = b.read(6)
                    else:
                        sf[0] = b.read(6)
                        sf[1] = sf[2] = b.read(6)
            if mode == T.MP2_MODE_MONO:
                self.scale_factor[1][sb] = list(self.scale_factor[0][sb])

        out_pos = 0
        for part in range(3):
            for granule in range(4):
                for sb in range(bound):
                    self._read_samples(b, 0, sb, part)
                    self._read_samples(b, 1, sb, part)
                for sb in range(bound, sblimit):
                    self._read_samples(b, 0, sb, part)
                    self.sample[1][sb] = list(self.sample[0][sb])
                for sb in range(sblimit, 32):
                    self.sample[0][sb] = [0, 0, 0]
                    self.sample[1][sb] = [0, 0, 0]
                for p in range(3):
                    self.VPos = (self.VPos - 64) & 1023
                    for ch in range(2):
                        self._matrix_transform(self.sample[ch], p,
                                               self.V[ch], self.VPos)
                        U = self._window(self.V[ch])
                        dest = left if ch == 0 else right
                        for j in range(32):
                            dest[out_pos + j] = np.float32(U[j] / 2147418112.0)
                    out_pos += 32
        self.sample_rate = sample_rate
        return frame_size

    def _read_samples(self, b: Bits, ch: int, sb: int, part: int):
        q = self.allocation[ch][sb]
        sf = self.scale_factor[ch][sb][part]
        sample = self.sample[ch][sb]
        if not q:
            sample[0] = sample[1] = sample[2] = 0
            return
        if sf == 63:
            sf = 0
        else:
            shift = sf // 3
            sf = (T.MP2_SCALEFACTOR_BASE[sf % 3] + ((1 << shift) >> 1)) >> shift
        levels, group, bits_n = q
        adj = levels
        if group:
            val = b.read(bits_n)
            sample[0] = val % adj
            val //= adj
            sample[1] = val % adj
            sample[2] = val // adj
        else:
            sample[0] = b.read(bits_n)
            sample[1] = b.read(bits_n)
            sample[2] = b.read(bits_n)
        scale = 65536 // (adj + 1)
        adj = ((adj + 1) >> 1) - 1
        for k in range(3):
            val = (adj - sample[k]) * scale
            sample[k] = (val * (sf >> 12) + ((val * (sf & 4095) + 2048) >> 12)) >> 12

    def _window(self, V: np.ndarray):
        """Windowed accumulation with per-step int32 truncation."""
        U = [0] * 32
        D = self.D
        d_index = 512 - (self.VPos >> 1)
        v_index = (self.VPos % 128) >> 1
        while v_index < 1024:
            for i in range(32):
                U[i] = to_i32(U[i] + float(D[d_index]) * float(V[v_index]))
                d_index += 1
                v_index += 1
            v_index += 128 - 32
            d_index += 64 - 32
        v_index = (128 - 32 + 1024) - v_index
        d_index -= (512 - 32)
        while v_index < 1024:
            for i in range(32):
                U[i] = to_i32(U[i] + float(D[d_index]) * float(V[v_index]))
                d_index += 1
                v_index += 1
            v_index += 128 - 32
            d_index += 64 - 32
        return U

    def _matrix_transform(self, s, ss, d, dp):
        t01 = s[0][ss] + s[31][ss]; t02 = (s[0][ss] - s[31][ss]) * 0.500602998235
        t03 = s[1][ss] + s[30][ss]; t04 = (s[1][ss] - s[30][ss]) * 0.505470959898
        t05 = s[2][ss] + s[29][ss]; t06 = (s[2][ss] - s[29][ss]) * 0.515447309923
        t07 = s[3][ss] + s[28][ss]; t08 = (s[3][ss] - s[28][ss]) * 0.53104259109
        t09 = s[4][ss] + s[27][ss]; t10 = (s[4][ss] - s[27][ss]) * 0.553103896034
        t11 = s[5][ss] + s[26][ss]; t12 = (s[5][ss] - s[26][ss]) * 0.582934968206
        t13 = s[6][ss] + s[25][ss]; t14 = (s[6][ss] - s[25][ss]) * 0.622504123036
        t15 = s[7][ss] + s[24][ss]; t16 = (s[7][ss] - s[24][ss]) * 0.674808341455
        t17 = s[8][ss] + s[23][ss]; t18 = (s[8][ss] - s[23][ss]) * 0.744536271002
        t19 = s[9][ss] + s[22][ss]; t20 = (s[9][ss] - s[22][ss]) * 0.839349645416
        t21 = s[10][ss] + s[21][ss]; t22 = (s[10][ss] - s[21][ss]) * 0.972568237862
        t23 = s[11][ss] + s[20][ss]; t24 = (s[11][ss] - s[20][ss]) * 1.16943993343
        t25 = s[12][ss] + s[19][ss]; t26 = (s[12][ss] - s[19][ss]) * 1.48416461631
        t27 = s[13][ss] + s[18][ss]; t28 = (s[13][ss] - s[18][ss]) * 2.05778100995
        t29 = s[14][ss] + s[17][ss]; t30 = (s[14][ss] - s[17][ss]) * 3.40760841847
        t31 = s[15][ss] + s[16][ss]; t32 = (s[15][ss] - s[16][ss]) * 10.1900081235
        t33 = t01 + t31; t31 = (t01 - t31) * 0.502419286188
        t01 = t03 + t29; t29 = (t03 - t29) * 0.52249861494
        t03 = t05 + t27; t27 = (t05 - t27) * 0.566944034816
        t05 = t07 + t25; t25 = (t07 - t25) * 0.64682178336
        t07 = t09 + t23; t23 = (t09 - t23) * 0.788154623451
        t09 = t11 + t21; t21 = (t11 - t21) * 1.06067768599
        t11 = t13 + t19; t19 = (t13 - t19) * 1.72244709824
        t13 = t15 + t17; t17 = (t15 - t17) * 5.10114861869
        t15 = t33 + t13; t13 = (t33 - t13) * 0.509795579104
        t33 = t01 + t11; t01 = (t01 - t11) * 0.601344886935
        t11 = t03 + t09; t09 = (t03 - t09) * 0.899976223136
        t03 = t05 + t07; t07 = (t05 - t07) * 2.56291544774
        t05 = t15 + t03; t15 = (t15 - t03) * 0.541196100146
        t03 = t33 + t11; t11 = (t33 - t11) * 1.30656296488
        t33 = t05 + t03; t05 = (t05 - t03) * 0.707106781187
        t03 = t15 + t11; t15 = (t15 - t11) * 0.707106781187
        t03 += t15
        t11 = t13 + t07; t13 = (t13 - t07) * 0.541196100146
        t07 = t01 + t09; t09 = (t01 - t09) * 1.30656296488
        t01 = t11 + t07; t07 = (t11 - t07) * 0.707106781187
        t11 = t13 + t09; t13 = (t13 - t09) * 0.707106781187
        t11 += t13; t01 += t11
        t11 += t07; t07 += t13
        t09 = t31 + t17; t31 = (t31 - t17) * 0.509795579104
        t17 = t29 + t19; t29 = (t29 - t19) * 0.601344886935
        t19 = t27 + t21; t21 = (t27 - t21) * 0.899976223136
        t27 = t25 + t23; t23 = (t25 - t23) * 2.56291544774
        t25 = t09 + t27; t09 = (t09 - t27) * 0.541196100146
        t27 = t17 + t19; t19 = (t17 - t19) * 1.30656296488
        t17 = t25 + t27; t27 = (t25 - t27) * 0.707106781187
        t25 = t09 + t19; t19 = (t09 - t19) * 0.707106781187
        t25 += t19
        t09 = t31 + t23; t31 = (t31 - t23) * 0.541196100146
        t23 = t29 + t21; t21 = (t29 - t21) * 1.30656296488
        t29 = t09 + t23; t23 = (t09 - t23) * 0.707106781187
        t09 = t31 + t21; t31 = (t31 - t21) * 0.707106781187
        t09 += t31; t29 += t09; t09 += t23; t23 += t31
        t17 += t29; t29 += t25; t25 += t09; t09 += t27
        t27 += t23; t23 += t19; t19 += t31
        t21 = t02 + t32; t02 = (t02 - t32) * 0.502419286188
        t32 = t04 + t30; t04 = (t04 - t30) * 0.52249861494
        t30 = t06 + t28; t28 = (t06 - t28) * 0.566944034816
        t06 = t08 + t26; t08 = (t08 - t26) * 0.64682178336
        t26 = t10 + t24; t10 = (t10 - t24) * 0.788154623451
        t24 = t12 + t22; t22 = (t12 - t22) * 1.06067768599
        t12 = t14 + t20; t20 = (t14 - t20) * 1.72244709824
        t14 = t16 + t18; t16 = (t16 - t18) * 5.10114861869
        t18 = t21 + t14; t14 = (t21 - t14) * 0.509795579104
        t21 = t32 + t12; t32 = (t32 - t12) * 0.601344886935
        t12 = t30 + t24; t24 = (t30 - t24) * 0.899976223136
        t30 = t06 + t26; t26 = (t06 - t26) * 2.56291544774
        t06 = t18 + t30; t18 = (t18 - t30) * 0.541196100146
        t30 = t21 + t12; t12 = (t21 - t12) * 1.30656296488
        t21 = t06 + t30; t30 = (t06 - t30) * 0.707106781187
        t06 = t18 + t12; t12 = (t18 - t12) * 0.707106781187
        t06 += t12
        t18 = t14 + t26; t26 = (t14 - t26) * 0.541196100146
        t14 = t32 + t24; t24 = (t32 - t24) * 1.30656296488
        t32 = t18 + t14; t14 = (t18 - t14) * 0.707106781187
        t18 = t26 + t24; t24 = (t26 - t24) * 0.707106781187
        t18 += t24; t32 += t18
        t18 += t14; t26 = t14 + t24
        t14 = t02 + t16; t02 = (t02 - t16) * 0.509795579104
        t16 = t04 + t20; t04 = (t04 - t20) * 0.601344886935
        t20 = t28 + t22; t22 = (t28 - t22) * 0.899976223136
        t28 = t08 + t10; t10 = (t08 - t10) * 2.56291544774
        t08 = t14 + t28; t14 = (t14 - t28) * 0.541196100146
        t28 = t16 + t20; t20 = (t16 - t20) * 1.30656296488
        t16 = t08 + t28; t28 = (t08 - t28) * 0.707106781187
        t08 = t14 + t20; t20 = (t14 - t20) * 0.707106781187
        t08 += t20
        t14 = t02 + t10; t02 = (t02 - t10) * 0.541196100146
        t10 = t04 + t22; t22 = (t04 - t22) * 1.30656296488
        t04 = t14 + t10; t10 = (t14 - t10) * 0.707106781187
        t14 = t02 + t22; t02 = (t02 - t22) * 0.707106781187
        t14 += t02; t04 += t14; t14 += t10; t10 += t02
        t16 += t04; t04 += t08; t08 += t14; t14 += t28
        t28 += t10; t10 += t20; t20 += t02; t21 += t16
        t16 += t32; t32 += t04; t04 += t06; t06 += t08
        t08 += t18; t18 += t14; t14 += t30; t30 += t28
        t28 += t26; t26 += t10; t10 += t12; t12 += t20
        t20 += t24; t24 += t02

        d[dp + 48] = np.float32(-t33)
        d[dp + 49] = d[dp + 47] = np.float32(-t21)
        d[dp + 50] = d[dp + 46] = np.float32(-t17)
        d[dp + 51] = d[dp + 45] = np.float32(-t16)
        d[dp + 52] = d[dp + 44] = np.float32(-t01)
        d[dp + 53] = d[dp + 43] = np.float32(-t32)
        d[dp + 54] = d[dp + 42] = np.float32(-t29)
        d[dp + 55] = d[dp + 41] = np.float32(-t04)
        d[dp + 56] = d[dp + 40] = np.float32(-t03)
        d[dp + 57] = d[dp + 39] = np.float32(-t06)
        d[dp + 58] = d[dp + 38] = np.float32(-t25)
        d[dp + 59] = d[dp + 37] = np.float32(-t08)
        d[dp + 60] = d[dp + 36] = np.float32(-t11)
        d[dp + 61] = d[dp + 35] = np.float32(-t18)
        d[dp + 62] = d[dp + 34] = np.float32(-t09)
        d[dp + 63] = d[dp + 33] = np.float32(-t14)
        d[dp + 32] = np.float32(-t05)
        d[dp + 0] = np.float32(t05); d[dp + 31] = np.float32(-t30)
        d[dp + 1] = np.float32(t30); d[dp + 30] = np.float32(-t27)
        d[dp + 2] = np.float32(t27); d[dp + 29] = np.float32(-t28)
        d[dp + 3] = np.float32(t28); d[dp + 28] = np.float32(-t07)
        d[dp + 4] = np.float32(t07); d[dp + 27] = np.float32(-t26)
        d[dp + 5] = np.float32(t26); d[dp + 26] = np.float32(-t23)
        d[dp + 6] = np.float32(t23); d[dp + 25] = np.float32(-t10)
        d[dp + 7] = np.float32(t10); d[dp + 24] = np.float32(-t15)
        d[dp + 8] = np.float32(t15); d[dp + 23] = np.float32(-t12)
        d[dp + 9] = np.float32(t12); d[dp + 22] = np.float32(-t19)
        d[dp + 10] = np.float32(t19); d[dp + 21] = np.float32(-t20)
        d[dp + 11] = np.float32(t20); d[dp + 20] = np.float32(-t13)
        d[dp + 12] = np.float32(t13); d[dp + 19] = np.float32(-t24)
        d[dp + 13] = np.float32(t24); d[dp + 18] = np.float32(-t31)
        d[dp + 14] = np.float32(t31); d[dp + 17] = np.float32(-t02)
        d[dp + 15] = np.float32(t02); d[dp + 16] = np.float32(0.0)

"""Spec-derived test vectors for the port: jsmpeg_tpu_torch's tables, the
`vlc_tables.h` that host/native/gen_tables.py generates from them for the
C++ frontend, and K1's plain integer IDCT (`ops.idct.idct_s32`), checked
against ISO/IEC 11172 and closed-form mathematics -- not against the
repo's oracle or the JAX package, which share an author with them.

The vectors are tests/test_spec_vectors.py's, function for function: the
standard's tables re-transcribed value -> code, the zig-zag as a diagonal
walk, the ideal float IDCT, scale factors as powers of 2^(1/3).  One more
test decodes every LUT of a freshly generated vlc_tables.h back to its
codes and holds it to the same vectors.
"""

from __future__ import annotations

import re

import numpy as np
import pytest

import torch

from jsmpeg_tpu_torch import tables as T
from jsmpeg_tpu_torch.host.native.gen_tables import generate
from jsmpeg_tpu_torch.ops.idct import idct_s32
from jsmpeg_tpu_torch.testing.spec import (IDCT_MAX_ERR, IDCT_MEAN_MAX_ERR,
                                           idct_errors, idct_vectors)


# ---------------------------------------------------------------------------
# Scan order & quant matrices (ISO 11172-2 2.4.3.2 / Fig. 2-D.6)
# ---------------------------------------------------------------------------

def test_zigzag_from_diagonal_walk():
    """Construct the zig-zag order algorithmically (anti-diagonal walk,
    alternating direction, starting up-right from (0,0)) and compare."""
    order = []
    for s in range(15):                       # anti-diagonal index i+j
        ij = [(i, s - i) for i in range(8) if 0 <= s - i < 8]
        if s % 2 == 0:                        # even diagonals run bottom-left
            ij.reverse()                      # ... to top-right
        order += [i * 8 + j for i, j in ij]
    assert order == list(T.ZIG_ZAG)


# Default intra quantizer matrix as TRANSMITTED (zig-zag order), the form
# the standard lists it in (ISO 11172-2 2.4.3.2) -- independent of the
# raster-order table, so this cross-checks the matrix AND the scan order.
_INTRA_Q_ZIGZAG_ORDER = [
    8, 16, 16, 19, 16, 19, 22, 22, 22, 22, 22, 22, 26, 24, 26, 27,
    27, 27, 26, 26, 26, 26, 27, 27, 27, 29, 29, 29, 34, 34, 34, 29,
    29, 29, 27, 27, 29, 29, 32, 32, 34, 34, 37, 38, 37, 35, 35, 34,
    35, 38, 38, 40, 40, 40, 48, 48, 46, 46, 56, 56, 58, 69, 69, 83,
]


def test_default_intra_quant_matrix_transmission_order():
    got = [int(T.DEFAULT_INTRA_QUANT_MATRIX[T.ZIG_ZAG[i]])
           for i in range(64)]
    assert got == _INTRA_Q_ZIGZAG_ORDER


def test_default_non_intra_quant_matrix():
    assert list(T.DEFAULT_NON_INTRA_QUANT_MATRIX) == [16] * 64


# ---------------------------------------------------------------------------
# VLC tables, transcribed value -> code from ISO 11172-2 Annex B
# ---------------------------------------------------------------------------

# Table B.1: increment -> code (plus stuffing/escape)
_B1 = {
    1: '1', 2: '011', 3: '010', 4: '0011', 5: '0010',
    6: '00011', 7: '00010', 8: '0000111', 9: '0000110',
    10: '00001011', 11: '00001010', 12: '00001001', 13: '00001000',
    14: '00000111', 15: '00000110',
    16: '0000010111', 17: '0000010110', 18: '0000010101',
    19: '0000010100', 20: '0000010011', 21: '0000010010',
    22: '00000100011', 23: '00000100010', 24: '00000100001',
    25: '00000100000', 26: '00000011111', 27: '00000011110',
    28: '00000011101', 29: '00000011100', 30: '00000011011',
    31: '00000011010', 32: '00000011001', 33: '00000011000',
}
_B1_STUFFING = '00000001111'
_B1_ESCAPE = '00000001000'


def test_macroblock_address_increment_full_table():
    inv = {v: k for k, v in T.MACROBLOCK_ADDRESS_INCREMENT.items()}
    for val, code in _B1.items():
        assert inv[val] == code, (val, inv.get(val), code)
    assert inv[34] == _B1_STUFFING     # macroblock_stuffing
    assert inv[35] == _B1_ESCAPE       # macroblock_escape
    assert len(T.MACROBLOCK_ADDRESS_INCREMENT) == 35


# Table B.2: macroblock_type as (quant, mot_fw, mot_bw, pattern, intra)
# flag tuples -> code, per picture type.
def _flags(quant=0, fw=0, bw=0, pat=0, intra=0):
    return (T.MB_QUANT * quant | T.MB_MOT_FW * fw | T.MB_MOT_BW * bw
            | T.MB_PATTERN * pat | T.MB_INTRA * intra)


_B2_I = {_flags(intra=1): '1', _flags(quant=1, intra=1): '01'}
_B2_P = {
    _flags(fw=1, pat=1): '1',
    _flags(pat=1): '01',
    _flags(fw=1): '001',
    _flags(intra=1): '00011',
    _flags(quant=1, fw=1, pat=1): '00010',
    _flags(quant=1, pat=1): '00001',
    _flags(quant=1, intra=1): '000001',
}
_B2_B = {
    _flags(fw=1, bw=1): '10',
    _flags(fw=1, bw=1, pat=1): '11',
    _flags(bw=1): '010',
    _flags(bw=1, pat=1): '011',
    _flags(fw=1): '0010',
    _flags(fw=1, pat=1): '0011',
    _flags(intra=1): '00011',
    _flags(quant=1, fw=1, bw=1, pat=1): '00010',
    _flags(quant=1, fw=1, pat=1): '000011',
    _flags(quant=1, bw=1, pat=1): '000010',
    _flags(quant=1, intra=1): '000001',
}


@pytest.mark.parametrize('spec,table', [
    (_B2_I, T.MACROBLOCK_TYPE_I),
    (_B2_P, T.MACROBLOCK_TYPE_P),
    (_B2_B, T.MACROBLOCK_TYPE_B),
])
def test_macroblock_type_tables(spec, table):
    inv = {v: k for k, v in table.items()}
    assert len(table) == len(spec)
    for flags, code in spec.items():
        assert inv[flags] == code, (bin(flags), inv.get(flags), code)


# Table B.4: motion_code.  Structure: '1' = 0; each magnitude's positive
# and negative codes differ only in the final (sign) bit, 0 = positive.
_B4_POSITIVE = {
    1: '010', 2: '0010', 3: '00010', 4: '0000110', 5: '00001010',
    6: '00001000', 7: '00000110', 8: '0000010110', 9: '0000010100',
    10: '0000010010', 11: '00000100010', 12: '00000100000',
    13: '00000011110', 14: '00000011100', 15: '00000011010',
    16: '00000011000',
}


def test_motion_code_full_table():
    inv = {v: k for k, v in T.MOTION.items()}
    assert inv[0] == '1'
    for mag, code in _B4_POSITIVE.items():
        assert code[-1] == '0'
        assert inv[mag] == code, (mag, inv.get(mag), code)
        assert inv[-mag] == code[:-1] + '1'   # sign bit flip
    assert len(T.MOTION) == 33


# Table B.3: coded_block_pattern spot vectors (cbp value -> code).  The
# pattern bit order: bit 5..0 = Y0 Y1 Y2 Y3 Cr Cb (mask 0x20 >> block).
_B3_SPOT = {
    60: '111', 4: '1101', 8: '1100', 16: '1011', 32: '1010',
    12: '10011', 48: '10010', 20: '10001', 40: '10000',
    28: '01111', 44: '01110', 52: '01101', 56: '01100',
    1: '01011', 61: '01010', 2: '01001', 62: '01000',
    24: '001111', 36: '001110', 3: '001101', 63: '001100',
    31: '000000111', 47: '000000110', 55: '000000101', 59: '000000100',
    27: '000000011', 39: '000000010',
}


def test_coded_block_pattern_spot_vectors():
    inv = {v: k for k, v in T.CODE_BLOCK_PATTERN.items()}
    for val, code in _B3_SPOT.items():
        assert inv[val] == code, (val, inv.get(val), code)
    # structural: all 63 non-zero patterns present exactly once (cbp 0 is
    # not in the table -- a coded macroblock has at least one coded block)
    assert sorted(T.CODE_BLOCK_PATTERN.values()) == list(range(1, 64))


# Tables B.5a/B.5b: dct_dc_size (complete)
_B5A_LUMA = {0: '100', 1: '00', 2: '01', 3: '101', 4: '110', 5: '1110',
             6: '11110', 7: '111110', 8: '1111110'}
_B5B_CHROMA = {0: '00', 1: '01', 2: '10', 3: '110', 4: '1110', 5: '11110',
               6: '111110', 7: '1111110', 8: '11111110'}


def test_dct_dc_size_tables():
    assert {v: k for k, v in T.DCT_DC_SIZE_LUMINANCE.items()} == _B5A_LUMA
    assert ({v: k for k, v in T.DCT_DC_SIZE_CHROMINANCE.items()}
            == _B5B_CHROMA)


# Table B.5c..f: dct_coeff spot vectors ((run, level) -> code, sign bit
# excluded) + structural checks.
_B5C_SPOT = {
    (0, 1): '1',            # dc_coeff_first; 'next' reads the 11/10 split
    (1, 1): '011',
    (0, 2): '0100',
    (2, 1): '0101',
    (0, 3): '00101',
    (3, 1): '00111',
    (4, 1): '00110',
    (1, 2): '000110',
    (5, 1): '000111',
    (6, 1): '000101',
    (7, 1): '000100',
    (0, 4): '0000110',
    (2, 2): '0000100',
    (8, 1): '0000111',
    (9, 1): '0000101',
    (0, 5): '00100110',
    (0, 6): '00100001',
    (1, 3): '00100101',
    (0, 7): '0000001010',
    (0, 8): '000000011101',
    (0, 16): '00000000011111',
    (0, 31): '00000000010000',
    (0, 40): '000000000010000',
    (1, 18): '0000000000010000',
    (31, 1): '0000000000011011',
}


def test_dct_coeff_spot_vectors_and_structure():
    inv = {v: k for k, v in T.DCT_COEFF.items()}
    for rl, code in _B5C_SPOT.items():
        assert inv[rl] == code, (rl, inv.get(rl), code)
    assert T.DCT_COEFF_ESCAPE == '000001'
    # structural: (run, level) pairs unique; the spec's 111 run/level
    # codes: runs 0/1 reach levels 40/18, runs 2..10 taper 5..2, runs
    # 11..16 carry levels 1-2, runs 17..31 level 1 only
    assert len(set(T.DCT_COEFF.values())) == len(T.DCT_COEFF) == 111
    by_run = {}
    for r, v in T.DCT_COEFF.values():
        by_run[r] = max(by_run.get(r, 0), v)
    assert by_run == {0: 40, 1: 18, 2: 5, 3: 4, 4: 3, 5: 3, 6: 3,
                      **{r: 2 for r in range(7, 17)},
                      **{r: 1 for r in range(17, 32)}}
    runs = [r for r, _ in T.DCT_COEFF.values()]
    levels = [v for _, v in T.DCT_COEFF.values()]
    assert max(runs) == 31 and max(levels) == 40
    # prefix-freeness incl. the escape code (VLCTable would also raise)
    codes = list(T.DCT_COEFF) + [T.DCT_COEFF_ESCAPE]
    for a in codes:
        for b in codes:
            assert a == b or not b.startswith(a)


# ---------------------------------------------------------------------------
# Integer IDCT vs the ideal float IDCT (closed-form, IEEE-1180 style)
# ---------------------------------------------------------------------------

def test_idct_matches_ideal_float_transform():
    """The fixed-point IDCT (constants 473/196/362, premultiplier table)
    must track the mathematical 2-D IDCT.  Measured on correct constants:
    mean per-block max error ~2.6, absolute max ~13 over this seed; a
    single mis-transcribed constant (473 -> 437) yields mean ~12 / max
    ~31, so the thresholds below discriminate transcription errors
    without requiring IEEE-1180 compliance the reference design never
    had.  The same 200 blocks go through K1 on the card in
    chip_smoke.py."""
    coefs, ideal = idct_vectors(T.PREMULTIPLIER_MATRIX)
    assert coefs.shape == (200, 8, 8)
    mean, worst = idct_errors(idct_s32(torch.as_tensor(coefs)).numpy(),
                              ideal)
    assert mean <= IDCT_MEAN_MAX_ERR == 4.0, mean
    assert worst <= IDCT_MAX_ERR == 20.0, worst


def test_premultiplier_closed_form():
    """PREMULTIPLIER[u, v] = round(64 * C(u) * C(v)), C(0) = 1/sqrt(2),
    C(k) = cos(k*pi/16) -- the scaled-IDCT normalization."""
    c = np.array([1.0 / np.sqrt(2.0)]
                 + [np.cos(k * np.pi / 16.0) for k in range(1, 8)])
    expect = np.round(64.0 * np.outer(c, c)).astype(np.int64).reshape(64)
    assert list(expect) == list(T.PREMULTIPLIER_MATRIX)


# ---------------------------------------------------------------------------
# MP2 tables vs ISO 11172-3 / closed forms
# ---------------------------------------------------------------------------

def test_mp2_sample_and_bit_rates():
    # Table 3-B.1 ordering: 44.1, 48, 32 kHz (then the MPEG-2 halves)
    assert T.MP2_SAMPLE_RATE[:4] == [44100, 48000, 32000, 0]
    assert T.MP2_BIT_RATE[:14] == [32, 48, 56, 64, 80, 96, 112, 128,
                                   160, 192, 224, 256, 320, 384]


def test_mp2_scalefactor_base_closed_form():
    """Scale factor base values are 2^(2-i/3) in 1.24 fixed point
    (scalefactor table 3-B.1: 2.0, 2^(2/3) = 1.5874.., 2^(1/3) =
    1.2599..), within 1 ulp of the closed form."""
    for i, v in enumerate(T.MP2_SCALEFACTOR_BASE):
        ideal = (1 << 24) * 2.0 * 2.0 ** (-i / 3.0)
        assert abs(v - ideal) <= 1.0, (i, v, ideal)


def test_mp2_quant_tab_closed_form():
    """Quantizer classes (Table 3-B.4): levels 3/5/9 are grouped (three
    samples share ceil(log2(levels^3)) bits); all other classes are
    2^n - 1 levels at n bits."""
    for levels, grouped, bits in T.MP2_QUANT_TAB:
        if grouped:
            assert levels in (3, 5, 9)
            assert bits == int(np.ceil(np.log2(float(levels) ** 3)))
        else:
            assert levels + 1 == 1 << bits
    assert [q[0] for q in T.MP2_QUANT_TAB] == [
        3, 5, 7, 9, 15, 31, 63, 127, 255, 511, 1023, 2047, 4095, 8191,
        16383, 32767, 65535]


def test_mp2_quant_lut_structure():
    """The kjmp2-style condensed LUT chain must preserve Table 3-B.2
    invariants: sblimits 27/30/8/12, nbal in {2,3,4} per subband range,
    and every step-4 row ends at quantizer 17 (65535 levels) except the
    full 16-entry row."""
    a, b, c, d = 27 | 64, 30 | 64, 8, 12
    assert T.MP2_QUANT_LUT_STEP_2[0] == [c, c, d]
    assert T.MP2_QUANT_LUT_STEP_2[1] == [a, a, a]
    assert T.MP2_QUANT_LUT_STEP_2[2] == [b, a, b]
    hi = T.MP2_QUANT_LUT_STEP_3[1]
    assert len(hi) == 30                      # table 3-B.2a/b sblimit
    assert [x >> 4 for x in hi] == [4] * 3 + [4] * 8 + [3] * 12 + [2] * 7
    for row in T.MP2_QUANT_LUT_STEP_4:
        assert row[0] == 0                    # allocation 0 = no samples
        assert row[-1] in (15, 17)


# ---------------------------------------------------------------------------
# The C++ frontend's generated header (host/native/gen_tables.py)
# ---------------------------------------------------------------------------

def _header_arrays(text: str) -> dict:
    """name -> list of the numbers of every `static const` array, and
    name_BITS -> int, from a generated vlc_tables.h."""
    out = {}
    for name, body in re.findall(
            r'static const \w+ (\w+)(?:\[\d+\])+ = \{(.*?)\};', text, re.S):
        out[name] = [float(v.rstrip('f')) if '.' in v or 'e' in v
                     else int(v)
                     for v in re.findall(r'-?[\d.]+(?:e-?\d+)?f?', body)]
    for name, v in re.findall(r'static const int (\w+_BITS) = (\d+);', text):
        out[name] = int(v)
    return out


def _lut_codes(arrays: dict, name: str) -> dict:
    """Decode a LUT back to {code: value}: entry (nbits << 24) | (value +
    0x800000) over every index whose top nbits are the code; 0 where no
    code starts."""
    bits, lut = arrays[name + '_BITS'], arrays[name]
    assert len(lut) == 1 << bits, name
    codes = {}
    for idx, e in enumerate(lut):
        if e == 0:
            continue
        n = e >> 24
        code = format(idx >> (bits - n), f'0{n}b')
        value = (e & 0xFFFFFF) - 0x800000
        assert codes.setdefault(code, value) == value, (name, code)
    # every index under a code holds it: the LUT is the code table exactly
    for code in codes:
        lo = int(code, 2) << (bits - len(code))
        assert len(set(lut[lo:lo + (1 << (bits - len(code)))])) == 1
    return codes


def test_generated_vlc_tables_header(tmp_path):
    """Every table the frontend compiles in, read back from a freshly
    generated vlc_tables.h: each VLC LUT decoded to its codes and held to
    the Annex B vectors above (whole tables where they are transcribed
    whole: B.1, B.2, B.4, B.5a/b; the spot vectors and the code count for
    B.3 and B.5c), the scan order, quant matrices and premultipliers to
    their constructions, the MP2 tables to their closed forms."""
    path = tmp_path / 'vlc_tables.h'
    generate(str(path))
    a = _header_arrays(path.read_text())

    incr = _lut_codes(a, 'VLC_MB_INCR')
    assert incr == {**{c: v for v, c in _B1.items()},
                    _B1_STUFFING: 34, _B1_ESCAPE: 35}
    for name, spec in (('VLC_MB_TYPE_I', _B2_I), ('VLC_MB_TYPE_P', _B2_P),
                       ('VLC_MB_TYPE_B', _B2_B)):
        assert _lut_codes(a, name) == {c: f for f, c in spec.items()}, name
    motion = {'1': 0}
    for mag, code in _B4_POSITIVE.items():
        motion[code] = mag
        motion[code[:-1] + '1'] = -mag
    assert _lut_codes(a, 'VLC_MOTION') == motion
    assert _lut_codes(a, 'VLC_DC_LUMA') == {c: v for v, c in
                                           _B5A_LUMA.items()}
    assert _lut_codes(a, 'VLC_DC_CHROMA') == {c: v for v, c in
                                             _B5B_CHROMA.items()}
    cbp = _lut_codes(a, 'VLC_CBP')
    assert sorted(cbp.values()) == list(range(1, 64))
    for val, code in _B3_SPOT.items():
        assert cbp[code] == val, (val, code)
    coeff = _lut_codes(a, 'VLC_DCT_COEFF')
    assert len(coeff) == 111 + 1 and coeff[T.DCT_COEFF_ESCAPE] == 0xFFFF
    for (run, level), code in _B5C_SPOT.items():
        assert coeff[code] == (run << 8) | level, ((run, level), code)

    walk = []
    for s in range(15):
        ij = [(i, s - i) for i in range(8) if 0 <= s - i < 8]
        walk += [i * 8 + j for i, j in (reversed(ij) if s % 2 == 0 else ij)]
    assert a['ZIG_ZAG'] == walk
    assert [a['DEFAULT_INTRA_Q'][walk[i]] for i in range(64)] == \
        _INTRA_Q_ZIGZAG_ORDER
    assert a['DEFAULT_NON_INTRA_Q'] == [16] * 64
    c = np.array([1.0 / np.sqrt(2.0)]
                 + [np.cos(k * np.pi / 16.0) for k in range(1, 8)])
    assert a['PREMULTIPLIER'] == list(
        np.round(64.0 * np.outer(c, c)).astype(np.int64).reshape(64))
    assert a['MP2_SAMPLE_RATE'][:4] == [44100, 48000, 32000, 0]
    assert a['MP2_BIT_RATE'][:14] == [32, 48, 56, 64, 80, 96, 112, 128,
                                      160, 192, 224, 256, 320, 384]
    for i, v in enumerate(a['MP2_SCALEFACTOR_BASE']):
        assert abs(v - (1 << 24) * 2.0 * 2.0 ** (-i / 3.0)) <= 1.0, i
    qtab = np.array(a['MP2_QTAB']).reshape(17, 3)
    for levels, grouped, bits in qtab:
        if grouped:
            assert bits == int(np.ceil(np.log2(float(levels) ** 3)))
        else:
            assert levels + 1 == 1 << bits

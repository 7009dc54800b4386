"""Generate vlc_tables.h for the C++ frontend from the canonical Python
tables (single source of truth: jsmpeg_tpu_torch/tables.py)."""

from __future__ import annotations

import os

import numpy as np

from ... import tables as T


def _emit_lut(name: str, table: T.VLCTable) -> str:
    vals = ', '.join(str(int(v)) for v in table.lookup)
    return (f'static const int {name}_BITS = {table.maxbits};\n'
            f'static const uint32_t {name}[{len(table.lookup)}] = {{{vals}}};\n')


def generate(path: str) -> None:
    zz = ', '.join(str(int(v)) for v in T.ZIG_ZAG)
    premult = ', '.join(str(int(v)) for v in T.PREMULTIPLIER_MATRIX)
    intra_q = ', '.join(str(int(v)) for v in T.DEFAULT_INTRA_QUANT_MATRIX)
    rates = ', '.join(f'{v}' for v in T.PICTURE_RATE)
    out = [
        '// GENERATED by gen_tables.py -- do not edit\n',
        '#pragma once\n#include <cstdint>\n',
        f'static const int32_t ZIG_ZAG[64] = {{{zz}}};\n',
        f'static const int32_t PREMULTIPLIER[64] = {{{premult}}};\n',
        f'static const int32_t DEFAULT_INTRA_Q[64] = {{{intra_q}}};\n',
        'static const int32_t DEFAULT_NON_INTRA_Q[64] = {'
        + ', '.join(['16'] * 64) + '};\n',
        f'static const double PICTURE_RATE[16] = {{{rates}}};\n',
        _emit_lut('VLC_MB_INCR', T.VLC_MB_INCR),
        _emit_lut('VLC_MB_TYPE_I', T.VLC_MB_TYPE[T.PIC_I]),
        _emit_lut('VLC_MB_TYPE_P', T.VLC_MB_TYPE[T.PIC_P]),
        _emit_lut('VLC_MB_TYPE_B', T.VLC_MB_TYPE[T.PIC_B]),
        _emit_lut('VLC_CBP', T.VLC_CBP),
        _emit_lut('VLC_MOTION', T.VLC_MOTION),
        _emit_lut('VLC_DC_LUMA', T.VLC_DC_SIZE_LUMA),
        _emit_lut('VLC_DC_CHROMA', T.VLC_DC_SIZE_CHROMA),
        _emit_lut('VLC_DCT_COEFF', T.VLC_DCT_COEFF),
    ]

    # ---- MP2 audio tables (same single source of truth) ----
    def _i32(name, vals):
        return (f'static const int32_t {name}[{len(vals)}] = {{'
                + ', '.join(str(int(v)) for v in vals) + '};\n')

    def _u8_2d(name, rows, width):
        body = ', '.join(
            '{' + ', '.join(str(int(v)) for v in
                            list(r) + [0] * (width - len(r))) + '}'
            for r in rows)
        return (f'static const uint8_t {name}[{len(rows)}][{width}] = '
                f'{{{body}}};\n')

    qtab_rows = [f'{{{l}, {g}, {b}}}' for (l, g, b) in T.MP2_QUANT_TAB]
    # the reference indexes the 512-tap window duplicated to 1024
    # (src/mp2.js:22-24); values are exact in float32
    d_dup = list(T.MP2_SYNTHESIS_WINDOW) * 2
    out += [
        _i32('MP2_SAMPLE_RATE', T.MP2_SAMPLE_RATE),
        _i32('MP2_BIT_RATE', T.MP2_BIT_RATE),
        _i32('MP2_SCALEFACTOR_BASE', T.MP2_SCALEFACTOR_BASE),
        _u8_2d('MP2_Q1', T.MP2_QUANT_LUT_STEP_1, 14),
        _u8_2d('MP2_Q2', T.MP2_QUANT_LUT_STEP_2, 3),
        _u8_2d('MP2_Q3', T.MP2_QUANT_LUT_STEP_3, 32),
        _u8_2d('MP2_Q4', T.MP2_QUANT_LUT_STEP_4, 16),
        'static const int32_t MP2_QTAB[17][3] = {'
        + ', '.join(qtab_rows) + '};\n',
        f'static const float MP2_D[1024] = {{'
        + ', '.join(f'{float(v)!r}f' for v in d_dup) + '};\n',
    ]
    with open(path, 'w') as f:
        f.write(''.join(out))


if __name__ == '__main__':
    from .build_native import BUILD_DIR
    os.makedirs(BUILD_DIR, exist_ok=True)
    generate(os.path.join(BUILD_DIR, 'vlc_tables.h'))
    print('vlc_tables.h written to', BUILD_DIR)

"""Halo sizing of the tile axis (host side, numpy): copies of
jsmpeg_tpu/parallel/tiles.py's helpers, so that the port decides on/off
mesh exactly as jsmpeg_tpu does (parallel/packed.py fits_mesh).

P-picture motion compensation reads the previous reference frame up to
+/- (forward_f << 4) half-pels away, so a macroblock-row band of a
picture needs that many rows of its neighbours' reference planes.  The
port's tile cells on one device cover the full picture and need none;
the banded decode across devices that uses the halo is ROADMAP item
A12b.
"""

from __future__ import annotations

import numpy as np


def halo_mb_rows(f_code: int) -> int:
    """MB rows of halo needed for a given forward_f_code: max MV reach is
    (1 << (f_code-1)) << 4 half-pels => `reach/2 (+1 for the half-pel tap)`
    pixels."""
    reach_px = ((1 << (f_code - 1)) << 4) // 2 + 1
    return -(-reach_px // 16)


def halo_mb_for_mvs(max_abs_mv: int) -> int:
    """MB rows of halo covering a batch's largest |MV| (half-pel units,
    post full-pel doubling, either axis: MPEG1 has one forward_f for
    both and a banded MC bounds columns with the same halo), rounded up
    to a power of two as jsmpeg_tpu does."""
    reach_px = ((max_abs_mv + 1) >> 1) + 1
    need = -(-reach_px // 16)
    b = 1
    while b < need:
        b <<= 1
    return b


def batch_max_abs_mv(frames) -> int:
    """max |mv component| over per-frame packed dicts / FrameData /
    LevelsArrays-style dicts (0 when no MVs)."""
    m = 0
    for f in frames:
        mv = f['run_mv'] if isinstance(f, dict) and 'run_mv' in f else \
            f['mv'] if isinstance(f, dict) else f.mv
        if mv is not None and mv.size:
            m = max(m, int(np.abs(mv).max()))
    return m

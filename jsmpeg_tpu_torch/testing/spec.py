"""Closed-form vectors for the integer IDCT: random coefficient blocks and
their ideal float 2-D IDCT (ISO 11172-2 Annex A's definition), shared by
tests/test_torch_spec_vectors.py (the plain IDCT) and chip_smoke.py (K1's
IDCT-only mode on the card).  Pure numpy: nothing here depends on the
port's tables or kernels."""

from __future__ import annotations

import numpy as np

# the spec vectors' bounds on the per-block max |integer - ideal|: the mean
# over the blocks and the largest.  Correct constants measure ~2.6 / ~13 on
# these blocks; one mis-transcribed constant (473 -> 437) ~12 / ~31.
IDCT_MEAN_MAX_ERR, IDCT_MAX_ERR = 4.0, 20.0


def ideal_idct_basis() -> np.ndarray:
    """[x, y, u, v]: pixel (x, y)'s weight of coefficient (u, v)."""
    c = np.array([1.0 / np.sqrt(2.0)] + [1.0] * 7)
    cosx = np.cos((2 * np.arange(8)[:, None] + 1)
                  * np.arange(8)[None, :] * np.pi / 16.0)
    return 0.25 * np.einsum('u,v,xu,yv->xyuv', c, c, cosx, cosx)


def idct_vectors(premultiplier, n: int = 200, seed: int = 0):
    """n random blocks (1-11 AC coefficients in [-300, 300], a DC in
    [-2048, 2047]).  Returns (int32 [n, 8, 8] coefficients times the
    premultiplier table, as the integer IDCT takes them; float64 [n, 8,
    8] their ideal IDCT)."""
    basis = ideal_idct_basis()
    P = np.asarray(premultiplier, np.int64).reshape(8, 8)
    rng = np.random.default_rng(seed)
    coefs, ideal = [], []
    for _ in range(n):
        F = np.zeros((8, 8), np.int64)
        pos = rng.choice(64, size=rng.integers(1, 12), replace=False)
        F.flat[pos] = rng.integers(-300, 301, size=len(pos))
        F[0, 0] = rng.integers(-2048, 2048)
        ideal.append(np.einsum('xyuv,uv->xy', basis, F.astype(float)))
        coefs.append(F * P)
    return np.stack(coefs).astype(np.int32), np.stack(ideal)


def idct_errors(got, ideal) -> tuple:
    """(mean, max) over the blocks of each block's max |got - ideal|."""
    maxes = np.abs(np.asarray(got, np.float64) - ideal).max(axis=(1, 2))
    return float(maxes.mean()), float(maxes.max())

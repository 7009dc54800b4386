"""The port's plain dequant + IDCT (jsmpeg_tpu_torch.ops.idct) against the
JAX package: the shelved Pallas kernel in interpret mode, the XLA
formulation idct_s32(dequant_premult(...)), and idct_s32 alone for the
premultiplied mode.  All integer math: every comparison is exact."""

import re
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jsmpeg_tpu import tables as JT
from jsmpeg_tpu.ops.idct import dequant_premult, idct_s32
from jsmpeg_tpu_torch import tables as T
from jsmpeg_tpu_torch.ops import idct as tidct
from jsmpeg_tpu_torch.ops import kernels

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / 'tools'))
from idct_pallas_shelved import dequant_idct_pallas  # noqa: E402


def _random_case(seed, n_mb, lo=-255, hi=256, custom=False, edges=False):
    """The case generators of tests/test_dequant_device.py, plus the clamp
    edges (+/-2047, -2048), escape-coded zeros (a zero level in the dense
    lattice) and qscale 1 / 31."""
    rng = np.random.default_rng(seed)
    levels = rng.integers(lo, hi, (n_mb, 6, 64)).astype(np.int16)
    levels[rng.random((n_mb, 6, 64)) < 0.7] = 0
    levels[:, :, 0] = np.where(rng.random((n_mb, 6)) < 0.5,
                               rng.integers(0, 2048, (n_mb, 6)),
                               levels[:, :, 0])
    qscale = rng.integers(1, 32, n_mb).astype(np.uint8)
    intra = rng.random(n_mb) < 0.5
    if edges:
        e = rng.random((n_mb, 6, 64))
        levels[e < 0.05] = 2047
        levels[(e >= 0.05) & (e < 0.1)] = -2048
        levels[(e >= 0.1) & (e < 0.12)] = -2047
        levels[(e >= 0.12) & (e < 0.2)] = 0      # escape-coded zeros
        levels[:, :, 0] = np.where(intra[:, None], 2047, levels[:, :, 0])
        qscale[::2] = 1
        qscale[1::2] = 31
    if custom:
        iq = rng.integers(1, 256, 64).astype(np.int32)
        nq = rng.integers(1, 256, 64).astype(np.int32)
    else:
        iq = np.asarray(JT.DEFAULT_INTRA_QUANT_MATRIX, np.int32)
        nq = np.asarray(JT.DEFAULT_NON_INTRA_QUANT_MATRIX, np.int32)
    return levels, qscale, intra, iq, nq


CASES = {
    'default_matrices': dict(seed=0, n_mb=40),
    'custom_matrices': dict(seed=1, n_mb=16, lo=-40, hi=41, custom=True),
    'pallas_case': dict(seed=3, n_mb=30, custom=True),
    'clamp_edges': dict(seed=4, n_mb=24, custom=True, edges=True),
    'default_edges': dict(seed=5, n_mb=24, edges=True),
}


def _torch_args(levels, qscale, intra, iq, nq):
    return (torch.as_tensor(levels), torch.as_tensor(qscale),
            torch.as_tensor(intra), torch.as_tensor(iq), torch.as_tensor(nq))


def _jax_args(levels, qscale, intra, iq, nq):
    return (jnp.asarray(levels, jnp.int32), jnp.asarray(qscale, jnp.int32),
            jnp.asarray(intra), jnp.asarray(iq), jnp.asarray(nq))


@pytest.mark.parametrize('case', sorted(CASES))
def test_dequant_idct_ref_matches_jax(case):
    """The plain K1 equals the Pallas kernel (interpret mode) and the XLA
    idct_s32(dequant_premult(...)) on the same numpy inputs."""
    levels, qscale, intra, iq, nq = _random_case(**CASES[case])
    n_mb = levels.shape[0]
    got = tidct.dequant_idct_ref(*_torch_args(levels, qscale, intra, iq, nq))
    assert got.dtype == torch.int32 and tuple(got.shape) == (n_mb, 6, 64)
    ja = _jax_args(levels, qscale, intra, iq, nq)
    pallas = dequant_idct_pallas(*ja, interpret=True)
    xla = idct_s32(dequant_premult(*ja).reshape(-1, 6, 8, 8))
    np.testing.assert_array_equal(got.numpy(), np.asarray(pallas))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(xla).reshape(n_mb, 6, 64))


@pytest.mark.parametrize('case', sorted(CASES))
def test_dequant_premult_matches_jax(case):
    levels, qscale, intra, iq, nq = _random_case(**CASES[case])
    got = tidct.dequant_premult(*_torch_args(levels, qscale, intra, iq, nq))
    want = dequant_premult(*_jax_args(levels, qscale, intra, iq, nq))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize('wild', [False, True])
def test_premultiplied_mode_matches_idct_s32(wild):
    """premultiplied=True is idct_s32 alone; `wild` coefficients span the
    whole int32 range, so the butterflies wrap."""
    rng = np.random.default_rng(7 + wild)
    n_mb = 20
    if wild:
        coef = rng.integers(-2**31, 2**31, (n_mb, 6, 64),
                            dtype=np.int64).astype(np.int32)
    else:
        coef = np.array(dequant_premult(*_jax_args(
            *_random_case(seed=9, n_mb=n_mb, custom=True, edges=True))))
    got = tidct.dequant_idct(torch.as_tensor(coef), premultiplied=True)
    want = idct_s32(jnp.asarray(coef).reshape(-1, 6, 8, 8))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want).reshape(n_mb, 6, 64))


def test_entry_point_runs_plain_version_on_cpu():
    """dequant_idct on CPU tensors is the plain version and launches no
    kernel."""
    args = _torch_args(*_random_case(seed=11, n_mb=6))
    kernels.reset_launches()
    np.testing.assert_array_equal(tidct.dequant_idct(*args).numpy(),
                                  tidct.dequant_idct_ref(*args).numpy())
    assert kernels.launches == {'dequant_idct': 0, 'mc_combine': 0}


def test_kernel_premultiplier_table_matches():
    """The __constant__ copy in csrc/dequant_idct.cu is the table."""
    src = (ROOT / 'jsmpeg_tpu_torch' / 'csrc' / 'dequant_idct.cu').read_text()
    body = re.search(r'kPremult\[64\] = \{([^}]*)\}', src).group(1)
    vals = [int(v) for v in re.findall(r'-?\d+', body)]
    assert vals == list(np.asarray(T.PREMULTIPLIER_MATRIX).tolist())
    assert vals == list(np.asarray(JT.PREMULTIPLIER_MATRIX).tolist())

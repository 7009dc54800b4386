"""Wire v2 in the port: the host-side build is byte for byte jsmpeg_tpu's,
and the device unpack (unpack_fused + packed_to_levels, plain torch)
equals the JAX functions on buffers built by jsmpeg_tpu's
build_fused_buffer -- narrow and wide run records, escapes, padding pairs
(bucketed pair streams) and padding macroblocks (frames past the batch's
real count).  The port's unpack skips the wire's valid bytes: its own
wire never carries padding frames."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jsmpeg_tpu.models import mpeg1 as jm
from jsmpeg_tpu_torch.host.native import NativeMPEG1Parser
from jsmpeg_tpu_torch.models import mpeg1 as tm
from jsmpeg_tpu_torch.testing.gen import encode_test_stream


def _synthetic_batch(rng, n, n_mb, wide):
    """Random per-MB (flags, cbp, mv) streams RLE'd the way the parser
    emits them (tests/test_wire_v2.py), with a pair stream covering the
    first coded blocks, escapes included."""
    lo, hi = (-600, 600) if wide else (-128, 128)
    fl = rng.integers(0, 256, n * n_mb).astype(np.uint8)
    cb = rng.integers(0, 64, n * n_mb).astype(np.uint8)
    mv = rng.integers(lo, hi, (n * n_mb, 2)).astype(np.int16)
    for k in range(0, n * n_mb - 3, 7):
        fl[k + 1:k + 3] = fl[k]
        cb[k + 1:k + 3] = cb[k]
        mv[k + 1:k + 3] = mv[k]
    change = np.ones(n * n_mb, bool)
    change[1:] = ((fl[1:] != fl[:-1]) | (cb[1:] != cb[:-1])
                  | (mv[1:] != mv[:-1]).any(axis=1))
    starts = np.flatnonzero(change)
    lens = np.diff(np.append(starts, n * n_mb))
    n_coded = int(np.unpackbits(cb[:, None], axis=1)[:, 2:].sum())
    # 3 pairs per block for the first 20 coded blocks, one in five escaped
    n_blocks = min(20, n_coded)
    pos = np.tile(np.array([0, 5, 63], np.uint8), n_blocks)
    pos[::3] |= 0x80
    v8 = rng.integers(-127, 128, 3 * n_blocks).astype(np.int8)
    v8[v8 == 0] = 1
    v8[::5] = -128
    esc = rng.integers(-2048, 2048, int((v8 == -128).sum())).astype(np.int16)
    return dict(n=n, run_len=lens.astype(np.uint16), run_flags=fl[starts],
                run_cbp=cb[starts], run_mv=mv[starts], sp_pos=pos, sp_v8=v8,
                sp_esc=esc, n_blocks=n_blocks)


def _parsed_batch(n_frames=5):
    es, _ = encode_test_stream(96, 64, n_frames=n_frames, seed=2, gop=4)
    p = NativeMPEG1Parser()
    p.write(es)
    batch = p.parse_batch(8, eof=True)
    assert isinstance(batch, dict) and 'sp_pos' in batch
    assert len(batch['sp_esc']) > 0          # escapes ride the side stream
    return batch, p.seq.mb_size


def _batches():
    rng = np.random.default_rng(5)
    real, n_mb = _parsed_batch()
    return {'parsed': (real, n_mb),
            'narrow': (_synthetic_batch(rng, 3, 25, wide=False), 25),
            'wide': (_synthetic_batch(rng, 3, 25, wide=True), 25)}


@pytest.mark.parametrize('name', ['parsed', 'narrow', 'wide'])
def test_builder_byte_identical(name):
    batch, n_mb = _batches()[name]
    F = 4 if name != 'parsed' else 8
    jbuf, n_blk, n_runs, mv_wide, n_pairs, n_esc = jm.build_fused_buffer(
        batch, F, n_mb)
    assert mv_wide == (name == 'wide')
    tbuf = tm.build_fused_buffer_sized(batch, F, n_pairs, n_runs, n_mb,
                                       mv_wide=mv_wide, n_esc=n_esc)
    np.testing.assert_array_equal(tbuf, jbuf)
    assert len(tbuf) == tm.fused_buffer_len(F, n_mb, n_pairs, n_runs,
                                            mv_wide, n_esc=n_esc)


def _jax_levels(buf, F, n_mb, n_runs, mv_wide, n_pairs, n_esc, n_blk):
    valid, fl, cb, mv16, sp_pos, sp_val, _ = jm.unpack_fused(
        jnp.asarray(buf), F, n_mb, n_runs, mv_wide, n_pairs=n_pairs,
        n_esc=n_esc)
    la = jm.packed_to_levels(fl, cb, mv16, sp_pos, sp_val, valid, n_blk)
    return (valid, fl, cb, mv16, sp_pos, sp_val), la


@pytest.mark.parametrize('name', ['parsed', 'narrow', 'wide'])
def test_unpack_matches_jax(name):
    """Bucketed buffers: padding pairs (flag 0x40) past the real pairs
    and padding frames past the batch's n, both dropped by the scatter."""
    batch, n_mb = _batches()[name]
    F = 4 if name != 'parsed' else 8
    buf, n_blk, n_runs, mv_wide, n_pairs, n_esc = jm.build_fused_buffer(
        batch, F, n_mb)
    assert n_pairs > len(batch['sp_pos']) and F > batch['n']
    jstreams, jla = _jax_levels(buf, F, n_mb, n_runs, mv_wide, n_pairs,
                                n_esc, n_blk)
    tstreams = tm.unpack_fused(torch.as_tensor(buf), F, n_mb, n_runs,
                               mv_wide, n_pairs, n_esc)
    assert len(tstreams) == len(jstreams) - 1
    for t, j in zip(tstreams, jstreams[1:]):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    tla = tm.packed_to_levels(*tstreams, n_blk)
    for field in tla._fields:
        np.testing.assert_array_equal(getattr(tla, field).numpy(),
                                      np.asarray(getattr(jla, field)),
                                      err_msg=field)
    assert tla.levels.dtype == torch.int16
    assert int((tla.levels != 0).sum()) > 0


@pytest.mark.parametrize('name', ['parsed', 'narrow', 'wide'])
def test_exact_size_wire_matches_bucketed_jax(name):
    """The decoder's own wire (build_fused_buffer at the exact sizes: no
    padding pairs, no padding frames) gives the real frames' levels of
    the bucketed JAX wire."""
    batch, n_mb = _batches()[name]
    n = batch['n']
    jbuf, jn_blk, jn_runs, jwide, jpairs, jesc = jm.build_fused_buffer(
        batch, 4 if name != 'parsed' else 8, n_mb)
    _, jla = _jax_levels(jbuf, 4 if name != 'parsed' else 8, n_mb, jn_runs,
                         jwide, jpairs, jesc, jn_blk)
    buf, n_blk, n_runs, mv_wide, n_pairs, n_esc = tm.build_fused_buffer(
        batch, n_mb)
    assert (buf[:n] == 1).all()
    tla = tm.packed_to_levels(
        *tm.unpack_fused(torch.as_tensor(buf), n, n_mb, n_runs, mv_wide,
                         n_pairs, n_esc), n_blk)
    assert tla.levels.shape[0] == n
    for field in tla._fields:
        np.testing.assert_array_equal(getattr(tla, field).numpy(),
                                      np.asarray(getattr(jla, field))[:n],
                                      err_msg=field)


@pytest.mark.parametrize('name', ['narrow', 'wide'])
def test_unaligned_escape_stream(name):
    """The escape stream starts at an odd byte offset (F + B + wR + 2P is
    odd here) and still decodes: the int16 view needs a copy first."""
    batch, n_mb = _batches()[name]
    wide = name == 'wide'
    buf = jm.build_fused_buffer_sized(batch, 3, 61, 64, n_mb, mv_wide=wide,
                                      n_esc=12)
    o = 3 + jm._bitmap_bytes(3, n_mb) + (8 if wide else 4) * 64 + 2 * 61
    assert o % 2 == 1
    jstreams, _ = _jax_levels(buf, 3, n_mb, 64, wide, 61, 12, 64)
    tstreams = tm.unpack_fused(torch.as_tensor(buf), 3, n_mb, 64, wide, 61,
                               12)
    assert bool((tstreams[4] != tstreams[4].to(torch.int8)).any())
    np.testing.assert_array_equal(tstreams[4].numpy(),
                                  np.asarray(jstreams[5]))

"""Wire v2 in the port: the host-side build is byte for byte jsmpeg_tpu's,
and the device unpack (unpack_fused + packed_to_levels, plain torch, and
the compact packed_to_blocks scattered by its block ids) equals the JAX
functions on buffers built by jsmpeg_tpu's
build_fused_buffer -- narrow and wide run records, escapes, padding pairs
(bucketed pair streams) and padding macroblocks (frames past the batch's
real count).  The port's unpack skips the wire's valid bytes: its own
wire never carries padding frames.  The sparse wire (global index/value
pairs, parse_batch(packed=False)) decodes as jsmpeg_tpu's
decode_scan_sparse does, and as the packed wire does."""

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
    # the compact form scattered by its ids is the same lattice
    cla = tm.packed_to_blocks(*tstreams, n_blk)
    for la in (tla, tm.levels_dense(cla)):
        assert la.blk_ids is None
        for field in la._fields[:7]:
            np.testing.assert_array_equal(getattr(la, field).numpy(),
                                          np.asarray(getattr(jla, field)),
                                          err_msg=field)
    assert tla.levels.dtype == cla.levels.dtype == torch.int16
    assert int((tla.levels != 0).sum()) > 0
    assert cla.levels.shape == (n_blk, 64)


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
    streams = tm.unpack_fused(torch.as_tensor(buf), n, n_mb, n_runs,
                              mv_wide, n_pairs, n_esc)
    tla = tm.packed_to_levels(*streams, n_blk)
    assert tla.levels.shape[0] == n
    for la in (tla, tm.levels_dense(tm.packed_to_blocks(*streams, n_blk))):
        for field in la._fields[:7]:
            np.testing.assert_array_equal(getattr(la, field).numpy(),
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


def _sparse_batches(es, F):
    """Every parse_batch(F, packed=False) batch of `es` (the sparse wire:
    global index/value pairs + dense metadata slabs)."""
    p = NativeMPEG1Parser()
    p.write(es)
    out = []
    while isinstance(b := p.parse_batch(F, eof=True, packed=False), dict):
        assert 'sp_idx' in b and 'levels' not in b
        out.append(b)
        if b['n'] < F:
            break
    return out


@pytest.mark.parametrize('F', [4, 16])
def test_sparse_wire_matches_jax_and_packed(F):
    """A9: the same sparse batches through jsmpeg_tpu's
    MPEG1Decoder._dispatch_batch (decode_scan_sparse) and the port's
    _decode_batch give equal planes, carry included across batches; and
    the port's packed path gives the same frames."""
    from jsmpeg_tpu.models.mpeg1 import MPEG1Decoder as JaxDecoder
    es, _ = encode_test_stream(96, 64, n_frames=9, seed=23, gop=4)
    jdec, tdec = JaxDecoder(), tm.MPEG1Decoder({'device': 'cpu'})
    jdec.write(0.0, es)
    tdec.write(0.0, es)
    got, want = [], []
    for b in _sparse_batches(es, F):
        n = b['n']
        outs = jdec._dispatch_batch(b)
        want += [tuple(np.asarray(x)[k] for x in outs) for k in range(n)]
        pb = tdec._decode_batch(b)
        assert len(pb) == n
        got += [tuple(x.numpy() for x in p) for p in pb]
    assert len(got) == 9
    packed = tm.MPEG1Decoder({'device': 'cpu'})
    packed.write(0.0, es)
    ref = [tuple(x.numpy() for x in p)
           for p in packed.decode_available(eof=True)]
    for k, (g, w, r) in enumerate(zip(got, want, ref)):
        for pn, a, b, c in zip(('y', 'cr', 'cb'), g, w, r):
            np.testing.assert_array_equal(a, b, err_msg=f'f{k} {pn} jax')
            np.testing.assert_array_equal(a, c, err_msg=f'f{k} {pn} packed')


def test_sparse_scatter_drops_out_of_range():
    """sparse_to_levels == JAX's .at[idx].set(val, mode='drop') scatter
    of decode_scan_sparse, with indices past the lattice (padding)."""
    F, n_mb = 2, 6
    total = F * n_mb * 6 * 64
    rng = np.random.default_rng(8)
    idx = rng.choice(total, 300, replace=False).astype(np.int32)
    idx = np.concatenate([idx, [total, total + 5, 2 ** 31 - 1]])
    val = rng.integers(-2048, 2048, len(idx)).astype(np.int16)
    want = jnp.zeros(total, jnp.int16).at[jnp.asarray(idx)].set(
        jnp.asarray(val), mode='drop')
    got = tm.sparse_to_levels(torch.as_tensor(idx), torch.as_tensor(val),
                              F, n_mb)
    assert got.shape == (F, n_mb, 6, 64) and got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy().reshape(-1), np.asarray(want))


# ------------------------------------------ the int32 lattice limit (C1)

def test_upload_packed_refuses_a_lattice_past_the_limit(monkeypatch):
    """packed_to_levels numbers the levels lattice F * n_mb * 384 in
    int32: a batch past the limit raises a ValueError naming it before
    anything is uploaded (here at a limit patched down to the batch's
    lattice less one), and lattice_groups raises for a segment that is
    over it alone.  At the limit itself the batch decodes."""
    batch, n_mb = _parsed_batch()
    lattice = batch['n'] * n_mb * 384
    put = []
    monkeypatch.setattr(tm, 'LATTICE_LIMIT', lattice - 1)
    with pytest.raises(ValueError, match=f'limit {lattice - 1}'):
        tm.upload_packed(batch, n_mb, lambda a: put.append(a))
    assert not put
    with pytest.raises(ValueError, match='lattice limit'):
        tm.lattice_groups(4, batch['n'], n_mb)
    monkeypatch.setattr(tm, 'LATTICE_LIMIT', lattice)
    la = tm.upload_packed(batch, n_mb, torch.as_tensor)
    assert la.levels.shape == (batch['n_blocks'], 64)
    assert tm.levels_dense(la).levels.shape == (batch['n'], n_mb, 6, 64)
    assert tm.lattice_groups(3, batch['n'], n_mb) == [(0, 1), (1, 2), (2, 3)]
    monkeypatch.setattr(tm, 'LATTICE_LIMIT', 2 * lattice + 5)
    assert tm.lattice_groups(5, batch['n'], n_mb) == [(0, 2), (2, 4), (4, 5)]


def _counting(monkeypatch):
    """The decode_levels calls of the fleet and mesh paths (one K1 and one
    K2 launch each on the card), as their seg_frames."""
    from jsmpeg_tpu_torch.parallel import streams
    calls, real = [], streams.decode_levels

    def counting(*a, **kw):
        calls.append(list(kw['seg_frames']))
        return real(*a, **kw)

    monkeypatch.setattr(streams, 'decode_levels', counting)
    return calls


@pytest.mark.parametrize('mode', ['stacked', 'vmap'])
def test_joint_round_splits_at_the_lattice_limit(mode, monkeypatch):
    """A joint fleet round whose lattice passes the (patched) limit runs
    as the fewest launch pairs whose lattice fits, each on its rows of
    the joint carry: the same frames, carries threaded over rounds, as
    the unsplit rounds; below the limit one launch pair a round."""
    from jsmpeg_tpu_torch.parallel.streams import decode_streams_offline
    from jsmpeg_tpu_torch.testing.gen import encode_realistic_stream
    ess = [encode_realistic_stream(64, 48, n_frames=n, seed=s, gop=4)[0]
           for s, n in ((21, 9), (22, 6), (23, 2), (24, 2))]
    run = lambda: decode_streams_offline(ess, batch_frames=4, mode=mode,
                                         device='cpu')
    calls = _counting(monkeypatch)
    want = run()
    assert calls == [[4, 4, 2, 2], [4, 2, 0, 0], [1, 0, 0, 0]]
    calls.clear()
    # two segments of a 4-frame round fit, three do not; a run of idle
    # segments launches nothing
    monkeypatch.setattr(tm, 'LATTICE_LIMIT', 2 * 4 * 12 * 384)
    got = run()
    assert calls == [[4, 4], [2, 2], [4, 2], [1, 0, 0, 0]]
    for i in range(4):
        assert len(got[i]) == len(want[i])
        for p, q in zip(got[i], want[i]):
            for a, b in zip(p, q):
                np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_mesh_flush_splits_at_the_lattice_limit(monkeypatch):
    """A mesh flush whose GOPs' joint lattice passes the (patched) limit
    splits into launch pairs of as many GOPs as fit; frames and the
    returned carry equal the unsplit flush."""
    from jsmpeg_tpu_torch.host import best_parser
    from jsmpeg_tpu_torch.parallel.mesh import make_mesh
    from jsmpeg_tpu_torch.parallel.packed import (MeshPackedDecoder,
                                                  split_packed_frames)
    from jsmpeg_tpu_torch.testing.gen import encode_realistic_stream
    es = encode_realistic_stream(64, 48, n_frames=22, seed=24, gop=4)[0]
    p = best_parser()
    p.write(es)
    frames = split_packed_frames(p.parse_batch(32, eof=True))
    dec = MeshPackedDecoder(make_mesh(8, device='cpu'), p.seq)
    calls = _counting(monkeypatch)
    want, _, wcarry = dec.decode(frames)
    assert calls == [[4, 4, 4, 4, 4, 2]]
    calls.clear()
    monkeypatch.setattr(tm, 'LATTICE_LIMIT', 4 * 4 * 12 * 384)
    got, gl, gcarry = dec.decode(frames)
    assert calls == [[4, 4, 4, 4], [4, 2]] and gl == [4] * 5 + [2]
    for p_, q in zip(got + list(gcarry), want + list(wcarry)):
        for a, b in zip(p_, q):
            np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize('name', ['parsed', 'narrow', 'wide'])
def test_packed_to_blocks_rows_are_jax_coded_blocks(name):
    """packed_to_blocks on jsmpeg_tpu's bucketed wire (padding pairs and
    frames), with every other pair past a block's first made a bit-6
    pair (never scattered): its ids are the coded blocks in row-major
    order, its rows jsmpeg_tpu's levels of those blocks, and the dense
    lattice it stands for is jsmpeg_tpu's."""
    batch, n_mb = _batches()[name]
    F = 4 if name != 'parsed' else 8
    pos = batch['sp_pos'].copy()
    mid = np.flatnonzero((pos & 0x80) == 0)[::2]
    pos[mid] |= 0x40
    batch = dict(batch, sp_pos=pos)
    buf, n_blk, n_runs, mv_wide, n_pairs, n_esc = jm.build_fused_buffer(
        batch, F, n_mb)
    _, jla = _jax_levels(buf, F, n_mb, n_runs, mv_wide, n_pairs, n_esc,
                         n_blk)
    la = tm.packed_to_blocks(*tm.unpack_fused(
        torch.as_tensor(buf), F, n_mb, n_runs, mv_wide, n_pairs, n_esc),
        n_blk)
    coded = np.flatnonzero(np.asarray(jla.coded).reshape(-1))
    n = min(len(coded), n_blk)
    np.testing.assert_array_equal(la.blk_ids[:n].numpy(), coded[:n])
    assert bool((la.blk_ids[n:] == -1).all())
    jlv = np.asarray(jla.levels).reshape(-1, 64)
    np.testing.assert_array_equal(la.levels[:n].numpy(), jlv[coded[:n]])
    assert not la.levels[n:].any()
    np.testing.assert_array_equal(tm.levels_dense(la).levels.numpy(),
                                  np.asarray(jla.levels))

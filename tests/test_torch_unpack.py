"""K3, the wire unpack kernel (jsmpeg_tpu_torch/csrc/wire_unpack.cu), as
far as the CPU can check it: its decomposition written out in plain torch
(models.mpeg1.wire_unpack_mirror: tile counts, exclusive tile bases,
in-tile scans, each coded ordinal's pair range, the lattice built block
by block) equals its plain version (unpack_fused + packed_to_levels, via
unpack_wires_ref) and jsmpeg_tpu's unpack_fused + packed_to_levels on the
same buffers, at the kernel's tile and at tiles small enough that every
count crosses tiles.  The kernel itself is held to the plain version on
the card by chip_smoke.py's d_k3_check."""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jsmpeg_tpu.models import mpeg1 as jm
from jsmpeg_tpu_torch.models import mpeg1 as tm
from jsmpeg_tpu_torch.ops import kernels
from jsmpeg_tpu_torch.parallel.packed import _concat_cell
from tests.test_torch_wire import _parsed_batch, _synthetic_batch

TILES = [8, 16, tm.K3_TILE]


def _distinct_pairs(rng, n_blocks: int, per: int = 3):
    """`per` pairs for each of n_blocks blocks, no position used twice
    across all of them (so pairs that clamp into one ordinal never name
    the same level), one value in five escaped."""
    pos = (np.arange(n_blocks * per) % 64).astype(np.uint8)
    assert n_blocks * per <= 64
    pos[::per] |= 0x80
    v8 = rng.integers(-127, 128, len(pos)).astype(np.int8)
    v8[v8 == 0] = 1
    v8[::5] = -128
    esc = rng.integers(-2048, 2048, int((v8 == -128).sum())).astype(np.int16)
    return pos, v8, esc


def _wire(batch, n_mb, F=None, **sized):
    """(buf uint8, sizes) of `batch`: the exact-size wire, or with F and
    `sized` (n_pairs, n_runs, mv_wide, n_esc) a bucketed one."""
    if F is None:
        buf, n_blk, n_runs, wide, n_pairs, n_esc = tm.build_fused_buffer(
            batch, n_mb)
        return buf, (batch['n'], n_mb, n_runs, wide, n_pairs, n_esc, n_blk)
    buf = tm.build_fused_buffer_sized(batch, F, sized['n_pairs'],
                                      sized['n_runs'], n_mb, sized['mv_wide'],
                                      sized['n_esc'])
    return buf, (F, n_mb, sized['n_runs'], sized['mv_wide'],
                 sized['n_pairs'], sized['n_esc'], sized['n_blk'])


def _case(name):
    rng = np.random.default_rng(11)
    if name in ('narrow', 'wide'):
        # 20 coded ordinals carry pairs, every later coded block is past
        # n_blk (the plain version's dump slot)
        batch = _synthetic_batch(rng, 3, 25, wide=name == 'wide')
        assert batch['n_blocks'] < int(np.unpackbits(
            batch['run_cbp'][:, None], axis=1)[:, 2:].sum())
        return _wire(batch, 25)
    if name == 'padding_pairs':
        # jsmpeg_tpu's bucketed wire: padding pairs (0x40) past the real
        # ones, padding frames past the batch's n
        batch = _synthetic_batch(rng, 3, 25, wide=False)
        buf, n_blk, n_runs, wide, n_pairs, n_esc = jm.build_fused_buffer(
            batch, 4, 25)
        assert n_pairs > len(batch['sp_pos'])
        return buf, (4, 25, n_runs, wide, n_pairs, n_esc, n_blk)
    if name.startswith('odd_escapes'):
        wide = name.endswith('wide')
        batch = _synthetic_batch(rng, 3, 25, wide=wide)
        buf, sizes = _wire(batch, 25, 3, n_pairs=61, n_runs=64,
                           mv_wide=wide, n_esc=12, n_blk=64)
        o_esc = 3 + tm._bitmap_bytes(3, 25) + (8 if wide else 4) * 64 + 122
        assert o_esc % 2 == 1
        return buf, sizes
    if name == 'lead_pair':
        # a pair before the first bit-7 pair lands in ordinal 0
        batch = _synthetic_batch(rng, 3, 25, wide=False)
        pos, v8, esc = _distinct_pairs(rng, 20)
        batch.update(sp_pos=np.concatenate([[63], pos]).astype(np.uint8),
                     sp_v8=np.concatenate([[-128], v8]).astype(np.int8),
                     sp_esc=np.concatenate([[1234], esc]).astype(np.int16))
        return _wire(batch, 25)
    if name == 'tail_ordinals':
        # more bit-7 pairs than n_blk: the pairs of ordinals >= n_blk
        # clamp into ordinal n_blk - 1
        batch = _synthetic_batch(rng, 3, 25, wide=False)
        pos, v8, esc = _distinct_pairs(rng, 20)
        batch.update(sp_pos=pos, sp_v8=v8, sp_esc=esc, n_blocks=6)
        return _wire(batch, 25)
    if name == 'bit6_pairs':
        # pairs with bit 6 set in mid-stream, nonzero values at positions
        # of their block that no other pair names: never scattered
        batch = _synthetic_batch(rng, 3, 25, wide=False)
        pos = batch['sp_pos'].copy()
        mid = np.flatnonzero((pos & 0x80) == 0)[::2]
        pos[mid] = 0x40 | ((pos[mid] & 63) ^ 1)
        batch.update(sp_pos=pos)
        return _wire(batch, 25)
    if name == 'empty':
        # no run, no pair: every size 1
        buf, sizes = _wire(_concat_cell([], 0), 25, 2, n_pairs=1, n_runs=1,
                           mv_wide=False, n_esc=1, n_blk=1)
        return buf, sizes
    if name == 'parsed':
        batch, n_mb = _parsed_batch()
        return _wire(batch, n_mb)
    if name == 'parsed_bucketed':
        batch, n_mb = _parsed_batch()
        buf, n_blk, n_runs, wide, n_pairs, n_esc = jm.build_fused_buffer(
            batch, 8, n_mb)
        return buf, (8, n_mb, n_runs, wide, n_pairs, n_esc, n_blk)
    raise ValueError(name)


CASES = ['narrow', 'wide', 'padding_pairs', 'odd_escapes_narrow',
         'odd_escapes_wide', 'lead_pair', 'tail_ordinals', 'bit6_pairs',
         'empty', 'parsed', 'parsed_bucketed']


def _jax_levels(buf, sizes):
    F, n_mb, n_runs, wide, n_pairs, n_esc, n_blk = sizes
    valid, fl, cb, mv16, sp_pos, sp_val, _ = jm.unpack_fused(
        jnp.asarray(buf), F, n_mb, n_runs, wide, n_pairs=n_pairs, n_esc=n_esc)
    return jm.packed_to_levels(fl, cb, mv16, sp_pos, sp_val, valid, n_blk)


def _assert_levels_equal(got, want, what):
    for field in got._fields:
        g, w = getattr(got, field), getattr(want, field)
        w = w if isinstance(w, torch.Tensor) else torch.as_tensor(
            np.array(w))
        assert g.dtype == w.dtype, f'{what} {field}: {g.dtype} vs {w.dtype}'
        np.testing.assert_array_equal(g.numpy(), w.numpy(),
                                      err_msg=f'{what} {field}')


@pytest.mark.parametrize('tile', TILES)
@pytest.mark.parametrize('name', CASES)
def test_mirror_matches_plain_and_jax(name, tile):
    buf, sizes = _case(name)
    t = torch.as_tensor(buf)[None]
    plain = tm.unpack_wires_ref(t, *sizes)
    _assert_levels_equal(tm.wire_unpack_mirror(t, *sizes, tile=tile), plain,
                         f'{name} mirror')
    _assert_levels_equal(plain, _jax_levels(buf, sizes), f'{name} jax')
    if name not in ('empty',):
        assert int((plain.levels != 0).sum()) > 0
    if name == 'lead_pair':
        # ordinal 0's first level came from the leading escaped pair
        F, n_mb = sizes[:2]
        flat = plain.levels.reshape(-1, 64)[plain.coded.reshape(-1)]
        assert int(flat[0, 63]) == 1234


def _stream_batches():
    """Three streams of one picture size at unequal lengths: 5 and 3
    parsed frames (different content) and an idle stream."""
    from jsmpeg_tpu_torch.host.native import NativeMPEG1Parser
    from jsmpeg_tpu_torch.testing.gen import encode_test_stream
    out = []
    for seed, n in ((2, 5), (7, 3)):
        es, _ = encode_test_stream(96, 64, n_frames=n, seed=seed, gop=4)
        p = NativeMPEG1Parser()
        p.write(es)
        out.append(p.parse_batch(8, eof=True))
        n_mb = p.seq.mb_size
    return out + [None], n_mb


@pytest.mark.parametrize('tile', TILES)
def test_vmap_stack_into_the_joint_layout(tile):
    """The vmap fleet's [S, L] wires at shared sizes (as
    MultiStreamDecoder._upload_many builds them): unpack_wires writes each
    stream's macroblocks into its columns of the joint [F, S*n_mb]
    layout, equal to each stream's own unpack stacked (the join the
    fleet ran before K3), to the mirror, and per stream to jsmpeg_tpu."""
    batches, n_mb = _stream_batches()
    real = [b for b in batches if b]
    F = max(b['n'] for b in real)
    n_pairs = max(len(b['sp_pos']) for b in real)
    n_esc = max(max(len(b['sp_esc']) for b in real), 1)
    n_runs = max(len(b['run_len']) for b in real)
    n_blk = max(b['n_blocks'] for b in real)
    assert len({len(b['sp_pos']) for b in real}) > 1
    bufs = np.stack([tm.build_fused_buffer_sized(
        b or _concat_cell([], 0), F, n_pairs, n_runs, n_mb, False, n_esc)
        for b in batches])
    sizes = (F, n_mb, n_runs, False, n_pairs, n_esc, n_blk)
    t = torch.as_tensor(bufs)
    got = tm.unpack_wires(t, *sizes)
    assert got.levels.shape == (F, 3 * n_mb, 6, 64)
    own = [tm.packed_to_levels(*tm.unpack_fused(b, *sizes[:6]), n_blk)
           for b in t]
    stacked = type(got)(*[torch.stack(x, 1).flatten(1, 2)
                          for x in zip(*own)])
    _assert_levels_equal(got, stacked, 'joint')
    _assert_levels_equal(tm.wire_unpack_mirror(t, *sizes, tile=tile), got,
                         'mirror')
    for s, buf in enumerate(bufs):
        cols = slice(s * n_mb, (s + 1) * n_mb)
        _assert_levels_equal(type(got)(*[x[:, cols] for x in got]),
                             _jax_levels(buf, sizes), f'stream {s} jax')


def test_unpack_staged_on_the_cpu_is_the_plain_version():
    """unpack_staged (the main path's unpack) on a CPU wire runs the
    plain pair and launches nothing; upload_packed goes through it."""
    batch, n_mb = _parsed_batch()
    kernels.reset_launches()
    st = tm.stage_packed(batch, n_mb, torch.as_tensor)
    la = tm.unpack_staged(st)
    want = tm.packed_to_levels(*tm.unpack_fused(
        st.buf, st.n_frames, n_mb, st.n_runs, st.mv_wide, st.n_pairs,
        st.n_esc), st.n_blk)
    _assert_levels_equal(la, want, 'unpack_staged')
    _assert_levels_equal(tm.upload_packed(batch, n_mb, torch.as_tensor),
                         want, 'upload_packed')
    assert not any(kernels.launches.values())


def test_mirror_tile_is_the_kernels():
    """The mirror's default tile is csrc/wire_unpack.cu's kTile
    (kThreads * kItems), and the kernel reads one bitmap byte a thread,
    so a tile holds whole bitmap bytes."""
    src = open(os.path.join(kernels.CSRC, 'wire_unpack.cu')).read()
    threads = int(re.search(r'kThreads = (\d+);', src)[1])
    items = int(re.search(r'kItems = (\d+);', src)[1])
    assert 'kTile = kThreads * kItems;' in src
    assert items == 8 and threads * items == tm.K3_TILE
    assert all(t % 8 == 0 for t in TILES)

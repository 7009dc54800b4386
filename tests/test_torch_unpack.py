"""K3, the wire unpack kernel (jsmpeg_tpu_torch/csrc/wire_unpack.cu), as
far as the CPU can check it: its two launches written out in plain torch
(tests/torch_k3_mirror.py: the chained scans with their look-back
over tiles taken by ticket, then the write tiles, each macroblock's pair
range walked 32 pairs a chunk with the last lane of each equal level
winning, each warp's coded blocks stored as consecutive compact rows)
equal its plain version (unpack_fused + packed_to_blocks, via
unpack_wires_ref), whose compact rows scattered by their block ids
(levels_dense) equal jsmpeg_tpu's unpack_fused + packed_to_levels on the
same buffers, at the kernel's tiles and at tiles small enough that every
count crosses tiles and every look-back crosses windows, in ticket order
and in shuffled interleavings.  The kernel itself is held to the plain
version on the card by chip_smoke.py's d_k3_check."""

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
from tests import torch_k3_mirror as k3m
from tests.test_torch_wire import _parsed_batch, _synthetic_batch

TILES = [8, 16, k3m.K3_TILE]


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
    """Every field of `got` equal to `want`'s, dtypes too; a dense
    `got`'s blk_ids (None) to nothing (jsmpeg_tpu's LevelsArrays has no
    such field)."""
    for field in got._fields:
        g = getattr(got, field)
        if g is None:
            assert getattr(want, field, None) is None, f'{what} {field}'
            continue
        w = getattr(want, field)
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
    _assert_levels_equal(k3m.wire_unpack_mirror(t, *sizes, tile=tile), plain,
                         f'{name} mirror')
    dense = tm.levels_dense(plain)
    _assert_levels_equal(dense, _jax_levels(buf, sizes), f'{name} jax')
    if name not in ('empty',):
        assert int((plain.levels != 0).sum()) > 0
    if name == 'lead_pair':
        # ordinal 0's first level came from the leading escaped pair
        flat = dense.levels.reshape(-1, 64)[plain.coded.reshape(-1)]
        assert int(flat[0, 63]) == int(plain.levels[0, 63]) == 1234


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
    assert got.levels.shape == (3 * n_blk, 64)
    own = [tm.packed_to_levels(*tm.unpack_fused(b, *sizes[:6]), n_blk)
           for b in t]
    stacked = type(got)(*[torch.stack(x, 1).flatten(1, 2)
                          for x in zip(*[o[:7] for o in own])])
    dense = tm.levels_dense(got)
    _assert_levels_equal(dense, stacked, 'joint')
    _assert_levels_equal(k3m.wire_unpack_mirror(t, *sizes, tile=tile), got,
                         'mirror')
    for s, buf in enumerate(bufs):
        cols = slice(s * n_mb, (s + 1) * n_mb)
        _assert_levels_equal(type(got)(*[x[:, cols] for x in dense[:7]]),
                             _jax_levels(buf, sizes), f'stream {s} jax')


def test_unpack_staged_on_the_cpu_is_the_plain_version():
    """unpack_staged (the main path's unpack) on a CPU wire runs the
    plain pair and launches nothing; upload_packed goes through it."""
    batch, n_mb = _parsed_batch()
    kernels.reset_launches()
    st = tm.stage_packed(batch, n_mb, torch.as_tensor)
    la = tm.unpack_staged(st)
    want = tm.packed_to_blocks(*tm.unpack_fused(
        st.buf, st.n_frames, n_mb, st.n_runs, st.mv_wide, st.n_pairs,
        st.n_esc), st.n_blk)
    _assert_levels_equal(la, want, 'unpack_staged')
    _assert_levels_equal(tm.upload_packed(batch, n_mb, torch.as_tensor),
                         want, 'upload_packed')
    assert not any(kernels.launches.values())


def test_mirror_tile_is_the_kernels():
    """The mirror's tiles are csrc/wire_unpack.cu's: launch A's tiles of
    kScanThreads macroblocks (one a thread) and of kPairTile =
    kScanThreads * kPairItems pairs, launch B's kWriteMbs macroblocks a
    CTA, kWarpMbs a warp; the test tiles keep A's ratio."""
    src = open(os.path.join(kernels.CSRC, 'wire_unpack.cu')).read()
    threads = int(re.search(r'kScanThreads = (\d+);', src)[1])
    items = int(re.search(r'kPairItems = (\d+);', src)[1])
    write = int(re.search(r'kWriteMbs = (\d+);', src)[1])
    warp = int(re.search(r'kWarpMbs = (\d+);', src)[1])
    assert 'kMbTile = kScanThreads;' in src
    assert 'kPairTile = kScanThreads * kPairItems;' in src
    assert 'kWriteWarps = kWriteMbs / kWarpMbs;' in src
    assert 'kWriteThreads = kWriteWarps * 32;' in src
    assert (threads, items, write, warp) == (
        k3m.K3_SCAN_THREADS, k3m.K3_PAIR_ITEMS, k3m.K3_WRITE_MBS,
        k3m.K3_WARP_MBS)
    assert threads % 32 == 0 and threads * items == k3m.K3_TILE
    assert all(t % items == 0 for t in TILES)


def test_launcher_scratch_is_the_kernels_rule():
    """The launcher sizes K3's scratch by csrc/wire_unpack.cu's
    scratch_rule (the kernel carves it, and refuses a buffer under the
    rule or a layout over it), read from the source."""
    src = open(os.path.join(kernels.CSRC, 'wire_unpack.cu')).read()
    m = re.search(r'return (\d+)ll \* n_streams \* \(static_cast<long long>'
                  r'\(n_items\) \+ n_pairs \+\s+n_blk \+ (\d+)\) \+ (\d+);', src)
    per, stream, fixed = (int(x) for x in m.groups())
    for S, F, n_mb, P, n_blk in ((1, 32, 3600, 280669, 60000),
                                 (4, 3, 25, 61, 7), (3, 1, 1, 1, 1)):
        assert kernels.wire_unpack_scratch_bytes(S, F, n_mb, P, n_blk) == \
            per * S * (F * n_mb + P + n_blk + stream) + fixed


def _batch(rng, F, n_mb, cbp, blocks, wide=False):
    """A packed batch of F * n_mb macroblocks, one run each, cbp[i] coded
    blocks, the coded blocks' pairs from `blocks` (a list of position
    lists, in ordinal order; the first of each gets bit 7), one value in
    five escaped."""
    n = F * n_mb
    pos = np.concatenate([np.asarray(b, np.uint8) for b in blocks])
    firsts = np.cumsum([0] + [len(b) for b in blocks])[:-1]
    pos[firsts] |= 0x80
    v8 = rng.integers(-127, 128, len(pos)).astype(np.int8)
    v8[v8 == 0] = 1
    v8[::5] = -128
    esc = rng.integers(-2048, 2048, int((v8 == -128).sum())).astype(np.int16)
    lim = 600 if wide else 128
    return dict(n=F, run_len=np.ones(n, np.uint16),
                run_flags=rng.integers(0, 256, n).astype(np.uint8),
                run_cbp=np.asarray(cbp, np.uint8),
                run_mv=rng.integers(-lim, lim, (n, 2)).astype(np.int16),
                sp_pos=pos, sp_v8=v8, sp_esc=esc, n_blocks=len(blocks))


def _check_all(buf, sizes, what, **mirror):
    """The mirror (with `mirror`'s options) equal to the plain version,
    and the plain version to jsmpeg_tpu, on one wire."""
    t = torch.as_tensor(buf)[None]
    plain = tm.unpack_wires_ref(t, *sizes)
    _assert_levels_equal(k3m.wire_unpack_mirror(t, *sizes, **mirror), plain,
                         f'{what} mirror')
    _assert_levels_equal(tm.levels_dense(plain), _jax_levels(buf, sizes),
                         f'{what} jax')
    return plain


@pytest.mark.parametrize('tile', TILES)
def test_duplicate_positions_last_wins(tile):
    """Pairs of one block naming one position twice or more: within one
    32-pair chunk and across a chunk boundary of the macroblock's range
    (macroblock 0's first block: position 7 at pairs 5 and 9, 11 at 20 and
    36; macroblock 2's range starts mid-stream), the later pair wins, as
    the in-order scatter of the plain version and of jsmpeg_tpu; and the
    wire with each overwritten pair retired (bit 6 set, d_k3_check's
    reference on the card, where the plain version's repeated indices
    pick no defined winner) unpacks the same."""
    rng = np.random.default_rng(31)
    F, n_mb = 2, 5
    cbp = [0b000011, 0, 0b110101, 0b000001, 0, 0b001000, 0b111111, 0, 0,
           0b000010]
    first = list(rng.integers(0, 64, 40))
    first[5] = first[9] = 7
    first[20] = first[36] = 11
    blocks = [first, [3, 3, 3, 60]]
    blocks += [list(rng.integers(0, 64, int(rng.integers(1, 40))))
               for _ in range(sum(bin(c).count('1') for c in cbp) - 2)]
    buf, sizes = _wire(_batch(rng, F, n_mb, cbp, blocks), n_mb)
    plain = _check_all(buf, sizes, 'duplicates', tile=tile)
    lat = tm.levels_dense(plain).levels.reshape(-1, 6, 64)
    assert int(lat[0, 0, 11]) != 0 and int(lat[0, 1, 3]) != 0
    retired = k3m.k3_retire_overwritten(buf[None], sizes)
    assert int((retired != buf[None]).sum()) > 40
    _assert_levels_equal(tm.unpack_wires_ref(torch.as_tensor(retired),
                                             *sizes), plain, 'retired')


@pytest.mark.parametrize('name', CASES)
def test_shuffled_interleaving_same_lattice(name):
    """Launch A's tiles started in ticket order but stepped in a random
    interleaving (each look-back waiting, yielding, on tiles that have
    published nothing yet), and launch B's CTAs in a random order, give
    the lattice of the in-order mirror, the plain version and
    jsmpeg_tpu, at tiles small enough that look-backs span windows."""
    buf, sizes = _case(name)
    for seed in (0, 1):
        _check_all(buf, sizes, f'{name} seed {seed}', tile=8,
                   write_mbs=3, rng=np.random.default_rng(seed))


@pytest.mark.parametrize('write_mbs', [k3m.K3_WRITE_MBS, 7])
def test_stack_of_four_off_the_write_tile(write_mbs):
    """Four streams of n_mb = 25 macroblocks (not a multiple of the write
    tile) at shared sizes: no write tile crosses a frame or a stream's
    columns (k3_write_tiles, which the mirror stores through, each level
    once), and each stream's columns equal its own wire's unpack by the
    plain version and by jsmpeg_tpu."""
    rng = np.random.default_rng(41)
    F, n_mb, S = 3, 25, 4
    assert n_mb % write_mbs
    batches = [_synthetic_batch(rng, F, n_mb, wide=False) for _ in range(S)]
    n_pairs = max(len(b['sp_pos']) for b in batches) + 9
    n_esc = max(len(b['sp_esc']) for b in batches) + 2
    n_runs = max(len(b['run_len']) for b in batches) + 1
    n_blk = max(b['n_blocks'] for b in batches)
    bufs = np.stack([tm.build_fused_buffer_sized(
        b, F, n_pairs, n_runs, n_mb, False, n_esc) for b in batches])
    sizes = (F, n_mb, n_runs, False, n_pairs, n_esc, n_blk)
    tiles = list(k3m.k3_write_tiles(S, F, n_mb, write_mbs))
    assert len(tiles) == S * F * -(-n_mb // write_mbs)
    for st, f, m0, n in tiles:
        assert 0 <= st < S and 0 <= f < F and 1 <= n <= write_mbs
        assert m0 + n <= n_mb
    assert sum(n for *_, n in tiles) == S * F * n_mb
    t = torch.as_tensor(bufs)
    got = k3m.wire_unpack_mirror(t, *sizes, write_mbs=write_mbs)
    _assert_levels_equal(got, tm.unpack_wires_ref(t, *sizes), 'joint')
    dense = tm.levels_dense(got)
    for s, buf in enumerate(bufs):
        cols = slice(s * n_mb, (s + 1) * n_mb)
        _assert_levels_equal(type(got)(*[x[:, cols] for x in dense[:7]]),
                             _jax_levels(buf, sizes), f'stream {s} jax')


@pytest.mark.parametrize('tile', TILES)
def test_macroblock_over_32_pairs(tile):
    """Macroblocks whose six coded blocks hold 7 to 20 pairs each (42 to
    120 together: two to four chunks of the write pass, chunk boundaries
    inside blocks) beside sparse ones, equal to the plain version and to
    jsmpeg_tpu."""
    rng = np.random.default_rng(53)
    F, n_mb = 2, 6
    cbp = [63, 0, 63, 0b000100, 63, 0b100001] * F
    blocks = []
    for c in cbp:
        for _ in range(bin(c).count('1')):
            m = int(rng.integers(7, 21)) if c == 63 else 2
            blocks.append(sorted(rng.choice(64, m, replace=False)))
    buf, sizes = _wire(_batch(rng, F, n_mb, cbp, blocks, wide=True), n_mb)
    plain = _check_all(buf, sizes, 'dense', tile=tile)
    per_mb = (tm.levels_dense(plain).levels != 0).reshape(F * n_mb,
                                                          -1).sum(1)
    assert int(per_mb.max()) > 32


# ------------------------------------------- the compact form's contract

def k1_calls(monkeypatch):
    """Every K1 call of the decode paths as models.mpeg1 makes it, in
    order: ('compact', rows, named rows) for K1's compact form,
    ('dense', blocks) for its levels and premultiplied forms."""
    calls = []
    compact, dense = tm.dequant_idct_compact, tm.dequant_idct

    def on_compact(levels, blk_ids, *a):
        calls.append(('compact', int(levels.shape[0]),
                      int((blk_ids >= 0).sum())))
        return compact(levels, blk_ids, *a)

    def on_dense(x, *a, **k):
        calls.append(('dense', int(x.shape[0]) * 6))
        return dense(x, *a, **k)

    monkeypatch.setattr(tm, 'dequant_idct_compact', on_compact)
    monkeypatch.setattr(tm, 'dequant_idct', on_dense)
    return calls


def _assert_compact(la, n_blk, what):
    """The compact contract on one stream's unpack: row k is coded-block
    ordinal k (its id the k-th coded block's flat id, row-major), rows
    past the coded blocks are zero with id -1, and a coded block past
    ordinal n_blk - 1 has no row."""
    ids = torch.nonzero(la.coded.reshape(-1)).flatten()
    n = min(len(ids), n_blk)
    assert la.levels.shape == (n_blk, 64) and la.blk_ids.shape == (n_blk,)
    assert la.blk_ids.dtype == torch.int32, what
    np.testing.assert_array_equal(la.blk_ids[:n].numpy(), ids[:n].numpy(),
                                  err_msg=f'{what} ids')
    assert bool((la.blk_ids[n:] == -1).all()), what
    assert not bool(la.levels[n:].any()), what


@pytest.mark.parametrize('name', CASES)
def test_compact_rows_are_the_coded_blocks(name):
    """On each case's wire (bucketed ones with padding pairs and frames,
    bit-6 markers, ordinals past n_blk, more bit-7 pairs than n_blk, an
    empty wire) the plain version's rows are the coded blocks by ordinal,
    each equal to its block of jsmpeg_tpu's dense lattice; a coded block
    with no pair left (a bit-6 empty-block marker) is a zero row."""
    buf, sizes = _case(name)
    la = tm.unpack_wires_ref(torch.as_tensor(buf)[None], *sizes)
    _assert_compact(la, sizes[6], name)
    jax = np.asarray(_jax_levels(buf, sizes).levels).reshape(-1, 64)
    named = la.blk_ids >= 0
    np.testing.assert_array_equal(la.levels[named].numpy(),
                                  jax[la.blk_ids[named].numpy()])


@pytest.mark.parametrize('tile', TILES)
def test_compact_stack_at_shared_sizes(tile):
    """The vmap fleet's [S, L] wires at shared sizes (n_blk the largest
    stream's): each stream's rows at [s*n_blk, (s+1)*n_blk), its coded
    blocks by ordinal with ids in the joint [F, S*n_mb] layout, the rows
    past its own count (all of the idle stream's) zero with id -1; the
    mirror's launch B zeroes them in shares over the stream's warps."""
    batches, n_mb = _stream_batches()
    real = [b for b in batches if b]
    F = max(b['n'] for b in real)
    n_pairs = max(len(b['sp_pos']) for b in real)
    n_esc = max(max(len(b['sp_esc']) for b in real), 1)
    n_runs = max(len(b['run_len']) for b in real)
    n_blk = max(b['n_blocks'] for b in real)
    bufs = np.stack([tm.build_fused_buffer_sized(
        b or _concat_cell([], 0), F, n_pairs, n_runs, n_mb, False, n_esc)
        for b in batches])
    sizes = (F, n_mb, n_runs, False, n_pairs, n_esc, n_blk)
    t = torch.as_tensor(bufs)
    got = tm.unpack_wires(t, *sizes)
    S = len(batches)
    for s in range(S):
        rows = slice(s * n_blk, (s + 1) * n_blk)
        own = tm.unpack_wires_ref(t[s:s + 1], *sizes)
        _assert_compact(own, n_blk, f'stream {s}')
        ids = own.blk_ids
        joint = torch.where(ids >= 0, (ids // (n_mb * 6) * S + s) * n_mb * 6
                            + ids % (n_mb * 6), -1)
        np.testing.assert_array_equal(got.blk_ids[rows].numpy(),
                                      joint.numpy(), err_msg=f'stream {s}')
        np.testing.assert_array_equal(got.levels[rows].numpy(),
                                      own.levels.numpy())
    assert int((got.blk_ids[2 * n_blk:] == -1).sum()) == n_blk
    assert len({b['n_blocks'] for b in real}) > 1
    _assert_levels_equal(k3m.wire_unpack_mirror(t, *sizes, tile=tile,
                                                write_mbs=7), got, 'mirror')

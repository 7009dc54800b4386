"""K3, the wire unpack (jsmpeg_tpu_torch/csrc/wire_unpack.cu), written out
for its checks: its two launches step by step in plain torch
(`wire_unpack_mirror`, at any tile, in ticket order or in a random
interleaving) and its write tiles (`k3_write_tiles`), beside the
last-wins reference of wires whose blocks name a position twice
(`k3_retire_overwritten`, defined with the card's kernel cases in
jsmpeg_tpu_torch/testing/kernel_cases.py).  tests/test_torch_unpack.py
holds the mirror to the plain version and to jsmpeg_tpu on the CPU;
chip_smoke.py's d_k3_check holds the kernel to `k3_retire_overwritten`'s
wires on the card.  Every wire, lattice, field and scratch index the
mirror's launches use is asserted inside the region it addresses
(`_inside`, an AssertionError naming it): the CPU twin of the checked
build's bounds accessors (csrc/checked.cuh), which
tests/test_torch_checked.py runs over the fuzz corpus's packed batches.
Imports torch and jsmpeg_tpu_torch only."""

from __future__ import annotations

import torch

from jsmpeg_tpu_torch.models.mpeg1 import _bitmap_bytes
from jsmpeg_tpu_torch.ops.frame import LevelsArrays
from jsmpeg_tpu_torch.testing.kernel_cases import (  # noqa: F401
    k3_retire_overwritten)

# csrc/wire_unpack.cu's tiles: launch A's threads a CTA (one macroblock
# each) and pairs a thread, launch B's macroblocks a CTA and a warp
K3_SCAN_THREADS, K3_PAIR_ITEMS, K3_WRITE_MBS, K3_WARP_MBS = 256, 8, 32, 4
# launch A's pair tile (kPairTile); its macroblock tile is K3_SCAN_THREADS
K3_TILE = K3_SCAN_THREADS * K3_PAIR_ITEMS


def _inside(idx, lo: int, hi: int, what: str) -> None:
    """Every index in `idx` (an int or a tensor) lies in [lo, hi)."""
    t = torch.as_tensor(idx)
    if t.numel() and not (int(t.min()) >= lo and int(t.max()) < hi):
        raise AssertionError(f'{what}: index {int(t.min())}..{int(t.max())}'
                             f' outside [{lo}, {hi})')


def k3_write_tiles(n_streams: int, n_frames: int, n_mb: int,
                   write_mbs: int = K3_WRITE_MBS):
    """K3's launch B CTAs in blockIdx order, as (stream, frame, first
    macroblock, macroblocks): `write_mbs` consecutive macroblocks of one
    frame of one stream, each frame's last tile short, so no tile crosses
    a frame or a stream's columns of the joint layout."""
    per = -(-n_mb // write_mbs)
    for cta in range(n_streams * n_frames * per):
        tt, fs = cta % per, cta // per
        m0 = tt * write_mbs
        yield fs // n_frames, fs % n_frames, m0, min(write_mbs, n_mb - m0)


def wire_unpack_mirror(bufs: torch.Tensor, n_frames: int, n_mb: int,
                       n_runs: int, mv_wide: bool, n_pairs: int, n_esc: int,
                       n_blk: int, tile: int = K3_TILE,
                       write_mbs: int = K3_WRITE_MBS,
                       rng=None) -> LevelsArrays:
    """K3's two launches in plain torch, step by step, for the tests (CPU
    tensors); same contract as unpack_wires_ref.

    Launch A: tiles of tile // K3_PAIR_ITEMS macroblocks (one a thread)
    and of `tile` pairs, numbered by ticket stream by stream (the
    macroblock tiles, then the pair tiles).  Each tile is a generator
    that steps as the kernel's CTA through its chained scan: it publishes
    its aggregate, looks back over its chain 32 tiles a step (a lane
    keeps the first word it sees set, and the step waits, yielding, while
    one is still 0) until it meets an inclusive prefix, and publishes its
    inclusive prefix.  A macroblock tile first chains its run starts on a
    chain that never waits (a step of as many tiles as the tile has
    macroblocks, a thread each, taking an earlier tile's inclusive prefix
    where one is published, else counting that tile's bitmap bits),
    then reads its records and fields, chains the coded blocks and
    writes each coded block's id at its ordinal (the stream's last tile
    also its count of coded blocks); a pair tile chains the bit-7 pairs
    and the escapes.
    Launch B: per k3_write_tiles CTA, per warp of K3_WARP_MBS macroblocks,
    zeroed rows, the coded block of ordinal k at row k - k0 (k0 the
    warp's first ordinal); each macroblock's ordinal bounds, its one pair
    range walked 32 pairs a chunk in wire order, the last lane of each
    equal (row, position) in a chunk winning; the warp's rows stored
    whole at rows k0.. of its stream's, then its share of the stream's
    rows past its coded blocks zeroed with id -1; each row and id
    exactly once.

    rng (a numpy Generator): tiles start in ticket order but step in a
    random interleaving, and B's CTAs run in a random order; None runs
    each tile to its end in ticket order."""
    S = bufs.shape[0]
    F, R, P, E = n_frames, n_runs, n_pairs, n_esc
    N, M = F * n_mb, S * n_mb
    w = 8 if mv_wide else 4
    o_rec = F + _bitmap_bytes(F, n_mb)
    o_pos = o_rec + w * R
    o_v8, o_esc = o_pos + P, o_pos + 2 * P
    L = o_esc + 2 * E
    if bufs.shape[1] != L:
        raise AssertionError(f'wires of {bufs.shape[1]} bytes, the sizes '
                             f'give {L}')
    mb_tile = max(tile // K3_PAIR_ITEMS, 1)
    mt, pt = -(-N // mb_tile), -(-P // tile)
    high = 31                          # a pair word's escape count shift
    wires = bufs.long()
    qscale = torch.zeros((F, M), dtype=torch.uint8)
    coded = torch.zeros((F, M, 6), dtype=torch.bool)
    intra = torch.zeros((F, M), dtype=torch.bool)
    written = torch.zeros((F, M), dtype=torch.bool)
    mv_h = torch.zeros((F, M), dtype=torch.int32)
    mv_v = torch.zeros((F, M), dtype=torch.int32)
    # launch A's scratch: the chains' (flag, value) words (0 nothing, 1
    # aggregate, 2 inclusive prefix), zeroed as by the launcher's memset
    chains = {(kind, st): [(0, 0)] * (pt if kind == 'pair' else mt)
              for kind in ('run', 'cod', 'pair') for st in range(S)}
    live1 = [0] * S
    n_b7 = [None] * S
    first = [[None] * n_blk for _ in range(S)]
    mbw = [[None] * N for _ in range(S)]
    pv = [[None] * P for _ in range(S)]
    n_cod = [None] * S
    ids = [None] * (S * n_blk)          # blk_ids, each written once

    def set_id(r, v):
        _inside(r, 0, S * n_blk, 'block id')
        if ids[r] is not None:
            raise AssertionError(f'block id of row {r} written twice')
        ids[r] = v

    def le16(lo, hi):                   # little-endian int16 from bytes
        v = lo | (hi << 8)
        return torch.where(v >= 1 << 15, v - (1 << 16), v)

    def signed8(x):
        return torch.where(x >= 128, x - 256, x)

    def look_back(chain, j):
        total, top = 0, j - 1
        while True:
            snap = [None] * 32
            while True:
                for lane in range(32):
                    if snap[lane] is None or not snap[lane][0]:
                        t = top - lane
                        if t >= 0:
                            _inside(t, 0, len(chain), 'look-back status')
                        snap[lane] = chain[t] if t >= 0 else (2, 0)
                if all(flag for flag, _ in snap):
                    break
                yield
            for flag, value in snap:
                total += value
                if flag == 2:
                    return total
            top -= 32

    def prefix(chain, j, agg):
        _inside(j, 0, len(chain), 'status word')
        if j == 0:
            chain[0] = (2, agg)
            return 0
        chain[j] = (1, agg)
        yield
        excl = yield from look_back(chain, j)
        chain[j] = (2, excl + agg)
        return excl

    def tile_starts(buf, t):
        # the run starts of macroblock tile t (the kernel's tile holds
        # whole bitmap words; here bits, at any tile)
        i = torch.arange(t * mb_tile, min((t + 1) * mb_tile, N))
        _inside(F + (i >> 3), F, o_rec, 'run-start bitmap')
        return (buf[F + (i >> 3)] >> (i & 7)) & 1

    def run_prefix(chain, buf, j, total):
        # the run-start chain: a step of mb_tile tiles (the kernel's
        # threads a CTA), a thread taking its tile's inclusive prefix if
        # published, else counting the tile's bits; it never waits
        excl, top = 0, j - 1
        while top >= 0:
            snap = [chain[top - k] if top - k >= 0 else (2, 0)
                    for k in range(mb_tile)]
            for k, (flag, value) in enumerate(snap):
                if flag == 2:
                    excl += value
                    break
                excl += int(tile_starts(buf, top - k).sum())
            else:
                top -= mb_tile
                continue
            break
        chain[j] = (2, excl + total)
        return excl

    def mb_tile_run(st, t):
        buf = wires[st]
        i = torch.arange(t * mb_tile, min((t + 1) * mb_tile, N))
        start = tile_starts(buf, t)
        yield
        run = run_prefix(chains['run', st], buf, t, int(start.sum())) + \
            start.cumsum(0)
        slot = (run - 1).clamp(0, R - 1)
        _inside(o_rec + slot[:, None] * w + torch.arange(w), o_rec, o_pos,
                'run record')
        rec = buf[o_rec + slot[:, None] * w + torch.arange(w)]
        if mv_wide:
            mvh, mvv = le16(rec[:, 0], rec[:, 1]), le16(rec[:, 2], rec[:, 3])
            flags, cbp = rec[:, 4], rec[:, 5]
        else:
            flags, cbp = rec[:, 0], rec[:, 1]
            mvh, mvv = signed8(rec[:, 2]), signed8(rec[:, 3])
        f, col = i // n_mb, st * n_mb + i % n_mb
        _inside(f, 0, F, 'field frame')
        _inside(col, st * n_mb, (st + 1) * n_mb, 'field column')
        qscale[f, col] = (flags & 31).to(torch.uint8)
        intra[f, col] = ((flags >> 5) & 1).bool()
        written[f, col] = ((flags >> 6) & 1).bool()
        coded[f, col] = ((cbp[:, None] >> torch.arange(6)) & 1).bool()
        mv_h[f, col] = mvh.to(torch.int32)
        mv_v[f, col] = mvv.to(torch.int32)
        cbp = cbp & 63
        per = ((cbp[:, None] >> torch.arange(6)) & 1).sum(1)
        excl = yield from prefix(chains['cod', st], t, int(per.sum()))
        cod = excl + per.cumsum(0) - per
        _inside(i, 0, N, 'macroblock word')
        for ii, word in zip(i.tolist(), ((cod << 6) | cbp).tolist()):
            mbw[st][ii] = word
        # each coded block's id (in the joint layout) at its ordinal's row
        for ii, k, c in zip(i.tolist(), cod.tolist(), cbp.tolist()):
            j = (ii // n_mb * S + st) * n_mb + ii % n_mb
            for b in [b for b in range(6) if c >> b & 1][:max(n_blk - k, 0)]:
                set_id(st * n_blk + k, j * 6 + b)
                k += 1
        if t == mt - 1:
            n_cod[st] = excl + int(per.sum())

    def pair_tile_run(st, t):
        buf = wires[st]
        p = torch.arange(t * tile, min((t + 1) * tile, P))
        _inside(o_pos + p, o_pos, o_v8, 'pair position')
        _inside(o_v8 + p, o_v8, o_esc, 'pair value')
        pos, v8 = buf[o_pos + p], signed8(buf[o_v8 + p])
        b7, esc = pos >> 7, (v8 == -128).long()
        pre = yield from prefix(chains['pair', st], t,
                                int(b7.sum()) + (int(esc.sum()) << high))
        c7 = (pre & ((1 << high) - 1)) + b7.cumsum(0)
        ce = (pre >> high) + esc.cumsum(0)
        if t == pt - 1:
            n_b7[st] = int(c7[-1])
        e = o_esc + 2 * (ce - 1).clamp(0, E - 1)
        _inside(e[esc.bool()], o_esc, L - 1, 'escape')
        val = torch.where(esc.bool(), le16(buf[e], buf[e + 1]), v8)
        for pp, word in zip(p.tolist(),
                            (((val & 0xffff) << 16) | pos).tolist()):
            pv[st][pp] = word
        _inside(p, 0, P, 'pair word')
        named = (b7 == 1) & (c7 - 1 < n_blk)
        _inside(c7[named] - 1, 0, n_blk, "ordinal's first pair")
        for k, pp in zip((c7[named] - 1).tolist(), p[named].tolist()):
            first[st][k] = pp
        live = p[(pos & 0x40) == 0]
        if len(live):
            live1[st] = max(live1[st], int(live[-1]) + 1)

    # launch A: tickets stream by stream, the macroblock tiles first
    tickets = [run(st, t) for st in range(S)
               for run, n in ((mb_tile_run, mt), (pair_tile_run, pt))
               for t in range(n)]
    if rng is None:
        for tile_run in tickets:
            for _ in tile_run:
                pass
    else:
        running, started, steps = [], 0, 0
        while started < len(tickets) or running:
            steps += 1
            if steps > 10**6:
                raise RuntimeError('launch A made no progress')
            if started < len(tickets) and (not running or rng.random() < .5):
                running.append(tickets[started])
                started += 1
                continue
            k = int(rng.integers(len(running)))
            try:
                next(running[k])
            except StopIteration:
                running.pop(k)

    # launch B
    levels = torch.zeros((S * n_blk, 64), dtype=torch.int16)
    stored = torch.zeros(S * n_blk, dtype=torch.bool)

    def scatter_mb(st, i, rows):
        # macroblock i's pairs into rows, its coded blocks' rows
        word = mbw[st][i]
        cbp, k0 = word & 63, word >> 6
        n_c = min(bin(cbp).count('1'), max(n_blk - k0, 0))
        if not n_c:
            return
        named = min(n_b7[st], n_blk)
        _inside(i, 0, N, 'macroblock word')
        _inside([k for k in range(k0, k0 + n_c + 1) if 0 < k < named], 0,
                n_blk, "ordinal's first pair")
        bnd = [min(0 if k == 0 else first[st][k] if k < named else P,
                   live1[st]) for k in range(k0, k0 + n_c + 1)]
        _inside(bnd, 0, P + 1, 'pair range bound')
        for base in range(bnd[0], bnd[n_c], 32):
            lanes = []
            for lane in range(32):
                p = base + lane
                if p < bnd[n_c]:
                    _inside(p, 0, P, 'pair word')
                x = pv[st][p] if p < bnd[n_c] else 0x40
                q = sum(r <= p for r in bnd[1:n_c])
                live = p < bnd[n_c] and not x & 0x40
                lanes.append((q << 6 | (x & 63)) if live else 0x1000 | lane)
            # __match_any_sync: the highest lane of each key writes
            last = {key: lane for lane, key in enumerate(lanes)}
            for lane, key in enumerate(lanes):
                if key < 0x1000 and last[key] == lane:
                    _inside(key, 0, len(rows) * 64, 'tile level')
                    v = pv[st][base + lane] >> 16
                    rows[key >> 6, key & 63] = v - (1 << 16) \
                        if v >= 1 << 15 else v

    def store(r0, rows, what):
        _inside([r0, r0 + len(rows) - 1], 0, S * n_blk, what)
        if bool(stored[r0:r0 + len(rows)].any()):
            raise AssertionError(f'{what}: rows {r0}.. stored twice')
        levels[r0:r0 + len(rows)] = rows
        stored[r0:r0 + len(rows)] = True

    per_frame = -(-n_mb // write_mbs)
    warps = -(-write_mbs // K3_WARP_MBS)
    ctas = list(k3_write_tiles(S, F, n_mb, write_mbs))
    if rng is not None:
        rng.shuffle(ctas)
    for st, f, m0, n in ctas:
        _inside(f, 0, F, 'lattice frame')
        _inside([m0, m0 + n - 1], 0, n_mb, 'lattice macroblock')
        for wp in range(warps):
            a = wp * K3_WARP_MBS
            nw = min(K3_WARP_MBS, n - a)
            if nw > 0:
                # the warp's macroblocks: ordinals k0.. at rows 0..
                i0 = f * n_mb + m0 + a
                ks = [mbw[st][i0 + q] >> 6 for q in range(nw)]
                n_c = [min(bin(mbw[st][i0 + q] & 63).count('1'),
                           max(n_blk - k, 0)) for q, k in enumerate(ks)]
                rows = torch.zeros((nw * 6, 64), dtype=torch.int16)
                for q in range(nw):
                    scatter_mb(st, i0 + q, rows[ks[q] - ks[0]:])
                if sum(n_c):
                    store(st * n_blk + ks[0], rows[:sum(n_c)],
                          f'stream {st} frame {f} macroblocks {m0 + a}..')
            # the warp's share of the stream's rows past its coded blocks
            cnt = min(n_cod[st], n_blk)
            if cnt < n_blk:
                g = (f * per_frame + m0 // write_mbs) * warps + wp
                share = -(-(n_blk - cnt) // (F * per_frame * warps))
                r0 = st * n_blk + cnt + g * share
                r1 = min(r0 + share, (st + 1) * n_blk)
                if r1 > r0:
                    store(r0, torch.zeros((r1 - r0, 64), dtype=torch.int16),
                          f'stream {st} rows past its coded blocks')
                    for r in range(r0, r1):
                        set_id(r, -1)
    if not bool(stored.all()) or None in ids:
        raise AssertionError('launch B left rows or ids unstored')
    return LevelsArrays(levels=levels, qscale=qscale, coded=coded,
                        intra=intra, written=written, mv_h=mv_h, mv_v=mv_v,
                        blk_ids=torch.tensor(ids, dtype=torch.int32))


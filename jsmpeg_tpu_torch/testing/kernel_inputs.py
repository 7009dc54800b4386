"""Random inputs for the kernels' checks on the card, one copy for every
rig that builds them: chip_smoke.py's c_k1_check / d_k2_check /
d_k3_check, k2_sweep.py and the sanitizer rig's `--cuda-driver`
(host/native/sanitize_check.py).  Each function draws from the `rng` it is
given in a fixed order, so a seed names its inputs."""

from __future__ import annotations

import numpy as np


def k1_inputs(torch, n_mb: int, rng, dev):
    """Random levels with the edge cases: clamps at +/-2047/-2048, large
    levels whose IDCT wraps int32, zeros (escape-coded zeros arrive as 0),
    intra DC up to 2047, qscale 1 and 31, custom matrices."""
    lv = rng.integers(-255, 256, (n_mb, 6, 64)).astype(np.int16)
    lv[rng.random((n_mb, 6, 64)) < 0.7] = 0
    edge = rng.random((n_mb, 6, 64))
    lv[edge < 0.01] = 2047
    lv[(edge >= 0.01) & (edge < 0.02)] = -2048
    lv[(edge >= 0.02) & (edge < 0.025)] = -2047
    lv[(edge >= 0.025) & (edge < 0.027)] = np.int16(32767)
    lv[(edge >= 0.027) & (edge < 0.029)] = np.int16(-32768)
    lv[:, :, 0] = np.where(rng.random((n_mb, 6)) < 0.5,
                           rng.integers(0, 2048, (n_mb, 6)), lv[:, :, 0])
    qs = rng.integers(1, 32, n_mb).astype(np.uint8)
    qs[::7] = 1
    qs[3::7] = 31
    intra = rng.random(n_mb) < 0.5
    iq = rng.integers(1, 256, 64).astype(np.int32)
    nq = rng.integers(1, 256, 64).astype(np.int32)
    iq[0] = 8
    t = lambda a: torch.as_tensor(a, device=dev)
    return t(lv), t(qs), t(intra), t(iq), t(nq)


def k1_compact_inputs(torch, n_mb: int, rng, dev):
    """K1's compact form on k1_inputs' blocks: a random fifth of the
    n_mb * 6 blocks in a random order as the rows (row 0 always a block),
    every eighth other row named by no block (-1).  Returns (levels int16
    [n, 64], blk_ids int32 [n], qscale, intra, intra_q, non_intra_q,
    n_blocks): dequant_idct_compact's arguments."""
    lv, qs, intra, iq, nq = k1_inputs(torch, n_mb, rng, dev)
    n_blocks = n_mb * 6
    ids = rng.permutation(n_blocks)[:max(n_blocks // 5, 1)].astype(np.int32)
    ids[1::8] = -1
    rows = lv.reshape(n_blocks, 64)[torch.as_tensor(
        np.maximum(ids, 0), device=dev).long()]
    return (rows.contiguous(), torch.as_tensor(ids, device=dev), qs, intra,
            iq, nq, n_blocks)


def random_planes(torch, rng, rows: int, W: int, dev):
    """Planes of random bytes, `rows` x `W` luma and its chroma halves."""
    from ..ops.frame import Planes
    return Planes(*[torch.as_tensor(rng.integers(
        0, 256, (rows // d, W // d), dtype=np.uint8), device=dev)
        for d in (1, 2, 2)])


def k2_vectors(kind: str, rng, n_frames: int, mb_h: int, mb_w: int,
               n_seg: int = 1):
    """int32 [n_frames, n_mb, 2] vectors of a K2 check.  'random': all
    half-pel parities, vectors past every frame and segment edge, wide and
    negative odd ones.  'far': each macroblock reads the opposite edge of
    its segment in the previous frame (rows of the top half the last
    rows, of the bottom half the first; columns likewise), the wait
    design's worst case.  'one_row': exactly +-16 luma rows (half-pel
    +-32), the tightest dependency."""
    n_mb = mb_h * mb_w
    if kind == 'random':
        reach = rng.choice([9, 300, 3000], size=(n_frames, n_mb, 2))
        mv = rng.integers(-reach, reach + 1)
        mv[:, ::11] = [-3, -5]               # negative odd: chroma -1, -2
        return mv.astype(np.int32)
    seg_h = mb_h // n_seg
    row = np.arange(n_mb) // mb_w % seg_h
    col = np.arange(n_mb) % mb_w
    if kind == 'far':
        mv_v = np.where(row < seg_h // 2, 32 * (seg_h - 1 - row), -32 * row)
        mv_h = np.where(col < mb_w // 2, 32 * (mb_w - 1 - col), -32 * col)
        mv = np.stack([mv_h, mv_v], -1)[None].repeat(n_frames, 0)
        return (mv + rng.integers(0, 2, mv.shape)).astype(np.int32)
    if kind != 'one_row':
        raise ValueError(f'unknown vectors {kind!r}')
    mv_v = rng.choice([-32, 32], size=(n_frames, n_mb))
    mv_h = rng.integers(-20, 21, (n_frames, n_mb))
    return np.stack([mv_h, mv_v], -1).astype(np.int32)


def k2_batch(torch, rng, dev, F: int, rows: int, W: int,
             vectors: str = 'random', n_seg: int = 1):
    """A K2 batch of F frames of `rows` x `W` (n_seg streams stacked along
    rows): (cur, fwd, resid, meta, mv).  The carry planes are random (so
    every segment holds other content than its neighbours), the vectors
    `k2_vectors(vectors)`, the modes a random mix of written/coded/intra
    (every macroblock written but for 'random'), the residuals wrap
    int32."""
    n_mb = (W // 16) * (rows // 16)
    cur = random_planes(torch, rng, rows, W, dev)
    fwd = random_planes(torch, rng, rows, W, dev)
    mv = k2_vectors(vectors, rng, F, rows // 16, W // 16, n_seg)
    resid = rng.integers(-400, 400, (F, n_mb, 6, 64)).astype(np.int32)
    resid[rng.random((F, n_mb, 6, 64)) < 0.001] = 2**31 - 1
    resid[rng.random((F, n_mb, 6, 64)) < 0.001] = -2**31
    mode = rng.integers(0, 256, (F, n_mb)).astype(np.int32)
    if vectors != 'random':
        mode |= 0x80
    meta = torch.as_tensor(np.stack([mv[..., 0], mv[..., 1], mode], axis=-1),
                           device=dev)
    return cur, fwd, torch.as_tensor(resid, device=dev), meta, mv


def k2_band(torch, rng, dev, S: int, local: int, mb_h: int, halo: int,
            W: int, band: int):
    """One band launch of K2's band mode: band `band` (`local` macroblock
    rows of a picture of `mb_h`) of S segments, its halos `halo` rows
    deep.  Every plane and halo is random, so a read the clamp should have
    kept out shows; vectors reach the halo's full depth past the band's
    edges (one in three up, one in three down), columns past both sides.
    Returns (cur, fwd, resid [1, ...], meta [1, ...], Band)."""
    from ..ops.kernels import Band
    n_mb = S * local * (W // 16)
    reach = 2 * (16 * halo - 1)
    mv = np.stack([rng.integers(-300, 301, n_mb),
                   rng.integers(-reach, reach + 1, n_mb)], -1)
    mv[::3, 1] = reach
    mv[1::3, 1] = -reach
    mv[::11] = [-3, -5]
    mode = rng.integers(0, 256, n_mb)
    meta = torch.as_tensor(np.stack([mv[:, 0], mv[:, 1], mode], -1)[None]
                           .astype(np.int32), device=dev)
    resid = rng.integers(-400, 400, (1, n_mb, 6, 64)).astype(np.int32)
    resid[rng.random(resid.shape) < 0.001] = 2**31 - 1
    b = Band(random_planes(torch, rng, S * 16 * halo, W, dev),
             random_planes(torch, rng, S * 16 * halo, W, dev),
             band * local, mb_h, halo, 3)
    return (random_planes(torch, rng, S * 16 * local, W, dev),
            random_planes(torch, rng, S * 16 * local, W, dev),
            torch.as_tensor(resid, device=dev), meta, b)


def k3_random_batch(rng, n_frames: int, n_mb: int, wide: bool) -> dict:
    """A packed batch (the parser's dict) of random macroblocks in runs of
    1-7 equal (flags, cbp, mv), vectors in int8 or (wide) past it; every
    coded block 1-8 pairs at increasing positions (bit 7 on the first),
    one block in 16 an empty-block marker (0xC0), values int8 with one in
    six escaped to the int16 side stream."""
    n = n_frames * n_mb
    lens = rng.integers(1, 8, n)
    cut = int(np.searchsorted(np.cumsum(lens), n))
    lens = lens[:cut + 1]
    lens[-1] -= int(lens.sum()) - n
    R = len(lens)
    cbp = rng.integers(0, 64, R).astype(np.uint8)
    cbp[rng.random(R) < 0.3] = 0
    lim = 600 if wide else 128
    mv = rng.integers(-lim, lim, (R, 2)).astype(np.int16)
    n_blocks = int(np.unpackbits(np.repeat(cbp, lens)[:, None],
                                 axis=1)[:, 2:].sum())
    # per block: positions = cumsum of gaps in [1, 8] minus 1, the first m
    pos = np.cumsum(rng.integers(1, 9, (n_blocks, 8)), axis=1) - 1
    m = rng.integers(1, 9, n_blocks)
    keep = (np.arange(8) < m[:, None]) & (pos <= 63)
    pos = pos.astype(np.uint8)
    pos[:, 0] |= 0x80
    marker = rng.random(n_blocks) < 1 / 16
    pos[marker, 0] = 0xC0
    keep[marker, 1:] = False
    sp_pos = pos[keep]
    v8 = rng.integers(-127, 128, len(sp_pos)).astype(np.int8)
    v8[v8 == 0] = 1
    v8[rng.random(len(v8)) < 1 / 6] = -128
    v8[sp_pos == 0xC0] = 0
    esc = rng.integers(-2048, 2048, int((v8 == -128).sum())).astype(np.int16)
    return dict(n=n_frames, run_len=lens.astype(np.uint16),
                run_flags=rng.integers(0, 256, R).astype(np.uint8),
                run_cbp=cbp, run_mv=mv, sp_pos=sp_pos, sp_v8=v8,
                sp_esc=esc, n_blocks=n_blocks)


def k3_duplicate_positions(rng, batch: dict) -> dict:
    """The batch with one pair in three after its block's first naming the
    position of a random earlier pair of its block (its value kept), so
    blocks name positions twice or more, in one 32-pair chunk and across
    chunks of a macroblock's range: the later pair must win."""
    pos = batch['sp_pos'].copy()
    start = np.flatnonzero(pos >> 7)
    blk = np.cumsum(pos >> 7) - 1
    own = np.arange(len(pos)) - start[np.maximum(blk, 0)]
    pick = (own > 0) & (pos != 0xC0) & (rng.random(len(pos)) < 1 / 3)
    src = start[blk[pick]] + (rng.random(int(pick.sum())) *
                              own[pick]).astype(np.int64)
    pos[pick] = (pos[pick] & 0xC0) | (pos[src] & 63)
    return dict(batch, sp_pos=pos)


def k3_dense_batch(rng, n_frames: int, n_mb: int) -> dict:
    """An intra-only packed batch of coefficient-dense macroblocks: each
    its own run, intra and written, all six blocks coded with 20 to 64
    pairs at increasing positions (bit 7 on the first), so most blocks
    span more than one 32-pair chunk; values int8 with one in six
    escaped."""
    n = n_frames * n_mb
    m = rng.integers(20, 65, 6 * n)
    rank = np.argsort(np.argsort(rng.random((6 * n, 64)), axis=1), axis=1)
    _, cols = np.nonzero(rank < m[:, None])
    pos = cols.astype(np.uint8)
    pos[np.cumsum(m) - m] |= 0x80
    v8 = rng.integers(-127, 128, len(pos)).astype(np.int8)
    v8[v8 == 0] = 1
    v8[rng.random(len(v8)) < 1 / 6] = -128
    esc = rng.integers(-2048, 2048, int((v8 == -128).sum())).astype(np.int16)
    return dict(n=n_frames, run_len=np.ones(n, np.uint16),
                run_flags=(0x60 | rng.integers(1, 32, n)).astype(np.uint8),
                run_cbp=np.full(n, 63, np.uint8),
                run_mv=rng.integers(-128, 128, (n, 2)).astype(np.int16),
                sp_pos=pos, sp_v8=v8, sp_esc=esc, n_blocks=6 * n)


def exact_wire(batch: dict, n_mb: int):
    """A packed batch's wire v2 at its own sizes, as the decoder builds
    it: (uint8 [1, L], sizes (F, n_mb, n_runs, mv_wide, n_pairs, n_esc,
    n_blk))."""
    from ..models.mpeg1 import build_fused_buffer
    buf, n_blk, n_runs, wide, n_pairs, n_esc = build_fused_buffer(batch,
                                                                  n_mb)
    return buf[None], (batch['n'], n_mb, n_runs, wide, n_pairs, n_esc,
                       n_blk)


def sized_wires(batches, F: int, n_mb: int, n_pairs: int, n_runs: int,
                wide: bool, n_esc: int, n_blk: int):
    """Packed batches (None: an idle stream) as wires v2 at the sizes
    given, stacked: (uint8 [S, L], sizes)."""
    from ..models.mpeg1 import build_fused_buffer_sized
    from ..parallel.packed import _concat_cell
    bufs = np.stack([build_fused_buffer_sized(
        b or _concat_cell([], 0), F, n_pairs, n_runs, n_mb, wide, n_esc)
        for b in batches])
    return bufs, (F, n_mb, n_runs, wide, n_pairs, n_esc, n_blk)


def shared_wires(batches, F: int, n_mb: int):
    """Packed batches (None: an idle stream) stacked at their shared
    (largest) sizes, as the fleet's vmap mode stacks them."""
    from ..models.mpeg1 import mv_fits_narrow
    real = [b for b in batches if b]
    return sized_wires(batches, F, n_mb,
                       max(len(b['sp_pos']) for b in real),
                       max(len(b['run_len']) for b in real),
                       not all(mv_fits_narrow(b['run_mv']) for b in real),
                       max(max(len(b['sp_esc']) for b in real), 1),
                       max(b['n_blocks'] for b in real))

"""K2's wait set (csrc/mc_combine.cu `wait_set`, mirrored by
jsmpeg_tpu_torch.ops.frame.k2_wait_rows) against the rows each macroblock
really reads, derived independently from the plain version
`mc_combine_ref` by perturbation: for every macroblock row q of the
forward plane (and of the stale plane) set row q of all three planes to
255 over zero planes and see which macroblocks' outputs change.  A single
changed tap moves the 4-tap average by at least 64 and the residuals are
zero, so no read can hide.  Every (frame, row) read must be in the
macroblock's wait set, and every wait must be on an earlier frame."""

import numpy as np
import pytest
import torch

from jsmpeg_tpu_torch.ops import kernels
from jsmpeg_tpu_torch.ops.frame import Planes, k2_wait_rows, mc_combine_ref

MB_W, SEG_MB_H, F = 6, 5, 4          # 96 x 80 per segment, 4 frames
KEEP = 'keep'


def _meta(rng, n_mb, mb_h):
    """Random metadata over every case K2 waits on: all half-pel parities,
    negative odd vectors (chroma rounds toward zero), vectors past every
    edge, exactly +-16 rows (one row's reach) and to the opposite edge,
    written / coded / intra mixes, all-coded intra macroblocks (no base
    read) and intra ones that read their base."""
    reach = rng.choice([3, 9, 33, 100, 300], size=(F, n_mb, 2))
    mv = rng.integers(-reach, reach + 1)
    mv[:, ::7] = [-3, -5]
    mv[:, 1::7, 1] = rng.choice([-33, -32, 32, 33], size=mv[:, 1::7].shape[:2])
    row = np.arange(n_mb) // MB_W
    far = 32 * (mb_h - 1 - 2 * row)            # row r reads row mb_h-1-r
    mv[:, 2::7, 1] = far[2::7]
    mv[:, 3::11, 0] = -16 * MB_W * 2
    mode = rng.integers(0, 256, (F, n_mb))
    mode[:, ::5] = rng.choice([0x00, 0x40, 0x7F, 0x80, 0xC0, 0xFF],
                              size=mode[:, ::5].shape)
    return torch.as_tensor(np.stack([mv[..., 0], mv[..., 1], mode],
                                    -1).astype(np.int32))


def _changed(a: Planes, b: Planes, mb_h: int) -> torch.Tensor:
    """bool [n_mb]: macroblocks whose output pixels differ."""
    out = torch.zeros(mb_h, MB_W, dtype=torch.bool)
    for x, y, bs in zip(a, b, (16, 8, 8)):
        d = (x != y).reshape(mb_h, bs, MB_W, bs)
        out |= d.any(3).any(1)
    return out.reshape(-1)


def _reads(meta_k, mb_h, n_seg, live):
    """bool [2, n_mb, mb_h]: macroblock reads row q of the forward plane
    (0) or of the stale plane (1) in one frame step of mc_combine_ref."""
    H, W = mb_h * 16, MB_W * 16
    n_mb = mb_h * MB_W

    def planes(q=None):
        p = [torch.zeros(s, dtype=torch.uint8)
             for s in ((H, W), (H // 2, W // 2), (H // 2, W // 2))]
        if q is not None:
            for x, bs in zip(p, (16, 8, 8)):
                x[q * bs:(q + 1) * bs] = 255
        return Planes(*p)

    zero, resid = planes(), torch.zeros((n_mb, 6, 64), dtype=torch.int32)
    base = mc_combine_ref(zero, zero, resid, meta_k, n_seg, live)
    reads = torch.zeros((2, n_mb, mb_h), dtype=torch.bool)
    for q in range(mb_h):
        hot = planes(q)
        reads[0, :, q] = _changed(
            mc_combine_ref(zero, hot, resid, meta_k, n_seg, live), base, mb_h)
        reads[1, :, q] = _changed(
            mc_combine_ref(hot, zero, resid, meta_k, n_seg, live), base, mb_h)
    return reads


@pytest.mark.parametrize('n_seg,seg_frames,seed', [
    (1, None, 0), (1, None, 1), (1, [2], 2), (1, [0], 3),
    (3, None, 4), (3, [0, F, 2], 5), (3, [F, 1, 0], 6), (3, [3, 3, 3], 7)])
def test_wait_set_covers_every_read(n_seg, seg_frames, seed):
    rng = np.random.default_rng(seed)
    mb_h = n_seg * SEG_MB_H
    n_mb = mb_h * MB_W
    meta = _meta(rng, n_mb, mb_h)
    waits = k2_wait_rows(meta, mb_h, MB_W, n_seg, seg_frames)
    counts = kernels.check_segments(mb_h, F, n_seg, seg_frames)
    seen = {'fwd': 0, 'stale': 0, KEEP: 0}
    for k in range(F):
        live = [k < c for c in counts]
        reads = _reads(meta[k], mb_h, n_seg, live)
        dead = ~torch.as_tensor(live).repeat_interleave(SEG_MB_H * MB_W)
        # frame k's forward plane is output k-1, its stale plane output
        # k-2; earlier ones are the carried planes
        for src, j in ((0, k - 1), (1, k - 2)):
            if j < 0:
                continue
            missing = reads[src] & ~waits[k, :, j]
            bad = missing.any(1).nonzero().flatten().tolist()
            assert not bad, (f'frame {k}: macroblocks {bad} read rows of '
                             f'output {j} they do not wait for')
            hit = reads[src].any(1)
            if src == 0:
                seen[KEEP] += int((hit & dead).sum())
                seen['fwd'] += int((hit & ~dead).sum())
            else:
                seen['stale'] += int(hit.sum())
    # the case exercised what it should: forward reads where a segment
    # decodes frame 1 or later, stale reads where it decodes frame 2 or
    # later, kept rows where one stops before the last frame
    assert bool(seen['fwd']) == (max(counts) >= 2)
    assert bool(seen['stale']) == (max(counts) >= 3)
    assert bool(seen[KEEP]) == any(c < F for c in counts)


@pytest.mark.parametrize('n_seg,seg_frames', [(1, None), (3, [0, F, 2])])
def test_waits_are_on_earlier_frames_within_3_rows(n_seg, seg_frames):
    """The progress argument's premise: every wait is on an earlier frame
    (a smaller flattened index), none in frame 0, and a wait spans at most
    3 rows (one poll per lane)."""
    mb_h = n_seg * SEG_MB_H
    meta = _meta(np.random.default_rng(11), mb_h * MB_W, mb_h)
    waits = k2_wait_rows(meta, mb_h, MB_W, n_seg, seg_frames)
    k, _, j, _ = waits.nonzero().unbind(1)
    assert len(k) and bool((j < k).all())
    assert not waits[0].any()
    per_mb = waits.any(3).sum(2)
    assert int(per_mb.max()) == 1        # one output per macroblock
    span = waits.sum(3).amax(2)
    assert 1 <= int(span.max()) <= 3


def _one(mv_v, mode, row, k=2, n_seg=1, seg_frames=None, mb_h=SEG_MB_H):
    """The (output, rows) macroblock (row, column 0) of frame k waits for,
    every other macroblock skipped."""
    meta = torch.zeros((F, mb_h * MB_W, 3), dtype=torch.int32)
    meta[k, row * MB_W] = torch.tensor([0, mv_v, mode])
    w = k2_wait_rows(meta, mb_h, MB_W, n_seg, seg_frames)[k, row * MB_W]
    return [(int(j), w[j].nonzero().flatten().tolist())
            for j in range(F) if w[j].any()]


@pytest.mark.parametrize('mv_v,row,want', [
    (32, 1, [2, 3]),       # +16 rows: the next row and the 17th tap's row
    (-32, 2, [1, 2]),      # -16 rows
    (0, 2, [2, 3]),        # in place: the 17th staged row is row r + 1's
    (-1, 2, [1, 2, 3]),    # half-pel up: luma from row 16r - 1, chroma
                           # (vector 0) to row 8r + 8
    (-3, 0, [0]),          # past the top edge: clamped
    (300, 3, [4]),         # past the bottom edge: the last row
    (32 * 4, 0, [4]),      # the far vector: the opposite edge
    (-32 * 4, 4, [0, 1]),
])
def test_written_window_rows(mv_v, row, want):
    assert _one(mv_v, 0x80, row) == [(1, want)]


def test_stale_keep_and_intra_waits():
    # a skipped macroblock reads its stale pixel: row r of output k-2
    assert _one(0, 0x00, 3) == [(0, [3])]
    # all six blocks coded intra read no base; five do
    assert _one(0, 0x7F, 3) == []
    assert _one(0, 0x5F, 3) == [(0, [3])]
    # frame 1 reads the carried stale plane, frame 0 both carried planes
    assert _one(0, 0x00, 3, k=1) == []
    assert _one(40, 0x80, 3, k=0) == []
    # a segment past its count keeps row r of output k-1
    assert _one(0, 0x7F, 3, k=2, seg_frames=[2]) == [(1, [3])]
    # segment edges clamp: segment 1 of 3 owns rows 5-9
    assert _one(-300, 0x80, 6, n_seg=3, mb_h=3 * SEG_MB_H) == [(1, [5])]
    assert _one(300, 0x80, 6, n_seg=3, mb_h=3 * SEG_MB_H) == [(1, [9])]

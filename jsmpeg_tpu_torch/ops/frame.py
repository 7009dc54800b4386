"""Frame step: motion prediction + residual combine into the carried
reference planes, in plane layout.

`mc_combine` is the per-batch entry point: the frame loop of F pictures
(the port of jsmpeg_tpu's `lax.scan` over `decode_frame_step`).  On CUDA
tensors it launches kernel K2 (csrc/mc_combine.cu) once, which replaces
the XLA-lowered `_mc_gather` x3 + `_combine` of jsmpeg_tpu/ops/frame.py
(`decode_frame_planes`) and the scan around it; on CPU tensors it runs
`decode_frames_ref`, the loop of the single-frame spec `mc_combine_ref`.
`decode_frames` hands the batch out as a `PlanesBatch` (per-frame views)
and the new carry.

Per-MB metadata rides as one int32 [n_mb, 3] tensor (`frame_meta`):
(mv_h, mv_v, mode), mode = coded-block bits 0-5 | intra << 6 |
written << 7.

Segments (the joint fleet modes of parallel/streams.py): the planes may
hold `n_seg` streams stacked along macroblock rows.  Motion clamps rows
at each segment's edges, and segment s decodes only its first
`seg_frames[s]` frames of the batch: at a later frame its output rows
are the forward plane's and its carry does not rotate (jsmpeg_tpu's
`valid_seg[f, s] = f < seg_frames[s]`, `decode_frame_step`'s `keep`).

Bands (the tile axis across devices, parallel/tiles.py): with `band` (a
`kernels.Band`) a call decodes ONE frame of a band of macroblock rows of
each segment, reading the rows above and below it from halo buffers and
clamping motion at the picture's real rows in global rows (K2's band
mode; jsmpeg_tpu's `_tiled_step`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..metrics import span
from . import kernels
from .kernels import Band
from .motion import chroma_mv, mc_gather, per_pixel


class FrameArrays(NamedTuple):
    """Per-frame inputs of the serial path (dense, premultiplied)."""
    coef: torch.Tensor      # int32 [n_mb, 6, 64] premultiplied dequantized
    coded: torch.Tensor     # bool  [n_mb, 6]
    intra: torch.Tensor     # bool  [n_mb]
    written: torch.Tensor   # bool  [n_mb]
    mv_h: torch.Tensor      # int32 [n_mb]
    mv_v: torch.Tensor      # int32 [n_mb]


class Planes(NamedTuple):
    y: torch.Tensor         # uint8 [H, W]
    cr: torch.Tensor        # uint8 [H/2, W/2]
    cb: torch.Tensor        # uint8 [H/2, W/2]


class LevelsArrays(NamedTuple):
    """Per-batch inputs of the levels wire: raw VLC levels, dequantized
    on the device (leading axis of the fields = frame).  Dense (blk_ids
    None: the dense-levels and sparse wires, the tiles): levels int16
    [F, n_mb, 6, 64].  Compact (the packed wire's unpack): levels int16
    [n, 64] holds the coded blocks only, row i being the block of flat id
    blk_ids[i] = (f * n_mb + m) * 6 + b, -1 where the row is no block's
    (models.mpeg1.packed_to_blocks)."""
    levels: torch.Tensor    # int16 raw levels, raster order
    qscale: torch.Tensor    # uint8 [F, n_mb]
    coded: torch.Tensor     # bool  [F, n_mb, 6]
    intra: torch.Tensor     # bool  [F, n_mb]
    written: torch.Tensor   # bool  [F, n_mb]
    mv_h: torch.Tensor      # int32 [F, n_mb]
    mv_v: torch.Tensor      # int32 [F, n_mb]
    blk_ids: Optional[torch.Tensor] = None   # int32 [n] (compact only)


def frame_meta(coded: torch.Tensor, intra: torch.Tensor,
               written: torch.Tensor, mv_h: torch.Tensor,
               mv_v: torch.Tensor) -> torch.Tensor:
    """Pack per-MB metadata ([..., n_mb] and coded [..., n_mb, 6]) into
    the int32 [..., n_mb, 3] (mv_h, mv_v, mode) rows K2 reads."""
    shifts = torch.arange(6, dtype=torch.int32, device=coded.device)
    mode = ((coded.to(torch.int32) << shifts).sum(-1, dtype=torch.int32)
            | (intra.to(torch.int32) << 6) | (written.to(torch.int32) << 7))
    return torch.stack([mv_h.to(torch.int32), mv_v.to(torch.int32), mode],
                       dim=-1)


def _luma_plane(blocks: torch.Tensor, mb_h: int, mb_w: int) -> torch.Tensor:
    """[n_mb, 4, 8, 8] (blocks tl, tr, bl, br) -> [16*mb_h, 16*mb_w]."""
    x = blocks.reshape(mb_h, mb_w, 2, 2, 8, 8).permute(0, 2, 4, 1, 3, 5)
    return x.reshape(mb_h * 16, mb_w * 16)


def _chroma_plane(blocks: torch.Tensor, mb_h: int,
                  mb_w: int) -> torch.Tensor:
    """[n_mb, 8, 8] -> [8*mb_h, 8*mb_w]."""
    x = blocks.reshape(mb_h, mb_w, 8, 8).permute(0, 2, 1, 3)
    return x.reshape(mb_h * 8, mb_w * 8)


def _combine(base: torch.Tensor, resid: torch.Tensor, coded: torch.Tensor,
             intra: torch.Tensor) -> torch.Tensor:
    """Per-pixel select: uncoded -> base; coded intra -> clamp(resid);
    coded non-intra -> clamp(base + resid)."""
    added = (base + resid).clamp(0, 255)
    over = resid.clamp(0, 255)
    out = torch.where(coded, torch.where(intra, over, added), base)
    return out.to(torch.uint8)


def _keep_rows(live, new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    """Rows of segment s (len(live) equal row bands) from `new` where
    live[s], else from `old`."""
    mask = torch.as_tensor(live, dtype=torch.bool,
                           device=new.device).repeat_interleave(
        new.shape[0] // len(live))
    return torch.where(mask[:, None], new, old)


def _halo_slab(top: torch.Tensor, own: torch.Tensor, bot: torch.Tensor,
               n_seg: int) -> torch.Tensor:
    """Each segment's band with its halo rows above and below, stacked:
    [n_seg * (halo + rows + halo), W]."""
    W = own.shape[1]
    parts = [x.reshape(n_seg, -1, W) for x in (top, own, bot)]
    return torch.cat(parts, dim=1).reshape(-1, W)


def mc_combine_ref(cur: Planes, fwd: Planes, resid: torch.Tensor,
                   meta: torch.Tensor, n_seg: int = 1,
                   seg_frames=None, band: Band = None) -> Planes:
    """Plain version of `mc_combine`: half-pel MC from `fwd` where the MB
    is written (else the stale `cur` pixel), then the residual of each
    coded block replaces (intra) or adds to (non-intra) that base.

    resid: int32 [n_mb, 6, 64] IDCT output (blocks Y0-Y3, Cb, Cr);
    meta: int32 [n_mb, 3] from `frame_meta`.  n_seg segments clamp motion
    at their own rows; a segment with seg_frames[s] = 0 (of this one
    frame) keeps the rows of `fwd`.  With `band` the planes are the
    segments' bands, `fwd` read through the halo rows with the global
    clamp, and segment s decodes when band.frame < seg_frames[s]."""
    H, W = cur.y.shape
    mb_h, mb_w = H // 16, W // 16
    n_mb = mb_h * mb_w
    mv_h, mv_v, mode = meta.unbind(-1)
    shifts = torch.arange(6, dtype=torch.int32, device=meta.device)
    coded = ((mode[:, None] >> shifts) & 1) != 0
    intra = ((mode >> 6) & 1) != 0
    written = ((mode >> 7) & 1) != 0

    if band is None:
        counts = kernels.check_segments(mb_h, 1, n_seg, seg_frames)
        refs, geo = fwd, (None, None)
    else:
        counts = [band.frame < c for c in kernels.check_segments(
            mb_h, kernels.BAND_COUNT_MAX, n_seg, seg_frames)]
        refs = Planes(*[_halo_slab(t, f, b, n_seg)
                        for t, f, b in zip(band.top, fwd, band.bot)])
        geo = tuple((band.halo_mb * bs, band.row0 * bs, band.mb_h * bs)
                    for bs in (16, 8))
    pred_y = mc_gather(refs.y, mv_h, mv_v, mb_h, mb_w, 16, n_seg, geo[0])
    cmh, cmv = chroma_mv(mv_h), chroma_mv(mv_v)
    pred_cr = mc_gather(refs.cr, cmh, cmv, mb_h, mb_w, 8, n_seg, geo[1])
    pred_cb = mc_gather(refs.cb, cmh, cmv, mb_h, mb_w, 8, n_seg, geo[1])

    resid = resid.reshape(n_mb, 6, 8, 8)
    ry = _luma_plane(resid[:, :4], mb_h, mb_w)
    rcb = _chroma_plane(resid[:, 4], mb_h, mb_w)
    rcr = _chroma_plane(resid[:, 5], mb_h, mb_w)
    coded_y = _luma_plane(coded[:, :4, None, None].expand(n_mb, 4, 8, 8),
                          mb_h, mb_w)
    coded_cb = per_pixel(coded[:, 4], mb_h, mb_w, 8)
    coded_cr = per_pixel(coded[:, 5], mb_h, mb_w, 8)
    written_y = per_pixel(written, mb_h, mb_w, 16)
    written_c = per_pixel(written, mb_h, mb_w, 8)
    intra_y = per_pixel(intra, mb_h, mb_w, 16)
    intra_c = per_pixel(intra, mb_h, mb_w, 8)

    base_y = torch.where(written_y, pred_y, cur.y.to(torch.int32))
    base_cr = torch.where(written_c, pred_cr, cur.cr.to(torch.int32))
    base_cb = torch.where(written_c, pred_cb, cur.cb.to(torch.int32))
    out = Planes(y=_combine(base_y, ry, coded_y, intra_y),
                 cr=_combine(base_cr, rcr, coded_cr, intra_c),
                 cb=_combine(base_cb, rcb, coded_cb, intra_c))
    if all(counts):
        return out
    return Planes(*[_keep_rows(counts, o, f) for o, f in zip(out, fwd)])


def decode_frames_ref(cur: Planes, fwd: Planes, resid: torch.Tensor,
                      meta: torch.Tensor, n_seg: int = 1,
                      seg_frames=None, band: Band = None) -> Planes:
    """Plain version of `mc_combine`: `mc_combine_ref` over the frames of
    a batch, frame k reading fwd = output k-1 and cur = output k-2 (the
    reference's pointer rotation, jsmpeg/src/mpeg1.js:220-246).
    resid int32 [F, n_mb, 6, 64], meta int32 [F, n_mb, 3].  Segment s
    (of n_seg) rotates only through its first seg_frames[s] frames; its
    rows of a later output are the forward plane's.  A band call is one
    frame (F = 1).  Returns the stacked outputs, Planes of [F, H, W] /
    [F, H/2, W/2]."""
    F = resid.shape[0]
    if band is not None:
        if F != 1:
            raise ValueError(f'a band call is one frame, got {F}')
        out = mc_combine_ref(cur, fwd, resid[0], meta[0], n_seg, seg_frames,
                             band)
        return Planes(*[p[None] for p in out])
    counts = kernels.check_segments(cur.y.shape[0] // 16, F, n_seg,
                                    seg_frames)
    outs = []
    for k in range(F):
        live = [k < c for c in counts]
        out = mc_combine_ref(cur, fwd, resid[k], meta[k], n_seg, live)
        cur = (fwd if all(live) else
               Planes(*[_keep_rows(live, f, c) for f, c in zip(fwd, cur)]))
        fwd = out
        outs.append(out)
    if not outs:
        return Planes(*[p.new_empty((0,) + p.shape) for p in cur])
    return Planes(*[torch.stack(ps) for ps in zip(*outs)])


def k2_wait_rows(meta: torch.Tensor, mb_h: int, mb_w: int, n_seg: int = 1,
                 seg_frames=None) -> torch.Tensor:
    """The rows each macroblock of K2's batch waits for before it reads:
    the plain mirror of `wait_set` in csrc/mc_combine.cu, for the tests.
    meta int32 [F, n_mb, 3] of a batch of `n_seg` segments (mb_h counts
    the stacked rows) with frame counts `seg_frames` (None: F each).
    Returns bool [F, n_mb, F, mb_h]: [k, mb, j, r] is set when macroblock
    mb of frame k waits for row r of output j.

    A written macroblock of frame k >= 1 waits for the rows of output k-1
    under its 17-row luma window from row 16r + (mv_v >> 1) and its 9-row
    chroma window from row 8r + (cmv_v >> 1), each row clamped to its
    segment's rows; one past its segment's count for row r of output k-1;
    any other whose blocks are not all coded intra, at k >= 2, for row r
    of output k-2.  Frames 0 and 1 read the carried planes otherwise."""
    F, n_mb = meta.shape[:2]
    counts = kernels.check_segments(mb_h, F, n_seg, seg_frames)
    seg_mb_h = mb_h // n_seg
    row = torch.arange(n_mb) // mb_w
    k = torch.arange(F)[:, None]
    live = k < torch.tensor(counts)[row // seg_mb_h]
    mv_v, mode = meta[..., 1].long(), meta[..., 2].long()
    written = live & ((mode >> 7) & 1).bool()
    keep = ~live
    stale = live & ~written & ~(((mode >> 6) & 1).bool()
                                & ((mode & 0x3F) == 0x3F))
    lo = (row // seg_mb_h) * seg_mb_h * 16
    hi = lo + seg_mb_h * 16 - 1
    sy = row * 16 + (mv_v >> 1)
    cy = row * 8 + (chroma_mv(mv_v) >> 1)
    clamp = lambda v, a, b: torch.minimum(torch.maximum(v, a), b)
    r0 = torch.minimum(clamp(sy, lo, hi) >> 4,
                       clamp(cy, lo >> 1, hi >> 1) >> 3)
    r1 = torch.maximum(clamp(sy + 16, lo, hi) >> 4,
                       clamp(cy + 8, lo >> 1, hi >> 1) >> 3)
    r0 = torch.where(written, r0, row)
    r1 = torch.where(written, r1, row)
    wk = torch.full((F, n_mb), -1)
    wk = torch.where((written | keep) & (k >= 1), k - 1, wk)
    wk = torch.where(stale & (k >= 2), k - 2, wk)
    r = torch.arange(mb_h)
    rows = (r >= r0[..., None]) & (r <= r1[..., None])
    frames = wk[..., None] == torch.arange(F)
    return frames[..., None] & rows[:, :, None, :]


def mc_combine(cur: Planes, fwd: Planes, resid: torch.Tensor,
               meta: torch.Tensor, n_seg: int = 1,
               seg_frames=None, band: Band = None) -> Planes:
    """One batch's MC + combine, Planes of [F, ...] (with `band`, one
    frame of a band).  CUDA tensors go to kernel K2 in one launch (or the
    call raises); CPU tensors run `decode_frames_ref`."""
    if cur.y.device.type == 'cpu':
        return decode_frames_ref(cur, fwd, resid, meta, n_seg, seg_frames,
                                 band)
    return Planes(*kernels.mc_combine_cuda(cur, fwd, resid, meta, n_seg,
                                           seg_frames, band))


class PlanesBatch:
    """The F decoded frames of one batch: Planes of [F, H, W] /
    [F, H/2, W/2] tensors, handed out per frame as views into them."""

    def __init__(self, planes: Planes):
        self.planes = planes
        self._fetch = None      # (host Planes, event) from queue_fetch

    def __len__(self) -> int:
        return self.planes.y.shape[0]

    def __getitem__(self, i: int) -> Planes:
        if not -len(self) <= i < len(self):
            raise IndexError(i)
        return Planes(*[p[i] for p in self.planes])

    def __iter__(self):
        return (self[i] for i in range(len(self)))

    def queue_fetch(self) -> None:
        """Queue the copy back on the current stream: ONE asynchronous
        copy per plane into fresh pinned host tensors, then an event.
        Fresh, because a sink may keep the arrays it renders.  CPU
        tensors need no copy."""
        if self.planes.y.device.type != 'cuda':
            return
        host = Planes(*[torch.empty(p.shape, dtype=p.dtype, pin_memory=True)
                        for p in self.planes])
        for h, p in zip(host, self.planes):
            h.copy_(p, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        self._fetch = (host, event)

    def fetch_all(self) -> Planes:
        """All frames as ONE host copy per plane (numpy [F, H, W]): the
        queued copy once its event has completed, else a copy now.  Each
        blocking wait on the device is a 'device.wait' span."""
        if self._fetch is not None:
            host, event = self._fetch
            with span('device.wait'):
                event.synchronize()
            return Planes(*[h.numpy() for h in host])
        return to_host(self.planes)


def to_host(planes: Planes) -> Planes:
    """The planes as host numpy arrays: a blocking copy each, each a
    'device.wait' span."""
    out = []
    for p in planes:
        with span('device.wait'):
            out.append(p.cpu().numpy())
    return Planes(*out)


def _rotate(cur: Planes, fwd: Planes, outs: PlanesBatch, n: int):
    """The carry after the first n frames of `outs`: the last two (for
    n = 1 the old fwd and the frame; for n = 0 the old carry)."""
    for k in range(max(n - 2, 0), n):
        cur, fwd = fwd, outs[k]
    return cur, fwd


def decode_frames(cur: Planes, fwd: Planes, resid: torch.Tensor,
                  meta: torch.Tensor, n_seg: int = 1, seg_frames=None):
    """The frame loop of a batch through `mc_combine`.  Only real frames
    are stepped (no padding frames).  resid int32 [F, n_mb, 6, 64], meta
    int32 [F, n_mb, 3].  Returns (cur, fwd, PlanesBatch of the F frames).
    The new carry is the last two frames (for F = 1, the old fwd and the
    frame), views into the batch tensors; with segments of unequal
    seg_frames, each segment's rows come from its own last two frames,
    joined into new tensors."""
    outs = PlanesBatch(mc_combine(cur, fwd, resid, meta, n_seg, seg_frames))
    counts = kernels.check_segments(cur.y.shape[0] // 16, len(outs), n_seg,
                                    seg_frames)
    pairs = {n: _rotate(cur, fwd, outs, n) for n in set(counts)}
    if len(pairs) == 1:
        return (*pairs[counts[0]], outs)

    def join(i):        # 0: cur, 1: fwd
        return Planes(*[torch.cat([pairs[n][i][p].chunk(n_seg)[s]
                                   for s, n in enumerate(counts)])
                        for p in range(3)])

    return join(0), join(1), outs

"""Frame step: motion prediction + residual combine into the carried
reference planes, in plane layout.

`mc_combine` is the per-frame entry point.  On CUDA tensors it launches
kernel K2 (csrc/mc_combine.cu), which replaces the XLA-lowered
`_mc_gather` x3 + `_combine` of jsmpeg_tpu/ops/frame.py
(`decode_frame_planes`); on CPU tensors it runs `mc_combine_ref`.
`decode_frames` is the frame loop of a batch.

Per-MB metadata rides as one int32 [n_mb, 3] tensor (`frame_meta`):
(mv_h, mv_v, mode), mode = coded-block bits 0-5 | intra << 6 |
written << 7.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import kernels
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
    on the device (leading axis = frame)."""
    levels: torch.Tensor    # int16 [F, n_mb, 6, 64] raw levels, raster order
    qscale: torch.Tensor    # uint8 [F, n_mb]
    coded: torch.Tensor     # bool  [F, n_mb, 6]
    intra: torch.Tensor     # bool  [F, n_mb]
    written: torch.Tensor   # bool  [F, n_mb]
    mv_h: torch.Tensor      # int32 [F, n_mb]
    mv_v: torch.Tensor      # int32 [F, n_mb]


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


def mc_combine_ref(cur: Planes, fwd: Planes, resid: torch.Tensor,
                   meta: torch.Tensor) -> Planes:
    """Plain version of `mc_combine`: half-pel MC from `fwd` where the MB
    is written (else the stale `cur` pixel), then the residual of each
    coded block replaces (intra) or adds to (non-intra) that base.

    resid: int32 [n_mb, 6, 64] IDCT output (blocks Y0-Y3, Cb, Cr);
    meta: int32 [n_mb, 3] from `frame_meta`."""
    H, W = cur.y.shape
    mb_h, mb_w = H // 16, W // 16
    n_mb = mb_h * mb_w
    mv_h, mv_v, mode = meta.unbind(-1)
    shifts = torch.arange(6, dtype=torch.int32, device=meta.device)
    coded = ((mode[:, None] >> shifts) & 1) != 0
    intra = ((mode >> 6) & 1) != 0
    written = ((mode >> 7) & 1) != 0

    pred_y = mc_gather(fwd.y, mv_h, mv_v, mb_h, mb_w, 16)
    cmh, cmv = chroma_mv(mv_h), chroma_mv(mv_v)
    pred_cr = mc_gather(fwd.cr, cmh, cmv, mb_h, mb_w, 8)
    pred_cb = mc_gather(fwd.cb, cmh, cmv, mb_h, mb_w, 8)

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
    return Planes(y=_combine(base_y, ry, coded_y, intra_y),
                  cr=_combine(base_cr, rcr, coded_cr, intra_c),
                  cb=_combine(base_cb, rcb, coded_cb, intra_c))


def mc_combine(cur: Planes, fwd: Planes, resid: torch.Tensor,
               meta: torch.Tensor) -> Planes:
    """One picture's MC + combine.  CUDA tensors go to kernel K2 (or the
    call raises); CPU tensors run `mc_combine_ref`."""
    if cur.y.device.type == 'cpu':
        return mc_combine_ref(cur, fwd, resid, meta)
    return Planes(*kernels.mc_combine_cuda(cur, fwd, resid, meta))


def decode_frames(cur: Planes, fwd: Planes, resid: torch.Tensor,
                  meta: torch.Tensor):
    """The frame loop of a batch (the port of jsmpeg_tpu's `lax.scan`
    over `decode_frame_step`, the reference's pointer rotation,
    jsmpeg/src/mpeg1.js:220-246): frame k reads `fwd` = output k-1 and
    `cur` = output k-2, a pointer swap on the host with one K2 launch
    per frame.  Only real frames are stepped (no padding frames).
    resid int32 [n, n_mb, 6, 64], meta int32 [n, n_mb, 3].
    Returns (cur, fwd, [Planes] * n)."""
    outs = []
    for k in range(resid.shape[0]):
        out = mc_combine(cur, fwd, resid[k], meta[k])
        cur, fwd = fwd, out
        outs.append(out)
    return cur, fwd, outs

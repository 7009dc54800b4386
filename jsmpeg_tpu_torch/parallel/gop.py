"""GOP-parallel decode of serially parsed frames (the port of
jsmpeg_tpu/parallel/gop.py).

A closed GOP (an I picture and the P pictures after it) depends on
nothing outside itself, so a batch of GOPs decodes independently.  On
the GPU the GOPs of one device are the segments of one launch pair:
stacked along macroblock rows, each from zero reference planes, segment
s stepping its own GOP's frames (`decode_coef` with `n_seg` and
`seg_frames`; jsmpeg_tpu runs one `lax.scan` per GOP, `vmap`ped over a
shard's GOPs).  The packed-wire mesh decode is parallel/packed.py's.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..host.mpeg1_parse import FrameData
from ..models.mpeg1 import decode_coef, frame_to_arrays, upload
from ..ops.frame import FrameArrays, Planes


def split_at_iframes(frames, pic_type_of) -> list:
    """Split a picture sequence at I-frames into closed GOPs."""
    gops: list = []
    for f in frames:
        if pic_type_of(f) == 1 or not gops:
            gops.append([])
        gops[-1].append(f)
    return gops


def split_gops(frames: List[FrameData]) -> List[List[FrameData]]:
    return split_at_iframes(frames, lambda f: f.pic_type)


def stack_gops(gops: List[List[FrameData]],
               n_mb: int) -> Tuple[FrameArrays, List[int]]:
    """The GOPs as segments of one batch: numpy FrameArrays of
    [F, len(gops) * n_mb, ...], joint frame f holding every GOP's frame f
    in GOP order (F = the longest GOP; past a GOP's end its macroblocks
    are empty, and its segment's count stops it there anyway).  Returns
    (stacked, frames per GOP)."""
    counts = [len(g) for g in gops]
    empty = FrameArrays(coef=np.zeros((n_mb, 6, 64), np.int32),
                        coded=np.zeros((n_mb, 6), bool),
                        intra=np.zeros(n_mb, bool),
                        written=np.zeros(n_mb, bool),
                        mv_h=np.zeros(n_mb, np.int32),
                        mv_v=np.zeros(n_mb, np.int32))
    joint = []
    for f in range(max(counts)):
        parts = [frame_to_arrays(g[f]) if f < len(g) else empty for g in gops]
        joint.append(FrameArrays(*[np.concatenate(x) for x in zip(*parts)]))
    return FrameArrays(*[np.stack(x) for x in zip(*joint)]), counts


def _seed_planes(init: Optional[Tuple], n_seg: int, h: int, w: int,
                 device: torch.device) -> Tuple[Planes, Planes]:
    """(cur, fwd) for n_seg segments of h x w stacked along rows: zero
    planes, with the caller's carry (if any) in segment 0's rows -- a
    mid-GOP continuation decodes against it (jsmpeg_tpu's _stack_init)."""
    def one(which):
        out = []
        for pi, (hh, ww) in enumerate(((h, w), (h // 2, w // 2),
                                       (h // 2, w // 2))):
            z = torch.zeros((n_seg * hh, ww), dtype=torch.uint8,
                            device=device)
            if init is not None:
                z[:hh] = init[which][pi]
            out.append(z)
        return Planes(*out)
    return one(0), one(1)


def decode_gop_parallel(frames: List[FrameData], mb_h: int, mb_w: int,
                        mesh) -> List[Planes]:
    """Split frames into GOPs, decode them over the mesh (each row
    layout's GOPs as the segments of one launch pair on its first device,
    the whole picture: jsmpeg_tpu's shard_map here shards the 'gop' axis
    only) and return per-frame planes in input order, on the devices that
    decoded them.  Raises ValueError for a GOP that is not closed
    (parallel/packed.gop_closed)."""
    from .packed import gop_closed
    gops = split_gops(frames)
    for gop in gops:
        if not gop_closed(gop):
            raise ValueError('GOP not closed (slice-gap frame exposes '
                             'pre-GOP plane content); decode off-mesh')
    n_mb = mb_h * mb_w
    per_gop: list = [None] * len(gops)
    for bands, idx in mesh.gop_groups(len(gops)).items():
        dev = bands[0]
        st, counts = stack_gops([gops[i] for i in idx], n_mb)
        f = FrameArrays(*[upload(x, dev) for x in st])
        k = len(idx)
        cur, fwd = _seed_planes(None, k, mb_h * 16, mb_w * 16, dev)
        _, _, outs = decode_coef(cur, fwd, f, n_seg=k, seg_frames=counts)
        for s, (i, n) in enumerate(zip(idx, counts)):
            per_gop[i] = Planes(*[x.chunk(k, dim=1)[s][:n]
                                  for x in outs.planes])
    return [Planes(*[x[fi] for x in p]) for p in per_gop
            for fi in range(p.y.shape[0])]

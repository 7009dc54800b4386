"""Half-pel forward motion compensation over whole frames (plain torch).

One universal rounding formula covers the reference's four hand-unrolled
half-pel cases (jsmpeg/src/mpeg1.js:459-687):

    pred = (A + B + C + D + 2) >> 2,   B/C/D offset by (odd_h, odd_v)

  - odd_h = odd_v = 1: the reference's (a+b+c+d+2)>>2        (identical)
  - one odd:           (2(a+b)+2)>>2 == (a+b+1)>>1           (exact identity)
  - none:              (4a+2)>>2 == a                        (exact identity)

Source coordinates clamp to the coded plane's edges; a plane of `n_seg`
streams stacked along rows (the joint fleet modes, parallel/streams.py)
clamps rows at each segment's edges instead, which is each stream's own
frame-edge clamp.  A band of macroblock rows (the tile axis across
devices, parallel/tiles.py) reads a halo'd slab and clamps rows to the
picture's real rows in global row numbers.  This is the plain version of
the MC half of kernel K2
(csrc/mc_combine.cu); the decoder's frame step reaches it through
`ops.frame.mc_combine`.
"""

from __future__ import annotations

import torch


def per_pixel(per_mb: torch.Tensor, mb_h: int, mb_w: int,
              block: int) -> torch.Tensor:
    """Broadcast per-MB values [n_mb] -> per-pixel [mb_h*block, mb_w*block]."""
    grid = per_mb.reshape(mb_h, mb_w)
    return grid.repeat_interleave(block, 0).repeat_interleave(block, 1)


def mc_gather(ref: torch.Tensor, mv_h: torch.Tensor, mv_v: torch.Tensor,
              mb_h: int, mb_w: int, block: int, n_seg: int = 1,
              band=None) -> torch.Tensor:
    """ref: uint8 [H, W] reference plane (H = mb_h * block); mv_*: int32
    [n_mb] in this plane's half-pel units (chroma callers pass `chroma_mv`
    vectors).  With n_seg > 1 the output is n_seg segments of H / n_seg
    rows and output row iy reads only rows of its own segment.

    band = (halo, row0, total_rows), in this plane's rows: each segment's
    rows are a band of a picture of total_rows real rows, its first row
    global row row0, and ref holds each segment's halo'd slab (halo rows
    above, the band's own rows, halo rows below; [n_seg * (H / n_seg + 2 *
    halo), W]).  A source row clamps to [0, total_rows) in global rows,
    then maps into the slab (jsmpeg_tpu's `_mc_tiled_gather`, whose
    total_rows its callers pass as the padded height).  Returns the int32
    [H, W] prediction."""
    if n_seg < 1 or mb_h % n_seg:
        raise ValueError(f'{mb_h} macroblock rows do not split into '
                         f'{n_seg} segments')
    H, W = mb_h * block, mb_w * block
    mvh = per_pixel(mv_h.to(torch.int32), mb_h, mb_w, block)
    mvv = per_pixel(mv_v.to(torch.int32), mb_h, mb_w, block)

    iy = torch.arange(H, dtype=torch.int32, device=ref.device)[:, None]
    ix = torch.arange(W, dtype=torch.int32, device=ref.device)[None, :]
    sx = ix + (mvh >> 1)
    oy = mvv & 1
    ox = mvh & 1
    hs = H // n_seg
    seg0 = (iy // hs) * hs              # each output row's segment's first row
    if band is None:
        sy = iy + (mvv >> 1)
        yhi = seg0 + (hs - 1)

        def row(y):
            return torch.minimum(torch.maximum(y, seg0), yhi)
    else:
        halo, row0, total = band
        slab = hs + 2 * halo
        sy = row0 + (iy - seg0) + (mvv >> 1)     # global rows

        def row(y):
            local = (y.clamp(0, total - 1) - row0 + halo).clamp(0, slab - 1)
            return local + (seg0 // hs) * slab

    flat = ref.reshape(-1).to(torch.int32)

    def g(y, x):
        x = x.clamp(0, W - 1)
        return flat[(row(y) * W + x).long()]

    a = g(sy, sx)
    b = g(sy, sx + ox)
    c = g(sy + oy, sx)
    d = g(sy + oy, sx + ox)
    return (a + b + c + d + 2) >> 2


def chroma_mv(mv: torch.Tensor) -> torch.Tensor:
    """Luma half-pel vector -> chroma half-pel vector: truncate-toward-zero
    division by two (JS `(x/2)|0` semantics at src/mpeg1.js:562-565)."""
    return torch.sign(mv) * (mv.abs() >> 1)

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
frame-edge clamp.  This is the plain version of the MC half of kernel K2
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
              mb_h: int, mb_w: int, block: int,
              n_seg: int = 1) -> torch.Tensor:
    """ref: uint8 [H, W] reference plane; mv_*: int32 [n_mb] in this
    plane's half-pel units (chroma callers pass `chroma_mv` vectors).
    With n_seg > 1 the plane is n_seg segments of H / n_seg rows and
    output row iy reads only rows of its own segment.  Returns the int32
    [H, W] prediction."""
    if n_seg < 1 or mb_h % n_seg:
        raise ValueError(f'{mb_h} macroblock rows do not split into '
                         f'{n_seg} segments')
    H, W = ref.shape
    mvh = per_pixel(mv_h.to(torch.int32), mb_h, mb_w, block)
    mvv = per_pixel(mv_v.to(torch.int32), mb_h, mb_w, block)

    iy = torch.arange(H, dtype=torch.int32, device=ref.device)[:, None]
    ix = torch.arange(W, dtype=torch.int32, device=ref.device)[None, :]
    sy = iy + (mvv >> 1)
    sx = ix + (mvh >> 1)
    oy = mvv & 1
    ox = mvh & 1
    hs = H // n_seg
    ylo = (iy // hs) * hs               # each output row's segment
    yhi = ylo + (hs - 1)

    flat = ref.reshape(-1).to(torch.int32)

    def g(y, x):
        y = torch.minimum(torch.maximum(y, ylo), yhi)
        x = x.clamp(0, W - 1)
        return flat[(y * W + x).long()]

    a = g(sy, sx)
    b = g(sy, sx + ox)
    c = g(sy + oy, sx)
    d = g(sy + oy, sx + ox)
    return (a + b + c + d + 2) >> 2


def chroma_mv(mv: torch.Tensor) -> torch.Tensor:
    """Luma half-pel vector -> chroma half-pel vector: truncate-toward-zero
    division by two (JS `(x/2)|0` semantics at src/mpeg1.js:562-565)."""
    return torch.sign(mv) * (mv.abs() >> 1)

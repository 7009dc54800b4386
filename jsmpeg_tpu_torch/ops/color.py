"""YCbCr -> RGB conversion, on the device of the input planes.

Two variants mirroring the reference's two renderers:
- `ycbcr_to_rgb_int`: the Canvas2D renderer's integer math
  (jsmpeg/src/canvas2d.js:89-112), bit-exact, 2x2 shared chroma.
- `ycbcr_to_rgb_rec601`: the WebGL shader's float Rec.601 matrix
  (jsmpeg/src/webgl.js:260-281).

Both take coded-size planes (uint8 tensors) and return display-size RGB.
NOTE on argument order: like the reference's render() call chain, `cr` is
the red-difference plane, `cb` the blue-difference plane.
"""

from __future__ import annotations

import torch


def _upsample2(c: torch.Tensor) -> torch.Tensor:
    return c.repeat_interleave(2, dim=0).repeat_interleave(2, dim=1)


def ycbcr_to_rgb_int(y: torch.Tensor, cr: torch.Tensor, cb: torch.Tensor,
                     width: int, height: int) -> torch.Tensor:
    """Integer conversion, bit-exact with the Canvas2D renderer.

    y: uint8 [CH, CW] coded-size; cr/cb: uint8 [CH/2, CW/2].
    Returns uint8 [height, width, 3].
    """
    yv = y[:height, :width].to(torch.int32)
    crf = _upsample2(cr.to(torch.int32))[:height, :width]
    cbf = _upsample2(cb.to(torch.int32))[:height, :width]
    # reference names its 2nd arg "cb" but receives the Cr plane; the math
    # below uses the real meanings.
    r = (crf + ((crf * 103) >> 8)) - 179
    g = ((cbf * 88) >> 8) - 44 + ((crf * 183) >> 8) - 91
    b = (cbf + ((cbf * 198) >> 8)) - 227
    rgb = torch.stack([yv + r, yv - g, yv + b], dim=-1)
    return rgb.clamp(0, 255).to(torch.uint8)


def ycbcr_to_rgb_rec601(y: torch.Tensor, cr: torch.Tensor, cb: torch.Tensor,
                        width: int, height: int) -> torch.Tensor:
    """Float Rec.601 conversion (WebGL shader semantics)."""
    yv = y[:height, :width].to(torch.float32)
    crf = _upsample2(cr.to(torch.float32))[:height, :width] - 128.0
    cbf = _upsample2(cb.to(torch.float32))[:height, :width] - 128.0
    r = yv + 1.402 * crf
    g = yv - 0.344136 * cbf - 0.714136 * crf
    b = yv + 1.772 * cbf
    rgb = torch.stack([r, g, b], dim=-1)
    return torch.round(rgb).clamp(0, 255).to(torch.uint8)

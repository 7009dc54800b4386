"""Batched fixed-point 8x8 IDCT with optional fused dequantization.

Reproduces the reference decoder's integer IDCT (semantics of
jsmpeg/src/mpeg1.js:916-983) bit-exactly in int32: JS reduces to int32 at
every `>>` site and at Int32Array stores, and only +/-/* occur between
reductions, so wrapping int32 arithmetic with arithmetic `>>` is exact.

`dequant_idct` (a dense lattice of every block) and
`dequant_idct_compact` (the coded blocks only, the packed paths) are the
entry points.  On a CUDA tensor each launches the hand-written kernel
`csrc/dequant_idct.cu` (the port of the Pallas kernel
`dequant_idct_pallas`, tools/idct_pallas_shelved.py); on a CPU tensor it
runs its plain version below (`dequant_idct_ref`,
`dequant_idct_compact_ref`).
"""

from __future__ import annotations

import torch

from .. import tables as T
from . import kernels


def _butterfly(r, final: bool):
    """One IDCT pass over a list of 8 int32 tensors (one per row index)."""
    b1 = r[4]
    b3 = r[2] + r[6]
    b4 = r[5] - r[3]
    tmp1 = r[1] + r[7]
    tmp2 = r[3] + r[5]
    b6 = r[1] - r[7]
    b7 = tmp1 + tmp2
    m0 = r[0]
    x4 = ((b6 * 473 - b4 * 196 + 128) >> 8) - b7
    x0 = x4 - (((tmp1 - tmp2) * 362 + 128) >> 8)
    x1 = m0 - b1
    x2 = (((r[2] - r[6]) * 362 + 128) >> 8) - b3
    x3 = m0 + b1
    y3 = x1 + x2
    y4 = x3 + b3
    y5 = x1 - x2
    y6 = x3 - b3
    y7 = -x0 - ((b4 * 473 + b6 * 196 + 128) >> 8)
    rows = (b7 + y4, x4 + y3, y5 - x0, y6 - y7,
            y6 + y7, x0 + y5, y3 - x4, y4 - b7)
    if final:
        rows = tuple((v + 128) >> 8 for v in rows)
    return rows


def idct_s32(blocks: torch.Tensor) -> torch.Tensor:
    """blocks: int32 [..., 8, 8] premultiplied coefficients -> int32
    pixels (pass 1 along the row index, pass 2 along the column index)."""
    if blocks.dtype != torch.int32:
        raise TypeError(f'idct_s32 takes int32, got {blocks.dtype}')
    cols = torch.stack(_butterfly(blocks.unbind(-2), final=False), dim=-2)
    rows = _butterfly(cols.unbind(-1), final=True)
    return torch.stack(rows, dim=-1)


PREMULT = torch.tensor(T.PREMULTIPLIER_MATRIX, dtype=torch.int32)


def dequant_premult(levels: torch.Tensor, qscale: torch.Tensor,
                    intra: torch.Tensor, intra_q: torch.Tensor,
                    non_intra_q: torch.Tensor) -> torch.Tensor:
    """Dequantize + oddify + clamp + premultiply (src/mpeg1.js:793-810).

    levels:      int [n_mb, 6, 64] raw VLC levels at raster positions
                 (intra DC at [..., 0] already predictor-resolved)
    qscale:      int [n_mb]
    intra:       bool [n_mb]
    *_q:         int32 [64] quantizer matrices (raster order)

    Returns int32 [n_mb, 6, 64].  Valid only for streams without the
    escape-coded zero level (the host parser flags those and the decoder
    takes the serial path)."""
    lv = levels.to(torch.int32)
    intra_b = intra.to(torch.bool)[:, None, None]
    quant = torch.where(intra_b, intra_q.to(torch.int32),
                        non_intra_q.to(torch.int32))
    x = lv * 2
    x = torch.where(intra_b, x, x + torch.sign(lv))
    x = (x * qscale.to(torch.int32)[:, None, None] * quant) >> 4
    # oddify: if even, step toward zero by one (a dequantized 0 becomes
    # +1 here, masked below by lv == 0)
    x = torch.where((x & 1) == 0, x + 1 - 2 * (x > 0).int(), x)
    x = x.clamp(-2048, 2047)
    x = x * PREMULT.to(x.device)
    # uncoded (all-zero) positions in the dense layout must stay zero
    x = torch.where(lv == 0, 0, x)
    # intra DC bypasses dequant: value << 8
    x[..., 0] = torch.where(intra_b[..., 0], lv[..., 0] << 8, x[..., 0])
    return x


def dequant_idct_ref(x: torch.Tensor, qscale: torch.Tensor = None,
                     intra: torch.Tensor = None,
                     intra_q: torch.Tensor = None,
                     non_intra_q: torch.Tensor = None,
                     premultiplied: bool = False) -> torch.Tensor:
    """Plain version of `dequant_idct`: [n_mb, 6, 64] -> int32
    [n_mb, 6, 64] residuals in raster order."""
    coef = (x.to(torch.int32) if premultiplied else
            dequant_premult(x, qscale, intra, intra_q, non_intra_q))
    n_mb = coef.shape[0]
    return idct_s32(coef.reshape(n_mb, 6, 8, 8)).reshape(n_mb, 6, 64)


def dequant_idct(x: torch.Tensor, qscale: torch.Tensor = None,
                 intra: torch.Tensor = None, intra_q: torch.Tensor = None,
                 non_intra_q: torch.Tensor = None,
                 premultiplied: bool = False) -> torch.Tensor:
    """Fused dequant + IDCT over a batch of macroblocks.

    premultiplied=False: x is int16 levels [n_mb, 6, 64] (raster order),
    with qscale uint8 [n_mb], intra bool [n_mb] and int32 [64] matrices;
    returns idct_s32(dequant_premult(...)).
    premultiplied=True: x is int32 premultiplied coefficients (the serial
    path's FrameArrays.coef); returns idct_s32(x).  The other arguments
    are ignored.

    A CUDA tensor goes to kernel K1 (or the call raises); a CPU tensor
    runs the plain version."""
    if x.device.type == 'cpu':
        return dequant_idct_ref(x, qscale, intra, intra_q, non_intra_q,
                                premultiplied)
    return kernels.dequant_idct_cuda(x, qscale, intra, intra_q,
                                     non_intra_q, premultiplied)


def dequant_idct_compact_ref(levels: torch.Tensor, blk_ids: torch.Tensor,
                             qscale: torch.Tensor, intra: torch.Tensor,
                             intra_q: torch.Tensor, non_intra_q: torch.Tensor,
                             n_blocks: int) -> torch.Tensor:
    """Plain version of `dequant_idct_compact`: dequant_idct_ref of each
    named row, scattered to its block of a zeroed int32 [n_blocks, 64]."""
    named = blk_ids >= 0
    ids = blk_ids[named].long()
    mb = ids // 6
    coef = dequant_premult(levels[named][:, None], qscale[mb], intra[mb],
                           intra_q, non_intra_q)
    out = torch.zeros((n_blocks, 64), dtype=torch.int32, device=levels.device)
    out[ids] = idct_s32(coef.reshape(-1, 8, 8)).reshape(-1, 64)
    return out


def dequant_idct_compact(levels: torch.Tensor, blk_ids: torch.Tensor,
                         qscale: torch.Tensor, intra: torch.Tensor,
                         intra_q: torch.Tensor, non_intra_q: torch.Tensor,
                         n_blocks: int) -> torch.Tensor:
    """Fused dequant + IDCT of the coded blocks only (the packed paths).

    levels int16 [n, 64] (raster order) holds the levels of block
    blk_ids[i] (int32 [n]; -1: the row is no block's) in row i; qscale
    uint8 and intra bool [n_blocks // 6] are per macroblock (block b's is
    b // 6) with int32 [64] matrices.  Returns the int32 [n_blocks, 64]
    residuals of the named blocks, each dequant_idct's; the other blocks
    are 0 here and unwritten (`torch.empty`) on the card, where K2, which
    reads coded blocks only, never reads them.

    A CUDA tensor goes to kernel K1's compact form (or the call raises);
    a CPU tensor runs the plain version."""
    if levels.device.type == 'cpu':
        return dequant_idct_compact_ref(levels, blk_ids, qscale, intra,
                                        intra_q, non_intra_q, n_blocks)
    return kernels.dequant_idct_compact_cuda(levels, blk_ids, qscale, intra,
                                             intra_q, non_intra_q, n_blocks)

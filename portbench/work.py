"""The least time each of the port's kernels could take: the operations
and bytes its work needs, over the H100's published peaks.

A frozen copy of `chip_smoke.py`'s `bound`, `k1_work`, `k2_work` and
`k3_work` and of their constants (counted from the kernels' sources as
they stood when the benchmark was written), so that a change to the
program cannot change the yardstick.  `k2_work_counts` is `k2_work` over
the counts it reads from a launch's metadata, which the benchmark takes
from its own reference parse of the stream (`reference.mpeg1.PictureWork`).
"""

from __future__ import annotations

# H100 SXM peaks at the 700 W limit (NVIDIA's data sheet)
HBM_BYTES_PER_S = 3.35e12
# int32 ALU ops: the data sheet's 67 TFLOP/s fp32 counts an FMA as two
# flops on 128 lanes per SM; the int32 pipe has 64 lanes per SM, one op per
# lane
INT32_OPS_PER_S = 67e12 / 4

# integer ops counted from csrc/dequant_idct.cu: one butterfly pass over 8
# values is 43 ops, the final rounding 2 more per value; 8 column passes +
# 8 row passes per block.  Dequant: 1 zero test per level, 11 ops per
# non-zero level.
IDCT_OPS_PER_BLOCK = 8 * 43 + 8 * (43 + 16)
DEQUANT_OPS_PER_LEVEL, DEQUANT_OPS_PER_NONZERO = 1, 11
# csrc/mc_combine.cu: a written macroblock stages its window with 70
# aligned loads (17 luma rows x 2, 2 x 9 chroma rows x 2) at 5 ops each
# (row clamp, address); per word of 4 pixels the prediction takes 37 ops
# (11 to pick the 4 taps from the staged rows, 26 for the 16-bit-lane
# average) and the combine of a coded block 24
MC_STAGED_LOADS, MC_OPS_PER_STAGED_LOAD = 2 * 17 + 2 * 2 * 9, 5
MC_OPS_PER_WORD, COMBINE_OPS_PER_WORD = 37, 24
# csrc/wire_unpack.cu: per pair about 20 ops in launch A and 25 in launch
# B; per macroblock about 60 in A and 75 in B
K3_OPS_PER_PAIR = 20 + 25
K3_OPS_PER_MB = 60 + 75
# bytes K3 writes per macroblock (qscale, 6 coded, intra, written, mv_h
# and mv_v int32) and per coded block (its 64 int16 levels and int32 id)
K3_BYTES_PER_MB = 1 + 6 + 1 + 1 + 4 + 4
K3_BYTES_PER_BLOCK = 64 * 2 + 4


def bound(n_bytes: float, n_ops: float):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    integer ops over the int32 rate."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / INT32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            'bytes' if t_bytes >= t_ops else 'operations')


def k1_work(n_blocks: int, nonzero: int, n_mb: int, compact: bool):
    """(bytes, int32 ops) of K1's levels forms over n_blocks blocks
    holding `nonzero` non-zero levels: each block's 128 B of int16
    levels read and 256 B of int32 residuals written (the compact form
    also reads each row's 4-byte id), each of the n_mb macroblocks whose
    blocks it covers reads its qscale and intra, and the two matrices;
    the IDCT's and the dequant's integer ops."""
    return (n_blocks * (64 * (2 + 4) + (4 if compact else 0))
            + 2 * n_mb + 2 * 64 * 4,
            n_blocks * (IDCT_OPS_PER_BLOCK + 64 * DEQUANT_OPS_PER_LEVEL)
            + nonzero * DEQUANT_OPS_PER_NONZERO)


def k3_work(wire_bytes: int, items: int, n_rows: int, n_pairs: int):
    """(bytes, int32 ops) of K3 on a wire of `wire_bytes` bytes, read
    once: `items` macroblocks' fields and `n_rows` compact rows with
    their ids written; the ops counted from its source."""
    return (wire_bytes + items * K3_BYTES_PER_MB
            + n_rows * K3_BYTES_PER_BLOCK,
            n_pairs * K3_OPS_PER_PAIR + items * K3_OPS_PER_MB)


def k2_work_counts(n_frames: int, n_mb: int, coded: int, intra_coded: int,
                   written: int):
    """(bytes, integer ops) K2 must spend on a launch of n_frames frames of
    n_mb macroblocks holding `coded` coded blocks (`intra_coded` of them
    in intra macroblocks) and `written` macroblocks predicted from the
    forward picture: meta + output per macroblock; each base block's 64
    reference pixels (none for a coded intra block); the residual of
    coded blocks only."""
    base = n_frames * n_mb * 6 - intra_coded
    n_bytes = n_frames * n_mb * (12 + 384) + base * 64 + coded * 64 * 4
    n_ops = (written * (MC_STAGED_LOADS * MC_OPS_PER_STAGED_LOAD
                        + 96 * MC_OPS_PER_WORD)
             + coded * 16 * COMBINE_OPS_PER_WORD)
    return n_bytes, n_ops


def k2_work(meta):
    """(bytes, integer ops) K2 must spend on a launch's metadata
    (int32 [F, n_mb, 3], mode bits 0-5 coded blocks, 6 intra, 7 written),
    as `chip_smoke.py` counts them."""
    F, n_mb = meta.shape[:2]
    mode = meta[..., 2]
    bits = [((mode >> b) & 1) for b in range(6)]
    coded = int(sum(int(b.sum()) for b in bits))
    intra = (mode >> 6) & 1
    written = int(((mode >> 7) & 1).sum())
    intra_coded = int(sum(int((intra & b).sum()) for b in bits))
    return k2_work_counts(F, n_mb, coded, intra_coded, written)

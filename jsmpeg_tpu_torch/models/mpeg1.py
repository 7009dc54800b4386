"""MPEG1 video decoder: host parse + PyTorch/CUDA decode pipeline.

The reference's Decoder contract (connect/write/decode/seek, jsmpeg's
src/decoder.js) over the same host frontend as jsmpeg_tpu: the threaded
C++ batch parse emits the packed wire v2 (byte for byte jsmpeg_tpu's),
kernel K3 (csrc/wire_unpack.cu) unpacks it on the device into the levels
of the coded blocks only, kernel K1 (csrc/dequant_idct.cu) dequantizes +
inverse-transforms those blocks of the whole batch in one launch, and
kernel K2 (csrc/mc_combine.cu) runs the batch's frame loop (motion
compensation and combine, the reference planes rotated on the device) in
one more.
Coefficient-dense batches take the dense-levels wire, and a batch of
the sparse wire (`parse_batch(packed=False)`: global index/value pairs)
is scattered into a dense levels lattice on the device; quirky or
malformed streams finish on the always-exact serial path (premultiplied
coefficients from `parse_frame`, K1 in its IDCT-only mode, then K2).

`decode_available` runs a two-thread pipeline: the calling thread
parses batch k+1 while one feeder thread builds batch k's wire in pinned
host memory, uploads it and queues its unpack, K1 and K2 (and, when the
frames are rendered, their copy back); the calling thread renders batch
k-1 meanwhile.  `decode()` stays on the calling thread.

Every tensor lives on the decoder's `device` ('cuda' by default).  On
the CPU (device='cpu', the tests) the plain PyTorch versions of the
kernels run instead, on the same two threads.
"""

from __future__ import annotations

import contextlib
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from ..config import resolve_device
from ..host.mpeg1_parse import FrameData, MPEG1Parser
from ..ops.frame import FrameArrays, LevelsArrays, Planes, PlanesBatch, \
    decode_frames, frame_meta
from ..ops import kernels
from ..ops.idct import dequant_idct, dequant_idct_compact


def frame_to_arrays(f: FrameData) -> FrameArrays:
    """Host FrameData -> FrameArrays of numpy arrays (serial path)."""
    return FrameArrays(
        coef=f.coef.astype(np.int32),
        coded=f.coded,
        intra=f.intra,
        written=f.written,
        mv_h=f.mv[:, 0].astype(np.int32),
        mv_v=f.mv[:, 1].astype(np.int32),
    )


def stack_frames(frames: List[FrameArrays]) -> FrameArrays:
    return FrameArrays(*[np.stack([getattr(f, name) for f in frames])
                         for name in FrameArrays._fields])


# ------------------------------------------------------------ wire v2 (host)

def _bitmap_bytes(n_frames: int, n_mb: int) -> int:
    return (n_frames * n_mb + 7) // 8


def mv_fits_narrow(mv: np.ndarray) -> bool:
    """True when every component of an int16 MV array fits int8 (the
    narrow 4-byte run record)."""
    return bool(mv.size == 0 or (mv.min() >= -128 and mv.max() <= 127))


def fused_buffer_len(n_frames: int, n_mb: int, n_pairs: int, n_runs: int,
                     mv_wide: bool, n_esc: int) -> int:
    """Total wire-v2 buffer length for the given sizes (n_esc sizes the
    int16 escape side stream)."""
    return (n_frames + _bitmap_bytes(n_frames, n_mb)
            + (8 if mv_wide else 4) * n_runs
            + 2 * n_pairs + 2 * n_esc)


def host_empty(n: int) -> np.ndarray:
    """n bytes of ordinary host memory (uint8)."""
    return np.empty(n, np.uint8)


def build_fused_buffer_sized(batch: dict, n_frames: int, n_pairs: int,
                             n_runs: int, n_mb: int, mv_wide: bool,
                             n_esc: int, empty=host_empty) -> np.ndarray:
    """Assemble the single-upload wire buffer (wire v2, see unpack_fused)
    from a packed parse_batch dict with caller-fixed sizes, into the
    uint8 array `empty(n)` returns (every byte is written)."""
    F = n_frames
    n = batch['n']
    total = len(batch['sp_pos'])
    actual_esc = len(batch['sp_esc'])
    bucket = n_pairs
    rt = len(batch['run_len'])
    assert total <= bucket and actual_esc <= n_esc and rt <= n_runs
    B = _bitmap_bytes(F, n_mb)
    w = 8 if mv_wide else 4
    buf = empty(fused_buffer_len(F, n_mb, bucket, n_runs, mv_wide, n_esc))
    buf[:F] = np.arange(F) < n
    o = F
    # run-start bitmap: bit (i & 7) of byte (i >> 3) marks MB i opening a
    # run.  Real runs are never empty (the RLE invariant; asserted --
    # an empty mid-stream run would desync slot<->record), so start
    # positions are distinct and the device's bit-cumsum numbers runs in
    # record order.
    lens = batch['run_len'].astype(np.int64)
    assert rt == 0 or (lens.min() > 0 and lens.sum() <= F * n_mb)
    starts = np.cumsum(lens) - lens
    bm = np.zeros(B, np.uint8)
    np.bitwise_or.at(bm, starts >> 3, (1 << (starts & 7)).astype(np.uint8))
    buf[o:o + B] = bm
    o += B
    rec = np.zeros((n_runs, w), np.uint8)
    mv = batch['run_mv']
    if mv_wide:
        rec[:rt, 0:4] = mv.astype('<i2').reshape(rt, 2).view(
            np.uint8).reshape(rt, 4)
        rec[:rt, 4] = batch['run_flags']
        rec[:rt, 5] = batch['run_cbp']
    else:
        assert mv_fits_narrow(mv)
        rec[:rt, 0] = batch['run_flags']
        rec[:rt, 1] = batch['run_cbp']
        rec[:rt, 2:4] = mv.astype(np.int8).reshape(rt, 2).view(np.uint8)
    buf[o:o + w * n_runs] = rec.reshape(-1)
    o += w * n_runs
    # padding pairs: bit 6 set (never scattered), bit 7 clear (do not
    # advance the block slot); padding values 0 (not the escape sentinel)
    buf[o:o + bucket] = 0x40
    buf[o:o + total] = batch['sp_pos']
    o += bucket
    buf[o:o + total] = batch['sp_v8'].view(np.uint8)
    buf[o + total:o + bucket] = 0
    o += bucket
    buf[o:o + 2 * actual_esc] = batch['sp_esc'].view(np.uint8)
    buf[o + 2 * actual_esc:] = 0
    return buf


def build_fused_buffer(batch: dict, n_mb: int, empty=host_empty):
    """The wire buffer of one packed batch at its exact sizes: F = the
    batch's frame count, and pairs, escapes, runs and coded blocks as
    parsed (at least 1 each, so no stream is empty).  Eager PyTorch has
    no compiled shapes to reuse, so nothing is bucketed.  `empty(n)`
    allocates it (`pinned_empty` on the card).  Returns (buf uint8,
    n_blk, n_runs, mv_wide, n_pairs, n_esc)."""
    n_pairs = max(len(batch['sp_pos']), 1)
    n_esc = max(len(batch['sp_esc']), 1)
    n_runs = max(len(batch['run_len']), 1)
    n_blk = max(batch['n_blocks'], 1)
    mv_wide = not mv_fits_narrow(batch['run_mv'])
    buf = build_fused_buffer_sized(batch, batch['n'], n_pairs, n_runs, n_mb,
                                   mv_wide, n_esc, empty)
    return buf, n_blk, n_runs, mv_wide, n_pairs, n_esc


def pinned_empty(n: int) -> np.ndarray:
    """n bytes of page-locked host memory from PyTorch's caching host
    allocator, as a numpy array (which keeps the block alive).  A
    non-blocking upload of it records an event on its block, and the
    allocator hands the block out again only once no array holds it and
    that event has completed."""
    return torch.empty(n, dtype=torch.uint8, pin_memory=True).numpy()


# ---------------------------------------------------------- wire v2 (device)

def unpack_fused(buf: torch.Tensor, n_frames: int, n_mb: int, n_runs: int,
                 mv_wide: bool, n_pairs: int, n_esc: int):
    """Decode the single-upload wire buffer into per-MB streams.

    Layout (wire v2): [valid F][run-start bitmap B=(F*n_mb+7)//8]
    [run records R*w][sp_pos P][sp_v8 i8 P][sp_esc LE i16 E], with
    P = n_pairs and E = n_esc.  The valid bytes are skipped: the port's
    wire never carries padding frames.  One bit per MB marks run
    starts (bitorder little); a cumsum numbers each MB's run.  Run
    records are w=4 bytes [flags, cbp, mv_h i8, mv_v i8], or w=8 bytes
    [mv_h i16, mv_v i16, flags, cbp, 0, 0] when the batch carries wide
    vectors.  Coefficient values ride as int8 with -128 escaping to the
    int16 side stream.

    Returns (flags[F,n_mb] u8, cbp[F,n_mb] u8, mv16[F,n_mb,2] i16,
    sp_pos[P] u8, sp_val[P] i16)."""
    F = n_frames
    R = n_runs
    B = _bitmap_bytes(F, n_mb)
    w = 8 if mv_wide else 4
    P, E = n_pairs, n_esc
    o = F
    bm = buf[o:o + B]
    o += B
    rec = buf[o:o + w * R].reshape(R, w)
    o += w * R
    sp_pos = buf[o:o + P]
    o += P
    sp_v8 = buf[o:o + P].view(torch.int8)
    o += P
    # the escape stream starts at an arbitrary byte offset, and a 2-byte
    # view needs an even storage offset: copy it out first
    sp_esc = buf[o:o + 2 * E].clone().view(torch.int16)
    is_esc = sp_v8 == -128
    eslot = (torch.cumsum(is_esc, 0, dtype=torch.int32) - 1).clamp(0, E - 1)
    sp_val = torch.where(is_esc, sp_esc[eslot.long()], sp_v8.to(torch.int16))

    # expand runs -> per-MB streams: run slot per MB = (number of run
    # starts at or before the MB) - 1.  MBs past the last run (padding
    # frames of a bucketed wire) read the last real run's values; an
    # all-empty cell reads the zero record.
    shifts = torch.arange(8, dtype=torch.uint8, device=buf.device)
    bits = (bm[:, None] >> shifts) & 1
    slot = (torch.cumsum(bits.reshape(-1)[:F * n_mb], 0, dtype=torch.int32)
            - 1).clamp_min(0)
    taken = rec[slot.long()]                    # [F*n_mb, w] record bytes
    if mv_wide:
        mv16 = taken[:, 0:4].contiguous().view(torch.int16)
        flags, cbp = taken[:, 4], taken[:, 5]
    else:
        mv16 = taken[:, 2:4].contiguous().view(torch.int8).to(torch.int16)
        flags, cbp = taken[:, 0], taken[:, 1]
    return (flags.contiguous().reshape(F, n_mb),
            cbp.contiguous().reshape(F, n_mb), mv16.reshape(F, n_mb, 2),
            sp_pos, sp_val)


def _mb_fields(flags: torch.Tensor, cbp: torch.Tensor,
              mv16: torch.Tensor) -> LevelsArrays:
    """The per-macroblock fields of the packed records (levels None)."""
    coded = ((cbp[..., None] >> torch.arange(6, dtype=torch.uint8,
                                             device=flags.device)) & 1) != 0
    return LevelsArrays(
        levels=None, qscale=flags & 31, coded=coded,
        intra=(flags & 0x20) != 0, written=(flags & 0x40) != 0,
        mv_h=mv16[..., 0].to(torch.int32), mv_v=mv16[..., 1].to(torch.int32))


def _ordinal_ids(coded: torch.Tensor, n_blk: int, none: int) -> torch.Tensor:
    """int32 [n_blk]: coded-block ordinal k's flat block id (row-major
    (frame, mb, block) order), `none` where no coded block has ordinal
    k; ordinals >= n_blk are dropped (a dump slot past the end)."""
    mask = coded.reshape(-1)
    ordinal = torch.cumsum(mask, 0, dtype=torch.int32) - 1
    dst = torch.where(mask, ordinal.clamp_max(n_blk), n_blk).long()
    ids = torch.full((n_blk + 1,), none, dtype=torch.int32,
                     device=coded.device)
    ids[dst] = torch.arange(mask.numel(), dtype=torch.int32,
                            device=coded.device)
    return ids[:n_blk]


def packed_to_levels(flags: torch.Tensor, cbp: torch.Tensor,
                     mv16: torch.Tensor, sp_pos: torch.Tensor,
                     sp_val: torch.Tensor, n_blk: int) -> LevelsArrays:
    """Packed wire -> dense LevelsArrays.  Per-MB metadata rides packed
    into bytes and coefficients as (pos, value) pairs whose block is
    carried by flag bits (bit 7 = first pair of a coded block, bit 6 =
    never scattered: empty-coded-block markers and padding).  Coded-block
    ids in row-major (frame, mb, block) order match the host's emission
    order.  Out-of-range ids (padding) are dropped, as JAX's
    mode='drop' scatters drop them: here they land in a dump slot past
    the end, which is cut off."""
    F, n_mb = flags.shape
    dev = flags.device
    la = _mb_fields(flags, cbp, mv16)
    oob = F * n_mb * 6
    # coded-block ordinal -> flat block id; ids never named stay oob
    blk_dense = _ordinal_ids(la.coded, n_blk, oob)
    slot = torch.cumsum(sp_pos >> 7, 0, dtype=torch.int32) - 1
    pair_ok = (sp_pos & 0x40) == 0
    gid = blk_dense[slot.clamp(0, n_blk - 1).long()]
    total = oob * 64
    fidx = torch.where(pair_ok, gid * 64 + (sp_pos & 63).to(torch.int32),
                       total)
    flat = torch.zeros(total + 1, dtype=torch.int16, device=dev)
    flat[fidx.clamp_max(total).long()] = sp_val
    return la._replace(levels=flat[:total].reshape(F, n_mb, 6, 64))


def packed_to_blocks(flags: torch.Tensor, cbp: torch.Tensor,
                     mv16: torch.Tensor, sp_pos: torch.Tensor,
                     sp_val: torch.Tensor, n_blk: int) -> LevelsArrays:
    """Packed wire -> compact LevelsArrays: packed_to_levels' levels of
    the coded blocks only, coded-block ordinal k (row-major (frame, mb,
    block) order, the host's emission order) in row k of an int16
    [n_blk, 64] lattice, and blk_ids int32 [n_blk], row k's flat block id
    (f * n_mb + m) * 6 + b.  Pairs map to ordinals as in
    packed_to_levels (clamped into [0, n_blk - 1]).  A row past the coded
    blocks (n_blk above their count: a shared-size wire) is zero with id
    -1; a coded block past ordinal n_blk - 1 has no row, and its levels
    are packed_to_levels' zeros.  Scattered by blk_ids into a zeroed
    lattice (`levels_dense`) it is packed_to_levels' lattice."""
    la = _mb_fields(flags, cbp, mv16)
    blk_ids = _ordinal_ids(la.coded, n_blk, -1)
    slot = torch.cumsum(sp_pos >> 7, 0, dtype=torch.int32) - 1
    total = n_blk * 64
    cidx = torch.where((sp_pos & 0x40) == 0,
                       slot.clamp(0, n_blk - 1) * 64
                       + (sp_pos & 63).to(torch.int32), total)
    flat = torch.zeros(total + 1, dtype=torch.int16, device=flags.device)
    flat[cidx.long()] = sp_val
    levels = flat[:total].reshape(n_blk, 64)
    levels[blk_ids < 0] = 0
    return la._replace(levels=levels, blk_ids=blk_ids)


def levels_dense(la: LevelsArrays) -> LevelsArrays:
    """A compact LevelsArrays as the dense one it stands for: each named
    row scattered to its block of a zeroed [F, n_mb, 6, 64] lattice,
    blk_ids None.  A dense one is returned as it is."""
    if la.blk_ids is None:
        return la
    F, n_mb = la.qscale.shape
    flat = la.levels.new_zeros((F * n_mb * 6, 64))
    named = la.blk_ids >= 0
    flat[la.blk_ids[named].long()] = la.levels[named]
    return la._replace(levels=flat.reshape(F, n_mb, 6, 64), blk_ids=None)


def upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> device tensor (asynchronous on CUDA, so the copy does
    not wait for the kernels already queued).  An array in pinned memory
    (`pinned_empty`) goes up as it is; any other is first copied into a
    pinned one."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == 'cuda':
        if not t.is_pinned():
            t = t.pin_memory()
        return t.to(device, non_blocking=True)
    return t.to(device)


# packed_to_levels numbers a batch's levels lattice (F * n_mb * 6 * 64
# values, plus its dump slot) in int32
LATTICE_LIMIT = 2**31 - 1


def check_lattice(n_frames: int, n_mb: int) -> None:
    """Raise ValueError when a batch of n_frames frames of n_mb macroblocks
    has more levels than packed_to_levels' int32 indices can number (its
    `gid * 64` would wrap and its dump index overflow)."""
    total = n_frames * n_mb * 6 * 64
    if total > LATTICE_LIMIT:
        raise ValueError(
            f'a batch of {n_frames} frames x {n_mb} macroblocks holds '
            f'{total} levels, over the int32 lattice limit {LATTICE_LIMIT}')


def lattice_groups(n_seg: int, n_frames: int, n_mb: int) -> list:
    """The fewest runs [a, b) of consecutive segments (n_mb macroblocks
    each, n_frames frames) whose joint lattice passes check_lattice: one
    launch pair per run, a single run below the limit.  Raises when one
    segment alone is over it."""
    check_lattice(n_frames, n_mb)
    per = LATTICE_LIMIT // max(n_frames * n_mb * 6 * 64, 1)
    return [(a, min(a + per, n_seg)) for a in range(0, n_seg, per)]


class StagedWire(NamedTuple):
    """One packed batch's wire on the device, with the sizes its unpack
    needs (`stage_packed`)."""
    buf: torch.Tensor       # uint8 [L] wire v2
    n_frames: int
    n_mb: int
    n_runs: int
    mv_wide: bool
    n_pairs: int
    n_esc: int
    n_blk: int


def stage_packed(batch: dict, n_mb: int, put,
                 empty=host_empty) -> StagedWire:
    """The host half of one packed batch: its wire buffer built (into
    `empty(n)`) and uploaded by `put` (host array -> device tensor).
    Raises ValueError before the upload when the batch's lattice is over
    check_lattice's limit."""
    check_lattice(batch['n'], n_mb)
    buf, n_blk, n_runs, mv_wide, n_pairs, n_esc = build_fused_buffer(
        batch, n_mb, empty)
    return StagedWire(put(buf), batch['n'], n_mb, n_runs, mv_wide, n_pairs,
                      n_esc, n_blk)


def unpack_wires_ref(bufs: torch.Tensor, n_frames: int, n_mb: int,
                     n_runs: int, mv_wide: bool, n_pairs: int, n_esc: int,
                     n_blk: int) -> LevelsArrays:
    """K3's plain version: each of the S wires [S, L] (shared sizes)
    through unpack_fused + packed_to_blocks, the S streams joined: their
    fields along macroblocks ([F, S*n_mb], stream s in columns [s*n_mb,
    (s+1)*n_mb)), their rows one after another (stream s's at rows
    [s*n_blk, (s+1)*n_blk)), each id the block's in the joint layout.
    Runs on any device."""
    las = [packed_to_blocks(*unpack_fused(buf, n_frames, n_mb, n_runs,
                                          mv_wide, n_pairs, n_esc), n_blk)
           for buf in bufs]
    S = len(las)
    if S == 1:
        return las[0]
    per = n_mb * 6
    ids = [torch.where(la.blk_ids >= 0, (la.blk_ids // per * S + s) * per
                       + la.blk_ids % per, -1)
           for s, la in enumerate(las)]
    fields = [torch.stack(x, 1).flatten(1, 2)
              for x in zip(*[la[1:7] for la in las])]
    return LevelsArrays(torch.cat([la.levels for la in las]), *fields,
                        blk_ids=torch.cat(ids).to(torch.int32))


def unpack_wires(bufs: torch.Tensor, n_frames: int, n_mb: int, n_runs: int,
                 mv_wide: bool, n_pairs: int, n_esc: int,
                 n_blk: int) -> LevelsArrays:
    """The wire unpack of S streams' wires v2 at shared sizes (uint8
    [S, L]) into their joint compact levels (unpack_wires_ref's contract):
    K3 (csrc/wire_unpack.cu, one call) on a CUDA tensor, the plain version
    on a CPU one."""
    if bufs.device.type == 'cuda':
        return LevelsArrays(*kernels.wire_unpack_cuda(
            bufs, n_frames, n_mb, n_runs, mv_wide, n_pairs, n_esc, n_blk))
    return unpack_wires_ref(bufs, n_frames, n_mb, n_runs, mv_wide, n_pairs,
                            n_esc, n_blk)


def unpack_staged(w: StagedWire) -> LevelsArrays:
    """The device half: the staged wire unpacked into compact levels (K3
    on the card, its plain version on the CPU: unpack_wires)."""
    return unpack_wires(w.buf[None], w.n_frames, w.n_mb, w.n_runs,
                        w.mv_wide, w.n_pairs, w.n_esc, w.n_blk)


def upload_packed(batch: dict, n_mb: int, put) -> LevelsArrays:
    """One packed batch: ONE wire buffer upload (`put`, host array ->
    device tensor), then the device unpack into compact levels.  Raises
    ValueError before the upload when the batch's lattice is over
    check_lattice's limit."""
    return unpack_staged(stage_packed(batch, n_mb, put))


@contextlib.contextmanager
def _on_stream(stream):
    """Queue the enclosed work on `stream` and its device: a new thread
    starts on device 0's default stream and does not inherit the
    caller's device.  None (the CPU) changes nothing."""
    if stream is None:
        yield
        return
    with torch.cuda.device(stream.device), torch.cuda.stream(stream):
        yield


def sparse_to_levels(sp_idx: torch.Tensor, sp_val: torch.Tensor,
                     n_frames: int, n_mb: int) -> torch.Tensor:
    """The sparse wire's (global index, value) pairs scattered into a
    zeroed int16 [F, n_mb, 6, 64] lattice.  Indices outside the lattice
    are dropped, as JAX's mode='drop' scatter drops them: here they land
    in a dump slot past the end, which is cut off."""
    total = n_frames * n_mb * 6 * 64
    idx = sp_idx.long()
    idx = torch.where((idx >= 0) & (idx < total), idx, total)
    flat = torch.zeros(total + 1, dtype=torch.int16, device=sp_val.device)
    flat[idx] = sp_val.to(torch.int16)
    return flat[:total].reshape(n_frames, n_mb, 6, 64)


def state_from_numpy(cur, fwd, intra_q, non_intra_q, device):
    """Decoder state from numpy arrays -> the port's tensors on `device`:
    cur/fwd are (y, cr, cb) uint8 planes (e.g. jsmpeg_tpu's carry),
    intra_q/non_intra_q int [64] quant matrices.  Returns
    (cur Planes, fwd Planes, intra_q int32, non_intra_q int32)."""
    def planes(p):
        return Planes(*[torch.as_tensor(np.ascontiguousarray(x, np.uint8),
                                        device=device) for x in p])

    def mat(q):
        return torch.as_tensor(np.asarray(q, np.int32), device=device)

    return planes(cur), planes(fwd), mat(intra_q), mat(non_intra_q)


def levels_blocks(la: LevelsArrays, intra_q: torch.Tensor,
                  non_intra_q: torch.Tensor):
    """K1 over a levels batch in one launch: its compact form over the
    coded blocks' rows of a compact LevelsArrays, else over all F*n_mb*6
    blocks.  Returns (resid int32 [F, n_mb, 6, 64], meta int32 [F, n_mb,
    3]), the frame loop's inputs (a compact batch's resid holds its coded
    blocks only: the frame loop reads no other)."""
    F, n_mb = la.qscale.shape
    if la.blk_ids is not None:
        resid = dequant_idct_compact(la.levels, la.blk_ids,
                                     la.qscale.reshape(-1),
                                     la.intra.reshape(-1), intra_q,
                                     non_intra_q, F * n_mb * 6)
    else:
        resid = dequant_idct(la.levels.reshape(F * n_mb, 6, 64),
                             la.qscale.reshape(-1), la.intra.reshape(-1),
                             intra_q, non_intra_q)
    meta = frame_meta(la.coded, la.intra, la.written, la.mv_h, la.mv_v)
    return resid.reshape(F, n_mb, 6, 64), meta


def coef_blocks(f: FrameArrays):
    """K1 in its IDCT-only mode over stacked premultiplied frames (the
    serial path); returns (resid, meta) as levels_blocks."""
    F, n_mb = f.intra.shape
    resid = dequant_idct(f.coef.reshape(F * n_mb, 6, 64), premultiplied=True)
    meta = frame_meta(f.coded, f.intra, f.written, f.mv_h, f.mv_v)
    return resid.reshape(F, n_mb, 6, 64), meta


def decode_levels(cur: Planes, fwd: Planes, la: LevelsArrays,
                  intra_q: torch.Tensor, non_intra_q: torch.Tensor,
                  n_seg: int = 1, seg_frames=None):
    """One batch of the levels wire: K1 in one launch (levels_blocks),
    then the frame loop (K2, one launch).  With n_seg > 1 the
    planes and the macroblocks are n_seg streams stacked along macroblock
    rows, segment s decoding its first seg_frames[s] frames
    (ops.frame.decode_frames).  Returns (cur, fwd, PlanesBatch of the F
    frames)."""
    return decode_frames(cur, fwd, *levels_blocks(la, intra_q, non_intra_q),
                         n_seg, seg_frames)


def decode_coef(cur: Planes, fwd: Planes, f: FrameArrays, n_seg: int = 1,
                seg_frames=None):
    """Stacked premultiplied frames (the serial path): K1 in its IDCT-only
    mode over every block, then the frame loop (K2, one launch), with
    segments as in decode_levels (the GOPs of parallel/gop.py)."""
    return decode_frames(cur, fwd, *coef_blocks(f), n_seg, seg_frames)


# ----------------------------------------------------------------- outputs

def _to_host(p: Planes) -> Planes:
    return Planes(*[x.cpu().numpy() for x in p])


class FrameSeq:
    """List-like concatenation of PlanesBatch chunks + single Planes.

    Frames decoded under retain=False were rendered to the destination and
    their device tensors released; they count toward len() but indexing
    them raises (there is nothing left to return)."""

    def __init__(self):
        self._chunks: list = []
        self._len = 0
        self._released = 0

    def append_batch(self, batch: PlanesBatch) -> None:
        self._chunks.append(batch)
        self._len += len(batch)

    def append(self, planes: Planes) -> None:
        self._chunks.append(planes)
        self._len += 1

    def count_only(self, n: int) -> None:
        """Record frames that were already consumed (rendered + released)
        without retaining their device tensors."""
        self._released += n

    def __len__(self) -> int:
        return self._released + self._len

    def __getitem__(self, i: int):
        total = self._released + self._len
        if not -total <= i < total:
            raise IndexError(i)
        i = i % total
        if i < self._released:
            raise IndexError(
                f'frame {i} was rendered and released (retain=False)')
        i -= self._released
        for c in self._chunks:
            n = len(c) if isinstance(c, PlanesBatch) else 1
            if i < n:
                return c[i] if isinstance(c, PlanesBatch) else c
            i -= n
        raise IndexError(i)

    def __iter__(self):
        for i in range(self._released, self._released + self._len):
            yield self[i]

    def stacked_planes(self) -> Optional[Planes]:
        """Every retained frame as ONE stacked Planes ([n, H, W] per
        plane), built from the whole-batch tensors in a single cat per
        plane and never from per-frame slices (the demoted-stream serving
        path, parallel/streams.py).  None when nothing is retained."""
        parts = [c.planes if isinstance(c, PlanesBatch)
                 else Planes(*[p[None] for p in c]) for c in self._chunks]
        if not parts:
            return None
        if len(parts) == 1:
            return parts[0]
        return Planes(*[torch.cat(ps) for ps in zip(*parts)])


# ----------------------------------------------------------------- decoder

class MPEG1Decoder:
    """Streaming-capable MPEG1 video decoder (PyTorch/CUDA pipeline).

    write() bytes in, decode() one frame out -- or decode_available() to
    decode every parsed picture in batches (the high-throughput path).

    Options: 'device' (default 'cuda'; construction raises when no GPU is
    present unless a device is given), 'native' (None = best parser,
    True = C++, False = Python), 'onVideoDecode', 'decodeFirstFrame',
    'streaming', 'videoBufferSize'.
    """

    # frames per parse batch (one K1 launch each)
    BATCH_FRAMES = 32

    def __init__(self, options: Optional[dict] = None):
        options = options or {}
        self.device = resolve_device(options.get('device'), 'MPEG1Decoder')
        use_native = options.get('native')
        if use_native is None:
            from ..host import best_parser
            self.parser = best_parser()
        elif use_native:
            from ..host.native import NativeMPEG1Parser
            self.parser = NativeMPEG1Parser()
        else:
            self.parser = MPEG1Parser()
        self.destination = None
        # the wire's host memory: pinned on the card, so its upload is
        # one asynchronous copy
        self._host_empty = (pinned_empty if self.device.type == 'cuda'
                            else host_empty)
        self._cur: Optional[Planes] = None
        self._fwd: Optional[Planes] = None
        self._quant_key = None
        self._quant_dev = None
        self.frame_rate = 30.0
        self.on_decode = options.get('onVideoDecode')
        self.decode_first_frame = options.get('decodeFirstFrame', False)
        self._first_frame_done = False
        self.frames_decoded = 0
        # timestamp collection for static-file A/V sync + seek
        # (semantics of the reference Decoder.Base, src/decoder.js:36-102)
        self.streaming = bool(options.get('streaming'))
        self.buffer_size = options.get('videoBufferSize', 512 * 1024)
        self.collect_timestamps = not self.streaming
        self.bytes_written = 0
        self.timestamps: list = []      # (bit_index, pts)
        self.timestamp_index = 0
        self.start_time = 0.0
        self.decoded_time = 0.0
        self.can_play = False

    # ------------------------------------------------------- decoder API

    def connect(self, destination) -> None:
        self.destination = destination

    def write(self, pts, buffers) -> None:
        if isinstance(buffers, (bytes, bytearray, memoryview, np.ndarray)):
            buffers = [buffers]
        if self.collect_timestamps and pts is not None:
            if not self.timestamps:
                self.start_time = pts
                self.decoded_time = pts
            self.timestamps.append((self.bytes_written << 3, pts))
        for b in buffers:
            data = bytes(b)
            self.bytes_written += len(data)
            self.parser.write(data)
        if self.streaming:
            self._enforce_buffer_cap()
        self.can_play = True
        if self.parser.has_sequence_header and self._cur is None:
            self._init_planes()
            if self.decode_first_frame and not self._first_frame_done:
                # immediate first-frame decode on header detect (preview
                # while paused; reference src/mpeg1.js:29-42)
                self._first_frame_done = True
                self.decode()

    def _enforce_buffer_cap(self) -> None:
        # EVICT-mode memory bound (reference src/buffer.js:30-62): drop
        # consumed bytes; if unread data still exceeds the cap, drop it all
        # (the reference's emergency evac -- streaming prefers staying
        # current over completeness)
        bits = self.parser.bits
        bits.evict_consumed()
        unread = bits.byte_length - (bits.index >> 3)
        if unread > self.buffer_size:
            bits.index = bits.byte_length << 3
            bits.evict_consumed()

    @property
    def current_time(self) -> float:
        return self.decoded_time

    def seek(self, time: float, to_iframe: bool = False) -> None:
        if not self.collect_timestamps:
            return
        self.timestamp_index = 0
        for i, (_, t) in enumerate(self.timestamps):
            if t > time:
                break
            self.timestamp_index = i
        if self.timestamps:
            idx, t = self.timestamps[self.timestamp_index]
            self.parser.bits.index = idx
            self.decoded_time = t
        else:
            self.parser.bits.index = 0
            self.decoded_time = self.start_time
        if to_iframe and hasattr(self.parser, 'seek_iframe'):
            # snap forward to the next I picture: a clean GOP-aligned
            # resume (the reference decodes from the raw byte position and
            # shows artifacts until the next I refresh)
            self.parser.seek_iframe()

    def advance_decoded_time(self, seconds: float) -> None:
        if self.collect_timestamps:
            new_index = -1
            current = self.parser.bits.index
            for i in range(self.timestamp_index, len(self.timestamps)):
                if self.timestamps[i][0] > current:
                    break
                new_index = i
            if new_index != -1 and new_index != self.timestamp_index:
                self.timestamp_index = new_index
                self.decoded_time = self.timestamps[new_index][1]
                return
        self.decoded_time += seconds

    def _init_planes(self) -> None:
        seq = self.parser.seq
        # forbidden/reserved picture-rate codes map to 0.0
        # (tables.PICTURE_RATE, ISO 11172-2 table 2-5): keep the previous
        # (default 30) rate instead of dividing by zero per decoded frame
        # -- the JS reference silently produces Infinity timestamps here
        # (1/0 in JS); a finite fallback is the documented deviation
        if seq.frame_rate > 0:
            self.frame_rate = seq.frame_rate
        cw, ch = seq.coded_width, seq.coded_height

        def z(h, w):
            return torch.zeros((h, w), dtype=torch.uint8, device=self.device)

        self._cur = Planes(z(ch, cw), z(ch >> 1, cw >> 1), z(ch >> 1, cw >> 1))
        self._fwd = Planes(z(ch, cw), z(ch >> 1, cw >> 1), z(ch >> 1, cw >> 1))
        if self.destination is not None:
            if hasattr(self.destination, 'resize'):
                self.destination.resize(seq.width, seq.height)
            if hasattr(self.destination, 'frame_rate'):
                self.destination.frame_rate = self.frame_rate

    @property
    def seq(self):
        return self.parser.seq

    def decode(self, eof: bool = False):
        """Decode one picture; returns Planes (device tensors, or host
        numpy arrays when a destination is connected) or None."""
        t0 = time.monotonic()
        out = None
        if hasattr(self.parser, 'parse_batch'):
            batch = self.parser.parse_batch(1, eof=eof)
            if batch is None:
                return None
            if isinstance(batch, dict):
                out = self._decode_batch(batch)[0]
        if out is None:
            fd = self.parser.parse_frame(eof=eof)
            if fd is None:
                return None
            out = self._decode_serial([frame_to_arrays(fd)])[0]
        self.advance_decoded_time(1.0 / self.frame_rate)
        self.frames_decoded += 1
        if self.streaming:
            self.parser.bits.evict_consumed()
        if self.destination is not None:
            out = _to_host(out)
            self.destination.render(out.y, out.cr, out.cb)
        if self.on_decode is not None:
            self.on_decode(self, time.monotonic() - t0)
        return out

    def decode_available(self, eof: bool = False, retain: bool = True,
                         mesh=None):
        """Parse every complete picture buffered and decode them in
        batches of up to BATCH_FRAMES.  Returns a FrameSeq of Planes
        (device tensors), or None when nothing was decoded.

        retain=False (requires a connected destination) renders each
        batch as soon as it completes and releases its tensors -- bounded
        device memory for arbitrarily long files; the returned FrameSeq
        then only carries the frame count.

        mesh: an optional parallel.mesh.Mesh -- closed GOPs decode over
        its 'gop' cells (parallel/packed.py MeshPackedDecoder), the GOPs
        of one device as the segments of one K1 + K2 launch pair."""
        if not retain and self.destination is None:
            raise ValueError('retain=False requires a connected destination '
                             '(frames are rendered and released per batch)')
        release = not retain
        if mesh is not None and hasattr(self.parser, 'parse_batch'):
            return self._decode_available_mesh(mesh, eof, release)
        outs = FrameSeq()
        needs_serial = (self._decode_available_batch(eof, outs, release)
                        if hasattr(self.parser, 'parse_batch') else True)
        if needs_serial:
            # quirk leak or malformed data (or the Python parser): finish
            # with the always-exact serial coefficient path
            for p in self._decode_available_serial(eof):
                if release:
                    self._render(p)
                    outs.count_only(1)
                else:
                    outs.append(p)
        if not len(outs):
            return None
        if self.destination is not None and not release:
            for p in outs:
                self._render(p)
        return outs

    def _render(self, p: Planes) -> None:
        p = _to_host(p)
        self.destination.render(p.y, p.cr, p.cb)

    def _quant_matrices(self, seq):
        """Quant matrices of `seq` as device tensors, cached per
        sequence."""
        key = (seq.intra_quant_matrix.tobytes(),
               seq.non_intra_quant_matrix.tobytes())
        if self._quant_key != key:
            self._quant_key = key
            self._quant_dev = tuple(
                torch.as_tensor(np.asarray(q, np.int32), device=self.device)
                for q in (seq.intra_quant_matrix,
                          seq.non_intra_quant_matrix))
        return self._quant_dev

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        return upload(a, self.device)

    def _upload_meta(self, batch: dict, levels: torch.Tensor) -> LevelsArrays:
        """`levels` with the parser's per-MB metadata slabs, cut to the
        batch's real frames."""
        up = lambda a: self._upload(a[:batch['n']])
        return LevelsArrays(
            levels=levels, qscale=up(batch['qscale']),
            coded=up(batch['coded']).bool(), intra=up(batch['intra']).bool(),
            written=up(batch['written']).bool(),
            mv_h=up(batch['mv'][..., 0]), mv_v=up(batch['mv'][..., 1]))

    def _upload_dense(self, batch: dict) -> LevelsArrays:
        """The dense-levels fallback wire (coefficient-dense batches):
        the parser's full slabs, cut to the batch's real frames."""
        return self._upload_meta(
            batch, self._upload(batch['levels'][:batch['n']]))

    def _upload_sparse(self, batch: dict, n_mb: int) -> LevelsArrays:
        """The sparse wire (parse_batch(packed=False)): the dense
        metadata, and the (global index, value) pairs scattered into the
        levels lattice on the device."""
        return self._upload_meta(batch, sparse_to_levels(
            self._upload(batch['sp_idx']), self._upload(batch['sp_val']),
            batch['n'], n_mb))

    def _stage_batch(self, batch: dict, seq):
        """The host half of one parsed batch of sequence `seq`: the
        packed wire built into pinned memory and uploaded (a
        StagedWire), or a sparse or dense batch's slabs uploaded into
        levels."""
        n_mb = seq.mb_size
        if 'sp_pos' in batch:
            return stage_packed(batch, n_mb, self._upload, self._host_empty)
        if 'sp_idx' in batch:
            return self._upload_sparse(batch, n_mb)
        return self._upload_dense(batch)

    def _dispatch_batch(self, staged, seq) -> PlanesBatch:
        """The device half: a staged wire's unpack, then K1 and K2 from
        the decoder's carry, which they advance; the kernels run
        asynchronously."""
        la = unpack_staged(staged) if isinstance(staged, StagedWire) \
            else staged
        iq, nq = self._quant_matrices(seq)
        self._cur, self._fwd, outs = decode_levels(self._cur, self._fwd, la,
                                                   iq, nq)
        return outs

    def _decode_batch(self, batch: dict) -> PlanesBatch:
        """Upload one parsed batch (packed, sparse or dense wire) and
        decode it, on the calling thread; the kernels run
        asynchronously."""
        seq = self.parser.seq
        return self._dispatch_batch(self._stage_batch(batch, seq), seq)

    def _decode_serial(self, frames: List[FrameArrays]) -> PlanesBatch:
        st = stack_frames(frames)
        f = FrameArrays(*[self._upload(x) for x in st])
        self._cur, self._fwd, outs = decode_coef(self._cur, self._fwd, f)
        return outs

    def _feed(self, batch: dict, seq, stream, release: bool,
              prev) -> Optional[PlanesBatch]:
        """The feeder thread's work for one batch, on the caller's stream:
        stage it, dispatch it and, when it will be rendered, queue its
        copy back.  Nothing is done after a failed batch (`prev`, the
        previous batch's future), whose error the caller meets first."""
        if prev is not None and prev.exception() is not None:
            return None
        with _on_stream(stream):
            pb = self._dispatch_batch(self._stage_batch(batch, seq), seq)
            if release:
                pb.queue_fetch()
        return pb

    def _decode_available_batch(self, eof: bool, outs_all: FrameSeq,
                                release: bool = False) -> bool:
        """Threaded C++ parse + packed-wire device pipeline, on two
        threads (jsmpeg_tpu's four-way overlap, re-cut for the card).
        Batch k is handed to a one-worker feeder, which builds its wire
        in pinned memory, uploads it and queues its unpack, K1 and K2 on
        the caller's stream, then (release) the copy of its frames into
        fresh pinned host tensors and an event.  Meanwhile the calling
        thread parses batch k+1 (the C++ parse releases the GIL; only
        this thread touches the parser), counts batch k's frames, and
        renders (release) or retains batch k-1 once the feeder is done
        with it and, rendering, its event has completed: rendering runs
        one batch behind dispatch.  A feeder error re-raises here, at
        its batch's turn, and nothing after it renders.  On a
        'fallback' batch the feeder is drained and the pending batch
        rendered before returning, so the serial path starts from the
        carry the feeder left.  The feeder is shut down before this
        returns or raises.  Returns needs_serial_fallback."""
        seq = self.parser.seq
        stream = (torch.cuda.current_stream(self.device)
                  if self.device.type == 'cuda' else None)
        pool = ThreadPoolExecutor(max_workers=1,
                                  thread_name_prefix='jsmpeg-feeder')
        pending = None
        try:
            batch = self.parser.parse_batch(self.BATCH_FRAMES, eof=eof)
            while isinstance(batch, dict):
                n = batch['n']
                fut = pool.submit(self._feed, batch, seq, stream, release,
                                  pending)
                batch = (self.parser.parse_batch(self.BATCH_FRAMES, eof=eof)
                         if n == self.BATCH_FRAMES else None)
                self._account(n)
                if pending is not None:
                    self._emit(pending.result(), outs_all, release)
                pending = fut
            if pending is not None:
                self._emit(pending.result(), outs_all, release)
            return batch == 'fallback'
        finally:
            pool.shutdown(wait=True, cancel_futures=True)

    def _account(self, n: int) -> None:
        """n more frames decoded: the count and the decoded time."""
        self.frames_decoded += n
        for _ in range(n):
            self.advance_decoded_time(1.0 / self.frame_rate)

    def _emit(self, pb: PlanesBatch, outs_all: FrameSeq,
              release: bool) -> None:
        """A decoded batch: rendered and released (one copy back per
        plane, queued by the feeder when it ran there) or retained."""
        if release:
            ys, crs, cbs = pb.fetch_all()
            for i in range(len(pb)):
                self.destination.render(ys[i], crs[i], cbs[i])
            outs_all.count_only(len(pb))
        else:
            outs_all.append_batch(pb)

    def _mesh_decoder(self, mesh):
        from ..parallel.packed import MeshPackedDecoder
        md = getattr(self, '_mesh_dec', None)
        if md is None or md.mesh is not mesh or md.seq is not self.parser.seq:
            self._mesh_dec = md = MeshPackedDecoder(mesh, self.parser.seq,
                                                    device=self.device)
        return md

    def _decode_available_mesh(self, mesh, eof: bool, release: bool):
        """decode_available over a mesh (jsmpeg_tpu's
        _decode_available_mesh): packed batches queue per frame and flush
        as closed GOPs through MeshPackedDecoder once every gop row has
        about BATCH_FRAMES frames.  A flush whose MV reach exceeds the
        tile halo, or that holds a GOP that is not closed, decodes
        off-mesh in batches; a coefficient-dense batch flushes the queue
        and decodes on the decoder's own device; a quirky stream finishes
        on the serial path.  The reference-plane carry threads through
        all of them."""
        from ..parallel.packed import (gops_all_closed, merge_packed_frames,
                                       split_packed_frames)
        if self.parser.seq is None:
            return None
        outs_all = FrameSeq()
        pending: list = []
        emit = lambda pb: self._emit(pb, outs_all, release)

        def flush():
            if not pending:
                return
            md = self._mesh_decoder(mesh)
            if not md.fits_mesh(pending) or not gops_all_closed(pending):
                # off-mesh, from the same carry: the MV reach exceeds the
                # tile halo, or a slice-gap frame makes a GOP depend on
                # pre-GOP plane content (parallel/packed.gop_closed)
                for a in range(0, len(pending), self.BATCH_FRAMES):
                    emit(self._decode_batch(merge_packed_frames(
                        pending[a:a + self.BATCH_FRAMES])))
                self._account(len(pending))
                pending.clear()
                return
            # a leading I picture overwrites every pixel, so the carry
            # only matters for a mid-GOP continuation
            init = (None if pending[0]['pic_type'] == 1
                    else (self._cur, self._fwd))
            outs, _, carry = md.decode(pending, init=init)
            self._cur, self._fwd = carry
            self._account(len(pending))
            pending.clear()
            for p in outs:
                emit(PlanesBatch(p))

        # bounded memory for arbitrarily long files: a flush once every
        # gop row has BATCH_FRAMES frames queued
        flush_limit = self.BATCH_FRAMES * mesh.shape['gop']
        needs_serial = False
        while True:
            batch = self.parser.parse_batch(self.BATCH_FRAMES, eof=eof)
            if batch == 'fallback':
                needs_serial = True
                break
            if batch is None:
                break
            if 'sp_pos' not in batch:
                flush()
                n = batch['n']
                pb = self._decode_batch(batch)
                self._account(n)
                emit(pb)
                if n < self.BATCH_FRAMES:
                    break
                continue
            pending.extend(split_packed_frames(batch))
            if len(pending) >= flush_limit:
                flush()
            if batch['n'] < self.BATCH_FRAMES:
                break
        flush()
        if needs_serial:
            for p in self._decode_available_serial(eof):
                if release:
                    self._render(p)
                    outs_all.count_only(1)
                else:
                    outs_all.append(p)
        if not len(outs_all):
            return None
        if self.destination is not None and not release:
            for p in outs_all:
                self._render(p)
        return outs_all

    def _decode_available_serial(self, eof: bool = False):
        frames = []
        while True:
            fd = self.parser.parse_frame(eof=eof)
            if fd is None:
                break
            frames.append(frame_to_arrays(fd))
            self.frames_decoded += 1
            self.advance_decoded_time(1.0 / self.frame_rate)
        return self._decode_serial(frames) if frames else []

"""The tile axis: macroblock-row bands of one picture on distinct devices
(the port of jsmpeg_tpu/parallel/tiles.py).

P-picture motion compensation reads the previous reference frame up to
+/- (forward_f << 4) half-pels away, so a macroblock-row band of a
picture needs that many rows of its neighbours' reference planes: the
halo.  The halo sizing helpers are copies of jsmpeg_tpu's, so the port
decides on/off mesh exactly as jsmpeg_tpu does (parallel/packed.py
fits_mesh).

`decode_bands` is the banded frame loop (jsmpeg_tpu's `_tiled_step`
scanned under `shard_map`, tiles.py:344-426, and packed.py:202-242):
  - band t of n_band holds macroblock rows [t * mb_h_local, (t + 1) *
    mb_h_local) of the padded picture (mb_h_local = ceil(mb_h / n_band))
    for every GOP, the GOPs stacked along rows as K2 segments;
  - each device runs K1 once over all its bands' blocks (the IDCT has no
    frame dependency);
  - then, per frame step, ONE K2 band-mode launch per band (kernels.Band):
    the band's own rows of the previous frame, the rows above and below
    it from halo buffers, motion clamped at the picture's real rows in
    global rows (so the result equals the serial decode; jsmpeg_tpu
    clamps at its padded height and does not);
  - after each step `exchange_halo` copies each band's boundary rows
    device to device into its neighbours' halo buffers (jsmpeg_tpu's
    `ppermute`, `_exchange_halo` :70), ordered by CUDA events.
The loop takes an explicit list of band devices; a device may repeat
(every band is its own K2 launch), so three or four bands run on one
card or on the CPU.  Which cells merge is the mesh's business
(parallel/mesh.py, parallel/packed.py).

Entry points: `decode_tiled` (the serial path's FrameData, K1 in its
IDCT-only mode) and `decode_tiled_levels` (the dense-levels wire) over a
parallel.mesh.Mesh, each gop row's GOPs through its row's bands.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import resolve_device
from ..models.mpeg1 import (coef_blocks, frame_to_arrays, levels_blocks,
                            upload)
from ..ops.frame import FrameArrays, LevelsArrays, Planes, mc_combine
from ..ops.kernels import Band
from .gop import split_at_iframes


def halo_mb_rows(f_code: int) -> int:
    """MB rows of halo needed for a given forward_f_code: max MV reach is
    (1 << (f_code-1)) << 4 half-pels => `reach/2 (+1 for the half-pel tap)`
    pixels."""
    reach_px = ((1 << (f_code - 1)) << 4) // 2 + 1
    return -(-reach_px // 16)


def halo_mb_for_mvs(max_abs_mv: int) -> int:
    """MB rows of halo covering a batch's largest |MV| (half-pel units,
    post full-pel doubling, either axis: MPEG1 has one forward_f for
    both and a banded MC bounds columns with the same halo), rounded up
    to a power of two as jsmpeg_tpu does."""
    reach_px = ((max_abs_mv + 1) >> 1) + 1
    need = -(-reach_px // 16)
    b = 1
    while b < need:
        b <<= 1
    return b


def batch_max_abs_mv(frames) -> int:
    """max |mv component| over per-frame packed dicts / FrameData /
    LevelsArrays-style dicts (0 when no MVs)."""
    m = 0
    for f in frames:
        mv = f['run_mv'] if isinstance(f, dict) and 'run_mv' in f else \
            f['mv'] if isinstance(f, dict) else f.mv
        if mv is not None and mv.size:
            m = max(m, int(np.abs(mv).max()))
    return m


# ------------------------------------------------------ the banded loop

def _zeros(rows: int, w: int, device) -> Planes:
    z = lambda h, ww: torch.zeros((h, ww), dtype=torch.uint8, device=device)
    return Planes(z(rows, w), z(rows // 2, w // 2), z(rows // 2, w // 2))


def _send(src: torch.Tensor, dst: torch.Tensor, n_seg: int,
          last: bool) -> None:
    """Copy each segment's first (or last) rows of a band plane into a
    halo buffer [n_seg * rows, W] on the receiving device: device to
    device, ordered by events on the two devices' current streams (the
    receiver is done reading the buffer; the receiver waits for the
    copy)."""
    rows = dst.shape[0] // n_seg
    s = src.view(n_seg, -1, src.shape[1])
    s = s[:, -rows:] if last else s[:, :rows]
    d = dst.view(n_seg, rows, dst.shape[1])
    if src.device.type != 'cuda' or dst.device.type != 'cuda':
        d.copy_(s)
        return
    to = torch.cuda.current_stream(dst.device)
    frm = torch.cuda.current_stream(src.device)
    free = torch.cuda.Event()
    free.record(to)
    frm.wait_event(free)
    d.copy_(s, non_blocking=True)
    done = torch.cuda.Event()
    done.record(frm)
    to.wait_event(done)


def exchange_halo(fwd: Sequence[Planes], top: Sequence[Planes],
                  bot: Sequence[Planes], n_seg: int) -> None:
    """After a frame step: each band's last halo rows go to the top halo
    of the band below it, and its first halo rows to the bottom halo of
    the band above it, per plane (luma 16 * halo_mb rows, chroma 8 *
    halo_mb) and per segment.  The picture's top and bottom halos stay
    zero; the clamp at the real rows never reads them."""
    for t in range(len(fwd) - 1):
        for p in range(3):
            _send(fwd[t][p], top[t + 1][p], n_seg, last=True)
            _send(fwd[t + 1][p], bot[t][p], n_seg, last=False)


def _seed(init: Optional[Planes], t: int, rows: int, n_seg: int, w: int,
          device) -> Planes:
    """Band t's rows of zero planes for n_seg segments, segment 0 holding
    band t's rows of the full-picture `init` (a mid-GOP carry)."""
    z = _zeros(n_seg * rows, w, device)
    if init is not None:
        for p, (dst, src) in enumerate(zip(z, init)):
            r = rows >> (p > 0)
            part = src[t * r:(t + 1) * r]
            dst[:part.shape[0]] = part.to(device)
    return z


def decode_bands(band_devices: Sequence, counts: List[int], mb_h: int,
                 mb_w: int, halo_mb: int, blocks_of: Callable,
                 init: Optional[Tuple[Planes, Planes]] = None):
    """Decode len(counts) GOPs (GOP g of counts[g] frames) as
    n_band = len(band_devices) macroblock-row bands, band t on
    band_devices[t].  One band (a row whose tile cells share a device)
    needs no halo: its frame loop is ONE segmented K2 launch.

    blocks_of(device, bands) -> (resid int32 [F, n, 6, 64], meta int32
    [F, n, 3]) on `device`: K1 over the blocks of the listed bands of
    every GOP (n = len(bands) * len(counts) * mb_h_local * mb_w, band
    major, F = max(counts), zero macroblocks past a GOP's end or the
    picture's last row).  It is called once per distinct device object
    ('cuda' and 'cuda:0' are two).
    init: the (cur, fwd) full-picture carry GOP 0 continues from (a
    mid-GOP flush), or None for zero planes.

    Returns ([Planes of [counts[g], 16 * mb_h, 16 * mb_w] per GOP],
    (cur, fwd) of the last GOP), joined on band_devices[0]."""
    devs = [resolve_device(d, 'decode_bands') for d in band_devices]
    n_band, S, F = len(devs), len(counts), max(counts)
    local = -(-mb_h // n_band)
    if n_band > 1 and halo_mb > local:
        raise ValueError(f'MV reach needs {halo_mb} MB rows of halo > '
                         f'{local} rows per tile')
    device = devs[0]
    W, rows = mb_w * 16, local * 16
    n = S * local * mb_w
    groups: dict = {}
    for t, d in enumerate(devs):
        groups.setdefault(d, []).append(t)
    resid, meta = [None] * n_band, [None] * n_band
    for d, ts in groups.items():          # K1: once per device
        r, m = blocks_of(d, ts)
        for i, t in enumerate(ts):
            resid[t], meta[t] = r[:, i * n:(i + 1) * n], m[:, i * n:(i + 1) * n]
    cur = [_seed(init and init[0], t, rows, S, W, d)
           for t, d in enumerate(devs)]
    fwd = [_seed(init and init[1], t, rows, S, W, d)
           for t, d in enumerate(devs)]
    if n_band == 1:                        # K2: the whole loop, one launch
        outs = [mc_combine(cur[0], fwd[0], resid[0], meta[0], S, counts)]
    else:
        outs = _band_loop(cur, fwd, resid, meta, counts, devs, local, mb_h,
                          halo_mb)
    # each GOP's frames: its rows of every band, joined on `device`
    stacked = [[outs[t][p].view(F, S, rows >> (p > 0), W >> (p > 0))
                for p in range(3)] for t in range(n_band)]
    result = []
    for g, c in enumerate(counts):
        result.append(Planes(*[torch.cat(
            [stacked[t][p][:c, g].to(device) for t in range(n_band)],
            dim=1)[:, :(mb_h * 16) >> (p > 0)] for p in range(3)]))
    last = result[-1]
    if counts[-1] >= 2:
        c_cur = Planes(*[x[-2] for x in last])
    elif init is not None and S == 1:
        c_cur = Planes(*[x.to(device) for x in init[1]])
    else:
        c_cur = _zeros(mb_h * 16, W, device)
    return result, (c_cur, Planes(*[x[-1] for x in last]))


def _band_loop(cur: List[Planes], fwd: List[Planes], resid: list,
               meta: list, counts: List[int], devs: list, local: int,
               mb_h: int, halo_mb: int) -> List[Planes]:
    """decode_bands' frame loop over n_band > 1 bands: per frame step one
    K2 band launch per band, then the halo exchange.  Returns each band's
    frames, Planes of [F, n_seg * rows, W]."""
    S, F, W = len(counts), max(counts), cur[0].y.shape[1]
    top = [_zeros(S * halo_mb * 16, W, d) for d in devs]
    bot = [_zeros(S * halo_mb * 16, W, d) for d in devs]
    outs: list = [[] for _ in devs]
    exchange_halo(fwd, top, bot, S)
    for k in range(F):                     # K2: one launch per band a step
        new = [Planes(*[p[0] for p in mc_combine(
            cur[t], fwd[t], resid[t][k:k + 1], meta[t][k:k + 1], S, counts,
            Band(top[t], bot[t], t * local, mb_h, halo_mb, k))])
            for t in range(len(devs))]
        cur, fwd = fwd, new
        for t, o in enumerate(new):
            outs[t].append(o)
        if k + 1 < F:
            exchange_halo(fwd, top, bot, S)
    return [Planes(*[torch.stack([o[p] for o in band]) for p in range(3)])
            for band in outs]


# ------------------------------------------------- host cells of a wire

def stack_cells(gops: List[list], bands: Sequence[int], n_band: int,
                mb_h: int, mb_w: int, fields: List[Callable]) -> list:
    """Per-MB host arrays of the cells (band t, GOP g), band major: for
    each `fields` entry (frame -> numpy [n_mb, ...]) an array
    [F, len(bands) * len(gops) * mb_h_local * mb_w, ...], joint frame k
    holding every cell's rows of its GOP's frame k (zeros past a GOP's
    end and past the picture's last row)."""
    local = -(-mb_h // n_band)
    mpt, n_mb = local * mb_w, mb_h * mb_w
    F = max(len(g) for g in gops)
    out = []
    for get in fields:
        proto = get(gops[0][0])
        arr = np.zeros((F, len(bands), len(gops), mpt) + proto.shape[1:],
                       proto.dtype)
        for i, t in enumerate(bands):
            a, b = min(t * mpt, n_mb), min((t + 1) * mpt, n_mb)
            for j, g in enumerate(gops):
                for k, fr in enumerate(g):
                    arr[k, i, j, :b - a] = get(fr)[a:b]
        out.append(arr.reshape((F, -1) + proto.shape[1:]))
    return out


def _decode_mesh_rows(gops: List[list], mesh, mb_h: int, mb_w: int,
                      halo_mb: int, blocks_for: Callable) -> List[Planes]:
    """GOPs over the mesh's gop rows (jsmpeg_tpu's padding and sharding:
    parallel/mesh.Mesh.gop_groups), each row layout's GOPs through
    decode_bands over its bands (one band, one K2 launch, when the row's
    tile cells share a device).  blocks_for(gops, n_band) -> blocks_of.  Returns
    per-frame Planes in input order, cropped to the picture."""
    outs: list = [None] * len(gops)
    for bands, idx in mesh.gop_groups(len(gops)).items():
        local = [gops[i] for i in idx]
        planes, _ = decode_bands(bands, [len(g) for g in local], mb_h, mb_w,
                                 halo_mb, blocks_for(local, len(bands)))
        for i, p in zip(idx, planes):
            outs[i] = p
    return [Planes(*[x[fi] for x in p]) for p in outs
            for fi in range(p.y.shape[0])]


def _check_tiling(gops: List[list], frames, mb_h: int, mesh,
                  f_code: int) -> int:
    """jsmpeg_tpu's refusals: a GOP that is not closed, and a halo (the
    declared f_code's floor raised to the data's MV reach) over the rows
    of one tile.  Returns the halo in MB rows."""
    from .packed import gop_closed
    for gop in gops:
        if not gop_closed(gop):
            raise ValueError('GOP not closed (slice-gap frame exposes '
                             'pre-GOP plane content); decode off-mesh')
    n_tile = mesh.shape['tile']
    local = -(-mb_h // n_tile)
    halo = max(halo_mb_rows(f_code),
               halo_mb_for_mvs(batch_max_abs_mv(frames)))
    if halo > local:
        raise ValueError(f'MV reach needs {halo} MB rows of halo > '
                         f'{local} rows per tile; use fewer tiles')
    return halo


def decode_tiled(frames, mb_h: int, mb_w: int, mesh,
                 f_code: int = 2) -> List[Planes]:
    """Serially parsed frames (host FrameData: premultiplied coefficients)
    over the mesh: GOPs over its gop rows, each row's picture in bands
    over its tile cells; K1 in its IDCT-only mode.  Returns per-frame
    planes in input order (on each row's first device)."""
    gops = split_at_iframes(frames, lambda f: f.pic_type)
    halo = _check_tiling(gops, frames, mb_h, mesh, f_code)

    def blocks_for(local, n_band):
        arrays = [[frame_to_arrays(f) for f in g] for g in local]

        def blocks_of(dev, bands):
            cols = stack_cells(arrays, bands, n_band, mb_h, mb_w,
                               [lambda a, i=i: a[i]
                                for i in range(len(FrameArrays._fields))])
            return coef_blocks(FrameArrays(*[upload(x, dev) for x in cols]))
        return blocks_of

    return _decode_mesh_rows(gops, mesh, mb_h, mb_w, halo, blocks_for)


def parse_levels_frames(es_or_parser, eof: bool = True):
    """Parse a stream into per-frame dense-levels dicts with the native
    batch parser.  Returns (seq, [frame dicts]); raises when the stream
    needs the serial-exact path."""
    from ..host import best_parser
    if isinstance(es_or_parser, (bytes, bytearray, memoryview)):
        parser = best_parser()
        parser.write(bytes(es_or_parser))
    else:
        parser = es_or_parser
    if not hasattr(parser, 'parse_batch'):
        raise RuntimeError('stream needs the serial-exact path; '
                           'use decode_tiled (FrameData) instead')
    frames = []
    while True:
        b = parser.parse_batch(32, eof=eof, sparse=False, packed=False)
        if b == 'fallback':
            raise RuntimeError('stream needs the serial-exact path; '
                               'use decode_tiled (FrameData) instead')
        if b is None:
            break
        for i in range(b['n']):
            frames.append(dict(
                levels=b['levels'][i], qscale=b['qscale'][i],
                coded=b['coded'][i], intra=b['intra'][i],
                written=b['written'][i], mv=b['mv'][i],
                pic_type=int(b['pic_types'][i])))
        if b['n'] < 32:
            break
    return parser.seq, frames


# a dense-levels frame dict -> the LevelsArrays fields, per macroblock
_LEVEL_FIELDS = [lambda f: f['levels'], lambda f: f['qscale'],
                 lambda f: f['coded'].astype(bool),
                 lambda f: f['intra'].astype(bool),
                 lambda f: f['written'].astype(bool),
                 lambda f: f['mv'][:, 0].astype(np.int32),
                 lambda f: f['mv'][:, 1].astype(np.int32)]


def decode_tiled_levels(es: bytes, mesh, f_code: int = 2) -> List[Planes]:
    """The dense-levels wire over the mesh: parse (C++ batch), GOPs over
    the gop rows, bands over the tile cells, dequantised on the devices
    (K1).  Returns per-frame planes in input order."""
    seq, frames = parse_levels_frames(es)
    if not frames:
        return []
    mb_h, mb_w = seq.mb_height, seq.mb_width
    gops = split_at_iframes(frames, lambda f: f['pic_type'])
    halo = _check_tiling(gops, frames, mb_h, mesh, f_code)
    quant = {}

    def blocks_for(local, n_band):
        def blocks_of(dev, bands):
            if dev not in quant:
                quant[dev] = tuple(
                    torch.as_tensor(np.asarray(q, np.int32), device=dev)
                    for q in (seq.intra_quant_matrix,
                              seq.non_intra_quant_matrix))
            cols = stack_cells(local, bands, n_band, mb_h, mb_w,
                               _LEVEL_FIELDS)
            return levels_blocks(LevelsArrays(*[upload(x, dev)
                                                for x in cols]), *quant[dev])
        return blocks_of

    return _decode_mesh_rows(gops, mesh, mb_h, mb_w, halo, blocks_for)

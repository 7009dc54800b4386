"""Build, bind and launch the hand-written CUDA kernels.

Sources live in `jsmpeg_tpu_torch/csrc/*.cu` with a plain C interface.
At first CUDA use each source compiles with its own `nvcc` process (all
started together) for `sm_90a`, and the objects link into
`build/jsmpeg_tpu_torch/libjsmpeg_kernels.so` at the checkout root,
loaded with ctypes.  The build reruns when a source is newer than the
library; a missing `nvcc` or a failed build raises.

Each launcher checks device, dtype, shape and contiguity, allocates its
outputs with `torch.empty`, launches on the current stream, raises on a
non-zero `cudaGetLastError()`, and adds one to its entry in `launches`.
There is no fallback: the plain versions run only on CPU tensors, in the
callers (ops/idct.py, ops/frame.py, models/mpeg1.py).

  python -m jsmpeg_tpu_torch.ops.kernels      # build and print the path
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import os
import shutil
import subprocess
import tempfile
from typing import NamedTuple

import torch

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(PKG, 'csrc')
SOURCES = [os.path.join(CSRC, n)
           for n in ('dequant_idct.cu', 'mc_combine.cu', 'wire_unpack.cu')]
BUILD_DIR = os.path.join(os.path.dirname(PKG), 'build', 'jsmpeg_tpu_torch')
SO_PATH = os.path.join(BUILD_DIR, 'libjsmpeg_kernels.so')
LOG_PATH = os.path.join(BUILD_DIR, 'kernels_build.log')
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-O3',
              '-std=c++17', '-Xcompiler', '-fPIC']
NVCC_DEFAULT = '/usr/local/cuda/bin/nvcc'   # the toolkit's default prefix

# kernel launches since the last reset_launches(), by kernel name
launches = {'dequant_idct': 0, 'mc_combine': 0, 'wire_unpack': 0}

_lib = None


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def nvcc_path() -> str:
    home = os.environ.get('CUDA_HOME') or os.environ.get('CUDA_PATH')
    for cand in ((os.path.join(home, 'bin', 'nvcc') if home else None),
                 shutil.which('nvcc'), NVCC_DEFAULT):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError('nvcc not found (set CUDA_HOME): the CUDA kernels '
                       'of jsmpeg_tpu_torch cannot be built')


def _fresh() -> bool:
    if not os.path.exists(SO_PATH):
        return False
    m = os.path.getmtime(SO_PATH)
    return all(os.path.getmtime(s) <= m for s in SOURCES)


def build() -> str:
    """Compile every source in parallel (one nvcc each, `-Xptxas -v`
    resource report kept in kernels_build.log), link, and move the
    library into place."""
    nvcc = nvcc_path()
    os.makedirs(BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in SOURCES:
            obj = os.path.join(
                tmp, os.path.splitext(os.path.basename(src))[0] + '.o')
            objs.append(obj)
            procs.append(subprocess.Popen(
                [nvcc] + NVCC_FLAGS + ['-Xptxas', '-v', '-c', src,
                                       '-o', obj],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        logs = [p.communicate()[0] for p in procs]
        with open(LOG_PATH, 'w') as f:
            f.write('\n'.join(logs))
        for src, p, log in zip(SOURCES, procs, logs):
            if p.returncode != 0:
                raise RuntimeError(f'nvcc failed on {src}:\n{log}')
        out = os.path.join(tmp, 'libjsmpeg_kernels.so')
        subprocess.run([nvcc] + NVCC_FLAGS[:2] + ['-shared', '-o', out]
                       + objs, check=True)
        os.replace(out, SO_PATH)
    return SO_PATH


def ensure_built() -> str:
    if _fresh():
        return SO_PATH
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, 'kernels.lock'), 'w') as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not _fresh():
            build()
    return SO_PATH


def lib():
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        so = ctypes.CDLL(ensure_built())
        P, I = ctypes.c_void_p, ctypes.c_int
        so.jt_dequant_idct.argtypes = [P, P, P, P, P, P, I, I, P]
        so.jt_dequant_idct.restype = I
        so.jt_mc_combine.argtypes = [P] * 13 + [I, I, I, I, P]
        so.jt_mc_combine.restype = I
        so.jt_mc_combine_grid.argtypes = [I]
        so.jt_mc_combine_grid.restype = I
        so.jt_mc_combine_flag_words.argtypes = [I, I]
        so.jt_mc_combine_flag_words.restype = ctypes.c_longlong
        so.jt_mc_combine_band.argtypes = [P] * 18 + [I] * 7 + [P]
        so.jt_mc_combine_band.restype = I
        so.jt_wire_unpack_launches.argtypes = []
        so.jt_wire_unpack_launches.restype = I
        so.jt_wire_unpack.argtypes = ([P, ctypes.c_longlong] + [I] * 8
                                      + [P, ctypes.c_longlong] + [P] * 8)
        so.jt_wire_unpack.restype = I
        _lib = so
    return _lib


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple,
           device: torch.device) -> int:
    """Validate one kernel argument; returns its data pointer."""
    if t.device != device:
        raise ValueError(f'{name} is on {t.device}, expected {device}')
    if t.dtype != dtype:
        raise TypeError(f'{name} must be {dtype}, got {t.dtype}')
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f'{name} must have shape {tuple(shape)}, '
                         f'got {tuple(t.shape)}')
    if not t.is_contiguous():
        raise ValueError(f'{name} must be contiguous')
    return t.data_ptr()


def _raise_on(rc: int, kernel: str) -> None:
    if rc != 0:
        raise RuntimeError(f'{kernel} kernel launch failed: CUDA error {rc}')


def dequant_idct_cuda(x, qscale=None, intra=None, intra_q=None,
                      non_intra_q=None,
                      premultiplied: bool = False) -> torch.Tensor:
    """K1 (csrc/dequant_idct.cu) on int16 levels, or on int32
    premultiplied coefficients when `premultiplied`; see
    ops.idct.dequant_idct for the contract."""
    dev = x.device
    if dev.type != 'cuda':
        raise ValueError(f'dequant_idct_cuda needs a CUDA tensor, got {dev}')
    if x.dim() != 3:
        raise ValueError(f'expected [n_mb, 6, 64], got {tuple(x.shape)}')
    n_mb = x.shape[0]
    if premultiplied:
        xp = _check(x, 'coef', torch.int32, (n_mb, 6, 64), dev)
        qp = ip = iqp = nqp = None
    else:
        xp = _check(x, 'levels', torch.int16, (n_mb, 6, 64), dev)
        qp = _check(qscale, 'qscale', torch.uint8, (n_mb,), dev)
        ip = _check(intra, 'intra', torch.bool, (n_mb,), dev)
        iqp = _check(intra_q, 'intra_q', torch.int32, (64,), dev)
        nqp = _check(non_intra_q, 'non_intra_q', torch.int32, (64,), dev)
    out = torch.empty((n_mb, 6, 64), dtype=torch.int32, device=dev)
    if n_mb == 0:
        return out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib().jt_dequant_idct(xp, qp, ip, iqp, nqp, out.data_ptr(),
                                   n_mb * 6, int(premultiplied), stream)
    _raise_on(rc, 'dequant_idct')
    launches['dequant_idct'] += 1
    return out


def check_segments(mb_h: int, n_frames: int, n_seg: int,
                   seg_frames=None) -> list:
    """The frame count of each of `n_seg` segments stacked along the
    macroblock rows of a batch of `n_frames` frames: `seg_frames` (ints,
    each in [0, n_frames]) or, when None, n_frames for every segment.
    Raises ValueError when the rows do not split evenly or a count is
    out of range."""
    if n_seg < 1 or mb_h % n_seg:
        raise ValueError(f'{mb_h} macroblock rows do not split into '
                         f'{n_seg} segments')
    if seg_frames is None:
        return [n_frames] * n_seg
    counts = [int(c) for c in seg_frames]
    if len(counts) != n_seg or not all(0 <= c <= n_frames for c in counts):
        raise ValueError(f'seg_frames {counts} must hold {n_seg} counts in '
                         f'[0, {n_frames}]')
    return counts


class Band(NamedTuple):
    """K2's band mode: a launch decodes ONE frame of the macroblock rows
    [row0, row0 + mb_h_local) of a picture of mb_h real rows, for each of
    its n_seg segments (the launch's planes hold the segments' bands
    stacked).  top / bot: (y, cr, cb) uint8 halo rows above and below each
    segment's band, [n_seg * 16 * halo_mb, W] (chroma half).  frame: this
    frame's index, compared with seg_frames (each segment's frame
    count)."""
    top: tuple
    bot: tuple
    row0: int
    mb_h: int
    halo_mb: int
    frame: int


# a band launch's counts are its segments' GOP lengths (int32 on the card),
# compared with Band.frame: no frame count bounds them
BAND_COUNT_MAX = 2**31 - 1


def mc_combine_cuda(cur, fwd, resid: torch.Tensor, meta: torch.Tensor,
                    n_seg: int = 1, seg_frames=None, band: Band = None):
    """K2 (csrc/mc_combine.cu): the frame loop of one batch in one
    cooperative launch, each macroblock waiting on per-row readiness
    flags for the rows of earlier frames that it reads.  cur/fwd: the
    carried (y, cr, cb) uint8 planes; resid int32 [F, n_mb, 6, 64]; meta
    int32 [F, n_mb, 3].  With n_seg > 1 the planes are n_seg streams
    stacked along macroblock rows: motion clamps rows at each segment's
    edges, and segment s decodes its first seg_frames[s] frames only (see
    ops.frame.decode_frames_ref).  Returns the F new pictures as
    (y [F, H, W], cr, cb [F, H/2, W/2]).  Shapes and segments are checked
    before the device, so a mismatch raises on any device.  With `band`
    the launch runs K2's band mode (`Band`): F = 1, the planes are the
    segments' bands, segment s decodes when band.frame < seg_frames[s]."""
    dev = cur[0].device
    H, W = cur[0].shape
    if H % 16 or W % 16:
        raise ValueError(f'plane {H}x{W} is not macroblock-aligned')
    # the kernel's in-plane offsets are int
    if H * W >= 2**31:
        raise ValueError(f'plane {H}x{W} is over 2^31 bytes')
    if resid.dim() != 4:
        raise ValueError(f'resid must be [F, n_mb, 6, 64], got '
                         f'{tuple(resid.shape)}')
    F = resid.shape[0]
    mb_h, mb_w = H // 16, W // 16
    n_mb = mb_h * mb_w
    shapes = ((H, W), (H // 2, W // 2), (H // 2, W // 2))
    named = [('cur', cur, shapes), ('fwd', fwd, shapes)]
    if band is None:
        counts = check_segments(mb_h, F, n_seg, seg_frames)
        idle = all(c == F for c in counts)
    else:
        if F != 1:
            raise ValueError(f'a band launch is one frame: resid must be '
                             f'[1, n_mb, 6, 64], got {tuple(resid.shape)}')
        counts = check_segments(mb_h, BAND_COUNT_MAX, n_seg, seg_frames)
        if not 0 <= band.halo_mb <= mb_h // n_seg:
            raise ValueError(f'{mb_h} band rows in {n_seg} segments with a '
                             f'halo of {band.halo_mb} rows')
        if band.row0 < 0 or band.mb_h < 1:
            raise ValueError(f'band at row {band.row0} of {band.mb_h}')
        hy = n_seg * band.halo_mb * 16
        halos = ((hy, W), (hy // 2, W // 2), (hy // 2, W // 2))
        named += [('top', band.top, halos), ('bot', band.bot, halos)]
        idle = all(band.frame < c for c in counts)
    planes = []
    for name, ps, shp in named:
        for pn, p, shape in zip(('y', 'cr', 'cb'), ps, shp):
            planes.append(_check(p, f'{name}.{pn}', torch.uint8, shape, dev))
    rp = _check(resid, 'resid', torch.int32, (F, n_mb, 6, 64), dev)
    mp = _check(meta, 'meta', torch.int32, (F, n_mb, 3), dev)
    if dev.type != 'cuda':
        raise ValueError(f'mc_combine_cuda needs CUDA tensors, got {dev}')
    # the kernel reads plane rows and residuals 16 bytes at a time
    if any(q % 16 for q in planes) or rp % 16:
        raise ValueError('mc_combine_cuda needs 16-byte aligned planes and '
                         'residuals')
    out = tuple(torch.empty((F,) + s, dtype=torch.uint8, device=dev)
                for s in shapes)
    if F == 0:
        return out
    # no counts on the device when every segment decodes every frame of
    # the launch: the kernel then skips the test
    seg = (None if idle else
           torch.tensor(counts, dtype=torch.int32).pin_memory().to(
               dev, non_blocking=True))
    seg_ptr = None if seg is None else seg.data_ptr()
    outs = [o.data_ptr() for o in out]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if band is None:
            # the readiness flags: stored macroblocks per (frame, row)
            done = torch.zeros(lib().jt_mc_combine_flag_words(F, mb_h),
                               dtype=torch.int32, device=dev)
            rc = lib().jt_mc_combine(*planes, rp, mp, *outs,
                                     done.data_ptr(), seg_ptr, F, mb_h,
                                     mb_w, n_seg, stream)
        else:
            rc = lib().jt_mc_combine_band(
                *planes, rp, mp, *outs, seg_ptr, mb_h // n_seg, mb_w, n_seg,
                band.row0, band.mb_h, band.halo_mb, band.frame, stream)
    _raise_on(rc, 'mc_combine')
    launches['mc_combine'] += 1
    return out


def wire_unpack_scratch_bytes(n_streams: int, n_frames: int, n_mb: int,
                              n_pairs: int, n_blk: int) -> int:
    """The scratch of one K3 call: csrc/wire_unpack.cu's scratch_rule (8
    bytes a macroblock, pair and ordinal of each stream, 16 KB a stream and
    1 KB), which covers the kernel's layout; the kernel carves it and
    refuses a smaller one."""
    return 8 * n_streams * (n_frames * n_mb + n_pairs + n_blk + 2048) + 1024


def wire_unpack_cuda(bufs: torch.Tensor, n_frames: int, n_mb: int,
                     n_runs: int, mv_wide: bool, n_pairs: int, n_esc: int,
                     n_blk: int) -> tuple:
    """K3 (csrc/wire_unpack.cu): S packed wires v2 at shared sizes,
    uint8 [S, L], unpacked into the levels of the S streams joined along
    macroblocks, stream s in columns [s*n_mb, (s+1)*n_mb).  Returns the
    LevelsArrays fields in order: levels int16 [F, S*n_mb, 6, 64], qscale
    uint8 [F, S*n_mb], coded bool [F, S*n_mb, 6], intra, written bool,
    mv_h, mv_v int32; see models.mpeg1.unpack_wires for the contract.
    One ctypes call queues a memset of the scan's status words and the
    two launches.  Sizes and shapes are checked before the device, so a
    mismatch raises on any device."""
    # the wire layout and the lattice limit are models.mpeg1's (which
    # imports this module)
    from ..models.mpeg1 import LATTICE_LIMIT, fused_buffer_len
    dev = bufs.device
    if bufs.dim() != 2:
        raise ValueError(f'expected wires [S, L], got {tuple(bufs.shape)}')
    S = bufs.shape[0]
    sizes = (n_frames, n_mb, n_runs, n_pairs, n_esc, n_blk)
    if S < 1 or S > 65535 or min(sizes) < 1:
        raise ValueError(f'wire_unpack_cuda needs 1 <= S <= 65535 and '
                         f'every size >= 1, got S={S}, sizes {sizes}')
    # the kernel counts levels, pairs, escapes and runs in int32 (a pair
    # index runs up to a tile past n_pairs)
    if n_frames * S * n_mb * 6 * 64 > LATTICE_LIMIT or \
            max(n_pairs, n_esc, n_runs) > 2**30:
        raise ValueError(f'wire_unpack_cuda: {S} wires of {n_frames} x '
                         f'{n_mb} macroblocks, {n_pairs} pairs are over '
                         f'its int32 counts')
    L = fused_buffer_len(n_frames, n_mb, n_pairs, n_runs, mv_wide, n_esc)
    bp = _check(bufs, 'bufs', torch.uint8, (S, L), dev)
    if dev.type != 'cuda':
        raise ValueError(f'wire_unpack_cuda needs a CUDA tensor, got {dev}')
    F, M = n_frames, S * n_mb
    out = (torch.empty((F, M, 6, 64), dtype=torch.int16, device=dev),
           torch.empty((F, M), dtype=torch.uint8, device=dev),
           torch.empty((F, M, 6), dtype=torch.bool, device=dev),
           torch.empty((F, M), dtype=torch.bool, device=dev),
           torch.empty((F, M), dtype=torch.bool, device=dev),
           torch.empty((F, M), dtype=torch.int32, device=dev),
           torch.empty((F, M), dtype=torch.int32, device=dev))
    n_scratch = wire_unpack_scratch_bytes(S, F, n_mb, n_pairs, n_blk)
    scratch = torch.empty(n_scratch, dtype=torch.uint8, device=dev)
    # launch on the tensors' device, entered only when it is not current
    ctx = (contextlib.nullcontext() if dev.index == torch.cuda.current_device()
           else torch.cuda.device(dev))
    with ctx:
        rc = lib().jt_wire_unpack(
            bp, L, S, F, n_mb, n_runs, int(mv_wide), n_pairs, n_esc, n_blk,
            scratch.data_ptr(), n_scratch, *[o.data_ptr() for o in out],
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, 'wire_unpack')
    launches['wire_unpack'] += 1
    return out


if __name__ == '__main__':
    print(ensure_built())

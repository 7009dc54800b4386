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
callers (ops/idct.py, ops/frame.py).

  python -m jsmpeg_tpu_torch.ops.kernels      # build and print the path
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import shutil
import subprocess
import tempfile

import torch

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(PKG, 'csrc')
SOURCES = [os.path.join(CSRC, n) for n in ('dequant_idct.cu', 'mc_combine.cu')]
BUILD_DIR = os.path.join(os.path.dirname(PKG), 'build', 'jsmpeg_tpu_torch')
SO_PATH = os.path.join(BUILD_DIR, 'libjsmpeg_kernels.so')
LOG_PATH = os.path.join(BUILD_DIR, 'kernels_build.log')
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-O3',
              '-std=c++17', '-Xcompiler', '-fPIC']
NVCC_DEFAULT = '/usr/local/cuda/bin/nvcc'   # the toolkit's default prefix

# kernel launches since the last reset_launches(), by kernel name
launches = {'dequant_idct': 0, 'mc_combine': 0}

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
        so.jt_mc_combine.argtypes = [P] * 11 + [I, I, P]
        so.jt_mc_combine.restype = I
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


def mc_combine_cuda(cur, fwd, resid: torch.Tensor, meta: torch.Tensor):
    """K2 (csrc/mc_combine.cu): one picture's half-pel MC + combine.
    cur/fwd: (y, cr, cb) uint8 planes; returns the new (y, cr, cb)."""
    dev = cur[0].device
    if dev.type != 'cuda':
        raise ValueError(f'mc_combine_cuda needs CUDA tensors, got {dev}')
    H, W = cur[0].shape
    if H % 16 or W % 16:
        raise ValueError(f'plane {H}x{W} is not macroblock-aligned')
    mb_h, mb_w = H // 16, W // 16
    n_mb = mb_h * mb_w
    ptrs = []
    for name, planes in (('cur', cur), ('fwd', fwd)):
        for pn, p, shape in zip(('y', 'cr', 'cb'), planes,
                                ((H, W), (H // 2, W // 2), (H // 2, W // 2))):
            ptrs.append(_check(p, f'{name}.{pn}', torch.uint8, shape, dev))
    ptrs.append(_check(resid, 'resid', torch.int32, (n_mb, 6, 64), dev))
    ptrs.append(_check(meta, 'meta', torch.int32, (n_mb, 3), dev))
    out = tuple(torch.empty_like(p) for p in cur)
    if n_mb == 0:
        return out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib().jt_mc_combine(*ptrs, *(o.data_ptr() for o in out),
                                 mb_h, mb_w, stream)
    _raise_on(rc, 'mc_combine')
    launches['mc_combine'] += 1
    return out


if __name__ == '__main__':
    print(ensure_built())

#!/usr/bin/env python3
"""Time variants of kernel K2 (jsmpeg_tpu_torch/csrc/mc_combine.cu) on one
GPU: CTA shapes and the grid barrier, on the same random 720p batch.

    python3 k2_sweep.py          # from the checkout root, beside chip_smoke.py

Each variant is the checked-in source with its CTA constants (threads,
minimum CTAs per SM, hence the register cap) replaced, and with the
hand-written barrier or cooperative_groups' grid.sync().  The variants
build in parallel into build/jsmpeg_tpu_torch/k2_sweep/, each is held to
decode_frames_ref, and each is timed twice, in forward then reverse
order: the batch, one frame alone, and the batch with all-zero metadata
(every frame a copy of the stale plane, then the barrier), with
chip_smoke.py's held-stream timer.  Prints one JSON line per timing and
the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys

import numpy as np
import torch

from chip_smoke import cuda_ms
from jsmpeg_tpu_torch.ops import kernels
from jsmpeg_tpu_torch.ops.frame import Planes, decode_frames_ref

SHAPES = ((128, 8), (256, 4), (512, 2), (1024, 1), (256, 2), (512, 1))
BARRIERS = ('hand', 'cg')
F, H, W = 32, 720, 1280


def variant_source(threads: int, min_ctas: int, barrier: str) -> str:
    src = open(os.path.join(kernels.CSRC, 'mc_combine.cu')).read()
    src = re.sub(r'constexpr int kThreads = \d+;',
                 f'constexpr int kThreads = {threads};', src)
    src = re.sub(r'constexpr int kMinCtasPerSm = \d+;',
                 f'constexpr int kMinCtasPerSm = {min_ctas};', src)
    if barrier == 'cg':
        src = src.replace('#include <cuda_runtime.h>',
                          '#include <cooperative_groups.h>\n'
                          '#include <cuda_runtime.h>')
        src = src.replace('grid_barrier(p.arrived, k);',
                          'cooperative_groups::this_grid().sync();')
    return src


def build(variants):
    out_dir = os.path.join(kernels.BUILD_DIR, 'k2_sweep')
    os.makedirs(out_dir, exist_ok=True)
    procs = []
    for v in variants:
        cu = os.path.join(out_dir, 'k2_{}_{}_{}.cu'.format(*v))
        with open(cu, 'w') as f:
            f.write(variant_source(*v))
        so = cu[:-3] + '.so'
        procs.append((v, so, subprocess.Popen(
            [kernels.nvcc_path()] + kernels.NVCC_FLAGS
            + ['-Xptxas', '-v', '-shared', cu, '-o', so],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = []
    for v, so, p in procs:
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f'nvcc failed on variant {v}:\n{log}')
        lib = ctypes.CDLL(so)
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.jt_mc_combine.argtypes = [P] * 13 + [I, I, I, I, P]
        lib.jt_mc_combine.restype = I
        lib.jt_mc_combine_grid.argtypes = [I]
        lib.jt_mc_combine_grid.restype = I
        info = dict(registers=re.findall(r'Used (\d+) registers', log),
                    spill_bytes=re.findall(r'(\d+) bytes spill stores', log))
        libs.append((v, lib, info))
    return libs


def batch(dev):
    """A 720p batch: 94 % of macroblocks written, 15 % of blocks coded,
    vectors within +-20 half-pels (the realistic stream's proportions)."""
    rng = np.random.default_rng(0)
    n_mb = (H // 16) * (W // 16)
    t = lambda a: torch.as_tensor(a, device=dev)
    cur = Planes(*(t(rng.integers(0, 256, s, dtype=np.uint8))
                   for s in ((H, W), (H // 2, W // 2), (H // 2, W // 2))))
    mv = rng.integers(-20, 21, (F, n_mb, 2)).astype(np.int32)
    coded = rng.random((F, n_mb, 6)) < 0.15
    written = rng.random((F, n_mb)) < 0.94
    intra = ~written & (rng.random((F, n_mb)) < 0.5)
    mode = ((coded << np.arange(6)).sum(-1) | (intra << 6) | (written << 7))
    meta = t(np.stack([mv[..., 0], mv[..., 1], mode], -1).astype(np.int32))
    resid = t(rng.integers(-300, 300, (F, n_mb, 6, 64)).astype(np.int32))
    return cur, resid, meta


def launch(lib, cur, resid, meta):
    out = tuple(torch.empty((resid.shape[0],) + p.shape, dtype=torch.uint8,
                            device=p.device) for p in cur)
    arrived = torch.zeros(1, dtype=torch.int32, device=resid.device)
    rc = lib.jt_mc_combine(*(p.data_ptr() for p in cur),
                           *(p.data_ptr() for p in cur), resid.data_ptr(),
                           meta.data_ptr(), *(o.data_ptr() for o in out),
                           arrived.data_ptr(), None, resid.shape[0], H // 16,
                           W // 16, 1, torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f'K2 variant launch failed: CUDA error {rc}')
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print('k2_sweep: no CUDA device is available', file=sys.stderr)
        return 1
    dev = torch.device('cuda')
    libs = build([(th, mc, b) for th, mc in SHAPES for b in BARRIERS])
    cur, resid, meta = batch(dev)
    idle = torch.zeros_like(meta)
    want = decode_frames_ref(cur, cur, resid, meta)
    for order in (libs, libs[::-1]):
        for (threads, min_ctas, barrier), lib, info in order:
            for g, w in zip(launch(lib, cur, resid, meta), want):
                if not torch.equal(g, w):
                    raise AssertionError(f'variant {threads}x{min_ctas} '
                                         f'{barrier} differs')
            ms = cuda_ms(torch, lambda: launch(lib, cur, resid, meta), 20)
            one = cuda_ms(torch, lambda: launch(lib, cur, resid[:1],
                                                meta[:1]), 20)
            copy = cuda_ms(torch, lambda: launch(lib, cur, resid, idle), 20)
            print(json.dumps(dict(
                threads=threads, min_ctas_per_sm=min_ctas, barrier=barrier,
                grid_ctas=lib.jt_mc_combine_grid(meta.shape[1]), **info,
                batch_ms=ms, us_per_frame=ms / F * 1e3,
                one_frame_us=one * 1e3,
                copy_only_us_per_frame=copy / F * 1e3)), flush=True)
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())

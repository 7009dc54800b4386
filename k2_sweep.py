#!/usr/bin/env python3
"""Time variants of kernel K2 (jsmpeg_tpu_torch/csrc/mc_combine.cu) on one
GPU: CTA shapes and the backoff of its readiness waits, on the same
random 720p inputs.

    python3 k2_sweep.py                      # from the checkout root
    python3 k2_sweep.py --baseline OLD.cu    # plus another K2 source
    python3 k2_sweep.py --phases             # where a macroblock's time goes

Each variant is the checked-in source with its CTA constants (threads,
minimum CTAs per SM, hence the register cap), its poll backoff (the
first and the longest __nanosleep of a wait), the words between two
rows' readiness counts or the macroblocks a warp publishes with one
fence replaced; `--baseline` adds
another source with the same C interface as it is (an earlier K2, to
compare two versions in one run).  The variants build in parallel into
build/jsmpeg_tpu_torch/k2_sweep/, each is held to decode_frames_ref on
every case, and each is timed twice, in forward then reverse order, with
chip_smoke.py's held-stream timer, on: a 32-frame batch with the
realistic stream's proportions, one frame of it, the batch with all-zero
metadata (every frame a copy of the stale plane), the batch with far
vectors (every macroblock written, reading the previous frame's opposite
edge), the batch as 4 stacked segments (the joint fleet modes' launch)
and its first 12 frames as 8 segments (the GOP mesh's 8 x 12 launch).
Prints one JSON line per variant and order, then the card's name and
power limit.  `--phases` builds the checked-in source alone with a clock
stamp at each step of a macroblock (its wait, its windows' arrival, its
compute and stores, its publish) and prints, per case, each step's cycles
per macroblock.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

import numpy as np
import torch

from chip_smoke import cuda_ms, ptxas_report
from jsmpeg_tpu_torch.ops import kernels
from jsmpeg_tpu_torch.ops.frame import Planes, decode_frames_ref
from jsmpeg_tpu_torch.testing.kernel_inputs import k2_vectors

SOURCE = dict(threads=384, min_ctas=2, spin_ns=32, spin_max_ns=512,
              flag_stride=32, publish_every=8)
SHAPES = ((256, 3), (128, 6), (256, 2))
BACKOFFS = ((0, 0), (32, 128), (128, 2048), (512, 512))
FLAG_STRIDES = (1,)   # words between two rows' counts
PUBLISH_EVERY = (1, 4)   # the most macroblocks a warp publishes at once
F, H, W = 32, 720, 1280
MESH_SEGS, MESH_FRAMES = 8, 12
JOINT_SEGS = 4


def variants(baseline=None):
    """The checked-in constants, the other CTA shapes, backoffs and flag
    strides with the rest as checked in, and the baseline source."""
    yield dict(SOURCE)
    for threads, min_ctas in SHAPES:
        yield dict(SOURCE, threads=threads, min_ctas=min_ctas)
    for spin_ns, spin_max_ns in BACKOFFS:
        yield dict(SOURCE, spin_ns=spin_ns, spin_max_ns=spin_max_ns)
    for flag_stride in FLAG_STRIDES:
        yield dict(SOURCE, flag_stride=flag_stride)
    for publish_every in PUBLISH_EVERY:
        yield dict(SOURCE, publish_every=publish_every)
    if baseline:
        yield dict(baseline=baseline)


def variant_source(v: dict) -> str:
    if 'baseline' in v:
        return open(v['baseline']).read()
    src = open(os.path.join(kernels.CSRC, 'mc_combine.cu')).read()
    for pattern, repl in (
            (r'constexpr int kThreads = \d+;',
             f'constexpr int kThreads = {v["threads"]};'),
            (r'constexpr int kMinCtasPerSm = \d+;',
             f'constexpr int kMinCtasPerSm = {v["min_ctas"]};'),
            (r'constexpr int kSpinNs = \d+, kSpinMaxNs = \d+;',
             f'constexpr int kSpinNs = {v["spin_ns"]}, '
             f'kSpinMaxNs = {v["spin_max_ns"]};'),
            (r'constexpr int kFlagStride = \d+;',
             f'constexpr int kFlagStride = {v["flag_stride"]};'),
            (r'constexpr int kPublishEvery = \d+;',
             f'constexpr int kPublishEvery = {v["publish_every"]};')):
        src, n = re.subn(pattern, repl, src)
        if n != 1:
            raise RuntimeError(f'{pattern!r} not found in mc_combine.cu')
    return src


def build(vs):
    out_dir = os.path.join(kernels.BUILD_DIR, 'k2_sweep')
    os.makedirs(out_dir, exist_ok=True)
    procs = []
    for v in vs:
        cu = os.path.join(out_dir, 'k2_{}.cu'.format(
            'baseline' if 'baseline' in v else 'phases' if 'phases' in v else
            '{threads}_{min_ctas}_{spin_ns}_{spin_max_ns}_{flag_stride}_'
            '{publish_every}'.format(**v)))
        with open(cu, 'w') as f:
            f.write(phase_source(v) if 'phases' in v else variant_source(v))
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
        if hasattr(lib, 'jt_mc_combine_flag_words'):
            lib.jt_mc_combine_flag_words.argtypes = [I, I]
            lib.jt_mc_combine_flag_words.restype = ctypes.c_longlong
        info = {k: v for k, v in ptxas_report(log).items()
                if k.startswith('k2_')}
        libs.append((v, lib, info))
    return libs


def cases(dev):
    """name -> (carry planes, resid, meta, n_seg).  A 720p batch: 94 % of
    macroblocks written, 15 % of blocks coded, vectors within +-20
    half-pels (the realistic stream's proportions); one frame of it; the
    batch as copies of the stale plane; with far vectors; as JOINT_SEGS
    stacked segments; its first MESH_FRAMES frames as MESH_SEGS
    segments."""
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
    far = meta.clone()
    far[..., :2] = t(k2_vectors('far', rng, F, H // 16, W // 16))
    far[..., 2] |= 0x80

    def stacked(n, frames):
        return (Planes(*[torch.cat([p] * n) for p in cur]),
                torch.cat([resid[:frames]] * n, dim=1),
                torch.cat([meta[:frames]] * n, dim=1), n)

    return {'batch': (cur, resid, meta, 1),
            'one_frame': (cur, resid[:1], meta[:1], 1),
            'copy_only': (cur, resid, torch.zeros_like(meta), 1),
            'far_vectors': (cur, resid, far, 1),
            f'segments_{JOINT_SEGS}': stacked(JOINT_SEGS, F),
            f'mesh_{MESH_SEGS}x{MESH_FRAMES}': stacked(MESH_SEGS,
                                                       MESH_FRAMES)}


def launch(lib, cur, resid, meta, n_seg, extra_words: int = 0):
    """One launch; returns the outputs and the flag words (with
    `extra_words` more after them)."""
    n_frames, (h, w) = resid.shape[0], cur[0].shape
    out = tuple(torch.empty((n_frames,) + p.shape, dtype=torch.uint8,
                            device=p.device) for p in cur)
    # a baseline without readiness flags reads word 0 (its counter)
    words = (lib.jt_mc_combine_flag_words(n_frames, h // 16)
             if hasattr(lib, 'jt_mc_combine_flag_words') else 1)
    done = torch.zeros(words + extra_words, dtype=torch.int32,
                       device=resid.device)
    rc = lib.jt_mc_combine(*(p.data_ptr() for p in cur),
                           *(p.data_ptr() for p in cur), resid.data_ptr(),
                           meta.data_ptr(), *(o.data_ptr() for o in out),
                           done.data_ptr(), None, n_frames, h // 16, w // 16,
                           n_seg, torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f'K2 variant launch failed: CUDA error {rc}')
    return out, done[words:]


# --phases: the checked-in source with a clock64() stamp at each step of a
# macroblock; lane 0 writes its four intervals (cycles) to words
# [4 g, 4 g + 4) after the flags
PHASES = ('wait', 'windows', 'compute_store', 'publish')
STAMPS = (
    ('    if constexpr (!kBand) {\n      int wk, r0, r1;',
     '    const long long t0 = clock64();\n'),
    ('    // scalars, not arrays: a dynamically indexed array lands',
     '    const long long t1 = clock64();\n'),
    ("    // an unwritten macroblock's base words",
     '    const long long t2 = clock64();\n'),
    ("    // the walk's next macroblock\n",
     '    const long long t3 = clock64();\n'),
    ('    // after the publish, whose fence would wait for them',
     '    if constexpr (!kBand) {\n'
     '      unsigned int* const t = p.done + int64_t(p.n_frames) * p.mb_h *\n'
     '          kFlagStride + int64_t(g) * 4;\n'
     '      if (lane == 0) {\n'
     '        t[0] = unsigned(t1 - t0);\n'
     '        t[1] = unsigned(t2 - t1);\n'
     '        t[2] = unsigned(t3 - t2);\n'
     '        t[3] = unsigned(clock64() - t3);\n'
     '      }\n'
     '    }\n'))


def phase_source(v: dict) -> str:
    src = variant_source(v)
    for anchor, stamp in STAMPS:
        if src.count(anchor) != 1:
            raise RuntimeError(f'{anchor!r} not found once in mc_combine.cu')
        src = src.replace(anchor, stamp + anchor)
    return src


def phases(lib, cs) -> None:
    """Per case, each phase's cycles per macroblock (mean, p50, p90) in
    the stamped kernel, from its second launch."""
    for name, (cur, resid, meta, n_seg) in cs.items():
        n = resid.shape[0] * resid.shape[1]
        for _ in range(2):
            _, t = launch(lib, cur, resid, meta, n_seg, 4 * n)
        torch.cuda.synchronize()
        c = t.view(n, 4).cpu().numpy().astype(np.uint32).astype(np.float64)
        print(json.dumps({'case': name, 'cycles_per_mb': dict(
            mean=c.sum(1).mean(), **{ph: dict(
                mean=c[:, i].mean(), p50=np.percentile(c[:, i], 50),
                p90=np.percentile(c[:, i], 90))
                for i, ph in enumerate(PHASES)})}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--baseline', help='another K2 source to time beside')
    ap.add_argument('--phases', action='store_true',
                    help='only the checked-in source, stamped: cycles per '
                         'macroblock in each phase')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('k2_sweep: no CUDA device is available', file=sys.stderr)
        return 1
    dev = torch.device('cuda')
    cs = cases(dev)
    if args.phases:
        (_, lib, info), = build([dict(SOURCE, phases=True)])
        print(json.dumps(info), flush=True)
        phases(lib, cs)
        print(subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit,clocks.sm',
             '--format=csv,noheader'], capture_output=True,
            text=True).stdout.strip(), flush=True)
        return 0
    libs = build(list(variants(args.baseline)))
    want = {name: decode_frames_ref(c[0], c[0], *c[1:])
            for name, c in cs.items()}
    for order in (libs, libs[::-1]):
        for v, lib, info in order:
            times = {}
            for name, c in cs.items():
                for g, w in zip(launch(lib, *c)[0], want[name]):
                    if not torch.equal(g, w):
                        raise AssertionError(f'variant {v} differs on '
                                             f'{name}')
                times[f'{name}_ms'] = cuda_ms(
                    torch, lambda: launch(lib, *c), 20)
            print(json.dumps(dict(
                **v,
                grid_ctas=lib.jt_mc_combine_grid(F * (H // 16) * (W // 16)),
                **info, **times,
                batch_us_per_frame=times['batch_ms'] / F * 1e3)),
                flush=True)
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())

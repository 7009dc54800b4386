#!/usr/bin/env python3
"""The port's correctness rig on one NVIDIA GPU: every path of the
PyTorch/CUDA port (jsmpeg_tpu_torch) on the card, held to the CPU.

    python3 chip_smoke.py

Builds the host parser and the CUDA kernels from the checkout, records
the host canary (`host_canary`, and `host_canary_end` after the last
phase), holds each kernel to its plain PyTorch version on the card (K1's
three forms, and K1's IDCT against the ideal float transform; K2; K3, the
wire unpack, on the kernel cases of `jsmpeg_tpu_torch.testing.
kernel_cases`, with K1's compact form on each wire's coded blocks),
decodes a 96-frame 720p MPEG-TS stream through `MPEG1Decoder` on the card
(checked against the same decoder on the CPU, the wire build, upload and
dispatch on the feeder thread, a pinned wire held until its copy is
done), runs the single-frame, serial-fallback and dense-levels paths,
then the user's entry points on the same video muxed with 123 MP2 audio
frames: `Player.decode_offline` (every warm run's frames held to the CPU
too), the audio decoder's device mode, the colour conversion, the CLI
(`python -m jsmpeg_tpu_torch`) and a live stream pushed at 30 fps; then
the sparse wire, a fleet of four 720p streams through
`MultiStreamDecoder` in its three modes (round-robin, and the joint
stacked and vmap modes, where K2 runs the streams as segments of one
launch) and 1, 2 and 4 copies of the stream, `serve()` on two files and a
TCP feed (and the two files again in the stacked mode), the multi-input
CLI, the I-picture thumbnails, a differential fuzz of a SIF stream (card
against CPU) and the robustness soak (`jsmpeg_tpu_torch.fuzz_soak`,
random geometries and corruptions through every layer, each decode held
to the CPU, for a fixed wall), then the kernels' checked build in a
process of its own (`sanitize_check --checked`: bounds-checked accesses,
shared-memory hazards, K2's waits and K3's look-back, poisoned outputs,
perturbed schedules, seven negative controls; `s2_checked`); then the GOP
mesh (the 96 frames as 8 GOP segments of one launch pair through
`decode_packed_mesh`, `decode_available(mesh=)`, the Player and the CLI
with `--mesh 8`, the fleet through `decode_streams_mesh`), a live stream
through the port's relay to a ws:// Player, the tile cells of a mesh on
two device objects (the picture in bands: K2's band mode and the halo
exchange, `decode_tiled`, `decode_tiled_levels`, a stream whose vectors
reach past the picture's edges), the multi-process decodes (two gloo
ranks of `python -m jsmpeg_tpu_torch.parallel.multihost`, the elastic
decode with a worker killed); and last, each kernel alone beside its
bound (`portbench.work`) at the main batch and at shapes no benchmark
cell runs (`h_kernel_detail`).  The port's end-to-end speed is the
benchmark's (`python3 -m portbench.run`), its spans' breakdown
`span_breakdown.py`'s.  Each phase prints one JSON line; the line before
the last is the card's name and power limit as nvidia-smi prints them,
and the last line is {"ok": true, "device": {...}}.  Any failure exits
non-zero before that.  It needs a CUDA device and the repo's
`jsmpeg_tpu_torch` and `portbench` packages beside it, and imports
nothing of JAX.
"""

from __future__ import annotations

import contextlib
import gc
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

from jsmpeg_tpu_torch.testing.kernel_cases import (
    BATCH, GOP, H, K2_BAND_HALO, K2_BAND_MB_H, K2_BAND_SEGS, K2_BANDS,
    K2_CHECK_FRAMES, K2_SEG_FRAMES, K2_SEGMENTS, N_FRAMES, SEED, W, k3_cases,
    k3_copies, k3_shape_wires, stream_quant)
from portbench.work import (HBM_BYTES_PER_S, IDCT_OPS_PER_BLOCK,
                            INT32_OPS_PER_S, bound, k1_work, k2_work,
                            k3_work)

N_AUDIO = 123               # MP2 frames of the A/V stream (3.21 s at 44.1 kHz)
FPS = 30.0
N_DENSE = 24                # frames of the dense-levels phase
N_REPEATS = 5               # warm repeats: Player, audio, thumbs, meshes
K2_RERUNS = 20              # launches of each K2 check, all equal
K3_RERUNS = 20              # launches of each K3 check, all equal
MS_FRAMES, MS_SEEDS = (40, 32, 20), (4, 5, 6)   # streams 1-3 of the fleet
FLEET_MODES = ('roundrobin', 'stacked', 'vmap')
SWEEP_S = (1, 2, 4)         # copies of the main stream
DEVICE = 'cuda'
SOAK_SECONDS, SOAK_SEED = 45, 1200   # the robustness soak's wall and seed
# the checked rig (s2_checked): its soak's wall, its whole wall (build
# included), the in-process soak iterations it must reach
CHECKED_SOAK_SECONDS, CHECKED_CAP_S, CHECKED_MIN_ITERATIONS = 30, 150, 10
# kernel launches of each path's run, counted from 0 just before it
PATH_LAUNCHES: dict = {}
KERNELS = ('dequant_idct', 'mc_combine', 'wire_unpack')
# K1's launches of each path's run by form (kernels.k1_forms), and each
# form's max |err| against its plain version over the checks
PATH_K1_FORMS: dict = {}
K1_ERR = {'dequant_idct.compact': 0, 'dequant_idct.levels': 0,
          'dequant_idct.premultiplied': 0}
# the thread prefix of the batch path's feeder (models/mpeg1.py)
FEEDER_PREFIX = 'jsmpeg-feeder'

# clock cycles of the device-side sleep that cuda_ms enqueues ahead of the
# timed calls: ~0.1 s at the H100's ~2 GHz, longer than the host takes to
# enqueue them
HOLD_CYCLES = 200_000_000


T0 = time.monotonic()


def emit(phase: str, **kw) -> None:
    """One phase's JSON line, with the script's seconds so far (at_s)."""
    print(json.dumps({'phase': phase, **kw,
                      'at_s': time.monotonic() - T0}), flush=True)


def each(n: int, unpacks: int = None) -> dict:
    """The launch counts of a path that runs K1 and K2 n times each and
    K3 `unpacks` times (n: one packed wire per K1 launch)."""
    return {'dequant_idct': n, 'mc_combine': n,
            'wire_unpack': n if unpacks is None else unpacks}


def ran_or_raise(name: str, launches: dict, kernels=KERNELS) -> None:
    """Raises unless each of `kernels` was launched in this path's run."""
    missing = [k for k in kernels if launches.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f'{name} skipped {missing}: {launches}')


def k1_compact_args(torch, la, iq=None, nq=None) -> tuple:
    """dequant_idct_compact's arguments for a compact LevelsArrays (K3's
    outputs), with the stream's matrices or else the default ones."""
    from jsmpeg_tpu_torch import tables as T
    dev = la.levels.device
    if iq is None:
        iq, nq = (torch.as_tensor(np.asarray(q, np.int32), device=dev)
                  for q in (T.DEFAULT_INTRA_QUANT_MATRIX,
                            T.DEFAULT_NON_INTRA_QUANT_MATRIX))
    F, M = la.qscale.shape
    return (la.levels, la.blk_ids, la.qscale.reshape(-1),
            la.intra.reshape(-1), iq, nq, F * M * 6)


def k1_compact_check(torch, kernels, args, name: str):
    """K1's compact form against its plain version on the card at the
    named blocks (the only ones it writes).  Returns the residuals."""
    from jsmpeg_tpu_torch.ops.idct import dequant_idct_compact_ref
    got = kernels.dequant_idct_compact_cuda(*args)
    named = args[1][args[1] >= 0].long()
    K1_ERR['dequant_idct.compact'] = max(
        K1_ERR['dequant_idct.compact'],
        equal_or_raise(f'K1 compact {name}', got[named],
                       dequant_idct_compact_ref(*args)[named]))
    return got


def k1_forms_of(path: str, kernels) -> dict:
    """K1's launches by form since the last reset, kept as `path`'s."""
    PATH_K1_FORMS[path] = dict(kernels.k1_forms)
    return PATH_K1_FORMS[path]


def cuda_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of one fn() call over `iters` back-to-back calls.
    A device-side sleep holds the stream while the host enqueues the
    timed calls, so the events see the kernels run back to back and not
    the host's launch rate (one Python launch outlasts a small kernel)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(HOLD_CYCLES)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def host_us(torch, fn, iters: int, rounds: int = 5) -> float:
    """Host time, in microseconds, to enqueue one fn() call while a
    device-side sleep holds the stream, so that no call waits on the
    device (warm: the caching allocator reuses the last call's blocks):
    the median over `rounds` of the mean of `iters` calls."""
    fn()
    means = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        torch.cuda._sleep(HOLD_CYCLES)
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        means.append((time.perf_counter() - t0) / iters * 1e6)
    torch.cuda.synchronize()
    return float(np.median(means))


def profiled_us(torch, fn, iters: int) -> dict:
    """Each device kernel and memset of `iters` fn() calls as CUPTI traces
    them (torch.profiler), by name: launches per call and mean device
    microseconds each, every launch measured apart."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, 'self_device_time_total', None)
        if us is None:
            us = getattr(e, 'self_cuda_time_total', 0)
        if us > 0:
            out[e.key] = {'per_call': e.count / iters,
                          'mean_us': us / e.count}
    return out


def equal_or_raise(name: str, got, want) -> int:
    """Exact comparison of integer tensors; returns the max |error| (0)."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f'{name}: {got.dtype}{tuple(got.shape)} vs '
                             f'{want.dtype}{tuple(want.shape)}')
    err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
    if err:
        bad = int((got != want).sum())
        raise AssertionError(f'{name}: {bad} values differ, max |err| {err}')
    return err


def planes_equal(name: str, a, b) -> None:
    for pn, x, y in zip(('y', 'cr', 'cb'), a, b):
        x, y = np.asarray(x), np.asarray(y)
        if x.shape != y.shape or not np.array_equal(x, y):
            raise AssertionError(f'{name} plane {pn} differs')


def host_planes(p):
    return tuple(t.cpu().numpy() for t in p)


# ------------------------------------------------------------------ phases

def phase_gpu():
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], check=True,
                         capture_output=True, text=True).stdout.strip()
    smi = out.splitlines()[0]
    emit('a_gpu', nvidia_smi=smi)
    return smi


# K2's instantiations, frame_loop_kernel<kSegmented, kBand>, by their
# mangled template arguments
K2_FORMS = {'ILb0ELb0E': 'k2_one_stream', 'ILb1ELb0E': 'k2_segmented',
            'ILb1ELb1E': 'k2_band'}


def ptxas_report(log: str) -> dict:
    """Registers, spill-store bytes and static shared bytes of each
    kernel in an `-Xptxas -v` log, by name (K2's forms by K2_FORMS,
    others by their mangled name)."""
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name = next((v for k, v in K2_FORMS.items() if k in m[1]), m[1])
            out[name] = {}
        elif name and 'spill stores' in ln:
            out[name]['spill_bytes'] = int(
                re.search(r'(\d+) bytes spill stores', ln)[1])
        elif name and 'Used' in ln and 'registers' in ln:
            out[name]['registers'] = int(
                re.search(r'Used (\d+) registers', ln)[1])
            smem = re.search(r'(\d+) bytes smem', ln)
            out[name]['smem_bytes'] = int(smem[1]) if smem else 0
    return out


def phase_build(kernels):
    """Host parser (g++), CUDA kernels (one nvcc per source) and their
    checked build (csrc/checked.cuh, for s2_checked) build in parallel;
    all from the checkout's sources."""
    from jsmpeg_tpu_torch.host.native.build_native import ensure_built
    times, errors = {}, []

    def run(name, fn):
        t0 = time.monotonic()
        try:
            fn()
        except Exception as e:       # re-raised below, after both joined
            errors.append(e)
        times[name] = time.monotonic() - t0

    threads = [threading.Thread(target=run, args=('host_s', ensure_built)),
               threading.Thread(target=run,
                                args=('kernels_s', kernels.ensure_built)),
               threading.Thread(target=run, args=(
                   'checked_kernels_s',
                   lambda: kernels.ensure_built(checked=True)))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    kernels.lib()
    with open(kernels.LOG_PATH) as f:
        ptxas = ptxas_report(f.read())
    with open(kernels.CHECKED_LOG_PATH) as f:
        ptxas_checked = ptxas_report(f.read())
    emit('b_build', **{k: round(v, 3) for k, v in times.items()},
         library=kernels.SO_PATH, ptxas=ptxas,
         checked_library=kernels.CHECKED_SO_PATH,
         ptxas_checked=ptxas_checked)
    # K2's batch forms keep every value in registers
    for form in ('k2_one_stream', 'k2_segmented'):
        if ptxas.get(form, {}).get('spill_bytes', 1):
            raise AssertionError(f'{form} spills or is missing from the '
                                 f'build log: {ptxas.get(form)}')


def phase_k1(torch, dev):
    """K1 against its plain versions on the card: the levels form at the
    720p 32-frame batch shape (and a ragged tail), the compact form on a
    random fifth of the same shapes' blocks in a random order with
    unnamed rows, then the IDCT-only form."""
    from jsmpeg_tpu_torch.ops import kernels
    from jsmpeg_tpu_torch.ops.idct import dequant_idct_ref, dequant_premult
    from jsmpeg_tpu_torch.testing.kernel_inputs import (k1_compact_inputs,
                                                        k1_inputs)
    rng = np.random.default_rng(SEED)
    compact_rng = np.random.default_rng(SEED + 1)
    err = 0
    for n_mb in (BATCH * (W // 16) * (H // 16), 7):
        args = k1_inputs(torch, n_mb, rng, dev)
        got = kernels.dequant_idct_cuda(*args, premultiplied=False)
        err = max(err, equal_or_raise(f'K1 levels n_mb={n_mb}', got,
                                      dequant_idct_ref(*args)))
        K1_ERR['dequant_idct.levels'] = err
        k1_compact_check(torch, kernels,
                         k1_compact_inputs(torch, n_mb, compact_rng, dev),
                         f'random n_mb={n_mb}')
        coef = dequant_premult(*args)
        # plus blocks of arbitrary int32 coefficients: wrapping butterflies
        wild = torch.as_tensor(rng.integers(-2**31, 2**31, (n_mb, 1, 64),
                                            dtype=np.int64).astype(np.int32),
                               device=dev)
        coef[:, 5:6] = wild
        got = kernels.dequant_idct_cuda(coef, premultiplied=True)
        K1_ERR['dequant_idct.premultiplied'] = max(
            K1_ERR['dequant_idct.premultiplied'],
            equal_or_raise(f'K1 premultiplied n_mb={n_mb}', got,
                           dequant_idct_ref(coef, premultiplied=True)))
    ideal = k1_ideal_idct(torch, kernels, dev)
    torch.cuda.synchronize()
    emit('c_k1_check', equal=True, max_abs_err=dict(K1_ERR),
         shape=[BATCH * (W // 16) * (H // 16), 6, 64], ideal_idct=ideal)
    return max(K1_ERR.values())


def k1_ideal_idct(torch, kernels, dev) -> dict:
    """K1's IDCT-only mode against closed-form math, independently of its
    plain version: the 200 random blocks of the spec vectors
    (tests/test_torch_spec_vectors.py), premultiplied, through K1 (in
    one launch of 34 macroblocks, the last 4 blocks zero), each block's
    max |K1 - ideal float 2-D IDCT| held to the spec's bounds on their
    mean and largest."""
    from jsmpeg_tpu_torch import tables as T
    from jsmpeg_tpu_torch.testing.spec import (IDCT_MAX_ERR,
                                               IDCT_MEAN_MAX_ERR,
                                               idct_errors, idct_vectors)
    coefs, ideal = idct_vectors(T.PREMULTIPLIER_MATRIX)
    n = len(coefs)
    flat = np.zeros((-(-n // 6) * 6, 64), np.int32)
    flat[:n] = coefs.reshape(n, 64)
    got = kernels.dequant_idct_cuda(
        torch.as_tensor(flat.reshape(-1, 6, 64), device=dev),
        premultiplied=True)
    mean, worst = idct_errors(got.reshape(-1, 8, 8)[:n].cpu().numpy(),
                              ideal)
    if mean > IDCT_MEAN_MAX_ERR or worst > IDCT_MAX_ERR:
        raise AssertionError(f'K1 against the ideal IDCT: mean {mean}, '
                             f'max {worst} (bounds {IDCT_MEAN_MAX_ERR}, '
                             f'{IDCT_MAX_ERR})')
    return {'blocks': n, 'mean_err': mean, 'max_err': worst,
            'bounds': [IDCT_MEAN_MAX_ERR, IDCT_MAX_ERR]}


def k2_case(torch, kernels, rng, dev, n_seg: int, seg_frames=None,
            vectors: str = 'random'):
    """K2 against decode_frames_ref on a batch of K2_CHECK_FRAMES frames
    of n_seg 720p streams stacked along rows (`kernel_inputs.k2_batch`:
    random carry planes, `k2_vectors(vectors)`, a mix of written/coded/
    intra, residuals that wrap int32).  The kernel runs K2_RERUNS times
    and every output must equal the first (a missing wait or a stale read
    of an earlier frame would show as a difference).  Returns (max |err|,
    parities)."""
    from jsmpeg_tpu_torch.ops.frame import decode_frames_ref
    from jsmpeg_tpu_torch.testing.kernel_inputs import k2_batch
    cur, fwd, resid, meta, mv = k2_batch(torch, rng, dev, K2_CHECK_FRAMES,
                                         n_seg * H, W, vectors, n_seg)
    args = (cur, fwd, resid, meta, n_seg, seg_frames)
    got = kernels.mc_combine_cuda(*args)
    what = f'K2 n_seg={n_seg} seg_frames={seg_frames} vectors={vectors}'
    for i in range(1, K2_RERUNS):
        for pn, g, a in zip(('y', 'cr', 'cb'), got,
                            kernels.mc_combine_cuda(*args)):
            equal_or_raise(f'{what} rerun {i} {pn}', a, g)
    want = decode_frames_ref(*args)
    err = max(equal_or_raise(f'{what} {pn}', g, w_)
              for pn, g, w_ in zip(('y', 'cr', 'cb'), got, want))
    torch.cuda.synchronize()
    return err, sorted({(int(a) & 1, int(b) & 1)
                        for a, b in mv.reshape(-1, 2)})


def k2_band_case(torch, kernels, rng, dev):
    """K2's band mode against mc_combine_ref with the same Band: each of
    K2_BANDS bands of a 1280-wide picture of K2_BAND_MB_H macroblock rows
    (the last band ends in a padding row), K2_BAND_SEGS segments whose
    counts leave the second past its last frame (`kernel_inputs.k2_band`:
    every plane and halo random, the padding rows and the picture's outer
    halos too; vectors at the halo's full depth past every band edge and
    past the picture's top and bottom, columns past both sides).  Each
    band launch runs twice and both outputs must be equal.  Returns the
    max |err| (0)."""
    from jsmpeg_tpu_torch.ops.frame import mc_combine_ref
    from jsmpeg_tpu_torch.testing.kernel_inputs import k2_band
    S, local = K2_BAND_SEGS, -(-K2_BAND_MB_H // K2_BANDS)
    err = 0
    for band in range(K2_BANDS):
        cur, fwd, resid, meta, b = k2_band(torch, rng, dev, S, local,
                                           K2_BAND_MB_H, K2_BAND_HALO, W,
                                           band)
        args = (cur, fwd, resid, meta, S, [4, 3])
        got = kernels.mc_combine_cuda(*args, band=b)
        again = kernels.mc_combine_cuda(*args, band=b)
        want = mc_combine_ref(cur, fwd, resid[0], meta[0], S, [4, 3], b)
        for pn, g, a, w_ in zip(('y', 'cr', 'cb'), got, again, want):
            equal_or_raise(f'K2 band {band} rerun {pn}', a, g)
            err = max(err, equal_or_raise(f'K2 band {band} {pn}', g[0], w_))
    torch.cuda.synchronize()
    return err


def phase_k2(torch, dev):
    """K2 against decode_frames_ref (k2_case): one 720p stream, then
    K2_SEGMENTS 720p streams stacked along rows (the joint fleet modes)
    whose frame counts K2_SEG_FRAMES include 0 and the whole batch; both
    again with far vectors and with one row's reach; then its band mode
    (k2_band_case)."""
    from jsmpeg_tpu_torch.ops import kernels
    rng = np.random.default_rng(SEED + 1)
    err, parities = k2_case(torch, kernels, rng, dev, 1)
    seg_err, _ = k2_case(torch, kernels, rng, dev, K2_SEGMENTS,
                         K2_SEG_FRAMES)
    waits = {}
    for vectors in ('far', 'one_row'):
        for n_seg, counts in ((1, None), (K2_SEGMENTS, K2_SEG_FRAMES)):
            e, _ = k2_case(torch, kernels, rng, dev, n_seg, counts, vectors)
            waits[f'{vectors}_n_seg_{n_seg}'] = {
                'equal': True, 'rerun_equal': True, 'max_abs_err': e}
    band_err = k2_band_case(torch, kernels, rng, dev)
    emit('d_k2_check', equal=True, rerun_equal=True, max_abs_err=err,
         reruns=K2_RERUNS, frames=K2_CHECK_FRAMES, frame=[H, W],
         grid_ctas=kernels.lib().jt_mc_combine_grid(
             K2_CHECK_FRAMES * (W // 16) * (H // 16)),
         parities=parities,
         segmented={'n_seg': K2_SEGMENTS, 'seg_frames': K2_SEG_FRAMES,
                    'frame': [K2_SEGMENTS * H, W], 'equal': True,
                    'rerun_equal': True, 'max_abs_err': seg_err},
         band={'n_band': K2_BANDS, 'mb_h': K2_BAND_MB_H,
               'n_seg': K2_BAND_SEGS, 'seg_frames': [4, 3], 'frame': 3,
               'halo_mb': K2_BAND_HALO, 'width': W, 'equal': True,
               'rerun_equal': True, 'max_abs_err': band_err},
         **waits)
    return max(err, seg_err, band_err,
               *(v['max_abs_err'] for v in waits.values()))


def k3_two_streams(torch, kernels, cases) -> dict:
    """Two K3 calls at once on two CUDA streams, on different wires, each
    held to its own plain version, K3_RERUNS times: state shared between
    calls would show here.  Both streams wait on one event behind a
    device-side sleep while both calls queue, so they start together; the
    two calls' spans must overlap.  Returns the last round's overlap."""
    from jsmpeg_tpu_torch.models.mpeg1 import unpack_wires_ref
    pick = [c for c in cases if c[0] in ('main_batch_0', 'random_wide')]
    ins = [(torch.as_tensor(b, device=DEVICE), sz) for _, b, sz, _ in pick]
    wants = [unpack_wires_ref(d, *sz) for d, sz in ins]
    streams = [torch.cuda.Stream() for _ in ins]
    for stream, (d, sz) in zip(streams, ins):
        # each stream's first call fills its allocator pool
        with torch.cuda.stream(stream):
            kernels.wire_unpack_cuda(d, *sz)
    Ev = lambda: torch.cuda.Event(enable_timing=True)
    for i in range(K3_RERUNS):
        torch.cuda.synchronize()
        ref, gate, outs, spans = Ev(), Ev(), [], []
        ref.record()
        # ~5 ms: longer than the host takes to queue both calls
        torch.cuda._sleep(HOLD_CYCLES // 20)
        gate.record()
        for stream, (d, sz) in zip(streams, ins):
            stream.wait_event(gate)
            with torch.cuda.stream(stream):
                a, b = Ev(), Ev()
                a.record()
                outs.append(kernels.wire_unpack_cuda(d, *sz))
                b.record()
                spans.append((a, b))
        torch.cuda.synchronize()
        for (name, *_), got, want in zip(pick, outs, wants):
            for field, g, w_ in zip(want._fields, got, want):
                equal_or_raise(f'K3 two streams round {i} {name} {field}',
                               g, w_)
        ms = [(ref.elapsed_time(a), ref.elapsed_time(b)) for a, b in spans]
        overlap = min(e for _, e in ms) - max(s for s, _ in ms)
        if overlap <= 0:
            raise AssertionError(f'K3 two streams round {i}: the calls ran '
                                 f'one after the other ({ms} ms)')
    return {'wires': [c[0] for c in pick], 'rounds': K3_RERUNS,
            'overlap_ms': overlap}


def phase_k3(torch, es: bytes):
    """K3 against its plain version (unpack_wires_ref) on the card, bit for
    bit, on each of k3_cases' wires; each runs K3_RERUNS times and every
    output must equal the first; K1's compact form on each wire's output
    against its plain version; then two K3 calls at once on two streams.
    Returns the max |err| (0)."""
    from jsmpeg_tpu_torch.models.mpeg1 import unpack_wires_ref
    from jsmpeg_tpu_torch.ops import kernels
    from jsmpeg_tpu_torch.ops.frame import LevelsArrays
    err, out = 0, {}
    cases = k3_cases(es)
    for name, bufs, sizes, ref_bufs in cases:
        dev_bufs = torch.as_tensor(bufs, device=DEVICE)
        got = LevelsArrays(*kernels.wire_unpack_cuda(dev_bufs, *sizes))
        for i in range(1, K3_RERUNS):
            again = kernels.wire_unpack_cuda(dev_bufs, *sizes)
            for field, g, a in zip(got._fields, got, again):
                equal_or_raise(f'K3 {name} rerun {i} {field}', a, g)
        want = unpack_wires_ref(torch.as_tensor(ref_bufs, device=DEVICE),
                                *sizes)
        for field, g, w_ in zip(got._fields, got, want):
            err = max(err, equal_or_raise(f'K3 {name} {field}', g, w_))
        k1_compact_check(torch, kernels, k1_compact_args(torch, got), name)
        torch.cuda.synchronize()
        out[name] = {'streams': bufs.shape[0], 'wire_bytes': bufs.shape[1],
                     'frames': sizes[0], 'n_mb': sizes[1],
                     'pairs': sizes[4], 'n_blk': sizes[6],
                     'mv_wide': bool(sizes[3]),
                     'retired_pairs': int((ref_bufs != bufs).sum()),
                     'nonzero_levels': int((got.levels != 0).sum())}
        del got, want, dev_bufs
    if not out['main_batch_0']['nonzero_levels']:
        raise AssertionError('K3 check: the main batch holds no level')
    if not out['duplicates']['retired_pairs']:
        raise AssertionError('K3 check: the duplicates wire repeats nothing')
    two = k3_two_streams(torch, kernels, cases)
    emit('d_k3_check', equal=True, rerun_equal=True, max_abs_err=err,
         reruns=K3_RERUNS, cases=out, two_streams=two)
    return err


def encode_stream():
    """The 720p video as TS (demuxed back to its ES) and the same video
    muxed with N_AUDIO MP2 frames (stereo, 44.1 kHz, scale factors kept in
    the range where the device audio path's bound applies)."""
    from jsmpeg_tpu_torch.demux import demux_to_es
    from jsmpeg_tpu_torch.testing.gen import encode_realistic_stream
    from jsmpeg_tpu_torch.testing.mp2_enc import encode_stream as mp2_stream
    from jsmpeg_tpu_torch.testing.ts_mux import mux_av, mux_video
    t0 = time.monotonic()
    es, chunks = encode_realistic_stream(W, H, n_frames=N_FRAMES, seed=SEED,
                                         gop=GOP)
    v = chunks[:-1]
    v[-1] = v[-1] + chunks[-1]
    ts = mux_video(v, FPS)
    audio_es, audio_frames = mp2_stream(N_AUDIO, seed=SEED + 2,
                                        sf_range=(24, 63))
    ts_av = mux_av(v, FPS, audio_frames, 1152, 44100)
    encode_s = time.monotonic() - t0
    t0 = time.monotonic()
    demuxed = demux_to_es(ts)
    demux_s = time.monotonic() - t0
    if demuxed != es:
        raise AssertionError('TS mux/demux did not round-trip the stream')
    return demuxed, chunks, ts_av, audio_es, {
        'encode_s': encode_s, 'demux_s': demux_s, 'ts_bytes': len(ts),
        'es_bytes': len(es), 'av_ts_bytes': len(ts_av)}


def decode_all(torch, es: bytes, device: str):
    from jsmpeg_tpu_torch.models.mpeg1 import MPEG1Decoder
    dec = MPEG1Decoder({'device': device})
    dec.write(0.0, es)
    outs = dec.decode_available(eof=True)
    if device != 'cpu':
        torch.cuda.synchronize()
    return outs


def phase_main(torch, kernels, es: bytes, chunks, stream: dict):
    """The main path: TS -> ES -> MPEG1Decoder.decode_available on the
    card, 96 frames, after one warm-up batch; every frame is held to the
    CPU decoder, so the cur/fwd carry handed from one batch to the next
    is checked too; each K1 launch must be its compact form over exactly
    its batch's coded blocks (the parse's count); the parse must run on
    the calling thread and the wire build, upload and dispatch on the
    feeder (feeder_threads); a pinned wire buffer must be held until its
    upload is done (pinned_wire_held).  Returns the launch counts and the
    CPU decoder's frames (host arrays), which the later phases are held
    to."""
    from jsmpeg_tpu_torch.models.mpeg1 import MPEG1Decoder
    decode_all(torch, b''.join(chunks[:BATCH]), DEVICE)     # warm-up
    # the rows of each compact K1 launch of the counted run
    rows, compact = [], kernels.dequant_idct_compact_cuda

    def recorded(levels, *a):
        rows.append(levels.shape[0])
        return compact(levels, *a)

    kernels.dequant_idct_compact_cuda = recorded
    kernels.reset_launches()
    dec = MPEG1Decoder({'device': DEVICE})
    dec.write(0.0, es)
    try:
        with feeder_threads(dec) as threads:
            t0 = time.monotonic()
            outs = dec.decode_available(eof=True)
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
    finally:
        kernels.dequant_idct_compact_cuda = compact
    launches = dict(kernels.launches)
    forms = k1_forms_of('main', kernels)
    parser = MPEG1Decoder({'device': 'cpu'}).parser
    parser.write(es)
    coded = [parser.parse_batch(BATCH, eof=True)['n_blocks']
             for _ in range(N_FRAMES // BATCH)]
    if rows != coded or forms['dequant_idct.compact'] != len(coded):
        raise AssertionError(f'main-path K1 launches {forms} over {rows} '
                             f'rows; the batches hold {coded} coded blocks')
    if outs is None or len(outs) != N_FRAMES:
        raise AssertionError(f'decoded {0 if outs is None else len(outs)} '
                             f'of {N_FRAMES} frames')
    for p in outs:
        if (tuple(p.y.shape) != (H, W) or tuple(p.cr.shape) != (H // 2, W // 2)
                or p.y.dtype != torch.uint8
                or p.y.device.type != torch.device(DEVICE).type):
            raise AssertionError('unexpected frame shape/dtype/device')
    t0 = time.monotonic()
    ref = decode_all(torch, es, 'cpu')
    cpu_s = time.monotonic() - t0
    if len(ref) != N_FRAMES:
        raise AssertionError('CPU decoder lost frames')
    for i in range(N_FRAMES):
        planes_equal(f'main path frame {i}', host_planes(outs[i]),
                     host_planes(ref[i]))
    # one K3, one K1 and one K2 launch per 32-frame batch
    want = each(N_FRAMES // BATCH)
    if launches != want:
        raise AssertionError(f'main-path launches {launches}, expected '
                             f'{want}')
    PATH_LAUNCHES['main'] = launches
    cpu_frames = [host_planes(p) for p in ref]
    del outs, ref
    emit('e_main', frames=N_FRAMES, cpu_equal_frames=N_FRAMES,
         cpu_decode_s=cpu_s, wall_s=wall, launches=launches, k1_forms=forms,
         k1_rows_per_launch=rows,
         k1_dense_blocks_per_batch=BATCH * (W // 16) * (H // 16) * 6,
         stage_threads=threads,
         pinned_wire_held_until_copied=pinned_wire_held(torch), **stream)
    return launches, cpu_frames


@contextlib.contextmanager
def feeder_threads(dec):
    """The names of the threads that run each stage of `dec`'s batch path
    while the block runs: its parser's parse_batch, and the wire build,
    upload, unpack and K1 + K2 dispatch (models.mpeg1's functions).
    Yields {stage: [thread names]}, filled on exit; raises unless the
    parse ran on the calling thread only and every other stage ran, on
    the feeder only."""
    from jsmpeg_tpu_torch.models import mpeg1
    seen = {}

    def traced(name, fn):
        def run(*a, **kw):
            seen.setdefault(name, set()).add(threading.current_thread().name)
            return fn(*a, **kw)
        return run

    feeder = ('build_fused_buffer', 'upload', 'unpack_staged', 'decode_levels')
    saved = {name: getattr(mpeg1, name) for name in feeder}
    parse = dec.parser.parse_batch
    out = {}
    dec.parser.parse_batch = traced('parse_batch', parse)
    try:
        for name, fn in saved.items():
            setattr(mpeg1, name, traced(name, fn))
        yield out
    finally:
        dec.parser.parse_batch = parse
        for name, fn in saved.items():
            setattr(mpeg1, name, fn)
    out.update({k: sorted(v) for k, v in seen.items()})
    caller = threading.current_thread().name
    if seen.get('parse_batch') != {caller}:
        raise AssertionError(f'the parse ran on {out.get("parse_batch")}, '
                             f'not on the calling thread {caller}')
    for name in feeder:
        if not seen.get(name) or not all(t.startswith(FEEDER_PREFIX)
                                         for t in seen[name]):
            raise AssertionError(f'{name} ran on {out.get(name)}, not on '
                                 'the feeder thread')


def pinned_wire_held(torch) -> bool:
    """The pipeline drops each wire's host buffer as soon as its
    asynchronous upload is queued and relies on PyTorch's caching host
    allocator to hold the block until the copy is done.  Here a wire
    buffer (`pinned_empty`, as numpy) is uploaded through `upload` behind
    a device-side sleep and dropped; a buffer of the same size taken
    meanwhile must be another block, and the device copy must hold the
    first buffer's bytes."""
    from jsmpeg_tpu_torch.models.mpeg1 import pinned_empty, upload
    n = 1 << 20
    torch.cuda.synchronize()
    torch.cuda._sleep(HOLD_CYCLES)
    buf = pinned_empty(n)
    buf[:] = 0xA5
    addr = buf.__array_interface__['data'][0]
    dev = upload(buf, torch.device(DEVICE))
    del buf
    other = pinned_empty(n)
    other[:] = 0x5A
    held = other.__array_interface__['data'][0] != addr
    torch.cuda.synchronize()
    if not held or not bool((dev == 0xA5).all()):
        raise AssertionError('a pinned wire buffer was handed out again '
                             'before its upload completed')
    return True


def phase_single(torch, kernels, es: bytes):
    """decode() one picture at a time on the card vs the CPU."""
    from jsmpeg_tpu_torch.models.mpeg1 import MPEG1Decoder
    n = 5
    card, cpu = (MPEG1Decoder({'device': d}) for d in (DEVICE, 'cpu'))
    card.write(0.0, es)
    cpu.write(0.0, es)
    kernels.reset_launches()
    for i in range(n):
        a, b = card.decode(), cpu.decode()
        if a is None or b is None:
            raise AssertionError(f'decode() returned None at frame {i}')
        planes_equal(f'decode() frame {i}', host_planes(a), host_planes(b))
    emit('f_single_frame', frames=n, equal=True,
         launches=dict(kernels.launches))


def phase_serial(torch, kernels):
    """An escape-coded zero forces the serial path (premultiplied
    coefficients, K1 in its IDCT-only mode, then K2) on the card."""
    from jsmpeg_tpu_torch.models.mpeg1 import MPEG1Decoder
    from jsmpeg_tpu_torch.testing.quirks import escape_zero_stream
    es = escape_zero_stream(W, H)
    probe = MPEG1Decoder({'device': 'cpu'})
    probe.write(0.0, es)
    if probe.parser.parse_batch(BATCH, eof=True) != 'fallback':
        raise AssertionError('escape-zero stream did not force the '
                             'serial path')
    kernels.reset_launches()
    got = decode_all(torch, es, DEVICE)
    launches = dict(kernels.launches)
    forms = k1_forms_of('serial', kernels)
    want = decode_all(torch, es, 'cpu')
    if got is None or len(got) != 2 or len(want) != 2:
        raise AssertionError('serial path did not return both pictures')
    for i in range(2):
        planes_equal(f'serial frame {i}', host_planes(got[i]),
                     host_planes(want[i]))
    # premultiplied coefficients: no wire to unpack
    ran_or_raise('serial path', launches, KERNELS[:2])
    if launches['wire_unpack'] or forms['dequant_idct.premultiplied'] != \
            launches['dequant_idct']:
        raise AssertionError(f'serial path unpacked a wire or ran K1 '
                             f'other than premultiplied: {launches}, {forms}')
    emit('g_serial_fallback', frames=2, equal=True, launches=launches,
         k1_forms=forms)


def phase_dense(torch, kernels, chunks):
    """The dense-levels wire (a batch that overflows the packed pair cap,
    forced by a cap of 1 coefficient per block) on the card vs the CPU."""
    from jsmpeg_tpu_torch.models.mpeg1 import MPEG1Decoder
    es = b''.join(chunks[:N_DENSE])

    def dense_decoder(device):
        dec = MPEG1Decoder({'device': device})
        dec.parser.SPARSE_CAP_PER_BLOCK = 1
        dec.write(0.0, es)
        return dec

    if 'levels' not in dense_decoder('cpu').parser.parse_batch(BATCH,
                                                               eof=True):
        raise AssertionError('the pair cap did not force the dense wire')
    card, cpu = dense_decoder(DEVICE), dense_decoder('cpu')
    kernels.reset_launches()
    got = card.decode_available(eof=True)
    torch.cuda.synchronize()
    launches = dict(kernels.launches)
    forms = k1_forms_of('dense_levels', kernels)
    want = cpu.decode_available(eof=True)
    if len(got) != N_DENSE or len(want) != N_DENSE:
        raise AssertionError('dense-levels decode lost frames')
    for i in range(N_DENSE):
        planes_equal(f'dense-levels frame {i}', host_planes(got[i]),
                     host_planes(want[i]))
    # dense levels: no wire to unpack
    ran_or_raise('dense-levels path', launches, KERNELS[:2])
    if launches['wire_unpack'] or forms['dequant_idct.levels'] != \
            launches['dequant_idct']:
        raise AssertionError(f'dense-levels path unpacked a wire or ran K1 '
                             f'other than on levels: {launches}, {forms}')
    emit('g2_dense_levels', frames=N_DENSE, equal=True,
         launches=launches, k1_forms=forms)


def read_y4m(path: str, w: int = W, h: int = H):
    """(header, [(y, cr, cb)]) of a 4:2:0 y4m file."""
    with open(path, 'rb') as f:
        header, _, body = f.read().partition(b'\n')
    n_y, n_c = w * h, (w // 2) * (h // 2)
    frames = []
    for fr in body.split(b'FRAME\n')[1:]:
        a = np.frombuffer(fr, np.uint8)
        frames.append((a[:n_y].reshape(h, w),
                       a[n_y + n_c:].reshape(h // 2, w // 2),
                       a[n_y:n_y + n_c].reshape(h // 2, w // 2)))
    return header, frames


def frame_spans(chunks):
    """The video's TS cut per frame: span i carries frame i's PES (the
    last frame with the sequence end code), pts i / FPS."""
    from jsmpeg_tpu_torch.testing.ts_mux import TSMuxer
    mux, spans, prev = TSMuxer(), [], 0
    v = chunks[:-1]
    v[-1] = v[-1] + chunks[-1]
    for i, c in enumerate(v):
        mux.add_access_unit(0x100, 0xE0, c, i / FPS, bounded=False)
        ts = mux.getvalue()
        spans.append(ts[prev:])
        prev = len(ts)
    return spans


def frames_equal(name: str, got, want) -> None:
    if len(got) != len(want):
        raise AssertionError(f'{name}: {len(got)} frames, expected '
                             f'{len(want)}')
    for i, (a, b) in enumerate(zip(got, want)):
        planes_equal(f'{name} frame {i}', a, b)


def phase_player(torch, kernels, ts_av: bytes, cpu_frames):
    """`Player(ts, {'progressive': False}).decode_offline()` on the card
    with a VideoCollector and a PCMCollector: every frame equal to the CPU
    decoder's, the PCM equal to the same Player's on the CPU (audio only
    there: the exact audio path does not depend on the device), and K1/K2
    launched as often as the Player's own accounting says (one launch of
    each per batch of 32, plus one per decodeFirstFrame preview).  Then
    N_REPEATS warm runs, each one's frames held to the CPU's again.  The
    pipeline copies each batch back into fresh pinned host tensors and
    builds each wire in pinned memory, both from PyTorch's caching host
    allocator: a warm run's frames must lie at host addresses an earlier
    run's frames held (its collector dropped), so the equal frames cover
    pinned buffers handed out again; the wires' reuse is counted too."""
    from jsmpeg_tpu_torch.models import mpeg1
    from jsmpeg_tpu_torch.player import Player
    from jsmpeg_tpu_torch.sinks import PCMCollector, VideoCollector

    def run(device, **opts):
        vc, ac = VideoCollector(), PCMCollector()
        p = Player(ts_av, {'progressive': False, 'device': device, **opts},
                   renderer=vc, audio_out=ac)
        n = p.decode_offline()
        if device != 'cpu':
            torch.cuda.synchronize()
        return p, vc, ac, n

    kernels.reset_launches()
    p, vc, ac, (n_video, n_audio) = run(DEVICE)
    launches = dict(kernels.launches)
    PATH_LAUNCHES['player'] = launches
    if (n_video, n_audio) != (N_FRAMES, N_AUDIO):
        raise AssertionError(f'Player decoded {n_video} frames and '
                             f'{n_audio} audio frames')
    frames_equal('Player', vc.frames, cpu_frames)
    _, _, cpu_ac, (_, cpu_audio) = run('cpu', video=False)
    if cpu_audio != N_AUDIO or not np.array_equal(ac.pcm, cpu_ac.pcm):
        raise AssertionError('Player PCM on the card differs from the CPU')
    batched = p.metrics.counts['video_batch']
    previews = p.metrics.counts['video_decode']
    per_kernel = -(-batched // BATCH) + previews
    want = each(per_kernel)
    if launches != want or batched + previews != N_FRAMES:
        raise AssertionError(f'Player launches {launches}, expected {want} '
                             f'({batched} batched + {previews} previews)')
    # frame 0 is the decodeFirstFrame preview's pageable copy
    seen = {f[0].__array_interface__['data'][0] for f in vc.frames[1:]}
    del p, vc
    gc.collect()
    wires = []          # host address of every pinned wire buffer
    pinned_empty = mpeg1.pinned_empty

    def traced_empty(n):
        buf = pinned_empty(n)
        wires.append(buf.__array_interface__['data'][0])
        return buf

    reused_runs = 0
    mpeg1.pinned_empty = traced_empty
    try:
        for r in range(N_REPEATS):
            q, wvc, _, _ = run(DEVICE)
            frames_equal(f'Player warm run {r}', wvc.frames, cpu_frames)
            addrs = {f[0].__array_interface__['data'][0]
                     for f in wvc.frames[1:]}
            reused_runs += bool(addrs & seen)
            seen |= addrs
            # the run's pinned frames go back to the cache (the Player
            # holds its sinks in reference cycles)
            del q, wvc
            gc.collect()
    finally:
        mpeg1.pinned_empty = pinned_empty
    if not reused_runs:
        raise AssertionError('no warm Player run reused an earlier run\'s '
                             'pinned host buffers: the frame check does '
                             'not cover a reused buffer')
    emit('i_player_offline', frames=n_video, audio_frames=n_audio,
         cpu_equal_frames=N_FRAMES, pcm_equal_cpu=True, launches=launches,
         batched_frames=batched, preview_frames=previews,
         warm_runs_equal_cpu=N_REPEATS, warm_runs_reusing_pinned=reused_runs,
         pinned_wires=len(wires), pinned_wires_reused=len(wires)
         - len(set(wires)))
    return ac.pcm


def phase_audio(torch, audio_es: bytes, pcm_exact):
    """`MP2Decoder(mode='device')` on the card over the N_AUDIO frames,
    once through decode_available and once frame by frame: within 3e-5
    of the exact PCM (the Player's, held to the CPU above) and the batch
    within 1e-7 of the frame-by-frame decode.  ms per batch of the whole
    decode_available (parse + synthesis) for the device mode on the card
    and the exact mode on the host, medians of N_REPEATS, and the device
    synthesis alone."""
    from jsmpeg_tpu_torch.models.mp2 import MP2Decoder
    from jsmpeg_tpu_torch.ops.mp2_synth import synthesize_device

    def batch(mode):
        opts = {'device': DEVICE} if mode == 'device' else {}
        dec = MP2Decoder(opts, mode=mode)
        dec.write(0.0, audio_es)
        t0 = time.monotonic()
        out = dec.decode_available()
        return out, (time.monotonic() - t0) * 1e3

    got, _ = batch('device')
    step = MP2Decoder({'device': DEVICE}, mode='device')
    step.write(0.0, audio_es)
    stepped = []
    while (f := step.decode()) is not None:
        stepped.append(np.stack(f))
    want = pcm_exact.reshape(2, N_AUDIO, 1152).transpose(1, 0, 2)
    if got.shape != (N_AUDIO, 2, 1152) or len(stepped) != N_AUDIO:
        raise AssertionError(f'device audio shape {got.shape}, '
                             f'{len(stepped)} frames stepped')
    err = float(np.abs(got - want).max())
    step_err = float(np.abs(got - np.stack(stepped)).max())
    if not err <= 3e-5 or not step_err <= 1e-7:
        raise AssertionError(f'device audio: max |err| {err} vs exact '
                             f'(bound 3e-5), {step_err} batch vs step '
                             f'(bound 1e-7)')
    dev_ms = [batch('device')[1] for _ in range(N_REPEATS)]
    exact_ms = [batch('exact')[1] for _ in range(N_REPEATS)]
    from jsmpeg_tpu_torch.host.native import NativeMP2Parser
    parser = NativeMP2Parser()
    parser.write(audio_es)
    samples = torch.as_tensor(np.concatenate(
        [parser.parse_frame().samples for _ in range(N_AUDIO)]),
        device=DEVICE)
    hist = torch.zeros((15, 2, 64), dtype=torch.float32, device=DEVICE)
    synth_ms = cuda_ms(torch, lambda: synthesize_device(samples, hist, 0),
                       iters=20)
    emit('j_audio_device', frames=N_AUDIO, max_abs_err_vs_exact=err,
         max_abs_err_batch_vs_step=step_err,
         device_batch_ms_median=float(np.median(dev_ms)),
         exact_host_batch_ms_median=float(np.median(exact_ms)),
         device_batch_ms=dev_ms, exact_host_batch_ms=exact_ms,
         device_synthesis_ms=synth_ms)


def phase_color(torch, cpu_frames):
    """ycbcr_to_rgb_int on the card equal to the CPU bit for bit, and
    ycbcr_to_rgb_rec601 within 1, on a 720p frame of the stream; ms per
    frame of each on the card."""
    from jsmpeg_tpu_torch.ops.color import (ycbcr_to_rgb_int,
                                            ycbcr_to_rgb_rec601)
    frame = cpu_frames[N_FRAMES // 2 + 1]
    cpu = [torch.as_tensor(x) for x in frame]
    card = [x.to(DEVICE) for x in cpu]
    out = {}
    for name, fn in (('int', ycbcr_to_rgb_int),
                     ('rec601', ycbcr_to_rgb_rec601)):
        got = fn(*card, W, H)
        want = fn(*cpu, W, H)
        if got.shape != (H, W, 3) or got.dtype != torch.uint8:
            raise AssertionError(f'colour {name}: {got.dtype}{got.shape}')
        err = int((got.cpu().int() - want.int()).abs().max())
        if err > (0 if name == 'int' else 1):
            raise AssertionError(f'colour {name}: max |err| {err}')
        out[f'{name}_max_abs_err'] = err
        out[f'{name}_ms'] = cuda_ms(torch, lambda: fn(*card, W, H),
                                    iters=50)
    emit('k_color', frame=[H, W], **out)


def phase_cli(torch, ts_av: bytes, cpu_frames, pcm_exact):
    """`python -m jsmpeg_tpu_torch clip.ts -o out.y4m --wav out.wav
    --stats --offline` as a subprocess on the card: exit 0, 96 frames,
    K1/K2 launched as its own accounting says, every y4m frame equal to
    the CPU frames, the WAV equal to WavWriter's int16 of the exact PCM;
    then `--selftest` exits 0 and names the card."""
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as d:
        clip, y4m, wav = (os.path.join(d, n)
                          for n in ('clip.ts', 'out.y4m', 'out.wav'))
        with open(clip, 'wb') as f:
            f.write(ts_av)
        t0 = time.monotonic()
        r = subprocess.run([sys.executable, '-m', 'jsmpeg_tpu_torch', clip,
                            '-o', y4m, '--wav', wav, '--stats', '--offline'],
                           cwd=root, capture_output=True, text=True,
                           timeout=300)
        cli_s = time.monotonic() - t0
        if r.returncode != 0:
            raise AssertionError(f'CLI exit {r.returncode}: {r.stderr[-2000:]}')
        stats = json.loads(r.stdout.strip().splitlines()[-1])
        # the CLI process counts its own launches: one of each kernel per
        # batch of 32, plus one per decodeFirstFrame preview
        stages = stats['stages']
        batched = stages['video_batch']['count']
        previews = stages.get('video_decode', {}).get('count', 0)
        per_kernel = -(-batched // BATCH) + previews
        if (stats['video_frames'] != N_FRAMES
                or batched + previews != N_FRAMES
                or stats['kernel_launches'] != each(per_kernel)):
            raise AssertionError(f'CLI stats {stats}')
        header, got = read_y4m(y4m)
        frames_equal('CLI y4m', got, cpu_frames)
        import wave
        with wave.open(wav) as w:
            shape = (w.getnchannels(), w.getnframes())
            pcm16 = np.frombuffer(w.readframes(w.getnframes()), '<i2')
        want = np.clip(np.round(pcm_exact.T * 32767.0), -32768,
                       32767).astype('<i2').reshape(-1)
        if shape != (2, N_AUDIO * 1152) or not np.array_equal(pcm16, want):
            raise AssertionError(f'CLI wav {shape} differs from the exact '
                                 'PCM')
    t0 = time.monotonic()
    r = subprocess.run([sys.executable, '-m', 'jsmpeg_tpu_torch',
                        '--selftest'], cwd=root, capture_output=True,
                       text=True, timeout=300)
    selftest_s = time.monotonic() - t0
    name = torch.cuda.get_device_name(0)
    if r.returncode != 0 or name not in r.stdout:
        raise AssertionError(f'--selftest exit {r.returncode}: {r.stdout} '
                             f'{r.stderr[-2000:]}')
    emit('l_cli', header=header.decode(), y4m_frames=len(got),
         cpu_equal_frames=N_FRAMES, wav_samples=N_AUDIO * 1152,
         wav_equal_exact=True, stats=stats, cli_s=cli_s,
         selftest=json.loads(r.stdout.strip().splitlines()[-1]),
         selftest_s=selftest_s)


def phase_live(torch, kernels, chunks, cpu_frames):
    """A streaming Player on a PushSource at 720p, video only: each
    frame's TS is pushed in chunks of 7 packets at the stream's 30 fps
    pace and the Player ticks in between.  A picture becomes decodable
    when the next one's bytes arrive (the last with the sequence end
    code).  Every frame is held to the CPU frames."""
    from jsmpeg_tpu_torch.player import Player
    from jsmpeg_tpu_torch.sinks import VideoCollector
    from jsmpeg_tpu_torch.sources import PushSource

    spans = frame_spans(chunks)
    src, sink = PushSource(), VideoCollector()
    p = Player(src, {'audio': False, 'device': DEVICE}, renderer=sink)
    p.play()
    kernels.reset_launches()
    t_start = time.monotonic()
    for i, span in enumerate(spans):
        last = i == len(spans) - 1
        # pace: frame i's bytes go out at i / FPS; between frames the
        # Player ticks until the frame the span completes is out
        pause = t_start + i / FPS - time.monotonic()
        if pause > 0:
            time.sleep(pause)
        for j in range(0, len(span), 7 * 188):
            src.write(span[j:j + 7 * 188])
            p.tick()
        if last:
            # the end of the stream: a PES whose last TS packet is full
            # completes only at the next payload start, so flush it
            p.demuxer.flush()
        ready, until = ((N_FRAMES, time.monotonic() + 2.0) if last
                        else (i, t_start + (i + 1) / FPS))
        while sink.frames_rendered < ready and time.monotonic() < until:
            p.tick()
    launches = dict(kernels.launches)
    PATH_LAUNCHES['live'] = launches
    p.destroy()
    frames_equal('live', sink.frames, cpu_frames)
    ran_or_raise('live path', launches)
    emit('m_live', frames=len(sink.frames), cpu_equal_frames=N_FRAMES,
         chunk_bytes=7 * 188, pace_fps=FPS, launches=launches)


def phase_sparse_wire(torch, kernels, es: bytes, cpu_frames):
    """The sparse wire on the card: the stream's first 32 frames parsed
    as global (index, value) pairs (`parse_batch(packed=False)`) and
    decoded by `MPEG1Decoder._decode_batch` (the pairs scattered into the
    levels on the device, then K1 and K2 once each), every frame equal to
    the CPU frames.  Reports both wires' upload bytes for the batch."""
    from jsmpeg_tpu_torch.models.mpeg1 import MPEG1Decoder, build_fused_buffer
    dec = MPEG1Decoder({'device': DEVICE})
    dec.write(0.0, es)
    batch = dec.parser.parse_batch(BATCH, eof=True, packed=False)
    if not isinstance(batch, dict) or 'sp_idx' not in batch \
            or batch['n'] != BATCH:
        raise AssertionError('the first batch did not take the sparse wire')
    kernels.reset_launches()
    got = dec._decode_batch(batch)
    torch.cuda.synchronize()
    launches = dict(kernels.launches)
    PATH_LAUNCHES['sparse_wire'] = launches
    forms = k1_forms_of('sparse_wire', kernels)
    frames_equal('sparse wire', [host_planes(p) for p in got],
                 cpu_frames[:BATCH])
    # the sparse wire's scatter is plain torch: no K3, a dense lattice
    if launches != each(1, unpacks=0) or forms['dequant_idct.levels'] != 1:
        raise AssertionError(f'sparse-wire launches {launches}, {forms}')
    packed = MPEG1Decoder({'device': 'cpu'})
    packed.write(0.0, es)
    pbuf = build_fused_buffer(packed.parser.parse_batch(BATCH, eof=True),
                              packed.parser.seq.mb_size)[0]
    meta = sum(batch[k][:BATCH].nbytes for k in ('qscale', 'coded', 'intra',
                                                  'written', 'mv'))
    emit('n_sparse_wire', frames=BATCH, cpu_equal_frames=BATCH,
         launches=launches, pairs=len(batch['sp_idx']),
         sparse_upload_bytes=batch['sp_idx'].nbytes
         + batch['sp_val'].nbytes + meta,
         packed_upload_bytes=int(pbuf.nbytes))


def encode_extra_streams(torch):
    """Streams 1-3 of the fleet: 720p, unequal lengths (MS_FRAMES), each
    with its TS (cut per frame for the live push) and its frames decoded
    on the CPU."""
    from jsmpeg_tpu_torch.testing.gen import encode_realistic_stream
    out = []
    for n, seed in zip(MS_FRAMES, MS_SEEDS):
        es, chunks = encode_realistic_stream(W, H, n_frames=n, seed=seed,
                                             gop=GOP)
        spans = frame_spans(chunks)
        ref = decode_all(torch, es, 'cpu')
        out.append({'es': es, 'spans': spans, 'ts': b''.join(spans),
                    'cpu_frames': [host_planes(p) for p in ref]})
    return out


def fleet_run(torch, streams, mode: str):
    """One `decode_streams_offline(batch_frames=BATCH)` call on the card,
    outputs resident and fenced by synchronize; returns the frames."""
    from jsmpeg_tpu_torch.parallel.streams import decode_streams_offline
    frames = decode_streams_offline(streams, batch_frames=BATCH, mode=mode,
                                    device=DEVICE)
    torch.cuda.synchronize()
    return frames


def fleet_launches(mode: str, lengths) -> int:
    """Launches of each kernel for a fleet: one per stream batch
    (roundrobin) or one per round (the joint modes)."""
    if mode == 'roundrobin':
        return sum(-(-n // BATCH) for n in lengths)
    return -(-max(lengths) // BATCH)


def phase_multistream(torch, kernels, es: bytes, cpu_frames, extra):
    """Four 720p streams of 96 / 40 / 32 / 20 frames through
    `decode_streams_offline(batch_frames=32)` on the card in each mode:
    roundrobin (each stream's batch in turn, one K1 and one K2 launch
    each: 7 of each kernel for rounds of 4, 3 and 1 streams), stacked and
    vmap (one launch pair per round over the four streams as segments:
    3 of each).  Every frame of every stream equal to its CPU decode in
    every mode."""
    streams = [es] + [x['es'] for x in extra]
    wants = [cpu_frames] + [x['cpu_frames'] for x in extra]
    lengths = [len(w) for w in wants]
    total = sum(lengths)
    out = {}
    for mode in FLEET_MODES:
        kernels.reset_launches()
        frames = fleet_run(torch, streams, mode)
        launches = dict(kernels.launches)
        PATH_LAUNCHES['multistream' if mode == 'roundrobin'
                      else f'multistream_{mode}'] = launches
        for i, (got, want) in enumerate(zip(frames, wants)):
            frames_equal(f'multistream {mode} stream {i}',
                         [host_planes(p) for p in got], want)
        n = fleet_launches(mode, lengths)
        if launches != each(n):
            raise AssertionError(f'multistream {mode} launches {launches}, '
                                 f'expected {n} of each')
        del frames
        out[mode] = {'launches': launches, 'cpu_equal_frames': total}
    emit('o_multistream', streams=len(streams), frames=lengths,
         rounds=-(-max(lengths) // BATCH), modes=out)


def phase_fleet_sweep(torch, kernels, es: bytes, cpu_frames):
    """S = 1, 2 and 4 copies of the main 96-frame stream through each
    mode: the launches of each (roundrobin 3 * S, the joint modes 3) and
    each copy's frame count and last frame against the CPU frames."""
    out = {}
    for s in SWEEP_S:
        streams = [es] * s
        row = {}
        for mode in FLEET_MODES:
            kernels.reset_launches()
            frames = fleet_run(torch, streams, mode)
            launches = dict(kernels.launches)
            n = fleet_launches(mode, [N_FRAMES] * s)
            if launches != each(n):
                raise AssertionError(f'sweep S={s} {mode} launches '
                                     f'{launches}, expected {n} of each')
            for i, got in enumerate(frames):
                if len(got) != N_FRAMES:
                    raise AssertionError(f'sweep S={s} {mode} stream {i}: '
                                         f'{len(got)} frames')
                planes_equal(f'sweep S={s} {mode} stream {i} last frame',
                             host_planes(got[-1]), cpu_frames[-1])
            del frames
            row[mode] = {'launches': launches}
        out[str(s)] = row
    emit('o2_fleet_sweep', copies_of_main_stream=list(SWEEP_S), by_s=out)


def phase_serve(torch, kernels, ts_av: bytes, extra, cpu_frames, pcm_exact):
    """`serve()` on three 720p feeds at once: stream 0's A/V TS as a
    static file (with its wav), stream 1's TS as a static file, and
    stream 2's TS pushed over a local TCP socket at FPS frames per
    second in 1316-byte chunks by a thread.  Every y4m equal to the CPU
    frames and the wav to the exact PCM."""
    import socket
    from jsmpeg_tpu_torch.serve import serve
    push = extra[1]
    srv = socket.socket()
    srv.bind(('127.0.0.1', 0))
    srv.listen(1)
    port = srv.getsockname()[1]
    done, stop = threading.Event(), threading.Event()
    pushed = {}

    def run_feed():
        conn, _ = srv.accept()
        t0 = time.monotonic()
        for i, span in enumerate(push['spans']):
            pause = t0 + i / FPS - time.monotonic()
            if pause > 0:
                time.sleep(pause)
            for j in range(0, len(span), 7 * 188):
                conn.sendall(span[j:j + 7 * 188])
        pushed['s'] = time.monotonic() - t0
        done.set()
        stop.wait(30)        # a live feed stays open; serve() ends it
        conn.close()
        srv.close()

    feed = threading.Thread(target=run_feed, daemon=True)
    feed.start()
    with tempfile.TemporaryDirectory() as d:
        s0, s1 = os.path.join(d, 's0.ts'), os.path.join(d, 's1.ts')
        with open(s0, 'wb') as f:
            f.write(ts_av)
        with open(s1, 'wb') as f:
            f.write(extra[0]['ts'])
        kernels.reset_launches()
        try:
            stats = serve([s0, s1, f'tcp://127.0.0.1:{port}'],
                          out_pattern=os.path.join(d, 'v%d.y4m'),
                          wav_pattern=os.path.join(d, 'a%d.wav'),
                          interval=0.01,
                          seconds=len(push['spans']) / FPS + 3.0,
                          stats_out=io.StringIO(), device=DEVICE)
        finally:
            stop.set()
            feed.join(timeout=10)
        launches = dict(kernels.launches)
        PATH_LAUNCHES['serve'] = launches
        if not done.is_set():
            raise AssertionError('the TCP feed did not finish')
        wants = [cpu_frames, extra[0]['cpu_frames'], push['cpu_frames']]
        if stats['video_frames'] != [len(w) for w in wants] \
                or stats['dead']:
            raise AssertionError(f'serve stats {stats}')
        for i, want in enumerate(wants):
            frames_equal(f'serve y4m {i}',
                         read_y4m(os.path.join(d, f'v{i}.y4m'))[1], want)
        import wave
        with wave.open(os.path.join(d, 'a0.wav')) as w:
            pcm16 = np.frombuffer(w.readframes(w.getnframes()), '<i2')
        want16 = np.clip(np.round(pcm_exact.T * 32767.0), -32768,
                         32767).astype('<i2').reshape(-1)
        if not np.array_equal(pcm16, want16):
            raise AssertionError('serve wav differs from the exact PCM')
        # the two static files again in the stacked mode: one launch pair
        # per round of batch 8, at least the 12 of the 96-frame file
        kernels.reset_launches()
        stacked = serve([s0, s1], out_pattern=os.path.join(d, 'st%d.y4m'),
                        interval=0.01, mode='stacked',
                        stats_out=io.StringIO(), device=DEVICE)
        stacked_launches = dict(kernels.launches)
        PATH_LAUNCHES['serve_stacked'] = stacked_launches
        if stacked['video_frames'] != [len(w) for w in wants[:2]] \
                or stacked['dead'] \
                or stacked_launches['mc_combine'] < -(-N_FRAMES // 8) \
                or len(set(stacked_launches.values())) != 1:
            raise AssertionError(f'stacked serve stats {stacked}, '
                                 f'launches {stacked_launches}')
        for i, want in enumerate(wants[:2]):
            frames_equal(f'stacked serve y4m {i}',
                         read_y4m(os.path.join(d, f'st{i}.y4m'))[1], want)
    ran_or_raise('serve', launches)
    emit('p_serve', feeds=['file A/V', 'file', 'tcp 30 fps'],
         cpu_equal_frames=sum(len(w) for w in wants),
         wav_equal_exact=True, launches=launches, tcp_push_s=pushed['s'],
         stats=stats, stacked={'feeds': ['file A/V', 'file'],
                               'cpu_equal_frames': sum(
                                   len(w) for w in wants[:2]),
                               'launches': stacked_launches,
                               'stats': stacked})


def phase_cli_multi(torch, ts_av: bytes, extra, cpu_frames):
    """`python -m jsmpeg_tpu_torch s0.ts s1.ts -o m%d.y4m` as a
    subprocess on the card: both y4m files equal to the CPU frames and
    the process's own launch counts one of each kernel per stream
    batch."""
    root = os.path.dirname(os.path.abspath(__file__))
    wants = [cpu_frames, extra[0]['cpu_frames']]
    with tempfile.TemporaryDirectory() as d:
        paths = [os.path.join(d, f's{i}.ts') for i in range(2)]
        for path, data in zip(paths, (ts_av, extra[0]['ts'])):
            with open(path, 'wb') as f:
                f.write(data)
        t0 = time.monotonic()
        r = subprocess.run([sys.executable, '-m', 'jsmpeg_tpu_torch', *paths,
                            '-o', os.path.join(d, 'm%d.y4m')], cwd=root,
                           capture_output=True, text=True, timeout=300)
        cli_s = time.monotonic() - t0
        if r.returncode != 0:
            raise AssertionError(f'multi-input CLI exit {r.returncode}: '
                                 f'{r.stderr[-2000:]}')
        stats = json.loads(r.stdout.strip().splitlines()[-1])
        n = sum(-(-len(w) // BATCH) for w in wants)
        if (stats['video_frames'] != [len(w) for w in wants]
                or stats['kernel_launches'] != each(n)):
            raise AssertionError(f'multi-input CLI stats {stats}')
        for i, want in enumerate(wants):
            frames_equal(f'multi-input CLI y4m {i}',
                         read_y4m(os.path.join(d, f'm{i}.y4m'))[1], want)
    PATH_LAUNCHES['cli_multi'] = stats['kernel_launches']
    emit('q_cli_multi', cpu_equal_frames=sum(len(w) for w in wants),
         stats=stats, cli_s=cli_s)


def read_png(path: str) -> np.ndarray:
    """RGB [h, w, 3] of a PNG as sinks.write_image writes it (8-bit RGB,
    one IDAT, filter 0 on every row)."""
    import struct
    import zlib
    with open(path, 'rb') as f:
        data = f.read()
    pos, idat, w, h = 8, b'', 0, 0
    while pos < len(data):
        n, tag = struct.unpack('>I4s', data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if tag == b'IHDR':
            w, h = struct.unpack('>II', body[:8])
        elif tag == b'IDAT':
            idat += body
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, -1)
    if raw[:, 0].any():
        raise AssertionError(f'{path}: a row filter other than 0')
    return raw[:, 1:].reshape(h, w, 3)


def phase_thumbs(torch, kernels, es: bytes, ts_av: bytes, cpu_frames):
    """`extract_iframe_planes` on the main stream on the card: its 8 I
    pictures (frames 0, 12, ..., 84) in one batch, one K1 and one K2
    launch, equal to the CPU frames; thumbnails per second from
    N_REPEATS warm runs.  Then `python -m jsmpeg_tpu_torch.thumbs` once:
    8 PNGs, the first and the last equal to the colour conversion of the
    CPU frames."""
    from jsmpeg_tpu_torch.ops.color import ycbcr_to_rgb_int
    from jsmpeg_tpu_torch.thumbs import extract_iframe_planes
    at = list(range(0, N_FRAMES, GOP))
    kernels.reset_launches()
    _, thumbs = extract_iframe_planes(es, device=DEVICE)
    torch.cuda.synchronize()
    launches = dict(kernels.launches)
    PATH_LAUNCHES['thumbs'] = launches
    frames_equal('thumbnails', [host_planes(p) for p in thumbs],
                 [cpu_frames[k] for k in at])
    if launches != each(1):
        raise AssertionError(f'thumbnail launches {launches}')
    walls = []
    for _ in range(N_REPEATS):
        t0 = time.monotonic()
        again = extract_iframe_planes(es, device=DEVICE)[1]
        torch.cuda.synchronize()
        walls.append(time.monotonic() - t0)
        del again
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as d:
        clip = os.path.join(d, 'clip.ts')
        with open(clip, 'wb') as f:
            f.write(ts_av)
        t0 = time.monotonic()
        r = subprocess.run([sys.executable, '-m', 'jsmpeg_tpu_torch.thumbs',
                            clip, '-o', os.path.join(d, 't_%02d.png')],
                           cwd=root, capture_output=True, text=True,
                           timeout=300)
        cli_s = time.monotonic() - t0
        if r.returncode != 0:
            raise AssertionError(f'thumbs CLI exit {r.returncode}: '
                                 f'{r.stderr[-2000:]}')
        pngs = sorted(n for n in os.listdir(d) if n.endswith('.png'))
        if len(pngs) != len(at):
            raise AssertionError(f'thumbs CLI wrote {pngs}')
        for i in (0, len(at) - 1):
            want = ycbcr_to_rgb_int(*[torch.as_tensor(x) for x in
                                      cpu_frames[at[i]]], W, H).numpy()
            if not np.array_equal(read_png(os.path.join(d, pngs[i])),
                                  want):
                raise AssertionError(f'thumbnail PNG {i} differs')
    emit('r_thumbs', thumbnails=len(thumbs), at_frames=at,
         cpu_equal_frames=len(at), launches=launches, repeat_wall_s=walls,
         thumbs_per_s_median=len(at) / float(np.median(walls)),
         cli_s=cli_s, cli_stdout=r.stdout.strip(), png_equal=[0, len(at) - 1])


def phase_fuzz(torch, kernels):
    """A 352x240 (SIF) 24-frame A/V TS, decoded on the card and on the
    CPU through TSDemuxer + MPEG1Decoder.decode_available(eof=True): 16
    copies with 30 random bytes flipped each, 4 truncations and one with
    garbage prepended.  Each pair must agree on the frame count and
    every frame, and neither side may raise: garbage vectors, levels and
    headers reach K1 and K2."""
    from jsmpeg_tpu_torch.demux import TSDemuxer
    from jsmpeg_tpu_torch.models.mpeg1 import MPEG1Decoder
    from jsmpeg_tpu_torch.testing.gen import encode_test_stream
    from jsmpeg_tpu_torch.testing.mp2_enc import encode_stream as mp2_stream
    from jsmpeg_tpu_torch.testing.ts_mux import mux_av
    _, chunks = encode_test_stream(352, 240, n_frames=24, seed=SEED + 20,
                                   gop=12)
    v = chunks[:-1]
    v[-1] = v[-1] + chunks[-1]
    _, af = mp2_stream(30, seed=SEED + 21)
    ts = mux_av(v, 25.0, af, 1152, 44100)
    rng = np.random.default_rng(SEED + 22)
    variants = []
    for _ in range(16):
        b = bytearray(ts)
        for _ in range(30):
            b[int(rng.integers(0, len(b)))] ^= int(rng.integers(1, 256))
        variants.append(('flip', bytes(b)))
    for frac in (0.07, 0.33, 0.61, 0.94):
        variants.append(('truncate', ts[:int(len(ts) * frac)]))
    variants.append(('garbage', rng.integers(0, 256, 3777, dtype=np.uint8)
                     .tobytes() + ts))

    def decode(data, device):
        dem, dec = TSDemuxer(), MPEG1Decoder({'device': device})
        dem.connect(0xE0, dec)
        dem.write(data)
        outs = dec.decode_available(eof=True)
        return [host_planes(p) for p in outs] if outs is not None else []

    kernels.reset_launches()
    counts = []
    for kind, data in variants:
        got = decode(data, DEVICE)
        want = decode(data, 'cpu')
        frames_equal(f'fuzz {kind} variant {len(counts)}', got, want)
        counts.append(len(got))
    launches = dict(kernels.launches)
    PATH_LAUNCHES['fuzz'] = launches
    ran_or_raise('fuzz', launches)
    emit('s_fuzz', variants=[k for k, _ in variants], frames=counts,
         cpu_equal_frames=sum(counts), launches=launches, ts_bytes=len(ts))


def phase_soak(torch, kernels):
    """The robustness soak (`jsmpeg_tpu_torch.fuzz_soak.main`) on the
    card for SOAK_SECONDS from SOAK_SEED: random geometries (48x48 up,
    f_code 1-4, full-pel vectors, GOPs of 1-4) corrupted through the
    demuxer and decoders, the clean differential, fleet, mesh and
    elastic rounds, every decode held to the CPU.  Fails on any failed
    round (its reproducer lines in the message), on a kind of round that
    never completed (a mesh round completes only when it compared a
    decode; `rounds` also counts the mesh decodes compared and refused by
    policy), or when K1, K2 or K3 was not launched."""
    from jsmpeg_tpu_torch import fuzz_soak
    stats = {}
    with tempfile.TemporaryDirectory() as tmp:
        log = os.path.join(tmp, 'soak.jsonl')
        kernels.reset_launches()
        rc = fuzz_soak.main(['--seconds', str(SOAK_SECONDS), '--seed',
                             str(SOAK_SEED), '--log', log, '--device',
                             DEVICE], stats)
        launches = dict(kernels.launches)
        if rc != 0 or stats['failures']:
            with open(log) as f:
                raise AssertionError(f'soak: {stats["failures"]} failed '
                                     f'rounds:\n{f.read()[-6000:]}')
    PATH_LAUNCHES['soak'] = launches
    ran_or_raise('soak', launches)
    idle = [k for k in fuzz_soak.ROUNDS if not stats['rounds'][k]]
    if idle:
        raise AssertionError(f'soak: no {idle} round completed in '
                             f'{stats["iterations"]} iterations')
    emit('s1_soak', iterations=stats['iterations'],
         failures=stats['failures'], rounds=stats['rounds'],
         seconds=stats['seconds'], seed=stats['seed'], launches=launches,
         cpu_equal=True)


def phase_checked(torch):
    """The checked build of K1-K3 (`python -m jsmpeg_tpu_torch.host.
    native.sanitize_check --checked`, a process of its own: it binds the
    checked library, which this process must not load), capped at
    CHECKED_CAP_S: bounds-checked accesses, shared-memory hazards, K2's
    waits and publishes, K3's look-back, outputs poisoned two ways,
    perturbed schedules, the main stream, d_k2_check's and d_k3_check's
    cases, the soak for CHECKED_SOAK_SECONDS and the seven negative
    controls.  Emits the rig's summary; fails on its non-zero exit, on
    a kernel form with no checked launch, or on fewer than
    CHECKED_MIN_ITERATIONS in-process soak iterations."""
    gc.collect()
    torch.cuda.empty_cache()     # the rig's process needs the card's memory
    t0 = time.monotonic()
    r = subprocess.run(
        [sys.executable, '-m', 'jsmpeg_tpu_torch.host.native.sanitize_check',
         '--checked', '--seconds', str(CHECKED_SOAK_SECONDS)],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
        text=True, timeout=CHECKED_CAP_S)
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith('{')]
    if not lines:
        raise AssertionError(f'checked rig: exit {r.returncode}, no result:'
                             f'\n{r.stdout[-3000:]}\n{r.stderr[-3000:]}')
    res = json.loads(lines[-1])['checked']
    keep = ('faults', 'hazards', 'flag_faults', 'unwritten',
            'perturbed_mismatches', 'mismatches', 'reports', 'cases',
            'checked_launches', 'injections_reported', 'build_s',
            'checked_ms', 'product_ms', 'slowdown', 'missing_forms')
    emit('s2_checked', **{k: res.get(k) for k in keep},
         main_path=res['main_path'], soak=res['soak'],
         injections={k: {f: v.get(f) for f in ('what', 'kind', 'where',
                                               'function', 'reported')}
                     for k, v in res['injections'].items()},
         rig_s=time.monotonic() - t0, rc=r.returncode)
    if r.returncode != 0 or not res['ok']:
        raise AssertionError(f'checked rig: exit {r.returncode}: '
                             f'{r.stderr[-3000:]}')
    idle = [f for f, n in res['checked_launches'].items() if not n]
    if idle:
        raise AssertionError(f'checked rig: no checked launch of {idle}')
    if res['soak']['in_process_iterations'] < CHECKED_MIN_ITERATIONS:
        raise AssertionError(f'checked rig: {res["soak"]} has fewer than '
                             f'{CHECKED_MIN_ITERATIONS} in-process soak '
                             f'iterations')


def phase_gop_mesh(torch, kernels, es: bytes, ts_av: bytes, extra,
                   cpu_frames):
    """The GOP mesh on the card (parallel/mesh.py, parallel/packed.py),
    every frame held to the CPU frames, each path's launches counted
    from 0:
    1. `decode_packed_mesh(es, make_mesh(8))`: the 96 frames as 8 GOPs
       of 12, the segments of ONE K1 and ONE K2 launch (12 serial frame
       steps in place of 96).  That launch pair's K1 and K2 timed with
       cuda_ms, its K2 output held to decode_frames_ref; the warm median
       of N_REPEATS decodes.
    2. `MPEG1Decoder.decode_available(mesh=make_mesh(1))`: a flush every
       32 frames, the second and third beginning inside a GOP.
    3. `Player(ts_av, {'mesh': '8', 'audio': False}).decode_offline()`:
       the decodeFirstFrame preview (if any), then one flush; its video
       rate beside the same Player's without the mesh, in turns.
    4. `decode_streams_mesh` on the fleet's four streams over '4x2' (the
       tile cells merge on the one card): their 17 GOPs in one launch
       pair.
    5. `python -m jsmpeg_tpu_torch main.ts --offline --mesh 8 --no-audio
       -o out.y4m --stats` as a subprocess."""
    from jsmpeg_tpu_torch.models.mpeg1 import MPEG1Decoder
    from jsmpeg_tpu_torch.ops.frame import decode_frames_ref, frame_meta
    from jsmpeg_tpu_torch.parallel import streams as fleet
    from jsmpeg_tpu_torch.parallel.mesh import make_mesh, resolve_mesh
    from jsmpeg_tpu_torch.parallel.packed import decode_packed_mesh
    from jsmpeg_tpu_torch.player import Player
    from jsmpeg_tpu_torch.sinks import VideoCollector
    out = {}

    def counted(name, fn, want):
        """fn() with the launches counted from 0; `want` launches of each
        kernel or the phase fails.  Returns (fn's result, wall s)."""
        kernels.reset_launches()
        t0 = time.monotonic()
        r = fn()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = dict(kernels.launches)
        PATH_LAUNCHES[name] = launches
        if launches != each(want):
            raise AssertionError(f'{name} launches {launches}, expected '
                                 f'{want} of each')
        return r, wall

    def median_wall(fn):
        walls = []
        for _ in range(N_REPEATS):
            t0 = time.monotonic()
            r = fn()
            torch.cuda.synchronize()
            walls.append(time.monotonic() - t0)
            del r
        return walls

    # 1. the main stream as 8 GOP segments; the launch's inputs captured
    mesh8 = make_mesh(8, device=DEVICE)
    captured, real = [], fleet.decode_levels

    def capture(cur, fwd, la, iq, nq, **kw):
        captured.append((cur, fwd, la, iq, nq, kw))
        return real(cur, fwd, la, iq, nq, **kw)

    fleet.decode_levels = capture
    try:
        frames, wall = counted('gop_mesh',
                               lambda: decode_packed_mesh(es, mesh8), 1)
    finally:
        fleet.decode_levels = real
    frames_equal('gop mesh', [host_planes(p) for p in frames], cpu_frames)
    del frames
    segs = [(c[5]['n_seg'], list(c[5]['seg_frames'])) for c in captured]
    if segs != [(N_FRAMES // GOP, [GOP] * (N_FRAMES // GOP))]:
        raise AssertionError(f'gop mesh segments {segs}')
    walls = median_wall(lambda: decode_packed_mesh(es, mesh8))
    cur, fwd, la, iq, nq, kw = captured[0]
    del captured

    # K1's compact form, the packed paths'
    F, n_mb = la.qscale.shape
    args = k1_compact_args(torch, la, iq, nq)
    resid = k1_compact_check(torch, kernels, args, 'gop mesh').reshape(
        F, n_mb, 6, 64)
    meta = frame_meta(la.coded, la.intra, la.written, la.mv_h, la.mv_v)
    k2 = (cur, fwd, resid, meta, kw['n_seg'], kw['seg_frames'])
    k2_err = max(equal_or_raise(f'K2 gop mesh {pn}', g, w_) for pn, g, w_ in
                 zip(('y', 'cr', 'cb'), kernels.mc_combine_cuda(*k2),
                     decode_frames_ref(*k2)))
    k1_mesh = cuda_ms(torch, lambda: kernels.dequant_idct_compact_cuda(
        *args), iters=20)
    k2_mesh = cuda_ms(torch, lambda: kernels.mc_combine_cuda(*k2), iters=10)
    del args, resid, meta, k2, la
    out['packed_mesh_8'] = {
        'segments': segs[0][1], 'launches': PATH_LAUNCHES['gop_mesh'],
        'first_wall_s': wall, 'repeat_wall_s': walls,
        'fps_median': N_FRAMES / float(np.median(walls)),
        'k2_equal_plain': True, 'k2_max_abs_err': k2_err,
        'k1_ms': k1_mesh, 'k2_ms': k2_mesh}

    # 2. decode_available over a 1-cell mesh: flushes of 32 frames
    def decoder_run():
        dec = MPEG1Decoder({'device': DEVICE})
        dec.write(0.0, es)
        return dec.decode_available(eof=True, mesh=make_mesh(1,
                                                             device=DEVICE))

    frames, wall = counted('gop_mesh_decoder', decoder_run,
                           N_FRAMES // BATCH)
    frames_equal('gop mesh decode_available',
                 [host_planes(p) for p in frames], cpu_frames)
    del frames
    walls = median_wall(decoder_run)
    out['decode_available_mesh_1'] = {
        'launches': PATH_LAUNCHES['gop_mesh_decoder'], 'first_wall_s': wall,
        'repeat_wall_s': walls,
        'fps_median': N_FRAMES / float(np.median(walls))}

    # 3. the Player with cfg.mesh
    def player_run(mesh='8'):
        vc = VideoCollector()
        p = Player(ts_av, {'mesh': mesh, 'audio': False, 'device': DEVICE},
                   renderer=vc)
        n_video, _ = p.decode_offline()
        return p, vc, n_video

    kernels.reset_launches()
    p, vc, n_video = player_run()
    torch.cuda.synchronize()
    launches = dict(kernels.launches)
    PATH_LAUNCHES['gop_mesh_player'] = launches
    previews = p.metrics.counts['video_decode']
    if n_video != N_FRAMES or launches != each(1 + previews):
        raise AssertionError(f'mesh Player: {n_video} frames, launches '
                             f'{launches}, {previews} previews')
    frames_equal('gop mesh Player', vc.frames, cpu_frames)
    # the same Player without the mesh, the two taking turns: what the
    # mesh changes with the audio left out of both
    vfps, plain_fps = [], []
    for _ in range(N_REPEATS):
        for mesh, into in (('8', vfps), (None, plain_fps)):
            q = player_run(mesh)[0]
            into.append(q.metrics.counts['video_batch']
                        / q.metrics.seconds['video_batch'])
    out['player_mesh_8'] = {
        'launches': launches, 'preview_frames': previews,
        'video_fps': vfps, 'video_fps_median': float(np.median(vfps)),
        'no_mesh_video_fps': plain_fps,
        'no_mesh_video_fps_median': float(np.median(plain_fps))}

    # 4. the fleet's four streams over 4x2
    streams = [es] + [x['es'] for x in extra]
    wants = [cpu_frames] + [x['cpu_frames'] for x in extra]
    mesh42 = resolve_mesh('4x2', device=DEVICE)
    got, wall = counted('gop_mesh_streams',
                        lambda: fleet.decode_streams_mesh(streams, mesh42), 1)
    for i, (g, w_) in enumerate(zip(got, wants)):
        frames_equal(f'gop mesh streams {i}', [host_planes(x) for x in g], w_)
    del got
    total = sum(len(w_) for w_ in wants)
    walls = median_wall(lambda: fleet.decode_streams_mesh(streams, mesh42))
    out['streams_mesh_4x2'] = {
        'frames': [len(w_) for w_ in wants],
        'launches': PATH_LAUNCHES['gop_mesh_streams'], 'first_wall_s': wall,
        'repeat_wall_s': walls,
        'aggregate_fps_median': total / float(np.median(walls))}

    # 5. the CLI
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as d:
        clip, y4m = os.path.join(d, 'main.ts'), os.path.join(d, 'out.y4m')
        with open(clip, 'wb') as f:
            f.write(ts_av)
        t0 = time.monotonic()
        r = subprocess.run([sys.executable, '-m', 'jsmpeg_tpu_torch', clip,
                            '--offline', '--mesh', '8', '--no-audio', '-o',
                            y4m, '--stats'], cwd=root, capture_output=True,
                           text=True, timeout=300)
        cli_s = time.monotonic() - t0
        if r.returncode != 0:
            raise AssertionError(f'mesh CLI exit {r.returncode}: '
                                 f'{r.stderr[-2000:]}')
        stats = json.loads(r.stdout.strip().splitlines()[-1])
        previews = stats['stages'].get('video_decode', {}).get('count', 0)
        if (stats['video_frames'] != N_FRAMES
                or stats['kernel_launches'] != each(1 + previews)):
            raise AssertionError(f'mesh CLI stats {stats}')
        frames_equal('gop mesh CLI y4m', read_y4m(y4m)[1], cpu_frames)
    PATH_LAUNCHES['gop_mesh_cli'] = stats['kernel_launches']
    out['cli_mesh_8'] = {'launches': stats['kernel_launches'],
                         'cli_s': cli_s, 'video_fps': stats['video_fps']}
    emit('t_gop_mesh', cpu_equal_frames=N_FRAMES * 4 + total, **out)


def encode_edge_stream(n_frames: int = 5, seed: int = 84) -> bytes:
    """A 720p I picture, then P pictures whose top macroblock row predicts
    from 10-31 rows above the picture and whose bottom row from as far
    below it (f_code 3; the other rows move a little).  Over 2 bands the
    picture's 45 rows pad to 46, so only a clamp at the last REAL row
    keeps the bottom row's reads out of the padding row."""
    from jsmpeg_tpu_torch import tables as T
    from jsmpeg_tpu_torch.testing.bitwriter import BitWriter
    from jsmpeg_tpu_torch.testing.gen import _intra_levels, make_ycbcr_frame
    from jsmpeg_tpu_torch.testing.mpeg1_enc import MB, MPEG1Encoder
    rng = np.random.default_rng(seed)
    enc = MPEG1Encoder(W, H, qscale=8, f_code=3)
    chunks = []
    for t in range(n_frames):
        enc.w = BitWriter()
        if t == 0:
            enc.sequence_header()
            enc.gop_header()
            y, cb, cr = make_ycbcr_frame(W, H, t, seed)
            enc.encode_picture(T.PIC_I, [
                MB('intra', levels=_intra_levels(y, cb, cr, r, c, 8,
                                                 enc.intra_q))
                for r in range(enc.mb_h) for c in range(enc.mb_w)])
        else:
            mbs = []
            for r in range(enc.mb_h):
                reach = int(rng.integers(20, 62))
                for c in range(enc.mb_w):
                    mv_v = (-reach if r == 0 else reach if r == enc.mb_h - 1
                            else int(rng.integers(-8, 9)))
                    mbs.append(MB('mc', mv=(int(rng.integers(-8, 9)), mv_v)))
            enc.encode_picture(T.PIC_P, mbs)
        chunks.append(enc.getvalue())
    return b''.join(chunks) + b'\x00\x00\x01\xb7'


def phase_tile_mesh(torch, kernels, es: bytes, cpu_frames):
    """Tile cells on distinct devices (parallel/tiles.py): the picture in
    macroblock-row bands, K1 once per device, then per frame step one K2
    band launch per band and a halo exchange.  'cuda' and 'cuda:0' are
    two device objects (two mesh cells) on the one card.  Every frame is
    held to the CPU frames, each path's launches counted from 0:
    1. decode_packed_mesh over make_mesh(1, 2) on ['cuda', 'cuda:0']: the
       8 GOPs as segments of each band's launches, K1 2 and K2 12 x 2;
       its warm median rate; one frame step's two band launches timed
       with cuda_ms, held to mc_combine_ref first, with their bound; the
       halo exchange of a step timed alone.
    2. make_mesh(2, 2) on the same two objects: K1 2, K2 24.
    3. The 4-band loop on the one card (make_mesh(1, 4) on the two
       objects, repeated): K1 2, K2 12 x 4; the last band ends in 3
       padding rows.
    4. decode_tiled_levels and decode_tiled on the first GOP (1, 2);
       decode_tiled over make_mesh(1, 2) on one device object (its cells
       merge into one band: K1 1, K2 1).
    5. A 720p edge-vector stream (encode_edge_stream) on (1, 2), held to
       the CPU's serial decode: the clamp at the real rows on the card."""
    from jsmpeg_tpu_torch.host import best_parser
    from jsmpeg_tpu_torch.ops.frame import mc_combine_ref
    from jsmpeg_tpu_torch.parallel import packed, tiles
    from jsmpeg_tpu_torch.parallel.mesh import make_mesh
    from jsmpeg_tpu_torch.parallel.multihost import index_gops
    from jsmpeg_tpu_torch.parallel.packed import decode_packed_mesh
    two = [DEVICE, DEVICE + ':0']      # two mesh cells, one device
    n_steps = GOP
    mb_h = H // 16
    out = {}

    def counted(name, fn, k1, k2, k3=None):
        """k3: K3 launches, by default one per K1 launch (a packed wire
        per device)."""
        kernels.reset_launches()
        t0 = time.monotonic()
        r = fn()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = dict(kernels.launches)
        PATH_LAUNCHES[name] = launches
        want = {'dequant_idct': k1, 'mc_combine': k2,
                'wire_unpack': k1 if k3 is None else k3}
        if launches != want:
            raise AssertionError(f'{name} launches {launches}, expected '
                                 f'{want}')
        return r, wall

    # 1. (1, 2), the band launches and the exchange of one step captured,
    # the host's split of the pictures into band wires timed
    mesh12 = make_mesh(1, 2, devices=two)
    steps, swaps, split_s = [], [], [0.0]
    real_mc, real_swap = tiles.mc_combine, tiles.exchange_halo
    real_split = packed.split_frame_tiles

    def timed_split(*a):
        t0 = time.monotonic()
        r = real_split(*a)
        split_s[0] += time.monotonic() - t0
        return r

    def capture_mc(*a):
        if a[6].frame == 1:
            steps.append(a)
        return real_mc(*a)

    def capture_swap(*a):
        if not swaps:
            swaps.append(a)
        return real_swap(*a)

    tiles.mc_combine, tiles.exchange_halo = capture_mc, capture_swap
    packed.split_frame_tiles = timed_split
    try:
        frames, wall = counted('tile_mesh_1x2',
                               lambda: decode_packed_mesh(es, mesh12), 2,
                               2 * n_steps)
    finally:
        tiles.mc_combine, tiles.exchange_halo = real_mc, real_swap
        packed.split_frame_tiles = real_split
    frames_equal('tile mesh 1x2', [host_planes(p) for p in frames],
                 cpu_frames)
    del frames
    walls = []
    for _ in range(3):
        t0 = time.monotonic()
        r = decode_packed_mesh(es, mesh12)
        torch.cuda.synchronize()
        walls.append(time.monotonic() - t0)
        del r
    step_ms, step_bytes, step_ops, err = 0.0, 0, 0, 0
    for cur, fwd, resid, meta, n_seg, seg, band in steps:
        got = kernels.mc_combine_cuda(cur, fwd, resid, meta, n_seg, seg, band)
        want = mc_combine_ref(cur, fwd, resid[0], meta[0], n_seg, seg, band)
        for pn, g, w_ in zip(('y', 'cr', 'cb'), got, want):
            err = max(err, equal_or_raise(f'K2 band step {pn}', g[0], w_))
        step_ms += cuda_ms(torch, lambda: kernels.mc_combine_cuda(
            cur, fwd, resid, meta, n_seg, seg, band), iters=20)
        b, o = k2_work(meta)
        step_bytes, step_ops = step_bytes + b, step_ops + o
    step_bound, step_by = bound(step_bytes, step_ops)
    swap_ms = cuda_ms(torch, lambda: tiles.exchange_halo(*swaps[0]),
                      iters=20)
    out['mesh_1x2'] = {
        'launches': PATH_LAUNCHES['tile_mesh_1x2'], 'first_wall_s': wall,
        'host_split_ms': split_s[0] * 1e3, 'repeat_wall_s': walls,
        'fps_median': N_FRAMES / float(np.median(walls)),
        'n_seg': steps[0][4],
        'band_launches_per_step': len(steps),
        'k2_band_ms_per_step': step_ms,
        'k2_band_bound_ms_per_step': step_bound,
        'k2_band_bound_by': step_by, 'k2_band_max_abs_err': err,
        'halo_exchange_ms_per_step': swap_ms,
        'halo_rows': [swaps[0][1][1].y.shape[0] // swaps[0][3],
                      swaps[0][1][1].cr.shape[0] // swaps[0][3]]}
    del steps, swaps

    # 2. (2, 2) on the same two objects: the rows share one band loop
    frames, wall = counted('tile_mesh_2x2', lambda: decode_packed_mesh(
        es, make_mesh(2, 2, devices=two)), 2, 2 * n_steps)
    frames_equal('tile mesh 2x2', [host_planes(p) for p in frames],
                 cpu_frames)
    del frames
    out['mesh_2x2'] = {'launches': PATH_LAUNCHES['tile_mesh_2x2'],
                       'wall_s': wall}

    # 3. four bands on the one card
    frames, wall = counted('tile_bands_4', lambda: decode_packed_mesh(
        es, make_mesh(1, 4, devices=two * 2)), 2, 4 * n_steps)
    frames_equal('tile bands 4', [host_planes(p) for p in frames],
                 cpu_frames)
    del frames
    out['bands_4'] = {'launches': PATH_LAUNCHES['tile_bands_4'],
                      'wall_s': wall,
                      'padding_rows': 4 * -(-mb_h // 4) - mb_h}

    # 4. the tiled entry points on the first GOP
    header, ranges = index_gops(es)
    s0, e0, n0 = ranges[0]
    gop_es = header + es[s0:e0]
    frames, wall = counted('tiled_levels', lambda: tiles.decode_tiled_levels(
        gop_es, mesh12), 2, 2 * n0, 0)
    frames_equal('decode_tiled_levels', [host_planes(p) for p in frames],
                 cpu_frames[:n0])
    parser = best_parser()
    parser.write(gop_es)
    fds = [parser.parse_frame(eof=True) for _ in range(n0)]
    frames, wall2 = counted('tiled', lambda: tiles.decode_tiled(
        fds, H // 16, W // 16, mesh12), 2, 2 * n0, 0)
    frames_equal('decode_tiled', [host_planes(p) for p in frames],
                 cpu_frames[:n0])
    del frames
    # tile cells on one device object merge into one band: one launch pair
    frames, wall3 = counted('tiled_one_band', lambda: tiles.decode_tiled(
        fds, H // 16, W // 16, make_mesh(1, 2, devices=[DEVICE])), 1, 1, 0)
    frames_equal('decode_tiled one band', [host_planes(p) for p in frames],
                 cpu_frames[:n0])
    del frames, fds
    out['tiled_entry_points'] = {
        'frames': n0, 'levels_launches': PATH_LAUNCHES['tiled_levels'],
        'levels_wall_s': wall, 'serial_wire_launches': PATH_LAUNCHES['tiled'],
        'serial_wire_wall_s': wall2,
        'one_band_launches': PATH_LAUNCHES['tiled_one_band'],
        'one_band_wall_s': wall3}

    # 5. the edge-vector stream: the clamp at the real rows
    edge = encode_edge_stream()
    want = [host_planes(p) for p in decode_all(torch, edge, 'cpu')]
    frames, wall = counted('tile_edge', lambda: decode_packed_mesh(
        edge, mesh12), 2, 2 * len(want))
    frames_equal('edge stream 1x2', [host_planes(p) for p in frames], want)
    del frames
    out['edge_stream_1x2'] = {'frames': len(want),
                              'mb_h_pad': 2 * -(-mb_h // 2),
                              'launches': PATH_LAUNCHES['tile_edge']}
    emit('v_tile_mesh', cpu_equal_frames=3 * N_FRAMES + 3 * n0 + len(want),
         **out)
    return out['mesh_1x2']


def phase_multiprocess(torch, kernels, es: bytes, cpu_frames):
    """The multi-process decode on the card, in subprocesses (the kernels
    and the host library are built already; they load them):
    1. two gloo ranks of `python -m jsmpeg_tpu_torch.parallel.multihost`
       on the one card, at n_tile 1 (each rank's 4 GOPs as segments of one
       launch pair) and n_tile 2 (bands on 'cuda' and 'cuda:0'); each
       rank's frames held to the CPU frames, the two ranks covering all
       of them; launches from the ranks' JSON lines;
    2. decode_gops_elastic with 3 workers on the card, worker 0 SIGKILLed
       as its first GOP goes out: every frame equal, the GOP re-done by a
       survivor; launches from the workers' replies."""
    import signal
    import socket
    from jsmpeg_tpu_torch.parallel.elastic import decode_gops_elastic
    root = os.path.dirname(os.path.abspath(__file__))
    out = {}
    with tempfile.TemporaryDirectory() as d:
        es_path = os.path.join(d, 'main.es')
        with open(es_path, 'wb') as f:
            f.write(es)
        for n_tile, devs in ((1, [DEVICE]), (2, [DEVICE, DEVICE + ':0'])):
            with socket.socket() as sk:
                sk.bind(('127.0.0.1', 0))
                port = sk.getsockname()[1]
            t0 = time.monotonic()
            procs = [subprocess.Popen(
                [sys.executable, '-m', 'jsmpeg_tpu_torch.parallel.multihost',
                 f'tcp://127.0.0.1:{port}', '2', str(r), es_path,
                 os.path.join(d, f'r{r}.npz'), '--n-tile', str(n_tile)]
                + [a for dv in devs for a in ('--device', dv)], cwd=root,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                for r in range(2)]
            try:
                res = [p.communicate(timeout=300) for p in procs]
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
            wall = time.monotonic() - t0
            lines, seen = [], []
            for r, (p, (so, se)) in enumerate(zip(procs, res)):
                if p.returncode != 0:
                    raise AssertionError(f'multihost rank {r} (n_tile '
                                         f'{n_tile}) exit {p.returncode}: '
                                         f'{se[-2000:]}')
                line = json.loads(so.strip().splitlines()[-1])
                with np.load(os.path.join(d, f'r{r}.npz')) as z:
                    frames_equal(f'multihost n_tile {n_tile} rank {r}',
                                 [(z['y'][i], z['cr'][i], z['cb'][i])
                                  for i in range(len(line['frames']))],
                                 [cpu_frames[k] for k in line['frames']])
                if min(line['launches'].values()) <= 0:
                    raise AssertionError(f'rank {r} launched no kernel')
                seen += line['frames']
                lines.append(line)
            if sorted(seen) != list(range(N_FRAMES)):
                raise AssertionError(f'the ranks decoded frames {seen}')
            name = f'multihost_n_tile_{n_tile}'
            PATH_LAUNCHES[name] = {k: sum(x['launches'][k] for x in lines)
                                   for k in lines[0]['launches']}
            out[name] = {'ranks': [{'frames': len(x['frames']),
                                    'launches': x['launches']}
                                   for x in lines], 'wall_s': wall}
    killed, stats = [], {}

    def on_assign(worker_id, pid, gop):
        if worker_id == 0 and not killed:
            os.kill(pid, signal.SIGKILL)
            killed.append((pid, gop))

    t0 = time.monotonic()
    counts, frames = decode_gops_elastic(es, n_workers=3, device=DEVICE,
                                         on_assign=on_assign, timeout=300,
                                         stats=stats)
    wall = time.monotonic() - t0
    frames_equal('elastic', frames, cpu_frames)
    if not killed or stats['done_by'][killed[0][1]] == killed[0][0]:
        raise AssertionError(f'elastic: no worker killed or its GOP not '
                             f're-done ({killed}, {stats["done_by"]})')
    launches = [v for v in stats['launches'].values() if v]
    if not launches or min(min(v.values()) for v in launches) <= 0:
        raise AssertionError(f'elastic workers launched {launches}')
    PATH_LAUNCHES['elastic'] = {k: sum(v[k] for v in launches)
                                for k in launches[0]}
    out['elastic'] = {'workers': 3, 'killed_gop': killed[0][1],
                      'gop_frames': counts, 'wall_s': wall,
                      'workers_launches': launches}
    emit('w_multiprocess', cpu_equal_frames=3 * N_FRAMES, **out)


def phase_relay_live(torch, kernels, chunks, cpu_frames):
    """The live relay (`jsmpeg_tpu_torch.relay.serve`) on localhost ports
    in a thread of its own; another thread POSTs the 720p TS to it at
    FPS in 1316-byte chunks (frame i's bytes at i / FPS), and a ws://
    Player on the card ticks on the main thread.  Every frame equal to
    the CPU frames; the last picture completes only when its PES is
    flushed once every byte has arrived (as in m_live)."""
    import asyncio
    import socket
    from jsmpeg_tpu_torch.player import Player
    from jsmpeg_tpu_torch.relay import serve
    from jsmpeg_tpu_torch.sinks import VideoCollector

    def free_port():
        s = socket.socket()
        s.bind(('127.0.0.1', 0))
        port = s.getsockname()[1]
        s.close()
        return port

    ports = {k: free_port() for k in ('http', 'ws', 'tcp')}
    loop = asyncio.new_event_loop()
    task = loop.create_task(serve('live', ports['http'], ports['ws'],
                                  ports['tcp'], None, host='127.0.0.1'))

    def run_relay():
        asyncio.set_event_loop(loop)
        try:
            loop.run_until_complete(task)
        except asyncio.CancelledError:
            pass
        finally:
            loop.close()

    spans = frame_spans(chunks)
    n_bytes = sum(len(s) for s in spans)
    pushed, stop = threading.Event(), threading.Event()

    def post():
        s = socket.create_connection(('127.0.0.1', ports['http']))
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        s.sendall(b'POST /live HTTP/1.1\r\nHost: localhost\r\n\r\n')
        t0 = time.monotonic()
        for i, span in enumerate(spans):
            pause = t0 + i / FPS - time.monotonic()
            if pause > 0:
                time.sleep(pause)
            for j in range(0, len(span), 7 * 188):
                s.sendall(span[j:j + 7 * 188])
        pushed.set()
        stop.wait(30)
        s.close()

    relay = threading.Thread(target=run_relay, daemon=True)
    feeder = threading.Thread(target=post, daemon=True)
    relay.start()
    deadline = time.monotonic() + 10
    while True:                     # the relay listens before anyone joins
        try:
            socket.create_connection(('127.0.0.1', ports['http'])).close()
            break
        except OSError:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.05)
    sink = VideoCollector()
    p = Player(f'ws://127.0.0.1:{ports["ws"]}/',
               {'audio': False, 'device': DEVICE, 'reconnectInterval': 0.1},
               renderer=sink)
    received = [0]
    inner = p.source.destination

    class Counting:
        def write(self, data):
            received[0] += len(data)
            inner.write(data)

    p.source.destination = Counting()
    try:
        p.play()
        time.sleep(1.0)         # the WebSocket client joins before the feed
        kernels.reset_launches()
        t_start = time.monotonic()
        feeder.start()
        deadline = t_start + len(spans) / FPS + 10
        while received[0] < n_bytes and time.monotonic() < deadline:
            p.tick()
        # the end of the stream: a PES whose last TS packet is full
        # completes only at the next payload start, so flush it
        p.demuxer.flush()
        until = time.monotonic() + 2.0
        while sink.frames_rendered < N_FRAMES and time.monotonic() < until:
            p.tick()
        launches = dict(kernels.launches)
    finally:
        p.destroy()
        stop.set()
        loop.call_soon_threadsafe(task.cancel)
        feeder.join(timeout=10)
        relay.join(timeout=10)
    PATH_LAUNCHES['relay_live'] = launches
    if not pushed.is_set() or relay.is_alive():
        raise AssertionError('the relay feed did not finish or stop')
    frames_equal('relay live', sink.frames, cpu_frames)
    if min(launches.values()) <= 0:
        raise AssertionError(f'relay live path skipped a kernel: {launches}')
    emit('u_relay_live', frames=len(sink.frames), cpu_equal_frames=N_FRAMES,
         chunk_bytes=7 * 188, pace_fps=FPS, relayed_bytes=received[0],
         launches=launches)


def phase_k3_shapes(torch, kernels, shapes, main, iq, nq) -> dict:
    """K3 and K1's compact form at the wire shapes of one call beyond the
    main path's (`shapes`, k3_shape_wires: the GOP mesh's joint wire, the
    stacked fleet's round, 48 stacked copies of the main batch) and at the
    vmap fleet's [4, L] round of the main batch: each K3 call held to its
    plain version (the lattice wire to `main`'s copies, `main` being the
    main batch's checked outputs), each K1 call on K3's output to its
    plain version; their times, their bounds and K3's launches apart."""
    from jsmpeg_tpu_torch.models.mpeg1 import unpack_wires_ref
    from jsmpeg_tpu_torch.ops.frame import LevelsArrays
    out = {}
    main_wire = shapes[0]
    shapes = shapes[1:] + [('vmap_4', np.repeat(main_wire[1], 4, axis=0),
                            main_wire[2], 1)]
    for name, buf, sizes, copies in shapes:
        args = (torch.as_tensor(buf).to(DEVICE),) + sizes
        got = LevelsArrays(*kernels.wire_unpack_cuda(*args))
        # the lattice wire: each frame holds copies of 'main's
        want = (unpack_wires_ref(*args) if copies == 1 else
                k3_copies(torch, main, copies))
        for i, (g, w_) in enumerate(zip(got, want)):
            equal_or_raise(f'K3 {name} output {i}', g, w_)
        del want
        k1 = k1_compact_args(torch, got, iq, nq)
        k1_compact_check(torch, kernels, k1, f'k3 shape {name}')
        rows = int((got.blk_ids >= 0).sum())
        k1_bound_ms, k1_by = bound(*k1_work(
            rows, int((got.levels[got.blk_ids >= 0] != 0).sum()),
            int(got.coded.any(-1).sum()), True))
        items = sizes[0] * sizes[1] * buf.shape[0]
        ms_bound, by = bound(*k3_work(buf.size, items, got.levels.shape[0],
                                      sizes[4] * buf.shape[0]))
        del got
        ms = cuda_ms(torch, lambda: kernels.wire_unpack_cuda(*args),
                     iters=10)
        k1_ms = cuda_ms(torch, lambda: kernels.dequant_idct_compact_cuda(
            *k1), iters=10)
        out[name] = {'streams': buf.shape[0], 'frames': sizes[0],
                     'n_mb': sizes[1], 'macroblocks': items,
                     'pairs': sizes[4], 'n_blk': sizes[6],
                     'wire_bytes': buf.size, 'equal': True, 'ms': ms,
                     'bound_ms': ms_bound, 'bound_by': by,
                     'ms_over_bound': ms / ms_bound,
                     'sub_launch_ms': {
                         k: v['mean_us'] / 1e3 for k, v in profiled_us(
                             torch, lambda: kernels.wire_unpack_cuda(*args),
                             5).items()},
                     'k1_compact_rows': rows, 'k1_compact_ms': k1_ms,
                     'k1_compact_bound_ms': k1_bound_ms,
                     'k1_compact_bound_by': k1_by}
        del args, k1
        torch.cuda.empty_cache()
    return out


def phase_kernels(torch, kernels, es: bytes, launches, errs, band):
    """Each kernel's time at the main path's shape and data (the last
    32-frame batch of the stream, k3_shape_wires' 'main': its wire for
    K3, K3's compact levels of it for K1), its plain version's time on
    the same inputs, and its bound (portbench.work).  The three kernels
    run once per batch, so `ms` is per batch; K2 also reports
    `ms_per_frame`, and its output on this batch is held to
    decode_frames_ref first, as K3's to unpack_wires_ref; K3 and K1's
    compact form also at the GOP mesh's, the stacked fleet's, a
    near-limit and the vmap fleet's wire (phase_k3_shapes).  K1's three
    forms on the same batch (compact; levels, its dense lattice;
    premultiplied, that lattice's coefficients) are timed in turns, each
    form beside its own bound.  Each launch's time apart comes from the
    profiler (profiled_us)."""
    from jsmpeg_tpu_torch.models.mpeg1 import levels_dense, unpack_wires_ref
    from jsmpeg_tpu_torch.ops.frame import (LevelsArrays, Planes,
                                            decode_frames_ref, frame_meta)
    from jsmpeg_tpu_torch.ops.idct import (dequant_idct_compact_ref,
                                           dequant_idct_ref, dequant_premult)
    shapes = k3_shape_wires(es, GOP)
    _, host_wire, sizes, _ = shapes[0]
    n_frames, n_mb, n_runs, mv_wide, n_pairs, n_esc, n_blk = sizes
    buf = torch.as_tensor(host_wire[0], device=DEVICE)
    iq, nq = (torch.as_tensor(q, device=DEVICE) for q in stream_quant(es))
    k3_args = (buf[None],) + sizes
    la = LevelsArrays(*kernels.wire_unpack_cuda(*k3_args))
    for field, g, w_ in zip(la._fields, la, unpack_wires_ref(*k3_args)):
        equal_or_raise(f'K3 main-path batch {field}', g, w_)
    k3_ms = cuda_ms(torch, lambda: kernels.wire_unpack_cuda(*k3_args),
                    iters=50)
    k3_plain = cuda_ms(torch, lambda: unpack_wires_ref(*k3_args), iters=10)
    # each launch apart as the profiler traces it, and the host's time to
    # enqueue one whole call
    k3_split = {k: v['mean_us'] / 1e3 for k, v in profiled_us(
        torch, lambda: kernels.wire_unpack_cuda(*k3_args), 20).items()}
    k3_host = host_us(torch, lambda: kernels.wire_unpack_cuda(*k3_args),
                      iters=50)
    k3_shapes = phase_k3_shapes(torch, kernels, shapes, la, iq, nq)
    # the vmap fleet's call: four copies of the wire as one [4, L] stack
    k3_vmap_ms = k3_shapes['vmap_4']['ms']
    del shapes
    k3_bytes, k3_ops = k3_work(buf.numel(), n_frames * n_mb, n_blk, n_pairs)
    k3_bnd, k3_by = bound(k3_bytes, k3_ops)
    v8 = buf[buf.numel() - 2 * n_esc - n_pairs:buf.numel() - 2 * n_esc]
    k3_escapes = int((v8.view(torch.int8) == -128).sum())
    # K1's three forms on the batch: the compact one (the main path's),
    # the levels form on the dense lattice it stands for, and the
    # premultiplied form on that lattice's coefficients
    F, n_mb = la.qscale.shape
    compact = k1_compact_args(torch, la, iq, nq)
    dense = levels_dense(la)
    levels = (dense.levels.reshape(F * n_mb, 6, 64), la.qscale.reshape(-1),
              la.intra.reshape(-1), iq, nq)
    coef = dequant_premult(*levels)
    calls = {
        'dequant_idct.compact': (
            lambda: kernels.dequant_idct_compact_cuda(*compact),
            lambda: dequant_idct_compact_ref(*compact)),
        'dequant_idct.levels': (
            lambda: kernels.dequant_idct_cuda(*levels),
            lambda: dequant_idct_ref(*levels)),
        'dequant_idct.premultiplied': (
            lambda: kernels.dequant_idct_cuda(coef, premultiplied=True),
            lambda: dequant_idct_ref(coef, premultiplied=True))}
    resid = k1_compact_check(torch, kernels, compact, 'main-path batch')
    named = la.blk_ids[la.blk_ids >= 0].long()
    equal_or_raise('K1 levels form on the main-path batch',
                   calls['dequant_idct.levels'][0]().reshape(-1, 64)[named],
                   resid[named])
    # in turns on one card: levels, compact, premultiplied, then back
    turns = {}
    for form in ('dequant_idct.levels', 'dequant_idct.compact',
                 'dequant_idct.premultiplied', 'dequant_idct.premultiplied',
                 'dequant_idct.compact', 'dequant_idct.levels'):
        turns.setdefault(form, []).append(cuda_ms(torch, calls[form][0],
                                                  iters=50))
    n_dense = F * n_mb * 6
    rows = int(named.numel())
    k1 = {}
    for form, (_, plain) in calls.items():
        if form == 'dequant_idct.compact':
            blocks = rows
            b_ms, b_by = bound(*k1_work(rows, int((la.levels != 0).sum()),
                                        int(la.coded.any(-1).sum()), True))
        elif form == 'dequant_idct.levels':
            blocks = n_dense
            b_ms, b_by = bound(*k1_work(n_dense, int((levels[0] != 0).sum()),
                                        F * n_mb, False))
        else:
            blocks = n_dense
            b_ms, b_by = bound(n_dense * 64 * (4 + 4),
                               n_dense * IDCT_OPS_PER_BLOCK)
        k1[form] = {'blocks': blocks, 'ms': float(np.mean(turns[form])),
                    'ms_turns': turns[form],
                    'plain_ms': cuda_ms(torch, plain, iters=3, warmup=1),
                    'bound_ms': b_ms, 'bound_by': b_by}
    # the dense forms' bound at the compact form's blocks: what the
    # dense lattice costs over the coded blocks alone
    k1['dequant_idct.compact']['dense_bound_ms'] = \
        k1['dequant_idct.levels']['bound_ms']
    del dense, levels, coef, calls
    resid = resid.reshape(F, n_mb, 6, 64)
    meta = frame_meta(la.coded, la.intra, la.written, la.mv_h, la.mv_v)
    Hc, Wc = (n_mb // (W // 16)) * 16, W
    z = lambda h, w: torch.zeros((h, w), dtype=torch.uint8,
                                 device=resid.device)
    cur = Planes(z(Hc, Wc), z(Hc // 2, Wc // 2), z(Hc // 2, Wc // 2))
    got = kernels.mc_combine_cuda(cur, cur, resid, meta)
    want = decode_frames_ref(cur, cur, resid, meta)
    k2_err = max(equal_or_raise(f'K2 main-path batch {pn}', g, w_)
                 for pn, g, w_ in zip(('y', 'cr', 'cb'), got, want))
    del got, want
    k2_ms = cuda_ms(torch, lambda: kernels.mc_combine_cuda(
        cur, cur, resid, meta), iters=20)
    k2_plain = cuda_ms(torch, lambda: decode_frames_ref(cur, cur, resid,
                                                        meta),
                       iters=2, warmup=1)
    # where a frame's time goes: one frame alone (no waits), the batch
    # with all-zero metadata (each frame a copy of the stale plane, each
    # macroblock waiting for its row two frames back), and the batch with
    # every macroblock written and reading the previous frame's opposite
    # edge (held to decode_frames_ref first)
    k2_one_ms = cuda_ms(torch, lambda: kernels.mc_combine_cuda(
        cur, cur, resid[:1], meta[:1]), iters=20)
    idle = torch.zeros_like(meta)
    k2_copy_ms = cuda_ms(torch, lambda: kernels.mc_combine_cuda(
        cur, cur, resid, idle), iters=20)
    far = meta.clone()
    from jsmpeg_tpu_torch.testing.kernel_inputs import k2_vectors
    far[..., :2] = torch.as_tensor(k2_vectors(
        'far', np.random.default_rng(SEED), F, Hc // 16, Wc // 16),
        device=meta.device)
    far[..., 2] |= 0x80
    for pn, g, w_ in zip(('y', 'cr', 'cb'),
                         kernels.mc_combine_cuda(cur, cur, resid, far),
                         decode_frames_ref(cur, cur, resid, far)):
        equal_or_raise(f'K2 far vectors {pn}', g, w_)
    k2_far_ms = cuda_ms(torch, lambda: kernels.mc_combine_cuda(
        cur, cur, resid, far), iters=20)
    # the joint modes' launch: the batch as K2_SEGMENTS stacked streams,
    # all frames each (no counts on the device) and the fleet's last
    # stream short (counts on the device); and the segment code's own
    # cost: the one-stream batch cut into 3 segments runs the kSegmented
    # instantiation over the same macroblocks as `ms`
    s = K2_SEGMENTS
    cur_s = Planes(*[torch.cat([p] * s) for p in cur])
    resid_s = torch.cat([resid] * s, dim=1)
    meta_s = torch.cat([meta] * s, dim=1)
    segmented = {'n_seg': s}
    for key, args in (
            ('all_frames_ms', (cur_s, cur_s, resid_s, meta_s, s, None)),
            ('counts_ms', (cur_s, cur_s, resid_s, meta_s, s,
                           [F] * (s - 1) + [MS_FRAMES[-1]])),
            ('one_stream_as_3_segments_ms', (cur, cur, resid, meta, 3,
                                             None))):
        for pn, g, w_ in zip(('y', 'cr', 'cb'), kernels.mc_combine_cuda(*args),
                             decode_frames_ref(*args)):
            equal_or_raise(f'K2 segmented {key} {pn}', g, w_)
        segmented[key] = cuda_ms(torch, lambda: kernels.mc_combine_cuda(
            *args), iters=20)
    segmented['counts'] = [F] * (s - 1) + [MS_FRAMES[-1]]
    del cur_s, resid_s, meta_s
    written = int(la.written.sum())
    coded_blocks = int(la.coded.sum())
    # blocks that read a base: all but the coded intra ones, whose
    # residual replaces it
    base_blocks = int((~(la.intra[..., None] & la.coded)).sum())
    k2_bytes, k2_ops = k2_work(meta)
    k2_bound, k2_by = bound(k2_bytes, k2_ops)
    line = {'kernels': [
        {'name': 'wire_unpack', 'route': 'cuda',
         'source': 'jsmpeg_tpu_torch/csrc/wire_unpack.cu',
         'replaces': 'jsmpeg_tpu/models/mpeg1.py:133',
         'launches': launches['wire_unpack'],
         'launches_by_path': {k: v.get('wire_unpack', 0)
                              for k, v in PATH_LAUNCHES.items()},
         'max_abs_err': errs[2],
         'ms': k3_ms, 'plain_ms': k3_plain, 'bound_ms': k3_bnd,
         'bound_by': k3_by, 'library_ms': None, 'vmap_4_ms': k3_vmap_ms},
        *[{'name': form, 'route': 'cuda',
           'source': 'jsmpeg_tpu_torch/csrc/dequant_idct.cu',
           'replaces': 'tools/idct_pallas_shelved.py:102',
           'launches': PATH_K1_FORMS['main'][form],
           'launches_by_path': {k: v[form]
                                for k, v in PATH_K1_FORMS.items()},
           'max_abs_err': K1_ERR[form], **k1[form], 'library_ms': None}
          for form in k1],
        {'name': 'mc_combine', 'route': 'cuda',
         'source': 'jsmpeg_tpu_torch/csrc/mc_combine.cu',
         'replaces': 'jsmpeg_tpu/ops/frame.py:235',
         'launches': launches['mc_combine'],
         'launches_by_path': {k: v['mc_combine']
                              for k, v in PATH_LAUNCHES.items()},
         'max_abs_err': max(errs[1], k2_err, band['k2_band_max_abs_err']),
         'ms': k2_ms, 'ms_per_frame': k2_ms / F, 'plain_ms': k2_plain,
         'bound_ms': k2_bound, 'bound_by': k2_by, 'library_ms': None,
         'band_ms_per_step': band['k2_band_ms_per_step'],
         'band_bound_ms_per_step': band['k2_band_bound_ms_per_step'],
         'band_launches_per_step': band['band_launches_per_step']},
    ]}
    emit('h_kernel_detail', k3_wire_bytes=buf.numel(), k3_frames=n_frames,
         k3_pairs=n_pairs, k3_escapes=k3_escapes, k3_runs=n_runs,
         k3_n_blk=n_blk, k3_coded_blocks=int(la.coded.sum()),
         k3_mv_wide=mv_wide,
         k3_sub_launches_per_call=kernels.lib().jt_wire_unpack_launches(),
         k3_sub_launch_ms=k3_split, k3_host_us=k3_host,
         k3_bytes=k3_bytes, k3_ops=k3_ops, k3_batch_equal=True,
         k3_vmap_4_ms=k3_vmap_ms, k3_shapes=k3_shapes,
         k1_dense_blocks=n_dense, k1_compact_rows=rows,
         k1_nonzero_levels=int((la.levels != 0).sum()),
         k1_all_launches=launches['dequant_idct'],
         k2_frames=F, k2_batch_equal=True, k2_written_mbs=written,
         k2_coded_blocks=coded_blocks, k2_base_blocks=base_blocks,
         k2_bytes=k2_bytes, k2_ops=k2_ops,
         k2_bytes_ms=k2_bytes / HBM_BYTES_PER_S * 1e3,
         k2_ops_ms=k2_ops / INT32_OPS_PER_S * 1e3, k2_one_frame_ms=k2_one_ms,
         k2_copy_only_ms=k2_copy_ms, k2_far_vectors_ms=k2_far_ms,
         k2_segmented=segmented,
         k2_grid_ctas=kernels.lib().jt_mc_combine_grid(F * n_mb))
    print(json.dumps(line), flush=True)


def main() -> int:
    try:
        import torch
    except ImportError:
        print('chip_smoke: PyTorch is not installed', file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device is available', file=sys.stderr)
        return 1
    from jsmpeg_tpu_torch.host.native import host_canary
    from jsmpeg_tpu_torch.ops import kernels
    dev = torch.device(DEVICE)
    smi = phase_gpu()
    phase_build(kernels)
    emit('host_canary', **host_canary())
    errs = (phase_k1(torch, dev), phase_k2(torch, dev))
    es, chunks, ts_av, audio_es, stream = encode_stream()
    errs += (phase_k3(torch, es),)
    launches, cpu_frames = phase_main(torch, kernels, es, chunks, stream)
    phase_single(torch, kernels, es)
    phase_serial(torch, kernels)
    phase_dense(torch, kernels, chunks)
    pcm_exact = phase_player(torch, kernels, ts_av, cpu_frames)
    phase_audio(torch, audio_es, pcm_exact)
    phase_color(torch, cpu_frames)
    phase_cli(torch, ts_av, cpu_frames, pcm_exact)
    phase_live(torch, kernels, chunks, cpu_frames)
    phase_sparse_wire(torch, kernels, es, cpu_frames)
    t0 = time.monotonic()
    extra = encode_extra_streams(torch)
    emit('o0_fleet_streams', frames=list(MS_FRAMES), seeds=list(MS_SEEDS),
         encode_and_cpu_decode_s=time.monotonic() - t0)
    phase_multistream(torch, kernels, es, cpu_frames, extra)
    phase_fleet_sweep(torch, kernels, es, cpu_frames)
    phase_serve(torch, kernels, ts_av, extra, cpu_frames, pcm_exact)
    phase_cli_multi(torch, ts_av, extra, cpu_frames)
    phase_thumbs(torch, kernels, es, ts_av, cpu_frames)
    phase_fuzz(torch, kernels)
    phase_soak(torch, kernels)
    phase_checked(torch)
    phase_gop_mesh(torch, kernels, es, ts_av, extra, cpu_frames)
    phase_relay_live(torch, kernels, chunks, cpu_frames)
    band = phase_tile_mesh(torch, kernels, es, cpu_frames)
    phase_multiprocess(torch, kernels, es, cpu_frames)
    phase_kernels(torch, kernels, es, launches, errs, band)
    emit('host_canary_end', **host_canary())
    print(smi, flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())

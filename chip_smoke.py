#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (jsmpeg_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the host parser and the CUDA kernels from the checkout, holds each
kernel to its plain PyTorch version on the card, decodes a 96-frame 720p
MPEG-TS stream through `MPEG1Decoder` on the card (checked against the
same decoder on the CPU), runs the single-frame, serial-fallback and
dense-levels paths, and times every kernel beside its bound.  Each phase
prints one JSON line; the line before the last is the card's name and
power limit as nvidia-smi prints them, and the last line is
{"ok": true, "device": {...}}.  Any failure exits non-zero before that.
It needs a CUDA device and the repo's `jsmpeg_tpu_torch` package beside
it, and imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import threading
import time

import numpy as np

W, H = 1280, 720            # the operating point: 3600 macroblocks
N_FRAMES, GOP, SEED = 96, 12, 3
N_DENSE = 24                # frames of the dense-levels phase
N_REPEATS = 5               # warm repeats of the main-path decode
BATCH = 32                  # MPEG1Decoder.BATCH_FRAMES
DEVICE = 'cuda'

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
# csrc/mc_combine.cu per output pixel: 27 ops for a half-pel prediction
# (taps, clamps, addresses, rounding), 4 for a residual combine
MC_OPS_PER_PIXEL, COMBINE_OPS_PER_PIXEL = 27, 4
# clock cycles of the device-side sleep that cuda_ms enqueues ahead of the
# timed calls: ~0.1 s at the H100's ~2 GHz, longer than the host takes to
# enqueue them
HOLD_CYCLES = 200_000_000


def emit(phase: str, **kw) -> None:
    print(json.dumps({'phase': phase, **kw}), flush=True)


def bound(n_bytes: float, n_ops: float):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    integer ops over the int32 rate."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / INT32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            'bytes' if t_bytes >= t_ops else 'operations')


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


def phase_build(kernels):
    """Host parser (g++) and CUDA kernels (one nvcc per source) build in
    parallel; both from the checkout's sources."""
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
                                args=('kernels_s', kernels.ensure_built))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    kernels.lib()
    with open(kernels.LOG_PATH) as f:
        ptxas = [ln.strip() for ln in f
                 if 'registers' in ln or 'spill' in ln]
    emit('b_build', **{k: round(v, 3) for k, v in times.items()},
         library=kernels.SO_PATH, ptxas=ptxas)


def k1_inputs(torch, n_mb: int, rng, dev):
    """Random levels with the edge cases: clamps at +/-2047/-2048, large
    levels whose IDCT wraps int32, zeros (escape-coded zeros arrive as 0),
    intra DC up to 2047, qscale 1 and 31, custom matrices."""
    lv = rng.integers(-255, 256, (n_mb, 6, 64)).astype(np.int16)
    lv[rng.random((n_mb, 6, 64)) < 0.7] = 0
    edge = rng.random((n_mb, 6, 64))
    lv[edge < 0.01] = 2047
    lv[(edge >= 0.01) & (edge < 0.02)] = -2048
    lv[(edge >= 0.02) & (edge < 0.025)] = -2047
    lv[(edge >= 0.025) & (edge < 0.027)] = np.int16(32767)
    lv[(edge >= 0.027) & (edge < 0.029)] = np.int16(-32768)
    lv[:, :, 0] = np.where(rng.random((n_mb, 6)) < 0.5,
                           rng.integers(0, 2048, (n_mb, 6)), lv[:, :, 0])
    qs = rng.integers(1, 32, n_mb).astype(np.uint8)
    qs[::7] = 1
    qs[3::7] = 31
    intra = rng.random(n_mb) < 0.5
    iq = rng.integers(1, 256, 64).astype(np.int32)
    nq = rng.integers(1, 256, 64).astype(np.int32)
    iq[0] = 8
    t = lambda a: torch.as_tensor(a, device=dev)
    return t(lv), t(qs), t(intra), t(iq), t(nq)


def phase_k1(torch, dev):
    """K1 against dequant_idct_ref on the card: levels mode at the 720p
    32-frame batch shape (and a ragged tail), then the IDCT-only mode."""
    from jsmpeg_tpu_torch.ops import kernels
    from jsmpeg_tpu_torch.ops.idct import dequant_idct_ref, dequant_premult
    rng = np.random.default_rng(SEED)
    err = 0
    for n_mb in (BATCH * (W // 16) * (H // 16), 7):
        args = k1_inputs(torch, n_mb, rng, dev)
        got = kernels.dequant_idct_cuda(*args, premultiplied=False)
        err = max(err, equal_or_raise(f'K1 levels n_mb={n_mb}', got,
                                      dequant_idct_ref(*args)))
        coef = dequant_premult(*args)
        # plus blocks of arbitrary int32 coefficients: wrapping butterflies
        wild = torch.as_tensor(rng.integers(-2**31, 2**31, (n_mb, 1, 64),
                                            dtype=np.int64).astype(np.int32),
                               device=dev)
        coef[:, 5:6] = wild
        got = kernels.dequant_idct_cuda(coef, premultiplied=True)
        err = max(err, equal_or_raise(f'K1 premultiplied n_mb={n_mb}', got,
                                      dequant_idct_ref(coef,
                                                       premultiplied=True)))
    torch.cuda.synchronize()
    emit('c_k1_check', equal=True, max_abs_err=err,
         shape=[BATCH * (W // 16) * (H // 16), 6, 64])
    return err


def phase_k2(torch, dev):
    """K2 against mc_combine_ref on one 720p frame: all half-pel
    parities, vectors past every edge, wide and negative odd vectors,
    a mix of written/coded/intra, residuals that wrap int32."""
    from jsmpeg_tpu_torch.ops import kernels
    from jsmpeg_tpu_torch.ops.frame import Planes, mc_combine_ref
    rng = np.random.default_rng(SEED + 1)
    n_mb = (W // 16) * (H // 16)
    t = lambda a: torch.as_tensor(a, device=dev)

    def planes():
        return Planes(t(rng.integers(0, 256, (H, W), dtype=np.uint8)),
                      t(rng.integers(0, 256, (H // 2, W // 2),
                                     dtype=np.uint8)),
                      t(rng.integers(0, 256, (H // 2, W // 2),
                                     dtype=np.uint8)))

    cur, fwd = planes(), planes()
    reach = rng.choice([9, 300, 3000], size=(n_mb, 2))
    mv = rng.integers(-reach, reach + 1).astype(np.int32)
    mv[::11] = [-3, -5]                  # negative odd: chroma -1, -2
    resid = rng.integers(-400, 400, (n_mb, 6, 64)).astype(np.int32)
    resid[rng.random((n_mb, 6, 64)) < 0.001] = 2**31 - 1
    resid[rng.random((n_mb, 6, 64)) < 0.001] = -2**31
    mode = rng.integers(0, 256, n_mb).astype(np.int32)
    meta = t(np.stack([mv[:, 0], mv[:, 1], mode], axis=1))
    resid = t(resid)
    got = kernels.mc_combine_cuda(cur, fwd, resid, meta)
    want = mc_combine_ref(cur, fwd, resid, meta)
    err = max(equal_or_raise(f'K2 {pn}', g, w_)
              for pn, g, w_ in zip(('y', 'cr', 'cb'), got, want))
    torch.cuda.synchronize()
    emit('d_k2_check', equal=True, max_abs_err=err, frame=[H, W],
         parities=sorted({(int(a) & 1, int(b) & 1) for a, b in mv}))
    return err


def encode_stream():
    from jsmpeg_tpu_torch.demux import demux_to_es
    from jsmpeg_tpu_torch.testing.gen import encode_realistic_stream
    from jsmpeg_tpu_torch.testing.ts_mux import mux_video
    t0 = time.monotonic()
    es, chunks = encode_realistic_stream(W, H, n_frames=N_FRAMES, seed=SEED,
                                         gop=GOP)
    v = chunks[:-1]
    v[-1] = v[-1] + chunks[-1]
    ts = mux_video(v, 30.0)
    encode_s = time.monotonic() - t0
    t0 = time.monotonic()
    demuxed = demux_to_es(ts)
    demux_s = time.monotonic() - t0
    if demuxed != es:
        raise AssertionError('TS mux/demux did not round-trip the stream')
    return demuxed, chunks, {'encode_s': encode_s, 'demux_s': demux_s,
                             'ts_bytes': len(ts), 'es_bytes': len(es)}


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
    is checked too.  The same decode is then timed N_REPEATS times more,
    with the allocators warm from the first (each run's outputs released
    before the next)."""
    decode_all(torch, b''.join(chunks[:BATCH]), DEVICE)     # warm-up
    kernels.reset_launches()
    t0 = time.monotonic()
    outs = decode_all(torch, es, DEVICE)
    wall = time.monotonic() - t0
    launches = dict(kernels.launches)
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
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f'kernel {name} never launched on the '
                                 'main path')
    del outs, ref
    walls = []
    for _ in range(N_REPEATS):
        t0 = time.monotonic()
        again = decode_all(torch, es, DEVICE)
        walls.append(time.monotonic() - t0)
        if len(again) != N_FRAMES:
            raise AssertionError('a repeated decode lost frames')
        del again
    emit('e_main', frames=N_FRAMES, cpu_equal_frames=N_FRAMES,
         cpu_decode_s=cpu_s, wall_s=wall, fps=N_FRAMES / wall, repeat_wall_s=walls,
         repeat_fps_median=N_FRAMES / float(np.median(walls)),
         launches=launches, **stream)
    return launches


def phase_breakdown(torch, es: bytes):
    """Where one 32-frame batch's time goes: the decoder's own
    decode_available, with each stage it calls wrapped in a timer fenced
    by synchronizes (so the parse of batch k+1 no longer overlaps the
    device work of batch k).  Returns the last batch's decode_levels
    inputs (levels, quant matrices) as the decoder built them."""
    from jsmpeg_tpu_torch.models import mpeg1
    dec = mpeg1.MPEG1Decoder({'device': DEVICE})
    dec.write(0.0, es)
    out, last = {}, {}

    def timed(name, fn):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            r = fn(*a, **kw)
            torch.cuda.synchronize()
            out[name] = out.get(name, 0.0) + (time.monotonic() - t0) * 1e3
            last[fn.__name__] = a
            return r
        return run

    dec.parser.parse_batch = timed('parse_ms', dec.parser.parse_batch)
    dec._upload = timed('upload_ms', dec._upload)
    stages = {'build_fused_buffer': 'wire_build_ms',
              'unpack_fused': 'unpack_ms', 'packed_to_levels': 'unpack_ms',
              'decode_levels': 'device_decode_ms'}
    saved = {fn: getattr(mpeg1, fn) for fn in stages}
    try:
        for fn, name in stages.items():
            setattr(mpeg1, fn, timed(name, saved[fn]))
        n_frames = len(dec.decode_available(eof=True))
    finally:
        for fn, f in saved.items():
            setattr(mpeg1, fn, f)
    n_batches = -(-n_frames // BATCH)
    emit('e2_breakdown', batches=n_batches,
         per_batch_ms={k: v / n_batches for k, v in out.items()})
    _, _, la, iq, nq = last['decode_levels']
    return la, iq, nq


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
    want = decode_all(torch, es, 'cpu')
    if got is None or len(got) != 2 or len(want) != 2:
        raise AssertionError('serial path did not return both pictures')
    for i in range(2):
        planes_equal(f'serial frame {i}', host_planes(got[i]),
                     host_planes(want[i]))
    if min(launches.values()) <= 0:
        raise AssertionError(f'serial path skipped a kernel: {launches}')
    emit('g_serial_fallback', frames=2, equal=True, launches=launches)


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
    want = cpu.decode_available(eof=True)
    if len(got) != N_DENSE or len(want) != N_DENSE:
        raise AssertionError('dense-levels decode lost frames')
    for i in range(N_DENSE):
        planes_equal(f'dense-levels frame {i}', host_planes(got[i]),
                     host_planes(want[i]))
    if min(launches.values()) <= 0:
        raise AssertionError(f'dense-levels path skipped a kernel: '
                             f'{launches}')
    emit('g2_dense_levels', frames=N_DENSE, equal=True,
         launches=launches)


def phase_kernels(torch, kernels, la, iq, nq, launches, errs):
    """Each kernel's time at the main path's shape and data (the last
    32-frame batch of the stream), its plain version's time on the same
    inputs, and its bound."""
    from jsmpeg_tpu_torch.ops.frame import Planes, frame_meta, mc_combine_ref
    from jsmpeg_tpu_torch.ops.idct import dequant_idct_ref
    F, n_mb = la.qscale.shape
    args = (la.levels.reshape(F * n_mb, 6, 64), la.qscale.reshape(-1),
            la.intra.reshape(-1), iq, nq)
    n_blk = F * n_mb * 6
    k1_ms = cuda_ms(torch, lambda: kernels.dequant_idct_cuda(
        *args, premultiplied=False), iters=50)
    k1_plain = cuda_ms(torch, lambda: dequant_idct_ref(*args), iters=3,
                       warmup=1)
    nonzero = int((args[0] != 0).sum())
    k1_bytes = n_blk * 64 * (2 + 4) + 2 * F * n_mb + 2 * 64 * 4
    k1_ops = (n_blk * (IDCT_OPS_PER_BLOCK + 64 * DEQUANT_OPS_PER_LEVEL)
              + nonzero * DEQUANT_OPS_PER_NONZERO)
    k1_bound, k1_by = bound(k1_bytes, k1_ops)

    resid = kernels.dequant_idct_cuda(*args, premultiplied=False).reshape(
        F, n_mb, 6, 64)
    meta = frame_meta(la.coded, la.intra, la.written, la.mv_h, la.mv_v)
    Hc, Wc = (n_mb // (W // 16)) * 16, W
    z = lambda h, w: torch.zeros((h, w), dtype=torch.uint8,
                                 device=resid.device)
    cur = Planes(z(Hc, Wc), z(Hc // 2, Wc // 2), z(Hc // 2, Wc // 2))

    def loop(fn):
        c, f = cur, cur
        for k in range(F):
            c, f = f, fn(c, f, resid[k], meta[k])

    k2 = lambda c, f, r, m: Planes(*kernels.mc_combine_cuda(c, f, r, m))
    k2_ms = cuda_ms(torch, lambda: loop(k2), iters=10) / F
    k2_plain = cuda_ms(torch, lambda: loop(mc_combine_ref), iters=2,
                       warmup=1) / F
    written = int(la.written.sum())
    coded_blocks = int(la.coded.sum())
    # per frame: meta + output; the forward window where a macroblock is
    # written, else the stale pixel; the residual of coded blocks only
    k2_bytes = (F * n_mb * (12 + 384) + F * n_mb * 384
                + coded_blocks * 64 * 4) / F
    k2_ops = (written * 384 * MC_OPS_PER_PIXEL
              + coded_blocks * 64 * COMBINE_OPS_PER_PIXEL) / F
    k2_bound, k2_by = bound(k2_bytes, k2_ops)
    line = {'kernels': [
        {'name': 'dequant_idct', 'route': 'cuda',
         'source': 'jsmpeg_tpu_torch/csrc/dequant_idct.cu',
         'replaces': 'tools/idct_pallas_shelved.py:102',
         'launches': launches['dequant_idct'], 'max_abs_err': errs[0],
         'ms': k1_ms, 'plain_ms': k1_plain, 'bound_ms': k1_bound,
         'bound_by': k1_by, 'library_ms': None},
        {'name': 'mc_combine', 'route': 'cuda',
         'source': 'jsmpeg_tpu_torch/csrc/mc_combine.cu',
         'replaces': 'jsmpeg_tpu/ops/frame.py:138',
         'launches': launches['mc_combine'], 'max_abs_err': errs[1],
         'ms': k2_ms, 'plain_ms': k2_plain, 'bound_ms': k2_bound,
         'bound_by': k2_by, 'library_ms': None},
    ]}
    emit('h_kernel_detail', k1_blocks=n_blk, k1_nonzero_levels=nonzero,
         k2_frames=F, k2_written_mbs=written, k2_coded_blocks=coded_blocks)
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
    try:
        from jsmpeg_tpu_torch.ops import kernels
    except ImportError:
        print('chip_smoke: run from a checkout of the repo (the '
              'jsmpeg_tpu_torch package must sit beside this script)',
              file=sys.stderr)
        return 1
    dev = torch.device(DEVICE)
    smi = phase_gpu()
    phase_build(kernels)
    errs = (phase_k1(torch, dev), phase_k2(torch, dev))
    es, chunks, stream = encode_stream()
    launches = phase_main(torch, kernels, es, chunks, stream)
    la, iq, nq = phase_breakdown(torch, es)
    phase_single(torch, kernels, es)
    phase_serial(torch, kernels)
    phase_dense(torch, kernels, chunks)
    phase_kernels(torch, kernels, la, iq, nq, launches, errs)
    print(smi, flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())

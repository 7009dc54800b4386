"""The port's sanitizer rig: its native host code under ASan+UBSan and
TSan, and its three CUDA kernels under compute-sanitizer.

  python -m jsmpeg_tpu_torch.host.native.sanitize_check          # host
  python -m jsmpeg_tpu_torch.host.native.sanitize_check --cuda   # kernels

The host half makes fixture streams with the port's encoders
(`jsmpeg_tpu_torch.testing`), generates `vlc_tables.h` into a temporary
directory (as build_native.py does), builds `sanitize_main.cpp` with the
port's `frontend.cpp`, `mp2.cpp` and `ts_demux.cpp` into two standalone
executables (`-O1 -g`: ASan+UBSan with `-fno-sanitize-recover=all`, and
TSan) and runs each on every video fixture.  Any report, a non-zero exit
or a build that fails (a missing sanitizer runtime too) raises.

The CUDA half (`--cuda`, needs a GPU and the toolkit's compute-sanitizer)
runs `--cuda-driver` (the three kernels once each on small random inputs,
K2 in its three forms, each held to its plain version on the CPU) under
compute-sanitizer's memcheck, racecheck and synccheck tools; any error or
hazard raises.  Racecheck sees shared memory only: K2's readiness flags
and K3's look-back live in global memory, and no tool here proves them.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

NATIVE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(NATIVE)))
SOURCES = [os.path.join(NATIVE, s) for s in
           ('frontend.cpp', 'mp2.cpp', 'ts_demux.cpp', 'sanitize_main.cpp')]
FLAVORS = {'asan_ubsan': ['-fsanitize=address,undefined',
                          '-fno-sanitize-recover=all'],
           'tsan': ['-fsanitize=thread']}
# a report aborts the run (ASan, UBSan) or sets its exit code (TSan); the
# markers catch one that did neither
REPORT_MARKERS = ('ERROR: AddressSanitizer', 'ERROR: LeakSanitizer',
                  'WARNING: ThreadSanitizer', 'runtime error:',
                  'SUMMARY: AddressSanitizer', 'SUMMARY: UndefinedBehavior',
                  'SUMMARY: ThreadSanitizer')
SANITIZER_ENV = {'ASAN_OPTIONS': 'halt_on_error=1:detect_leaks=1',
                 'UBSAN_OPTIONS': 'halt_on_error=1:print_stacktrace=1',
                 'TSAN_OPTIONS': 'halt_on_error=1:exitcode=66'}
CUDA_TOOLS = ('memcheck', 'racecheck', 'synccheck')
CUDA_TIMEOUT = 600          # seconds for one tool's run of the driver
DRIVER_SEED = 12            # the driver's random inputs and streams
COMPUTE_SANITIZER_DEFAULT = '/usr/local/cuda/bin/compute-sanitizer'
DRIVER_OK = 'cuda driver OK'
LOG_DIR = os.path.join(ROOT, 'build', 'jsmpeg_tpu_torch', 'sanitize')


class SanitizerError(RuntimeError):
    """A sanitizer reported, a run failed, or a build failed."""


def make_fixtures(tmp: str) -> dict:
    """Fixture streams from the port's encoders: three MPEG1 ESs (160x128
    GOP 5; 320x240 realistic GOP 6; 64x48, 40 frames, GOP 8, so a batch
    of 32 has pictures for 8 threads), 24 MP2 frames, and the first
    video muxed with the audio as TS.  Returns {'video': [paths],
    'audio': path, 'ts': path}."""
    from ...testing.gen import encode_realistic_stream, encode_test_stream
    from ...testing.mp2_enc import encode_stream
    from ...testing.ts_mux import mux_av
    v1, c1 = encode_test_stream(160, 128, n_frames=10, seed=3, gop=5)
    v2, _ = encode_realistic_stream(320, 240, n_frames=12, seed=4, gop=6)
    v3, _ = encode_test_stream(64, 48, n_frames=40, seed=5, gop=8)
    a, af = encode_stream(24, seed=5)
    vch = c1[:-1]
    vch[-1] = vch[-1] + c1[-1]
    ts = mux_av(vch, 25.0, af, 1152, 44100)
    paths = {}
    for name, data in (('v1.es', v1), ('v2.es', v2), ('v3.es', v3),
                       ('a.mp2', a), ('av.ts', ts)):
        paths[name] = os.path.join(tmp, name)
        with open(paths[name], 'wb') as f:
            f.write(data)
    return {'video': [paths['v1.es'], paths['v2.es'], paths['v3.es']],
            'audio': paths['a.mp2'], 'ts': paths['av.ts']}


def generate_header(tmp: str) -> str:
    """vlc_tables.h generated into a directory of `tmp`; returns it."""
    from .gen_tables import generate
    inc = os.path.join(tmp, 'include')
    os.makedirs(inc, exist_ok=True)
    generate(os.path.join(inc, 'vlc_tables.h'))
    return inc


def build(tmp: str, flavor: str, sources, includes=()) -> str:
    """Compile `sources` with the sanitizers of `flavor` into an
    executable in `tmp`; returns its path.  A failed build raises."""
    exe = os.path.join(tmp, f'san_{flavor}')
    cmd = (['g++', '-O1', '-g', '-std=c++17', '-pthread']
           + FLAVORS[flavor] + [f'-I{d}' for d in includes]
           + list(sources) + ['-o', exe])
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise SanitizerError(f'{flavor}: the build failed (is the g++ '
                             f'sanitizer runtime installed?):\n'
                             f'{" ".join(cmd)}\n{r.stderr[-4000:]}')
    return exe


def run(exe: str, flavor: str, args) -> str:
    """Run a sanitizer executable; returns its stdout.  Raises on a
    non-zero exit or any sanitizer report."""
    r = subprocess.run([exe, *args], capture_output=True, text=True,
                       env={**os.environ, **SANITIZER_ENV}, timeout=600)
    reports = [m for m in REPORT_MARKERS if m in r.stderr]
    if r.returncode != 0 or reports:
        raise SanitizerError(
            f'{flavor} on {" ".join(os.path.basename(a) for a in args)}: '
            f'exit {r.returncode}, reports {reports}\n{r.stderr[-6000:]}')
    return r.stdout


def build_and_run(tmp: str, flavor: str, sources, runs,
                  includes=()) -> list:
    """Build `sources` under `flavor` and run the executable once per
    argument list of `runs`, in parallel; returns each run's stdout."""
    exe = build(tmp, flavor, sources, includes)
    with ThreadPoolExecutor(max_workers=len(runs)) as pool:
        return list(pool.map(lambda a: run(exe, flavor, a), runs))


def check_host(flavors=tuple(FLAVORS)) -> dict:
    """The host half: each flavour built (in parallel) and run on every
    video fixture.  Returns {flavor: {'seconds', 'runs': [stdout
    lines]}}; raises SanitizerError on any report."""
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        fx = make_fixtures(tmp)
        inc = generate_header(tmp)
        runs = [[v, fx['audio'], fx['ts']] for v in fx['video']]

        def one(flavor):
            t0 = time.monotonic()
            d = os.path.join(tmp, flavor)
            os.makedirs(d)
            lines = [s.strip() for s in build_and_run(
                d, flavor, SOURCES, runs, includes=(inc, NATIVE))]
            if not all(s.startswith('sanitize OK') for s in lines):
                raise SanitizerError(f'{flavor}: the driver did not finish: '
                                     f'{lines}')
            return flavor, {'seconds': time.monotonic() - t0, 'runs': lines}

        with ThreadPoolExecutor(max_workers=len(flavors)) as pool:
            for flavor, res in pool.map(one, flavors):
                out[flavor] = res
    return out


# ------------------------------------------------------------- CUDA half

def compute_sanitizer_path() -> str:
    home = os.environ.get('CUDA_HOME') or os.environ.get('CUDA_PATH')
    for cand in ((os.path.join(home, 'bin', 'compute-sanitizer')
                  if home else None),
                 shutil.which('compute-sanitizer'),
                 COMPUTE_SANITIZER_DEFAULT):
        if cand and os.path.exists(cand):
            return cand
    raise SanitizerError('compute-sanitizer not found (set CUDA_HOME): the '
                         "CUDA half of the rig needs the toolkit's "
                         'compute-sanitizer')


def _cpu(x):
    """A tensor, or a tuple or named tuple of them, on the CPU."""
    if hasattr(x, 'cpu'):
        return x.cpu()
    items = [_cpu(v) for v in x]
    return type(x)(*items) if hasattr(x, '_fields') else type(x)(items)


def _equal(name: str, got, want) -> None:
    for i, (g, w) in enumerate(zip(got, want)):
        if not bool((g.cpu() == w.cpu()).all()):
            raise AssertionError(f'{name}: output {i} differs from the '
                                 'plain version')


def cuda_driver() -> dict:
    """K1 (levels and IDCT-only modes), K2 (one stream, segments, bands)
    and K3 (one wire, a [2, L] stack) each on small random inputs from
    DRIVER_SEED (`testing.kernel_inputs`, where chip_smoke.py's checks
    draw theirs) at a 48x48 picture and at 720p shapes, each output held to
    its plain version on the CPU.  Returns the launches."""
    import torch

    from ...host.native import NativeMPEG1Parser
    from ...models.mpeg1 import unpack_wires_ref
    from ...ops import kernels
    from ...ops.frame import decode_frames_ref, mc_combine_ref
    from ...ops.idct import dequant_idct_ref
    from ...testing import kernel_inputs as ki
    from ...testing.gen import encode_realistic_stream, encode_test_stream
    if not torch.cuda.is_available():
        raise RuntimeError('sanitize_check --cuda-driver: no CUDA device '
                           'is available')
    rng = np.random.default_rng(DRIVER_SEED)
    dev = 'cuda'
    kernels.reset_launches()

    # K1 at 4 frames of 48x48 and 2 frames of 720p
    for n_mb in (4 * 9, 2 * 3600):
        args = ki.k1_inputs(torch, n_mb, rng, dev)
        _equal(f'K1 levels n_mb={n_mb}',
               [kernels.dequant_idct_cuda(*args)],
               [dequant_idct_ref(*_cpu(args))])
        coef = torch.as_tensor(rng.integers(
            -2**31, 2**31, (n_mb, 6, 64), dtype=np.int64).astype(np.int32),
            device=dev)
        _equal(f'K1 premultiplied n_mb={n_mb}',
               [kernels.dequant_idct_cuda(coef, premultiplied=True)],
               [dequant_idct_ref(coef.cpu(), premultiplied=True)])

    # K2, one stream: 4 frames of 48x48, 2 frames of 720p
    for F, H, W in ((4, 48, 48), (2, 720, 1280)):
        args = ki.k2_batch(torch, rng, dev, F, H, W)[:4]
        _equal(f'K2 one stream {W}x{H}', kernels.mc_combine_cuda(*args),
               decode_frames_ref(*_cpu(args)))
    # K2, segments: four 48x48 streams stacked, one past its count
    args = ki.k2_batch(torch, rng, dev, 4, 4 * 48, 48, n_seg=4)[:4]
    _equal('K2 segments',
           kernels.mc_combine_cuda(*args, 4, [4, 0, 3, 1]),
           decode_frames_ref(*_cpu(args), 4, [4, 0, 3, 1]))
    # K2, bands: a 48-wide picture of 7 macroblock rows in 3 bands, two
    # segments, a halo of 2 rows, vectors at the halo's full reach
    S, halo, mb_h, n_band = 2, 2, 7, 3
    local = -(-mb_h // n_band)
    for band in range(n_band):
        cur, fwd, resid, meta, b = ki.k2_band(torch, rng, dev, S, local,
                                              mb_h, halo, 48, band)
        got = kernels.mc_combine_cuda(cur, fwd, resid, meta, S, [4, 3],
                                      band=b)
        want = mc_combine_ref(*_cpu((cur, fwd, resid[0], meta[0])), S,
                              [4, 3], type(b)(*_cpu(b[:2]), *b[2:]))
        _equal(f'K2 band {band}', [g[0] for g in got], want)

    # K3: the wire of a 48x48 stream (3x3 macroblocks), of a 720p one,
    # and the 48x48 stream's two batches as a [2, L] stack
    small, _ = encode_test_stream(48, 48, n_frames=6, seed=DRIVER_SEED,
                                  gop=3)
    big, _ = encode_realistic_stream(1280, 720, n_frames=2,
                                     seed=DRIVER_SEED, gop=2)
    for name, es, frames, n_batch in (('48x48', small, 6, 1),
                                      ('720p', big, 2, 1),
                                      ('48x48 [2, L]', small, 3, 2)):
        p = NativeMPEG1Parser()
        p.write(es)
        batches = [p.parse_batch(frames, eof=True) for _ in range(n_batch)]
        if not all(isinstance(b, dict) and 'sp_pos' in b for b in batches):
            raise AssertionError(f'K3 {name}: no packed batch')
        bufs, sizes = (ki.exact_wire(batches[0], p.seq.mb_size)
                       if n_batch == 1 else
                       ki.shared_wires(batches, frames, p.seq.mb_size))
        _equal(f'K3 {name}',
               kernels.wire_unpack_cuda(torch.as_tensor(bufs, device=dev),
                                        *sizes),
               unpack_wires_ref(torch.as_tensor(bufs), *sizes))
    torch.cuda.synchronize()
    return dict(kernels.launches)


def _tool_summary(tool: str, out: str) -> dict:
    """The error (and, for racecheck, hazard) counts compute-sanitizer
    printed for one tool."""
    m = re.search(r'ERROR SUMMARY: (\d+) error', out)
    res = {'errors': int(m[1]) if m else None}
    m = re.search(r'RACECHECK SUMMARY: (\d+) hazards? displayed \((\d+) '
                  r'errors?, (\d+) warnings?\)', out)
    if m:
        res.update(hazards=int(m[1]), errors=int(m[2]), warnings=int(m[3]))
    return res


def _headlines(out: str, limit: int = 24) -> list:
    """compute-sanitizer's report lines without the stack frames."""
    keep = [ln.strip() for ln in out.splitlines()
            if ln.startswith('=========') and 'Frame' not in ln
            and ln.strip('= \n')]
    return keep[:limit]


def check_cuda(log_dir: str = LOG_DIR) -> dict:
    """The CUDA half: `--cuda-driver` under each compute-sanitizer tool,
    each tool's whole output kept in `log_dir`/<tool>.txt.  Returns
    {tool: {'seconds', 'rc', 'errors', ..., 'driver_ok', 'summary',
    'headlines'}}; raises SanitizerError, after every tool ran, on any
    report or failed driver, and at once on a missing tool or one that
    does not support the device (then nothing was checked)."""
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError('sanitize_check --cuda: no CUDA device is '
                           'available')
    cs = compute_sanitizer_path()
    version = subprocess.run([cs, '--version'], capture_output=True,
                             text=True).stdout.strip().splitlines()[-1:]
    # build the host library and the kernels outside the sanitizer
    from ...ops import kernels
    from .build_native import ensure_built
    ensure_built()
    kernels.ensure_built()
    os.makedirs(log_dir, exist_ok=True)
    out, failed = {}, []
    for tool in CUDA_TOOLS:
        cmd = [cs, '--tool', tool, '--error-exitcode', '86',
               sys.executable, '-m', 'jsmpeg_tpu_torch.host.native.'
               'sanitize_check', '--cuda-driver']
        t0 = time.monotonic()
        # without PyTorch's caching allocator every tensor is its own
        # allocation, so memcheck sees a read or write past its end
        r = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                           timeout=CUDA_TIMEOUT, env={
                               **os.environ,
                               'PYTORCH_NO_CUDA_MEMORY_CACHING': '1'})
        text = r.stdout + r.stderr
        path = os.path.join(log_dir, f'{tool}.txt')
        with open(path, 'w') as f:
            f.write(text)
        res = {'seconds': time.monotonic() - t0, 'rc': r.returncode,
               **_tool_summary(tool, text),
               'driver_ok': DRIVER_OK in r.stdout,
               'summary': [ln.strip() for ln in text.splitlines()
                           if 'SUMMARY' in ln],
               'headlines': _headlines(text)}
        refused = [h for h in res['headlines'] if 'not supported' in h]
        if refused:
            raise SanitizerError(
                f'compute-sanitizer ({" ".join(version)}) does not support '
                f'this device ({torch.cuda.get_device_name(0)}): '
                f'{refused[0]!r} under --tool {tool}; no kernel was '
                f'checked (whole output in {path})')
        out[tool] = res
        if (r.returncode != 0 or not res['driver_ok'] or res['errors'] != 0
                or res.get('hazards', 0) or res.get('warnings', 0)):
            failed.append(tool)
    if failed:
        raise SanitizerError(f'compute-sanitizer: {failed} reported or '
                             f'failed (whole outputs in {log_dir}):\n'
                             + json.dumps(out, indent=1))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--cuda', action='store_true',
                    help='the CUDA half: the kernels under '
                         'compute-sanitizer (needs a GPU)')
    ap.add_argument('--cuda-driver', action='store_true',
                    help='launch the kernels once each (run by --cuda '
                         'under each tool)')
    ap.add_argument('--log-dir', default=LOG_DIR,
                    help="where --cuda keeps each tool's whole output")
    args = ap.parse_args(argv)
    if args.cuda_driver:
        launches = cuda_driver()
        print(DRIVER_OK, json.dumps(launches), flush=True)
        return 0
    if args.cuda:
        res = check_cuda(log_dir=args.log_dir)
        print(json.dumps({'compute_sanitizer': res}), flush=True)
        print('all CUDA sanitizer tools clean', flush=True)
        return 0
    res = check_host()
    print(json.dumps({'host_cores': os.cpu_count(), **res}), flush=True)
    print('all sanitizers clean', flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())

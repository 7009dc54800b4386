"""The port's sanitizer rig: its native host code under ASan+UBSan and
TSan, and its three CUDA kernels under compute-sanitizer or built
checked.

  python -m jsmpeg_tpu_torch.host.native.sanitize_check          # host
  python -m jsmpeg_tpu_torch.host.native.sanitize_check --cuda   # kernels
  python -m jsmpeg_tpu_torch.host.native.sanitize_check --checked \
      [--seconds S] [--seed N]

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

The checked half (`--checked`, needs a GPU; compute-sanitizer refuses the
H100 where the port is measured) binds the kernels' checked build
(csrc/checked.cuh, ops/kernels.py `bind_checked`) in its own process and
runs (i) every `--cuda-driver` case, (ii) each with its outputs and
scratch poisoned with two bytes in turn (a byte that differs between the
two runs was never written) and under P perturbation seeds, each run held
to the plain version (P = CHECKED_PERTURB), (iii) the main stream (96
frames of 720p, `testing.kernel_cases`) through
`MPEG1Decoder.decode_available`, every frame held to the CPU decoder's,
(iv) the K2 and K3 cases of `testing.kernel_cases` and K2 on the main
batch with its uncoded residual slots poisoned, (v) the soak
(`fuzz_soak`) for S seconds (the elastic workers are processes of their
own, with the product library: counted apart), (vi) the seven negative
controls (`kernels.INJECTIONS`), each of which must be reported with its
kind at its site.  It prints one JSON line (faults, hazards, flag_faults,
unwritten, perturbed_mismatches, checked launches by kernel and form,
injections_reported, the checked build's seconds, each kernel's checked
over product time at the main batch) and exits 1 on any finding.
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

from ...testing import kernel_cases as kc

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


def driver_cases(rng, dev: str = 'cuda') -> list:
    """`--cuda-driver`'s cases, drawn from `rng` in a fixed order, as
    (name, launch, want): `launch()` runs one kernel call on the card and
    returns its outputs, `want` the plain version's on the CPU.  K1 in
    its three forms at 4 frames of 48x48 and 2 of 720p (the compact one on
    a random fifth of the blocks, in a random order, with unnamed rows:
    its output's named blocks only, the rest being no output of it); K2
    one stream at both,
    four 48x48 segments (one past its count), three bands of a 48-wide
    picture of 7 macroblock rows (two segments, a halo of 2 rows, vectors
    at the halo's full reach); K3 on the wire of a 48x48 stream, of a 720p
    one, and of the 48x48 stream's two batches as a [2, L] stack."""
    import torch

    from ...host.native import NativeMPEG1Parser
    from ...models.mpeg1 import unpack_wires_ref
    from ...ops import kernels
    from ...ops.frame import decode_frames_ref, mc_combine_ref
    from ...ops.idct import dequant_idct_compact_ref, dequant_idct_ref
    from ...testing import kernel_inputs as ki
    from ...testing.gen import encode_realistic_stream, encode_test_stream
    cases = []
    # the compact form's rows from a generator of their own, so that the
    # other cases' draws (and what they exercise) stay as they were
    compact_rng = np.random.default_rng(DRIVER_SEED + 1)
    for n_mb in (4 * 9, 2 * 3600):
        args = ki.k1_inputs(torch, n_mb, rng, dev)
        cases.append((f'K1 levels n_mb={n_mb}',
                      lambda a=args: [kernels.dequant_idct_cuda(*a)],
                      [dequant_idct_ref(*_cpu(args))]))
        coef = torch.as_tensor(rng.integers(
            -2**31, 2**31, (n_mb, 6, 64), dtype=np.int64).astype(np.int32),
            device=dev)
        cases.append((f'K1 premultiplied n_mb={n_mb}',
                      lambda c=coef: [kernels.dequant_idct_cuda(
                          c, premultiplied=True)],
                      [dequant_idct_ref(coef.cpu(), premultiplied=True)]))
        args = ki.k1_compact_inputs(torch, n_mb, compact_rng, dev)
        named = args[1][args[1] >= 0].long()
        cases.append((f'K1 compact n_mb={n_mb}',
                      lambda a=args, i=named: [
                          kernels.dequant_idct_compact_cuda(*a)[i]],
                      [dequant_idct_compact_ref(*_cpu(args[:6]),
                                                args[6])[named.cpu()]]))
    for F, H, W in ((4, 48, 48), (2, 720, 1280)):
        args = ki.k2_batch(torch, rng, dev, F, H, W)[:4]
        cases.append((f'K2 one stream {W}x{H}',
                      lambda a=args: kernels.mc_combine_cuda(*a),
                      decode_frames_ref(*_cpu(args))))
    args = ki.k2_batch(torch, rng, dev, 4, 4 * 48, 48, n_seg=4)[:4]
    cases.append(('K2 segments',
                  lambda a=args: kernels.mc_combine_cuda(*a, 4,
                                                         [4, 0, 3, 1]),
                  decode_frames_ref(*_cpu(args), 4, [4, 0, 3, 1])))
    S, halo, mb_h, n_band = 2, 2, 7, 3
    local = -(-mb_h // n_band)
    for band in range(n_band):
        cur, fwd, resid, meta, b = ki.k2_band(torch, rng, dev, S, local,
                                              mb_h, halo, 48, band)
        cases.append((f'K2 band {band}',
                      lambda a=(cur, fwd, resid, meta), b=b: [
                          g[0] for g in kernels.mc_combine_cuda(
                              *a, S, [4, 3], band=b)],
                      mc_combine_ref(*_cpu((cur, fwd, resid[0], meta[0])),
                                     S, [4, 3],
                                     type(b)(*_cpu(b[:2]), *b[2:]))))
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
        wire = torch.as_tensor(bufs, device=dev)
        cases.append((f'K3 {name}',
                      lambda w=wire, sz=sizes: kernels.wire_unpack_cuda(
                          w, *sz),
                      unpack_wires_ref(torch.as_tensor(bufs), *sizes)))
    return cases


def cuda_driver() -> dict:
    """Each of driver_cases (from DRIVER_SEED) launched once on the card
    and held to its plain version on the CPU.  Returns the launches."""
    import torch

    from ...ops import kernels
    if not torch.cuda.is_available():
        raise RuntimeError('sanitize_check --cuda-driver: no CUDA device '
                           'is available')
    kernels.reset_launches()
    for name, launch, want in driver_cases(
            np.random.default_rng(DRIVER_SEED)):
        _equal(name, launch(), want)
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


# ----------------------------------------------------------- checked half

POISONS = (0xA5, 0x5A)      # the two bytes outputs and scratch start as
CHECKED_SECONDS = 30        # the soak's wall in the checked rig
CHECKED_SEED = 1300         # the soak's first seed and the seeds' base
CHECKED_PERTURB = 4         # perturbation seeds per --cuda-driver case
# the main stream: 96 frames of 720p, GOPs of 12, seed 3
MAIN_STREAM = dict(width=kc.W, height=kc.H, n_frames=kc.N_FRAMES,
                   seed=kc.SEED, gop=kc.GOP)
PRODUCT_TIMING_ITERS = 20   # launches per product kernel timing
CHECKED_DEVICE = 'cuda'     # the checked rig's device
# the checked forms the main stream's decode must launch
MAIN_PATH_FORMS = ('wire_unpack', 'dequant_idct.compact',
                   'mc_combine.one_stream')
# K2 on the main batch with every uncoded residual slot set to each of
# these (K2 reads coded blocks only: the frames must not change)
UNCODED_POISONS = (0x7FFFFFFF, -0x80000000)


_T0 = time.monotonic()


def _progress(msg: str) -> None:
    """A progress line on stderr (the rig's seconds so far)."""
    print(f'[checked {time.monotonic() - _T0:8.2f}s] {msg}', file=sys.stderr,
          flush=True)


def _bytes(t):
    """A tensor's bytes, flat (a view where the tensor is contiguous)."""
    import torch
    return t.contiguous().view(-1).view(torch.uint8)


def raw_bytes(t):
    """A copy of a tensor's bytes.  A bool tensor's own clone may rewrite
    a poison byte as 1, hiding it: copy the bytes."""
    return _bytes(t).clone()


def unwritten(a, b) -> int:
    """Bytes that differ between two runs of one launch whose outputs
    were first filled with the two POISONS: never written by the launch,
    or not deterministic.  a, b: the runs' outputs, tensors in the same
    order (any dtype; compared as bytes)."""
    return sum(int((_bytes(x) != _bytes(y)).sum()) for x, y in zip(a, b))


def _same(got, want) -> bool:
    import torch
    return all(torch.equal(g, w.to(g.device)) for g, w in zip(got, want))


class CheckedRun:
    """The checked rig's tallies over its cases."""

    def __init__(self, chk):
        self.chk = chk
        self.cases = 0
        self.unwritten = 0
        self.unwritten_cases = []
        self.mismatches = []               # against the plain version
        self.perturbed_mismatches = []
        self.reports = []                  # CheckedFault messages

    def case(self, name: str, launch, want, seeds=()) -> None:
        """`launch` twice, its outputs first poisoned with each of
        POISONS (seed 0 and the first of `seeds` or 0), each held to
        `want` and to each other (`unwritten`); then once per remaining
        seed, poisoned in turn, held to `want`."""
        from ...ops.kernels import CheckedFault
        chk = self.chk
        self.cases += 1
        seeds = list(seeds)
        _progress(f'case {name}')
        try:
            runs = []
            for i, poison in enumerate(POISONS):
                chk.poison = poison
                chk.seed = seeds.pop(0) if i and seeds else 0
                got = launch()
                runs.append([raw_bytes(g) for g in got])
                if not _same(got, want):
                    self.mismatches.append(f'{name} poison {poison:#x}')
                del got
            n = unwritten(*runs)
            if n:
                self.unwritten += n
                self.unwritten_cases.append(f'{name}: {n} bytes')
            del runs
            for i, seed in enumerate(seeds):
                chk.poison, chk.seed = POISONS[i % 2], seed
                if not _same(launch(), want):
                    self.perturbed_mismatches.append(f'{name} seed {seed}')
        except CheckedFault as e:
            self.reports.append(f'{name}: {e}')
        finally:
            chk.poison, chk.seed = None, 0


def _decode(es: bytes, device: str) -> list:
    import torch

    from ...models.mpeg1 import MPEG1Decoder
    dec = MPEG1Decoder({'device': device})
    dec.write(0.0, es)
    outs = dec.decode_available(eof=True)
    if device != 'cpu':
        torch.cuda.synchronize()
    return [tuple(t.cpu().numpy() for t in p) for p in outs]


def _main_path(run: CheckedRun, es: bytes) -> dict:
    """(iii) The main stream through MPEG1Decoder.decode_available on the
    card, twice (poisoned each way, the second perturbed), every frame
    held to the CPU decoder's; the checked launches of each run."""
    from ...ops.kernels import CheckedFault
    chk = run.chk
    cpu = _decode(es, 'cpu')
    _progress('main stream decoded on the CPU')
    out = {'frames': len(cpu), 'runs': []}
    for poison, seed in zip(POISONS, (0, CHECKED_SEED)):
        before = dict(chk.launches)
        chk.poison, chk.seed = poison, seed
        try:
            got = _decode(es, CHECKED_DEVICE)
        except CheckedFault as e:
            run.reports.append(f'main path: {e}')
            got = []
        finally:
            chk.poison, chk.seed = None, 0
        diff = sum(any(not np.array_equal(a, b) for a, b in zip(g, w))
                   for g, w in zip(got, cpu)) + abs(len(got) - len(cpu))
        if diff:
            run.mismatches.append(f'main path poison {poison:#x}: {diff} '
                                  f'frames differ from the CPU')
        out['runs'].append({
            'poison': poison, 'seed': seed, 'frames_equal': len(cpu) - diff,
            'launches': {k: v - before[k] for k, v in chk.launches.items()
                         if v - before[k]}})
    return out


def _kernel_cases(run: CheckedRun, es: bytes) -> dict:
    """(iv) The kernel cases of `testing.kernel_cases`, poisoned both
    ways and perturbed: d_k2_check's batches (one stream and segments,
    random, far and one-row vectors; the bands), d_k3_check's wires
    (k3_cases) and k3_shape_wires' main, GOP-mesh, stacked-round and
    48-batch wires, each held to its plain version on the card; K2 on the
    main batch with its uncoded residual slots set to each of
    UNCODED_POISONS, held to the frames of the batch's own residuals."""
    import torch

    from ...models.mpeg1 import unpack_wires_ref
    from ...ops import kernels
    from ...ops.frame import (LevelsArrays, Planes, decode_frames_ref,
                              frame_meta, mc_combine_ref)
    from ...ops.idct import dequant_idct_compact_ref
    from ...testing.kernel_inputs import k2_band, k2_batch
    dev = CHECKED_DEVICE
    seeds = iter(range(CHECKED_SEED + 100, CHECKED_SEED + 10**6))
    names = []
    rng = np.random.default_rng(kc.SEED + 1)       # phase_k2's draws
    for n_seg, counts, vectors in (
            (1, None, 'random'), (kc.K2_SEGMENTS, kc.K2_SEG_FRAMES, 'random'),
            (1, None, 'far'), (kc.K2_SEGMENTS, kc.K2_SEG_FRAMES, 'far'),
            (1, None, 'one_row'),
            (kc.K2_SEGMENTS, kc.K2_SEG_FRAMES, 'one_row')):
        cur, fwd, resid, meta, _ = k2_batch(
            torch, rng, dev, kc.K2_CHECK_FRAMES, n_seg * kc.H, kc.W, vectors,
            n_seg)
        args = (cur, fwd, resid, meta, n_seg, counts)
        name = f'd_k2_check n_seg={n_seg} {vectors}'
        run.case(name, lambda a=args: kernels.mc_combine_cuda(*a),
                 decode_frames_ref(*args), [next(seeds)])
        names.append(name)
    S, local = kc.K2_BAND_SEGS, -(-kc.K2_BAND_MB_H // kc.K2_BANDS)
    for band in range(kc.K2_BANDS):
        cur, fwd, resid, meta, b = k2_band(torch, rng, dev, S, local,
                                           kc.K2_BAND_MB_H, kc.K2_BAND_HALO,
                                           kc.W, band)
        name = f'd_k2_check band {band}'
        run.case(name, lambda a=(cur, fwd, resid, meta), b=b: [
                     g[0] for g in kernels.mc_combine_cuda(*a, S, [4, 3],
                                                           band=b)],
                 mc_combine_ref(cur, fwd, resid[0], meta[0], S, [4, 3], b),
                 [next(seeds)])
        names.append(name)
    for name, bufs, sizes, ref in kc.k3_cases(es):
        wire = torch.as_tensor(bufs, device=dev)
        run.case(f'd_k3_check {name}',
                 lambda w=wire, sz=sizes: kernels.wire_unpack_cuda(w, *sz),
                 unpack_wires_ref(torch.as_tensor(ref, device=dev), *sizes),
                 [next(seeds)])
        names.append(f'd_k3_check {name}')
        del wire
    main = None
    for name, buf, sizes, copies in kc.k3_shape_wires(es, kc.GOP):
        wire = torch.as_tensor(buf, device=dev)
        if copies == 1:
            want = LevelsArrays(*unpack_wires_ref(wire, *sizes))
            if name == 'main':
                main = want
        else:            # each frame holds `copies` copies of 'main's
            want = kc.k3_copies(torch, main, copies)
        run.case(f'k3_shape_wires {name}',
                 lambda w=wire, sz=sizes: kernels.wire_unpack_cuda(w, *sz),
                 want, [next(seeds)])
        names.append(f'k3_shape_wires {name}')
        del wire, want
        torch.cuda.empty_cache()
    # K2 on the main batch, its uncoded residual slots poisoned
    F, M = main.qscale.shape
    iq, nq = (torch.as_tensor(q, device=dev) for q in rng.integers(
        1, 256, (2, 64), dtype=np.int32))
    resid = dequant_idct_compact_ref(
        main.levels, main.blk_ids, main.qscale.reshape(-1),
        main.intra.reshape(-1), iq, nq, F * M * 6).reshape(F, M, 6, 64)
    meta = frame_meta(main.coded, main.intra, main.written, main.mv_h,
                      main.mv_v)
    H = M // (kc.W // 16) * 16
    zero = Planes(*[torch.zeros((h, w), dtype=torch.uint8, device=dev)
                    for h, w in ((H, kc.W), (H // 2, kc.W // 2),
                                 (H // 2, kc.W // 2))])
    want = decode_frames_ref(zero, zero, resid, meta)
    for poison in UNCODED_POISONS:
        bad = resid.masked_fill(~main.coded[..., None], poison)
        name = f'K2 uncoded residuals {poison:#x}'
        run.case(name, lambda r=bad: kernels.mc_combine_cuda(zero, zero, r,
                                                             meta),
                 want, [next(seeds)])
        names.append(name)
    return {'cases': names}


def _soak(run: CheckedRun, seconds: float, seed: int) -> dict:
    """(v) fuzz_soak.main on the card for `seconds` from `seed`, outputs
    poisoned and launches perturbed; every decode held to the CPU.  The
    elastic rounds' workers are processes of their own, with the product
    library: they are counted apart."""
    from ... import fuzz_soak
    chk = run.chk
    stats = {}
    before = dict(chk.launches)
    with tempfile.TemporaryDirectory() as tmp:
        log = os.path.join(tmp, 'soak.jsonl')
        chk.poison, chk.seed = POISONS[0], seed
        try:
            fuzz_soak.main(['--seconds', str(seconds), '--seed', str(seed),
                            '--log', log, '--device', CHECKED_DEVICE],
                           stats)
        finally:
            chk.poison, chk.seed = None, 0
        failures = []
        if os.path.exists(log):
            with open(log) as f:
                failures = [json.loads(ln) for ln in f if ln.strip()]
    rounds = stats['rounds']
    elastic = rounds.get('elastic', 0)
    for rec in failures:
        run.reports.append(f'soak seed {rec["seed"]}: {rec["error"]}')
    return {'iterations': stats['iterations'],
            'in_process_iterations': stats['iterations'] - elastic,
            'failures': stats['failures'], 'seed': seed,
            'seconds': stats['seconds'],
            'checked_rounds': {k: v for k, v in rounds.items()
                               if k != 'elastic'},
            'unchecked_rounds': {'elastic': elastic},
            'launches': {k: v - before[k] for k, v in chk.launches.items()
                         if v - before[k]}}


# where each negative control is planted: a --cuda-driver case by name
INJECTION_CASES = {1: 'K1 levels n_mb=7200', 2: 'K2 one stream 1280x720',
                   3: 'K2 one stream 1280x720', 4: 'K2 one stream 1280x720',
                   5: 'K3 720p', 6: 'K3 720p', 7: 'K1 compact n_mb=7200'}


def planted_unwritten(inj: int, runs) -> tuple:
    """Where negative control `inj` ('unwritten') leaves bytes unwritten,
    in the outputs of its case's two poisoned runs: 6, the rows of launch
    B's first warp (the coded blocks of macroblocks 0-3 of frame 0 of
    stream 0: rows 0.. of K3's compact levels); 7, K1's compact row 0 (the
    case's first output row).  Returns (the bytes there that differ
    between the runs, the bytes there)."""
    a, b = runs
    rows = int(a[2][0, :4].sum()) if inj == 6 else 1
    return (unwritten([a[0][:rows]], [b[0][:rows]]),
            rows * a[0][0].numel() * a[0].element_size())


def _injections(run: CheckedRun, cases: dict) -> dict:
    """(vi) Each negative control planted in its case (poisoned both
    ways): a device report of one of its kinds at a site in one of its
    functions, or for 'unwritten' exactly the bytes it skips
    (planted_unwritten) left unwritten, no other, and no device report.
    Returns {id: {reported, ...}}."""
    from ...ops.kernels import INJECTIONS, CheckedFault
    chk = run.chk
    out = {}
    for inj, spec in INJECTIONS.items():
        launch = cases[INJECTION_CASES[inj]]
        res = {'what': spec.what, 'case': INJECTION_CASES[inj],
               'reported': False}
        chk.inject = inj
        runs = []
        try:
            for poison in POISONS:
                chk.poison = poison
                runs.append(launch())
        except CheckedFault as e:
            first = e.reports[0]
            res.update(kind=first['kind'], where=first['where'],
                       function=first['function'],
                       counts=first['counts'])
            res['reported'] = (first['kind'] in spec.kinds and
                               first['function'] in spec.functions)
        finally:
            chk.inject, chk.poison = 0, None
        if len(runs) == 2:
            per = [unwritten([a], [b]) for a, b in zip(*runs)]
            res.update(kind='unwritten' if any(per) else None,
                       unwritten_bytes=per)
            if 'unwritten' in spec.kinds:
                inside, size = planted_unwritten(inj, runs)
                res['reported'] = (per[0] == inside == size > 0 and
                                   not any(per[1:]))
                res['function'] = (spec.functions[0] if res['reported']
                                   else None)
        out[inj] = res
    return out


def main_batch_ms(wire_path: str, iters: int) -> dict:
    """K3, K1 and K2 on the main path's last 32-frame batch (the wire
    saved at `wire_path` by the checked rig), each the mean of `iters`
    calls between two CUDA events, on whatever library this process
    bound: K3 on the wire, K1 on its levels, K2 on K1's residuals from
    zeroed carry planes.  K1 is its compact form, the main path's.
    Returns {'wire_unpack', 'dequant_idct', 'mc_combine'} in ms."""
    import torch

    from ...ops import kernels
    from ...ops.frame import LevelsArrays, Planes, frame_meta
    dev = CHECKED_DEVICE
    with np.load(wire_path) as z:
        wire = torch.as_tensor(z['buf'], device=dev)
        sizes = tuple(int(v) for v in z['sizes'])
        iq = torch.as_tensor(z['iq'], device=dev)
        nq = torch.as_tensor(z['nq'], device=dev)
        width = int(z['width'])
    la = LevelsArrays(*kernels.wire_unpack_cuda(wire, *sizes))
    F, n_mb = la.qscale.shape
    k1 = (la.levels, la.blk_ids, la.qscale.reshape(-1), la.intra.reshape(-1),
          iq, nq, F * n_mb * 6)
    resid = kernels.dequant_idct_compact_cuda(*k1).reshape(F, n_mb, 6, 64)
    meta = frame_meta(la.coded, la.intra, la.written, la.mv_h, la.mv_v)
    H = n_mb // (width // 16) * 16
    z = lambda h, w: torch.zeros((h, w), dtype=torch.uint8, device=dev)
    cur = Planes(z(H, width), z(H // 2, width // 2), z(H // 2, width // 2))
    out = {}
    for name, fn in (('wire_unpack',
                      lambda: kernels.wire_unpack_cuda(wire, *sizes)),
                     ('dequant_idct',
                      lambda: kernels.dequant_idct_compact_cuda(*k1)),
                     ('mc_combine', lambda: kernels.mc_combine_cuda(
                         cur, cur, resid, meta))):
        fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        torch.cuda.synchronize()
        out[name] = a.elapsed_time(b) / iters
    return out


def _save_main_batch(es: bytes, path: str) -> None:
    """The main stream's last 32-frame batch wire and quant matrices."""
    _, buf, sizes, _ = kc.k3_shape_wires(es, kc.GOP)[0]
    iq, nq = kc.stream_quant(es)
    np.savez(path, buf=buf, sizes=np.array([int(v) for v in sizes]),
             iq=iq, nq=nq, width=MAIN_STREAM['width'])


def check_checked(seconds: float = CHECKED_SECONDS,
                  seed: int = CHECKED_SEED,
                  perturb: int = CHECKED_PERTURB) -> dict:
    """The checked rig (this process binds the checked library first):
    (i) every --cuda-driver case, (ii) each poisoned both ways and under
    `perturb` seeds, (iii) the main stream's decode, (iv) the kernel
    cases, (v) the soak for `seconds` from `seed`, (vi) the seven
    negative controls; then the main batch's kernels timed checked here
    and product in a child process.  Returns the summary; `ok` is False
    on any finding."""
    import torch

    from ...ops import kernels
    from ...testing.gen import encode_realistic_stream
    if not torch.cuda.is_available():
        raise RuntimeError('sanitize_check --checked: no CUDA device is '
                           'available')
    t0 = time.monotonic()
    chk = kernels.bind_checked()
    bind_s = time.monotonic() - t0
    run = CheckedRun(chk)
    res = {'device': torch.cuda.get_device_name(0),
           'build_s': _checked_build_seconds(), 'bind_s': bind_s}
    t = time.monotonic()
    cases = driver_cases(np.random.default_rng(DRIVER_SEED), CHECKED_DEVICE)
    for i, (name, launch, want) in enumerate(cases):
        run.case(name, launch, want,
                 [seed + 10 * i + k + 1 for k in range(perturb)])
    res['driver_s'] = time.monotonic() - t
    t = time.monotonic()
    _progress('main stream')
    es, _ = encode_realistic_stream(
        MAIN_STREAM['width'], MAIN_STREAM['height'],
        n_frames=MAIN_STREAM['n_frames'], seed=MAIN_STREAM['seed'],
        gop=MAIN_STREAM['gop'])
    res['main_path'] = _main_path(run, es)
    res['main_path_s'] = time.monotonic() - t
    t = time.monotonic()
    res['kernel_cases'] = _kernel_cases(run, es)
    res['kernel_cases_s'] = time.monotonic() - t
    _progress('soak')
    res['soak'] = _soak(run, seconds, seed)
    _progress('negative controls')
    t = time.monotonic()
    inj = _injections(run, {n: f for n, f, _ in cases})
    res['injections'] = inj
    res['injections_reported'] = (f'{sum(r["reported"] for r in inj.values())}'
                                  f'/{len(inj)}')
    res['injections_s'] = time.monotonic() - t
    _progress('timing the main batch')
    res.update(_slowdown(es))
    _progress('done')
    return _summarize(run, res)


def _checked_build_seconds():
    """The checked library's build time, from its build log (None when it
    was built by another process before this log recorded it)."""
    from ...ops import kernels
    try:
        with open(kernels.CHECKED_LOG_PATH) as f:
            m = re.findall(r'# build seconds: ([0-9.]+)', f.read())
        return float(m[-1]) if m else None
    except OSError:
        return None


def _slowdown(es: bytes) -> dict:
    """Each kernel's checked-over-product time at the main batch: checked
    here (one call per timing: each checked call waits for itself),
    product in a child process with the product library."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, 'main_batch.npz')
        _save_main_batch(es, path)
        checked = main_batch_ms(path, iters=3)
        code = ('import json, sys\n'
                'from jsmpeg_tpu_torch.host.native.sanitize_check import '
                'main_batch_ms\n'
                f'print(json.dumps(main_batch_ms({path!r}, '
                f'{PRODUCT_TIMING_ITERS})))')
        r = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                           capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        raise RuntimeError(f'product timing child failed:\n{r.stderr[-3000:]}')
    product = json.loads(r.stdout.strip().splitlines()[-1])
    return {'checked_ms': checked, 'product_ms': product,
            'slowdown': {k: checked[k] / product[k] for k in checked}}


def _summarize(run: CheckedRun, res: dict) -> dict:
    from ...ops import kernels
    chk = run.chk
    faults = dict.fromkeys(('faults', 'hazards', 'flag_faults'), 0)
    for kind, n in chk.faults.items():      # the injections' apart
        faults[kernels.CATEGORY[kind]] += n
    res.update(faults)
    res['unwritten'] = run.unwritten
    res['unwritten_cases'] = run.unwritten_cases
    res['perturbed_mismatches'] = len(run.perturbed_mismatches)
    res['perturbed'] = run.perturbed_mismatches
    res['mismatches'] = run.mismatches
    res['reports'] = run.reports[:20]
    res['cases'] = run.cases
    res['checked_launches'] = dict(chk.launches)
    missing = [f for f in kernels.CHECKED_FORMS if not chk.launches[f]]
    # the main path's own run went through K3, K1 and K2
    missing += [f'main path {f}' for f in MAIN_PATH_FORMS
                for r in res['main_path']['runs'] if not r['launches'].get(f)]
    res['ok'] = not (any(faults.values()) or run.unwritten or
                     run.perturbed_mismatches or run.mismatches or
                     run.reports or missing or
                     res['injections_reported'] != f'{len(res["injections"])}'
                     f'/{len(res["injections"])}' or
                     res['soak']['in_process_iterations'] < 1)
    res['missing_forms'] = missing
    return res


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
    ap.add_argument('--checked', action='store_true',
                    help='the kernels built checked (csrc/checked.cuh): '
                         'bounds, shared-memory hazards, flag protocols, '
                         'poisoned outputs, perturbed schedules and '
                         'negative controls (needs a GPU)')
    ap.add_argument('--seconds', type=float, default=CHECKED_SECONDS,
                    help="--checked: the soak's wall")
    ap.add_argument('--seed', type=int, default=CHECKED_SEED,
                    help="--checked: the soak's first seed and the "
                         "perturbation seeds' base")
    args = ap.parse_args(argv)
    if args.checked:
        res = check_checked(args.seconds, args.seed)
        print(json.dumps({'checked': res}, default=str), flush=True)
        if not res['ok']:
            print('the checked kernels reported findings', file=sys.stderr,
                  flush=True)
            return 1
        print('checked kernels clean', flush=True)
        return 0
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

"""Run one cell of the port's benchmark once:

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  It measures `jsmpeg_tpu_torch` on the card
and prints, as the last line of its standard output, one JSON object:
`correct`, `attempted`, `failed`, `metrics` (the cell's end-to-end
metrics with --trace 0, its per-layer metrics with --trace 1), `device`
and, traced, `breakdown`; then `compared`, each number the correctness
check compared beside its limit.  The same numbers close its standard
error.  Without a card, with fewer cards than the cell asks for, or if
JAX or the JAX package was loaded, it exits non-zero and prints no
result.

The set-up time `setup_s` runs from the start of this process to the
start of the window: imports, the port's builds (its host library and
CUDA kernels, compiled in a checkout's first run), the device and the
warm-up of the cell's own shapes.  It leaves out the benchmark's own
inputs (the pool of GOPs, encoded from the seed or read from
`portbench/.cache/`, and the files or feeds muxed from it), which no
user of the program makes.  The result line gives both apart under
`setup_parts`: `build_s` (inside `setup_s`) and `inputs_s` (outside).
The plain reference runs after the window, outside both.
"""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

# top-level module names no run may load: JAX and the JAX package (whole
# names: the port's own `jsmpeg_tpu_torch` is not one of them)
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'jsmpeg_tpu')
HERE = os.path.dirname(os.path.abspath(__file__))


def forbidden_modules(modules=None) -> list:
    """The forbidden top-level names among the loaded modules."""
    names = {m.split('.')[0] for m in (sys.modules if modules is None
                                       else modules)}
    return sorted(names & set(FORBIDDEN))


def cache_env() -> None:
    """Every build and kernel cache at a fixed path inside the checkout:
    the port's own nvcc and host builds go to `build/jsmpeg_tpu_torch/`
    beside its package; these catch what torch would build."""
    base = os.path.join(HERE, '.cache')
    os.environ['TORCH_EXTENSIONS_DIR'] = os.path.join(base,
                                                      'torch_extensions')
    os.environ['TRITON_CACHE_DIR'] = os.path.join(base, 'triton')
    # a library that would load JAX by itself (transformers) does not
    os.environ['USE_FLAX'] = '0'
    os.environ['USE_JAX'] = '0'


def build_program(cuda: bool) -> float:
    """Builds the port's host library and, on a card, its CUDA kernels
    where they are missing or stale (a checkout's first run); the
    seconds it took."""
    t0 = time.monotonic()
    from jsmpeg_tpu_torch.host.native.build_native import ensure_built
    ensure_built()
    if cuda:
        from jsmpeg_tpu_torch.ops import kernels
        kernels.ensure_built()
    return time.monotonic() - t0


def run_cell(cell, seed: int, seconds: float, trace: bool, device: str,
             t_start: float, control: bool = False, base: str = HERE) -> dict:
    """One run of `cell` (a `spec.Cell`) on `device`: set-up, the window,
    the reference check.  Returns the result's fields."""
    from . import spec
    from .loads.base import say
    from .trace import Spans
    import torch
    cuda = device != 'cpu'
    gen = spec.load(cell.traffic)
    run = gen.Cell(cell, seed, device, seconds,
                   spans=Spans() if trace else None, control=control)
    try:
        build_s = build_program(cuda)
        run.setup()
        setup_s = time.monotonic() - t_start - run.inputs_s
        say(f'set-up {setup_s:.1f} s (the build {build_s:.1f} s), the '
            f'inputs {run.inputs_s:.1f} s')
        t0 = time.monotonic()
        run.measure()
        say(f'window and its tail {time.monotonic() - t0:.1f} s')
        peak = torch.cuda.max_memory_allocated() if cuda else 0
    finally:
        run.release()
    t0 = time.monotonic()
    compared = run.check()
    say(f'reference check {time.monotonic() - t0:.1f} s')
    correct = all(c.value <= c.limit for c in compared)
    if trace:
        metrics = {}
        for m in cell.per_layer:
            v = spec.reader(m['name'], base)(run)
            if v is not None:
                metrics[m['name']] = {'value': float(v), 'unit': m['unit']}
    else:
        values = dict(run.end_to_end(), setup_s=setup_s)
        metrics = {m['name']: {'value': float(values[m['name']]),
                               'unit': m['unit']}
                   for m in cell.end_to_end}
    dev = {'platform': 'gpu' if cuda else 'cpu',
           'kind': (torch.cuda.get_device_name(0) if cuda else 'cpu'),
           'count': int(cell.workload.get('chips', 1)),
           'memory_peak_bytes': int(peak)}
    out = {'correct': bool(correct), 'attempted': int(run.attempted()),
           'failed': int(run.failed), 'metrics': metrics, 'device': dev}
    if trace and run.trace is not None:
        tr = run.trace
        dev['busy_s'] = tr.busy_s
        dev['window_s'] = tr.window_s
        out['breakdown'] = {'device_ops': tr.top_ops(10),
                            'idle_gaps': tr.gaps_by_host(run.spans.spans,
                                                         10)}
    out['setup_parts'] = {'build_s': build_s, 'inputs_s': run.inputs_s}
    out['compared'] = {c.name: {'value': c.value, 'limit': c.limit}
                       for c in compared}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog='portbench.run')
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    # the correctness control (PERF.md): not a run the benchmark makes
    ap.add_argument('--control', action='store_true')
    args = ap.parse_args(argv)
    cache_env()
    from . import spec
    cell = spec.cell(args.workload)
    import torch
    chips = int(cell.workload.get('chips', 1))
    if not torch.cuda.is_available():
        print('portbench: no CUDA device is available', file=sys.stderr)
        return 3
    if torch.cuda.device_count() < chips:
        print(f'portbench: {args.workload} needs {chips} cards, '
              f'{torch.cuda.device_count()} visible', file=sys.stderr)
        return 3
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), 'cuda',
                   T_START, control=args.control)
    bad = forbidden_modules()
    if bad:
        print(f'portbench: the run loaded {bad}', file=sys.stderr)
        return 4
    for name, c in out['compared'].items():
        print(f"compared {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())

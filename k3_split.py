#!/usr/bin/env python3
"""Time K3, the wire unpack (jsmpeg_tpu_torch/csrc/wire_unpack.cu), of two
checkouts on one NVIDIA GPU, in turns, launch by launch.

    python3 k3_split.py [--baseline DIR] [--iters N]

DIR is another checkout of the repo (for instance a parent commit
unpacked with `git archive` into a directory `.gitignore` lists).  The
wires are chip_smoke.py's `k3_shape_wires`, made once here from its
96-frame 1280x720 stream (seed 3, GOP 12): the main path's last 32-frame
batch, the GOP mesh's joint wire, the stacked fleet's round of four
streams, and 48 copies of the batch stacked (5.5 M macroblocks).  Each
turn (baseline, this checkout, this checkout, baseline; this checkout
twice alone without --baseline) is a fresh process that imports
`jsmpeg_tpu_torch` from its own checkout (building its kernels there) and
times its K3 on each wire with this checkout's chip_smoke.py helpers:
- `ms`: a call's device time, back to back behind a device-side sleep
  (`cuda_ms`);
- `profiled`: each kernel and memset of `iters` calls as the profiler
  traces them, by name (`profiled_us`);
- `digest`: a checksum of each output (`k3_digest`); every turn's must
  match on every wire, or the script fails;
- on the main batch also `vmap_4_ms`, four copies as one [4, L] call, and
  `host_us`, the host's time to enqueue one call while the stream is held
  (`host_us`).
Prints one JSON line per turn, then the card's name and power limit.
Needs a CUDA device and imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

WORKER = r'''
import importlib.util, json, sys
import numpy as np
import torch
from jsmpeg_tpu_torch.ops import kernels

spec = importlib.util.spec_from_file_location('smoke', sys.argv[3])
smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(smoke)
data = np.load(sys.argv[1])
iters = int(sys.argv[2])
out = {'sub_launches_per_call': kernels.lib().jt_wire_unpack_launches()}
for name in json.loads(sys.argv[4]):
    f, n_mb, runs, wide, pairs, esc, blk = (int(x) for x in data[name + '_sizes'])
    args = (torch.as_tensor(data[name]).cuda(), f, n_mb, runs, bool(wide),
            pairs, esc, blk)
    call = lambda: kernels.wire_unpack_cuda(*args)
    r = {'digest': smoke.k3_digest(torch, call()),
         'ms': smoke.cuda_ms(torch, call, iters),
         'profiled': smoke.profiled_us(torch, call, iters)}
    if name == 'main':
        args4 = (args[0].repeat(4, 1),) + args[1:]
        r['vmap_4_ms'] = smoke.cuda_ms(
            torch, lambda: kernels.wire_unpack_cuda(*args4), iters)
        r['host_us'] = smoke.host_us(torch, call, 50)
    out[name] = r
    del args
print(json.dumps(out))
'''


def run_turn(tree: str, data: str, iters: int, names: list) -> dict:
    out = subprocess.run([sys.executable, '-c', WORKER, data, str(iters),
                          os.path.join(HERE, 'chip_smoke.py'),
                          json.dumps(names)],
                         cwd=tree, check=True, capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=tree))
    return json.loads(out.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--baseline', help='another checkout of the repo')
    ap.add_argument('--iters', type=int, default=20,
                    help='calls timed and traced on each wire in each turn')
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print('k3_split: no CUDA device is available', file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import chip_smoke
    es = chip_smoke.encode_stream()[0]
    wires = chip_smoke.k3_shape_wires(es, chip_smoke.GOP)
    names = [w[0] for w in wires]
    trees = {'this': HERE}
    order = ('this', 'this')
    if args.baseline:
        trees['baseline'] = os.path.abspath(args.baseline)
        order = ('baseline', 'this', 'this', 'baseline')
    digests = {}
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, 'wires.npz')
        np.savez(data, **{n: b for n, b, _, _ in wires},
                 **{n + '_sizes': np.asarray(s, np.int64)
                    for n, _, s, _ in wires})
        for turn, name in enumerate(order):
            r = run_turn(trees[name], data, args.iters, names)
            print(json.dumps({'turn': turn, 'tree': name, **r}), flush=True)
            for n in names:
                if digests.setdefault(n, r[n]['digest']) != r[n]['digest']:
                    raise AssertionError(f'turn {turn} ({name}) unpacks '
                                         f'{n} differently')
    print(chip_smoke.phase_gpu(), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())

"""A benchmark of small cells over the test data's configurations and
mixes, run on the CPU with the program's plain versions."""

from __future__ import annotations

import copy
import os
import time

from portbench import spec

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'data')

# test cell -> (config, mix) under DATA, and the real cell it stands for
CELLS = {'tiny_av.offline': ('tiny_av', 'tiny_offline',
                             'mpeg1_720p30.offline'),
         'tiny_video.live1': ('tiny_video', 'tiny_live1',
                              'mpeg1_540p30.live1')}


def tiny_bench() -> dict:
    """BENCHMARK.json with its cells replaced by the test cells, each
    metric applying to the test cell of the real cells it lists."""
    b = copy.deepcopy(spec.benchmark())
    real = {v[2]: k for k, v in CELLS.items()}
    b['workloads'] = [{'name': k, 'config': c, 'traffic': t, 'chips': 1,
                       'why': 'test'} for k, (c, t, _) in CELLS.items()]
    for m in b['end_to_end'] + b['per_layer']:
        if 'workloads' in m:
            m['workloads'] = [real[w] for w in m['workloads'] if w in real]
    return b


def tiny_cell(name: str):
    return spec.cell(name, bench=tiny_bench(), base=DATA)


def run_tiny(name: str, seed: int = 7, seconds: float = 1.0,
             trace: bool = False, control: bool = False) -> dict:
    from portbench.run import run_cell
    return run_cell(tiny_cell(name), seed, seconds, trace, 'cpu',
                    time.monotonic(), control=control)

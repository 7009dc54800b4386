"""Finding a cell's pieces by name.

`BENCHMARK.json` names each cell's configuration and traffic mix; each is
a file of its own under `portbench/`, found by that name, as is the
reader of each per-layer metric and the load a mix names.  Adding a
configuration, a mix or a metric is adding files: nothing here or in the
harness lists them.

- `configs/<config>.json`: the deployment (sizes, content statistics,
  audio, the pool of GOPs per run).
- `traffic/<mix>.json`: the load's parameters, and `load`, the name of
  the general generator that reads them (`loads/<load>.py`).
- `layer_metrics/<metric>.py`: `read(run)` returns the metric's value,
  or None where the run holds nothing to read it from.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import re
from typing import NamedTuple, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
NAME_RE = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')


class Cell(NamedTuple):
    name: str
    workload: dict          # the BENCHMARK.json entry
    config: dict            # configs/<config>.json
    traffic: dict           # traffic/<mix>.json
    end_to_end: list        # the metric entries that this cell reports
    per_layer: list


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return _load_json(os.path.join(root, 'BENCHMARK.json'))


def _applies(metric: dict, workload: str) -> bool:
    return 'workloads' not in metric or workload in metric['workloads']


def cell(name: str, bench: Optional[dict] = None,
         base: str = HERE) -> Cell:
    """The cell `name` of `bench` (BENCHMARK.json by default), its files
    read from `base` (the portbench directory)."""
    bench = bench if bench is not None else benchmark()
    found = [w for w in bench['workloads'] if w['name'] == name]
    if not found:
        raise KeyError(f'no workload named {name!r} in BENCHMARK.json')
    w = found[0]
    config = _load_json(os.path.join(base, 'configs', w['config'] + '.json'))
    traffic = _load_json(os.path.join(base, 'traffic',
                                      w['traffic'] + '.json'))
    e2e = [m for m in bench['end_to_end'] if _applies(m, name)]
    e2e_names = {m['name'] for m in e2e}
    layer = [m for m in bench['per_layer']
             if _applies(m, name) and m['moves'] in e2e_names]
    return Cell(name, w, config, traffic, e2e, layer)


def load(traffic: dict):
    """The module of the general generator the mix names."""
    d = traffic['load']
    if not NAME_RE.match(d):
        raise ValueError(f'bad load name {d!r}')
    return importlib.import_module(f'portbench.loads.{d}')


def reader(metric: str, base: str = HERE):
    """`read` of layer_metrics/<metric>.py (the file is named by the
    metric, dots and all, so it is loaded by path)."""
    path = os.path.join(base, 'layer_metrics', metric + '.py')
    spec = importlib.util.spec_from_file_location(
        'portbench_metric_' + re.sub(r'\W', '_', metric), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read

"""On the card (skipped without one): each cell of BENCHMARK.json runs
through the command, briefly, and comes out correct with its metrics."""

import json
import subprocess
import sys

import pytest

from portbench import spec


@pytest.mark.card
@pytest.mark.parametrize('workload', [w['name'] for w in
                                      spec.benchmark()['workloads']])
def test_cell_on_the_card(workload):
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    out = subprocess.run(
        [sys.executable, '-m', 'portbench.run', '--workload', workload,
         '--seed', '2147483749', '--seconds', '2', '--trace', '0'],
        capture_output=True, text=True, timeout=1200, cwd=spec.ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res['correct'] and res['device']['platform'] == 'gpu'
    want = {m['name'] for m in spec.cell(workload).end_to_end}
    assert set(res['metrics']) == want

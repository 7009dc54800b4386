"""The import guard compares whole top-level module names; the command
refuses to print a result without a card."""

import os
import shutil
import subprocess
import sys

from portbench.run import forbidden_modules
from portbench.spec import ROOT


def test_whole_names_only():
    assert forbidden_modules({'jsmpeg_tpu_torch', 'jsmpeg_tpu_torch.ops',
                              'torch', 'jaxtyping', 'numpy'}) == []
    assert forbidden_modules({'jsmpeg_tpu.models', 'jax._src.core',
                              'flax', 'jaxlib'}) == ['flax', 'jax', 'jaxlib',
                                                     'jsmpeg_tpu']


def test_a_run_loads_no_jax():
    code = ('from portbench.tests.helpers import run_tiny; '
            'out = run_tiny("tiny_video.live1", seed=3, seconds=0.5); '
            'from portbench.run import forbidden_modules; '
            'import sys; print(out["correct"], forbidden_modules(), '
            '"jsmpeg_tpu_torch" in sys.modules)')
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split('\n')[-2] == 'True [] True'


def test_no_card_no_result():
    out = subprocess.run(
        [sys.executable, '-m', 'portbench.run', '--workload',
         'mpeg1_540p30.live1', '--seed', '1', '--seconds', '1'],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=''))
    assert out.returncode != 0 and out.stdout.strip() == ''


def test_paths_alone_are_not_enough(tmp_path):
    """In a directory holding only BENCHMARK.json and portbench/, the
    command exits non-zero and prints no result."""
    shutil.copy(os.path.join(ROOT, 'BENCHMARK.json'), tmp_path)
    shutil.copytree(os.path.join(ROOT, 'portbench'), tmp_path / 'portbench',
                    ignore=shutil.ignore_patterns('.cache', '__pycache__'))
    out = subprocess.run(
        [sys.executable, '-m', 'portbench.run', '--workload',
         'mpeg1_720p30.offline', '--seed', '1', '--seconds', '1'],
        capture_output=True, text=True, timeout=300, cwd=tmp_path,
        env={k: v for k, v in os.environ.items() if k != 'PYTHONPATH'})
    assert out.returncode != 0 and out.stdout.strip() == ''

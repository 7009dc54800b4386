"""The port stands alone: jsmpeg_tpu_torch and chip_smoke.py import
neither JAX nor anything of jsmpeg_tpu, importing them has no side
effects, and the decoder never quietly runs on the CPU."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from jsmpeg_tpu_torch.models.mpeg1 import MPEG1Decoder

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {'jax', 'jaxlib', 'jsmpeg_tpu'}


def _port_files():
    return sorted((ROOT / 'jsmpeg_tpu_torch').rglob('*.py')) + [
        ROOT / 'chip_smoke.py']


def test_no_file_imports_jax_or_the_jax_package():
    """Every import statement, by its top-level module (so the
    `jsmpeg_tpu_torch` prefix is no false hit)."""
    bad = []
    for path in _port_files():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            bad += [f'{path.relative_to(ROOT)}:{node.lineno} {n}'
                    for n in names if n.split('.')[0] in FORBIDDEN]
    assert not bad, bad
    assert len(_port_files()) > 20


def test_import_every_module_without_jax():
    """In a process where `jax` and `jsmpeg_tpu` cannot be imported,
    every module of the port and chip_smoke.py import, start no thread
    and build nothing."""
    code = '\n'.join([
        'import sys, threading, importlib, pkgutil',
        "for m in ('jax', 'jaxlib', 'jsmpeg_tpu'):",
        '    sys.modules[m] = None',
        'import jsmpeg_tpu_torch',
        "names = [m.name for m in pkgutil.walk_packages(",
        "    jsmpeg_tpu_torch.__path__, 'jsmpeg_tpu_torch.')]",
        'for n in names:',
        '    importlib.import_module(n)',
        'import chip_smoke',
        'from jsmpeg_tpu_torch.ops import kernels',
        'from jsmpeg_tpu_torch.host import native',
        'assert kernels._lib is None and native._lib is None',
        'assert threading.active_count() == 1',
        'print(len(names))',
    ])
    r = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.split()[-1]) >= 15


def test_decoder_without_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        MPEG1Decoder()
    with pytest.raises(RuntimeError, match='CUDA'):
        MPEG1Decoder({'device': 'cuda'})
    assert MPEG1Decoder({'device': 'cpu'}).device == torch.device('cpu')


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """No CUDA device -> a non-zero exit and no result line; the same
    alone in a directory without the package."""
    env = {'CUDA_VISIBLE_DEVICES': ''}
    for cwd in (ROOT, tmp_path):
        script = ROOT / 'chip_smoke.py'
        if cwd == tmp_path:
            script = tmp_path / 'chip_smoke.py'
            script.write_text((ROOT / 'chip_smoke.py').read_text())
        r = subprocess.run([sys.executable, str(script)], cwd=cwd,
                           capture_output=True, text=True, timeout=120,
                           env={**os.environ, **env})
        assert r.returncode != 0
        assert '"ok"' not in r.stdout

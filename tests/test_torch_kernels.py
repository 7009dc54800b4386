"""The CUDA kernels' build and wrappers, as far as a machine without a
card and without nvcc can check them: the wrappers refuse CPU tensors
(no fallback inside them), a missing or failing nvcc raises, and the
build compiles each source for sm_90a and rebuilds when a source is
newer.  The kernels themselves are held to their plain versions on the
card by chip_smoke.py."""

import os
import shutil
import stat

import pytest
import torch

from jsmpeg_tpu_torch.ops import kernels
from jsmpeg_tpu_torch.ops.frame import Planes


def test_wrappers_refuse_cpu_tensors():
    kernels.reset_launches()
    lv = torch.zeros((2, 6, 64), dtype=torch.int16)
    with pytest.raises(ValueError, match='CUDA'):
        kernels.dequant_idct_cuda(lv, torch.ones(2, dtype=torch.uint8),
                                  torch.zeros(2, dtype=torch.bool),
                                  torch.ones(64, dtype=torch.int32),
                                  torch.ones(64, dtype=torch.int32))
    with pytest.raises(ValueError, match='CUDA'):
        kernels.dequant_idct_cuda(lv.int(), premultiplied=True)
    p = Planes(torch.zeros((16, 16), dtype=torch.uint8),
               torch.zeros((8, 8), dtype=torch.uint8),
               torch.zeros((8, 8), dtype=torch.uint8))
    with pytest.raises(ValueError, match='CUDA'):
        kernels.mc_combine_cuda(p, p,
                                torch.zeros((1, 6, 64), dtype=torch.int32),
                                torch.zeros((1, 3), dtype=torch.int32))
    assert kernels.launches == {'dequant_idct': 0, 'mc_combine': 0}


def test_argument_checks():
    """_check validates device, dtype, shape and contiguity."""
    dev = torch.device('cpu')
    t = torch.zeros((4, 6), dtype=torch.int32)
    assert kernels._check(t, 't', torch.int32, (4, 6), dev) == t.data_ptr()
    with pytest.raises(TypeError):
        kernels._check(t, 't', torch.int16, (4, 6), dev)
    with pytest.raises(ValueError, match='shape'):
        kernels._check(t, 't', torch.int32, (6, 4), dev)
    with pytest.raises(ValueError, match='contiguous'):
        kernels._check(t.t(), 't', torch.int32, (6, 4), dev)
    with pytest.raises(ValueError, match='expected'):
        kernels._check(t, 't', torch.int32, (4, 6), torch.device('meta'))


def _fake_nvcc(tmp_path, fail=False):
    """A stand-in nvcc that logs its argv and writes its -o output."""
    bin_dir = tmp_path / 'cuda' / 'bin'
    bin_dir.mkdir(parents=True)
    log = tmp_path / 'nvcc.log'
    nvcc = bin_dir / 'nvcc'
    nvcc.write_text('#!/bin/sh\n'
                    f'echo "$@" >> {log}\n'
                    + ('echo "error: boom"; exit 1\n' if fail else '')
                    + 'while [ $# -gt 0 ]; do\n'
                    '  if [ "$1" = "-o" ]; then touch "$2"; fi; shift\n'
                    'done\n'
                    'echo "ptxas info    : Used 8 registers"\n')
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    return tmp_path / 'cuda', log


@pytest.fixture
def build_dir(tmp_path, monkeypatch):
    """The build redirected into tmp_path, on copies of the sources."""
    out = tmp_path / 'build'
    monkeypatch.setattr(kernels, 'BUILD_DIR', str(out))
    monkeypatch.setattr(kernels, 'SO_PATH', str(out / 'lib.so'))
    monkeypatch.setattr(kernels, 'LOG_PATH', str(out / 'build.log'))
    srcs = []
    for s in kernels.SOURCES:
        dst = tmp_path / os.path.basename(s)
        shutil.copy(s, dst)
        srcs.append(str(dst))
    monkeypatch.setattr(kernels, 'SOURCES', srcs)
    return out


def test_build_compiles_each_source_for_sm90a(tmp_path, monkeypatch,
                                              build_dir):
    home, log = _fake_nvcc(tmp_path)
    monkeypatch.setenv('CUDA_HOME', str(home))
    assert kernels.ensure_built() == kernels.SO_PATH
    cmds = log.read_text().splitlines()
    compiles = [c for c in cmds if ' -c ' in f' {c} ']
    assert len(compiles) == len(kernels.SOURCES) == 2
    for c, src in zip(compiles, kernels.SOURCES):
        assert 'arch=compute_90a,code=sm_90a' in c and src in c
        assert '-O3' in c and '-std=c++17' in c
    assert any('-shared' in c for c in cmds)
    assert 'Used 8 registers' in open(kernels.LOG_PATH).read()
    # fresh: no rebuild; a newer source: rebuild
    n = len(cmds)
    kernels.ensure_built()
    assert len(log.read_text().splitlines()) == n
    future = os.path.getmtime(kernels.SO_PATH) + 10
    os.utime(kernels.SOURCES[1], (future, future))
    kernels.ensure_built()
    assert len(log.read_text().splitlines()) == 2 * n


def test_failed_build_raises(tmp_path, monkeypatch, build_dir):
    home, _ = _fake_nvcc(tmp_path, fail=True)
    monkeypatch.setenv('CUDA_HOME', str(home))
    with pytest.raises(RuntimeError, match='nvcc failed'):
        kernels.ensure_built()
    assert not os.path.exists(kernels.SO_PATH)


def test_missing_nvcc_raises(tmp_path, monkeypatch, build_dir):
    monkeypatch.setenv('CUDA_HOME', str(tmp_path / 'nowhere'))
    monkeypatch.delenv('CUDA_PATH', raising=False)
    monkeypatch.setenv('PATH', str(tmp_path))
    monkeypatch.setattr(kernels, 'NVCC_DEFAULT', str(tmp_path / 'no-nvcc'))
    with pytest.raises(RuntimeError, match='nvcc not found'):
        kernels.ensure_built()


def test_launch_counts_reset():
    kernels.launches['mc_combine'] += 3
    kernels.reset_launches()
    assert kernels.launches == {'dequant_idct': 0, 'mc_combine': 0}

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
from jsmpeg_tpu_torch.ops.frame import Planes, mc_combine


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
    p = _planes(16, 16)
    with pytest.raises(ValueError, match='CUDA'):
        kernels.mc_combine_cuda(p, p,
                                torch.zeros((2, 1, 6, 64), dtype=torch.int32),
                                torch.zeros((2, 1, 3), dtype=torch.int32))
    assert kernels.launches == {'dequant_idct': 0, 'mc_combine': 0,
                                'wire_unpack': 0}


def _planes(H, W):
    return Planes(torch.zeros((H, W), dtype=torch.uint8),
                  torch.zeros((H // 2, W // 2), dtype=torch.uint8),
                  torch.zeros((H // 2, W // 2), dtype=torch.uint8))


# K2 arguments that do not fit one batch of F = 2 frames of 32 x 16
# (2 macroblocks): (what changes, the message it raises with)
K2_MISMATCHES = {
    # F is resid's leading axis, so meta is held to it
    'resid_frames': (dict(resid=(3, 2, 6, 64)), 'meta must have shape'),
    'meta_frames': (dict(meta=(1, 2, 3)), 'meta must have shape'),
    'resid_mbs': (dict(resid=(2, 3, 6, 64)), 'resid must have shape'),
    'resid_not_batched': (dict(resid=(2, 6, 64)), r'\[F, n_mb, 6, 64\]'),
    'fwd_plane': (dict(fwd=(16, 32)), r'fwd\.y must have shape'),
    'cur_chroma': (dict(cur_cr=(8, 16)), r'cur\.cr must have shape'),
    'unaligned': (dict(cur=(24, 16)), 'macroblock-aligned'),
}


@pytest.mark.parametrize('case', sorted(K2_MISMATCHES))
def test_mc_combine_refuses_mismatched_batch(case):
    """Shapes that do not make one [F, ...] batch raise before the device
    is looked at (so here on the CPU too), and count no launch."""
    change, msg = K2_MISMATCHES[case]
    cur = _planes(*change.get('cur', (32, 16)))
    if 'cur_cr' in change:
        cur = cur._replace(cr=torch.zeros(change['cur_cr'],
                                          dtype=torch.uint8))
    fwd = _planes(*change.get('fwd', (32, 16)))
    resid = torch.zeros(change.get('resid', (2, 2, 6, 64)), dtype=torch.int32)
    meta = torch.zeros(change.get('meta', (2, 2, 3)), dtype=torch.int32)
    kernels.reset_launches()
    with pytest.raises(ValueError, match=msg):
        kernels.mc_combine_cuda(cur, fwd, resid, meta)
    assert kernels.launches['mc_combine'] == 0


# segment arguments that do not fit that batch (mb_h = 2, F = 2):
# (n_seg, seg_frames, the message it raises with)
K2_BAD_SEGMENTS = {
    'uneven': (3, None, 'do not split'),
    'no_segment': (0, None, 'do not split'),
    'counts_short': (2, [2], 'seg_frames'),
    'count_over_F': (2, [2, 3], 'seg_frames'),
    'count_negative': (2, [-1, 2], 'seg_frames'),
}


@pytest.mark.parametrize('case', sorted(K2_BAD_SEGMENTS))
def test_mc_combine_refuses_bad_segments(case):
    """n_seg must divide the macroblock rows and seg_frames hold n_seg
    counts in [0, F]: checked before the device, so raised here too, with
    no launch counted; the plain version refuses the same."""
    n_seg, seg_frames, msg = K2_BAD_SEGMENTS[case]
    p = _planes(32, 16)
    resid = torch.zeros((2, 2, 6, 64), dtype=torch.int32)
    meta = torch.zeros((2, 2, 3), dtype=torch.int32)
    kernels.reset_launches()
    with pytest.raises(ValueError, match=msg):
        kernels.mc_combine_cuda(p, p, resid, meta, n_seg, seg_frames)
    assert kernels.launches['mc_combine'] == 0
    with pytest.raises(ValueError, match=msg):
        mc_combine(p, p, resid, meta, n_seg, seg_frames)


def test_mc_combine_refuses_oversize_plane():
    """K2's in-plane offsets are int: a plane of 2^31 bytes or more (a
    joint plane of many streams) raises before the device (the planes
    live on the meta device: nothing is allocated)."""
    side = 46352                    # 46352^2 > 2^31, macroblock-aligned
    z = lambda h, w: torch.zeros((h, w), dtype=torch.uint8, device='meta')
    p = Planes(z(side, side), z(side // 2, side // 2),
               z(side // 2, side // 2))
    with pytest.raises(ValueError, match='2\\^31'):
        kernels.mc_combine_cuda(p, p, torch.zeros((1, 1, 6, 64)),
                                torch.zeros((1, 1, 3)))


# K3 arguments that do not make S wires of the given sizes: (wires'
# shape, sizes (F, n_mb, n_runs, mv_wide, n_pairs, n_esc, n_blk), the
# message); every wire of 2 frames x 3 macroblocks, 2 runs, 4 pairs, 1
# escape is 2 + 1 + 8 + 8 + 2 = 21 bytes
K3_GOOD = (2, 3, 2, False, 4, 1, 3)
K3_MISMATCHES = {
    'one_dim': ((21,), K3_GOOD, r'\[S, L\]'),
    'short_wire': ((1, 20), K3_GOOD, 'bufs must have shape'),
    'wide_length': ((1, 21), (2, 3, 2, True, 4, 1, 3), 'bufs must have shape'),
    'zero_pairs': ((1, 13), (2, 3, 2, False, 0, 1, 3), 'every size >= 1'),
    'zero_blocks': ((1, 21), (2, 3, 2, False, 4, 1, 0), 'every size >= 1'),
    'over_lattice': ((1, 21), (2**22, 3, 2, False, 4, 1, 3), 'int32'),
}


@pytest.mark.parametrize('case', sorted(K3_MISMATCHES))
def test_wire_unpack_refuses_mismatched_wires(case):
    """Wires whose length is not the sizes' wire v2 length, and sizes the
    kernel cannot take, raise before the device is looked at (so here on
    the CPU too), and count no launch."""
    shape, sizes, msg = K3_MISMATCHES[case]
    kernels.reset_launches()
    with pytest.raises(ValueError, match=msg):
        kernels.wire_unpack_cuda(torch.zeros(shape, dtype=torch.uint8),
                                 *sizes)
    assert kernels.launches['wire_unpack'] == 0


def test_wire_unpack_refuses_cpu_wires():
    """A well-formed wire on the CPU is refused (no fallback inside the
    wrapper: the plain version runs in models.mpeg1.unpack_wires)."""
    with pytest.raises(ValueError, match='CUDA'):
        kernels.wire_unpack_cuda(torch.zeros((2, 21), dtype=torch.uint8),
                                 *K3_GOOD)
    with pytest.raises(TypeError, match='uint8'):
        kernels.wire_unpack_cuda(torch.zeros((2, 21), dtype=torch.int8),
                                 *K3_GOOD)


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
    assert len(compiles) == len(kernels.SOURCES) == 3
    # the nvcc runs start together, so their log lines come in any order
    for src in kernels.SOURCES:
        (c,) = [c for c in compiles if f' -c {src} ' in f' {c} ']
        assert 'arch=compute_90a,code=sm_90a' in c
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
    assert kernels.launches == {'dequant_idct': 0, 'mc_combine': 0,
                                'wire_unpack': 0}

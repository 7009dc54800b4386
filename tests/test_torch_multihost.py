"""The port's multi-process decode on the CPU (jsmpeg_tpu_torch.parallel.
multihost and .elastic), case for case tests/test_multihost.py and
test_packed_mesh.py::test_elastic_prefix_fallback_on_open_gop: ranks of a
gloo process group each decode their own block of GOPs, and an elastic
coordinator hands GOP ranges to worker processes and recovers from a
killed one.  Each rank's frame indices are jsmpeg_tpu's assignment for
the same layout; every frame equals, with tolerance 0, the port's serial
decode and the oracle.  Every subprocess has a timeout."""

import functools
import json
import os
import re
import signal
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from jsmpeg_tpu.parallel import multihost as jmh
from jsmpeg_tpu_torch.host import best_parser
from jsmpeg_tpu_torch.models.mpeg1 import MPEG1Decoder
from jsmpeg_tpu_torch.parallel import multihost as mh
from jsmpeg_tpu_torch.parallel.elastic import decode_gops_elastic
from jsmpeg_tpu_torch.parallel.gop import split_at_iframes
from jsmpeg_tpu_torch.parallel.packed import split_packed_frames
from jsmpeg_tpu_torch.testing.gen import (encode_realistic_stream,
                                          encode_test_stream)
from tests.oracle.ref_mpeg1 import OracleMPEG1

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_WORKER = os.path.join(ROOT, 'tests', '_torch_mh_worker.py')
sys.path.insert(0, os.path.dirname(_WORKER))
from _torch_mh_worker import stream as mh_stream  # noqa: E402


def _free_port():
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def _serial(es):
    d = MPEG1Decoder({'device': 'cpu'})
    d.write(0.0, es)
    return [tuple(x.numpy() for x in p) for p in d.decode_available(eof=True)]


def test_index_gops_matches_parse_and_jax():
    """The start-code GOP index is jsmpeg_tpu's, agrees with the VLC
    parse (GOP count, frame counts), and each range re-parses to the
    same per-frame wire bytes."""
    es, _ = encode_realistic_stream(96, 64, n_frames=11, seed=9, gop=4)
    header, ranges = mh.index_gops(es)
    assert (header, ranges) == jmh.index_gops(es)
    parser = best_parser()
    parser.write(es)
    frames = []
    while isinstance(b := parser.parse_batch(32, eof=True), dict):
        frames.extend(split_packed_frames(b))
        if b['n'] < 32:
            break
    gops = split_at_iframes(frames, lambda f: f['pic_type'])
    assert [r[2] for r in ranges] == [len(g) for g in gops]
    for (s, e, _), gop in zip(ranges, gops):
        _, got = mh.parse_gop_range(header, es, s, e)
        assert len(got) == len(gop)
        for a, b in zip(got, gop):
            for k in ('run_len', 'run_flags', 'run_cbp', 'run_mv',
                      'sp_pos', 'sp_v8', 'sp_esc'):
                np.testing.assert_array_equal(a[k], b[k])
    assert mh.index_gops(b'\x00' * 8) == (b'\x00' * 8, [])


_JAX_WORKER = os.path.join(ROOT, 'tests', '_mh_worker.py')


@functools.lru_cache(maxsize=None)
def _jax_rank_frames(world, n_tile):
    """The global frame numbers each of jsmpeg_tpu's ranks decodes, from
    its own multi-process run of the layout (tests/_mh_worker.py: the
    stream of _torch_mh_worker.stream(world), four virtual devices per
    rank, n_tile), as the worker prints them."""
    port = _free_port()
    env = dict(os.environ)
    env.pop('XLA_FLAGS', None)       # the worker sets its own device count
    env.pop('JSMPEG_TPU_TESTS', None)
    procs = [subprocess.Popen(
        [sys.executable, _JAX_WORKER, str(port), str(world), str(r),
         str(n_tile)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        env=env, text=True, cwd=ROOT) for r in range(world)]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    frames = []
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f'jsmpeg_tpu rank {r} failed:\n{out}'
        m = re.search(rf'worker {r}: .*\(global frames (\[[\d, ]*\])\)', out)
        assert m, out
        frames.append(json.loads(m.group(1)))
    return frames


def _run_ranks(world, n_tile, tmp_path, timeout=300):
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, _WORKER, str(port), str(world), str(r), str(n_tile),
         str(tmp_path)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, cwd=ROOT) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f'rank {r} failed:\n{out}'
    es = mh_stream(world)
    oracle = OracleMPEG1(es).decode_all()
    serial = _serial(es)
    seen = []
    for r, out in enumerate(outs):
        line = json.loads(out.strip().splitlines()[-1])
        assert line['rank'] == r
        assert line['frames'] == _jax_rank_frames(world, n_tile)[r]
        with np.load(tmp_path / f'rank{r}.npz') as z:
            assert z['frames'].tolist() == line['frames']
            for i, k in enumerate(line['frames']):
                for pn, want in zip(('y', 'cr', 'cb'), oracle[k]):
                    np.testing.assert_array_equal(z[pn][i], want,
                                                  err_msg=f'frame {k}')
                    np.testing.assert_array_equal(
                        z[pn][i], serial[k][('y', 'cr', 'cb').index(pn)])
        seen += line['frames']
    assert sorted(seen) == list(range(len(oracle)))


@pytest.mark.parametrize('n_tile', [1, 2])
def test_two_process_decode(n_tile, tmp_path):
    _run_ranks(2, n_tile, tmp_path)


def test_four_process_tiled_decode(tmp_path):
    """4 ranks x 4 device objects, n_tile = 2 (jsmpeg_tpu's 8 x 2 global
    mesh): ranks own several gop rows, each row's pictures in 2 bands."""
    _run_ranks(4, 2, tmp_path, timeout=600)


def test_multihost_cli_two_ranks(tmp_path):
    """`python -m jsmpeg_tpu_torch.parallel.multihost` (the entry a user
    runs per rank) at n_tile 2 over four CPU device objects each: the
    ranks' frames are jsmpeg_tpu's for the same layout."""
    es = mh_stream(2)
    (tmp_path / 's.es').write_bytes(es)
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, '-m', 'jsmpeg_tpu_torch.parallel.multihost',
         f'tcp://127.0.0.1:{port}', '2', str(r), str(tmp_path / 's.es'),
         str(tmp_path / f'r{r}.npz'), '--n-tile', '2']
        + ['--device', 'cpu', '--device', 'cpu:0'] * 2,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=ROOT) for r in range(2)]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    serial = _serial(es)
    seen = []
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, err
        line = json.loads(out.strip().splitlines()[-1])
        assert line['frames'] == _jax_rank_frames(2, 2)[r]
        with np.load(tmp_path / f'r{r}.npz') as z:
            for i, k in enumerate(line['frames']):
                for j, pn in enumerate(('y', 'cr', 'cb')):
                    np.testing.assert_array_equal(z[pn][i], serial[k][j])
        seen += line['frames']
    assert sorted(seen) == list(range(len(serial)))


def test_one_process_without_a_group():
    """Without a process group the caller is rank 0 of 1 and decodes
    every GOP; padding rows decode nothing."""
    es = encode_realistic_stream(64, 48, n_frames=7, seed=6, gop=3)[0]
    seq, frames, planes = mh.decode_packed_multihost(es, devices=['cpu'])
    assert frames == list(range(7)) and seq.mb_height == 3
    for p, want in zip(planes, _serial(es)):
        for a, b in zip(p, want):
            np.testing.assert_array_equal(a, b)
    assert mh.rank_gops(3, 2, 1, 4) == range(4, 8)


def _assert_elastic_bit_exact(es, counts, frames):
    _, ranges = mh.index_gops(es)
    golden = OracleMPEG1(es).decode_all()
    assert counts == [r[2] for r in ranges]
    assert len(frames) == len(golden)
    for got, want in zip(frames, golden):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_elastic_gop_decode():
    es, _ = encode_realistic_stream(96, 64, n_frames=12, seed=11, gop=3)
    counts, frames = decode_gops_elastic(es, n_workers=3, device='cpu',
                                         timeout=120)
    _assert_elastic_bit_exact(es, counts, frames)


def test_elastic_recovery_worker_killed_mid_run():
    """Worker 0 is SIGKILLed as its first shard goes out: the shard is
    re-dispatched to the survivors; the output stays exact."""
    es, _ = encode_realistic_stream(96, 64, n_frames=12, seed=11, gop=3)
    killed = []

    def on_assign(worker_id, pid, gop_index):
        if worker_id == 0 and not killed:
            os.kill(pid, signal.SIGKILL)
            killed.append((pid, gop_index))

    stats = {}
    counts, frames = decode_gops_elastic(es, n_workers=3, device='cpu',
                                         on_assign=on_assign, timeout=120,
                                         stats=stats)
    assert killed
    _assert_elastic_bit_exact(es, counts, frames)
    pid, gop = killed[0]
    assert stats['done_by'][gop] != pid        # a survivor did it


def test_elastic_all_workers_dead_raises():
    es, _ = encode_realistic_stream(96, 64, n_frames=8, seed=11, gop=2)
    with pytest.raises(RuntimeError, match='outstanding'):
        decode_gops_elastic(es, n_workers=2, device='cpu', timeout=120,
                            worker_env={'JSMPEG_ELASTIC_DIE_AFTER': '0'})


def test_elastic_pid_handshake():
    """on_assign names each job's worker by the pid that worker sent in
    its ready handshake: the pid that later reports the job done, one of
    the coordinator's own children."""
    es, _ = encode_realistic_stream(96, 64, n_frames=12, seed=12, gop=2)
    assigned, stats = {}, {}

    def on_assign(worker_id, pid, gop_index):
        assigned[gop_index] = pid

    decode_gops_elastic(es, n_workers=3, device='cpu', on_assign=on_assign,
                        timeout=120, stats=stats)
    assert assigned == stats['done_by'] and len(assigned) == 6
    assert all(p != os.getpid() for p in assigned.values())


def test_elastic_prefix_fallback_on_open_gop():
    """An open GOP range (a slice-gap P frame in its first two) decodes
    from the stream's prefix and stays exact."""
    es = encode_test_stream(96, 64, n_frames=8, seed=922899424, gop=3,
                            f_code=3)[0]
    counts, frames = decode_gops_elastic(es, n_workers=2, device='cpu',
                                         timeout=120)
    ref = _serial(es)
    assert sum(counts) == len(ref) == 8
    for got, want in zip(frames, ref):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_multi_process_entry_points_need_a_card(monkeypatch, tmp_path):
    """decode_packed_multihost and decode_gops_elastic run on the card
    unless given the CPU; an elastic worker told 'cuda' on a machine
    without a card exits non-zero naming CUDA, before it connects."""
    es = encode_realistic_stream(48, 32, n_frames=3, seed=7, gop=3)[0]
    (tmp_path / 's.es').write_bytes(es)
    r = subprocess.run(
        [sys.executable, '-m', 'jsmpeg_tpu_torch.parallel.elastic',
         '127.0.0.1', str(_free_port()), str(tmp_path / 's.es'),
         str(tmp_path), '--device', 'cuda'], cwd=ROOT, capture_output=True,
        text=True, timeout=120, env={**os.environ,
                                     'CUDA_VISIBLE_DEVICES': ''})
    assert r.returncode != 0 and 'CUDA' in r.stderr
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        mh.decode_packed_multihost(es)
    with pytest.raises(RuntimeError, match='CUDA'):
        decode_gops_elastic(es)
    with pytest.raises(RuntimeError, match='CUDA'):
        decode_gops_elastic(es, device='cuda')

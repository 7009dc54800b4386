"""The port's robustness soak (jsmpeg_tpu_torch/fuzz_soak.py) on the CPU:
each of its rounds at two fixed seeds, main() clean over a few seconds,
a failing round logged as one reproducer line with the soak going on,
the host canary; and the soak's first find, a sequence header split
across writes, which the port waits for (jsmpeg and jsmpeg_tpu decode
it from the zero pad past the buffered bytes)."""

import json

import numpy as np
import pytest
import torch

from jsmpeg_tpu_torch import fuzz_soak as fs
from jsmpeg_tpu_torch.host.native import host_canary
from jsmpeg_tpu_torch.models.mpeg1 import MPEG1Decoder
from jsmpeg_tpu_torch.parallel.multihost import index_gops
from jsmpeg_tpu_torch.parallel.streams import MultiStreamDecoder
from jsmpeg_tpu_torch.testing.gen import encode_test_stream

CPU = fs.CPU
SEEDS = (3, 11)         # fixtures of 3 and 4 closed GOPs


def _fixture(seed):
    rng = np.random.default_rng(seed)
    es, ts = fs.fixture(rng)
    assert len(index_gops(es)[1]) >= 2
    return rng, es, ts


@pytest.mark.parametrize('seed', SEEDS)
@pytest.mark.parametrize('mode', ['bitflips', 'garbage_prefix'])
def test_drain_round(seed, mode):
    rng, _, ts = _fixture(seed)
    bad = fs.corrupt(ts, rng, mode)
    assert bad != ts
    fs.drain_round(bad, CPU)
    assert fs.drain(bad, CPU)


@pytest.mark.parametrize('seed', SEEDS)
def test_differential_round(seed):
    rng, es, _ = _fixture(seed)
    fs.differential(es, rng, CPU)


@pytest.mark.parametrize('seed', SEEDS)
def test_fleet_round(seed):
    rng, _, _ = _fixture(seed)
    fs.fleet_round(rng, 'mix', CPU)


@pytest.mark.parametrize('seed', SEEDS)
def test_mesh_round(seed):
    rng, es, _ = _fixture(seed)
    assert fs.mesh_round(es, rng, CPU) == (2, 0)


def test_mesh_round_counts_refusals_apart():
    """Seed 4 draws a t = 2 mesh whose bands are shorter than the MV
    reach: decode_packed_mesh refuses it and its off-mesh fallback is
    compared; decode_tiled_levels' refusal stands."""
    rng = np.random.default_rng(4)
    es, _ = fs.fixture(rng)
    assert fs.mesh_round(es, rng, CPU) == (1, 2)


@pytest.mark.parametrize('target', ['parallel.packed.decode_packed_mesh',
                                    'parallel.tiles.decode_tiled_levels'])
@pytest.mark.parametrize('error', [
    RuntimeError('mc_combine kernel launch failed: CUDA error 700'),
    ValueError('a band launch is one frame: resid must be [1, ...]'),
    torch.cuda.OutOfMemoryError('CUDA out of memory')])
def test_mesh_round_raises_what_is_not_a_refusal(monkeypatch, target,
                                                 error):
    """A kernel's failure in the mesh paths fails the round: only the
    refusals by policy, told by their messages, are counted apart."""
    import importlib
    mod, name = target.rsplit('.', 1)
    module = importlib.import_module(f'jsmpeg_tpu_torch.{mod}')

    def fail(*a, **k):
        raise error

    monkeypatch.setattr(module, name, fail)
    rng, es, _ = _fixture(SEEDS[0])
    with pytest.raises(type(error), match=str(error)[:12]):
        fs.mesh_round(es, rng, CPU)
    assert not fs._refusal(error)


@pytest.mark.parametrize('seed', SEEDS)
def test_elastic_round(seed):
    rng, es, _ = _fixture(seed)
    fs.elastic_round(es, rng, CPU)


def test_elastic_round_on_a_one_gop_fixture_still_kills(monkeypatch):
    """Seed 2 draws a fixture of one GOP: the round draws a stream of two
    or more GOPs instead of returning unchecked, and a worker dies."""
    from jsmpeg_tpu_torch.parallel import elastic
    rng = np.random.default_rng(2)
    es, _ = fs.fixture(rng)
    assert len(index_gops(es)[1]) == 1
    real, seen = elastic.decode_gops_elastic, []

    def spy(es, **kw):
        assign = kw['on_assign']

        def on_assign(worker_id, pid, gop_index):
            seen.append(gop_index)
            assign(worker_id, pid, gop_index)
        kw['on_assign'] = on_assign
        seen.append(len(index_gops(es)[1]))
        return real(es, **kw)

    monkeypatch.setattr(elastic, 'decode_gops_elastic', spy)
    fs.elastic_round(es, rng, CPU)
    n_gops, assigned = seen[0], seen[1:]
    assert n_gops >= 2
    assert len(assigned) > n_gops            # the killed GOP went out again
    assert sorted(set(assigned)) == list(range(n_gops))


def test_main_clean_run_leaves_an_empty_log(tmp_path):
    log = tmp_path / 'soak.jsonl'
    stats = {}
    rc = fs.main(['--device', 'cpu', '--seconds', '3', '--seed', '40',
                  '--log', str(log)], stats)
    assert rc == 0
    assert not log.exists() or log.read_text() == ''
    assert stats['iterations'] >= 1 and stats['failures'] == 0
    assert stats['rounds']['drain'] == stats['iterations']
    assert set(stats['rounds']) == set(fs.COUNTS)
    assert stats['device'] == 'cpu'


def test_failing_round_logs_one_reproducer_and_goes_on(tmp_path,
                                                       monkeypatch):
    real, calls = fs.drain_round, []

    def first_raises(ts, device):
        calls.append(1)
        if len(calls) == 1:
            raise ValueError('planted fault')
        real(ts, device)

    monkeypatch.setattr(fs, 'drain_round', first_raises)
    log = tmp_path / 'soak.jsonl'
    stats = {}
    rc = fs.main(['--device', 'cpu', '--seconds', '2', '--seed', '7',
                  '--log', str(log)], stats)
    assert rc == 1
    lines = log.read_text().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert set(rec) == {'seed', 'mode', 'error', 'trace'}
    assert rec['seed'] == 7 and rec['mode'] == fs.MODES[0]
    assert 'planted fault' in rec['error'] and 'first_raises' in rec['trace']
    assert stats['failures'] == 1 and stats['iterations'] >= 2
    assert stats['rounds']['drain'] == stats['iterations'] - 1


def test_host_canary_at_tiny_sizes():
    c = host_canary(cpu_iters=100_000, mem_mb=1, mem_reps=1, runs=3)
    assert set(c) == {'int_mops', 'mem_gb_s'}
    assert c['int_mops'] > 0 and c['mem_gb_s'] > 0


# ------------------------------------------ the soak's find: split headers

def _decode(es, chunks, **opts):
    d = MPEG1Decoder({'device': 'cpu', **opts})
    for c in chunks:
        d.write(None, c)
    return [fs._host(p) for p in d.decode_available(eof=True) or []]


@pytest.mark.parametrize('native', [True, False])
@pytest.mark.parametrize('custom_matrices', [False, True])
def test_sequence_header_split_across_writes(native, custom_matrices):
    """Cut anywhere inside the sequence header (with its quant matrices),
    the stream decodes as one whole write: the parser waits for the rest
    of the header instead of reading its missing bits as zeros."""
    es, _ = encode_test_stream(96, 64, n_frames=3, seed=4, gop=3,
                               custom_matrices=custom_matrices)
    want = _decode(es, [es], native=native)
    assert len(want) == 3
    end = es.index(b'\x00\x00\x01', 4)      # the header's end
    assert end == (140 if custom_matrices else 12)
    for cut in sorted({5, 6, 8, 11, 12, end - 1, end // 2}):
        got = _decode(es, [es[:cut], es[cut:]], native=native)
        fs.frames_equal(f'cut at {cut}', got, want)


def test_fleet_stream_whose_header_arrives_in_pieces():
    """The soak's seed 146: a clean stream's first write held 6 bytes of
    its sequence header, which became the fleet's 96x0 geometry contract,
    and its frames decoded wrong; the corrupted sibling was quarantined
    for a resolution mismatch.  Now the whole iteration passes."""
    done = dict.fromkeys(fs.COUNTS, 0)
    fs.iteration(46, 146, CPU, done)
    assert done == {'drain': 1, 'differential': 0, 'fleet': 1, 'mesh': 1,
                    'elastic': 0, 'mesh_compared': 2, 'mesh_refused': 0}
    es, _ = encode_test_stream(96, 64, n_frames=3, seed=5, gop=3)
    dec = MultiStreamDecoder(2, batch_frames=4, device='cpu')
    frames = [[], []]
    dec.write(0, es[:6])
    dec.write(1, es)
    for i, st in enumerate(dec.decode_batch()):
        frames[i] += [fs._host((st.y[f], st.cr[f], st.cb[f]))
                      for f in range(st.y.shape[0])]
    dec.write(0, es[6:])
    for i, got in enumerate(dec.decode_all(eof=True)):
        frames[i] += [fs._host(p) for p in got]
    assert not any(dec.dead)
    want = fs.serial_frames(es)
    for i in range(2):
        fs.frames_equal(f'stream {i}', frames[i], want)

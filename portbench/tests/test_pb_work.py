"""The frozen work counts give PERF.md's bounds at the main path's last
32-frame batch (`chip_smoke.py`'s 720p stream, frames 64-95), its counts
taken from the benchmark's reference parse and its wire from the port."""

import numpy as np
import pytest

from portbench.work import bound, k1_work, k2_work, k2_work_counts, k3_work


@pytest.fixture(scope='module')
def main_batch():
    from portbench.gen.gen import encode_realistic_stream
    from portbench.reference.mpeg1 import ReferenceMPEG1
    es, _ = encode_realistic_stream(1280, 720, n_frames=96, seed=3, gop=12)
    ref = ReferenceMPEG1(es)
    ref.decode_all()
    return es, ref.work[64:96]


def test_bounds_at_the_main_batch(main_batch):
    from jsmpeg_tpu_torch.host.native import NativeMPEG1Parser
    from jsmpeg_tpu_torch.models.mpeg1 import build_fused_buffer
    es, pics = main_batch
    n_mb = 3600
    coded = sum(p.coded_blocks for p in pics)
    nonzero = sum(p.nonzero_levels for p in pics)
    assert coded == 103123
    k1c = bound(*k1_work(coded, nonzero, sum(p.coded_mbs for p in pics),
                         True))
    k1l = bound(*k1_work(32 * n_mb * 6, nonzero, 32 * n_mb, False))
    k2 = bound(*k2_work_counts(32, n_mb, coded,
                               sum(p.intra_coded_blocks for p in pics),
                               sum(p.written_mbs for p in pics)))
    parser = NativeMPEG1Parser()
    parser.write(es)
    batches = [parser.parse_batch(32, eof=True) for _ in range(3)]
    assert [b['n'] for b in batches] == [32, 32, 32]
    assert batches[2]['n_blocks'] == coded
    wire = build_fused_buffer(batches[2], n_mb)
    wire = wire[0] if isinstance(wire, tuple) else wire
    k3 = bound(*k3_work(int(np.asarray(wire).size), 32 * n_mb, coded,
                        nonzero))
    assert (round(k1c[0], 5), k1c[1]) == (0.01196, 'bytes')
    assert round(k1l[0], 4) == 0.0793
    assert round(k3[0], 4) == 0.0049
    assert round(k2[0], 4) == 0.0339


def test_k2_counts_equal_meta():
    rng = np.random.default_rng(0)
    meta = np.zeros((3, 50, 3), np.int64)
    meta[..., 2] = rng.integers(0, 256, (3, 50))
    mode = meta[..., 2]
    coded = sum(int(((mode >> b) & 1).sum()) for b in range(6))
    intra = (mode >> 6) & 1
    ic = sum(int((intra & ((mode >> b) & 1)).sum()) for b in range(6))
    assert k2_work(meta) == k2_work_counts(3, 50, coded, ic,
                                           int(((mode >> 7) & 1).sum()))

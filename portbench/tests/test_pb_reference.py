"""The benchmark's plain reference decodes as the repository's test
oracles do, bit for bit, and imports nothing of the program or of JAX."""

import subprocess
import sys

import numpy as np
import pytest

from portbench.reference.mpeg1 import ReferenceMPEG1, idct_float32, idct_int

CASES = [dict(), dict(full_pel=True), dict(b_stubs=True),
         dict(stuffing=True), dict(midstream_headers=True),
         dict(custom_matrices=True, f_code=4)]


@pytest.mark.parametrize('kw', CASES, ids=lambda kw: ','.join(kw) or 'plain')
def test_mpeg1_equals_oracle(kw):
    from jsmpeg_tpu_torch.testing.gen import encode_test_stream
    from tests.oracle.ref_mpeg1 import OracleMPEG1
    es, _ = encode_test_stream(64, 48, 8, seed=10, gop=3, **kw)
    want = OracleMPEG1(es).decode_all()
    got = ReferenceMPEG1(es).decode_all()
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)


def test_mpeg1_realistic_equals_oracle_and_counts_work():
    from portbench.gen.gen import encode_realistic_stream
    from tests.oracle.ref_mpeg1 import OracleMPEG1
    es, _ = encode_realistic_stream(176, 144, 6, seed=4, gop=3)
    ref = ReferenceMPEG1(es)
    got = ref.decode_all()
    for g, w in zip(got, OracleMPEG1(es).decode_all()):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    n_mb = 11 * 9
    i_pic, p_pic = ref.work[0], ref.work[1]
    assert i_pic.coded_blocks == i_pic.intra_coded_blocks == 6 * n_mb
    assert i_pic.written_mbs == 0 and i_pic.coded_mbs == n_mb
    assert p_pic.written_mbs > 0 and p_pic.coded_blocks < 6 * n_mb


def test_mp2_equals_oracle():
    from jsmpeg_tpu_torch.testing.mp2_enc import encode_stream
    from portbench.reference.mp2 import OracleMP2 as Ref
    from tests.oracle.ref_mp2 import OracleMP2
    es, _ = encode_stream(6, seed=3)
    for (a, b), (c, d) in zip(Ref(es).decode_all(),
                              OracleMP2(es).decode_all()):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)


def test_audio_cycle_repeats():
    """A cycled track's PCM repeats from its second cycle on, which is
    what `pool.expected_pcm` relies on."""
    from portbench.gen.mp2_enc import encode_stream
    from portbench.pool import expected_pcm, reference_audio
    from portbench.reference.mp2 import OracleMP2
    _, frames = encode_stream(4, seed=11, sf_range=(24, 63))
    ref = reference_audio(frames)
    whole = OracleMP2(b''.join(frames * 3)).decode_all()
    want = np.stack([np.concatenate([f[c] for f in whole]) for c in (0, 1)])
    np.testing.assert_array_equal(expected_pcm(ref, 12), want)


def test_float_idct_is_near_but_not_exact():
    rng = np.random.default_rng(1)
    blk = rng.integers(-2000, 2000, (64, 8, 8)) * 16
    a, b = idct_int(blk), idct_float32(blk)
    assert np.abs(a - b).max() <= 2 and np.count_nonzero(a != b) > 0


def test_reference_imports_nothing_of_the_program():
    code = ('import sys, portbench.reference.mpeg1, portbench.reference.mp2,'
            ' portbench.gen.gen, portbench.work; '
            'print(sorted({m.split(".")[0] for m in sys.modules} & '
            '{"jax", "jsmpeg_tpu", "jsmpeg_tpu_torch", "torch"}))')
    from portbench.spec import ROOT
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, check=True, cwd=ROOT)
    assert out.stdout.strip() == '[]'


def test_pool_gops_decode_alike_anywhere(tmp_path, monkeypatch):
    """A GOP whose picture 1 ends a slice on a macroblock the reference
    never decodes (it keeps the buffer's content from two pictures
    before) is flagged by the encoder where the reference misses it, and
    the pool draws another in its place."""
    import json
    from portbench import pool
    from portbench.gen.gen import encode_realistic_stream
    with open(f'{pool.__file__.rsplit("/", 1)[0]}/configs/'
              'mpeg1_720p30.json') as f:
        cfg = json.load(f)
    seed = pool.derived_seed(1732050811, 1, 3, 0)
    flagged = []
    es, _ = encode_realistic_stream(1280, 720, 12, seed=seed, gop=12,
                                    unvisited=flagged)
    assert flagged == [(1, 29)]
    ref = ReferenceMPEG1(es)
    ref.decode_all()
    assert ref.work[1].written_mbs == 3600 - 1
    monkeypatch.setattr(pool, 'CACHE_DIR', str(tmp_path))
    drawn = pool.encode_gop(cfg, 1732050811, 3)
    assert b''.join(drawn) != es[:-4]

"""The port's CLI (python -m jsmpeg_tpu_torch) on the CPU: end-to-end
decode of a muxed A/V clip to y4m + wav, bit-exact against the oracles
(the single-input case of tests/test_cli.py), and its y4m and wav bytes
equal to jsmpeg_tpu's CLI on the same clip; the multi-input case
likewise (its --mesh cases are in tests/test_torch_mesh.py)."""

import json
import os
import subprocess
import sys
import wave
from pathlib import Path

import numpy as np
import pytest

from jsmpeg_tpu_torch.testing.gen import encode_test_stream
from jsmpeg_tpu_torch.testing.mp2_enc import encode_stream as mp2_stream
from jsmpeg_tpu_torch.testing.ts_mux import mux_av, mux_video
from tests.oracle.ref_mp2 import OracleMP2
from tests.oracle.ref_mpeg1 import OracleMPEG1

ROOT = Path(__file__).resolve().parents[1]
ENV = {**os.environ, 'JAX_PLATFORMS': 'cpu', 'PYTHONPATH': str(ROOT)}


def _cli(module, *args):
    return subprocess.run([sys.executable, '-m', module, *map(str, args)],
                          capture_output=True, text=True, timeout=300,
                          env=ENV, cwd=ROOT)


@pytest.fixture(scope='module')
def clip(tmp_path_factory):
    es, chunks = encode_test_stream(80, 48, n_frames=6, seed=51, gop=3,
                                    frame_rate=25.0)
    aes, af = mp2_stream(8, seed=52)
    v = chunks[:-1]
    v[-1] += chunks[-1]
    d = tmp_path_factory.mktemp('cli')
    path = d / 'clip.ts'
    path.write_bytes(mux_av(v, 25.0, af, 1152, 44100))
    return path, es, aes, d


@pytest.fixture(scope='module')
def outputs(clip):
    """One run of each CLI on the clip: (port result, y4m, wav) and
    jsmpeg_tpu's (y4m, wav)."""
    path, _, _, d = clip
    r = _cli('jsmpeg_tpu_torch', path, '-o', d / 'out.y4m', '--wav',
             d / 'out.wav', '--stats', '--offline', '--device', 'cpu')
    j = _cli('jsmpeg_tpu', path, '-o', d / 'jax.y4m', '--wav',
             d / 'jax.wav', '--offline')
    assert j.returncode == 0, j.stderr[-2000:]
    return r, d


def test_cli_offline_decode(clip, outputs):
    _, es, aes, _ = clip
    r, d = outputs
    assert r.returncode == 0, r.stderr[-2000:]
    assert '"video_frames": 6' in r.stdout
    stats = json.loads(r.stdout.strip().splitlines()[-1])
    assert (stats['audio_frames'], stats['resolution'],
            stats['device']) == (8, '80x48', 'cpu')
    # the CPU runs the kernels' plain versions: no launch
    assert stats['kernel_launches'] == {'dequant_idct': 0, 'mc_combine': 0,
                                        'wire_unpack': 0}

    header, _, body = (d / 'out.y4m').read_bytes().partition(b'\n')
    assert header.startswith(b'YUV4MPEG2 W80 H48 F25:1')
    frames = body.split(b'FRAME\n')[1:]
    assert len(frames) == 6
    golden = OracleMPEG1(es).decode_all()
    for i, fr in enumerate(frames):
        y = np.frombuffer(fr[:80 * 48], np.uint8).reshape(48, 80)
        np.testing.assert_array_equal(golden[i][0][:48, :80], y,
                                      err_msg=f'frame {i}')

    with wave.open(str(d / 'out.wav')) as w:
        assert w.getnchannels() == 2
        assert w.getnframes() == 8 * 1152
        pcm = np.frombuffer(w.readframes(8 * 1152), '<i2').reshape(-1, 2)
    gold = OracleMP2(aes).decode_all()
    lr = np.stack([np.concatenate([f[0] for f in gold]),
                   np.concatenate([f[1] for f in gold])], axis=1)
    want = np.clip(np.round(lr * 32767.0), -32768, 32767).astype('<i2')
    np.testing.assert_array_equal(pcm, want)


def test_cli_bytes_equal_jsmpeg_tpu(outputs):
    """The y4m and the wav are byte for byte jsmpeg_tpu's."""
    r, d = outputs
    assert r.returncode == 0, r.stderr[-2000:]
    assert (d / 'out.y4m').read_bytes() == (d / 'jax.y4m').read_bytes()
    assert (d / 'out.wav').read_bytes() == (d / 'jax.wav').read_bytes()


def test_cli_refuses_several_sources(clip):
    """Joint decode of several inputs is video only: --wav or --ppm with
    several sources is a plain error and a non-zero exit, as in
    jsmpeg_tpu's CLI."""
    path, _, _, d = clip
    for extra in (('--wav', d / 'm.wav'), ('--ppm', d / 'm%d.ppm')):
        r = _cli('jsmpeg_tpu_torch', path, path, *extra, '--device', 'cpu')
        assert r.returncode != 0
        assert 'video-only' in r.stderr


def test_cli_multi_input(clip, tmp_path):
    """Two inputs decode jointly (round-robin MultiStreamDecoder, the
    case of tests/test_cli.py): m0.y4m is byte for byte the single-input
    offline decode, and both outputs are jsmpeg_tpu's multi-input
    outputs."""
    path = clip[0]
    es2, chunks = encode_test_stream(80, 48, n_frames=4, seed=77, gop=2,
                                     frame_rate=25.0)
    v = chunks[:-1]
    v[-1] += chunks[-1]
    other = tmp_path / 'other.ts'
    other.write_bytes(mux_video(v, 25.0))
    r = _cli('jsmpeg_tpu_torch', path, other, '-o', tmp_path / 'm%d.y4m',
             '--device', 'cpu')
    assert r.returncode == 0, r.stderr[-2000:]
    assert '"video_frames": [6, 4]' in r.stdout
    stats = json.loads(r.stdout.strip().splitlines()[-1])
    assert (stats['streams'], stats['resolution'], stats['device'],
            stats['kernel_launches']) == (
        2, '80x48', 'cpu', {'dequant_idct': 0, 'mc_combine': 0,
                            'wire_unpack': 0})
    r = _cli('jsmpeg_tpu_torch', path, '--no-audio', '-o',
             tmp_path / 'solo.y4m', '--offline', '--device', 'cpu')
    assert r.returncode == 0, r.stderr[-2000:]
    assert ((tmp_path / 'm0.y4m').read_bytes()
            == (tmp_path / 'solo.y4m').read_bytes())
    j = _cli('jsmpeg_tpu', path, other, '-o', tmp_path / 'jm%d.y4m')
    assert j.returncode == 0, j.stderr[-2000:]
    for i in range(2):
        assert ((tmp_path / f'm{i}.y4m').read_bytes()
                == (tmp_path / f'jm{i}.y4m').read_bytes()), i


def test_cli_ppm_and_poster_on_the_cpu(clip):
    """--ppm and --poster convert colour on the device given (--device
    cpu): frame 0 equals the poster."""
    path, es, _, d = clip
    r = _cli('jsmpeg_tpu_torch', path, '--ppm', d / 'f%d.ppm', '--poster',
             d / 'poster.ppm', '--no-audio', '--offline', '--device', 'cpu')
    assert r.returncode == 0, r.stderr[-2000:]
    assert (d / 'f0.ppm').read_bytes() == (d / 'poster.ppm').read_bytes()
    assert len(list(d.glob('f*.ppm'))) == 6

"""Player.decode_offline with the exact MP2 decode on its own thread
('mp2-offline') beside the video on the calling thread, on the CPU
({'device': 'cpu'}): the same frames and bit-identical PCM as
jsmpeg_tpu's Player and as a serial decode; the audio really runs while
the video does; errors from either side re-raise with no thread left
behind; the device audio mode and audio with no video stay on the
calling thread.  Every wait has a timeout, so a regression fails instead
of hanging."""

import sys
import threading
import time
from functools import lru_cache

import numpy as np
import pytest

from jsmpeg_tpu import sinks as jax_sinks
from jsmpeg_tpu.player import Player as JaxPlayer
from jsmpeg_tpu_torch.models.mpeg1 import MPEG1Decoder
from jsmpeg_tpu_torch.player import Player
from jsmpeg_tpu_torch.sinks import PCMCollector, VideoCollector
from jsmpeg_tpu_torch.testing.gen import encode_test_stream
from jsmpeg_tpu_torch.testing.mp2_enc import encode_stream as mp2_stream
from jsmpeg_tpu_torch.testing.ts_mux import mux_av

CPU = {'device': 'cpu', 'progressive': False}
AUDIO_THREAD = 'mp2-offline'
N_FRAMES, N_AUDIO, BATCH = 10, 24, 4
WAIT_S = 10.0


@lru_cache(maxsize=None)
def _av_ts():
    _, chunks = encode_test_stream(64, 48, n_frames=N_FRAMES, seed=21,
                                   gop=5, frame_rate=25.0)
    video = list(chunks[:-1])
    video[-1] += chunks[-1]
    _, audio = mp2_stream(N_AUDIO, seed=22)
    return mux_av(video, 25.0, audio, 1152, 44100)


def _audio_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith(AUDIO_THREAD)]


@pytest.fixture(autouse=True)
def _small_batches(monkeypatch):
    """Several video batches a file; no audio thread outlives a test."""
    monkeypatch.setattr(MPEG1Decoder, 'BATCH_FRAMES', BATCH)
    yield
    assert _audio_threads() == []


def _player(**opts):
    vc, ac = VideoCollector(), PCMCollector()
    p = Player(_av_ts(), dict(CPU, **opts), renderer=vc, audio_out=ac)
    return p, vc, ac


def _on_thread(fn, seen, name):
    """`fn`, recording into seen[name] the thread each call ran on."""
    def run(*a, **kw):
        seen.setdefault(name, []).append(threading.current_thread().name)
        return fn(*a, **kw)
    return run


@pytest.mark.parametrize('switch', [None, 1e-6], ids=['default', 'fast'])
@pytest.mark.parametrize('batch_gop', [True, False], ids=['batch', 'frame'])
def test_overlap_matches_jax_and_a_serial_decode(batch_gop, switch):
    """Frames, PCM and counts equal to jsmpeg_tpu's Player and to the
    video and the audio decoded apart, one after the other; at a 1 us
    switch interval too, with the Player's stage counts whole."""
    saved = sys.getswitchinterval()
    if switch is not None:
        sys.setswitchinterval(switch)
    try:
        p, vc, ac = _player(batch_gop=batch_gop)
        seen = {}
        p.audio.decode_available = _on_thread(p.audio.decode_available,
                                              seen, 'audio')
        got = p.decode_offline()
    finally:
        sys.setswitchinterval(saved)
    assert got == (N_FRAMES, N_AUDIO)
    assert seen['audio'][0].startswith(AUDIO_THREAD)

    sv, _, _ = _player(audio=False, batch_gop=batch_gop)
    sa, _, sac = _player(video=False)
    assert (sv.decode_offline()[0], sa.decode_offline()[1]) == got
    counts = dict(p.metrics.counts)
    assert counts.pop('audio_beside_video') == 1
    assert counts == {**sv.metrics.counts, **sa.metrics.counts}
    assert counts['audio_batch'] == N_AUDIO
    jvc, jac = jax_sinks.VideoCollector(), jax_sinks.PCMCollector()
    assert JaxPlayer(_av_ts(), {'progressive': False}, renderer=jvc,
                     audio_out=jac).decode_offline() == got

    assert len(vc.frames) == len(sv.renderer.frames) == len(jvc.frames)
    for i, (o, s, j) in enumerate(zip(vc.frames, sv.renderer.frames,
                                      jvc.frames)):
        for a, b, c in zip(o, s, j):
            np.testing.assert_array_equal(a, b, err_msg=f'frame {i}')
            np.testing.assert_array_equal(a, c, err_msg=f'frame {i}')
    assert ac.pcm.shape == (2, N_AUDIO * 1152)
    np.testing.assert_array_equal(ac.pcm, sac.pcm)
    np.testing.assert_array_equal(ac.pcm, jac.pcm)


def test_audio_runs_while_the_video_does():
    """The video's decode waits for the audio's to start: the serial
    order would time out; beside it, the call completes."""
    p, vc, ac = _player()
    started = threading.Event()
    audio, video = p.audio.decode_available, p.video.decode_available

    def audio_first(*a, **kw):
        started.set()
        return audio(*a, **kw)

    def video_after(*a, **kw):
        if not started.wait(WAIT_S):
            raise TimeoutError('the audio did not start beside the video')
        return video(*a, **kw)

    p.audio.decode_available = audio_first
    p.video.decode_available = video_after
    assert p.decode_offline() == (N_FRAMES, N_AUDIO)
    assert vc.frames_rendered == N_FRAMES
    assert ac.pcm.shape == (2, N_AUDIO * 1152)


def test_audio_error_reraises_after_the_video():
    """An error on the audio thread re-raises from decode_offline, after
    the video has rendered every frame; the thread is gone."""
    p, vc, _ = _player()

    def broken():
        raise ValueError('audio broke')

    p.audio.decode_available = broken
    with pytest.raises(ValueError, match='audio broke'):
        p.decode_offline()
    assert vc.frames_rendered == N_FRAMES
    assert _audio_threads() == []


def test_video_error_joins_the_audio_first():
    """The video raises while the audio still runs: the audio finishes
    before the error leaves decode_offline, and its thread is gone."""
    p, _, ac = _player()
    started, finished = threading.Event(), threading.Event()
    audio = p.audio.decode_available

    def slow_audio():
        started.set()
        time.sleep(0.2)
        out = audio()
        finished.set()
        return out

    def broken(*a, **kw):
        if not started.wait(WAIT_S):
            raise TimeoutError('the audio did not start')
        raise RuntimeError('video broke')

    p.audio.decode_available = slow_audio
    p.video.decode_available = broken
    with pytest.raises(RuntimeError, match='video broke'):
        p.decode_offline()
    assert finished.is_set()
    assert ac.pcm.shape == (2, N_AUDIO * 1152)
    assert _audio_threads() == []


@pytest.mark.parametrize('opts', [{'audio_mode': 'device'}, {'video': False}],
                         ids=['device_mode', 'no_video'])
def test_serial_audio_stays_on_the_calling_thread(opts):
    """The device audio mode (CUDA work on a card) and a Player with no
    video decode the audio on the calling thread, after the video."""
    p, vc, ac = _player(**opts)
    seen = {}
    order = []
    p.audio.decode_available = _on_thread(p.audio.decode_available, seen,
                                          'audio')
    if p.video is not None:
        video = p.video.decode_available

        def video_first(*a, **kw):
            out = video(*a, **kw)
            order.append('video')
            return out

        p.video.decode_available = video_first
        audio = p.audio.decode_available

        def audio_after():
            order.append('audio')
            return audio()

        p.audio.decode_available = audio_after
    n_video, n_audio = p.decode_offline()
    assert seen['audio'] == [threading.current_thread().name]
    assert n_audio == N_AUDIO
    assert n_video == (N_FRAMES if p.video is not None else 0)
    assert order == (['video', 'audio'] if p.video is not None else [])
    assert p.metrics.counts['audio_beside_video'] == 0

"""The port's overlapped batch pipeline (MPEG1Decoder._decode_available_batch)
on the CPU ({'device': 'cpu'}): the calling thread parses and renders, one
feeder thread per decode_available call stages and dispatches each batch,
and rendering runs one batch behind dispatch.  Frames are held to
jsmpeg_tpu's decode_available on the same ES bytes with tolerance 0, with
BATCH_FRAMES lowered on both classes so a stream spans several batches;
then the render order, feeder and sink errors, the serial fallback with a
pending batch, streaming writes between calls, and the Player."""

import sys
import threading
from concurrent.futures import ThreadPoolExecutor
from functools import lru_cache

import numpy as np
import pytest

from jsmpeg_tpu.models.mpeg1 import MPEG1Decoder as JaxDecoder
from jsmpeg_tpu_torch.host.native import NativeMPEG1Parser
from jsmpeg_tpu_torch.models import mpeg1
from jsmpeg_tpu_torch.models.mpeg1 import MPEG1Decoder
from jsmpeg_tpu_torch.player import Player
from jsmpeg_tpu_torch.sinks import VideoCollector
from jsmpeg_tpu_torch.testing.gen import (encode_realistic_stream,
                                          encode_test_stream)
from jsmpeg_tpu_torch.testing.quirks import escape_zero_stream
from jsmpeg_tpu_torch.testing.ts_mux import mux_video

CPU = {'device': 'cpu'}
FEEDER = 'jsmpeg-feeder'

# name -> (ES and per-picture chunks, BATCH_FRAMES): each spans several
# batches; 'short_last' ends on a short batch (4 + 4 + 3), 'exact' on a
# full one (the next parse finds nothing), 'one_per_batch' on 9 batches
STREAMS = {
    'short_last': (lambda: encode_test_stream(64, 48, n_frames=11, seed=41,
                                              gop=4), 4),
    'exact': (lambda: encode_realistic_stream(96, 64, n_frames=8, seed=43,
                                              gop=5), 4),
    'one_per_batch': (lambda: encode_test_stream(48, 32, n_frames=9,
                                                 seed=47, gop=3), 1),
}


@lru_cache(maxsize=None)
def _stream(name):
    make, batch_frames = STREAMS[name]
    es, chunks = make()
    return es, chunks, batch_frames


def _np(p):
    return tuple(np.array(x) for x in p)


@lru_cache(maxsize=None)
def _jax_frames(es, batch_frames):
    """jsmpeg_tpu's decode_available of `es` (JAX on the CPU) at
    BATCH_FRAMES = batch_frames, as host arrays."""
    saved = JaxDecoder.BATCH_FRAMES
    JaxDecoder.BATCH_FRAMES = batch_frames
    try:
        dec = JaxDecoder()
        dec.write(0.0, es)
        return tuple(_np(p) for p in dec.decode_available(eof=True))
    finally:
        JaxDecoder.BATCH_FRAMES = saved


def _assert_frames(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        for name, a, b in zip(('y', 'cr', 'cb'), g, w):
            assert a.dtype == np.uint8
            np.testing.assert_array_equal(a, b, err_msg=f'frame {i} {name}')


class _Sink:
    """Keeps every rendered frame; `on_render` runs first at each render."""

    def __init__(self, on_render=None):
        self.frames = []
        self.on_render = on_render

    def resize(self, w, h):
        pass

    def render(self, y, cr, cb):
        if self.on_render is not None:
            self.on_render()
        self.frames.append(_np((y, cr, cb)))


def _feeders():
    return [t for t in threading.enumerate() if t.name.startswith(FEEDER)]


@pytest.fixture(autouse=True)
def _no_feeder_left():
    """No decode_available call leaves its feeder thread behind."""
    yield
    assert not _feeders()


def _decode(es, batch_frames, monkeypatch, retain, chunks=None, sink=None):
    """The port's decode_available at BATCH_FRAMES = batch_frames: the
    frames (retained, or as the sink got them).  With `chunks`, the
    first half is written and decoded before the rest arrives."""
    monkeypatch.setattr(MPEG1Decoder, 'BATCH_FRAMES', batch_frames)
    dec = MPEG1Decoder(CPU)
    sink = sink if sink is not None else _Sink()
    dec.connect(sink)
    parts = ([es] if chunks is None
             else [b''.join(chunks[:len(chunks) // 2]),
                   b''.join(chunks[len(chunks) // 2:])])
    kept = []
    for k, part in enumerate(parts):
        dec.write(0.0, part)
        outs = dec.decode_available(eof=k == len(parts) - 1, retain=retain)
        if retain and outs is not None:
            kept += [_np(p) for p in outs]
    assert dec.frames_decoded == len(kept if retain else sink.frames)
    return kept if retain else sink.frames


def _counting_pools(monkeypatch):
    """Patch the decoder's executor with one that counts the batches
    handed to it; returns the list of executors made."""
    pools = []

    class Pool(ThreadPoolExecutor):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.handed = 0
            pools.append(self)

        def submit(self, *a, **kw):
            self.handed += 1
            return super().submit(*a, **kw)

    monkeypatch.setattr(mpeg1, 'ThreadPoolExecutor', Pool)
    return pools


@pytest.mark.parametrize('retain', [True, False], ids=['retain', 'release'])
@pytest.mark.parametrize('name', sorted(STREAMS))
def test_frames_equal_jax(monkeypatch, name, retain):
    es, _, batch_frames = _stream(name)
    got = _decode(es, batch_frames, monkeypatch, retain)
    _assert_frames(got, _jax_frames(es, batch_frames))


def test_frames_equal_jax_under_fast_switching(monkeypatch):
    """The two threads interleaved at a 1 us switch interval: the carry
    only the feeder advances and the parser only the caller touches give
    the same frames over 9 one-frame batches."""
    es, _, batch_frames = _stream('one_per_batch')
    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        got = _decode(es, batch_frames, monkeypatch, retain=False)
    finally:
        sys.setswitchinterval(saved)
    _assert_frames(got, _jax_frames(es, batch_frames))


def test_render_one_batch_behind(monkeypatch):
    """Batch k renders only after batch k+1 was handed to the feeder (the
    last batch once the loop ends); the parse runs on the calling thread,
    the stage and the dispatch of every batch on the feeder, in batch
    order, and one single-worker feeder serves the call."""
    es, _, batch_frames = _stream('short_last')
    pools = _counting_pools(monkeypatch)
    calls = []

    def traced(name, fn):
        def run(*a, **kw):
            calls.append((name, threading.current_thread().name))
            return fn(*a, **kw)
        return run

    for name in ('_stage_batch', '_dispatch_batch'):
        monkeypatch.setattr(MPEG1Decoder, name,
                            traced(name, getattr(MPEG1Decoder, name)))
    monkeypatch.setattr(NativeMPEG1Parser, 'parse_batch', traced(
        'parse_batch', NativeMPEG1Parser.parse_batch))
    handed_at_render = []
    sink = _Sink(lambda: handed_at_render.append(pools[-1].handed))
    got = _decode(es, batch_frames, monkeypatch, retain=False, sink=sink)
    _assert_frames(got, _jax_frames(es, batch_frames))
    assert len(pools) == 1 and pools[0]._max_workers == 1
    assert handed_at_render == [2] * 4 + [3] * 4 + [3] * 3
    main = threading.current_thread().name
    assert [c for c in calls if c[0] == 'parse_batch'] == [
        ('parse_batch', main)] * 3
    work = [c for c in calls if c[0] != 'parse_batch']
    assert [c[0] for c in work] == ['_stage_batch', '_dispatch_batch'] * 3
    assert all(t.startswith(FEEDER) for _, t in work)


class WireFault(Exception):
    pass


class SinkFault(Exception):
    pass


@pytest.mark.parametrize('where', ['feeder', 'sink'])
def test_error_reraised_without_hang_or_thread(monkeypatch, where):
    """An error on the feeder (building batch 2's wire) reaches the caller
    with its own type: batch 1 renders, nothing after it.  An error of a
    sink on the calling thread (at the first render) reaches the caller
    the same way.  Either way the feeder is shut down before the call
    raises (the autouse fixture: no feeder thread is left)."""
    es, _, batch_frames = _stream('short_last')
    if where == 'feeder':
        build, built = mpeg1.build_fused_buffer, []

        def failing(*a, **kw):
            built.append(threading.current_thread().name)
            if len(built) == 2:
                raise WireFault('batch 2')
            return build(*a, **kw)

        monkeypatch.setattr(mpeg1, 'build_fused_buffer', failing)
        sink, fault = _Sink(), WireFault
    else:
        def refuse():
            raise SinkFault('first render')

        sink, fault = _Sink(refuse), SinkFault
    with pytest.raises(fault):
        _decode(es, batch_frames, monkeypatch, retain=False, sink=sink)
    if where == 'feeder':
        assert all(t.startswith(FEEDER) for t in built)
        _assert_frames(sink.frames, _jax_frames(es, batch_frames)[:4])
    else:
        assert sink.frames == []


@pytest.mark.parametrize('retain', [True, False], ids=['retain', 'release'])
def test_fallback_drains_the_pending_batch(monkeypatch, retain):
    """escape_zero_stream at BATCH_FRAMES = 1: the I picture is the pending
    batch when the P picture's parse returns 'fallback'.  It is rendered
    (or retained) before the serial path decodes the P picture from the
    carry the feeder left; both frames equal jsmpeg_tpu's, in order."""
    es = escape_zero_stream()
    p = NativeMPEG1Parser()
    p.write(es)
    first = p.parse_batch(1, eof=True)
    assert isinstance(first, dict) and first['n'] == 1
    assert p.parse_batch(1, eof=True) == 'fallback'
    log = []
    serial = MPEG1Decoder._decode_available_serial

    def traced_serial(self, *a, **kw):
        log.append('serial')
        return serial(self, *a, **kw)

    monkeypatch.setattr(MPEG1Decoder, '_decode_available_serial',
                        traced_serial)
    sink = _Sink(lambda: log.append('render'))
    got = _decode(es, 1, monkeypatch, retain, sink=sink)
    _assert_frames(got, _jax_frames(es, 1))
    assert log == (['serial', 'render', 'render'] if retain
                   else ['render', 'serial', 'render'])


@pytest.mark.parametrize('retain', [True, False], ids=['retain', 'release'])
def test_streaming_writes_between_calls(monkeypatch, retain):
    """Half the pictures written and decoded, then the rest: the same
    frames as one call over the whole stream."""
    es, chunks, batch_frames = _stream('short_last')
    whole = _decode(es, batch_frames, monkeypatch, retain)
    split = _decode(es, batch_frames, monkeypatch, retain, chunks=chunks)
    _assert_frames(split, whole)
    _assert_frames(split, _jax_frames(es, batch_frames))


def test_player_decode_offline(monkeypatch):
    """The Player's decode_offline (a decodeFirstFrame preview, then
    decode_available(retain=False) through the pipeline) renders the
    same frames as jsmpeg_tpu, in the same order."""
    es, chunks, batch_frames = _stream('short_last')
    monkeypatch.setattr(MPEG1Decoder, 'BATCH_FRAMES', batch_frames)
    pools = _counting_pools(monkeypatch)
    video = chunks[:-1]
    video[-1] = video[-1] + chunks[-1]
    vc = VideoCollector()
    p = Player(mux_video(video, 25.0), dict(CPU, progressive=False,
                                            audio=False), renderer=vc)
    n_video, _ = p.decode_offline()
    assert n_video == vc.frames_rendered == 11
    # the preview is frame 0; the other 10 go through 3 batches
    assert len(pools) == 1 and pools[0].handed == 3
    _assert_frames([_np(f) for f in vc.frames],
                   _jax_frames(es, batch_frames))

"""The port's span recorder (jsmpeg_tpu_torch.metrics) on the CPU: off by
default at no cost (nothing recorded, no clock read), and on, the spans
of a decoded file nested and keyed across the calling and the feeder
thread; the native parse's phases on the binding's clock; the MP2
phases; one 'device.wait' per blocking wait; the device trace's busy
time as a union; and span_breakdown.py's arithmetic (its per-layer
numbers and the wrappers' partition) on hand-made runs."""

import time
from functools import lru_cache

import numpy as np
import pytest
import torch

from jsmpeg_tpu_torch import metrics
from jsmpeg_tpu_torch.host.native import NativeMPEG1Parser, _ptr
from jsmpeg_tpu_torch.models.mp2 import MP2Decoder
from jsmpeg_tpu_torch.models.mpeg1 import MPEG1Decoder
from jsmpeg_tpu_torch.ops.frame import Planes, PlanesBatch
from jsmpeg_tpu_torch.player import Player
from jsmpeg_tpu_torch.sinks import PCMCollector, VideoCollector
from jsmpeg_tpu_torch.sources import BytesSource
from jsmpeg_tpu_torch.testing.gen import encode_test_stream
from jsmpeg_tpu_torch.testing.mp2_enc import encode_stream as mp2_stream
from jsmpeg_tpu_torch.testing.ts_mux import mux_av, mux_video

CPU = {'device': 'cpu'}
FEEDER = 'jsmpeg-feeder'
# the benchmark's own wrappers' names (portbench/loads): no program span
# takes one
WRAPPERS = ('parse_batch', '_feed', 'audio_decode')
N_FRAMES, BATCH = 10, 4


@lru_cache(maxsize=None)
def _es(w=64, h=48, n=N_FRAMES, seed=42, gop=5):
    return encode_test_stream(w, h, n_frames=n, seed=seed, gop=gop,
                              frame_rate=25.0)


@lru_cache(maxsize=None)
def _audio(n=48):
    return mp2_stream(n, seed=43)


@lru_cache(maxsize=None)
def _av_ts():
    _, chunks = _es()
    v = list(chunks[:-1])
    v[-1] += chunks[-1]
    _, af = _audio(12)
    return mux_av(v, 25.0, af, 1152, 44100)


@pytest.fixture
def traced():
    """Tracing on (in memory) for the test, off after it."""
    metrics.enable()
    try:
        yield metrics
    finally:
        metrics.disable()


@pytest.fixture
def counted_clock(monkeypatch):
    """time.monotonic counting its reads."""
    reads = []
    real = time.monotonic

    def clock():
        reads.append(1)
        return real()

    monkeypatch.setattr(time, 'monotonic', clock)
    return reads


def _offline(monkeypatch):
    """A traced Player.decode_offline of a small A/V file, in batches of
    BATCH frames: (player, its video sink, the spans)."""
    monkeypatch.setattr(MPEG1Decoder, 'BATCH_FRAMES', BATCH)
    vc = VideoCollector()
    p = Player(_av_ts(), dict(CPU, progressive=False), renderer=vc,
               audio_out=PCMCollector())
    p.decode_offline()
    p.destroy()
    return p, vc, metrics.spans()


def _by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


# ------------------------------------------------------------------ off

def test_off_records_nothing_and_reads_no_clock(counted_clock):
    """Tracing off: the span sites of the parse, the batch pipeline, the
    copy back and the MP2 decode read no clock, and nothing is kept."""
    assert not metrics.TRACER.on
    before = metrics.spans()
    es, _ = _es()
    with metrics.span('x.y', 3):
        pass
    metrics.record('x.z', 0.0, 1.0)
    dec = MPEG1Decoder(CPU)
    vc = VideoCollector()
    dec.connect(vc)
    dec.write(None, es)
    dec.decode_available(eof=True, retain=False)
    a = MP2Decoder()
    a.connect(PCMCollector())
    a.write(None, _audio(12)[0])
    a.decode_available()
    assert len(vc.frames) == N_FRAMES
    assert counted_clock == []
    assert metrics.spans() == before


def test_off_after_on_leaves_the_native_clock_off(traced):
    """After a traced batch call the parse stamps no more phases once
    tracing is off: the native stamps stay as they were."""
    es, _ = _es(176, 144, n=12)
    p = NativeMPEG1Parser()
    p.write(es)
    assert isinstance(p.parse_batch(4), dict)

    def stamps():
        st = np.zeros(5, np.int64)
        p._lib.mpeg1_parser_last_timing(p._p, _ptr(st))
        return st

    first = stamps()
    assert (np.diff(first) >= 0).all() and first[0] > 0
    metrics.disable()
    assert isinstance(p.parse_batch(4), dict)
    np.testing.assert_array_equal(stamps(), first)


# ------------------------------------------------------------------- on

def test_offline_decode_spans_nest_and_key_across_threads(monkeypatch,
                                                          traced):
    p, vc, spans = _offline(monkeypatch)
    assert len(vc.frames) == N_FRAMES
    # the Player's stage counts, as the CLI's --stats reads them
    assert p.metrics.counts['video_batch'] + p.metrics.counts[
        'video_decode'] == N_FRAMES
    by = _by_name(spans)
    ids = {s.id: s for s in spans}
    parent = lambda s: ids[s.parent].name if s.parent in ids else None
    for name in ('player.open', 'player.demux', 'player.close',
                 'player.video_batch', 'player.audio_batch'):
        assert len(by[name]) == 1 and by[name][0].thread == 'MainThread'
    # the feeder's two phases on its thread, one each a batch
    keys = [0, 4, 8]
    for name in ('feeder.stage', 'feeder.dispatch'):
        assert [s.key for s in by[name]] == keys
        assert all(s.thread.startswith(FEEDER) for s in by[name])
        assert all(s.parent is None for s in by[name])
    # the caller's wait, copy back and render of each batch, in the
    # video's stage
    for name in ('pipeline.wait', 'pipeline.fetch', 'pipeline.render'):
        assert [s.key for s in by[name]] == keys
        assert all(s.thread == 'MainThread' for s in by[name])
        assert {parent(s) for s in by[name]} == {'player.video_batch'}
    # the parse: each batch's phases keyed by its first frame
    parsed = {s.key for s in by['parse.pictures']
              if parent(s) == 'player.video_batch'}
    assert parsed == set(keys)
    # the copy back waits three times a batch on the CPU (no queued copy)
    waits = by['device.wait']
    assert len(waits) == 3 * len(keys)
    assert {parent(s) for s in waits} == {'pipeline.fetch'}
    assert sorted({s.key for s in waits}) == keys
    # the MP2 decode's phases, inside the audio's stage
    for name in ('mp2.parse', 'mp2.synth', 'mp2.play'):
        assert len(by[name]) == 1 and parent(by[name][0]) == \
            'player.audio_batch'
    # each batch's feeder work follows its parse and precedes its copy
    for k in keys:
        stage = next(s for s in by['feeder.stage'] if s.key == k)
        fetch = next(s for s in by['pipeline.fetch'] if s.key == k)
        parse_end = max(s.end for s in spans
                        if s.name.startswith('parse.') and s.key == k)
        assert parse_end <= stage.start and stage.end <= fetch.start


def test_no_program_span_takes_a_wrapper_name(monkeypatch, traced):
    _, _, spans = _offline(monkeypatch)
    names = {s.name for s in spans}
    assert not names & set(WRAPPERS)
    assert all('.' in n for n in names)


def test_spans_go_to_a_sink_and_stay_out_of_memory(monkeypatch):
    got = []
    metrics.enable(sink=lambda *a: got.append(a))
    try:
        _offline(monkeypatch)
    finally:
        metrics.disable()
    assert metrics.spans() == []
    assert {a[0] for a in got} >= {'feeder.dispatch', 'pipeline.wait',
                                   'parse.scan', 'mp2.synth'}
    assert all(len(a) == 4 and a[2] <= a[3] for a in got)


def test_stage_timer_stage_is_a_span(traced):
    t = metrics.StageTimer()
    with t.time('parse', n=10):
        with metrics.span('unit.inner'):
            pass
    assert t.summary()['parse']['count'] == 10
    inner, outer = metrics.spans()
    assert outer.name == 'player.parse' and inner.parent == outer.id


# ------------------------------------------------------ native phases

PHASES = NativeMPEG1Parser.PARSE_PHASES


@pytest.mark.parametrize('wire', [dict(), dict(packed=False),
                                  dict(packed=False, sparse=False)],
                         ids=['packed', 'sparse', 'dense'])
def test_native_phases_cover_the_binding_call(traced, wire):
    """Each parse_batch call: its native phases lie inside the call on
    the same clock, in order, and with 'parse.wire' they cover at least
    95 % of the calls' time."""
    es, _ = _es(176, 144, n=12)
    p = NativeMPEG1Parser()
    p.write(es)
    frames = 0
    covered = called = 0.0
    while True:
        n0 = len(metrics.spans())
        t0 = time.monotonic()
        b = p.parse_batch(4, eof=True, **wire)
        t1 = time.monotonic()
        got = metrics.spans()[n0:]
        assert {s.key for s in got} == {frames}
        assert {s.name for s in got} <= set(PHASES) | {'parse.wire'}
        assert all(t0 <= s.start <= s.end <= t1 for s in got)
        native = [s for s in got if s.name in PHASES]
        assert all(x.end <= y.start for x, y in zip(native, native[1:]))
        covered += sum(s.end - s.start for s in got)
        called += t1 - t0
        if b is None:
            assert [s.name for s in native] == ['parse.scan']
            break
        assert [s.name for s in native] == list(PHASES)
        frames += b['n']
    assert frames == 12
    assert covered >= 0.95 * called


def test_mp2_phases_cover_decode_available(traced):
    a = MP2Decoder()
    a.connect(PCMCollector())
    a.write(None, _audio(64)[0])
    t0 = time.monotonic()
    pcm = a.decode_available()
    t1 = time.monotonic()
    assert pcm.shape[0] == 64
    by = _by_name(metrics.spans())
    covered = sum(s.end - s.start for n in ('mp2.parse', 'mp2.synth',
                                            'mp2.play') for s in by[n])
    assert covered >= 0.95 * (t1 - t0)


# ------------------------------------------------------- device waits

class _DrainSource(BytesSource):
    """A streaming source handing the decoder one picture's bytes per
    drain (on the player's tick), as a live feed does."""

    streaming = True

    def __init__(self, chunks):
        super().__init__(b'')
        self.chunks = list(chunks)

    def start(self):
        self.established = True

    def drain(self):
        if self.chunks:
            self.destination.write(self.chunks.pop(0))


def test_live_ticks_wait_three_times_a_frame(traced):
    """A streaming Player's tick decodes a picture at F = 1: each frame
    is decode.stage / dispatch / fetch / render keyed by its index, and
    its three planes' copies are one device.wait each."""
    _, chunks = _es()
    ts = mux_video(chunks, 25.0)
    step = 188 * 4
    src = _DrainSource(ts[i:i + step] for i in range(0, len(ts), step))
    vc = VideoCollector()
    p = Player(src, dict(CPU, audio=False, streaming=True), renderer=vc)
    p.play()
    for _ in range(len(src.chunks) + 4):
        p.tick()
    n = len(vc.frames)
    assert n >= N_FRAMES - 1         # the last waits for the next start
    spans = metrics.spans()
    by = _by_name(spans)
    ids = {s.id: s for s in spans}
    assert len(by['device.wait']) == 3 * n
    assert {ids[s.parent].name for s in by['device.wait']} == \
        {'decode.fetch'}
    for name in ('decode.stage', 'decode.dispatch', 'decode.fetch',
                 'decode.render'):
        assert [s.key for s in by[name]] == list(range(n))
        assert {ids[s.parent].name for s in by[name]} == {'player.tick'}
    assert len(by['tick.drain']) == len(by['player.tick'])
    # every parse call sits inside a tick (the first-frame preview's
    # inside the drain that brought the sequence header)
    assert {ids[s.parent].name for s in by['parse.wire']} <= \
        {'player.tick', 'tick.drain'}


class _Event:
    def __init__(self):
        self.waits = 0

    def synchronize(self):
        self.waits += 1


def test_a_queued_copy_back_waits_once(traced):
    planes = Planes(*[torch.zeros((2, 4, 4), dtype=torch.uint8)
                      for _ in range(3)])
    pb = PlanesBatch(planes)
    ev = _Event()
    pb._fetch = (planes, ev)
    pb.fetch_all()
    assert ev.waits == 1
    assert [s.name for s in metrics.spans()] == ['device.wait']
    PlanesBatch(planes).fetch_all()      # no queued copy: one per plane
    assert len(metrics.spans()) == 4


# ------------------------------------------------------ device trace

@pytest.mark.parametrize('intervals,want', [
    ([], 0.0),
    ([(0.0, 1.0), (2.0, 3.0)], 2.0),
    ([(0.0, 2.0), (1.0, 3.0)], 3.0),
    ([(0.0, 4.0), (1.0, 2.0), (1.5, 3.0)], 4.0),
    ([(1.0, 1.0), (3.0, 2.0), (0.0, 0.5)], 0.5),
    ([(2.0, 3.0), (0.0, 1.0), (1.0, 2.0)], 3.0),
])
def test_union_seconds_counts_overlaps_once(intervals, want):
    assert metrics.union_seconds(intervals) == pytest.approx(want)
    assert metrics.union_seconds(iter(intervals)) == pytest.approx(want)


# ------------------------------------- span_breakdown.py's arithmetic

# metric -> (spans as (name, start, end), frames, expected value)
_W = (100.0, 110.0)
SPAN_CASES = {
    'demux_ms_per_frame.offline':
        ([('player.demux', 101.0, 101.004)], 4, 1.0),
    'parse_serial_ms_per_frame.offline':
        ([('parse.scan', 101.0, 101.001), ('parse.compact', 102.0, 102.002),
          ('parse.wire', 103.0, 103.001), ('parse.join', 104.0, 105.0)],
         2, 2.0),
    'parse_straggler_ms_per_frame.offline':
        ([('parse.join', 101.0, 101.003)], 3, 1.0),
    'feeder_wait_ms_per_frame.offline':
        ([('pipeline.wait', 101.0, 101.008)], 4, 2.0),
    'copy_wait_ms_per_frame.offline':
        ([('pipeline.fetch', 101.0, 101.002),
          ('pipeline.fetch', 120.0, 121.0)], 2, 1.0),
    'mp2_parse_ms_per_frame.offline':
        ([('mp2.parse', 101.0, 101.005)], 5, 1.0),
    'mp2_synth_ms_per_frame.offline':
        ([('mp2.synth', 101.0, 101.006)], 2, 3.0),
    'parse_serial_ms_per_frame.live':
        ([('parse.wire', 101.0, 101.001), ('parse.scan', 102.0, 102.003)],
         2, 2.0),
    'dispatch_ms_per_frame.live':
        ([('decode.stage', 101.0, 101.001),
          ('decode.dispatch', 101.5, 101.502)], 3, 1.0),
    'fetch_ms_per_frame.live':
        ([('decode.fetch', 101.0, 101.004)], 2, 2.0),
    'host_waits_per_frame.live':
        ([('device.wait', 101.0 + k, 101.5 + k) for k in range(6)]
         + [('device.wait', 99.0, 99.5)], 2, 3.0),
}


class _Run:
    """The part of a portbench run a span reader reads."""

    def __init__(self, spans, frames):
        self.spans = spans
        self._frames = frames

    def layer_window(self):
        return (*_W, self._frames)


def _spans(made, thread='MainThread'):
    from portbench.trace import Span, Spans
    spans = Spans()
    spans.spans.extend(Span(n, thread, a, b) for n, a, b in made)
    return spans


def test_span_metrics_are_the_ones_cased():
    import span_breakdown
    assert set(span_breakdown.SPAN_METRICS) == set(SPAN_CASES)


@pytest.mark.parametrize('name', sorted(SPAN_CASES))
def test_span_metric_reads_a_hand_made_run(name):
    """Each of span_breakdown.py's metrics reads the window's program
    spans of a hand-made run, and nothing where they are not."""
    from span_breakdown import read_metric
    made, frames, want = SPAN_CASES[name]
    assert read_metric(_Run(_spans(made), frames), name) == \
        pytest.approx(want)
    assert read_metric(_Run(_spans([]), frames), name) is None
    assert read_metric(_Run(None, frames), name) is None


def test_partition_of_the_wrappers():
    """The share of each wrapper the program spans of its layer cover
    inside it, on its own thread only."""
    from span_breakdown import partition
    spans = _spans([('parse_batch', 0.0, 1.0), ('parse.scan', 0.0, 0.25),
                    ('parse.wire', 0.25, 0.75), ('parse.scan', 2.0, 3.0),
                    ('audio_decode', 5.0, 7.0), ('mp2.parse', 5.5, 6.5),
                    ('mp2.synth', 6.5, 7.5)]).spans
    spans += _spans([('parse.join', 0.5, 1.0), ('_feed', 0.0, 2.0),
                     ('feeder.stage', 0.0, 1.0), ('feeder.dispatch', 1.0,
                                                  2.0)], 'feeder').spans
    got = partition(spans)
    assert got['parse_batch'] == {'seconds': 1.0, 'share': 0.75}
    assert got['_feed'] == {'seconds': 2.0, 'share': 1.0}
    assert got['audio_decode'] == {'seconds': 2.0, 'share': 0.5}

"""Observability: the port's span recorder, per-stage counters/timers and
a device trace helper.

The reference exposes per-decode timing callbacks (onVideoDecode /
onAudioDecode) and little else; this module adds

- spans (`span`, `record`): named intervals of host work on
  `time.monotonic()`, each with its thread, the span open around it on
  that thread (its parent) and a `key`, the first frame index of the
  batch or picture it serves, so that one batch's spans on the calling
  and on the feeder thread join.  Off by default: a span site then
  costs one attribute check, reads no clock and allocates nothing.
  `enable()` keeps them in memory (`spans()`), `enable(sink)` hands each
  to `sink(name, thread, start, end)` as it ends;
- structured pipeline counters (frames, stage seconds: `StageTimer`);
- `device_trace`, which wraps `torch.profiler` for device-side
  inspection: the device's busy time over a region, and a Chrome trace
  of it.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import defaultdict
from typing import Callable, Dict, List, NamedTuple, Optional


class Span(NamedTuple):
    name: str
    thread: str
    start: float            # time.monotonic() seconds
    end: float
    id: int
    parent: Optional[int]   # the id of the span open around it, same thread
    key: Optional[int]      # first frame index of its batch or picture


class _Open:
    """A span while it runs (tracing on)."""

    __slots__ = ('tracer', 'name', 'key', 'id', 'parent', 'start')

    def __init__(self, tracer: 'Tracer', name: str, key: Optional[int]):
        self.tracer = tracer
        self.name = name
        self.key = key

    def __enter__(self):
        self.tracer._enter(self)
        return self

    def __exit__(self, *exc):
        self.tracer._exit(self)
        return False


_OFF = contextlib.nullcontext()


class Tracer:
    """The span recorder (module-level `TRACER`; see the module
    docstring).  Spans nest per thread; a span given no key takes its
    parent's."""

    def __init__(self):
        self.on = False
        self.sink: Optional[Callable] = None
        self.spans: List[Span] = []
        self._ids = itertools.count(1)
        self._local = threading.local()

    def enable(self, sink: Optional[Callable] = None) -> None:
        """Start recording spans: in memory (`spans()`), or handed to
        `sink(name, thread, start, end)` as each ends."""
        self.spans = []
        self.sink = sink
        self.on = True

    def disable(self) -> None:
        self.on = False
        self.sink = None

    def span(self, name: str, key: Optional[int] = None):
        """`with span(name, key):` records the enclosed work."""
        if not self.on:
            return _OFF
        return _Open(self, name, key)

    def record(self, name: str, start: float, end: float,
               key: Optional[int] = None) -> None:
        """A span timed elsewhere (the native parse's phases, on the same
        clock), on the calling thread, inside the span open there."""
        if not self.on:
            return
        top = self._top()
        if top is not None and key is None:
            key = top.key
        self._emit(name, start, end, next(self._ids),
                   top.id if top is not None else None, key)

    def _top(self) -> Optional[_Open]:
        loc = self._local
        if not hasattr(loc, 'stack'):
            loc.stack = []
            loc.thread = threading.current_thread().name
        return loc.stack[-1] if loc.stack else None

    def _enter(self, s: _Open) -> None:
        top = self._top()
        s.parent = top.id if top is not None else None
        if s.key is None and top is not None:
            s.key = top.key
        s.id = next(self._ids)
        self._local.stack.append(s)
        s.start = time.monotonic()

    def _exit(self, s: _Open) -> None:
        end = time.monotonic()
        self._local.stack.pop()
        self._emit(s.name, s.start, end, s.id, s.parent, s.key)

    def _emit(self, name: str, start: float, end: float, id: int,
              parent: Optional[int], key: Optional[int]) -> None:
        sink = self.sink
        if sink is not None:
            sink(name, self._local.thread, start, end)
        else:
            self.spans.append(Span(name, self._local.thread, start, end,
                                   id, parent, key))


TRACER = Tracer()
span = TRACER.span
record = TRACER.record
enable = TRACER.enable
disable = TRACER.disable


def spans() -> List[Span]:
    """The spans recorded in memory since the last `enable()`."""
    return list(TRACER.spans)


class StageTimer:
    """The Player's accumulating wall-clock timers + counters keyed by
    stage name; with tracing on, each timed stage is also the span
    'player.<stage>'."""

    def __init__(self):
        self.seconds: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def time(self, stage: str, n: int = 1):
        t0 = time.monotonic()
        try:
            with span('player.' + stage):
                yield
        finally:
            self.seconds[stage] += time.monotonic() - t0
            self.counts[stage] += n

    def add(self, stage: str, n: int = 1) -> None:
        self.counts[stage] += n

    def rate(self, stage: str) -> float:
        s = self.seconds.get(stage, 0.0)
        return self.counts.get(stage, 0) / s if s else 0.0

    def summary(self) -> Dict[str, dict]:
        out = {}
        for k in sorted(set(self.seconds) | set(self.counts)):
            out[k] = {
                'count': self.counts.get(k, 0),
                'seconds': round(self.seconds.get(k, 0.0), 6),
                'per_second': round(self.rate(k), 2),
            }
        return out


def union_seconds(intervals) -> float:
    """The length of the union of (start, end) intervals: the time at
    least one of them covers, overlapping time counted once."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


class DeviceTrace:
    """What `device_trace` measured: `wall_s` of the region (fenced by
    device synchronizes), `device_s`, the time in which at least one
    kernel, copy or memset the profiler saw ran on the device (the union
    of their intervals), and `busy_share` = device_s / wall_s.
    `profile` is the torch profiler, for its tables."""

    def __init__(self):
        self.wall_s = 0.0
        self.device_s = 0.0
        self.profile = None

    @property
    def busy_share(self) -> float:
        return self.device_s / self.wall_s if self.wall_s else 0.0


@contextlib.contextmanager
def device_trace(path: Optional[str] = None):
    """Profile a decode region with `torch.profiler` (CPU ops and CUDA
    activity); yields a DeviceTrace filled in at exit, and writes a
    Chrome trace (chrome://tracing, Perfetto) to `path` when given."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    out = DeviceTrace()
    with profile(activities=acts) as prof:
        if cuda:
            torch.cuda.synchronize()
        t0 = time.monotonic()
        yield out
        if cuda:
            torch.cuda.synchronize()
        out.wall_s = time.monotonic() - t0
    out.profile = prof
    # each kernel or copy on the device is an event of its own (the CPU
    # op that launched it spans the same time again: skipped)
    cpu = torch.autograd.DeviceType.CPU
    out.device_s = union_seconds(
        (e.time_range.start * 1e-6, e.time_range.end * 1e-6)
        for e in prof.events() if e.device_type != cpu)
    if path is not None:
        prof.export_chrome_trace(path)

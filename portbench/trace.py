"""What a traced run records, and the arithmetic that turns it into
per-layer numbers.

- `Spans`: the benchmark's own wrappers around the program's calls into
  each layer (the pattern of `chip_smoke.py`'s `stage_probe`): each call
  is recorded as (name, thread, start, end) on the host's monotonic
  clock.
- `DeviceTrace`: the device's kernels, copies and memsets from
  `torch.profiler` over the traced window, put on the host's clock.  The
  device's busy time is the union of their intervals (overlapping work
  counts once), not the sum of their durations.
"""

from __future__ import annotations

import heapq
import re
import sys
import threading
import time
from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional, Tuple


class Span(NamedTuple):
    name: str
    thread: str
    start: float        # host monotonic seconds
    end: float


class Spans:
    """Thread-safe span recorder; `wrap` times a callable."""

    def __init__(self):
        self.spans: List[Span] = []
        self._lock = threading.Lock()

    def wrap(self, name: str, fn):
        def run(*a, **kw):
            t0 = time.monotonic()
            try:
                return fn(*a, **kw)
            finally:
                t1 = time.monotonic()
                with self._lock:
                    self.spans.append(Span(name, threading.current_thread()
                                           .name, t0, t1))
        run.__wrapped__ = fn
        return run

    def total(self, name: str, start: float, end: float) -> Tuple[float, int]:
        """(seconds, calls) of the spans `name` that began in [start,
        end]."""
        s = [x for x in self.spans
             if x.name == name and start <= x.start <= end]
        return sum(x.end - x.start for x in s), len(s)


def union_length(intervals: List[Tuple[float, float]], lo: float,
                 hi: float) -> float:
    """The length of the union of `intervals`, clipped to [lo, hi]."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
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


def idle_gaps(intervals: List[Tuple[float, float]], lo: float,
              hi: float) -> List[Tuple[float, float]]:
    """The stretches of [lo, hi] in which no interval runs."""
    gaps, at = [], lo
    for s, e in sorted(intervals):
        if e <= at:
            continue
        if s > at:
            gaps.append((at, min(s, hi)))
        at = max(at, e)
        if at >= hi:
            break
    if at < hi:
        gaps.append((at, hi))
    return [(s, e) for s, e in gaps if e > s]


class DeviceEvent(NamedTuple):
    name: str
    start: float        # host monotonic seconds
    end: float


class DeviceTrace:
    """The device's work over a traced window [start, end] (host
    monotonic seconds; the window is fenced by synchronizes)."""

    def __init__(self, events: List[DeviceEvent], start: float, end: float):
        self.events = events
        self.start = start
        self.end = end

    @property
    def window_s(self) -> float:
        return self.end - self.start

    @property
    def busy_s(self) -> float:
        return union_length([(e.start, e.end) for e in self.events],
                            self.start, self.end)

    def kernel_s(self, pattern: str) -> Tuple[float, int]:
        """(seconds, launches) of the kernels whose name matches the
        regular expression `pattern`, inside the window."""
        rx = re.compile(pattern)
        hit = [e for e in self.events if rx.search(e.name)
               and e.start >= self.start and e.end <= self.end]
        return sum(e.end - e.start for e in hit), len(hit)

    def top_ops(self, n: int = 10) -> List[list]:
        by: Dict[str, float] = defaultdict(float)
        for e in self.events:
            by[short_name(e.name)] += max(0.0, min(e.end, self.end)
                                          - max(e.start, self.start))
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
                if v > 0][:n]

    def gaps_by_host(self, spans: List[Span], n: int = 10) -> List[list]:
        """The device's idle time in the window, summed by what the host
        was doing at each gap's middle: per thread, the spans open then,
        outer to inner ('_feed>parse_batch'), the threads joined
        by '+'; 'no span' where none was.  One sweep over the gaps and
        each thread's spans in time order."""
        gaps = idle_gaps([(e.start, e.end) for e in self.events],
                         self.start, self.end)
        mids = [(g0 + g1) / 2 for g0, g1 in gaps]
        at: List[Dict[str, str]] = [{} for _ in gaps]
        threads: Dict[str, List[Span]] = defaultdict(list)
        for s in spans:
            if s.end > self.start and s.start < self.end:
                threads[s.thread].append(s)
        for thread, todo in threads.items():
            todo.sort(key=lambda s: s.start)
            open_, k = [], 0
            for i, m in enumerate(mids):
                while k < len(todo) and todo[k].start <= m:
                    heapq.heappush(open_, (todo[k].end, k))
                    k += 1
                while open_ and open_[0][0] < m:
                    heapq.heappop(open_)
                if open_:
                    at[i][thread] = '>'.join(
                        todo[j].name for j in sorted(j for _, j in open_))
        by: Dict[str, float] = defaultdict(float)
        for (g0, g1), c in zip(gaps, at):
            by['+'.join(sorted(c.values())) or 'no span'] += g1 - g0
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
                ][:n]


def short_name(name: str) -> str:
    """A device operation's name without its return type, namespaces'
    noise, template arguments and argument list, at most 64
    characters."""
    base = name.replace('(anonymous namespace)::', '')
    while True:
        cut = re.sub(r'<[^<>]*>', '', base)
        if cut == base:
            break
        base = cut
    base = re.sub(r'^void ', '', base).split('(')[0].strip()
    return (base or name)[:64]


def _ns(ev, what: str) -> Optional[int]:
    for attr, scale in ((f'{what}_ns', 1), (f'{what}_us', 1000)):
        f = getattr(ev, attr, None)
        if f is not None:
            return int(f() * scale)
    return None


class Profiler:
    """The profiler's device activity alone (no host events, which at a
    window's rate are millions), through the autograd profiler's own
    calls, so that its events are read as recorded with no tree of host
    events built from them.  It starts before the window: its start-up
    takes seconds, which a live feed would see as a stall.  The window
    opens and closes fenced by synchronizes; a marker kernel
    (`torch.cuda._sleep`, `spin_kernel`) launched at a known host time
    puts the device's clock on the host's (the first one after the start
    is a warm-up: it can wait on the profiler's own set-up)."""

    MARKER = 'spin_kernel'

    def __init__(self, torch):
        self.torch = torch

    def start(self) -> None:
        from torch._C._profiler import _ExperimentalConfig
        from torch.autograd import (ProfilerConfig, ProfilerState,
                                    _enable_profiler, _prepare_profiler)
        from torch.profiler import ProfilerActivity
        config = ProfilerConfig(ProfilerState.KINETO, False, False, False,
                                False, False, _ExperimentalConfig())
        acts = {ProfilerActivity.CUDA}
        _prepare_profiler(config, acts)
        _enable_profiler(config, acts)
        self._mark()

    def _mark(self) -> float:
        cuda = self.torch.cuda
        cuda.synchronize()
        cuda._sleep(1000)
        t = time.monotonic()
        cuda.synchronize()
        return t

    def open_window(self) -> None:
        self.m0 = self._mark()
        self.h0 = time.monotonic()

    def close_window(self) -> None:
        self.torch.cuda.synchronize()
        self.h1 = time.monotonic()
        self.m1 = self._mark()

    def stop(self) -> DeviceTrace:
        """Stops the profiler; the device's kernels, copies and memsets
        on the host's clock, the markers left out."""
        from torch.autograd import _disable_profiler
        t0 = time.monotonic()
        cpu = self.torch.autograd.DeviceType.CPU
        raw = [e for e in _disable_profiler().events()
               if e.device_type() != cpu]
        marks = sorted((e for e in raw if self.MARKER in e.name()),
                       key=lambda e: _ns(e, 'start'))
        if len(marks) < 3:
            raise RuntimeError('the profiler recorded no window markers')
        offset = self.m0 - _ns(marks[1], 'start') * 1e-9
        drift = self.m1 - _ns(marks[-1], 'start') * 1e-9 - offset
        if abs(drift) > 1e-3:
            raise RuntimeError(f'the device clock drifted {drift * 1e3:.3f}'
                               ' ms from the host clock over the window')
        events = []
        for e in raw:
            if self.MARKER in e.name():
                continue
            s = _ns(e, 'start') * 1e-9 + offset
            events.append(DeviceEvent(e.name(), s,
                                      s + _ns(e, 'duration') * 1e-9))
        print(f'portbench: the profiler held {len(raw)} device events, '
              f'read in {time.monotonic() - t0:.1f} s; clock offset '
              f'{offset:.6f} s, drift {drift * 1e6:.0f} us',
              file=sys.stderr, flush=True)
        return DeviceTrace(events, self.h0, self.h1)

"""The live feeds' generator: a process of its own that serves S MPEG-TS
feeds on localhost TCP ports, on a fixed schedule that does not slow
when the decoder does (an open loop).

Feed s is the pool's GOPs in its own seeded order, muxed as one endless
TS stream at the configuration's frame rate.  Picture i's TS packets are
due at `phase_s + i / fps` (the feeds are staggered in phase, over a
GOP and a frame), as a live encoder emits a picture, and go out then in
chunks of up to `chunk_bytes` (7 TS packets, as the relay forwards
them), one write a chunk.

Picture i is complete with the first chunk of picture i + 1, whose start
code ends it; that chunk's due time is picture i's.  The generator runs
on a core of its own, at a raised priority where the system allows it,
and reports when each picture's first chunk went out: a frame's latency
runs from then, so that the generator's own lateness is not the
decoder's.
"""

from __future__ import annotations

import heapq
import os
import socket
import time
from typing import List

import numpy as np


def build_feed(gops: List[List[bytes]], order, fps: float,
               phase_s: float):
    """(ts bytes, sends [(due_s, start, end)] a picture,
    picture_due_s [n - 1]) of one feed: the GOPs of `order` muxed as one
    video stream."""
    from .gen.ts_mux import TSMuxer
    mux = TSMuxer()
    starts = []
    for g in order:
        for chunk in gops[int(g)]:
            pts = len(starts) / fps
            starts.append(len(mux.out))
            mux.add_access_unit(0x100, 0xE0, chunk, pts, bounded=False)
    ts = mux.getvalue()
    n = len(starts)
    starts.append(len(ts))
    sends = [(phase_s + i / fps, starts[i], starts[i + 1]) for i in range(n)]
    return ts, sends, phase_s + np.arange(1, n) / fps


def isolate(core: int) -> bool:
    """Pins this process to `core` and raises its priority; whether the
    system allowed the priority."""
    os.sched_setaffinity(0, {core})
    try:
        os.setpriority(os.PRIO_PROCESS, 0, -10)
        return True
    except OSError:
        return False


def serve(gops, orders, fps, chunk_bytes, phases, conn, core) -> None:
    """The generator process: builds the feeds, reports each picture's
    due time, listens on one localhost port per feed, and once every
    feed is connected and the start time has come, sends on schedule
    until the stop time.  Messages on `conn`: out (ports), out (picture
    due times), out 'connected', in (t0, stop_s), out (lateness stats,
    per feed the monotonic time each picture's first chunk went out), in
    'close'."""
    raised = isolate(core)
    feeds = [build_feed(gops, o, fps, ph)
             for o, ph in zip(orders, phases)]
    listeners = []
    for _ in feeds:
        ls = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        ls.bind(('127.0.0.1', 0))
        ls.listen(1)
        ls.settimeout(120)
        listeners.append(ls)
    conn.send([ls.getsockname()[1] for ls in listeners])
    conn.send([f[2] for f in feeds])
    socks = []
    try:
        for ls in listeners:
            c, _ = ls.accept()
            c.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            socks.append(c)
        conn.send('connected')
        t0, stop_s = conn.recv()
        views = [memoryview(f[0]) for f in feeds]
        events = heapq.merge(*[[(d, s, a, b) for d, a, b in f[1]]
                               for s, f in enumerate(feeds)])
        late = []
        sent: List[List[float]] = [[] for _ in feeds]
        for due, s, a, b in events:
            if due > stop_s:
                break
            target = t0 + due
            wait = target - time.monotonic()
            if wait > 0:
                time.sleep(wait)
            for c in range(a, b, chunk_bytes):
                socks[s].sendall(views[s][c:min(c + chunk_bytes, b)])
                if c == a:
                    sent[s].append(time.monotonic())
            late.append(sent[s][-1] - target)
        late = np.array(late) if late else np.zeros(1)
        conn.send(({'sends': int(late.size), 'priority_raised': raised,
                    'late_p50_ms': float(np.percentile(late, 50) * 1e3),
                    'late_p99_ms': float(np.percentile(late, 99) * 1e3),
                    'late_max_ms': float(late.max() * 1e3)}, sent))
        conn.recv()
    finally:
        for c in socks + listeners:
            c.close()

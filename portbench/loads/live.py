"""Open-loop live feeds: `feeds` camera feeds at the configuration's
frame rate, each a seeded order of the pool's GOPs, pushed by a separate
generator process (`portbench.feedgen`) over localhost TCP, one port a
feed, on a fixed schedule.  The decode side connects to them with the
port's `TCPSource`, as it connects to the relay, and runs the mix's
`entry`: `player`, one feed into a streaming `Player` (video only),
`tick()`ed with a sleep of `interval_s` between ticks, its renderer
stamping each frame (the planes reach it on the host).

The generator runs on a core of its own, which the decode side leaves
to it.  A frame's latency runs from the send of the chunk that completes
its picture (picture i + 1's first chunk: its due time, or the moment it
went out where the generator ran late) to its planes on the host.  The
window counts every frame due within it; one not delivered by the
window's end counts with its age at the end.  After the window the
decode goes on (up to `grace_s`) until every frame due in the window has
come, and a seeded sample of them is held to the reference.
"""

from __future__ import annotations

import math
import os
import time
from multiprocessing import get_context
from typing import List

import numpy as np

from ..pool import derived_seed, make_pool, reference
from .base import (Compared, differing_pixels, now, percentile, planes_of,
                   say)


class Cell:
    """One run of a live cell (see the module docstring)."""

    def __init__(self, spec, seed: int, device: str, seconds: float,
                 spans=None, control: bool = False):
        self.spec = spec
        self.cfg = spec.config
        self.mix = spec.traffic
        self.seed = int(seed)
        self.device = device
        self.seconds = float(seconds)
        # the control: the reference with a float32 IDCT, put in the
        # program's place for the sampled frames
        self.control = control
        # traced: the benchmark's spans (trace.Spans) and the profiler,
        # which starts before the feeds do
        self.spans = spans
        self.prof = None
        self.trace = None
        self.launches = None
        self.proc = None
        self.conn = None
        self.sources = []
        self.cores = None

    # ------------------------------------------------------------ set-up

    def setup(self) -> None:
        cfg, mix = self.cfg, self.mix
        t0 = now()
        self.pool = make_pool(cfg, self.seed)
        # the benchmark's own inputs (the pool, the generator's wait for
        # its feeds below), which no user of the program makes: left out
        # of `setup_s`
        self.inputs_s = now() - t0
        self.n = n = mix['feeds']
        fps, gop = float(cfg['fps']), cfg['gop']
        lead, warm = mix['lead_s'], mix['warm_s']
        span = lead + warm + self.seconds + mix['tail_s']
        n_gops = math.ceil(span * fps / gop) + 1
        rng = np.random.default_rng(derived_seed(self.seed, 4))
        orders = [rng.integers(0, len(self.pool.gops), n_gops)
                  for _ in range(n)]
        self.orders = orders
        # feeds staggered over a GOP and a frame: independent cameras,
        # their I pictures and their frame times spread evenly
        phases = [s * (gop + 1) / (n * fps) for s in range(n)]
        from .. import feedgen
        # the generator's core, which the decode side (this thread and
        # the threads it starts from now on) leaves to it
        self.cores = os.sched_getaffinity(0)
        cores = sorted(self.cores)
        gen_core = cores[-1]
        ctx = get_context('spawn')
        self.conn, child = ctx.Pipe()
        self.proc = ctx.Process(
            target=feedgen.serve, daemon=True,
            args=(self.pool.gops, orders, fps, mix['chunk_bytes'], phases,
                  child, gen_core))
        self.proc.start()
        child.close()
        if len(cores) > 1:
            os.sched_setaffinity(0, cores[:-1])
        self.at: List[List[float]] = [[] for _ in range(n)]
        self.kept: List[dict] = [{} for _ in range(n)]
        self.keep: List[set] = [set() for _ in range(n)]
        self._build_decoder()
        self._warm_kernels()
        t0 = now()
        ports = self.conn.recv()
        self.due_rel = [np.asarray(d) for d in self.conn.recv()]
        self.inputs_s += now() - t0
        self._connect(ports)
        if self.conn.recv() != 'connected':
            raise RuntimeError('the feed generator did not connect')
        if self.spans is not None and self.device != 'cpu':
            # started before the schedule is fixed: its start-up stalls
            # the process for seconds
            import torch
            from ..trace import Profiler
            self.prof = Profiler(torch)
            self.prof.start()
        self.t0 = now() + lead
        self.w0 = self.t0 + warm
        self.w1 = self.w0 + self.seconds
        self.due = [self.t0 + d for d in self.due_rel]
        self.conn.send((self.t0, warm + self.seconds + mix['stop_after_s']))
        # the frames due in the window, and a seeded sample of them
        self.in_window = [np.nonzero((d >= self.w0) & (d <= self.w1))[0]
                          for d in self.due]
        srng = np.random.default_rng(derived_seed(self.seed, 5))
        pairs = [(s, int(i)) for s in range(n) for i in self.in_window[s]]
        k = min(mix['sample_frames'], len(pairs))
        pick = srng.choice(len(pairs), k, replace=False) if k else []
        for j in pick:
            s, i = pairs[int(j)]
            self.keep[s].add(i)
        self._loop_until(self.w0)

    def _build_decoder(self) -> None:
        from jsmpeg_tpu_torch.sinks import VideoSinkBase
        cell = self
        if self.mix['entry'] != 'player' or self.n != 1:
            raise ValueError('the live load runs one feed into a Player')

        class Stamp(VideoSinkBase):
            def render(self, y, cr, cb):
                cell._stamp(0, now(), y, cr, cb)
                self.frames_rendered += 1

        self.sink = Stamp()

    def _warm_kernels(self) -> None:
        """Decode a pool GOP through a throwaway decoder while the
        generator builds the feeds."""
        from jsmpeg_tpu_torch.models.mpeg1 import MPEG1Decoder
        d = MPEG1Decoder({'device': self.device})
        d.write(None, b''.join(self.pool.gops[0]))
        while d.decode(eof=True) is not None:
            pass
        if self.device != 'cpu':
            import torch
            torch.cuda.synchronize()

    def _connect(self, ports) -> None:
        from jsmpeg_tpu_torch.player import Player
        from jsmpeg_tpu_torch.sources import TCPSource
        self.sources = [TCPSource('127.0.0.1', p,
                                  reconnect_interval=self.mix['grace_s'])
                        for p in ports]
        self.player = Player(self.sources[0],
                             {'device': self.device, 'audio': False,
                              'streaming': True}, renderer=self.sink)
        self.player.play()

    # ------------------------------------------------------------ window

    def _stamp(self, s: int, t: float, y, cr, cb) -> None:
        i = len(self.at[s])
        self.at[s].append(t)
        if i in self.keep[s]:
            self.kept[s][i] = planes_of(y, cr, cb)

    def _caught_up(self) -> bool:
        return all(len(self.at[s]) >= self.upto_w1[s]
                   for s in range(self.n))

    def _loop_until(self, t_stop: float, catch_up: bool = False) -> None:
        interval = self.mix['interval_s']
        while now() < t_stop:
            if catch_up and self._caught_up():
                break
            self.player.tick()
            time.sleep(interval)

    def _install_spans(self, spans) -> None:
        v = self.player.video
        v.parser.parse_batch = spans.wrap('parse_batch', v.parser.parse_batch)

    def measure(self) -> None:
        """The window [w0, w1] (set-up ran the warm-up up to w0), then
        the grace until every frame due in it has come."""
        from jsmpeg_tpu_torch.ops import kernels
        self.upto_w1 = [int(np.count_nonzero(d <= self.w1))
                        for d in self.due]
        if self.spans is not None:
            self._install_spans(self.spans)
        self.launch0 = sum(kernels.launches.values())
        if self.prof is not None:
            self.prof.open_window()
        self._loop_until(self.w1)
        if self.prof is not None:
            self.prof.close_window()
        self.launch1 = sum(kernels.launches.values())
        self.frames_w = sum(1 for s in range(self.n) for t in self.at[s]
                            if self.w0 <= t <= self.w1)
        self._loop_until(self.w1 + self.mix['grace_s'], catch_up=True)
        self.gen_stats, sent = self.conn.recv()
        say(f'the feed generator sent {self.gen_stats}')
        # picture i is complete with picture i + 1's first chunk: its
        # send time where it went out, else its due time
        self.sent = []
        for s in range(self.n):
            t = self.due[s].copy()
            got = np.asarray(sent[s][1:len(t) + 1], np.float64)
            t[:len(got)] = np.maximum(t[:len(got)], got)
            self.sent.append(t)
        lat = self.latencies_ms()
        say(f'latency p50 {percentile(lat, 50):.3f} p95 '
            f'{percentile(lat, 95):.3f} p99 {percentile(lat, 99):.3f} ms '
            f'over {len(lat)} frames; from the due times p50 '
            f'{percentile(self.latencies_ms(self.due), 50):.3f} p95 '
            f'{percentile(self.latencies_ms(self.due), 95):.3f} ms')
        if self.prof is not None:
            self.trace = self.prof.stop()

    def release(self) -> None:
        try:
            for s in self.sources:
                s.destroy()
            if self.conn is not None and self.proc is not None:
                if self.proc.is_alive():
                    try:
                        self.conn.send('close')
                    except (BrokenPipeError, OSError):
                        pass
                self.proc.join(30)
                if self.proc.is_alive():
                    self.proc.terminate()
                    self.proc.join(10)
        finally:
            import gc
            if self.cores is not None:
                os.sched_setaffinity(0, self.cores)
            self.player = None
            gc.collect()
            if self.device != 'cpu':
                import torch
                torch.cuda.empty_cache()

    # ---------------------------------------------------------- results

    def latencies_ms(self, since=None) -> List[float]:
        """Each frame due in the window: from the send of the chunk that
        completes it (`since`: the due times instead) to its planes on
        the host, or to the window's end where they had not come."""
        since = self.sent if since is None else since
        out = []
        for s in range(self.n):
            at = self.at[s]
            for i in self.in_window[s]:
                t = at[i] if i < len(at) and at[i] <= self.w1 else self.w1
                out.append(max(0.0, t - since[s][i]) * 1e3)
        return out

    def end_to_end(self) -> dict:
        lat = self.latencies_ms()
        return {'latency_p95_ms': percentile(lat, 95),
                'latency_p50_ms': percentile(lat, 50)}

    def layer_window(self):
        """(start, end, frames delivered) of the window."""
        return self.w0, self.w1, self.frames_w

    def n_mb(self) -> int:
        return ((self.cfg['width'] + 15) // 16) * \
            ((self.cfg['height'] + 15) // 16)

    def attempted(self) -> int:
        return int(sum(len(w) for w in self.in_window))

    def check(self) -> List[Compared]:
        """Every frame due in the window has come; the sampled frames
        equal the reference's planes of their pool GOP."""
        frames, self.work, _ = reference(self.pool, audio=False)
        ctrl = (reference(self.pool, audio=False, float_idct=True)[0]
                if self.control else None)
        gop = self.cfg['gop']
        missing = sum(max(0, int(w[-1]) + 1 - len(self.at[s]))
                      if len(w) else 0
                      for s, w in enumerate(self.in_window))
        bad_px = bad_frames = 0
        for s in range(self.n):
            for i in self.keep[s]:
                g, j = int(self.orders[s][i // gop]), i % gop
                got = self.kept[s].get(i)
                if got is None:
                    continue        # never came: counted as missing
                if ctrl is not None:
                    got = ctrl[g][j]
                d = differing_pixels(got, frames[g][j])
                bad_px += d
                bad_frames += d > 0
        self.failed = missing + bad_frames
        return [Compared('frames_missing', missing, 0),
                Compared('pixels_differing', bad_px, 0)]

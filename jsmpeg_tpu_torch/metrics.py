"""Observability: per-stage counters/timers and a device trace helper.

The reference exposes per-decode timing callbacks (onVideoDecode /
onAudioDecode) and little else; this module adds structured pipeline
counters (packets, PES units, frames, stage seconds) and wraps
`torch.profiler` for device-side inspection: the device's busy time over
a region, and a Chrome trace of it.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Optional


class StageTimer:
    """Accumulating wall-clock timers + counters keyed by stage name."""

    def __init__(self):
        self.seconds: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def time(self, stage: str, n: int = 1):
        t0 = time.monotonic()
        try:
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


class DeviceTrace:
    """What `device_trace` measured: `wall_s` of the region (fenced by
    device synchronizes), `device_s`, the sum of the device time of every
    kernel and copy the profiler saw, and `busy_share` = device_s /
    wall_s.  `profile` is the torch profiler, for its tables."""

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
    # op that launched it counts the same time again: skipped, as
    # torch's own table does)
    cpu = torch.autograd.DeviceType.CPU
    out.device_s = sum(e.device_time_total for e in prof.events()
                       if e.device_type != cpu) * 1e-6
    if path is not None:
        prof.export_chrome_trace(path)


def player_stats(player) -> dict:
    """Snapshot of pipeline counters for a Player."""
    stats = {
        'ts_packets': player.demuxer.packets_parsed,
        'ts_resyncs': player.demuxer.resyncs,
        'source_progress': round(player.source.progress, 4),
        'streaming': player.streaming,
    }
    if player.video is not None:
        seq = player.video.seq
        stats['video'] = {
            'frames_parsed': getattr(player.video.parser, 'frames_parsed', 0),
            'frames_rendered': player.renderer.frames_rendered,
            'resolution': f'{seq.width}x{seq.height}' if seq else None,
            'frame_rate': player.video.frame_rate,
            'decoded_time': round(player.video.decoded_time, 4),
            'quirk_fallbacks': getattr(player.video.parser, 'quirk_leaks', 0),
        }
    if player.audio is not None:
        stats['audio'] = {
            'sample_rate': player.audio.sample_rate,
            'samples_played': player.audio_out.samples_played,
            'decoded_time': round(player.audio.decoded_time, 4),
        }
    return stats

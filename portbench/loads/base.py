"""What every load shares: the sinks that stamp frames on the host, the
launch recorder of a traced window, and the exact comparison of sampled
frames with the plain reference."""

from __future__ import annotations

import sys
import threading
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np


class Compared(NamedTuple):
    """One number the correctness check compares, and its limit: the run
    is correct when every value is at most its limit."""
    name: str
    value: float
    limit: float


def planes_of(y, cr, cb) -> Tuple[np.ndarray, ...]:
    """Host copies of a frame's planes (tensors or arrays)."""
    return tuple(np.array(p, dtype=np.uint8, copy=True) for p in (y, cr, cb))


def differing_pixels(got, want) -> int:
    """Pixels of the three planes that differ (a plane of another shape
    counts whole)."""
    n = 0
    for g, w in zip(got, want):
        if g.shape != w.shape:
            n += max(g.size, w.size)
        else:
            n += int(np.count_nonzero(g != w))
    return n


class LaunchRecord(NamedTuple):
    kernel: str         # 'k1' (its compact form), 'k2', 'k3'
    frames: int         # frames of the launch (per stream)
    streams: int
    wire_bytes: int     # K3: the wires' bytes; else 0


class LaunchRecorder:
    """Wraps the program's kernel launch functions (`ops.kernels`) while
    a traced window runs, recording each launch's frames, streams and
    wire bytes from its arguments (host values: nothing is read from the
    device)."""

    NAMES = ('dequant_idct_compact_cuda', 'mc_combine_cuda',
             'wire_unpack_cuda')

    def __init__(self, n_mb: int):
        self.n_mb = n_mb
        self.records: List[LaunchRecord] = []
        self._saved: Dict[str, object] = {}
        self._lock = threading.Lock()

    def _add(self, rec: LaunchRecord) -> None:
        with self._lock:
            self.records.append(rec)

    def __enter__(self):
        from jsmpeg_tpu_torch.ops import kernels
        self._saved = {n: getattr(kernels, n) for n in self.NAMES}
        s = self._saved
        n_mb = self.n_mb

        def k1c(levels, blk_ids, qscale, intra, intra_q, non_intra_q,
                n_blocks, *a, **kw):
            out = s['dequant_idct_compact_cuda'](
                levels, blk_ids, qscale, intra, intra_q, non_intra_q,
                n_blocks, *a, **kw)
            self._add(LaunchRecord('k1', n_blocks // (6 * n_mb), 1, 0))
            return out

        def k2(cur, fwd, resid, meta, *a, **kw):
            out = s['mc_combine_cuda'](cur, fwd, resid, meta, *a, **kw)
            self._add(LaunchRecord('k2', int(resid.shape[0]), 1, 0))
            return out

        def k3(bufs, n_frames, *a, **kw):
            out = s['wire_unpack_cuda'](bufs, n_frames, *a, **kw)
            self._add(LaunchRecord('k3', int(n_frames), int(bufs.shape[0]),
                                   int(bufs.numel())))
            return out

        for name, fn in zip(self.NAMES, (k1c, k2, k3)):
            setattr(kernels, name, fn)
        return self

    def __exit__(self, *exc):
        from jsmpeg_tpu_torch.ops import kernels
        for n, f in self._saved.items():
            setattr(kernels, n, f)
        return False


def sample_plan(rng: np.random.Generator, n_slots: int, per_slot: int,
                slot_len: int) -> List[np.ndarray]:
    """For each of n_slots files or feeds, `per_slot` distinct frame
    positions below slot_len, drawn from `rng`."""
    k = min(per_slot, slot_len)
    return [np.sort(rng.choice(slot_len, k, replace=False))
            for _ in range(n_slots)]


def now() -> float:
    return time.monotonic()


def say(msg: str) -> None:
    """A progress or diagnostic line on standard error."""
    print(f'portbench: {msg}', file=sys.stderr, flush=True)


def percentile(values: List[float], q: float) -> Optional[float]:
    """The nearest-rank q-th percentile (q in (0, 100])."""
    if not values:
        return None
    s = sorted(values)
    k = max(0, int(np.ceil(q / 100.0 * len(s))) - 1)
    return float(s[k])

"""Faults planted under the timed path, for the tests that see a broken
run come out not correct.  Each patches the program's batch decode
(`decode_levels`, where the main path and `decode()` produce their
frames)."""

from __future__ import annotations

import contextlib

MODULE = 'jsmpeg_tpu_torch.models.mpeg1'


def _stale(real):
    """A step that returns its state unchanged: the carry handed back is
    the one it was given, and its frames are that state."""
    def step(cur, fwd, *a, **kw):
        _, _, pb = real(cur, fwd, *a, **kw)
        for out, old in zip(pb.planes, cur):
            out.copy_(old.expand_as(out))
        return cur, fwd, pb
    return step


def _half(real):
    """Half of each batch left out: the frames of its second half never
    reach the caller (a one-frame batch, as `decode()` takes, has no half
    to leave out)."""
    from jsmpeg_tpu_torch.ops.frame import Planes, PlanesBatch

    def step(*a, **kw):
        cur, fwd, pb = real(*a, **kw)
        n = len(pb)
        return cur, fwd, PlanesBatch(Planes(*[p[:n - n // 2]
                                              for p in pb.planes]))
    return step


def _alter(real):
    """An answer altered where it is produced: one luma sample of every
    frame flipped."""
    def step(*a, **kw):
        cur, fwd, pb = real(*a, **kw)
        pb.planes.y[:, 0, 0] ^= 1
        return cur, fwd, pb
    return step


FAULTS = {'stale_state': _stale, 'half_batch': _half,
          'altered_answer': _alter}


@contextlib.contextmanager
def planted(kind: str):
    import importlib
    mod = importlib.import_module(MODULE)
    saved = mod.decode_levels
    try:
        mod.decode_levels = FAULTS[kind](saved)
        yield
    finally:
        mod.decode_levels = saved

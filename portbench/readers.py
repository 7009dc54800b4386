"""The arithmetic of the per-layer metrics, shared by the readers in
`layer_metrics/`.  Each returns None where the run holds nothing to read
(no trace, no span, no launch of the kernel), never 0 for a share."""

from __future__ import annotations

from typing import Optional

from .work import bound, k1_work, k2_work_counts, k3_work

# the port's kernels by their names in the device trace (csrc/*.cu)
# (K1's dense forms, which no cell's streams take, would count as K1
# launches the recorder never saw: the roofline then reads nothing)
KERNEL_NAMES = {'k1': r'dequant_idct\w*_kernel',
                'k2': r'frame_loop_kernel',
                'k3': r'(?<!\w)(scan_kernel|write_kernel)(?!\w)'}
# device launches per recorded call (K3: scan, then write)
LAUNCHES_PER_CALL = {'k1': 1, 'k2': 1, 'k3': 2}


def span_ms_per_frame(run, name: str) -> Optional[float]:
    """The time of the spans `name` that began in the run's layer window,
    in ms per frame delivered in it."""
    if run.spans is None:
        return None
    start, end, frames = run.layer_window()
    seconds, calls = run.spans.total(name, start, end)
    if not calls or not frames:
        return None
    return seconds * 1e3 / frames


def span_mean_ms(run, name: str) -> Optional[float]:
    """The mean time of the spans `name` that began in the window."""
    if run.spans is None:
        return None
    start, end, _ = run.layer_window()
    seconds, calls = run.spans.total(name, start, end)
    return seconds * 1e3 / calls if calls else None


def idle_share(run) -> Optional[float]:
    """The share of the traced window in which no kernel, copy or memset
    ran on the device (the union of their intervals), in %."""
    tr = run.trace
    if tr is None or tr.window_s <= 0 or not tr.events:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def _launch_work(kernel: str, rec, pics, n_mb: int):
    coded = sum(p.coded_blocks for p in pics)
    nonzero = sum(p.nonzero_levels for p in pics)
    if kernel == 'k1':
        return k1_work(coded, nonzero, sum(p.coded_mbs for p in pics), True)
    if kernel == 'k2':
        return k2_work_counts(rec.frames, n_mb, coded,
                              sum(p.intra_coded_blocks for p in pics),
                              sum(p.written_mbs for p in pics))
    return k3_work(rec.wire_bytes, rec.frames * n_mb, coded, nonzero)


def roofline(run, kernel: str) -> Optional[float]:
    """The kernel's share of its roofline over the traced window: the sum
    of each launch's least time (`work.py`, from the work its frames ask
    for, counted by the reference's parse) over the kernel's device time
    in the trace, in %.  None unless the launches recorded cover exactly
    the window's frames and the trace holds each of them."""
    tr, rec = run.trace, run.launches
    work = getattr(run, 'work', None)
    if tr is None or rec is None or work is None:
        return None
    recs = [r for r in rec.records if r.kernel == kernel]
    if not recs or any(r.streams != 1 for r in recs):
        return None
    order = run.decode_order()
    n_mb = run.n_mb()
    least_ms, at = 0.0, 0
    for r in recs:
        pics = [work[g][j] for g, j in order[at:at + r.frames]]
        if len(pics) != r.frames:
            return None
        at += r.frames
        least_ms += bound(*_launch_work(kernel, r, pics, n_mb))[0]
    if at != len(order):
        return None
    dev_s, n = tr.kernel_s(KERNEL_NAMES[kernel])
    if n != len(recs) * LAUNCHES_PER_CALL[kernel] or dev_s <= 0:
        return None
    return 100.0 * least_ms / (dev_s * 1e3)


def launches_per_frame(run) -> Optional[float]:
    """Kernel launches counted by the program (`ops.kernels.launches`)
    over the window, per frame delivered in it."""
    _, _, frames = run.layer_window()
    n = run.launch1 - run.launch0
    return n / frames if frames and n > 0 else None

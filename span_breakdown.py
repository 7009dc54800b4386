#!/usr/bin/env python3
"""One traced run of a portbench cell with the port's own spans beside
the benchmark's wrappers:

    python3 span_breakdown.py --workload W --seed N --seconds S

from the root of a checkout, on a CUDA device (the arguments are
`portbench.run`'s, less `--trace`).  It runs `portbench.run` with
`--trace 1` and the port's span recorder on
(`jsmpeg_tpu_torch.metrics.enable`), each span handed to the run's
`trace.Spans` as it ends; the benchmark's own traced runs leave the
recorder off (PERF.md §7).  So the result line, printed first as
`portbench.run` prints it, names the program's spans in
`breakdown.idle_gaps`, nested under the wrappers
(`_feed>feeder.dispatch+parse_batch>parse.join`).  A last JSON line
adds:
- `span_metrics`: the SPAN_METRICS of the cell's load, read from the
  run's window as portbench's span readers read theirs (ms per frame
  of the window; `host_waits_per_frame` a count per frame);
- `partition`: for each wrapper (`parse_batch`, `_feed`,
  `audio_decode`), its seconds and the share of them that the program
  spans of its layer cover inside it, on its thread;
- `idle_gaps`: the device's idle time by what the host was doing, as
  the result line's, every entry;
- `totals`: each span name's seconds and count over the run.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import defaultdict

# metric -> the program spans whose time it sums, in ms per frame of the
# window (None: the 'device.wait' spans counted, per frame)
SPAN_METRICS = {
    'demux_ms_per_frame.offline': ('player.demux',),
    'parse_serial_ms_per_frame.offline': ('parse.scan', 'parse.compact',
                                          'parse.wire'),
    'parse_straggler_ms_per_frame.offline': ('parse.join',),
    'feeder_wait_ms_per_frame.offline': ('pipeline.wait',),
    'copy_wait_ms_per_frame.offline': ('pipeline.fetch',),
    'mp2_parse_ms_per_frame.offline': ('mp2.parse',),
    'mp2_synth_ms_per_frame.offline': ('mp2.synth',),
    'parse_serial_ms_per_frame.live': ('parse.scan', 'parse.compact',
                                       'parse.wire'),
    'dispatch_ms_per_frame.live': ('decode.stage', 'decode.dispatch'),
    'fetch_ms_per_frame.live': ('decode.fetch',),
    'host_waits_per_frame.live': None,
}
# portbench's wrappers (loads/offline.py, live.py), each with the prefix
# of the program spans that split it
WRAPPERS = {'parse_batch': 'parse.', '_feed': 'feeder.',
            'audio_decode': 'mp2.'}


def read_metric(run, name: str):
    """SPAN_METRICS[name] of a portbench run (its `spans` and
    `layer_window()`), None where it holds nothing to read."""
    from portbench.readers import span_ms_per_frame
    names = SPAN_METRICS[name]
    if names is None:
        if run.spans is None:
            return None
        start, end, frames = run.layer_window()
        _, waits = run.spans.total('device.wait', start, end)
        return waits / frames if waits and frames else None
    ms = [v for v in (span_ms_per_frame(run, n) for n in names)
          if v is not None]
    return sum(ms) if ms else None


def partition(spans) -> dict:
    """For each wrapper: its seconds, and the share of them that the
    program spans of its layer (WRAPPERS) cover inside it, on its
    thread."""
    threads = defaultdict(list)
    for s in spans:
        threads[s.thread].append(s)
    out = {}
    for wrapper, prefix in WRAPPERS.items():
        outer = inner = 0.0
        for ss in threads.values():
            ws = sorted((s for s in ss if s.name == wrapper),
                        key=lambda s: s.start)
            ps = sorted((s for s in ss if s.name.startswith(prefix)),
                        key=lambda s: s.start)
            k = 0
            for w in ws:
                outer += w.end - w.start
                while k < len(ps) and ps[k].start < w.start:
                    k += 1
                j = k
                while j < len(ps) and ps[j].start <= w.end:
                    if ps[j].end <= w.end:
                        inner += ps[j].end - ps[j].start
                    j += 1
        out[wrapper] = {'seconds': outer,
                        'share': inner / outer if outer else None}
    return out


def totals(spans) -> dict:
    t = defaultdict(lambda: [0.0, 0])
    for s in spans:
        t[s.name][0] += s.end - s.start
        t[s.name][1] += 1
    return dict(sorted(t.items()))


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    ap = argparse.ArgumentParser(prog='span_breakdown')
    ap.add_argument('--workload', required=True)
    workload = ap.parse_known_args(argv)[0].workload
    from jsmpeg_tpu_torch import metrics
    from portbench import run as bench
    from portbench import spec, trace

    class ProgramSpans(trace.Spans):
        """The run's spans, the program's recorded into them."""

        def __init__(self):
            super().__init__()
            metrics.enable(sink=self.add)

        def add(self, name, thread, start, end):
            with self._lock:
                self.spans.append(trace.Span(name, thread, start, end))

    seen = {}
    reader, spans_cls = spec.reader, trace.Spans

    def capture(metric, base=spec.HERE):
        read = reader(metric, base)

        def read_run(run):
            seen['run'] = run
            return read(run)
        return read_run

    trace.Spans, spec.reader = ProgramSpans, capture
    try:
        rc = bench.main(argv + ['--trace', '1'])
    finally:
        metrics.disable()
        trace.Spans, spec.reader = spans_cls, reader
    run = seen.get('run')
    if rc or run is None:
        return rc or 1
    load = spec.cell(workload).traffic['load']
    got = {m: read_metric(run, m) for m in SPAN_METRICS
           if m.endswith('.' + load)}
    gaps = (run.trace.gaps_by_host(run.spans.spans, 1000)
            if run.trace is not None else None)
    print(json.dumps({'span_metrics': got,
                      'partition': partition(run.spans.spans),
                      'idle_gaps': gaps,
                      'totals': totals(run.spans.spans)}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())

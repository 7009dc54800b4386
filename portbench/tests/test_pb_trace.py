"""The per-layer arithmetic on a recorded trace: the union of device
intervals, idle gaps labelled by host spans, kernel time by name, the
rooflines from launch records and the reference's work counts."""

import pytest

from portbench.loads.base import LaunchRecord, percentile
from portbench.readers import (idle_share, roofline, span_mean_ms,
                               span_ms_per_frame)
from portbench.reference.mpeg1 import PictureWork
from portbench.trace import (DeviceEvent, DeviceTrace, Span, Spans,
                             idle_gaps, union_length)
from portbench.work import bound, k1_work, k2_work_counts, k3_work


def test_union_counts_overlap_once():
    iv = [(0.0, 2.0), (1.0, 3.0), (5.0, 6.0), (5.5, 5.7)]
    assert union_length(iv, 0.0, 10.0) == pytest.approx(4.0)
    assert union_length(iv, 1.5, 5.5) == pytest.approx(2.0)
    assert union_length([], 0.0, 1.0) == 0.0
    assert idle_gaps(iv, 0.0, 10.0) == [(3.0, 5.0), (6.0, 10.0)]
    assert idle_gaps(iv, -1.0, 2.5) == [(-1.0, 0.0)]


def _trace():
    ev = [DeviceEvent('void (anonymous namespace)::'
                      'dequant_idct_compact_kernel<64>(short const*)',
                      1.0, 1.1),
          DeviceEvent('frame_loop_kernel(Params)', 1.05, 1.3),
          DeviceEvent('scan_kernel(Wire, Scratch, Out)', 0.9, 0.95),
          DeviceEvent('write_kernel(Wire, Scratch, Out)', 0.95, 1.0),
          DeviceEvent('Memcpy HtoD (Pinned -> Device)', 0.8, 0.85),
          DeviceEvent('cub::DeviceScanKernel<int>(int*)', 1.5, 1.6)]
    return DeviceTrace(ev, 0.5, 2.5)


def test_device_trace_reductions():
    tr = _trace()
    # [0.8, 0.85] + [0.9, 1.3] + [1.5, 1.6]
    assert tr.busy_s == pytest.approx(0.55)
    assert tr.kernel_s(r'frame_loop_kernel') == (pytest.approx(0.25), 1)
    s, n = tr.kernel_s(r'(?<!\w)(scan_kernel|write_kernel)(?!\w)')
    assert n == 2 and s == pytest.approx(0.1)
    assert tr.top_ops(2)[0] == ['frame_loop_kernel', pytest.approx(0.25)]
    # gaps [0.5, 0.8], [0.85, 0.9], [1.3, 1.5], [1.6, 2.5]
    spans = [Span('parse_batch', 'main', 0.4, 0.8),
             Span('_feed', 'feeder', 1.3, 1.45),
             Span('round', 'main', 1.5, 2.5),
             Span('parse_batch', 'main', 1.6, 2.4)]
    gaps = dict((k, v) for k, v in tr.gaps_by_host(spans))
    # each gap whole, under what was open at its middle
    assert gaps == {'parse_batch': pytest.approx(0.3),
                    'no span': pytest.approx(0.05),
                    '_feed': pytest.approx(0.2),
                    'round>parse_batch': pytest.approx(0.9)}


class _Run:
    def __init__(self):
        self.trace = _trace()
        self.spans = Spans()
        self.spans.spans += [Span('parse_batch', 'main', 0.6, 0.7),
                             Span('parse_batch', 'main', 3.0, 3.1)]
        self.work = [[PictureWork(600, 900, 100, 600, 0),
                      PictureWork(50, 80, 10, 0, 90)]]
        self.launches = type('R', (), {})()
        self.launches.records = [
            LaunchRecord('k1', 2, 1, 0),
            LaunchRecord('k2', 2, 1, 0),
            LaunchRecord('k3', 2, 1, 4000)]

    def layer_window(self):
        return 0.5, 2.5, 2

    def decode_order(self):
        return [(0, 0), (0, 1)]

    def n_mb(self):
        return 100


def test_rooflines_from_launches_and_work():
    run = _Run()
    k1 = bound(*k1_work(650, 980, 110, True))[0]
    k2 = bound(*k2_work_counts(2, 100, 650, 600, 90))[0]
    k3 = bound(*k3_work(4000, 200, 650, 980))[0]
    assert roofline(run, 'k1') == pytest.approx(100 * k1 / 100.0)
    assert roofline(run, 'k2') == pytest.approx(100 * k2 / 250.0)
    assert roofline(run, 'k3') == pytest.approx(100 * k3 / 100.0)
    # launches that do not cover the window's frames read nothing
    run.launches.records.append(LaunchRecord('k1', 1, 1, 0))
    assert roofline(run, 'k1') is None
    run.trace = None
    assert roofline(run, 'k2') is None and idle_share(run) is None


def test_spans_and_shares():
    run = _Run()
    assert span_ms_per_frame(run, 'parse_batch') == pytest.approx(50.0)
    assert span_mean_ms(run, 'parse_batch') == pytest.approx(100.0)
    assert span_ms_per_frame(run, '_feed') is None
    assert idle_share(run) == pytest.approx(100 * (1 - 0.55 / 2.0))


def test_spans_wrap_records_calls():
    s = Spans()
    f = s.wrap('f', lambda x: x + 1)
    assert f(1) == 2
    assert [x.name for x in s.spans] == ['f']


def test_percentile_nearest_rank():
    v = list(range(1, 101))
    assert percentile(v, 95) == 95 and percentile(v, 50) == 50
    assert percentile([], 50) is None

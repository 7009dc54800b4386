"""The batch pipeline's feeder (`MPEG1Decoder._feed`: the wire built into
pinned memory, its upload and the kernels' dispatch; a span on the
feeder thread) in ms per frame decoded in the traced window."""

from portbench.readers import span_ms_per_frame


def read(run):
    return span_ms_per_frame(run, '_feed')

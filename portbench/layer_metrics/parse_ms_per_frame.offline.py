"""The host parse (the parser's `parse_batch`, a span on the calling
thread) in ms per frame decoded in the traced window."""

from portbench.readers import span_ms_per_frame


def read(run):
    return span_ms_per_frame(run, 'parse_batch')

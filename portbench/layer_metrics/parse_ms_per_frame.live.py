"""The host parse (every `parse_batch` call, a span) in ms per frame
delivered in the window."""

from portbench.readers import span_ms_per_frame


def read(run):
    return span_ms_per_frame(run, 'parse_batch')

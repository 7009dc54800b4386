"""The MP2 decode (`MP2Decoder.decode_available`: the parse and the
exact synthesis on the host, after the video; a span on the calling
thread) in ms per video frame decoded in the traced window."""

from portbench.readers import span_ms_per_frame


def read(run):
    return span_ms_per_frame(run, 'audio_decode')

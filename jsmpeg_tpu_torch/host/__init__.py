"""Host frontend: the serial/branchy half of the decoder (bitstream walk,
TS demux, VLC parse) that feeds dense tensors to the device pipelines.

`best_parser()` returns the fastest available MPEG1 parser implementation:
the C++ native frontend when built, the Python reference build otherwise.
"""

from __future__ import annotations


def best_parser():
    try:
        from .native import NativeMPEG1Parser, native_available
        if native_available():
            return NativeMPEG1Parser()
    except ImportError:
        pass
    from .mpeg1_parse import MPEG1Parser
    return MPEG1Parser()

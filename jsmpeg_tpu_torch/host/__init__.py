"""Host frontend: the serial/branchy half of the decoder (bitstream walk,
TS demux, VLC parse) that feeds dense tensors to the device pipelines.

`best_parser()` and `best_mp2_parser()` return the fastest available MPEG1
and MP2 parser implementation: the C++ native frontend when built, the
Python reference build otherwise.
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


def best_mp2_parser():
    try:
        from .native import NativeMP2Parser, native_available
        if native_available():
            return NativeMP2Parser()
    except ImportError:
        pass
    from .mp2_parse import MP2Parser
    return MP2Parser()

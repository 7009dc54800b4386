"""Bit-granular reader over a byte buffer (host substrate).

Semantics match the reference BitBuffer (jsmpeg/src/buffer.js):
MSB-first reads, byte-aligned start-code scans, reads past the end of the
buffer yield zero bits.  Two write modes exist there (EXPAND for static
files, EVICT for streaming); this class covers the read side plus an
append/evict API used by the streaming demuxer.  The C++ frontend
(jsmpeg_tpu_torch/host/native) implements the same contract.
"""

from __future__ import annotations

import numpy as np


class BitReader:
    __slots__ = ('bytes', 'byte_length', 'index', '_capacity')

    def __init__(self, data=None, capacity: int = 1 << 20):
        if data is not None:
            b = np.frombuffer(bytes(data), dtype=np.uint8) if not isinstance(
                data, np.ndarray) else data.astype(np.uint8, copy=False)
            # keep an owned, padded copy so peeks past the end read zeros
            self.bytes = np.zeros(len(b) + 8, dtype=np.uint8)
            self.bytes[:len(b)] = b
            self.byte_length = len(b)
        else:
            self.bytes = np.zeros(capacity + 8, dtype=np.uint8)
            self.byte_length = 0
        self.index = 0  # bit index

    # -- writing ------------------------------------------------------------

    def append(self, data) -> int:
        b = np.frombuffer(bytes(data), dtype=np.uint8) if not isinstance(
            data, np.ndarray) else data
        need = self.byte_length + len(b) + 8
        if need > len(self.bytes):
            new = np.zeros(max(need, len(self.bytes) * 2), dtype=np.uint8)
            new[:self.byte_length] = self.bytes[:self.byte_length]
            self.bytes = new
        self.bytes[self.byte_length:self.byte_length + len(b)] = b
        self.byte_length += len(b)
        return len(b)

    def evict_consumed(self) -> int:
        """Drop fully-consumed bytes (streaming mode memory bound).

        Returns the number of bytes evicted so callers can fix up any
        byte-offset bookkeeping.
        """
        # the index may sit a few bits PAST byte_length (value reads run
        # into the zero pad, e.g. a header split across writes); clamp
        # the evict point to the valid bytes (C++ twin: bitview.h evict)
        pos = min(self.index >> 3, self.byte_length)
        if pos <= 0:
            return 0
        self.bytes[:self.byte_length - pos] = self.bytes[pos:self.byte_length]
        self.bytes[self.byte_length - pos:self.byte_length] = 0
        self.byte_length -= pos
        self.index -= pos << 3
        return pos

    # -- reading ------------------------------------------------------------

    def has(self, count: int) -> bool:
        return (self.byte_length << 3) - self.index >= count

    def peek(self, count: int) -> int:
        # read `count` bits MSB-first starting at bit `index`; bits past the
        # end of the buffer are zero (buffer is zero padded).
        start = self.index >> 3
        nbytes = (self.index + count + 7 >> 3) - start
        word = int.from_bytes(self.bytes[start:start + nbytes].tobytes(), 'big')
        shift = (nbytes << 3) - (self.index - (start << 3)) - count
        return (word >> shift) & ((1 << count) - 1)

    def read(self, count: int) -> int:
        v = self.peek(count)
        self.index += count
        return v

    def skip(self, count: int) -> None:
        self.index += count

    def rewind(self, count: int) -> None:
        self.index = max(self.index - count, 0)

    # -- start codes ----------------------------------------------------------

    def find_next_start_code(self) -> int:
        """Scan for 00 00 01 xx from the next byte boundary; position after
        it and return xx, or -1 (positioned at end)."""
        i = self.index + 7 >> 3
        b = self.bytes
        n = self.byte_length
        # vectorized scan
        if n - i >= 4:
            window = b[i:n]
            cand = np.flatnonzero(
                (window[:-3] == 0) & (window[1:-2] == 0) & (window[2:-1] == 1))
            if cand.size:
                j = i + int(cand[0])
                self.index = (j + 4) << 3
                return int(b[j + 3])
        else:
            # tail: mirror the reference's byte loop (reads past end see 0)
            while i < n:
                if b[i] == 0 and b[i + 1] == 0 and b[i + 2] == 1:
                    self.index = (i + 4) << 3
                    return int(b[i + 3])
                i += 1
        self.index = n << 3
        return -1

    def find_start_code(self, code: int) -> int:
        while True:
            current = self.find_next_start_code()
            if current == code or current == -1:
                return current

    def next_bytes_are_start_code(self) -> bool:
        i = self.index + 7 >> 3
        return (i >= self.byte_length or
                (self.bytes[i] == 0 and self.bytes[i + 1] == 0
                 and self.bytes[i + 2] == 1))

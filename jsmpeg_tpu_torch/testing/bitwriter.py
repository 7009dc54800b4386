"""MSB-first bit writer used by the test-fixture encoders."""

from __future__ import annotations


class BitWriter:
    def __init__(self):
        self._bits = 0
        self._nbits = 0
        self._out = bytearray()

    def write(self, value: int, nbits: int) -> None:
        assert nbits >= 0 and 0 <= value < (1 << nbits) if nbits else value == 0
        self._bits = (self._bits << nbits) | value
        self._nbits += nbits
        while self._nbits >= 8:
            self._nbits -= 8
            self._out.append((self._bits >> self._nbits) & 0xFF)
        self._bits &= (1 << self._nbits) - 1

    def write_bits(self, bitstring: str) -> None:
        for ch in bitstring:
            self.write(1 if ch == '1' else 0, 1)

    def align(self, fill: int = 0) -> None:
        if self._nbits:
            self.write(fill & ((1 << (8 - self._nbits)) - 1), 8 - self._nbits)

    def write_bytes(self, data: bytes) -> None:
        assert self._nbits == 0, 'byte writes must be aligned'
        self._out.extend(data)

    def start_code(self, code: int) -> None:
        self.align()
        self.write_bytes(bytes([0, 0, 1, code]))

    @property
    def nbytes(self) -> int:
        return len(self._out) + (1 if self._nbits else 0)

    def getvalue(self) -> bytes:
        out = bytes(self._out)
        if self._nbits:
            out += bytes([(self._bits << (8 - self._nbits)) & 0xFF])
        return out

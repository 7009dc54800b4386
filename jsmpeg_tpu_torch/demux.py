"""MPEG-TS demuxer.

Semantics match the reference demuxer (jsmpeg/src/ts.js): 188-byte
packets, resync needing 5 aligned sync bytes, PID -> stream-id learning from
PES start codes, 33-bit PTS (marker-bit interleaved) in seconds, PES
reassembly with two completion signals -- declared packet length (audio) and
the padded-TS-packet heuristic for unbounded video PES.  Chunked writes keep
leftover partial packets between calls.

Destinations receive write(pts_seconds, [byte_chunks]).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from . import tables as T


class _PesInfo:
    __slots__ = ('destination', 'current_length', 'total_length', 'pts',
                 'buffers')

    def __init__(self, destination):
        self.destination = destination
        self.current_length = 0
        self.total_length = 0
        self.pts = 0.0
        self.buffers = []


class TSDemuxer:
    """TS demuxer with a C++ fast path (host/native/ts_demux.cpp, same
    semantics, kept twin-identical by tests/test_native_ts.py) and this
    module's pure-Python implementation as the always-available fallback
    (options: native=False forces Python, native=True requires C++)."""

    def __init__(self, options: Optional[dict] = None):
        options = options or {}
        self.guess_video_frame_end = options.get('guessVideoFrameEnd', True)
        self.pids_to_stream_ids: Dict[int, int] = {}
        self.pes: Dict[int, _PesInfo] = {}
        self.leftover = b''
        self._start_time = 0.0
        self._current_time = 0.0
        self._packets_parsed = 0
        self._resyncs = 0
        self._native = None
        use_native = options.get('native')
        if use_native is None or use_native:
            try:
                from .host.native import NativeTSDemux, native_available
                if native_available():
                    self._native = NativeTSDemux(self.guess_video_frame_end)
            except Exception:
                self._native = None
            if use_native and self._native is None:
                raise RuntimeError('native TS demuxer unavailable')

    @property
    def start_time(self) -> float:
        return (self._native.start_time if self._native is not None
                else self._start_time)

    @property
    def current_time(self) -> float:
        return (self._native.current_time if self._native is not None
                else self._current_time)

    @property
    def packets_parsed(self) -> int:
        return (self._native.packets_parsed if self._native is not None
                else self._packets_parsed)

    @property
    def resyncs(self) -> int:
        return (self._native.resyncs if self._native is not None
                else self._resyncs)

    def connect(self, stream_id: int, destination) -> None:
        self.pes[stream_id] = _PesInfo(destination)
        if self._native is not None:
            self._native.connect(stream_id)

    def _dispatch(self, events) -> None:
        for stream_id, pts, payload in events:
            pi = self.pes.get(stream_id)
            if pi is not None:
                pi.destination.write(pts, [payload])

    def write(self, chunk) -> None:
        if self._native is not None:
            self._dispatch(self._native.write(bytes(chunk)))
            return
        data = self.leftover + bytes(chunk)
        pos = 0
        n = len(data)
        while n - pos >= T.TS_PACKET_SIZE:
            newpos = self._parse_packet(data, pos)
            if newpos is None:
                break
            pos = newpos
        self.leftover = data[pos:]

    def flush(self) -> None:
        """Deliver any pending reassembled PES payloads (end of stream)."""
        if self._native is not None:
            self._dispatch(self._native.flush())
            return
        for pi in self.pes.values():
            if pi.current_length:
                self._complete(pi)

    # ------------------------------------------------------------------

    def _parse_packet(self, data: bytes, pos: int) -> Optional[int]:
        if data[pos] != 0x47:
            skip = self._resync(data, pos)
            if skip is None:
                return None
            pos = skip
        end = pos + T.TS_PACKET_SIZE
        self._packets_parsed += 1

        b1 = data[pos + 1]
        payload_start = bool(b1 & 0x40)
        pid = ((b1 & 0x1F) << 8) | data[pos + 2]
        b3 = data[pos + 3]
        adaptation = (b3 >> 4) & 0x3
        p = pos + 4

        stream_id = self.pids_to_stream_ids.get(pid)
        if payload_start and stream_id is not None:
            pi = self.pes.get(stream_id)
            if pi is not None and pi.current_length:
                self._complete(pi)

        if adaptation & 0x1:
            if adaptation & 0x2:
                af_len = data[p]
                p += 1 + af_len
                if p >= end:
                    return end
            if (payload_start and p + 3 < end and data[p] == 0
                    and data[p + 1] == 0 and data[p + 2] == 1
                    and p + 9 <= len(data)):
                stream_id = data[p + 3]
                self.pids_to_stream_ids[pid] = stream_id
                packet_length = (data[p + 4] << 8) | data[p + 5]
                # flags byte at p+6, pts/dts flags at p+7, header len at p+8
                pts_dts = (data[p + 7] >> 6) & 0x3
                header_length = data[p + 8]
                payload_begin = p + 9 + header_length
                pi = self.pes.get(stream_id)
                if pi is not None:
                    pts = 0.0
                    if pts_dts & 0x2 and p + 14 <= len(data):
                        q = p + 9
                        p32_30 = (data[q] >> 1) & 0x7
                        p29_15 = (data[q + 1] << 7) | (data[q + 2] >> 1)
                        p14_0 = (data[q + 3] << 7) | (data[q + 4] >> 1)
                        pts = (p32_30 * 1073741824 + p29_15 * 32768
                               + p14_0) / 90000.0
                        self._current_time = pts
                        if self._start_time == -1:
                            self._start_time = pts
                    payload_length = (packet_length - header_length - 3
                                      if packet_length else 0)
                    pi.total_length = payload_length
                    pi.current_length = 0
                    pi.pts = pts
                p = payload_begin

            if stream_id is not None:
                pi = self.pes.get(stream_id)
                if pi is not None and p < end:
                    pi.buffers.append(data[p:end])
                    pi.current_length += end - p
                    complete = (pi.total_length != 0
                                and pi.current_length >= pi.total_length)
                    has_padding = (not payload_start) and (adaptation & 0x2)
                    if complete or (self.guess_video_frame_end and has_padding):
                        self._complete(pi)
        return end

    def _resync(self, data: bytes, pos: int) -> Optional[int]:
        # need 5 aligned sync bytes within 6 packets of lookahead
        if len(data) - pos < 188 * 6:
            return None
        for i in range(187):
            if data[pos + i] == 0x47:
                if all(data[pos + i + 188 * j] == 0x47 for j in range(1, 5)):
                    self._resyncs += 1
                    return pos + i
        # garbage: skip ahead
        self._resyncs += 1
        return None if len(data) - (pos + 187) < 188 else pos + 187

    def _complete(self, pi: _PesInfo) -> None:
        pi.destination.write(pi.pts, pi.buffers)
        pi.total_length = 0
        pi.current_length = 0
        pi.buffers = []


def demux_to_es(data: bytes, stream_type: int = 0xE0) -> bytes:
    """Extract one PID's elementary stream from MPEG-TS bytes; raw
    elementary streams (no TS packets) pass through unchanged.  The
    shared helper behind the CLI multi-input and tools (thumbs)."""
    es = bytearray()

    class _Collect:
        def write(self, pts, payload):
            bufs = ([payload] if isinstance(
                payload, (bytes, bytearray, memoryview)) else payload)
            for p in bufs:
                es.extend(p)

    dem = TSDemuxer()
    dem.connect(stream_type, _Collect())
    dem.write(data)
    dem.flush()
    return bytes(es) if es else data

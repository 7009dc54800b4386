"""Data sources.

Source contract (mirrors jsmpeg/src/jsmpeg.js:24-33):
  connect(destination), start(), resume(headroom_seconds), destroy(),
  established, completed, progress, streaming.

Implementations:
  BytesSource            in-memory buffer (reference: Ajax whole-file)
  FileSource             whole-file read
  ProgressiveFileSource  chunked reads with headroom throttling
                         (reference: AjaxProgressive + Range requests)
  PushSource             external writes, e.g. a network callback
                         (reference: WebSocket onmessage push)
  TCPSource              live stream over a TCP socket (relay sidecar)
"""

from __future__ import annotations

import os
import socket
import threading
import time
from typing import Optional


class BaseSource:
    streaming = False

    def __init__(self):
        self.destination = None
        self.established = False
        self.completed = False
        self.progress = 0.0

    def connect(self, destination) -> None:
        self.destination = destination

    def start(self) -> None:
        raise NotImplementedError

    def resume(self, seconds_headroom: float) -> None:
        pass

    def destroy(self) -> None:
        pass


class BytesSource(BaseSource):
    def __init__(self, data: bytes):
        super().__init__()
        self.data = bytes(data)

    def start(self) -> None:
        self.established = True
        self.completed = True
        self.progress = 1.0
        if self.destination is not None:
            self.destination.write(self.data)


class FileSource(BytesSource):
    def __init__(self, path: str):
        with open(path, 'rb') as f:
            data = f.read()
        super().__init__(data)


class ProgressiveFileSource(BaseSource):
    """Chunked loading with the reference's throttle policy: the next chunk
    loads when the player reports low headroom (resume())."""

    def __init__(self, path: str, chunk_size: int = 1024 * 1024,
                 throttled: bool = True):
        super().__init__()
        self.path = path
        self.chunk_size = chunk_size
        self.throttled = throttled
        self.file_size = os.path.getsize(path)
        self.loaded_size = 0
        self._fh = None
        self._load_time = 0.0

    def start(self) -> None:
        self._fh = open(self.path, 'rb')
        self.load_next_chunk()

    def destroy(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None

    def resume(self, seconds_headroom: float) -> None:
        # adaptive throttle (reference src/ajax-progressive.js:47-58): load
        # the next chunk while the worst-case estimated load time -- 8x the
        # last measured chunk load + 2 s -- exceeds the decode headroom.  A
        # slow medium therefore prefetches earlier; a fast one avoids
        # loading far ahead of playback.
        if self.throttled and seconds_headroom <= self._load_time * 8 + 2.0:
            self.load_next_chunk()

    def load_next_chunk(self) -> None:
        if self._fh is None or self.completed:
            return
        t0 = time.monotonic()
        chunk = self._fh.read(self.chunk_size)
        self._load_time = time.monotonic() - t0
        self.loaded_size += len(chunk)
        self.established = True
        self.progress = self.loaded_size / max(self.file_size, 1)
        if self.loaded_size >= self.file_size:
            self.completed = True
            self.progress = 1.0
        if chunk and self.destination is not None:
            self.destination.write(chunk)

    def load_all(self) -> None:
        while not self.completed:
            self.load_next_chunk()


class HTTPSource(BaseSource):
    """Plays a .ts over HTTP.  Whole-file or progressive Range requests
    (the Ajax / AjaxProgressive roles, reference src/ajax*.js), with the
    same headroom throttle and 3-retries-per-chunk policy."""

    def __init__(self, url: str, chunk_size: int = 1024 * 1024,
                 progressive: bool = True, throttled: bool = True):
        super().__init__()
        self.url = url
        self.chunk_size = chunk_size
        self.progressive = progressive
        self.throttled = throttled
        self.file_size = 0
        self.loaded_size = 0
        self._load_time = 0.0

    def start(self) -> None:
        import urllib.request
        if self.progressive:
            req = urllib.request.Request(self.url, method='HEAD')
            try:
                with urllib.request.urlopen(req) as r:
                    self.file_size = int(
                        r.headers.get('Content-Length', 0) or 0)
            except OSError:
                self.file_size = 0
            if self.file_size:
                self.load_next_chunk()
                return
            # no usable Content-Length: fall through to a whole-body GET
            # (bounded bodies only; endless ones need streaming=True ->
            # HTTPStreamSource)
        with urllib.request.urlopen(self.url) as r:
            data = r.read()
        self.established = True
        self.completed = True
        self.progress = 1.0
        if self.destination is not None:
            self.destination.write(data)

    def resume(self, seconds_headroom: float) -> None:
        # adaptive: worst-case load estimate = 8x last measured + 2 s
        # (reference src/ajax-progressive.js:52-56)
        if self.throttled and seconds_headroom <= self._load_time * 8 + 2.0:
            self.load_next_chunk()

    def load_next_chunk(self) -> None:
        if self.completed:
            return
        import urllib.request
        start = self.loaded_size
        end = min(start + self.chunk_size, self.file_size) - 1
        req = urllib.request.Request(
            self.url, headers={'Range': f'bytes={start}-{end}'})
        t0 = time.monotonic()
        for attempt in range(3):
            try:
                with urllib.request.urlopen(req) as r:
                    chunk = r.read()
                break
            except OSError:
                if attempt == 2:
                    raise
        self._load_time = time.monotonic() - t0
        self.loaded_size += len(chunk)
        self.established = True
        self.progress = self.loaded_size / max(self.file_size, 1)
        if self.loaded_size >= self.file_size or not chunk:
            self.completed = True
            self.progress = 1.0
        if chunk and self.destination is not None:
            self.destination.write(chunk)

    def load_all(self) -> None:
        while not self.completed:
            self.load_next_chunk()


class HTTPStreamSource(BaseSource):
    """Reads a chunked/endless HTTP body incrementally and feeds the
    demuxer as data arrives -- no Content-Length required (the reference
    Fetch source's ReadableStream pump, src/fetch.js:22-62).  Plays the
    relay's live HTTP output and any other progressive-download or
    chunked-transfer URL.  Reconnects like the WebSocket source."""
    streaming = True

    def __init__(self, url: str, reconnect_interval: float = 5.0):
        super().__init__()
        self.url = url
        self.reconnect_interval = reconnect_interval
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._pending: list = []
        self._resp = None

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def destroy(self) -> None:
        self._stop.set()
        resp = self._resp
        if resp is not None:
            try:
                resp.close()
            except Exception:
                pass

    def _run(self) -> None:
        import urllib.request
        while not self._stop.is_set():
            clean_eof = False
            try:
                resp = urllib.request.urlopen(self.url, timeout=10.0)
                self._resp = resp
                # read1 returns as soon as bytes arrive (one chunk), not
                # when the full count fills -- the latency-relevant call
                read = getattr(resp, 'read1', None) or resp.read
                while not self._stop.is_set():
                    chunk = read(65536)
                    if not chunk:
                        clean_eof = True
                        break
                    self.established = True
                    with self._lock:
                        self._pending.append(chunk)
            except Exception:
                # aborted chunked bodies raise http.client exceptions
                # (IncompleteRead etc.), not just OSError; any failure
                # here means "reconnect", never "kill the reader thread"
                pass
            finally:
                self._resp = None
            if clean_eof:
                # server ended the stream cleanly: complete, don't replay
                # the body from byte 0 (the reference Fetch source also
                # finishes when the ReadableStream ends, src/fetch.js:40-46)
                self.completed = True
                return
            if self._stop.is_set():
                return
            self._stop.wait(self.reconnect_interval)

    def drain(self) -> None:
        """Deliver buffered chunks on the caller's thread (the player
        tick pulls here so decoding stays single-owner)."""
        with self._lock:
            pending, self._pending = self._pending, []
        for chunk in pending:
            if self.destination is not None:
                self.destination.write(chunk)


class PushSource(BaseSource):
    """External pushes (network callback, test harness, relay client)."""
    streaming = True

    def start(self) -> None:
        pass

    def write(self, chunk: bytes) -> None:
        self.established = True
        if self.destination is not None:
            self.destination.write(chunk)

    def complete(self) -> None:
        self.completed = True


class TCPSource(BaseSource):
    """Connects to a host:port emitting raw MPEG-TS (e.g. the bundled
    relay, tools/relay.py) and pushes chunks from a reader thread."""
    streaming = True

    def __init__(self, host: str, port: int,
                 reconnect_interval: float = 5.0):
        super().__init__()
        self.host = host
        self.port = port
        self.reconnect_interval = reconnect_interval
        self._sock: Optional[socket.socket] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._pending = []

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def destroy(self) -> None:
        self._stop.set()
        if self._sock:
            try:
                self._sock.close()
            except OSError:
                pass

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self._sock = socket.create_connection(
                    (self.host, self.port), timeout=5.0)
                self._sock.settimeout(1.0)
                while not self._stop.is_set():
                    try:
                        chunk = self._sock.recv(65536)
                    except socket.timeout:
                        continue
                    if not chunk:
                        break
                    self.established = True
                    with self._lock:
                        self._pending.append(chunk)
            except OSError:
                pass
            if self._stop.is_set():
                return
            self._stop.wait(self.reconnect_interval)

    def drain(self) -> None:
        """Deliver buffered chunks on the caller's thread (the player tick
        pulls here so decoding stays single-owner)."""
        with self._lock:
            pending, self._pending = self._pending, []
        for chunk in pending:
            if self.destination is not None:
                self.destination.write(chunk)

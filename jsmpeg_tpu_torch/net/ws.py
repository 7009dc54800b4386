"""Minimal RFC 6455 WebSocket client + server framing (stdlib only;
the environment has no websocket package).

Covers what the streaming path needs: client handshake, binary frames,
ping/pong, close; no extensions, no fragmentation reassembly beyond
continuation concat.  The WebSocketSource mirrors the reference's
WSSource (jsmpeg/src/websocket.js): binary messages push
demuxer writes, auto-reconnect with an interval.
"""

from __future__ import annotations

import base64
import hashlib
import os
import socket
import struct
import threading
from typing import Optional
from urllib.parse import urlparse

_WS_MAGIC = '258EAFA5-E914-47DA-95CA-C5AB0DC85B11'


def _accept_key(key: str) -> str:
    digest = hashlib.sha1((key + _WS_MAGIC).encode()).digest()
    return base64.b64encode(digest).decode()


def encode_frame(payload: bytes, opcode: int = 0x2, mask: bool = False) -> bytes:
    """Build one (unfragmented) frame."""
    out = bytearray([0x80 | opcode])
    n = len(payload)
    mask_bit = 0x80 if mask else 0
    if n < 126:
        out.append(mask_bit | n)
    elif n < 0x10000:
        out.append(mask_bit | 126)
        out += struct.pack('>H', n)
    else:
        out.append(mask_bit | 127)
        out += struct.pack('>Q', n)
    if mask:
        key = os.urandom(4)
        out += key
        out += bytes(b ^ key[i % 4] for i, b in enumerate(payload))
    else:
        out += payload
    return bytes(out)


class FrameReader:
    """Incremental frame decoder over received bytes."""

    def __init__(self):
        self.buf = bytearray()

    def feed(self, data: bytes):
        """Yield (opcode, payload) for each complete frame."""
        self.buf += data
        while True:
            frame = self._try_parse()
            if frame is None:
                return
            yield frame

    def _try_parse(self):
        buf = self.buf
        if len(buf) < 2:
            return None
        b0, b1 = buf[0], buf[1]
        opcode = b0 & 0x0F
        masked = bool(b1 & 0x80)
        n = b1 & 0x7F
        pos = 2
        if n == 126:
            if len(buf) < 4:
                return None
            n = struct.unpack('>H', buf[2:4])[0]
            pos = 4
        elif n == 127:
            if len(buf) < 10:
                return None
            n = struct.unpack('>Q', buf[2:10])[0]
            pos = 10
        key = None
        if masked:
            if len(buf) < pos + 4:
                return None
            key = buf[pos:pos + 4]
            pos += 4
        if len(buf) < pos + n:
            return None
        payload = bytes(buf[pos:pos + n])
        if key:
            payload = bytes(b ^ key[i % 4] for i, b in enumerate(payload))
        del buf[:pos + n]
        return opcode, payload


def client_handshake(sock: socket.socket, host: str, path: str) -> None:
    key = base64.b64encode(os.urandom(16)).decode()
    req = (f'GET {path} HTTP/1.1\r\n'
           f'Host: {host}\r\n'
           'Upgrade: websocket\r\n'
           'Connection: Upgrade\r\n'
           f'Sec-WebSocket-Key: {key}\r\n'
           'Sec-WebSocket-Version: 13\r\n\r\n')
    sock.sendall(req.encode())
    resp = b''
    while b'\r\n\r\n' not in resp:
        chunk = sock.recv(4096)
        if not chunk:
            raise ConnectionError('websocket handshake failed (closed)')
        resp += chunk
    head, _, rest = resp.partition(b'\r\n\r\n')
    if b'101' not in head.split(b'\r\n')[0]:
        raise ConnectionError(f'websocket handshake rejected: {head[:80]!r}')
    expected = _accept_key(key).encode()
    if expected not in head:
        raise ConnectionError('websocket accept key mismatch')
    return rest   # bytes already received past the handshake


def server_handshake(request_head: bytes) -> Optional[bytes]:
    """Given an HTTP request head, return the 101 response bytes (or None
    if it is not a websocket upgrade)."""
    lines = request_head.decode('latin1').split('\r\n')
    headers = {}
    for line in lines[1:]:
        k, _, v = line.partition(':')
        headers[k.strip().lower()] = v.strip()
    if headers.get('upgrade', '').lower() != 'websocket':
        return None
    key = headers.get('sec-websocket-key', '')
    return ('HTTP/1.1 101 Switching Protocols\r\n'
            'Upgrade: websocket\r\n'
            'Connection: Upgrade\r\n'
            f'Sec-WebSocket-Accept: {_accept_key(key)}\r\n\r\n').encode()


class WebSocketSource:
    """Streaming source: connects to ws://host:port/path, pushes binary
    messages downstream; reconnects every `reconnect_interval` seconds."""

    streaming = True

    def __init__(self, url: str, reconnect_interval: float = 5.0):
        self.url = url
        self.reconnect_interval = reconnect_interval
        self.destination = None
        self.established = False
        self.completed = False
        self.progress = 0.0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self._pending = []
        self.on_established = None

    def connect(self, destination) -> None:
        self.destination = destination

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def resume(self, headroom: float) -> None:
        pass

    def destroy(self) -> None:
        self._stop.set()

    def _run(self) -> None:
        u = urlparse(self.url)
        port = u.port or (443 if u.scheme == 'wss' else 80)
        path = u.path or '/'
        while not self._stop.is_set():
            try:
                sock = socket.create_connection((u.hostname, port), timeout=5)
                sock.settimeout(1.0)
                leftover = client_handshake(sock, f'{u.hostname}:{port}', path)
                reader = FrameReader()
                if leftover:
                    self._handle(sock, reader, leftover)
                while not self._stop.is_set():
                    try:
                        data = sock.recv(65536)
                    except socket.timeout:
                        continue
                    if not data:
                        break
                    self._handle(sock, reader, data)
                sock.close()
            except OSError:
                pass
            if self._stop.is_set():
                return
            self._stop.wait(self.reconnect_interval)

    def _handle(self, sock, reader: FrameReader, data: bytes) -> None:
        for opcode, payload in reader.feed(data):
            if opcode in (0x1, 0x2, 0x0):       # text/binary/continuation
                if not self.established:
                    self.established = True
                    if self.on_established:
                        self.on_established(self)
                with self._lock:
                    self._pending.append(payload)
            elif opcode == 0x9:                  # ping -> pong
                sock.sendall(encode_frame(payload, opcode=0xA, mask=True))
            elif opcode == 0x8:                  # close
                raise OSError('closed')

    def drain(self) -> None:
        """Deliver buffered messages on the caller's (player) thread."""
        with self._lock:
            pending, self._pending = self._pending, []
        for chunk in pending:
            if self.destination is not None:
                self.destination.write(chunk)

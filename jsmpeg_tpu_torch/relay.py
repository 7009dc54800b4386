"""HTTP -> WebSocket/TCP relay for live MPEG-TS streaming (the port of
tools/relay.py, the sidecar role of the reference's websocket-relay.js).

An encoder POSTs an endless MPEG-TS body to http://host:8081/<secret>,
and every connected WebSocket client on :8082, raw-TCP client on :8083
(what TCPSource speaks) and HTTP GET client on :8081 (an endless chunked
body, what HTTPStreamSource reads) receives each chunk as it arrives.
Optionally every chunk is appended to a .ts file.

  python -m jsmpeg_tpu_torch.relay <secret> [--http 8081] [--ws 8082]
                                   [--tcp 8083] [--host 0.0.0.0]
                                   [--record out.ts]

stdlib only (asyncio); WebSocket framing from net/ws.py.  The relay
decodes nothing, so it needs no device.
"""

from __future__ import annotations

import argparse
import asyncio
from typing import Optional

from .net.ws import encode_frame, server_handshake


class Relay:
    def __init__(self, secret: str, record: Optional[str] = None):
        self.secret = secret
        self.ws_clients: set = set()
        self.tcp_clients: set = set()
        self.http_clients: set = set()
        # unbuffered: the recording holds every chunk as soon as it is
        # relayed, and nothing is lost when the relay is stopped
        self.record = open(record, 'ab', buffering=0) if record else None
        self.bytes_in = 0

    def close(self) -> None:
        if self.record:
            self.record.close()
            self.record = None

    def broadcast(self, chunk: bytes) -> None:
        self.bytes_in += len(chunk)
        if self.record:
            self.record.write(chunk)
        ws_frame = encode_frame(chunk, opcode=0x2)
        hx = b'%x\r\n%s\r\n' % (len(chunk), chunk)   # chunked framing
        for clients, data in ((self.ws_clients, ws_frame),
                              (self.tcp_clients, chunk),
                              (self.http_clients, hx)):
            for w in list(clients):
                try:
                    w.write(data)
                except (OSError, RuntimeError):   # a client that went away
                    clients.discard(w)

    # ---------------------------------------------------------- HTTP in/out

    async def handle_http(self, reader: asyncio.StreamReader,
                          writer: asyncio.StreamWriter) -> None:
        """POST /<secret> ingests; GET streams the live TS back out as an
        endless chunked body (no Content-Length -- the HTTPStreamSource /
        reference-Fetch shape of delivery)."""
        try:
            head = await reader.readuntil(b'\r\n\r\n')
        except (asyncio.IncompleteReadError, asyncio.LimitOverrunError):
            writer.close()
            return
        request = head.split(b'\r\n')[0].decode('latin1')
        parts = request.split(' ')
        method = parts[0].upper() if parts else 'GET'
        path = parts[1] if len(parts) > 1 else '/'
        if method == 'GET':
            await self._serve_http_out(reader, writer)
            return
        if path.strip('/') != self.secret:
            writer.write(b'HTTP/1.1 403 Forbidden\r\n\r\n')
            await writer.drain()
            writer.close()
            return
        peer = writer.get_extra_info('peername')
        print(f'relay: stream connected from {peer}', flush=True)
        try:
            while True:
                chunk = await reader.read(65536)
                if not chunk:
                    break
                self.broadcast(chunk)
        finally:
            print('relay: stream disconnected', flush=True)
            writer.close()

    async def _serve_http_out(self, reader: asyncio.StreamReader,
                              writer: asyncio.StreamWriter) -> None:
        writer.write(b'HTTP/1.1 200 OK\r\n'
                     b'Content-Type: video/mp2t\r\n'
                     b'Transfer-Encoding: chunked\r\n'
                     b'Cache-Control: no-store\r\n'
                     b'Connection: close\r\n\r\n')
        await writer.drain()
        await self._hold(self.http_clients, 'http', reader, writer)

    async def _hold(self, clients: set, kind: str,
                    reader: asyncio.StreamReader,
                    writer: asyncio.StreamWriter) -> None:
        """Keep a client in `clients` until it closes its connection
        (what it sends is ignored)."""
        clients.add(writer)
        print(f'relay: {kind} client connected ({len(clients)} total)',
              flush=True)
        try:
            while await reader.read(4096):
                pass
        finally:
            clients.discard(writer)
            writer.close()
            print(f'relay: {kind} client disconnected', flush=True)

    # -------------------------------------------------------------- WS out

    async def handle_ws(self, reader: asyncio.StreamReader,
                        writer: asyncio.StreamWriter) -> None:
        try:
            head = await reader.readuntil(b'\r\n\r\n')
        except (asyncio.IncompleteReadError, asyncio.LimitOverrunError):
            writer.close()
            return
        resp = server_handshake(head)
        if resp is None:
            writer.write(b'HTTP/1.1 400 Bad Request\r\n\r\n')
            await writer.drain()
            writer.close()
            return
        writer.write(resp)
        await writer.drain()
        await self._hold(self.ws_clients, 'ws', reader, writer)

    # ------------------------------------------------------------- TCP out

    async def handle_tcp(self, reader: asyncio.StreamReader,
                         writer: asyncio.StreamWriter) -> None:
        await self._hold(self.tcp_clients, 'tcp', reader, writer)


async def serve(secret: str, http_port: int, ws_port: int, tcp_port: int,
                record: Optional[str], host: str = '0.0.0.0') -> None:
    """Run the relay until cancelled; the recording is closed on the way
    out."""
    relay = Relay(secret, record)
    try:
        http_srv = await asyncio.start_server(relay.handle_http, host,
                                              http_port)
        ws_srv = await asyncio.start_server(relay.handle_ws, host, ws_port)
        tcp_srv = await asyncio.start_server(relay.handle_tcp, host,
                                             tcp_port)
        print(f'relay: ingest http://{host}:{http_port}/{secret}  '
              f'clients ws://{host}:{ws_port}/ tcp://{host}:{tcp_port}',
              flush=True)
        async with http_srv, ws_srv, tcp_srv:
            await asyncio.gather(http_srv.serve_forever(),
                                 ws_srv.serve_forever(),
                                 tcp_srv.serve_forever())
    finally:
        relay.close()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog='jsmpeg_tpu_torch.relay',
        description='HTTP -> WebSocket/TCP relay for live MPEG-TS')
    ap.add_argument('secret')
    ap.add_argument('--http', type=int, default=8081)
    ap.add_argument('--ws', type=int, default=8082)
    ap.add_argument('--tcp', type=int, default=8083)
    ap.add_argument('--host', default='0.0.0.0')
    ap.add_argument('--record')
    args = ap.parse_args(argv)
    asyncio.run(serve(args.secret, args.http, args.ws, args.tcp,
                      args.record, args.host))


if __name__ == '__main__':
    main()

"""The port's sources, buffer caps, callbacks and metrics on the CPU
(the cases of tests/test_sources_misc.py), and live streaming end to end
(tests/test_streaming_relay.py): HTTP ingest -> the port's relay
(jsmpeg_tpu_torch.relay) -> WebSocket/TCP/chunked-HTTP client -> the
port's Player, and the relay's recording.  Every decoded frame is held
to the oracle exactly."""

import http.server
import io
import socket
import threading
import time

import numpy as np
import pytest

from jsmpeg_tpu_torch.metrics import StageTimer
from jsmpeg_tpu_torch.models.mpeg1 import MPEG1Decoder
from jsmpeg_tpu_torch.player import Player
from jsmpeg_tpu_torch.sinks import PCMCollector, VideoCollector
from jsmpeg_tpu_torch.sources import HTTPStreamSource, ProgressiveFileSource
from jsmpeg_tpu_torch.testing.gen import encode_test_stream
from jsmpeg_tpu_torch.testing.ts_mux import mux_video
from tests.oracle.ref_mpeg1 import OracleMPEG1

CPU = {'device': 'cpu'}


def _ts(seed=91, n=4, w=48, h=32, gop=2):
    es, chunks = encode_test_stream(w, h, n_frames=n, seed=seed, gop=gop)
    v = chunks[:-1]
    v[-1] = v[-1] + chunks[-1]
    return es, mux_video(v, 25.0)


def _assert_frames_exact(es, frames):
    golden = OracleMPEG1(es).decode_all()
    assert len(frames) <= len(golden)
    for (gy, gcr, gcb), (py, pcr, pcb) in zip(golden, frames):
        np.testing.assert_array_equal(gy, py)
        np.testing.assert_array_equal(gcr, pcr)
        np.testing.assert_array_equal(gcb, pcb)


@pytest.fixture(scope='module')
def http_server(tmp_path_factory):
    root = tmp_path_factory.mktemp('www')
    es, ts = _ts()
    (root / 'clip.ts').write_bytes(ts)

    class Handler(http.server.SimpleHTTPRequestHandler):
        def translate_path(self, path):
            return str(root / path.lstrip('/'))

        def log_message(self, *a):
            pass

    srv = http.server.ThreadingHTTPServer(('127.0.0.1', 0), Handler)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f'http://127.0.0.1:{srv.server_port}/clip.ts', es
    srv.shutdown()


def test_http_progressive_source(http_server):
    url, es = http_server
    vc = VideoCollector()
    p = Player(url, dict(CPU, chunkSize=700), renderer=vc)
    p.run()
    assert vc.frames_rendered == 4
    _assert_frames_exact(es, vc.frames)


def test_adaptive_throttle_slow_source(tmp_path):
    """The progressive throttle scales with the measured chunk load time
    (reference src/ajax-progressive.js:47-58: worst case = loadTime*8+2):
    a slow medium prefetches at high headroom, a fast one does not."""
    path = tmp_path / 'clip.bin'
    path.write_bytes(b'x' * 4096)
    src = ProgressiveFileSource(str(path), chunk_size=512)
    got = []

    class Dest:
        def write(self, b):
            got.append(len(b))
    src.connect(Dest())
    src.start()
    # fast source (local file, ~0 load time): 3 s headroom > 0*8+2 -> hold
    src.resume(3.0)
    assert len(got) == 1
    # slow source: a 0.5 s measured chunk load -> worst case 6 s; the same
    # 3 s headroom now triggers a prefetch
    src._load_time = 0.5
    src.resume(3.0)
    assert len(got) == 2
    # and low headroom still loads regardless of speed
    src._load_time = 0.0
    src.resume(1.0)
    assert len(got) == 3
    src.destroy()


def test_render_progress_surface():
    """render_progress draws a stderr-style bar when a stream is attached
    (reference loading bar: src/canvas2d.js:36-46) and stays silent
    otherwise."""
    vc = VideoCollector()
    vc.render_progress(0.5)            # silent: no stream attached
    buf = io.StringIO()
    vc.progress_stream = buf
    vc.render_progress(0.25)
    vc.render_progress(0.253)          # <1% delta: no redraw
    vc.render_progress(1.0)
    out = buf.getvalue()
    assert ' 25%' in out and '100%' in out
    assert out.count('\r') == 2 and out.endswith('\n')


def test_http_whole_file(http_server):
    url, es = http_server
    vc = VideoCollector()
    p = Player(url, dict(CPU, progressive=False), renderer=vc)
    n_video, _ = p.decode_offline()
    assert n_video == 4
    _assert_frames_exact(es, vc.frames)


def test_source_callbacks(http_server):
    url, _ = http_server
    fired = []
    p = Player(url, dict(CPU, **{
        'onSourceEstablished': lambda s: fired.append('est'),
        'onSourceCompleted': lambda s: fired.append('done'),
        'onEnded': lambda s: fired.append('ended'),
    }), renderer=VideoCollector())
    p.run()
    assert 'est' in fired and 'done' in fired and 'ended' in fired


def test_streaming_buffer_cap():
    es, _ = _ts(seed=5, n=6)
    dec = MPEG1Decoder(dict(CPU, streaming=True, videoBufferSize=2048))
    # write far more than the cap without decoding: memory stays bounded
    for _ in range(50):
        dec.write(None, es)
    unread = dec.parser.bits.byte_length - (dec.parser.bits.index >> 3)
    assert unread <= 2048 + len(es)


def test_stage_timer():
    t = StageTimer()
    with t.time('parse', n=10):
        pass
    assert t.summary()['parse']['count'] == 10


def test_device_trace_writes_a_chrome_trace(tmp_path):
    """device_trace profiles a region and writes its Chrome trace; with no
    CUDA device in the process it sees no device time (busy share 0)."""
    from jsmpeg_tpu_torch.metrics import device_trace
    _, ts = _ts(seed=19)
    path = tmp_path / 'trace.json'
    with device_trace(str(path)) as tr:
        Player(ts, dict(CPU, progressive=False)).decode_offline()
    assert tr.wall_s > 0 and tr.device_s == 0 and tr.busy_share == 0
    assert tr.profile is not None
    assert b'traceEvents' in path.read_bytes()


def test_volume_property():
    """player.volume scales PCM in the sink (reference player.js:143-150);
    volume 1.0 is a bit-exact passthrough."""
    a = PCMCollector()
    left = np.full(8, 0.5, np.float32)
    a.play(44100, left, left)
    a.volume = 0.25
    a.play(44100, left, left)
    np.testing.assert_array_equal(a.chunks[0][0], left)
    np.testing.assert_allclose(a.chunks[1][0], left * np.float32(0.25))


def test_http_stream_source_clean_eof_completes():
    """A finite chunked body ends the HTTPStreamSource cleanly: completed
    is set and the body is NOT replayed from byte 0 (only errors
    reconnect -- the reference Fetch source also finishes when the
    stream ends)."""
    payload = b'0123456789abcdef' * 64

    def serve(sock):
        conn, _ = sock.accept()
        conn.recv(4096)
        conn.sendall(b'HTTP/1.1 200 OK\r\n'
                     b'Content-Type: video/mp2t\r\n'
                     b'Transfer-Encoding: chunked\r\n\r\n')
        for i in range(0, len(payload), 256):
            chunk = payload[i:i + 256]
            conn.sendall(b'%x\r\n%s\r\n' % (len(chunk), chunk))
        conn.sendall(b'0\r\n\r\n')          # clean chunked EOF
        conn.close()

    sock = socket.socket()
    sock.bind(('127.0.0.1', 0))
    sock.listen(1)
    port = sock.getsockname()[1]
    threading.Thread(target=serve, args=(sock,), daemon=True).start()
    got = []

    class Dest:
        def write(self, b):
            got.append(bytes(b))

    src = HTTPStreamSource(f'http://127.0.0.1:{port}/live.ts',
                           reconnect_interval=0.05)
    src.connect(Dest())
    src.start()
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline and not src.completed:
        src.drain()
        time.sleep(0.01)
    src.drain()
    assert src.completed
    assert b''.join(got) == payload          # exactly once, no replay
    src.destroy()
    sock.close()


def test_constructing_sources_starts_no_thread(monkeypatch):
    """Sources start their reader threads in start(), never before."""
    from jsmpeg_tpu_torch.net.ws import WebSocketSource
    from jsmpeg_tpu_torch.sources import TCPSource
    started = []
    monkeypatch.setattr(threading.Thread, 'start',
                        lambda self: started.append(self))
    srcs = [TCPSource('127.0.0.1', 9), WebSocketSource('ws://127.0.0.1:9/'),
            HTTPStreamSource('http://127.0.0.1:9/')]
    assert not started
    for src in srcs:
        src.start()
    assert len(started) == 3


# ------------------------------------------------------- live streaming

def _find_port():
    s = socket.socket()
    s.bind(('127.0.0.1', 0))
    p = s.getsockname()[1]
    s.close()
    return p


def _start_relay(record=None):
    """jsmpeg_tpu_torch.relay.serve in a thread of its own (an asyncio
    loop) on three free localhost ports.  Returns (ports, stop): stop()
    cancels the server and joins its thread."""
    import asyncio
    from jsmpeg_tpu_torch.relay import serve

    loop = asyncio.new_event_loop()
    ports = dict(http=_find_port(), ws=_find_port(), tcp=_find_port())
    task = loop.create_task(serve('sec', ports['http'], ports['ws'],
                                  ports['tcp'], record, host='127.0.0.1'))

    def run():
        asyncio.set_event_loop(loop)
        try:
            loop.run_until_complete(task)
        except asyncio.CancelledError:
            pass
        finally:
            loop.close()

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    time.sleep(0.4)

    def stop():
        loop.call_soon_threadsafe(task.cancel)
        thread.join(timeout=10)
        assert not thread.is_alive()

    return ports, stop


@pytest.fixture(scope='module')
def relay():
    """The port's relay for the module's live-streaming cases."""
    ports, stop = _start_relay()
    yield ports
    stop()


def _post_stream(port, ts, chunk=600, delay=0.002):
    s = socket.create_connection(('127.0.0.1', port))
    s.sendall(b'POST /sec HTTP/1.1\r\nHost: x\r\n\r\n')
    for i in range(0, len(ts), chunk):
        s.sendall(ts[i:i + chunk])
        time.sleep(delay)
    time.sleep(0.3)
    s.close()


@pytest.mark.parametrize('scheme', ['ws', 'tcp', 'http'])
def test_live_stream_end_to_end(relay, scheme):
    """ws/tcp: push sources.  http: the relay serves the live TS back out
    as an endless chunked body (no Content-Length) and HTTPStreamSource
    pumps it incrementally -- the reference Fetch source role
    (src/fetch.js:22-62)."""
    es, ts = _ts(seed=77, n=6, gop=3)
    url = {'ws': f'ws://127.0.0.1:{relay["ws"]}/',
           'tcp': f'tcp://127.0.0.1:{relay["tcp"]}',
           'http': f'http://127.0.0.1:{relay["http"]}/live.ts'}[scheme]
    vc = VideoCollector()
    p = Player(url, dict(CPU, audio=False, streaming=scheme == 'http'),
               renderer=vc)
    p.play()
    time.sleep(0.4)   # let the client connect before streaming starts

    feeder = threading.Thread(target=_post_stream,
                              args=(relay['http'], ts), daemon=True)
    feeder.start()
    deadline = time.monotonic() + 20
    while time.monotonic() < deadline and vc.frames_rendered < 5:
        p.tick()
        time.sleep(0.005)
    feeder.join()
    for _ in range(20):
        p.tick()
    p.destroy()

    assert vc.frames_rendered >= 5, vc.frames_rendered
    # streaming decode is bit-exact for the frames it produced
    _assert_frames_exact(es, vc.frames)


def test_relay_records_the_stream(tmp_path):
    """--record: every ingested chunk is appended to the file as it is
    relayed (a ws client connected or not), and the file is closed when
    the relay stops; a POST to another path than the secret is refused
    and records nothing."""
    _, ts = _ts(seed=78, n=3)
    path = tmp_path / 'rec.ts'
    path.write_bytes(b'old')               # appends, as the reference does
    ports, stop = _start_relay(record=str(path))
    try:
        s = socket.create_connection(('127.0.0.1', ports['http']))
        s.sendall(b'POST /wrong HTTP/1.1\r\nHost: x\r\n\r\n' + ts[:188])
        assert s.recv(64).startswith(b'HTTP/1.1 403')
        s.close()
        _post_stream(ports['http'], ts, chunk=700, delay=0.001)
        deadline = time.monotonic() + 5
        while (time.monotonic() < deadline
               and path.stat().st_size < 3 + len(ts)):
            time.sleep(0.02)
        assert path.read_bytes() == b'old' + ts
    finally:
        stop()
    assert path.read_bytes() == b'old' + ts


def test_relay_cli_help():
    """python -m jsmpeg_tpu_torch.relay names its options."""
    import subprocess
    import sys
    from pathlib import Path
    r = subprocess.run([sys.executable, '-m', 'jsmpeg_tpu_torch.relay',
                        '--help'], capture_output=True, text=True,
                       timeout=60, cwd=Path(__file__).resolve().parents[1])
    assert r.returncode == 0
    for opt in ('secret', '--http', '--ws', '--tcp', '--record'):
        assert opt in r.stdout

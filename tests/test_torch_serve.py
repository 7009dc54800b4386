"""The port's joint live serving (jsmpeg_tpu_torch.serve) on the CPU,
mirroring tests/test_serve_live.py: two TCP feeds dribbling MPEG-TS at
different rates decode jointly and bit-exactly, static A/V feeds give
y4m and wav bytes equal to jsmpeg_tpu's tools/serve.py (in the joint
modes too), and a stalled feed does not block the others."""

import socket
import threading
import time

import numpy as np
import pytest

from jsmpeg_tpu_torch.serve import main, serve
from jsmpeg_tpu_torch.testing.gen import encode_test_stream
from jsmpeg_tpu_torch.testing.mp2_enc import encode_stream as mp2_stream
from jsmpeg_tpu_torch.testing.ts_mux import mux_av, mux_video
from tests.oracle.ref_mpeg1 import OracleMPEG1


def _clip(seed, n_frames=6):
    es, chunks = encode_test_stream(64, 48, n_frames=n_frames, seed=seed,
                                    gop=3)
    v = chunks[:-1]
    v[-1] = v[-1] + chunks[-1]
    return es, mux_video(v, 25.0)


def _tcp_server(ts, delay):
    """One-shot TCP server: accepts a client, dribbles `ts` in chunks,
    then holds the socket open (a live feed never EOFs)."""
    srv = socket.socket()
    srv.bind(('127.0.0.1', 0))
    srv.listen(1)
    port = srv.getsockname()[1]
    done = threading.Event()

    def run():
        conn, _ = srv.accept()
        for off in range(0, len(ts), 752):
            conn.sendall(ts[off:off + 752])
            time.sleep(delay)
        done.set()
        time.sleep(8)        # hold open past the client's deadline
        conn.close()
        srv.close()

    threading.Thread(target=run, daemon=True).start()
    return port, done


def _y4m_lumas(path, w, h):
    frames = path.read_bytes().split(b'FRAME\n')[1:]
    return [np.frombuffer(fr[:w * h], np.uint8).reshape(h, w)
            for fr in frames]


def test_joint_live_tcp_feeds(tmp_path):
    es_a, ts_a = _clip(61)
    es_b, ts_b = _clip(62)
    pa, done_a = _tcp_server(ts_a, 0.004)
    pb, done_b = _tcp_server(ts_b, 0.02)      # slower feed

    out = str(tmp_path / 's%d.y4m')
    stats = serve([f'tcp://127.0.0.1:{pa}', f'tcp://127.0.0.1:{pb}'],
                  out_pattern=out, batch=4, interval=0.02, seconds=6.0,
                  device='cpu')
    assert done_a.is_set() and done_b.is_set(), 'feeds did not finish'
    assert stats['video_frames'] == [6, 6]
    assert stats['device'] == 'cpu' and stats['dead'] == {}

    for i, es in enumerate((es_a, es_b)):
        golden = OracleMPEG1(es).decode_all()
        lumas = _y4m_lumas(tmp_path / f's{i}.y4m', 64, 48)
        assert len(lumas) == 6, f'stream {i}'
        for k, y in enumerate(lumas):
            np.testing.assert_array_equal(golden[k][0][:48, :64], y,
                                          err_msg=f's{i} f{k}')


def test_serve_static_av_with_audio(tmp_path):
    """Static A/V inputs: the per-stream y4m and wav (exact host MP2
    path) are byte for byte jsmpeg_tpu's serve() on the same files; the
    CLI entry writes the same files."""
    from tools.serve import serve as jax_serve

    paths = []
    for seed in (71, 72):
        es, chunks = encode_test_stream(64, 48, n_frames=4, seed=seed,
                                        gop=2)
        _, af = mp2_stream(5, seed=seed)
        v = chunks[:-1]
        v[-1] = v[-1] + chunks[-1]
        p = tmp_path / f'in{seed}.ts'
        p.write_bytes(mux_av(v, 25.0, af, 1152, 44100))
        paths.append(str(p))

    stats = serve(paths, out_pattern=str(tmp_path / 'v%d.y4m'),
                  wav_pattern=str(tmp_path / 'a%d.wav'), batch=4,
                  interval=0.01, seconds=30.0, device='cpu')
    assert stats['video_frames'] == [4, 4]
    jstats = jax_serve(paths, out_pattern=str(tmp_path / 'jv%d.y4m'),
                       wav_pattern=str(tmp_path / 'ja%d.wav'), batch=4,
                       interval=0.01, seconds=30.0)
    assert jstats['video_frames'] == [4, 4]
    assert main([*paths, '-o', str(tmp_path / 'cv%d.y4m'), '--wav',
                 str(tmp_path / 'ca%d.wav'), '--batch', '4',
                 '--device', 'cpu']) == 0
    for i in range(2):
        for name, jname in ((f'v{i}.y4m', f'jv{i}.y4m'),
                            (f'a{i}.wav', f'ja{i}.wav'),
                            (f'cv{i}.y4m', f'jv{i}.y4m'),
                            (f'ca{i}.wav', f'ja{i}.wav')):
            got = (tmp_path / name).read_bytes()
            assert len(got) > 44, name
            assert got == (tmp_path / jname).read_bytes(), name


def test_stalled_feed_does_not_block(tmp_path):
    """Head-of-line isolation: feed B sends a few packets then stalls;
    feed A must still decode ALL its frames within the deadline."""
    es_a, ts_a = _clip(63)
    _, ts_b = _clip(64)
    pa, done_a = _tcp_server(ts_a, 0.004)
    pb, _ = _tcp_server(ts_b[:400], 0.004)    # truncated: stalls forever

    stats = serve([f'tcp://127.0.0.1:{pa}', f'tcp://127.0.0.1:{pb}'],
                  out_pattern=str(tmp_path / 'hb%d.y4m'), batch=4,
                  interval=0.02, seconds=5.0, device='cpu')
    assert done_a.is_set()
    assert stats['video_frames'][0] == 6, 'stalled feed blocked the round'

    golden = OracleMPEG1(es_a).decode_all()
    lumas = _y4m_lumas(tmp_path / 'hb0.y4m', 64, 48)
    assert len(lumas) == 6
    np.testing.assert_array_equal(golden[-1][0][:48, :64], lumas[-1])


def test_static_feed_over_the_live_cap_is_whole(tmp_path):
    """A static file arrives whole, so the EVICT bound of live feeds
    (128 KB of unread audio here) must not apply to it: every audio
    frame of a 154 KB MP2 stream reaches the wav, equal to a plain
    decode.  jsmpeg_tpu's tools/serve.py bounds every feed and drops the
    file's unread audio (a reference defect the port does not copy)."""
    from jsmpeg_tpu_torch.models.mp2 import MP2Decoder
    from jsmpeg_tpu_torch.sinks import WavWriter
    from tools.serve import serve as jax_serve

    _, chunks = encode_test_stream(64, 48, n_frames=4, seed=73, gop=2)
    aes, af = mp2_stream(123, seed=74)
    assert len(aes) > 128 * 1024
    v = chunks[:-1]
    v[-1] = v[-1] + chunks[-1]
    path = tmp_path / 'big.ts'
    path.write_bytes(mux_av(v, 25.0, af, 1152, 44100))
    stats = serve([str(path)], out_pattern=str(tmp_path / 'v%d.y4m'),
                  wav_pattern=str(tmp_path / 'a%d.wav'), device='cpu')
    assert stats['video_frames'] == [4]
    ref = MP2Decoder()
    ref.connect(WavWriter(str(tmp_path / 'ref.wav')))
    ref.write(0.0, aes)
    ref.decode_available()
    ref.destination.close()
    got = (tmp_path / 'a0.wav').read_bytes()
    assert got == (tmp_path / 'ref.wav').read_bytes()
    jax_serve([str(path)], wav_pattern=str(tmp_path / 'j%d.wav'))
    assert len((tmp_path / 'j0.wav').read_bytes()) < len(got)


@pytest.mark.parametrize('mode', ['stacked', 'vmap'])
def test_serve_joint_modes(tmp_path, mode):
    """`--mode stacked|vmap`: two static feeds of unequal length, one
    joint launch pair per round; the y4m files are byte for byte
    jsmpeg_tpu's serve() in the same mode."""
    from tools.serve import serve as jax_serve

    paths = []
    for seed, n in ((75, 6), (76, 3)):
        _, ts = _clip(seed, n_frames=n)
        p = tmp_path / f'in{seed}.ts'
        p.write_bytes(ts)
        paths.append(str(p))
    assert main([*paths, '-o', str(tmp_path / 'v%d.y4m'), '--batch', '4',
                 '--mode', mode, '--device', 'cpu']) == 0
    jstats = jax_serve(paths, out_pattern=str(tmp_path / 'j%d.y4m'),
                       batch=4, interval=0.01, seconds=30.0, mode=mode)
    assert jstats['video_frames'] == [6, 3]
    for i in range(2):
        got = (tmp_path / f'v{i}.y4m').read_bytes()
        assert got.count(b'FRAME') == (6, 3)[i]
        assert got == (tmp_path / f'j{i}.y4m').read_bytes()

"""The port's Player, colour conversion and sinks on the CPU
({'device': 'cpu'}) against the oracles and against jsmpeg_tpu on the same
seeded streams: the cases of tests/test_player_e2e.py, tests/test_color.py
and tests/test_sinks_png.py.  Video frames, exact PCM, the integer colour
conversion, y4m/wav/PPM/PNG bytes and the poster are held exactly; the
device-mode audio within 3e-5 of the oracle and 1e-6 of jsmpeg_tpu's
mode='tpu'; the Rec.601 conversion within 1 of jsmpeg_tpu's."""

import wave

import numpy as np
import pytest
import torch

from jsmpeg_tpu import sinks as jax_sinks
from jsmpeg_tpu.ops import color as jax_color
from jsmpeg_tpu.player import Player as JaxPlayer
from jsmpeg_tpu_torch.config import PlayerConfig
from jsmpeg_tpu_torch.models.mpeg1 import MPEG1Decoder
from jsmpeg_tpu_torch.ops.color import ycbcr_to_rgb_int, ycbcr_to_rgb_rec601
from jsmpeg_tpu_torch.player import Player, _PosterTee
from jsmpeg_tpu_torch.sinks import (NullVideoSink, PCMCollector, PPMWriter,
                                    VideoCollector, WavWriter, Y4MWriter,
                                    write_image)
from jsmpeg_tpu_torch.testing.gen import encode_test_stream
from jsmpeg_tpu_torch.testing.mp2_enc import encode_stream as mp2_stream
from jsmpeg_tpu_torch.testing.ts_mux import mux_av, mux_video
from tests.oracle.ref_mp2 import OracleMP2
from tests.oracle.ref_mpeg1 import OracleMPEG1
from tests.test_color import _oracle_canvas2d
from tests.test_sinks_png import read_png

CPU = {'device': 'cpu'}


def _opts(**kw):
    return dict(CPU, **kw)


def _av(sf_range=(0, 63)):
    es, chunks = encode_test_stream(64, 48, n_frames=6, seed=12, gop=3,
                                    frame_rate=25.0)
    audio_es, audio_frames = mp2_stream(10, seed=13, sf_range=sf_range)
    # the trailing sequence-end chunk rides with the last frame's PES
    vframes = chunks[:-1]
    vframes[-1] = vframes[-1] + chunks[-1]
    ts = mux_av(vframes, 25.0, audio_frames, 1152, 44100)
    return ts, es, audio_es


@pytest.fixture(scope='module')
def av_ts():
    return _av()


def _golden_pcm(audio_es):
    golden = OracleMP2(audio_es).decode_all()
    return (np.concatenate([f[0] for f in golden]),
            np.concatenate([f[1] for f in golden]), len(golden))


# ----------------------------------------------------------------- player

def test_offline_av_decode_matches_oracles_and_jax(av_ts):
    ts, video_es, audio_es = av_ts
    vc, ac = VideoCollector(), PCMCollector()
    p = Player(ts, _opts(progressive=False), renderer=vc, audio_out=ac)
    n_video, n_audio = p.decode_offline()
    jvc, jac = jax_sinks.VideoCollector(), jax_sinks.PCMCollector()
    assert JaxPlayer(ts, {'progressive': False}, renderer=jvc,
                     audio_out=jac).decode_offline() == (n_video, n_audio)

    golden_v = OracleMPEG1(video_es).decode_all()
    gl, gr, n_golden_a = _golden_pcm(audio_es)
    assert n_video == len(golden_v) == len(jvc.frames) == 6
    assert n_audio == n_golden_a == 10
    for i, (g, o, j) in enumerate(zip(golden_v, vc.frames, jvc.frames)):
        for a, b, c in zip(o, g, j):
            assert isinstance(a, np.ndarray)
            np.testing.assert_array_equal(a, b, err_msg=f'frame {i}')
            np.testing.assert_array_equal(a, c, err_msg=f'frame {i}')
    got = ac.pcm
    np.testing.assert_array_equal(got[0], gl)
    np.testing.assert_array_equal(got[1], gr)
    np.testing.assert_array_equal(got, jac.pcm)


def test_offline_audio_mode_device():
    """decode_offline with audio_mode='device' batches every audio frame
    through the float32 synthesis on the decoder's device; non-saturated
    content stays within 3e-5 of the oracle and 1e-6 of jsmpeg_tpu's
    audio_mode='tpu'."""
    ts, _, audio_es = _av(sf_range=(24, 63))
    ac, jac = PCMCollector(), jax_sinks.PCMCollector()
    p = Player(ts, _opts(progressive=False, audio_mode='device',
                         video=False), audio_out=ac)
    _, n_audio = p.decode_offline()
    assert p.audio.mode == 'device' and p.audio.device == torch.device('cpu')
    JaxPlayer(ts, {'progressive': False, 'audio_mode': 'tpu',
                   'video': False}, audio_out=jac).decode_offline()
    gl, gr, n_golden = _golden_pcm(audio_es)
    assert n_audio == n_golden == 10
    got = ac.pcm
    np.testing.assert_allclose(got[0], gl, atol=3e-5)
    np.testing.assert_allclose(got[1], gr, atol=3e-5)
    np.testing.assert_allclose(got, jac.pcm, rtol=0, atol=1e-6)


def test_poster_written(av_ts, tmp_path):
    """cfg.poster writes the decodeFirstFrame preview as a PPM (the
    data-poster analog of the reference video element), byte for byte
    jsmpeg_tpu's poster."""
    ts, video_es, _ = av_ts
    poster, jposter = tmp_path / 'poster.ppm', tmp_path / 'jax.ppm'
    p = Player(ts, _opts(progressive=False, poster=str(poster), audio=False),
               renderer=VideoCollector())
    p.decode_offline()
    JaxPlayer(ts, {'progressive': False, 'poster': str(jposter),
                   'audio': False},
              renderer=jax_sinks.VideoCollector()).decode_offline()
    data = poster.read_bytes()
    assert data.startswith(b'P6\n64 48\n255\n')
    gy, gcr, gcb = OracleMPEG1(video_es).decode_all()[0]
    rgb = _oracle_canvas2d(gy, gcr, gcb, 64, 48)
    assert data.split(b'\n', 3)[3] == rgb.tobytes()
    assert data == jposter.read_bytes()


def test_tick_driven_av_sync(av_ts):
    ts, video_es, audio_es = av_ts
    vc, ac = VideoCollector(), PCMCollector()
    p = Player(ts, _opts(progressive=False), renderer=vc, audio_out=ac)
    p.run(realtime=False)
    assert vc.frames_rendered == 6
    assert ac.samples_played == 10 * 1152
    # bit-exact through the tick path too
    golden_v = OracleMPEG1(video_es).decode_all()
    for (gy, _, _), (py, _, _) in zip(golden_v, vc.frames):
        np.testing.assert_array_equal(gy, py)
    gl, gr, _ = _golden_pcm(audio_es)
    np.testing.assert_array_equal(ac.pcm[0], gl)


def test_video_only_file(tmp_path):
    es, chunks = encode_test_stream(48, 32, n_frames=4, seed=14, gop=2)
    vframes = chunks[:-1]
    vframes[-1] = vframes[-1] + chunks[-1]
    path = tmp_path / 'clip.ts'
    path.write_bytes(mux_video(vframes, 25.0))
    vc = VideoCollector()
    p = Player(str(path), _opts(audio=False, chunkSize=512), renderer=vc)
    p.run()
    assert vc.frames_rendered == 4
    golden = OracleMPEG1(es).decode_all()
    for (gy, _, _), (py, _, _) in zip(golden, vc.frames):
        np.testing.assert_array_equal(gy, py)


def test_seek_and_loop(av_ts):
    ts, _, _ = av_ts
    vc = VideoCollector()
    p = Player(ts, _opts(progressive=False, audio=False), renderer=vc)
    p.run()
    n1 = vc.frames_rendered
    assert n1 == 6
    p.seek(0.0)
    p._ended_fired = False
    p.play()
    while p.tick():
        pass
    # after seek to 0 the stream decodes again (frames re-rendered)
    assert vc.frames_rendered > n1
    for a, b in zip(vc.frames[n1:], vc.frames):
        np.testing.assert_array_equal(a[0], b[0])


def test_streaming_push_source():
    from jsmpeg_tpu_torch.sources import PushSource
    es, chunks = encode_test_stream(48, 32, n_frames=4, seed=15, gop=2)
    vframes = chunks[:-1]
    vframes[-1] = vframes[-1] + chunks[-1]
    ts = mux_video(vframes, 25.0)
    src = PushSource()
    vc = VideoCollector()
    p = Player(src, _opts(audio=False), renderer=vc)
    assert p.streaming
    p.play()
    # push in odd-sized chunks like a network would
    for pos in range(0, len(ts), 1001):
        src.write(ts[pos:pos + 1001])
        p.tick()
    for _ in range(8):
        p.tick()
    assert vc.frames_rendered >= 3   # streaming decodes what is buffered
    golden = OracleMPEG1(es).decode_all()
    for (gy, _, _), (py, _, _) in zip(golden, vc.frames):
        np.testing.assert_array_equal(gy, py)


@pytest.mark.parametrize('native', [True, False])
def test_seek_to_iframe_clean_resume(native):
    """seek(t, to_iframe=True) resumes at a GOP boundary: the first frame
    decoded after the snap is bit-exact with the oracle's I frame, with
    the C++ and the Python parser."""
    es, chunks = encode_test_stream(96, 64, n_frames=9, seed=17, gop=3,
                                    frame_rate=25.0)
    golden = OracleMPEG1(es).decode_all()
    dec = MPEG1Decoder(_opts(native=native))
    for i, c in enumerate(chunks[:-1]):
        dec.write(i / 25.0, c)
    dec.write(None, chunks[-1])
    # seek into the middle of GOP 1 (frames 3..5): the snap lands on
    # frame 6's I picture (the next I at/after the seek point)
    dec.seek(4.4 / 25.0, to_iframe=True)
    got = dec.decode(eof=True).y.numpy()
    matches = [i for i, (gy, _, _) in enumerate(golden)
               if np.array_equal(gy, got)]
    assert matches and all(m % 3 == 0 for m in matches), matches


def test_offline_count_includes_first_frame_preview():
    """decode_offline counts the decodeFirstFrame preview (decoded during
    write) -- the decoder's frames_decoded covers it."""
    es, _ = encode_test_stream(80, 48, n_frames=5, seed=23, gop=5)
    dec = MPEG1Decoder(_opts(decodeFirstFrame=True))
    sink = VideoCollector()
    dec.connect(sink)
    dec.write(0.0, es)          # whole ES in one write -> preview decodes
    assert dec.frames_decoded == 1
    dec.decode_available(eof=True, retain=False)
    assert dec.frames_decoded == 5
    assert sink.frames_rendered == 5
    golden = OracleMPEG1(es).decode_all()
    for (gy, _, _), (py, _, _) in zip(golden, sink.frames):
        np.testing.assert_array_equal(gy, py)


def test_retain_false_frameseq_contract():
    """retain=False: len() counts all frames; accessing released frames
    raises a descriptive IndexError; no destination -> ValueError."""
    es, _ = encode_test_stream(80, 48, n_frames=4, seed=24, gop=2)
    dec = MPEG1Decoder(CPU)
    dec.write(0.0, es)
    with pytest.raises(ValueError):
        dec.decode_available(eof=True, retain=False)
    dec2 = MPEG1Decoder(CPU)
    dec2.connect(NullVideoSink())
    dec2.write(0.0, es)
    seq = dec2.decode_available(eof=True, retain=False)
    assert len(seq) == 4
    with pytest.raises(IndexError, match='released'):
        seq[0]
    assert list(iter(seq)) == []


def test_config_device_and_dropped_knobs():
    """PlayerConfig gains `device` (None = 'cuda') and takes the
    camelCase aliases; the TPU-only knobs are ignored like any unknown
    key."""
    cfg = PlayerConfig.from_options({'audioMode': 'device', 'batchGOP': False,
                                     'mesh': '2x1', 'wire_ids': True,
                                     'device': 'cpu'})
    assert (cfg.audio_mode, cfg.batch_gop, cfg.device) == ('device', False,
                                                           'cpu')
    assert PlayerConfig().device is None
    # the mesh is the port's too (tests/test_torch_mesh.py)
    assert cfg.mesh == '2x1' and PlayerConfig().mesh is None
    for knob in ('wire_ids', 'mc_method', 'block_carry', 'inline_upload',
                 'prewarm'):
        assert not hasattr(cfg, knob)


def test_frame_at_a_time_offline(av_ts):
    """batch_gop=False decodes frame at a time: the same frames."""
    ts, video_es, _ = av_ts
    vc = VideoCollector()
    p = Player(ts, _opts(progressive=False, audio=False, batch_gop=False),
               renderer=vc)
    n_video, _ = p.decode_offline()
    golden = OracleMPEG1(video_es).decode_all()
    assert n_video == vc.frames_rendered == len(golden)
    for g, o in zip(golden, vc.frames):
        for a, b in zip(o, g):
            np.testing.assert_array_equal(a, b)


# ----------------------------------------------------------------- colour

def _planes(rng, ch, cw):
    return (rng.integers(0, 256, (ch, cw), dtype=np.uint8),
            rng.integers(0, 256, (ch // 2, cw // 2), dtype=np.uint8),
            rng.integers(0, 256, (ch // 2, cw // 2), dtype=np.uint8))


@pytest.mark.parametrize('size', [(48, 32, 64, 32), (47, 33, 48, 48),
                                  (64, 48, 64, 48)])
def test_int_conversion_matches_reference_loop_and_jax(size):
    """Bit-exact with the reference's Canvas2D loop and with jsmpeg_tpu's
    ycbcr_to_rgb_int (display size width x height, coded cw x ch)."""
    width, height, cw, ch = size
    rng = np.random.default_rng(width)
    y, cr, cb = _planes(rng, ch, cw)
    got = ycbcr_to_rgb_int(*map(torch.as_tensor, (y, cr, cb)), width, height)
    assert got.dtype == torch.uint8 and got.shape == (height, width, 3)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_color.ycbcr_to_rgb_int(y, cr, cb, width,
                                                           height)))
    if width % 2 == 0 and height % 2 == 0:
        np.testing.assert_array_equal(got.numpy(), _oracle_canvas2d(
            y, cr, cb, width, height))


def test_rec601_within_one_of_jax():
    """Float path: within 1 of jsmpeg_tpu's (float rounding may differ
    at .5); neutral chroma (128) reproduces luma in all channels;
    saturation clamps."""
    rng = np.random.default_rng(8)
    y, cr, cb = _planes(rng, 48, 64)
    got = ycbcr_to_rgb_rec601(*map(torch.as_tensor, (y, cr, cb)), 60, 44)
    want = np.asarray(jax_color.ycbcr_to_rgb_rec601(y, cr, cb, 60, 44))
    assert got.shape == want.shape
    assert np.abs(got.numpy().astype(int) - want.astype(int)).max() <= 1
    yy = torch.full((16, 16), 77, dtype=torch.uint8)
    c = torch.full((8, 8), 128, dtype=torch.uint8)
    assert (ycbcr_to_rgb_rec601(yy, c, c, 16, 16) == 77).all()
    hot = torch.full((8, 8), 255, dtype=torch.uint8)
    rgb2 = ycbcr_to_rgb_rec601(torch.full((16, 16), 235, dtype=torch.uint8),
                               hot, hot, 16, 16)
    assert rgb2[..., 0].max() == 255 and rgb2.min() >= 0


# ------------------------------------------------------------------ sinks

def test_png_round_trips_exactly(tmp_path):
    rng = np.random.default_rng(3)
    rgb = rng.integers(0, 256, (33, 47, 3)).astype(np.uint8)
    p, j = tmp_path / 'x.png', tmp_path / 'j.png'
    write_image(str(p), rgb)
    jax_sinks.write_image(str(j), rgb)
    np.testing.assert_array_equal(read_png(str(p)), rgb)
    assert p.read_bytes() == j.read_bytes()


def test_ppm_path_unchanged(tmp_path):
    rgb = np.arange(2 * 3 * 3, dtype=np.uint8).reshape(2, 3, 3)
    p = tmp_path / 'x.ppm'
    write_image(str(p), rgb)
    assert p.read_bytes() == b'P6\n3 2\n255\n' + rgb.tobytes()


def test_frame_writer_selects_png_by_extension(tmp_path):
    w = PPMWriter(str(tmp_path / 'f_%02d.png'), device='cpu')
    w.resize(32, 16)
    y = torch.full((16, 32), 128, dtype=torch.uint8)
    c = torch.full((8, 16), 128, dtype=torch.uint8)
    w.render(y, c, c)
    w.render(y.numpy(), c.numpy(), c.numpy())
    got = read_png(str(tmp_path / 'f_00.png'))
    assert got.shape == (16, 32, 3)
    # grey Y with neutral chroma -> uniform grey RGB
    assert (got == got[0, 0]).all()
    assert ((tmp_path / 'f_01.png').read_bytes()
            == (tmp_path / 'f_00.png').read_bytes())


def test_poster_png_matches_ppm_pixels(tmp_path):
    rng = np.random.default_rng(4)
    y = rng.integers(0, 256, (16, 32)).astype(np.uint8)
    cr = rng.integers(0, 256, (8, 16)).astype(np.uint8)
    cb = rng.integers(0, 256, (8, 16)).astype(np.uint8)

    def shoot(path):
        inner = VideoCollector()
        inner.resize(32, 16)
        tee = _PosterTee(inner, path, torch.device('cpu'))
        tee.render(torch.as_tensor(y), torch.as_tensor(cr),
                   torch.as_tensor(cb))
        assert inner.frames_rendered == 1

    shoot(str(tmp_path / 'p.png'))
    shoot(str(tmp_path / 'p.ppm'))
    png = read_png(str(tmp_path / 'p.png'))
    ppm = np.frombuffer(
        (tmp_path / 'p.ppm').read_bytes().split(b'255\n', 1)[1],
        np.uint8).reshape(16, 32, 3)
    np.testing.assert_array_equal(png, ppm)
    np.testing.assert_array_equal(png, _oracle_canvas2d(y, cr, cb, 32, 16))


def test_poster_tee_delegates_attributes():
    """The decoder sets frame_rate (and calls resize) on its destination:
    through the tee both reach the wrapped sink."""
    inner = Y4MWriter('unused.y4m')
    tee = _PosterTee(inner, 'unused.ppm', torch.device('cpu'))
    tee.frame_rate = 25.0
    tee.resize(34, 20)
    assert inner.frame_rate == 25.0 and (inner.width, inner.height) == (34,
                                                                        20)
    assert tee.frames_rendered == 0 and tee.frame_rate == 25.0


def test_y4m_and_wav_bytes_equal_jsmpeg_tpu(tmp_path):
    """Y4MWriter (display crop to even size, 4:2:0 order Y, Cb, Cr) and
    WavWriter (int16 with rounding and clipping) write jsmpeg_tpu's bytes,
    from tensors or numpy arrays alike."""
    rng = np.random.default_rng(6)
    ours, theirs = Y4MWriter(str(tmp_path / 'a.y4m'), 29.97), \
        jax_sinks.Y4MWriter(str(tmp_path / 'b.y4m'), 29.97)
    for w in (ours, theirs):
        w.resize(61, 35)
    for k in range(3):
        y, cr, cb = _planes(rng, 48, 64)
        ours.render(*(torch.as_tensor(p) if k % 2 else p
                      for p in (y, cr, cb)))
        theirs.render(y, cr, cb)
    ours.close()
    theirs.close()
    assert (tmp_path / 'a.y4m').read_bytes() == (tmp_path / 'b.y4m'
                                                  ).read_bytes()
    aw, bw = WavWriter(str(tmp_path / 'a.wav')), \
        jax_sinks.WavWriter(str(tmp_path / 'b.wav'))
    for k in range(3):
        lr = (rng.standard_normal((2, 1152)) * 0.7).astype(np.float32)
        lr[:, :8] = [1.5, -1.5, 1.0, -1.0, 0.5 / 32767, -0.5 / 32767, 0, 2]
        aw.play(44100, *(torch.as_tensor(lr) if k % 2 else lr))
        bw.play(44100, lr[0], lr[1])
    aw.close()
    bw.close()
    assert (tmp_path / 'a.wav').read_bytes() == (tmp_path / 'b.wav'
                                                  ).read_bytes()
    with wave.open(str(tmp_path / 'a.wav')) as r:
        assert (r.getnchannels(), r.getnframes()) == (2, 3 * 1152)

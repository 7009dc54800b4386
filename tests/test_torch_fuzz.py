"""Differential fuzz of the port against jsmpeg_tpu on malformed input:
the six cases of tests/test_fuzz_robustness.py (garbage, truncations,
bit corruption, random chunk boundaries, garbage then a valid stream, a
zero picture rate), each run through both packages on the same bytes
and held to equal decoded frames, equal exact-mode PCM (sample counts and
values), and equal frame_rate / decoded_time; plus elementary-stream bit
flips, truncations and duplications through decode_available(eof=True).
Neither side may raise."""

import numpy as np
import pytest

import jsmpeg_tpu.demux as jdemux
import jsmpeg_tpu.models.mp2 as jmp2
import jsmpeg_tpu.models.mpeg1 as jmpeg1
import jsmpeg_tpu_torch.demux as tdemux
import jsmpeg_tpu_torch.models.mp2 as tmp2
import jsmpeg_tpu_torch.models.mpeg1 as tmpeg1
from jsmpeg_tpu_torch.testing.gen import encode_test_stream
from jsmpeg_tpu_torch.testing.mp2_enc import encode_stream
from jsmpeg_tpu_torch.testing.ts_mux import mux_av

# (demux module, mpeg1 module, mp2 module, device options)
JAX = (jdemux, jmpeg1, jmp2, {})
PORT = (tdemux, tmpeg1, tmp2, {'device': 'cpu'})


def _ts_fixture():
    es, chunks = encode_test_stream(96, 64, n_frames=6, seed=31, gop=3)
    _, af = encode_stream(6, seed=32)
    v = chunks[:-1]
    v[-1] += chunks[-1]
    return mux_av(v, 25.0, af, 1152, 44100)


def _frame(p):
    return tuple(np.asarray(x) for x in p)


def _drain(pkg, ts_bytes):
    """tests/test_fuzz_robustness.py's drain: demux everything, then up
    to 40 decode(eof=True) video frames and 40 audio frames."""
    demux, mpeg1, mp2, dev = pkg
    dem = demux.TSDemuxer()
    vid = mpeg1.MPEG1Decoder({'streaming': True, **dev})
    aud = mp2.MP2Decoder({'streaming': True})
    dem.connect(0xE0, vid)
    dem.connect(0xC0, aud)
    dem.write(ts_bytes)
    frames, pcm = [], []
    for _ in range(40):
        p = vid.decode(eof=True)
        if p is None:
            break
        frames.append(_frame(p))
    for _ in range(40):
        a = aud.decode()
        if a is None:
            break
        pcm.append(np.stack([np.asarray(x) for x in a]))
    return frames, pcm, vid.frame_rate, vid.decoded_time


def _same_frames(got, want):
    assert len(got) == len(want), 'frame count'
    for k, (g, w) in enumerate(zip(got, want)):
        for pn, a, b in zip(('y', 'cr', 'cb'), g, w):
            np.testing.assert_array_equal(a, b, err_msg=f'f{k} {pn}')


def _differential(ts_bytes):
    got, want = _drain(PORT, ts_bytes), _drain(JAX, ts_bytes)
    _same_frames(got[0], want[0])
    assert len(got[1]) == len(want[1]), 'audio frame count'
    for g, w in zip(got[1], want[1]):
        np.testing.assert_array_equal(g, w)
    assert got[2:] == want[2:], 'frame_rate / decoded_time'
    return len(got[0])


def test_pure_garbage():
    rng = np.random.default_rng(0)
    _differential(rng.integers(0, 256, 40000, dtype=np.uint8).tobytes())


@pytest.mark.parametrize('frac', [0.07, 0.33, 0.61, 0.94])
def test_truncations(frac):
    ts = _ts_fixture()
    _differential(ts[:int(len(ts) * frac)])


@pytest.mark.parametrize('variant', range(12))
def test_bit_corruption(variant):
    """The twelve 30-byte corruptions of tests/test_fuzz_robustness.py
    (the same generator, drawn in the same order)."""
    ts = bytearray(_ts_fixture())
    rng = np.random.default_rng(7)
    for _ in range(variant + 1):
        corrupted = bytearray(ts)
        for _ in range(30):
            corrupted[int(rng.integers(0, len(ts)))] ^= \
                int(rng.integers(1, 256))
    _differential(bytes(corrupted))


def test_random_chunk_boundaries():
    ts = _ts_fixture()
    outs = []
    for demux, mpeg1, _, dev in (PORT, JAX):
        rng = np.random.default_rng(9)
        dem = demux.TSDemuxer()
        vid = mpeg1.MPEG1Decoder({'streaming': True, **dev})
        dem.connect(0xE0, vid)
        frames = []
        i = 0
        while i < len(ts):
            n = int(rng.integers(1, 700))
            dem.write(ts[i:i + n])
            i += n
            p = vid.decode()
            if p is not None:
                frames.append(_frame(p))
        outs.append((frames, vid.frame_rate, vid.decoded_time))
    _same_frames(outs[0][0], outs[1][0])
    assert outs[0][1:] == outs[1][1:]
    assert len(outs[0][0]) >= 5


def test_garbage_then_valid_stream_recovers():
    """TS resync: after leading garbage, a clean stream still decodes."""
    rng = np.random.default_rng(3)
    junk = rng.integers(0, 256, 3777, dtype=np.uint8).tobytes()
    assert _differential(junk + _ts_fixture()) >= 5


def test_zero_picture_rate_header_survives():
    """The forbidden picture-rate code 0 keeps the previous (default 30)
    rate and a finite clock, in both packages alike."""
    es, _ = encode_test_stream(48, 48, n_frames=2, seed=50, gop=2)
    i = es.index(b'\x00\x00\x01\xb3')
    b = bytearray(es)
    b[i + 7] &= 0xF0                       # picture_rate code -> 0
    outs = []
    for _, mpeg1, _, dev in (PORT, JAX):
        dec = mpeg1.MPEG1Decoder({'streaming': True, **dev})
        dec.write(0.0, bytes(b))
        frames = []
        for _ in range(8):
            p = dec.decode(eof=True)
            if p is None:
                break
            frames.append(_frame(p))
        assert dec.frame_rate == 30.0          # finite fallback kept
        assert np.isfinite(dec.decoded_time)
        outs.append((frames, dec.decoded_time))
    _same_frames(outs[0][0], outs[1][0])
    assert outs[0][1] == outs[1][1]


# ------------------------------------------- elementary-stream variants

def _es_fixture():
    return encode_test_stream(96, 64, n_frames=8, seed=33, gop=4)[0]


def _es_variant(kind, k):
    es = _es_fixture()
    rng = np.random.default_rng(100 + k)
    body = es.index(b'\x00\x00\x01\x00')   # first picture start code
    if kind == 'bitflip':
        b = bytearray(es)
        for _ in range(4 + 2 * k):
            pos = int(rng.integers(body, len(b)))
            b[pos] ^= 1 << int(rng.integers(0, 8))
        return bytes(b)
    if kind == 'truncate':
        return es[:body + int((len(es) - body) * (0.15 + 0.2 * k))]
    # duplicate: the whole stream twice, or a span of it repeated
    if k == 0:
        return es + es
    a = int(rng.integers(body, len(es) - 64))
    n = int(rng.integers(16, 400))
    return es[:a + n] + es[a:]


def _decode_available(pkg, es):
    _, mpeg1, _, dev = pkg
    dec = mpeg1.MPEG1Decoder(dev)
    dec.write(0.0, es)
    fs = dec.decode_available(eof=True)
    return [_frame(p) for p in fs] if fs is not None else [], \
        dec.decoded_time


@pytest.mark.parametrize('kind,k', [('bitflip', k) for k in range(8)]
                         + [('truncate', k) for k in range(4)]
                         + [('duplicate', k) for k in range(3)])
def test_es_variants_decode_available(kind, k):
    es = _es_variant(kind, k)
    (got, t_got), (want, t_want) = (_decode_available(PORT, es),
                                    _decode_available(JAX, es))
    _same_frames(got, want)
    assert t_got == t_want

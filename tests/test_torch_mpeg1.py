"""The port's MPEG1Decoder on the CPU (plain versions of both kernels)
against the independent oracle decoder and against jsmpeg_tpu's decoder,
bit-exactly on every plane of every frame: the cases of
tests/test_mpeg1_differential.py and tests/test_quirk_leak.py, through
the batch path (packed wire, dense-levels fallback) and the serial
path."""

import numpy as np
import pytest
import torch

from jsmpeg_tpu.host.native import NativeMPEG1Parser as JaxNativeParser
from jsmpeg_tpu.models.mpeg1 import MPEG1Decoder as JaxDecoder
from jsmpeg_tpu_torch.host.native import NativeMPEG1Parser
from jsmpeg_tpu_torch.models.mpeg1 import MPEG1Decoder
from jsmpeg_tpu_torch.ops import kernels
from jsmpeg_tpu_torch.testing.gen import (encode_realistic_stream,
                                          encode_test_stream)
from jsmpeg_tpu_torch.testing.quirks import escape_zero_stream
from tests.oracle.ref_mpeg1 import OracleMPEG1

CPU = {'device': 'cpu'}

# name -> (encoder, size, encoder kwargs, decode mode)
CASES = {
    'intra_only': (encode_test_stream, (96, 64),
                   dict(n_frames=3, seed=1, gop=1), 'batch'),
    'ip_gop': (encode_test_stream, (96, 64),
               dict(n_frames=8, seed=2, gop=4), 'batch'),
    'fcode1': (encode_test_stream, (80, 48),
               dict(n_frames=6, seed=3, gop=3, f_code=1), 'batch'),
    'fcode3': (encode_test_stream, (128, 96),
               dict(n_frames=6, seed=4, gop=6, f_code=3), 'batch'),
    'custom_matrices': (encode_test_stream, (64, 48),
                        dict(n_frames=5, seed=5, gop=2,
                             custom_matrices=True, qscale=4), 'batch'),
    'non_mb_aligned': (encode_test_stream, (100, 70),
                       dict(n_frames=4, seed=6, gop=2), 'batch'),
    'single_frame': (encode_test_stream, (64, 48),
                     dict(n_frames=5, seed=7, gop=5), 'single'),
    'full_pel': (encode_test_stream, (96, 64),
                 dict(n_frames=8, seed=21, gop=4, full_pel=True), 'batch'),
    'full_pel_single': (encode_test_stream, (80, 48),
                        dict(n_frames=6, seed=22, gop=3, full_pel=True,
                             f_code=3), 'single'),
    'saturation': (encode_test_stream, (48, 32),
                   dict(n_frames=4, seed=8, gop=2, qscale=31), 'batch'),
    'realistic': (encode_realistic_stream, (96, 128),
                  dict(n_frames=8, seed=17, gop=4), 'batch'),
    'tiny_test': (encode_test_stream, (16, 16),
                  dict(n_frames=3, seed=5, gop=2), 'batch'),
    'tiny_realistic': (encode_realistic_stream, (16, 16),
                       dict(n_frames=3, seed=5, gop=2), 'batch'),
    'python_parser': (encode_test_stream, (80, 48),
                      dict(n_frames=8, seed=29, gop=4, full_pel=True,
                           b_stubs=True, stuffing=True,
                           midstream_headers=True), 'python'),
}


def _decode(dec, es, mode):
    dec.write(0.0, es)
    if mode == 'single':
        outs = []
        while (p := dec.decode(eof=True)) is not None:
            outs.append(p)
        return outs
    return list(dec.decode_available(eof=True) or [])


def _as_numpy(p):
    return tuple(np.asarray(x) for x in p)


def _check(es, mode='batch'):
    """Port (CPU) == oracle == jsmpeg_tpu, frame by frame."""
    golden = OracleMPEG1(es).decode_all()
    opts = dict(CPU, native=False) if mode == 'python' else CPU
    got = [_as_numpy(p) for p in _decode(MPEG1Decoder(opts), es, mode)]
    jax_opts = {'native': False} if mode == 'python' else {}
    want = [_as_numpy(p) for p in _decode(JaxDecoder(jax_opts), es,
                                          'batch' if mode == 'python'
                                          else mode)]
    assert len(got) == len(golden) == len(want)
    for i, (g, o, j) in enumerate(zip(got, golden, want)):
        for name, a, b, c in zip(('y', 'cr', 'cb'), g, o, j):
            assert a.dtype == np.uint8
            np.testing.assert_array_equal(a, b, err_msg=f'oracle f{i} {name}')
            np.testing.assert_array_equal(a, c, err_msg=f'jax f{i} {name}')
    return len(got)


@pytest.mark.parametrize('case', sorted(CASES))
def test_decoder_matches_oracle_and_jax(case):
    enc, (w, h), kw, mode = CASES[case]
    es, _ = enc(w, h, **kw)
    assert _check(es, mode) == kw['n_frames']


@pytest.mark.parametrize('mode', ['batch', 'single'])
def test_dense_levels_fallback(monkeypatch, mode):
    """A packed-cap overflow drops the batch to the dense-levels wire
    (both packages patched alike), batch and single-frame."""
    monkeypatch.setattr(NativeMPEG1Parser, 'SPARSE_CAP_PER_BLOCK', 1)
    monkeypatch.setattr(JaxNativeParser, 'SPARSE_CAP_PER_BLOCK', 1)
    es, _ = encode_test_stream(96, 64, n_frames=3, seed=2, gop=3)
    p = NativeMPEG1Parser()
    p.write(es)
    batch = p.parse_batch(4, eof=True)
    assert 'levels' in batch and 'sp_pos' not in batch
    assert _check(es, mode) == 3


@pytest.mark.parametrize('native', [True, False])
def test_escape_zero_serial_fallback(native):
    """An escape-coded zero level sends the batch path to the serial path
    (native parser) -- the Python parser always decodes serially."""
    es = escape_zero_stream()
    if native:
        p = NativeMPEG1Parser()
        p.write(es)
        assert p.parse_batch(4, eof=True) == 'fallback'
    assert _check(es, 'batch' if native else 'python') == 2


class _Sink:
    def __init__(self):
        self.frames, self.size = [], None

    def resize(self, w, h):
        self.size = (w, h)

    def render(self, y, cr, cb):
        self.frames.append(tuple(np.array(x) for x in (y, cr, cb)))


def test_release_mode_multi_batch(monkeypatch):
    """retain=False renders every batch in stream order and keeps only
    the count; several batches (BATCH_FRAMES lowered) thread the carry."""
    monkeypatch.setattr(MPEG1Decoder, 'BATCH_FRAMES', 4)
    es, _ = encode_realistic_stream(96, 128, n_frames=11, seed=29, gop=8)
    golden = OracleMPEG1(es).decode_all()
    dec = MPEG1Decoder(CPU)
    sink = _Sink()
    dec.connect(sink)
    dec.write(0.0, es)
    outs = dec.decode_available(eof=True, retain=False)
    assert len(outs) == len(sink.frames) == len(golden) == 11
    assert sink.size == (96, 128)
    with pytest.raises(IndexError):
        outs[0]
    for i, (got, want) in enumerate(zip(sink.frames, golden)):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b, err_msg=f'frame {i}')
    with pytest.raises(ValueError):
        MPEG1Decoder(CPU).decode_available(retain=False)


def test_decode_first_frame_and_timestamps():
    """decodeFirstFrame renders picture 0 as soon as the sequence header
    and a whole picture have arrived; timestamps follow jsmpeg_tpu's
    decoder through decode and seek."""
    es, chunks = encode_test_stream(64, 48, n_frames=6, seed=3, gop=3,
                                    frame_rate=25.0)
    golden = OracleMPEG1(es).decode_all()
    sink = _Sink()
    first = MPEG1Decoder(dict(CPU, decodeFirstFrame=True))
    first.connect(sink)
    first.write(0.0, es)
    assert len(sink.frames) == 1 and first.frames_decoded == 1
    for a, b in zip(sink.frames[0], golden[0]):
        np.testing.assert_array_equal(a, b)

    dec, jdec = MPEG1Decoder(CPU), JaxDecoder()
    for i, c in enumerate(chunks):
        dec.write(i / 25.0, c)
        jdec.write(i / 25.0, c)
    for _ in range(2):
        dec.decode(eof=True)
        jdec.decode(eof=True)
    assert dec.current_time == pytest.approx(jdec.current_time)
    dec.seek(0.1)
    jdec.seek(0.1)
    assert dec.current_time == pytest.approx(jdec.current_time)
    p, jp = dec.decode(eof=True), jdec.decode(eof=True)
    np.testing.assert_array_equal(p.y.numpy(), np.asarray(jp.y))
    assert dec.current_time == pytest.approx(jdec.current_time)


def test_reserved_picture_rate_keeps_default():
    """A forbidden picture-rate code keeps the 30 fps default instead of
    dividing by zero (models/mpeg1.py's documented deviation)."""
    es, _ = encode_test_stream(48, 32, n_frames=2, seed=4, gop=2)
    es = bytearray(es)
    assert es[:4] == b'\x00\x00\x01\xb3'
    es[7] &= 0xF0                          # picture_rate_code = 0
    es = bytes(es)
    dec, jdec = MPEG1Decoder(CPU), JaxDecoder()
    assert _decode(dec, es, 'batch') and _decode(jdec, es, 'batch')
    assert dec.frame_rate == jdec.frame_rate == 30.0
    assert dec.current_time == pytest.approx(jdec.current_time)


def test_cpu_decoder_launches_no_kernel():
    es, _ = encode_test_stream(48, 32, n_frames=3, seed=9, gop=3)
    kernels.reset_launches()
    outs = _decode(MPEG1Decoder(CPU), es, 'batch')
    assert len(outs) == 3 and outs[0].y.device == torch.device('cpu')
    assert kernels.launches == {'dequant_idct': 0, 'mc_combine': 0}

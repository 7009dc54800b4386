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
from jsmpeg_tpu_torch.models.mpeg1 import MPEG1Decoder, PlanesBatch
from jsmpeg_tpu_torch.ops.frame import Planes
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


def test_duplicate_slice_falls_back_to_serial():
    """A duplicated slice codes the same blocks twice, which the packed
    pair wire cannot express (tests/test_fuzz_parsers.py): the batch
    parse refuses it ('fallback') and the decoder's serial path
    overwrites the re-coded blocks as the reference does -- equal to the
    oracle and to jsmpeg_tpu."""
    es, _ = encode_test_stream(96, 64, n_frames=1, seed=3, gop=1)
    starts = [i for i in range(len(es) - 3)
              if es[i:i + 3] == b'\x00\x00\x01' and 0x01 <= es[i + 3] <= 0xAF]
    last_slice = starts[-1]
    end = es.find(b'\x00\x00\x01\xb7', last_slice)
    dup = es[:end] + es[last_slice:end] + es[end:]
    p = NativeMPEG1Parser()
    p.write(dup)
    assert p.parse_batch(4, eof=True) == 'fallback'
    assert _check(dup) == 1


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
    assert kernels.launches == {'dequant_idct': 0, 'mc_combine': 0,
                                'wire_unpack': 0}


@pytest.mark.parametrize('n_frames', [1, 3])
def test_planes_batch_fetch_all(n_frames):
    """A PlanesBatch hands out frame k as views at byte offset k * plane
    size of the batch tensors, and fetch_all copies each batch tensor to
    the host whole."""
    rng = np.random.default_rng(31)
    batch = Planes(*[torch.as_tensor(rng.integers(0, 256, (n_frames, h, w),
                                                  dtype=np.uint8))
                     for h, w in ((32, 48), (16, 24), (16, 24))])
    pb = PlanesBatch(batch)
    assert len(pb) == len(list(pb)) == n_frames
    for k, frame in enumerate(pb):
        for x, p in zip(frame, batch):
            assert x._base is p
            assert x.data_ptr() == p.data_ptr() + k * p[0].numel()
    assert pb[-1].y.data_ptr() == pb[n_frames - 1].y.data_ptr()
    with pytest.raises(IndexError):
        pb[n_frames]
    got = pb.fetch_all()
    for g, want in zip(got, batch):
        assert isinstance(g, np.ndarray) and g.shape == tuple(want.shape)
        np.testing.assert_array_equal(g, want.numpy())


def _coded_blocks_per_batch(es):
    p = NativeMPEG1Parser()
    p.write(es)
    out = []
    while isinstance(b := p.parse_batch(MPEG1Decoder.BATCH_FRAMES,
                                        eof=True), dict):
        out.append(b['n_blocks'])
        if b['n'] < MPEG1Decoder.BATCH_FRAMES:
            break
    return out


def test_packed_batches_run_the_compact_form(monkeypatch):
    """Every packed batch of the batch path reaches K1 in its compact
    form, one call a batch over exactly the batch's coded blocks (the
    parse's count, every row named); no dense K1 call; the frames equal
    the oracle's and jsmpeg_tpu's."""
    from tests.test_torch_unpack import k1_calls
    es, _ = encode_realistic_stream(96, 128, n_frames=40, seed=17, gop=4)
    calls = k1_calls(monkeypatch)
    assert _check(es) == 40
    coded = _coded_blocks_per_batch(es)
    assert len(coded) == 2 and all(coded)
    assert calls == [('compact', n, n) for n in coded]


@pytest.mark.parametrize('pattern', [0x7FFFFFFF, -0x80000000])
def test_uncoded_residual_slots_are_never_read(monkeypatch, pattern):
    """K1's compact form writes the coded blocks' residuals only (on the
    card into `torch.empty`): with every uncoded residual slot of every
    batch set to `pattern`, the plain frame loop's frames equal the
    unpoisoned decode's, the oracle's and jsmpeg_tpu's."""
    from jsmpeg_tpu_torch.models import mpeg1
    es, _ = encode_realistic_stream(96, 128, n_frames=8, seed=17, gop=4)
    clean = [_as_numpy(p) for p in _decode(MPEG1Decoder(CPU), es, 'batch')]
    real, poisoned = mpeg1.levels_blocks, []

    def poison(la, *q):
        resid, meta = real(la, *q)
        assert la.blk_ids is not None
        uncoded = ~la.coded[..., None].expand_as(resid)
        poisoned.append(int(uncoded.sum()))
        return resid.masked_fill(uncoded, pattern), meta

    monkeypatch.setattr(mpeg1, 'levels_blocks', poison)
    assert _check(es) == 8
    got = [_as_numpy(p) for p in _decode(MPEG1Decoder(CPU), es, 'batch')]
    for g, c in zip(got, clean):
        for a, b in zip(g, c):
            np.testing.assert_array_equal(a, b)
    assert poisoned and all(poisoned)

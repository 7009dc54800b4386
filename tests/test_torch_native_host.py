"""The port's C++ host code held to its pure-Python twins, on the port's
own build (`build/jsmpeg_tpu_torch/`): the TS demuxer (ts_demux.cpp vs
demux.TSDemuxer's Python path) delivers byte-identical PES packets and
equal counters on clean, chunked, corrupted and garbage-prefixed input;
the MPEG1 parser (frontend.cpp vs host.mpeg1_parse.MPEG1Parser) gives
identical frames whole, chunked and incremental, the same sequence
header, and a packed wire that rebuilds its dense-levels slab exactly.
Where both are fed whole writes, jsmpeg_tpu's Python parser witnesses
the same frames and header.  The cases of tests/test_native_ts.py and
tests/test_native_parser.py."""

import numpy as np
import pytest

from jsmpeg_tpu.host.mpeg1_parse import MPEG1Parser as RefMPEG1Parser
from jsmpeg_tpu_torch.demux import TSDemuxer
from jsmpeg_tpu_torch.host.mpeg1_parse import MPEG1Parser
from jsmpeg_tpu_torch.host.native import NativeMPEG1Parser
from jsmpeg_tpu_torch.testing.gen import encode_test_stream
from jsmpeg_tpu_torch.testing.mp2_enc import encode_stream as mp2_stream
from jsmpeg_tpu_torch.testing.ts_mux import mux_av


# ------------------------------------------------------------------ TS demux

class Collector:
    def __init__(self):
        self.items = []

    def write(self, pts, buffers):
        self.items.append((round(pts, 9), b''.join(bytes(b)
                                                   for b in buffers)))


def _run_ts(ts: bytes, chunks=None, streams=(0xE0, 0xC0)):
    outs = []
    for native in (False, True):
        dem = TSDemuxer({'native': native})
        assert (dem._native is not None) == native
        cols = {}
        for sid in streams:
            cols[sid] = Collector()
            dem.connect(sid, cols[sid])
        for c in (chunks or [ts]):
            dem.write(c)
        dem.flush()
        outs.append((cols, dem.packets_parsed, dem.resyncs,
                     round(dem.current_time, 9)))
    (py, pp, pr, pt), (nat, np_, nr, nt) = outs
    assert pp == np_ and pr == nr and pt == nt, (pp, np_, pr, nr, pt, nt)
    for sid in streams:
        assert py[sid].items == nat[sid].items, f'stream {sid} differs'
    return py


def _make_av_ts():
    es, chunks = encode_test_stream(64, 48, n_frames=6, seed=5, gop=3,
                                    frame_rate=25.0)
    aes, aframes = mp2_stream(4, seed=6)
    v = chunks[:-1]
    v[-1] = v[-1] + chunks[-1]
    return mux_av(v, 25.0, aframes, 1152, 44100)


def test_ts_clean_av_stream():
    py = _run_ts(_make_av_ts())
    assert py[0xE0].items and py[0xC0].items


@pytest.mark.parametrize('chunk_size', [1, 7, 188, 189, 1000])
def test_ts_chunked_writes(chunk_size):
    ts = _make_av_ts()
    chunks = [ts[i:i + chunk_size] for i in range(0, len(ts), chunk_size)]
    assert _run_ts(ts, chunks=chunks)[0xE0].items


def test_ts_garbage_prefix_resync():
    ts = _make_av_ts()
    garbage = np.random.default_rng(0).integers(0, 256, 401).astype(
        np.uint8).tobytes().replace(b'\x47', b'\x48')
    assert _run_ts(garbage + ts)[0xE0].items


def test_ts_corrupted_packets():
    ts = bytearray(_make_av_ts())
    rng = np.random.default_rng(1)
    # flip bytes inside some packets and destroy a few sync bytes
    for _ in range(40):
        ts[int(rng.integers(0, len(ts)))] = int(rng.integers(0, 256))
    for k in (5, 11, 12):
        if k * 188 < len(ts):
            ts[k * 188] = 0x00
    _run_ts(bytes(ts))


def test_ts_unconnected_streams_ignored():
    assert _run_ts(_make_av_ts(), streams=(0xE0,))[0xE0].items


# ------------------------------------------------------------- MPEG1 parser

def _frames(parser, es, chunked=False):
    if chunked:
        for i in range(0, len(es), 777):
            parser.write(es[i:i + 777])
    else:
        parser.write(es)
    out = []
    while True:
        fd = parser.parse_frame(eof=True)
        if fd is None:
            break
        out.append(fd)
    return out


def _same_frames(py, nat):
    assert len(py) == len(nat) > 0
    for i, (a, b) in enumerate(zip(py, nat)):
        assert a.pic_type == b.pic_type
        np.testing.assert_array_equal(a.coef, b.coef,
                                      err_msg=f'frame {i} coef')
        np.testing.assert_array_equal(a.coded, b.coded)
        np.testing.assert_array_equal(a.intra, b.intra)
        np.testing.assert_array_equal(a.written, b.written)
        np.testing.assert_array_equal(a.mv, b.mv)


@pytest.mark.parametrize('kw', [
    dict(w=96, h=64, n_frames=6, seed=2, gop=3),
    dict(w=80, h=48, n_frames=6, seed=3, gop=3, f_code=1),
    dict(w=64, h=48, n_frames=5, seed=5, gop=2, custom_matrices=True),
    dict(w=100, h=70, n_frames=4, seed=6, gop=2),
    dict(w=48, h=32, n_frames=4, seed=8, gop=2, qscale=31),
])
def test_parser_native_matches_python(kw):
    kw = dict(kw)
    es, _ = encode_test_stream(kw.pop('w'), kw.pop('h'), **kw)
    py = _frames(MPEG1Parser(), es)
    _same_frames(py, _frames(NativeMPEG1Parser(), es))
    _same_frames(_frames(RefMPEG1Parser(), es), py)


def test_parser_chunked_writes():
    es, _ = encode_test_stream(64, 48, n_frames=6, seed=11, gop=2)
    py = _frames(MPEG1Parser(), es)
    _same_frames(py, _frames(NativeMPEG1Parser(), es, chunked=True))
    _same_frames(_frames(RefMPEG1Parser(), es), py)


def test_parser_incremental_parse():
    """parse_frame(eof=False) refuses until a whole picture is in."""
    es, _ = encode_test_stream(48, 32, n_frames=3, seed=13, gop=3)
    p = NativeMPEG1Parser()
    p.write(es[:100])
    assert p.parse_frame(eof=False) is None
    p.write(es[100:])
    assert len(_frames(p, b'')) == 3


def test_parser_seq_info_matches():
    es, _ = encode_test_stream(100, 70, n_frames=1, seed=1, gop=1,
                               custom_matrices=True)
    py = MPEG1Parser()
    py.write(es)
    nat = NativeMPEG1Parser()
    nat.write(es)
    ref = RefMPEG1Parser()
    ref.write(es)
    assert py.seq.width == nat.seq.width == ref.seq.width == 100
    assert py.seq.height == nat.seq.height == ref.seq.height == 70
    assert py.seq.mb_width == nat.seq.mb_width == ref.seq.mb_width
    assert py.seq.mb_height == nat.seq.mb_height == ref.seq.mb_height
    assert py.seq.frame_rate == nat.seq.frame_rate == ref.seq.frame_rate
    for name in ('intra_quant_matrix', 'non_intra_quant_matrix'):
        np.testing.assert_array_equal(getattr(py.seq, name),
                                      getattr(nat.seq, name))
        np.testing.assert_array_equal(getattr(ref.seq, name),
                                      getattr(py.seq, name))


def test_parser_packed_wire_matches_dense():
    """The packed wire (RLE flags/cbp/mv runs + pos/val pairs with slot
    flags) rebuilds exactly the dense levels slab."""
    es, _ = encode_test_stream(96, 64, n_frames=6, seed=7, gop=3)
    pa = NativeMPEG1Parser()
    pa.write(es)
    packed = pa.parse_batch(8, eof=True, packed=True)
    pb = NativeMPEG1Parser()
    pb.write(es)
    dense = pb.parse_batch(8, eof=True, sparse=False, packed=False)
    assert isinstance(packed, dict) and isinstance(dense, dict)
    assert packed['n'] == dense['n'] == 6
    n_mb = pa.seq.mb_size
    # expand metadata runs (the device-side expansion, written out)
    reps = packed['run_len'].astype(np.int64)
    assert reps.sum() == packed['n'] * n_mb
    pad = (8 - packed['n']) * n_mb
    flags = np.concatenate([np.repeat(packed['run_flags'], reps),
                            np.zeros(pad, np.uint8)]).reshape(8, n_mb)
    cbp = np.concatenate([np.repeat(packed['run_cbp'], reps),
                          np.zeros(pad, np.uint8)]).reshape(8, n_mb)
    mv16 = np.concatenate([np.repeat(packed['run_mv'], reps, axis=0),
                           np.zeros((pad, 2), np.int16)]).reshape(8, n_mb, 2)
    np.testing.assert_array_equal(flags & 31, dense['qscale'] & 31)
    np.testing.assert_array_equal((flags >> 5) & 1, dense['intra'])
    np.testing.assert_array_equal((flags >> 6) & 1, dense['written'])
    for b in range(6):
        np.testing.assert_array_equal((cbp >> b) & 1, dense['coded'][..., b])
    np.testing.assert_array_equal(mv16.astype(np.int32), dense['mv'])
    # coefficients (the device-side unpack, written out)
    coded = np.stack([(cbp >> b) & 1 for b in range(6)], -1).astype(bool)
    blk_ids = np.flatnonzero(coded.reshape(-1))
    assert len(blk_ids) == packed['n_blocks']
    slot = np.cumsum(packed['sp_pos'] >> 7) - 1
    ok = (packed['sp_pos'] & 0x40) == 0
    levels = np.zeros((8, n_mb, 6, 64), np.int16)
    # values: an int8 stream with -128 escaping to the int16 side stream
    esc_mask = packed['sp_v8'] == -128
    assert esc_mask.sum() == len(packed['sp_esc'])
    vals = packed['sp_v8'].astype(np.int16)
    vals[esc_mask] = packed['sp_esc']
    levels.reshape(-1)[blk_ids[slot[ok]] * 64
                       + (packed['sp_pos'][ok] & 63)] = vals[ok]
    np.testing.assert_array_equal(levels, dense['levels'])

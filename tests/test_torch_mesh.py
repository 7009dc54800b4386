"""The port's GOP mesh on the CPU (jsmpeg_tpu_torch.parallel.{mesh, gop,
packed, tiles}, MPEG1Decoder.decode_available(mesh=), PlayerConfig.mesh,
the CLI's --mesh and decode_streams_mesh), case for case
tests/test_gop_parallel.py, tests/test_packed_mesh.py,
tests/test_fuzz_mesh.py and the mesh cases of tests/test_multistream.py
and tests/test_cli.py.  Every frame equals, with tolerance 0, jsmpeg_tpu's
same call on the same bytes (on the eight virtual CPU devices of
tests/conftest.py) and the port's serial decode.

The port's meshes here are make_mesh(..., device='cpu'): the cells take
the one CPU device in turn, so each device's GOPs decode as the segments
of one launch pair (the plain versions of K1 and K2 on the CPU).  Two
device objects that name the CPU ('cpu' and 'cpu:0') stand for two
devices where a case needs GOP rows on distinct devices.

test_elastic_prefix_fallback_on_open_gop is mirrored in
tests/test_torch_multihost.py, the tiled shapes on distinct devices in
tests/test_torch_tiles.py."""

import re

import numpy as np
import pytest
import torch

from jsmpeg_tpu.host import best_parser as jbest_parser
from jsmpeg_tpu.host.mpeg1_parse import MPEG1Parser as JParser
from jsmpeg_tpu.models.mpeg1 import MPEG1Decoder as JDecoder
from jsmpeg_tpu.parallel import gop as jgop
from jsmpeg_tpu.parallel import packed as jpacked
from jsmpeg_tpu.parallel import streams as jstreams
from jsmpeg_tpu.parallel import tiles as jtiles
from jsmpeg_tpu.parallel.mesh import make_mesh as jmake_mesh
from jsmpeg_tpu_torch.host import best_parser
from jsmpeg_tpu_torch.host.mpeg1_parse import MPEG1Parser
from jsmpeg_tpu_torch.models.mpeg1 import MPEG1Decoder
from jsmpeg_tpu_torch.parallel import gop, packed, streams, tiles
from jsmpeg_tpu_torch.parallel.mesh import Mesh, make_mesh, resolve_mesh
from jsmpeg_tpu_torch.parallel.packed import (MeshPackedDecoder,
                                              decode_packed_mesh, gop_closed,
                                              gops_all_closed,
                                              split_packed_frames)
from jsmpeg_tpu_torch.parallel.streams import decode_streams_mesh
from jsmpeg_tpu_torch.testing.gen import (encode_realistic_stream,
                                          encode_test_stream)
from jsmpeg_tpu_torch.testing.ts_mux import TSMuxer
from tests.test_torch_multistream import _edge_stream

CPU = {'device': 'cpu'}


def _np(frames):
    return [tuple(np.asarray(x) for x in p) for p in frames]


def _equal(got, want, what):
    assert len(got) == len(want), f'{what}: {len(got)} vs {len(want)} frames'
    for k, (g, w) in enumerate(zip(got, want)):
        for pn, a, b in zip(('y', 'cr', 'cb'), g, w):
            np.testing.assert_array_equal(a, b, err_msg=f'{what} f{k} {pn}')


def _serial(es):
    """The port's single-device decode (held to jsmpeg_tpu and the oracle
    by tests/test_torch_mpeg1.py)."""
    d = MPEG1Decoder(CPU)
    d.write(0.0, es)
    return _np(d.decode_available(eof=True))


def _jax_serial(es, mesh=None):
    d = JDecoder()
    d.write(0.0, es)
    return _np(d.decode_available(eof=True, mesh=mesh))


def _packed_frames(es, parser):
    parser.write(es)
    frames = []
    while True:
        b = parser.parse_batch(32, eof=True)
        if b is None:
            break
        frames.extend(split_packed_frames(b))
        if b['n'] < 32:
            break
    return frames, parser.seq


@pytest.fixture
def launches(monkeypatch):
    """Every decode_levels call of the mesh and fleet paths (one K1 and
    one K2 launch on the card): (frames, n_seg, seg_frames, device)."""
    calls = []
    real = streams.decode_levels

    def counting(cur, fwd, la, *a, **kw):
        seg = kw.get('seg_frames')
        calls.append((la.qscale.shape[0], kw.get('n_seg', 1),
                      None if seg is None else list(seg),
                      str(cur.y.device)))
        return real(cur, fwd, la, *a, **kw)

    monkeypatch.setattr(streams, 'decode_levels', counting)
    return calls


# ------------------------------------------------ tests/test_gop_parallel.py

def _parse_all(es, parser):
    parser.write(es)
    frames = []
    while (fd := parser.parse_frame(eof=True)) is not None:
        frames.append(fd)
    return parser.seq, frames


@pytest.mark.parametrize('case', ['matches_serial', 'uneven_gops'])
def test_gop_parallel(case, monkeypatch):
    """decode_gop_parallel (the serially parsed route): 8 GOPs of 2 over
    8 cells, and GOPs of 3, 3, 3, 1 over a 4x2 mesh; the GOPs of the one
    device go as the segments of ONE decode_coef call."""
    w, h, n, seed, g, shape = ((64, 48, 16, 31, 2, (8, 1))
                               if case == 'matches_serial'
                               else (48, 32, 10, 32, 3, (4, 2)))
    es, _ = encode_test_stream(w, h, n_frames=n, seed=seed, gop=g)
    seq, frames = _parse_all(es, MPEG1Parser())
    calls = []
    real = gop.decode_coef

    def counting(cur, fwd, f, **kw):
        calls.append((kw['n_seg'], list(kw['seg_frames'])))
        return real(cur, fwd, f, **kw)

    monkeypatch.setattr(gop, 'decode_coef', counting)
    par = gop.decode_gop_parallel(frames, seq.mb_height, seq.mb_width,
                                  make_mesh(*shape, device='cpu'))
    lengths = [len(x) for x in gop.split_gops(frames)]
    assert calls == [(len(lengths), lengths)]
    jseq, jframes = _parse_all(es, JParser())
    want = _np(jgop.decode_gop_parallel(jframes, jseq.mb_height,
                                        jseq.mb_width, jmake_mesh(*shape)))
    assert len(par) == n
    _equal(_np(par), want, 'vs jsmpeg_tpu')
    _equal(_np(par), _serial(es), 'vs serial')


# ------------------------------------------------ tests/test_packed_mesh.py

@pytest.fixture(scope='module')
def stream():
    # 96x128: mb grid 6x8 -- n_tile=4 keeps 2 MB rows/tile (= halo for
    # f_code=2); 10 frames over gop=4 gives 3 GOPs of unequal length
    es, _ = encode_realistic_stream(96, 128, n_frames=10, seed=11, gop=4)
    return es, _serial(es)


@pytest.mark.parametrize('shape', [(8, 1), (4, 2), (2, 4), (1, 2)])
def test_mesh_bit_exact(stream, shape, launches):
    es, ref = stream
    got = _np(decode_packed_mesh(es, make_mesh(*shape, device='cpu')))
    _equal(got, ref, f'{shape} vs serial')
    _equal(got, _np(jpacked.decode_packed_mesh(es, jmake_mesh(*shape))),
           f'{shape} vs jsmpeg_tpu')
    # one device: ONE launch pair, the 3 GOPs as its segments
    assert launches == [(4, 3, [4, 4, 2], 'cpu')]


def _ts(es):
    mux = TSMuxer()
    mux.add_access_unit(0x100, 0xE0, es, 0.0, bounded=True)
    return mux.getvalue()


def test_player_offline_mesh(stream):
    """Player.decode_offline with cfg.mesh: the same rendered frames as
    the serial path, including the decodeFirstFrame preview (which
    leaves the parser mid-GOP, exercising the carry init)."""
    from jsmpeg_tpu.player import Player as JPlayer
    from jsmpeg_tpu.sinks import VideoCollector as JCollector
    from jsmpeg_tpu_torch.player import Player
    from jsmpeg_tpu_torch.sinks import VideoCollector
    es, ref = stream
    ts = _ts(es)
    vc, jvc = VideoCollector(), JCollector()
    p = Player(ts, {'audio': False, 'mesh': '4x2', 'device': 'cpu'},
               renderer=vc)
    n_video, _ = p.decode_offline()
    assert n_video == len(ref)
    jn, _ = JPlayer(ts, {'audio': False, 'mesh': '4x2'},
                    renderer=jvc).decode_offline()
    assert jn == n_video
    _equal(vc.frames[-len(ref):], ref, 'vs serial')
    _equal(vc.frames, _np(jvc.frames), 'vs jsmpeg_tpu')


def _read_y4m(path, w, h):
    body = path.read_bytes().partition(b'\n')[2]
    n_y, n_c = w * h, (w // 2) * (h // 2)
    out = []
    for fr in body.split(b'FRAME\n')[1:]:
        a = np.frombuffer(fr, np.uint8)
        out.append((a[:n_y].reshape(h, w),
                    a[n_y + n_c:].reshape(h // 2, w // 2),
                    a[n_y:n_y + n_c].reshape(h // 2, w // 2)))
    return out


def test_cli_offline_mesh(stream, tmp_path):
    """--offline --mesh 2x2: the y4m is jsmpeg_tpu's CLI's byte for byte
    and its frames the serial decode's."""
    from jsmpeg_tpu.__main__ import main as jmain
    from jsmpeg_tpu_torch.__main__ import main
    es, ref = stream
    ts_path = tmp_path / 'clip.ts'
    ts_path.write_bytes(_ts(es))
    args = [str(ts_path), '--offline', '--mesh', '2x2', '--no-audio', '-o']
    assert main(args + [str(tmp_path / 'out.y4m'), '--device', 'cpu']) == 0
    assert jmain(args + [str(tmp_path / 'jax.y4m')]) == 0
    assert ((tmp_path / 'out.y4m').read_bytes()
            == (tmp_path / 'jax.y4m').read_bytes())
    _equal(_read_y4m(tmp_path / 'out.y4m', 96, 128), ref, 'y4m vs serial')


def _dense_mixed_stream():
    """32 sparse I/P frames (one packed batch) followed by an all-dense
    intra GOP that overflows the packed caps (every block carries 64
    coefficients) -> the parser's dense retry."""
    from jsmpeg_tpu_torch.testing.bitwriter import BitWriter
    from jsmpeg_tpu_torch.testing.mpeg1_enc import MB, MPEG1Encoder
    es, _ = encode_test_stream(48, 48, n_frames=32, seed=41, gop=8)
    es = es[:-4]                             # drop sequence_end
    enc = MPEG1Encoder(48, 48, qscale=1)
    enc._temporal_ref = 32
    rng = np.random.default_rng(5)
    parts = [es]
    for _ in range(4):
        enc.w = BitWriter()
        mbs = []
        for _ in range(enc.mb_w * enc.mb_h):
            levels = []
            for b in range(6):
                lv = rng.integers(1, 4, 64) * rng.choice((-1, 1), 64)
                lv[0] = int(rng.integers(1, 200))
                levels.append(lv)
            mbs.append(MB('intra', levels=levels))
        enc.encode_picture(1, mbs)           # I picture
        parts.append(enc.getvalue())
    parts.append(b'\x00\x00\x01\xb7')
    return b''.join(parts)


def test_mesh_dense_fallback_mid_stream(launches):
    """A coefficient-dense batch mid-stream flushes the queue and decodes
    on the decoder's device while packed GOPs ride the mesh; the carry
    threads through both."""
    es = _dense_mixed_stream()
    p = best_parser()
    p.write(es)
    kinds = []
    while isinstance(b := p.parse_batch(32, eof=True), dict):
        kinds.append('packed' if 'sp_pos' in b else 'dense')
        if b['n'] < 32:
            break
    assert 'dense' in kinds and 'packed' in kinds, kinds
    dec = MPEG1Decoder(CPU)
    dec.write(0.0, es)
    got = _np(dec.decode_available(eof=True, mesh=make_mesh(4,
                                                            device='cpu')))
    _equal(got, _serial(es), 'vs serial')
    _equal(got, _jax_serial(es, jmake_mesh(n_gop=4, n_tile=1)),
           'vs jsmpeg_tpu')
    assert len(launches) == 1 and launches[0][1] == 4    # the packed GOPs


def test_resolve_mesh_forms():
    """The forms of jsmpeg_tpu's resolve_mesh; 'auto' is every visible
    device: one CPU here."""
    assert resolve_mesh(None) is None
    shape = lambda spec: resolve_mesh(spec, device='cpu').shape
    assert shape('4x2') == {'gop': 4, 'tile': 2}
    assert shape(8) == {'gop': 8, 'tile': 1}
    assert shape((2, 2)) == {'gop': 2, 'tile': 2}
    assert shape('8') == {'gop': 8, 'tile': 1}
    assert shape('auto') == shape('all') == {'gop': 1, 'tile': 1}
    m = resolve_mesh('4x2', device='cpu')
    assert resolve_mesh(m) is m
    assert m.cells == [[torch.device('cpu')] * 2] * 4
    with pytest.raises(TypeError):
        resolve_mesh(2.5, device='cpu')


def _gop_frames(outs, gl):
    """MeshPackedDecoder.decode outputs -> per-frame numpy tuples."""
    assert [p.y.shape[0] for p in outs] == gl
    return [tuple(np.asarray(x[fi]) for x in p) for p in outs
            for fi in range(p.y.shape[0])]


def test_mesh_decoder_api_carry(stream):
    """Splitting the frame list across two decode() calls mid-GOP threads
    the reference planes through the returned carry."""
    es, ref = stream
    frames, seq = _packed_frames(es, best_parser())
    dec = MeshPackedDecoder(make_mesh(2, 2, device='cpu'), seq)
    cut = 6   # mid-GOP (gop=4: frame 6 is P inside the second GOP)
    outs1, gl1, carry = dec.decode(frames[:cut])
    outs2, gl2, _ = dec.decode(frames[cut:], init=carry)
    assert gl1 == [4, 2] and gl2 == [2, 2]
    got = _gop_frames(outs1, gl1) + _gop_frames(outs2, gl2)
    _equal(got, ref, 'vs serial')
    jframes, jseq = _packed_frames(es, jbest_parser())
    jdec = jpacked.MeshPackedDecoder(jmake_mesh(2, 2), jseq)
    jo1, jg1, jc = jdec.decode(jframes[:cut])
    jo2, jg2, _ = jdec.decode(jframes[cut:], init=jc)
    rows = jseq.mb_height * 16
    want = [tuple(np.asarray(x[gi, fi])[:rows >> (pn > 0)]
                  for pn, x in enumerate(o))
            for o, g in ((jo1, jg1), (jo2, jg2))
            for gi, n in enumerate(g) for fi in range(n)]
    _equal(got, want, 'vs jsmpeg_tpu')


def _slice_gap_stream():
    """jsmpeg_tpu's fuzz-soak fixture: frame 4 (the first P of GOP 2)
    leaves MB (0,5) uncovered by any slice, so its pixels come from the
    stale current plane = frame 2 -- PRE-GOP content.  A GOP decoded from
    zero planes cannot reproduce that."""
    es, _ = encode_test_stream(96, 64, n_frames=8, seed=922899424, gop=3,
                               f_code=3, full_pel=False)
    return es


def test_gop_closed_predicate():
    frames, _ = _packed_frames(_slice_gap_stream(), best_parser())
    gops = gop.split_at_iframes(frames, lambda f: f['pic_type'])
    closed = [gop_closed(g) for g in gops]
    assert closed == [True, False, True]       # GOP 2 has the slice gap
    assert closed == [jpacked.gop_closed(g) for g in gops]
    assert not gops_all_closed(frames)
    assert not jpacked.gops_all_closed(frames)


def test_mesh_refuses_open_gop():
    es = _slice_gap_stream()
    with pytest.raises(ValueError, match='GOP not closed'):
        decode_packed_mesh(es, make_mesh(1, 1, device='cpu'))
    seq, frames = _parse_all(es, MPEG1Parser())
    with pytest.raises(ValueError, match='GOP not closed'):
        gop.decode_gop_parallel(frames, seq.mb_height, seq.mb_width,
                                make_mesh(8, device='cpu'))


def test_player_mesh_falls_back_bit_exact_on_open_gop(launches):
    """The product mesh path falls back off mesh for an open GOP and
    stays bit-exact (jsmpeg_tpu's round-5 soak failure)."""
    es = _slice_gap_stream()
    dm = MPEG1Decoder(CPU)
    dm.write(0.0, es)
    got = _np(dm.decode_available(eof=True, mesh=make_mesh(2, device='cpu')))
    assert len(got) == 8 and not launches          # no mesh launch
    _equal(got, _serial(es), 'vs serial')
    _equal(got, _jax_serial(es, jmake_mesh(n_gop=2, n_tile=1)),
           'vs jsmpeg_tpu')


# -------------------------------------------------- tests/test_fuzz_mesh.py

@pytest.mark.parametrize('seed', range(6))
def test_random_stream_mesh_bit_exact(seed):
    rng = np.random.default_rng(1000 + seed)
    w = int(rng.choice([64, 96, 128]))
    h = int(rng.choice([96, 128]))
    n_frames = int(rng.integers(4, 13))
    g = int(rng.choice([2, 3, 4, 6]))
    es, _ = encode_realistic_stream(w, h, n_frames=n_frames,
                                    seed=int(rng.integers(1 << 30)), gop=g)
    shape = [(4, 2), (2, 2), (8, 1), (2, 4)][seed % 4]
    got = _np(decode_packed_mesh(es, make_mesh(*shape, device='cpu')))
    what = f'seed {seed} ({w}x{h} gop={g})'
    assert len(got) == n_frames
    _equal(got, _serial(es), f'{what} vs serial')
    _equal(got, _np(jpacked.decode_packed_mesh(es, jmake_mesh(*shape))),
           f'{what} vs jsmpeg_tpu')


# ------------------------------- tests/test_multistream.py, tests/test_cli.py

def _check_streams(streams_es, got, want):
    got, want = [_np(f) for f in got], [_np(f) for f in want]
    for i, es in enumerate(streams_es):
        _equal(got[i], _serial(es), f'stream {i} vs serial')
        _equal(got[i], want[i], f'stream {i} vs jsmpeg_tpu')


def test_streams_over_mesh_bit_exact(launches):
    """Three streams' GOPs concatenated into the gop rows of a 4x2 mesh:
    ONE launch pair, the 2 + 2 + 3 GOPs as its segments."""
    ess = [encode_realistic_stream(192, 112, n_frames=n, seed=s, gop=4)[0]
           for s, n in ((41, 8), (42, 5), (43, 9))]
    got = decode_streams_mesh(ess, make_mesh(4, 2, device='cpu'))
    _check_streams(ess, got, jstreams.decode_streams_mesh(
        ess, jmake_mesh(n_gop=4, n_tile=2)))
    assert launches == [(4, 7, [4, 4, 4, 1, 4, 4, 1], 'cpu')]


def test_mesh_wide_mv_falls_back_off_mesh(launches):
    """MV reach beyond the tile halo: decode_streams_mesh falls back to
    the one-device fleet (round-robin) instead of raising."""
    wide = encode_test_stream(96, 64, n_frames=4, seed=35, gop=2,
                              f_code=5)[0]
    other = encode_realistic_stream(96, 64, n_frames=4, seed=36, gop=2)[0]
    got = decode_streams_mesh([wide, other], make_mesh(2, 4, device='cpu'))
    _check_streams([wide, other], got, jstreams.decode_streams_mesh(
        [wide, other], jmake_mesh(n_gop=2, n_tile=4)))
    # per-stream batches, no joint launch
    assert launches and all(n == 1 for _, n, _, _ in launches)


def test_mesh_mid_gop_join_falls_back():
    """A stream whose first picture is P would predict from the previous
    stream's frames once concatenated: the job routes to the per-stream
    path."""
    es = encode_realistic_stream(96, 64, n_frames=6, seed=37, gop=3)[0]
    starts = [m.start() for m in re.finditer(b'\x00\x00\x01\x00', es)]
    assert len(starts) >= 2
    headless = es[:starts[0]] + es[starts[1]:]   # headers + P-first
    ok = encode_realistic_stream(96, 64, n_frames=3, seed=38, gop=3)[0]
    got = decode_streams_mesh([ok, headless], make_mesh(2, 1, device='cpu'))
    _check_streams([ok, headless], got, jstreams.decode_streams_mesh(
        [ok, headless], jmake_mesh(n_gop=2, n_tile=1)))


def test_cli_multi_input_mesh(tmp_path):
    """Several inputs + --mesh: outputs byte for byte the port's joint
    decode without a mesh, and jsmpeg_tpu's CLI with the same mesh."""
    from jsmpeg_tpu.__main__ import main as jmain
    from jsmpeg_tpu_torch.__main__ import main
    from jsmpeg_tpu_torch.testing.mp2_enc import encode_stream as mp2_stream
    from jsmpeg_tpu_torch.testing.ts_mux import mux_av
    _, chunks = encode_test_stream(80, 48, n_frames=6, seed=51, gop=3,
                                   frame_rate=25.0)
    _, af = mp2_stream(8, seed=52)
    v = chunks[:-1]
    v[-1] += chunks[-1]
    path = tmp_path / 'clip.ts'
    path.write_bytes(mux_av(v, 25.0, af, 1152, 44100))
    clips = [str(path), str(path)]
    assert main(clips + ['--mesh', '4x2', '-o', str(tmp_path / 'mm%d.y4m'),
                         '--device', 'cpu']) == 0
    assert main(clips + ['-o', str(tmp_path / 'sm%d.y4m'),
                         '--device', 'cpu']) == 0
    assert jmain(clips + ['--mesh', '4x2', '-o',
                          str(tmp_path / 'jm%d.y4m')]) == 0
    for i in range(2):
        mm = (tmp_path / f'mm{i}.y4m').read_bytes()
        assert mm == (tmp_path / f'sm{i}.y4m').read_bytes()
        assert mm == (tmp_path / f'jm{i}.y4m').read_bytes()


# ---------------------------------------------------------- the port's own

def test_flushes_of_32_frames_begin_mid_gop(launches):
    """make_mesh(1): a flush every 32 frames, so flushes 2 and 3 begin
    inside a GOP of 12 and continue from the decoder's carry (segment 0
    seeded with it); one launch pair per flush."""
    es = encode_realistic_stream(64, 48, n_frames=70, seed=17, gop=12)[0]
    dec = MPEG1Decoder(CPU)
    dec.write(0.0, es)
    got = _np(dec.decode_available(eof=True, mesh=make_mesh(1,
                                                            device='cpu')))
    assert [(n, s, k) for n, s, k, _ in launches] == [
        (12, 3, [12, 12, 8]), (12, 4, [4, 12, 12, 4]), (6, 1, [6])]
    _equal(got, _serial(es), 'vs serial')
    _equal(got, _jax_serial(es, jmake_mesh(1, 1)), 'vs jsmpeg_tpu')


def test_gop_rows_on_distinct_devices(stream, launches):
    """GOP rows on two devices ('cpu' and 'cpu:0' are distinct device
    objects): a launch pair on each, GOPs 0-1 on the first and GOP 2 on
    the second; the carry comes back to the decoder's device."""
    es, ref = stream
    mesh = make_mesh(2, devices=['cpu', 'cpu:0'])
    assert mesh.gop_devices() == [torch.device('cpu'),
                                  torch.device('cpu:0')]
    _equal(_np(decode_packed_mesh(es, mesh)), ref, 'vs serial')
    assert [(k, d) for _, _, k, d in launches] == [([4, 4], 'cpu'),
                                                   ([2], 'cpu')]
    frames, seq = _packed_frames(es, best_parser())
    _, _, carry = MeshPackedDecoder(mesh, seq, device='cpu').decode(frames)
    for p, r in zip(carry[1], ref[-1]):
        np.testing.assert_array_equal(p.numpy(), r)
        assert p.is_contiguous()


def test_tile_cells_on_distinct_devices_decode(stream, tmp_path,
                                               monkeypatch):
    """Tile cells of one gop row on two devices ('cpu' and 'cpu:0') decode
    in bands through every mesh entry point, equal to the serial decode:
    MeshPackedDecoder (a mid-GOP flush whose carry, joined on the
    decoder's device, equals the serial frames), decode_packed_mesh,
    decode_available(mesh=), the Player, the CLI's --mesh GxT and
    decode_streams_mesh.  A mesh over two cards builds without a card."""
    from jsmpeg_tpu_torch.__main__ import main
    from jsmpeg_tpu_torch.parallel import mesh as mesh_mod
    from jsmpeg_tpu_torch.player import Player
    from jsmpeg_tpu_torch.sinks import VideoCollector
    es, ref = stream
    frames, seq = _packed_frames(es, best_parser())
    assert MeshPackedDecoder(make_mesh(1, 2, devices=['cuda:0', 'cuda:1']),
                             seq).device == torch.device('cuda:0')
    two = ['cpu', 'cpu:0']
    mesh = make_mesh(2, 2, devices=two)
    assert mesh.row_bands() == [(torch.device('cpu'),
                                 torch.device('cpu:0'))] * 2
    dec = MeshPackedDecoder(make_mesh(1, 2, devices=two), seq, device='cpu')
    cut = 6                                  # frame 6: a P inside GOP 2
    outs1, gl1, carry = dec.decode(frames[:cut])
    for p, r in zip(carry, ref[cut - 2:cut]):
        for x, want in zip(p, r):
            np.testing.assert_array_equal(x.numpy(), want)
            assert x.device == torch.device('cpu') and x.is_contiguous()
    outs2, gl2, _ = dec.decode(frames[cut:], init=carry)
    _equal(_gop_frames(outs1, gl1) + _gop_frames(outs2, gl2), ref,
           'MeshPackedDecoder vs serial')
    _equal(_np(decode_packed_mesh(es, mesh)), ref, 'decode_packed_mesh')
    d = MPEG1Decoder(CPU)
    d.write(0.0, es)
    _equal(_np(d.decode_available(eof=True, mesh=mesh)), ref,
           'decode_available')
    vc = VideoCollector()
    n_video, _ = Player(_ts(es), {'audio': False, 'mesh': mesh,
                                  'device': 'cpu'}, renderer=vc
                        ).decode_offline()
    assert n_video == len(ref)
    _equal(vc.frames[-len(ref):], ref, 'Player vs serial')
    # --mesh GxT: the CPU's two names stand in for two cards
    real = mesh_mod.resolve_mesh
    monkeypatch.setattr(mesh_mod, 'resolve_mesh', lambda spec, device=None:
                        make_mesh(*map(int, spec.split('x')), devices=two))
    ts_path = tmp_path / 'clip.ts'
    ts_path.write_bytes(_ts(es))
    assert main([str(ts_path), '--offline', '--mesh', '1x2', '--no-audio',
                 '-o', str(tmp_path / 'out.y4m'), '--device', 'cpu']) == 0
    _equal(_read_y4m(tmp_path / 'out.y4m', 96, 128), ref, 'CLI vs serial')
    monkeypatch.setattr(mesh_mod, 'resolve_mesh', real)
    ess = [es, encode_realistic_stream(96, 128, n_frames=5, seed=12,
                                       gop=3)[0]]
    got = decode_streams_mesh(ess, mesh)
    for i, e in enumerate(ess):
        _equal(_np(got[i]), _serial(e), f'decode_streams_mesh {i}')


def test_make_mesh_needs_a_card_unless_given_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    for make in (lambda: make_mesh(), lambda: make_mesh(8),
                 lambda: resolve_mesh('auto'), lambda: resolve_mesh('4x2'),
                 lambda: make_mesh(device='cuda')):
        with pytest.raises(RuntimeError, match='CUDA'):
            make()
    m = make_mesh(8, device='cpu')
    assert isinstance(m, Mesh) and m.shape == {'gop': 8, 'tile': 1}
    assert m.gop_devices() == [torch.device('cpu')] * 8
    with pytest.raises(ValueError):
        make_mesh(0, device='cpu')


def test_edge_vectors_hold_to_serial_not_the_tiled_reference():
    """A stream whose edge rows predict 10-30 rows outside the picture,
    mb_h = 5 on a 1x2 mesh: the port's merged tile cells clamp at the
    picture edge, equal to the serial decode (the port's and
    jsmpeg_tpu's).  jsmpeg_tpu's tiled decode clamps at its padded
    height (6 MB rows) and differs from its own serial decode on this
    stream (ROADMAP section C, a reference defect the port does not
    copy).  The oracle reads no pixel outside the picture, so it has no
    answer for this stream."""
    es = _edge_stream(96, 80, n_frames=5, seed=84)
    got = _np(decode_packed_mesh(es, make_mesh(1, 2, device='cpu')))
    jax_serial = _jax_serial(es)
    _equal(got, _serial(es), 'vs serial')
    _equal(got, jax_serial, 'vs jsmpeg_tpu serial')
    jax_tiled = _np(jpacked.decode_packed_mesh(es, jmake_mesh(1, 2)))
    assert any(not np.array_equal(a[0], b[0])
               for a, b in zip(jax_tiled, jax_serial))


def test_split_frame_tiles_matches_jax(stream):
    """The per-tile wire of one picture, byte for byte jsmpeg_tpu's, with
    and without padding rows."""
    es, _ = stream
    frames, seq = _packed_frames(es, best_parser())
    n_mb = seq.mb_size
    for n_tile in (2, 4, 5):
        local = -(-seq.mb_height // n_tile)
        for fr in frames[:5]:
            got = packed.split_frame_tiles(fr, n_mb, seq.mb_width, local,
                                           n_tile)
            want = jpacked.split_frame_tiles(fr, n_mb, seq.mb_width, local,
                                             n_tile)
            assert len(got) == len(want) == n_tile
            for g, w in zip(got, want):
                assert g.keys() == w.keys()
                for k in g:
                    np.testing.assert_array_equal(np.asarray(g[k]),
                                                  np.asarray(w[k]), k)


def test_halo_helpers_match_jax(stream):
    es, _ = stream
    frames, _ = _packed_frames(es, best_parser())
    for f_code in range(1, 8):
        assert tiles.halo_mb_rows(f_code) == jtiles.halo_mb_rows(f_code)
    for mv in (0, 1, 2, 29, 30, 31, 62, 63, 64, 130, 500, 1023):
        assert tiles.halo_mb_for_mvs(mv) == jtiles.halo_mb_for_mvs(mv)
    assert tiles.batch_max_abs_mv(frames) == jtiles.batch_max_abs_mv(frames)
    assert tiles.batch_max_abs_mv([]) == 0


def test_gop_mesh_runs_the_compact_form(stream, monkeypatch):
    """The GOP mesh's one launch pair reaches K1 in its compact form, its
    rows the joint wire's coded blocks (every one named), and the frames
    equal the serial decode's and jsmpeg_tpu's."""
    from tests.test_torch_unpack import k1_calls
    es, ref = stream
    calls = k1_calls(monkeypatch)
    got = _np(decode_packed_mesh(es, make_mesh(8, device='cpu')))
    mesh_calls = list(calls)
    _equal(got, ref, 'vs serial')
    _equal(got, _np(jpacked.decode_packed_mesh(es, jmake_mesh(8))),
           'vs jsmpeg_tpu')
    frames, _ = _packed_frames(es, best_parser())
    coded = sum(int((np.unpackbits(f['run_cbp'][:, None], axis=1)[:, 2:]
                     .sum(1) * f['run_len']).sum()) for f in frames)
    assert mesh_calls == [('compact', coded, coded)]

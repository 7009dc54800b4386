"""The tile axis across devices on the CPU (jsmpeg_tpu_torch.parallel.tiles:
K2's band mode in its plain version, the halo exchange and the banded
frame loop; the mesh entry points with tile cells on distinct devices),
case for case tests/test_tile_parallel.py, tests/test_mesh_high_motion.py
and the tiled shapes of tests/test_packed_mesh.py and
tests/test_fuzz_mesh.py.  Every frame equals, with tolerance 0, the
port's serial decode, and jsmpeg_tpu's same call (on the eight virtual
CPU devices of tests/conftest.py) wherever the tile count divides the
picture's macroblock rows: where it does not, jsmpeg_tpu clamps motion at
its padded height and the port at the picture's last real row.

Two device objects that name the CPU ('cpu' and 'cpu:0') stand for two
devices; a device list that repeats them gives three or four bands."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jsmpeg_tpu.host.mpeg1_parse import MPEG1Parser as JParser
from jsmpeg_tpu.models.mpeg1 import MPEG1Decoder as JDecoder
from jsmpeg_tpu.parallel import packed as jpacked
from jsmpeg_tpu.parallel import tiles as jtiles
from jsmpeg_tpu.parallel.mesh import make_mesh as jmake_mesh
from jsmpeg_tpu_torch.host import best_parser
from jsmpeg_tpu_torch.host.mpeg1_parse import MPEG1Parser
from jsmpeg_tpu_torch.models.mpeg1 import MPEG1Decoder, mv_fits_narrow
from jsmpeg_tpu_torch.ops import kernels
from jsmpeg_tpu_torch.ops.frame import Planes, decode_frames_ref, mc_combine
from jsmpeg_tpu_torch.ops.kernels import Band
from jsmpeg_tpu_torch.ops.motion import mc_gather
from jsmpeg_tpu_torch.parallel import packed, tiles
from jsmpeg_tpu_torch.parallel.mesh import make_mesh
from jsmpeg_tpu_torch.parallel.packed import (MeshPackedDecoder,
                                              decode_packed_mesh,
                                              split_packed_frames)
from jsmpeg_tpu_torch.testing.gen import (encode_realistic_stream,
                                          encode_test_stream)
from tests.test_torch_multistream import _edge_stream

CPU = {'device': 'cpu'}
TWO = ['cpu', 'cpu:0']


def _np(frames):
    return [tuple(np.asarray(x) for x in p) for p in frames]


def _equal(got, want, what):
    assert len(got) == len(want), f'{what}: {len(got)} vs {len(want)} frames'
    for k, (g, w) in enumerate(zip(got, want)):
        for pn, a, b in zip(('y', 'cr', 'cb'), g, w):
            np.testing.assert_array_equal(a, b, err_msg=f'{what} f{k} {pn}')


def _serial(es):
    d = MPEG1Decoder(CPU)
    d.write(0.0, es)
    return _np(d.decode_available(eof=True))


def _jax_serial(es):
    d = JDecoder()
    d.write(0.0, es)
    return _np(d.decode_available(eof=True))


def _parse_all(es, parser):
    parser.write(es)
    frames = []
    while (fd := parser.parse_frame(eof=True)) is not None:
        frames.append(fd)
    return parser.seq, frames


def _packed_frames(es):
    p = best_parser()
    p.write(es)
    frames = []
    while isinstance(b := p.parse_batch(32, eof=True), dict):
        frames.extend(split_packed_frames(b))
        if b['n'] < 32:
            break
    return frames, p.seq


@pytest.fixture
def band_launches(monkeypatch):
    """Every K2 launch of decode_bands (one frame of one band, or a
    one-band row's whole loop): (band row0 or None, n_seg, device), and
    every K1 call of the packed band wire: (device, bands)."""
    k2, k1 = [], []
    real_mc, real_blocks = tiles.mc_combine, packed.levels_blocks

    def mc(cur, fwd, resid, meta, n_seg, seg, band=None):
        k2.append((None if band is None else band.row0, n_seg,
                   str(cur.y.device)))
        return real_mc(cur, fwd, resid, meta, n_seg, seg, band)

    def blocks(la, *q):
        k1.append((str(la.qscale.device), la.qscale.shape))
        return real_blocks(la, *q)

    monkeypatch.setattr(tiles, 'mc_combine', mc)
    monkeypatch.setattr(packed, 'levels_blocks', blocks)
    return k2, k1


# ------------------------------------------------- the band MC, the plain K2

def _padded_plane(rng, mb_h_pad, mb_w, block):
    """A random plane of mb_h_pad macroblock rows (padding rows random
    too, so that a read of them would show)."""
    return rng.integers(0, 256, (mb_h_pad * block, mb_w * block),
                        dtype=np.uint8)


def _band_slab(plane, t, rows, halo):
    """Band t's halo'd slab as jsmpeg_tpu's _exchange_halo builds it:
    the band above's last rows, the band's own, the band below's first
    (zeros at the picture's top and bottom)."""
    W = plane.shape[1]
    z = np.zeros((halo, W), np.uint8)
    top = plane[t * rows - halo:t * rows] if t else z
    own = plane[t * rows:(t + 1) * rows]
    bot = plane[(t + 1) * rows:(t + 1) * rows + halo]
    if len(bot) < halo:
        bot = z
    return top, own, bot


@pytest.mark.parametrize('n_band,mb_h', [(2, 4), (2, 5), (3, 5), (3, 7),
                                         (4, 5), (4, 8)])
@pytest.mark.parametrize('block', [16, 8])
def test_band_mc_matches_jax_tiled_gather(n_band, mb_h, block):
    """mc_gather with `band` against jsmpeg_tpu's _mc_tiled_gather called
    with total_rows = the picture's REAL rows, on the same halo'd slab:
    random planes, every half-pel parity, vectors past every band edge
    and the picture's edges (rows within the halo's reach, columns
    anywhere), and a last band of padding rows where the bands do not
    divide mb_h (mb_h 5 over 4 bands: the last band is all padding)."""
    rng = np.random.default_rng(100 * n_band + mb_h + block)
    mb_w, halo_mb = 3, 2
    local = -(-mb_h // n_band)
    if halo_mb > local:
        halo_mb = local
    rows, halo = local * block, halo_mb * block
    plane = _padded_plane(rng, local * n_band, mb_w, block)
    n_mb = local * mb_w
    reach = 2 * (halo - 1)                 # half-pels a row tap may move
    for t in range(n_band):
        top, own, bot = _band_slab(plane, t, rows, halo)
        slab = np.concatenate([top, own, bot])
        mv_h = rng.integers(-6 * block, 6 * block, n_mb).astype(np.int32)
        mv_v = rng.integers(-reach, reach + 1, n_mb).astype(np.int32)
        mv_v[::5] = reach                  # the farthest reach both ways
        mv_v[1::5] = -reach
        mv_h[2::7] = -3                    # negative odd
        want = np.asarray(jtiles._mc_tiled_gather(
            jnp.asarray(slab), jnp.asarray(mv_h), jnp.asarray(mv_v), local,
            mb_w, block, halo, t * rows, mb_h * block))
        got = mc_gather(torch.from_numpy(slab), torch.from_numpy(mv_h),
                        torch.from_numpy(mv_v), local, mb_w, block,
                        band=(halo, t * rows, mb_h * block))
        np.testing.assert_array_equal(got.numpy(), want,
                                      err_msg=f'band {t} of {n_band}')


def test_band_mc_clamps_at_real_rows_not_the_padded_height():
    """With total_rows = the padded height (jsmpeg_tpu's callers) the same
    call reads padding rows; the port's clamp at the real rows does not:
    the two differ on a last band that holds padding rows."""
    rng = np.random.default_rng(7)
    mb_h, n_band, mb_w, block = 5, 2, 3, 16
    local, halo = 3, 32
    plane = _padded_plane(rng, local * n_band, mb_w, block)
    top, own, bot = _band_slab(plane, 1, local * block, halo)
    slab = np.concatenate([top, own, bot])
    n_mb = local * mb_w
    mv_h = np.zeros(n_mb, np.int32)
    mv_v = np.full(n_mb, 40, np.int32)
    args = (jnp.asarray(slab), jnp.asarray(mv_h), jnp.asarray(mv_v), local,
            mb_w, block, halo, local * block)
    real = np.asarray(jtiles._mc_tiled_gather(*args, mb_h * block))
    padded = np.asarray(jtiles._mc_tiled_gather(*args, local * n_band * block))
    got = mc_gather(torch.from_numpy(slab), torch.from_numpy(mv_h),
                    torch.from_numpy(mv_v), local, mb_w, block,
                    band=(halo, local * block, mb_h * block)).numpy()
    np.testing.assert_array_equal(got, real)
    assert (got != padded).any()


@pytest.mark.parametrize('n_band', [2, 3, 4])
def test_band_frames_equal_the_whole_picture(n_band):
    """decode_frames_ref over bands (each frame one band call per band
    with halos cut from the previous frame, as the loop exchanges them)
    equals decode_frames_ref on the whole picture, with 2 segments whose
    frame counts differ: random carry planes, every parity, vectors
    within the halo's reach past every edge, random modes and residuals
    (int32-wrapping ones too).  mb_h = 5 leaves padding rows in the last
    band; the whole-picture run sees the real rows only."""
    rng = np.random.default_rng(n_band)
    S, F, mb_h, mb_w, halo_mb = 2, 3, 5, 3, 1
    local = -(-mb_h // n_band)
    counts = [3, 2]
    H, W = mb_h * 16, mb_w * 16
    pad = local * n_band

    def planes(h):
        return Planes(*[torch.from_numpy(rng.integers(
            0, 256, (S * h // d, W // d), dtype=np.uint8))
            for d in (1, 2, 2)])

    cur, fwd = planes(H), planes(H)
    n_mb = S * mb_h * mb_w
    mv = rng.integers(-30, 31, (F, n_mb, 2)).astype(np.int32)
    mode = rng.integers(0, 256, (F, n_mb)).astype(np.int32)
    meta = torch.from_numpy(np.stack([mv[..., 0], mv[..., 1], mode], -1))
    resid = rng.integers(-300, 300, (F, n_mb, 6, 64)).astype(np.int32)
    resid[rng.random(resid.shape) < 0.002] = 2**31 - 1
    resid = torch.from_numpy(resid)
    want = decode_frames_ref(cur, fwd, resid, meta, S, counts)

    def to_bands(x, rows_real, rows_band, lead=()):
        """[..., S * rows_real, ...] -> per band [..., S * rows_band, ...]
        (zero padding rows)."""
        x = x.reshape(lead + (S, rows_real) + x.shape[len(lead) + 1:])
        z = torch.zeros(lead + (S, pad * rows_band // local - rows_real)
                        + x.shape[len(lead) + 2:], dtype=x.dtype)
        x = torch.cat([x, z], dim=len(lead) + 1)
        return [x.narrow(len(lead) + 1, t * rows_band, rows_band).reshape(
            lead + (S * rows_band,) + x.shape[len(lead) + 2:])
            for t in range(n_band)]

    def plane_bands(p):
        return [Planes(*z) for z in zip(*[
            to_bands(q, H // d, local * 16 // d) for q, d in
            zip(p, (1, 2, 2))])]

    rb = to_bands(resid.reshape(F, S * mb_h, mb_w, 6, 64), mb_h, local,
                  (F,))
    mb_ = to_bands(meta.reshape(F, S * mb_h, mb_w, 3), mb_h, local, (F,))
    c_b, f_b = plane_bands(cur), plane_bands(fwd)
    hy = halo_mb * 16
    for k in range(F):
        new = []
        for t in range(n_band):
            def halo(bands, t2, first):
                if not 0 <= t2 < n_band:
                    return Planes(*[torch.zeros((S * hy // d, W // d),
                                                dtype=torch.uint8)
                                    for d in (1, 2, 2)])
                return Planes(*[
                    (b.reshape(S, -1, W // d)[:, :hy // d] if first else
                     b.reshape(S, -1, W // d)[:, -hy // d:]).reshape(
                        -1, W // d) for b, d in zip(bands[t2], (1, 2, 2))])
            band = Band(halo(f_b, t - 1, False), halo(f_b, t + 1, True),
                        t * local, mb_h, halo_mb, k)
            out = mc_combine(c_b[t], f_b[t],
                             rb[t][k:k + 1].reshape(1, -1, 6, 64),
                             mb_[t][k:k + 1].reshape(1, -1, 3), S, counts,
                             band)
            new.append(Planes(*[o[0] for o in out]))
        c_b, f_b = f_b, new
        for p, d in zip(range(3), (1, 2, 2)):
            joined = torch.cat([b[p].reshape(S, -1, W // d) for b in new], 1)
            np.testing.assert_array_equal(
                joined[:, :H // d].reshape(-1, W // d).numpy(),
                want[p][k].numpy(), err_msg=f'frame {k} plane {p}')


def test_band_mode_checks_before_the_device():
    """The band wrapper refuses what K2's band mode does not take, on
    any device: more than one frame, a halo over the band's rows, a
    wrong halo shape."""
    z = lambda h, w: torch.zeros((h, w), dtype=torch.uint8)
    pl = lambda h: Planes(z(h, 32), z(h // 2, 16), z(h // 2, 16))
    band = Band(pl(32), pl(32), 0, 2, 2, 0)
    meta = torch.zeros((1, 4, 3), dtype=torch.int32)
    resid = torch.zeros((1, 4, 6, 64), dtype=torch.int32)
    with pytest.raises(ValueError, match='one frame'):
        kernels.mc_combine_cuda(pl(32), pl(32), resid.expand(2, -1, -1, -1),
                                meta.expand(2, -1, -1), 1, None, band)
    with pytest.raises(ValueError, match='halo'):
        kernels.mc_combine_cuda(pl(32), pl(32), resid, meta, 1, None,
                                band._replace(halo_mb=3))
    with pytest.raises(ValueError, match='top'):
        kernels.mc_combine_cuda(pl(32), pl(32), resid, meta, 1, None,
                                band._replace(top=pl(16)))
    with pytest.raises(ValueError, match='CUDA'):
        kernels.mc_combine_cuda(pl(32), pl(32), resid, meta, 1, None, band)


def test_exchange_halo_moves_neighbour_rows():
    """exchange_halo: band t's last rows into band t+1's top halo, band
    t+1's first rows into band t's bottom halo, per segment and plane;
    the picture's own top and bottom halos stay zero."""
    S, rows, W, hy = 2, 32, 16, 16
    fwd = [Planes(*[torch.full((S * rows // d, W // d), 10 * t + d,
                               dtype=torch.uint8) for d in (1, 2, 2)])
           for t in range(3)]
    for t in range(3):
        fwd[t].y.view(S, rows, W)[:, 0] = 100 + t       # first row
        fwd[t].y.view(S, rows, W)[:, -1] = 200 + t      # last row
    z = lambda: Planes(*[torch.zeros((S * hy // d, W // d),
                                     dtype=torch.uint8) for d in (1, 2, 2)])
    top, bot = [z() for _ in range(3)], [z() for _ in range(3)]
    tiles.exchange_halo(fwd, top, bot, S)
    assert not top[0].y.any() and not bot[2].y.any()
    for t in range(2):
        np.testing.assert_array_equal(
            top[t + 1].y.view(S, hy, W).numpy(),
            fwd[t].y.view(S, rows, W)[:, -hy:].numpy())
        np.testing.assert_array_equal(
            bot[t].cb.view(S, hy // 2, W // 2).numpy(),
            fwd[t + 1].cb.view(S, rows // 2, W // 2)[:, :hy // 2].numpy())
        assert (top[t + 1].y.view(S, hy, W)[:, -1] == 200 + t).all()
        assert (bot[t].y.view(S, hy, W)[:, 0] == 101 + t).all()


# ---------------------------------------------- tests/test_tile_parallel.py

@pytest.mark.parametrize('shape,devices', [((2, 2), TWO), ((1, 2), TWO),
                                           ((2, 4), TWO * 2)])
def test_tiles_match_serial(shape, devices, band_launches):
    """decode_tiled (serially parsed FrameData, K1 in its IDCT-only mode):
    64x128, 8 MB rows in 2 or 4 bands, equal to the serial decode and to
    jsmpeg_tpu's decode_tiled on the same mesh shape; one K2 band launch
    per band and frame step."""
    es, _ = encode_test_stream(64, 128, n_frames=8, seed=41, gop=4,
                               f_code=2)
    seq, frames = _parse_all(es, MPEG1Parser())
    mesh = make_mesh(*shape, devices=devices)
    got = _np(tiles.decode_tiled(frames, seq.mb_height, seq.mb_width, mesh,
                                 f_code=2))
    _equal(got, _serial(es), f'{shape} vs serial')
    jseq, jframes = _parse_all(es, JParser())
    _equal(got, _np(jtiles.decode_tiled(jframes, jseq.mb_height,
                                        jseq.mb_width, jmake_mesh(*shape),
                                        f_code=2)), f'{shape} vs jsmpeg_tpu')
    # the gop rows have the same cells, so they share one loop: its 2
    # GOPs of 4 frames as the segments of each launch
    k2, _ = band_launches
    assert len(k2) == 4 * shape[1]
    assert {n for _, n, _ in k2} == {2}


@pytest.mark.parametrize('devices,n_band', [(['cpu', 'cpu:0', 'cpu'], 3),
                                            (TWO * 2, 4)])
def test_tiles_non_divisible_rows(devices, n_band):
    """7 MB rows (102 px tall) in 2, 3 and 4 bands: the last band holds
    padding rows, and a 3- or 4-band loop runs through a device list that
    repeats the CPU's two names.  Equal to the serial decode."""
    es, _ = encode_test_stream(80, 102, n_frames=8, seed=43, gop=2,
                               f_code=1)
    seq, frames = _parse_all(es, MPEG1Parser())
    assert seq.mb_height == 7
    ref = _serial(es)
    for mesh in (make_mesh(4, 2, devices=TWO),
                 make_mesh(2, n_band, devices=devices)):
        got = _np(tiles.decode_tiled(frames, seq.mb_height, seq.mb_width,
                                     mesh, f_code=1))
        _equal(got, ref, f'{mesh.shape} vs serial')


@pytest.mark.parametrize('wire', ['serial', 'levels'])
def test_one_band_rows_take_one_launch(wire, band_launches):
    """Tile cells that share a device merge into one band: decode_tiled
    and decode_tiled_levels then run the row's whole frame loop as ONE
    segmented K2 launch, its 2 GOPs as the segments, with no halo.  Equal
    to the serial decode."""
    es, _ = encode_test_stream(64, 128, n_frames=8, seed=41, gop=4,
                               f_code=2)
    mesh = make_mesh(2, 2, devices=['cpu'])
    if wire == 'serial':
        seq, frames = _parse_all(es, MPEG1Parser())
        got = tiles.decode_tiled(frames, seq.mb_height, seq.mb_width, mesh)
    else:
        got = tiles.decode_tiled_levels(es, mesh)
    _equal(_np(got), _serial(es), f'{wire} one band vs serial')
    k2, _ = band_launches
    assert k2 == [(None, 2, 'cpu')]


def test_halo_sizing():
    assert [tiles.halo_mb_rows(f) for f in (1, 2, 3, 4)] == [1, 2, 3, 5]


@pytest.mark.parametrize('shape', [(2, 2), (1, 2)])
def test_tiles_levels_wire_match_serial(shape):
    es, _ = encode_test_stream(64, 128, n_frames=8, seed=45, gop=4,
                               f_code=2)
    got = _np(tiles.decode_tiled_levels(es, make_mesh(*shape, devices=TWO),
                                        f_code=2))
    _equal(got, _serial(es), 'vs serial')
    _equal(got, _np(jtiles.decode_tiled_levels(es, jmake_mesh(*shape),
                                               f_code=2)), 'vs jsmpeg_tpu')


def test_tiles_levels_wire_custom_matrices():
    es, _ = encode_test_stream(64, 96, n_frames=6, seed=47, gop=3,
                               f_code=1, custom_matrices=True)
    mesh = make_mesh(4, 2, devices=TWO)
    got = _np(tiles.decode_tiled_levels(es, mesh, f_code=1))
    _equal(got, _serial(es), 'vs serial')
    _equal(got, _np(jtiles.decode_tiled_levels(es, jmake_mesh(4, 2),
                                               f_code=1)), 'vs jsmpeg_tpu')
    # the levels wire over 3 bands on the CPU's two names
    got3 = _np(tiles.decode_tiled_levels(
        es, make_mesh(1, 3, devices=['cpu', 'cpu:0', 'cpu']), f_code=1))
    _equal(got3, _serial(es), '3 bands vs serial')


def test_tiled_entry_points_refuse():
    """jsmpeg_tpu's refusals: a halo over the rows of a tile, an open
    GOP."""
    es, _ = encode_test_stream(96, 128, n_frames=4, seed=22, gop=2,
                               f_code=4)
    seq, frames = _parse_all(es, MPEG1Parser())
    mesh = make_mesh(2, 4, devices=TWO)
    with pytest.raises(ValueError, match='rows per tile'):
        tiles.decode_tiled(frames, seq.mb_height, seq.mb_width, mesh,
                           f_code=4)
    with pytest.raises(ValueError, match='rows per tile'):
        tiles.decode_tiled_levels(es, mesh, f_code=4)
    gap = encode_test_stream(96, 64, n_frames=8, seed=922899424, gop=3,
                             f_code=3)[0]
    seq, frames = _parse_all(gap, MPEG1Parser())
    with pytest.raises(ValueError, match='GOP not closed'):
        tiles.decode_tiled(frames, seq.mb_height, seq.mb_width,
                           make_mesh(1, 2, devices=TWO), f_code=3)
    with pytest.raises(ValueError, match='GOP not closed'):
        tiles.decode_tiled_levels(gap, make_mesh(1, 2, devices=TWO),
                                  f_code=3)


def test_parse_levels_frames_matches_jax():
    es, _ = encode_test_stream(64, 96, n_frames=5, seed=48, gop=3)
    seq, got = tiles.parse_levels_frames(es)
    jseq, want = jtiles.parse_levels_frames(es)
    assert (seq.mb_height, seq.mb_width) == (jseq.mb_height, jseq.mb_width)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]))


# --------------------------------------------- tests/test_mesh_high_motion.py

def _mesh_via_decoder(es, mesh):
    dec = MPEG1Decoder(CPU)
    dec.write(0.0, es)
    return _np(dec.decode_available(eof=True, mesh=mesh))


def _jax_mesh_via_decoder(es, mesh):
    dec = JDecoder()
    dec.write(0.0, es)
    return _np(dec.decode_available(eof=True, mesh=mesh))


@pytest.mark.parametrize('f_code,full_pel', [(3, False), (4, False),
                                             (3, True)])
def test_high_fcode_mesh_grows_halo(f_code, full_pel, band_launches):
    """8 MB rows in 2 bands of 4: where the data's reach needs a halo of
    up to 4 rows the banded decode runs with the grown halo; past that
    (f_code 4's reach rounds up to 8 rows) the decoder goes off mesh, as
    jsmpeg_tpu does.  Exact either way."""
    es, _ = encode_test_stream(96, 128, n_frames=6, seed=21, gop=3,
                               f_code=f_code, full_pel=full_pel)
    mesh = make_mesh(4, 2, devices=TWO)
    got = _mesh_via_decoder(es, mesh)
    _equal(got, _serial(es), 'vs serial')
    _equal(got, _jax_mesh_via_decoder(es, jmake_mesh(4, 2)), 'vs jsmpeg_tpu')
    frames, seq = _packed_frames(es)
    md = MeshPackedDecoder(mesh, seq)
    k2, _ = band_launches
    assert bool(k2) == md.fits_mesh(frames)
    assert md.fits_mesh(frames) == (f_code == 3)
    assert {d for _, _, d in k2} <= {'cpu'}


def test_reach_beyond_tile_rows_falls_back(band_launches):
    """4 bands of 2 MB rows cannot hold a 4-row halo: the library entry
    point refuses, the decoder's mesh path goes off mesh, exact."""
    es, _ = encode_test_stream(96, 128, n_frames=6, seed=22, gop=3,
                               f_code=4)
    mesh = make_mesh(2, 4, devices=TWO)
    frames, seq = _packed_frames(es)
    md = MeshPackedDecoder(mesh, seq)
    assert not md.fits_mesh(frames)
    with pytest.raises(ValueError, match='rows per tile'):
        md.decode(frames)
    _equal(_mesh_via_decoder(es, mesh), _serial(es), 'fallback vs serial')
    assert band_launches == ([], [])


def test_decode_packed_mesh_grows_halo():
    es, _ = encode_test_stream(64, 128, n_frames=4, seed=23, gop=2,
                               f_code=3)
    got = _np(decode_packed_mesh(es, make_mesh(2, 2, devices=TWO)))
    _equal(got, _serial(es), 'vs serial')
    _equal(got, _np(jpacked.decode_packed_mesh(es, jmake_mesh(2, 2))),
           'vs jsmpeg_tpu')


def test_fcode5_wide_mv_wire():
    """f_code 5: vectors past int8, so each band's wire takes the wide
    run record; 2 bands of 8 MB rows hold the 8-row halo."""
    es, _ = encode_test_stream(96, 256, n_frames=4, seed=23, gop=2,
                               f_code=5)
    frames, _ = _packed_frames(es)
    assert not all(mv_fits_narrow(f['run_mv']) for f in frames)
    got = _mesh_via_decoder(es, make_mesh(4, 2, devices=TWO))
    _equal(got, _serial(es), 'vs serial')
    _equal(got, _jax_mesh_via_decoder(es, jmake_mesh(4, 2)), 'vs jsmpeg_tpu')


# -------------------------- tests/test_packed_mesh.py, tests/test_fuzz_mesh.py

@pytest.fixture(scope='module')
def stream():
    es, _ = encode_realistic_stream(96, 128, n_frames=10, seed=11, gop=4)
    return es, _serial(es)


@pytest.mark.parametrize('shape', [(4, 2), (2, 4), (1, 2)])
def test_mesh_bit_exact(stream, shape, band_launches):
    """The packed wire split per band: K1 once per device (the CPU's two
    names), a K2 band launch per band and frame step."""
    es, ref = stream
    mesh = make_mesh(*shape, devices=TWO)
    got = _np(decode_packed_mesh(es, mesh))
    _equal(got, ref, f'{shape} vs serial')
    _equal(got, _np(jpacked.decode_packed_mesh(es, jmake_mesh(*shape))),
           f'{shape} vs jsmpeg_tpu')
    k2, k1 = band_launches
    # gop rows with the same cells share one loop: 3 GOPs, the longest 4
    assert [d for d, _ in k1] == ['cpu', 'cpu']
    assert len(k2) == 4 * shape[1]


@pytest.mark.parametrize('seed', [0, 1, 3, 4, 5])
def test_random_stream_mesh_bit_exact(seed):
    """tests/test_fuzz_mesh.py's seeds with tile cells, on distinct
    devices."""
    rng = np.random.default_rng(1000 + seed)
    w = int(rng.choice([64, 96, 128]))
    h = int(rng.choice([96, 128]))
    n_frames = int(rng.integers(4, 13))
    g = int(rng.choice([2, 3, 4, 6]))
    es, _ = encode_realistic_stream(w, h, n_frames=n_frames,
                                    seed=int(rng.integers(1 << 30)), gop=g)
    shape = [(4, 2), (2, 2), (8, 1), (2, 4)][seed % 4]
    got = _np(decode_packed_mesh(es, make_mesh(*shape, devices=TWO)))
    what = f'seed {seed} ({w}x{h} gop={g} {shape})'
    assert len(got) == n_frames
    _equal(got, _serial(es), f'{what} vs serial')
    if (h // 16) % shape[1] == 0:
        _equal(got, _np(jpacked.decode_packed_mesh(es, jmake_mesh(*shape))),
               f'{what} vs jsmpeg_tpu')


@pytest.mark.parametrize('n_tile', [2, 3, 4])
def test_edge_vectors_on_distinct_devices(n_tile):
    """The edge-vector stream (edge rows predicting 10-30 rows outside
    the picture, mb_h = 5) in 2, 3 and 4 bands on distinct devices: the
    port clamps at the picture's last row and equals the serial decode
    (the port's and jsmpeg_tpu's); jsmpeg_tpu's tiled decode clamps at
    its padded height and differs from its own serial decode."""
    es = _edge_stream(96, 80, n_frames=5, seed=84)
    devices = (TWO * 2)[:n_tile]
    got = _np(decode_packed_mesh(es, make_mesh(1, n_tile, devices=devices)))
    jax_serial = _jax_serial(es)
    _equal(got, _serial(es), 'vs serial')
    _equal(got, jax_serial, 'vs jsmpeg_tpu serial')
    jax_tiled = _np(jpacked.decode_packed_mesh(es, jmake_mesh(1, n_tile)))
    assert any(not np.array_equal(a[0], b[0])
               for a, b in zip(jax_tiled, jax_serial))


def test_mid_gop_flushes_in_bands(band_launches):
    """make_mesh(1, 2) on the CPU's two names with flushes of 32 frames:
    flushes 2 and 3 begin inside a GOP, their carry split into band rows
    on the way in and joined on the decoder's device on the way out."""
    es = encode_realistic_stream(64, 48, n_frames=70, seed=17, gop=12)[0]
    got = _mesh_via_decoder(es, make_mesh(1, 2, devices=TWO))
    _equal(got, _serial(es), 'vs serial')
    k2, k1 = band_launches
    assert len(k1) == 3 * 2                  # 3 flushes, 2 devices
    assert len(k2) == (12 + 12 + 6) * 2      # the longest GOP of each


def test_band_cells_run_the_compact_form(monkeypatch):
    """The band cells of a packed mesh (two device objects in one mesh
    row: decode_bands, K1 once per device over that device's bands'
    slabs) reach K1 in its compact form only, every row named, and the
    frames equal the serial decode's and jsmpeg_tpu's."""
    from tests.test_torch_unpack import k1_calls
    es, _ = encode_realistic_stream(96, 128, n_frames=6, seed=13, gop=3)
    calls = k1_calls(monkeypatch)
    got = _np(decode_packed_mesh(es, make_mesh(1, 2, devices=TWO)))
    assert len(calls) == 2           # one per device
    assert all(c[0] == 'compact' and c[1] == c[2] for c in calls)
    _equal(got, _serial(es), 'vs serial')
    _equal(got, _np(jpacked.decode_packed_mesh(es, jmake_mesh(1, 2))),
           'vs jsmpeg_tpu')

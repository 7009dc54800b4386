"""The port's MultiStreamDecoder (jsmpeg_tpu_torch.parallel.streams) on
the CPU, case for case the cases of tests/test_multistream.py in all
three modes: every stream's frames equal, with tolerance 0, to
jsmpeg_tpu's decode_streams_offline in the same mode on the same bytes
and to the port's single-stream decoder.  The joint modes' parts are
held to jsmpeg_tpu's too: stack_stream_frames byte for byte, and
decode_levels with segments against decode_scan_fused(n_seg, valid_seg)
on the same joint wire.

Not mirrored: test_stacked_wire_ids_* (the port has no wire_ids),
test_tuning_flags_bit_exact (nor block_carry or mc_method),
test_merge_halo_zero_sentinel (no band halo); the mesh cases are
mirrored in tests/test_torch_mesh.py, the fleet's lattice split in
tests/test_torch_wire.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jsmpeg_tpu.models import mpeg1 as jmpeg1
from jsmpeg_tpu.ops.frame import Planes as JPlanes
from jsmpeg_tpu.parallel import streams as jstreams
from jsmpeg_tpu_torch.host import best_parser
from jsmpeg_tpu_torch.models.mpeg1 import (FrameSeq, MPEG1Decoder,
                                           decode_levels, packed_to_levels,
                                           state_from_numpy, unpack_fused)
from jsmpeg_tpu_torch.ops import kernels
from jsmpeg_tpu_torch.parallel.packed import split_packed_frames
from jsmpeg_tpu_torch.parallel.streams import (MultiStreamDecoder,
                                               _pad_frame_dict,
                                               decode_streams_offline,
                                               stack_stream_frames)
from jsmpeg_tpu_torch.testing.gen import (encode_realistic_stream,
                                          encode_test_stream)
from jsmpeg_tpu_torch.testing.quirks import escape_zero_stream
from tests.oracle.ref_mpeg1 import OracleMPEG1

CPU = {'device': 'cpu'}
JOINT = ['stacked', 'vmap']


def _np(frames):
    """Per-stream frame lists -> lists of (y, cr, cb) numpy tuples."""
    return [[tuple(np.asarray(x) for x in p) for p in fs] for fs in frames]


def _single(es):
    d = MPEG1Decoder(CPU)
    d.write(0.0, es)
    return [tuple(x.numpy() for x in p)
            for p in d.decode_available(eof=True) or []]


def _equal(got, want, what):
    assert len(got) == len(want), f'{what}: frame count'
    for k, (g, w) in enumerate(zip(got, want)):
        for pn, a, b in zip(('y', 'cr', 'cb'), g, w):
            np.testing.assert_array_equal(a, b, err_msg=f'{what} f{k} {pn}')


def _check(streams, got, jax_got=None, mode='roundrobin', **kw):
    """Port frames == the port's single-stream decode == jsmpeg_tpu's
    fleet in the same mode on the same bytes."""
    if jax_got is None:
        jax_got = jstreams.decode_streams_offline(streams, mode=mode, **kw)
    got, jax_got = _np(got), _np(jax_got)
    for i, es in enumerate(streams):
        _equal(got[i], _single(es), f'stream {i} vs single')
        _equal(got[i], jax_got[i], f'stream {i} vs jsmpeg_tpu')


def test_three_streams_bit_exact():
    """Three different streams (one short: unequal lengths within the
    fleet round)."""
    streams = [
        encode_realistic_stream(192, 112, n_frames=10, seed=s, gop=5)[0]
        for s in (1, 2)]
    streams.append(encode_realistic_stream(192, 112, n_frames=4, seed=9,
                                           gop=4)[0])
    got = decode_streams_offline(streams, batch_frames=16, device='cpu')
    _check(streams, got, batch_frames=16)


def test_multi_batch_carry():
    """Streams longer than one round's batch: carries thread through."""
    streams = [
        encode_realistic_stream(160, 96, n_frames=13, seed=s, gop=4)[0]
        for s in (5, 6)]
    got = decode_streams_offline(streams, batch_frames=5, device='cpu')
    _check(streams, got, batch_frames=5)


def test_incremental_write_and_eof_tail():
    """write() per stream, one stream ending early: later rounds still
    decode the longer stream (the round-robin case of
    test_alternate_modes_bit_exact too: an unequal-length stream and
    multi-batch carries)."""
    a = encode_realistic_stream(160, 96, n_frames=12, seed=11, gop=6)[0]
    b = encode_realistic_stream(160, 96, n_frames=3, seed=12, gop=3)[0]
    dec = MultiStreamDecoder(2, batch_frames=4, device='cpu')
    dec.write(0, a)
    dec.write(1, b)
    kernels.reset_launches()
    frames = dec.decode_all(eof=True)
    # the CPU runs the kernels' plain versions: no launch
    assert kernels.launches == {'dequant_idct': 0, 'mc_combine': 0,
                                'wire_unpack': 0}
    _check([a, b], frames, batch_frames=4)


def test_round_outputs_cut_to_real_frames():
    """Each round hands every stream ONE Planes of [F_i, H, W], F_i its
    real frame count (0 for an idle stream), on the decoder's device."""
    a = encode_realistic_stream(64, 48, n_frames=7, seed=13, gop=3)[0]
    b = encode_realistic_stream(64, 48, n_frames=2, seed=14, gop=2)[0]
    dec = MultiStreamDecoder(2, batch_frames=4, device='cpu')
    dec.write(0, a)
    dec.write(1, b)
    counts = []
    while (outs := dec.decode_batch(eof=True)) is not None:
        counts.append([st.y.shape[0] for st in outs])
        for st in outs:
            assert st.y.shape[1:] == (48, 64) and st.cr.shape[1:] == (24, 32)
            assert st.y.device.type == 'cpu'
    assert counts == [[4, 2], [3, 0]]


def test_mixed_resolution_rejected():
    a = encode_realistic_stream(160, 96, n_frames=2, seed=1, gop=2)[0]
    b = encode_realistic_stream(192, 112, n_frames=2, seed=1, gop=2)[0]
    for make in (lambda: MultiStreamDecoder(2, batch_frames=4,
                                            device='cpu'),
                 lambda: jstreams.MultiStreamDecoder(2, batch_frames=4,
                                                     mode='roundrobin')):
        dec = make()
        dec.write(0, a)
        dec.write(1, b)
        with pytest.raises(ValueError, match='one resolution'):
            dec.decode_batch(eof=True)


def test_mixed_quant_matrices_rejected():
    a = encode_test_stream(64, 48, n_frames=2, seed=1, gop=2)[0]
    b = encode_test_stream(64, 48, n_frames=2, seed=2, gop=2,
                           custom_matrices=True)[0]
    for make in (lambda: MultiStreamDecoder(2, batch_frames=4,
                                            device='cpu'),
                 lambda: jstreams.MultiStreamDecoder(2, batch_frames=4,
                                                     mode='roundrobin')):
        dec = make()
        dec.write(0, a)
        dec.write(1, b)
        with pytest.raises(ValueError, match='quant'):
            dec.decode_batch(eof=True)


def test_parser_buffers_evict_consumed():
    """Long-running serving must not grow with consumed bitstream: after
    each round the parsers' byte buffers shrink back to the unread tail.
    The frames of the chunked feed equal jsmpeg_tpu's fleet fed the same
    chunks."""
    es = encode_realistic_stream(160, 96, n_frames=24, seed=51, gop=4)[0]
    dec = MultiStreamDecoder(2, batch_frames=4, streaming=True,
                             device='cpu')
    jdec = jstreams.MultiStreamDecoder(2, batch_frames=4, streaming=True,
                                       mode='roundrobin')
    got, want = [[], []], [[], []]

    def collect(outs, into):
        for i, st in enumerate(outs or []):
            for f in range(st.y.shape[0]):
                into[i].append((np.asarray(st.y[f]), np.asarray(st.cr[f]),
                                np.asarray(st.cb[f])))

    high_water = 0
    for chunk_at in range(0, len(es), 4096):
        for i in range(2):
            dec.write(i, es[chunk_at:chunk_at + 4096])
            jdec.write(i, es[chunk_at:chunk_at + 4096])
        collect(dec.decode_batch(), got)
        collect(jdec.decode_batch(), want)
        for p in dec.parsers:
            high_water = max(high_water,
                             p.bits.byte_length - (p.bits.index >> 3) + 1)
            # the retained buffer is bounded by the unread tail (+ the
            # chunk just written), not by total bytes ever written
            assert p.bits.byte_length <= high_water + 4096, \
                'buffer grew with consumed bytes'
    for d, into in ((dec, got), (jdec, want)):
        while (outs := d.decode_batch(eof=True)) is not None:
            collect(outs, into)
    for i in range(2):
        _equal(got[i], want[i], f'stream {i} vs jsmpeg_tpu')
        _equal(got[i], _single(es), f'stream {i} vs single')


def test_quarantine_isolates_bad_feed():
    """Serving posture: a mismatched feed is quarantined with a reason
    and the good feed keeps decoding bit-exactly."""
    good = encode_realistic_stream(160, 96, n_frames=6, seed=55, gop=3)[0]
    bad = encode_realistic_stream(192, 112, n_frames=4, seed=56, gop=2)[0]
    dec = MultiStreamDecoder(2, batch_frames=4, quarantine=True,
                             device='cpu')
    dec.write(0, good)
    dec.write(1, bad)
    frames = dec.decode_all(eof=True)
    jdec = jstreams.MultiStreamDecoder(2, batch_frames=4, quarantine=True,
                                       mode='roundrobin')
    jdec.write(0, good)
    jdec.write(1, bad)
    jframes = jdec.decode_all(eof=True)
    assert dec.dead == jdec.dead
    assert dec.dead[0] is None
    assert dec.dead[1] and 'resolution' in dec.dead[1]
    assert len(frames[1]) == len(jframes[1]) == 0
    _check([good], [frames[0]], jax_got=[jframes[0]])


def test_demotion_keeps_quirk_stream_decoding():
    """A stream hitting the exactness fallback (escape-coded zero) is
    demoted to its own serial-capable decoder mid-stream, adopting its
    carry: both streams deliver ALL frames bit-exactly and neither is
    marked dead."""
    quirk = escape_zero_stream(48, 32)
    # a same-geometry clean stream (the quirk stream is 48x32 qscale=8)
    clean = encode_test_stream(48, 32, n_frames=4, seed=61, gop=2,
                               qscale=8)[0]
    dec = MultiStreamDecoder(2, batch_frames=4, quarantine=True,
                             device='cpu')
    dec.write(0, clean)
    dec.write(1, quirk)
    frames = dec.decode_all(eof=True)
    assert dec.dead == [None, None]
    assert 1 in dec._demoted
    assert dec._demoted[1].device == dec.device
    ref_clean = OracleMPEG1(clean).decode_all()
    ref_quirk = OracleMPEG1(quirk).decode_all()
    assert len(frames[0]) == len(ref_clean)
    assert len(frames[1]) == len(ref_quirk) == 2
    for got, ref in ((frames[0], ref_clean), (frames[1], ref_quirk)):
        for p, r in zip(got, ref):
            for a, b in zip(p, r):
                np.testing.assert_array_equal(a.numpy(), b)
    _check([clean, quirk], frames, batch_frames=4, quarantine=True)


def test_single_quirk_stream_not_lost():
    """A demotion in a round where NO other stream has frames must not
    end decode_all early (the demoted stream's frames arrive on the next
    round)."""
    quirk = escape_zero_stream(48, 32)
    got = decode_streams_offline([quirk], batch_frames=4, device='cpu')
    ref = OracleMPEG1(quirk).decode_all()
    assert len(got[0]) == len(ref) == 2
    for p, r in zip(got[0], ref):
        np.testing.assert_array_equal(p.y.numpy(), r[0])
    _check([quirk], got, batch_frames=4)


def test_demoted_path_no_per_frame_slices(monkeypatch):
    """The demoted stream's frames ride whole-batch tensors
    (FrameSeq.stacked_planes, the stacked _demote output), never
    per-frame FrameSeq indexing."""
    def boom(self, i):
        raise AssertionError('per-frame slice on the demoted path')

    monkeypatch.setattr(FrameSeq, '__getitem__', boom)
    quirk = escape_zero_stream(48, 32)
    dec = MultiStreamDecoder(1, batch_frames=4, quarantine=True,
                             device='cpu')
    dec.write(0, quirk)
    stacked = []
    while True:
        outs = dec.decode_batch(eof=True)
        if outs is None:
            break
        st = outs[0]
        for f in range(st.y.shape[0]):
            stacked.append((st.y[f].numpy(), st.cr[f].numpy(),
                            st.cb[f].numpy()))
    monkeypatch.undo()
    _equal(stacked, _single(quirk), 'demoted vs single')
    ref = OracleMPEG1(quirk).decode_all()
    assert len(stacked) == len(ref) == 2
    for got, r in zip(stacked, ref):
        np.testing.assert_array_equal(got[0], r[0])


def test_stacked_planes_joins_whole_batches():
    """FrameSeq.stacked_planes: one Planes over every retained frame,
    equal to the frames one by one; None when nothing is retained."""
    es = encode_realistic_stream(64, 48, n_frames=7, seed=15, gop=3)[0]
    dec = MPEG1Decoder(CPU)
    dec.BATCH_FRAMES = 3
    dec.write(0.0, es)
    fs = dec.decode_available(eof=True)
    st = fs.stacked_planes()
    assert st.y.shape == (7, 48, 64)
    for k, p in enumerate(fs):
        for a, b in zip(st, p):
            np.testing.assert_array_equal(a[k].numpy(), b.numpy())
    assert FrameSeq().stacked_planes() is None


def test_demoted_then_dead_purged():
    """A feed that demotes first and later proves geometry-mismatched is
    purged: no wrong-geometry frames leak into the fleet output."""
    fleet = encode_realistic_stream(160, 96, n_frames=4, seed=65, gop=2)[0]
    rogue = escape_zero_stream(48, 32)       # demotes AND mismatches
    out = []
    for make in (lambda: MultiStreamDecoder(2, batch_frames=4,
                                            quarantine=True, device='cpu'),
                 lambda: jstreams.MultiStreamDecoder(
                     2, batch_frames=4, quarantine=True,
                     mode='roundrobin')):
        dec = make()
        dec.write(0, rogue)       # rogue header arrives first...
        dec.decode_batch()        # ...and demotes immediately
        dec.write(1, fleet)
        out.append((_np(dec.decode_all(eof=True)), list(dec.dead)))
    (frames, dead), (jframes, jdead) = out
    # whichever geometry won the contract, no stream may emit frames of
    # the OTHER geometry
    shapes = {p[0].shape for fs in frames for p in fs}
    assert len(shapes) <= 1, shapes
    assert dead == jdead
    for i in range(2):
        _equal(frames[i], jframes[i], f'stream {i} vs jsmpeg_tpu')


def test_unknown_mode_refused():
    """A mode other than the three raises before any device is touched."""
    with pytest.raises(ValueError, match='unknown'):
        MultiStreamDecoder(2, mode='lockstep', device='cpu')
    with pytest.raises(ValueError, match='unknown'):
        decode_streams_offline([b''], mode='lockstep', device='cpu')


def test_device_error_propagates_never_quarantines(monkeypatch, tmp_path):
    """Only the parse is guarded: an error of the kernel path (here the
    frame-loop entry point raising as a failed launch would) propagates
    out of decode_batch and out of serve(), and marks no feed dead."""
    from jsmpeg_tpu_torch.ops import frame
    from jsmpeg_tpu_torch.serve import serve
    from jsmpeg_tpu_torch.testing.ts_mux import mux_video

    es, chunks = encode_test_stream(48, 32, n_frames=3, seed=16, gop=3)
    v = chunks[:-1]
    v[-1] += chunks[-1]
    (tmp_path / 'a.ts').write_bytes(mux_video(v, 25.0))

    def launch_failed(*a, **kw):
        raise RuntimeError('mc_combine: CUDA error: launch failed')

    monkeypatch.setattr(frame, 'mc_combine', launch_failed)
    dec = MultiStreamDecoder(2, batch_frames=4, quarantine=True,
                             device='cpu')
    dec.write(0, es)
    dec.write(1, es)
    with pytest.raises(RuntimeError, match='launch failed'):
        dec.decode_batch(eof=True)
    assert dec.dead == [None, None]
    with pytest.raises(RuntimeError, match='launch failed'):
        serve([str(tmp_path / 'a.ts')], device='cpu')


def test_streaming_bound_per_stream():
    """streaming may name each stream: the live one (True) drops its
    unread bytes past buffer_size, as jsmpeg_tpu's streaming fleet does;
    the static one (False) keeps them and decodes whole."""
    es = encode_realistic_stream(64, 48, n_frames=8, seed=17, gop=4)[0]
    assert len(es) > 1000
    dec = MultiStreamDecoder(2, batch_frames=2, streaming=[True, False],
                             buffer_size=500, device='cpu')
    jdec = jstreams.MultiStreamDecoder(2, batch_frames=2, streaming=True,
                                       buffer_size=500, mode='roundrobin')
    for d in (dec, jdec):
        d.write(0, es)
        d.write(1, es)
    frames, jframes = _np(dec.decode_all()), _np(jdec.decode_all())
    _equal(frames[0], jframes[0], 'live stream vs jsmpeg_tpu')
    assert len(frames[0]) < 8
    _equal(frames[1], _single(es), 'static stream vs single')
    with pytest.raises(ValueError, match='streaming flags'):
        MultiStreamDecoder(2, streaming=[True], device='cpu')


# ------------------------------------------------------------ joint modes

def test_three_streams_bit_exact_stacked():
    """The fleet of test_three_streams_bit_exact through the stacked mode
    (unequal frame counts within ONE joint round)."""
    streams = [
        encode_realistic_stream(192, 112, n_frames=10, seed=s, gop=5)[0]
        for s in (1, 2)]
    streams.append(encode_realistic_stream(192, 112, n_frames=4, seed=9,
                                           gop=4)[0])
    got = decode_streams_offline(streams, batch_frames=16, mode='stacked',
                                 device='cpu')
    _check(streams, got, mode='stacked', batch_frames=16)


@pytest.mark.parametrize('mode', JOINT)
def test_alternate_modes_bit_exact(mode):
    """The joint modes on an unequal-length stream and multi-batch
    carries (the round-robin case is test_incremental_write_and_eof_tail)."""
    streams = [
        encode_realistic_stream(160, 96, n_frames=9, seed=s, gop=4)[0]
        for s in (71, 72)]
    streams.append(
        encode_realistic_stream(160, 96, n_frames=3, seed=73, gop=3)[0])
    dec = MultiStreamDecoder(3, batch_frames=4, mode=mode, device='cpu')
    for i, es in enumerate(streams):
        dec.write(i, es)
    _check(streams, dec.decode_all(eof=True), mode=mode, batch_frames=4)


def _edge_stream(w, h, n_frames, seed):
    """An I picture, then P pictures whose top macroblock row predicts
    from 10 to 30 rows above the frame and whose bottom row predicts
    from as far below it (f_code 3): only the frame-edge row clamp keeps
    those reads in the picture.  (The test encoder's own P pictures
    never read outside the frame.)"""
    from jsmpeg_tpu_torch import tables as T
    from jsmpeg_tpu_torch.testing.bitwriter import BitWriter
    from jsmpeg_tpu_torch.testing.gen import _intra_levels, make_ycbcr_frame
    from jsmpeg_tpu_torch.testing.mpeg1_enc import MB, MPEG1Encoder
    rng = np.random.default_rng(seed)
    enc = MPEG1Encoder(w, h, qscale=8, f_code=3)
    chunks = []
    for t in range(n_frames):
        enc.w = BitWriter()
        if t == 0:
            enc.sequence_header()
            enc.gop_header()
            y, cb, cr = make_ycbcr_frame(w, h, t, seed)
            enc.encode_picture(T.PIC_I, [
                MB('intra', levels=_intra_levels(y, cb, cr, r, c, 8,
                                                 enc.intra_q))
                for r in range(enc.mb_h) for c in range(enc.mb_w)])
        else:
            mbs = []
            for r in range(enc.mb_h):
                reach = int(rng.integers(20, 62))
                for c in range(enc.mb_w):
                    mv_v = (-reach if r == 0 else reach if r == enc.mb_h - 1
                            else int(rng.integers(-8, 9)))
                    mbs.append(MB('mc', mv=(int(rng.integers(-8, 9)), mv_v)))
            enc.encode_picture(T.PIC_P, mbs)
        chunks.append(enc.getvalue())
    return b''.join(chunks) + b'\x00\x00\x01\xb7'


def test_stacked_segment_clamp_is_load_bearing():
    """Streams whose vectors reach past their own frame edges, where the
    single-stream decode clamps at the frame edge: stacked, each must
    clamp at its SEGMENT edge and never read the neighbouring stream.
    The same stream above, below and between different neighbours (only
    there do both of its edges border another stream) gives identical
    frames: an f_code=5 stream (test_multistream.py's case) and one whose
    edge rows point 10-30 rows outside the picture."""
    wide = encode_test_stream(96, 64, n_frames=5, seed=81, gop=5,
                              f_code=5)[0]
    edge = _edge_stream(96, 64, n_frames=5, seed=84)
    a = encode_realistic_stream(96, 64, n_frames=5, seed=82, gop=5)[0]
    b = encode_test_stream(96, 64, n_frames=5, seed=83, gop=5,
                           qscale=8)[0]
    for es in (wide, edge):
        outs = [decode_streams_offline(fleet, batch_frames=8,
                                       mode='stacked', device='cpu')
                for fleet in ([es, a], [b, es], [a, es, b])]
        _check([es, a], outs[0], mode='stacked', batch_frames=8)
        _check([b, es], outs[1], mode='stacked', batch_frames=8)
        _check([a, es, b], outs[2], mode='stacked', batch_frames=8)
        for p, q, r in zip(outs[0][0], outs[1][1], outs[2][1]):
            np.testing.assert_array_equal(p.y.numpy(), q.y.numpy())
            np.testing.assert_array_equal(p.y.numpy(), r.y.numpy())


@pytest.mark.parametrize('mode', JOINT)
def test_wide_mv_stream_joint_with_narrow(mode):
    """One f_code=5 stream (vectors beyond int8 records) jointly with a
    narrow one: the joint round takes wide records and stays exact."""
    wide = encode_test_stream(192, 112, n_frames=6, seed=31, gop=3,
                              f_code=5)[0]
    narrow = encode_realistic_stream(192, 112, n_frames=6, seed=32,
                                     gop=3)[0]
    got = decode_streams_offline([wide, narrow], batch_frames=8, mode=mode,
                                 device='cpu')
    _check([wide, narrow], got, mode=mode, batch_frames=8)


@pytest.mark.parametrize('mode', JOINT)
def test_multi_batch_carry_joint(mode):
    """test_multi_batch_carry in the joint modes: the joint carry threads
    through rounds."""
    streams = [
        encode_realistic_stream(160, 96, n_frames=13, seed=s, gop=4)[0]
        for s in (5, 6)]
    got = decode_streams_offline(streams, batch_frames=5, mode=mode,
                                 device='cpu')
    _check(streams, got, mode=mode, batch_frames=5)


@pytest.mark.parametrize('mode', JOINT)
def test_incremental_write_and_eof_tail_joint(mode):
    """test_incremental_write_and_eof_tail in the joint modes: the short
    stream rides later rounds as a segment of zero frames."""
    a = encode_realistic_stream(160, 96, n_frames=12, seed=11, gop=6)[0]
    b = encode_realistic_stream(160, 96, n_frames=3, seed=12, gop=3)[0]
    dec = MultiStreamDecoder(2, batch_frames=4, mode=mode, device='cpu')
    dec.write(0, a)
    dec.write(1, b)
    kernels.reset_launches()
    frames = dec.decode_all(eof=True)
    assert kernels.launches == {'dequant_idct': 0, 'mc_combine': 0,
                                'wire_unpack': 0}
    _check([a, b], frames, mode=mode, batch_frames=4)


@pytest.mark.parametrize('mode', JOINT)
def test_round_is_one_joint_decode(mode, monkeypatch):
    """Each round with frames is ONE decode_levels call (one K1 and one
    K2 launch on the card) over the S streams as segments, seg_frames =
    the streams' frame counts; the outputs are cut per stream, and the
    carry has the mode's layout, [S*H, W] stacked or [S, H, W] vmap."""
    from jsmpeg_tpu_torch.parallel import streams as tstreams
    calls = []

    def counting(*a, **kw):
        calls.append((a[2].qscale.shape, kw['n_seg'], list(kw['seg_frames'])))
        return decode_levels(*a, **kw)

    monkeypatch.setattr(tstreams, 'decode_levels', counting)
    a = encode_realistic_stream(64, 48, n_frames=7, seed=13, gop=3)[0]
    b = encode_realistic_stream(64, 48, n_frames=2, seed=14, gop=2)[0]
    dec = MultiStreamDecoder(3, batch_frames=4, mode=mode, device='cpu')
    dec.write(0, a)
    dec.write(1, b)
    counts = []
    while (outs := dec.decode_batch(eof=True)) is not None:
        counts.append([st.y.shape[0] for st in outs])
        for st in outs:
            assert st.y.shape[1:] == (48, 64) and st.cr.shape[1:] == (24, 32)
    assert counts == [[4, 2, 0], [3, 0, 0]]
    assert calls == [((4, 36), 3, [4, 2, 0]), ((3, 36), 3, [3, 0, 0])]
    lead = (3 * 48,) if mode == 'stacked' else (3, 48)
    assert tuple(dec._carry[1].y.shape) == lead + (64,)
    cur, fwd = dec._carry_pair(1)
    assert tuple(fwd.y.shape) == (48, 64) and fwd.y.is_contiguous()
    assert torch.equal(fwd.y, torch.as_tensor(_single(b)[1][0]))


@pytest.mark.parametrize('mode', JOINT)
def test_quarantine_isolates_bad_feed_joint(mode):
    """A mismatched feed is quarantined and rides as a dead segment; the
    good feed keeps decoding bit-exactly."""
    good = encode_realistic_stream(160, 96, n_frames=6, seed=55, gop=3)[0]
    bad = encode_realistic_stream(192, 112, n_frames=4, seed=56, gop=2)[0]
    dec = MultiStreamDecoder(2, batch_frames=4, quarantine=True, mode=mode,
                             device='cpu')
    dec.write(0, good)
    dec.write(1, bad)
    frames = dec.decode_all(eof=True)
    jdec = jstreams.MultiStreamDecoder(2, batch_frames=4, quarantine=True,
                                       mode=mode)
    jdec.write(0, good)
    jdec.write(1, bad)
    jframes = jdec.decode_all(eof=True)
    assert dec.dead == jdec.dead and dec.dead[0] is None
    assert dec.dead[1] and 'resolution' in dec.dead[1]
    assert len(frames[1]) == len(jframes[1]) == 0
    _check([good], [frames[0]], jax_got=[jframes[0]])


@pytest.mark.parametrize('mode', JOINT)
def test_demotion_keeps_quirk_stream_decoding_joint(mode):
    """test_demotion_keeps_quirk_stream_decoding in the joint modes: the
    demoted decoder adopts the stream's rows of the joint carry."""
    quirk = escape_zero_stream(48, 32)
    clean = encode_test_stream(48, 32, n_frames=4, seed=61, gop=2,
                               qscale=8)[0]
    dec = MultiStreamDecoder(2, batch_frames=4, quarantine=True, mode=mode,
                             device='cpu')
    dec.write(0, clean)
    dec.write(1, quirk)
    frames = dec.decode_all(eof=True)
    assert dec.dead == [None, None]
    assert 1 in dec._demoted
    ref_quirk = OracleMPEG1(quirk).decode_all()
    assert len(frames[1]) == len(ref_quirk) == 2
    for p, r in zip(frames[1], ref_quirk):
        for a, b in zip(p, r):
            np.testing.assert_array_equal(a.numpy(), b)
    _check([clean, quirk], frames, mode=mode, batch_frames=4,
           quarantine=True)


@pytest.mark.parametrize('n_mb', [12, 3600, 65535, 150000])
def test_pad_frame_dict_matches_jax(n_mb):
    """The padding slab of a missing stream-frame: runs of at most
    _RUN_CAP macroblocks, byte for byte jsmpeg_tpu's."""
    got, want = _pad_frame_dict(n_mb), jstreams._pad_frame_dict(n_mb)
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert int(got['run_len'].astype(np.int64).sum()) == n_mb


def _stream_frames(es, n):
    """The first n per-frame packed dicts of a stream, and its sequence
    header."""
    p = best_parser()
    p.write(es)
    return split_packed_frames(p.parse_batch(n, eof=True))[:n], p.seq


def _four_streams():
    """Four 64x48 streams of 8 frames: wide vectors (f_code 5, reaching
    past every segment edge), realistic and test content."""
    ess = [encode_test_stream(64, 48, n_frames=8, seed=91, gop=8,
                              f_code=5)[0],
           encode_realistic_stream(64, 48, n_frames=8, seed=92, gop=4)[0],
           encode_test_stream(64, 48, n_frames=8, seed=93, gop=3)[0],
           encode_realistic_stream(64, 48, n_frames=8, seed=94, gop=8)[0]]
    return [_stream_frames(es, 8) for es in ess]


def test_stack_stream_frames_matches_jax():
    """The joint batch and valid mask, byte for byte jsmpeg_tpu's, with
    an idle stream and unequal counts."""
    streams = _four_streams()
    per_stream = [fr[:c] for (fr, _), c in zip(streams, (5, 0, 2, 8))]
    n_mb = streams[0][1].mb_size
    got, gvalid = stack_stream_frames(per_stream, n_mb, 8)
    want, wvalid = jstreams.stack_stream_frames(per_stream, n_mb, 8)
    np.testing.assert_array_equal(gvalid, wvalid)
    assert got.keys() == want.keys()
    for k in got:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype, k
        np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.mark.parametrize('order', [(0, 1, 2, 3), (2, 0, 3, 1)])
def test_decode_levels_segments_match_decode_scan_fused(order):
    """decode_levels(n_seg=4, seg_frames) against jsmpeg_tpu's
    decode_scan_fused(n_seg=4, valid_seg) on the SAME joint wire buffer,
    from random carry planes (every segment different), seg_frames
    holding 0, 1, F-1 and F; then a second batch from each side's carry
    with the counts reversed.  The P pictures' vectors are replaced by
    random ones of up to 150 pixels, past every segment edge.  Every
    output frame (the rows of a segment past its count are its forward
    plane's) and the carry equal."""
    rng = np.random.default_rng(sum(order))
    streams = [([dict(f, run_mv=rng.integers(-300, 301, f['run_mv'].shape)
                      .astype(np.int16)) if f['pic_type'] == 2 else f
                 for f in frames], seq)
               for frames, seq in (_four_streams()[i] for i in order)]
    seq = streams[0][1]
    S, F, n_mb = 4, 4, seq.mb_size
    H, W = S * seq.coded_height, seq.coded_width
    planes = lambda: tuple(rng.integers(0, 256, s, dtype=np.uint8)
                           for s in ((H, W), (H // 2, W // 2),
                                     (H // 2, W // 2)))
    cur, fwd = planes(), planes()
    tcur, tfwd, tiq, tnq = state_from_numpy(
        cur, fwd, seq.intra_quant_matrix, seq.non_intra_quant_matrix, 'cpu')
    jcur, jfwd = JPlanes(*map(jnp.asarray, cur)), JPlanes(*map(jnp.asarray,
                                                                fwd))
    jq = (jnp.asarray(seq.intra_quant_matrix, jnp.int32),
          jnp.asarray(seq.non_intra_quant_matrix, jnp.int32))
    done = [0] * S
    for counts in ([0, 1, F - 1, F], [F, F - 1, 1, 0]):
        per_stream = [fr[d:d + c] for (fr, _), d, c in
                      zip(streams, done, counts)]
        done = [d + c for d, c in zip(done, counts)]
        joint, valid = stack_stream_frames(per_stream, n_mb, F)
        buf, n_blk, n_runs, wide, n_pairs, n_esc = jmpeg1.build_fused_buffer(
            joint, F, S * n_mb)
        jcur, jfwd, jouts = jmpeg1.decode_scan_fused(
            jcur, jfwd, jnp.asarray(buf), *jq, mb_h=S * seq.mb_height,
            mb_w=seq.mb_width, n_frames=F, n_blk=n_blk, n_runs=n_runs,
            mv_wide=wide, n_pairs=n_pairs, n_esc=n_esc, n_seg=S,
            valid_seg=jnp.asarray(valid))
        la = packed_to_levels(*unpack_fused(
            torch.as_tensor(buf), F, S * n_mb, n_runs, wide, n_pairs, n_esc),
            n_blk)
        tcur, tfwd, touts = decode_levels(tcur, tfwd, la, tiq, tnq,
                                          n_seg=S, seg_frames=counts)
        for got, want in ((touts.planes, jouts), (tcur, jcur),
                          (tfwd, jfwd)):
            for pn, g, w in zip('y cr cb'.split(), got, want):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                              err_msg=f'{counts} {pn}')


@pytest.mark.parametrize('mode', JOINT)
def test_feeds_at_unequal_rates_joint(mode):
    """Two feeds whose bytes arrive at different rates (4096 and 1500
    bytes a round): most rounds give the streams unequal frame counts and
    both go on decoding later, so each segment's carry must come from its
    own last frames.  Every frame equals jsmpeg_tpu's fleet in the same
    mode fed the same chunks, and the single-stream decode."""
    ess = [encode_realistic_stream(160, 96, n_frames=14, seed=s, gop=5)[0]
           for s in (57, 58)]
    dec = MultiStreamDecoder(2, batch_frames=4, mode=mode, device='cpu')
    jdec = jstreams.MultiStreamDecoder(2, batch_frames=4, mode=mode)
    got, want, unequal = [[], []], [[], []], 0

    def collect(outs, into):
        counts = [st.y.shape[0] for st in outs or []]
        for i, st in enumerate(outs or []):
            for f in range(st.y.shape[0]):
                into[i].append(tuple(np.asarray(x[f]) for x in st))
        return counts

    for r in range(max(-(-len(es) // step)
                       for es, step in zip(ess, (4096, 1500)))):
        for i, step in enumerate((4096, 1500)):
            dec.write(i, ess[i][r * step:(r + 1) * step])
            jdec.write(i, ess[i][r * step:(r + 1) * step])
        counts = collect(dec.decode_batch(), got)
        collect(jdec.decode_batch(), want)
        unequal += len(set(counts)) > 1 and min(counts) > 0
    for d, into in ((dec, got), (jdec, want)):
        while (outs := d.decode_batch(eof=True)) is not None:
            collect(outs, into)
    assert unequal >= 2
    for i in range(2):
        _equal(got[i], want[i], f'stream {i} vs jsmpeg_tpu')
        _equal(got[i], _single(ess[i]), f'stream {i} vs single')


@pytest.mark.parametrize('mode', ['roundrobin'] + JOINT)
def test_fleet_modes_run_the_compact_form(mode, monkeypatch):
    """Each fleet mode's rounds reach K1 in its compact form only (a
    joint round as one call whose rows are its streams' coded blocks:
    the stacked wire numbers them exactly, the vmap stack pads each
    stream to the largest count with unnamed rows), and the frames equal
    each stream's own decode and jsmpeg_tpu's same mode."""
    from tests.test_torch_unpack import k1_calls
    streams = [encode_realistic_stream(96, 64, n_frames=n, seed=s, gop=4)[0]
               for n, s in ((6, 81), (4, 82), (6, 83))]
    calls = k1_calls(monkeypatch)
    dec = MultiStreamDecoder(3, batch_frames=4, mode=mode, device='cpu')
    for i, es in enumerate(streams):
        dec.write(i, es)
    got = dec.decode_all(eof=True)
    assert calls and {c[0] for c in calls} == {'compact'}
    if mode == 'roundrobin':
        assert len(calls) == 5          # 2, 1 and 2 batches
        assert all(c[1] == c[2] for c in calls)
    else:
        assert len(calls) == 2          # 2 rounds, one call each
        rows = [c[1] for c in calls]
        named = [c[2] for c in calls]
        if mode == 'stacked':
            assert rows == named
        else:
            assert all(r % 3 == 0 and r >= n for r, n in zip(rows, named))
            assert rows != named        # the shorter streams pad
    _check(streams, got, mode=mode, batch_frames=4)

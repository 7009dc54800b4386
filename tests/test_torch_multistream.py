"""The port's round-robin MultiStreamDecoder (jsmpeg_tpu_torch.parallel
.streams) on the CPU, case for case the round-robin cases of
tests/test_multistream.py: every stream's frames equal, with tolerance 0,
to jsmpeg_tpu's decode_streams_offline(..., mode='roundrobin') on the
same bytes and to the port's single-stream decoder."""

import numpy as np
import pytest

from jsmpeg_tpu.parallel import streams as jstreams
from jsmpeg_tpu_torch.models.mpeg1 import FrameSeq, MPEG1Decoder
from jsmpeg_tpu_torch.ops import kernels
from jsmpeg_tpu_torch.parallel.streams import (MultiStreamDecoder,
                                               decode_streams_offline)
from jsmpeg_tpu_torch.testing.gen import (encode_realistic_stream,
                                          encode_test_stream)
from jsmpeg_tpu_torch.testing.quirks import escape_zero_stream
from tests.oracle.ref_mpeg1 import OracleMPEG1

CPU = {'device': 'cpu'}


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


def _check(streams, got, jax_got=None, **kw):
    """Port frames == the port's single-stream decode == jsmpeg_tpu's
    round-robin fleet on the same bytes."""
    if jax_got is None:
        jax_got = jstreams.decode_streams_offline(
            streams, mode='roundrobin', **kw)
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
    assert kernels.launches == {'dequant_idct': 0, 'mc_combine': 0}
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


@pytest.mark.parametrize('mode', ['stacked', 'vmap'])
def test_unported_modes_refused(mode):
    """The joint formulations are not ported yet: a ValueError naming
    the ROADMAP item that brings them, before any device is touched."""
    with pytest.raises(ValueError, match='ROADMAP'):
        MultiStreamDecoder(2, mode=mode, device='cpu')
    with pytest.raises(ValueError, match='ROADMAP'):
        decode_streams_offline([b''], mode=mode, device='cpu')
    with pytest.raises(ValueError, match='unknown'):
        MultiStreamDecoder(2, mode='lockstep', device='cpu')


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

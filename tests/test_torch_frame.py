"""The port's motion compensation and frame step (jsmpeg_tpu_torch.ops)
against jsmpeg_tpu.ops on the same numpy inputs: mc_gather / chroma_mv
against the JAX gather formulation, mc_combine_ref against
decode_frame_planes, the batch frame loop (decode_frames_ref, and
decode_frames' per-frame views and carry) on random and on real I and P
pictures against decode_frame_step stepped (valid and padding) from the
same carry.  Exact equality throughout."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jsmpeg_tpu.ops import frame as jframe
from jsmpeg_tpu.ops import motion as jmotion
from jsmpeg_tpu_torch.host.mpeg1_parse import MPEG1Parser
from jsmpeg_tpu_torch.models.mpeg1 import (decode_coef, frame_to_arrays,
                                           stack_frames, state_from_numpy)
from jsmpeg_tpu_torch.ops import frame as tframe
from jsmpeg_tpu_torch.ops import kernels
from jsmpeg_tpu_torch.ops import motion as tmotion
from jsmpeg_tpu_torch.testing.gen import encode_test_stream

MB_H, MB_W = 4, 5


def _mvs(rng, n, reach):
    """Vectors of every half-pel parity, past every frame edge, wider
    than int8 and negative odd (the chroma rounding toward zero)."""
    mv = rng.integers(-reach, reach + 1, (n, 2)).astype(np.int32)
    mv[:4] = [[-1, -1], [1, 0], [0, 1], [-3, 5]]
    mv[4:6] = [[-300, 299], [255, -255]]
    return mv


def _planes(rng, mb_h=MB_H, mb_w=MB_W):
    H, W = mb_h * 16, mb_w * 16
    return tuple(rng.integers(0, 256, s, dtype=np.uint8)
                 for s in ((H, W), (H // 2, W // 2), (H // 2, W // 2)))


@pytest.mark.parametrize('block,reach', [(16, 9), (16, 200), (8, 9),
                                         (8, 200)])
def test_mc_gather_matches_jax(block, reach):
    rng = np.random.default_rng(block + reach)
    ref = rng.integers(0, 256, (MB_H * block, MB_W * block), dtype=np.uint8)
    mv = _mvs(rng, MB_H * MB_W, reach)
    assert len({(int(a) & 1, int(b) & 1) for a, b in mv}) == 4
    got = tmotion.mc_gather(torch.as_tensor(ref), torch.as_tensor(mv[:, 0]),
                            torch.as_tensor(mv[:, 1]), MB_H, MB_W, block)
    want = jmotion.motion_compensate(
        jnp.asarray(ref), jnp.asarray(mv[:, 0]), jnp.asarray(mv[:, 1]),
        MB_H, MB_W, block, method='gather')
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_chroma_mv_matches_jax():
    mv = np.arange(-600, 601, dtype=np.int32)
    got = tmotion.chroma_mv(torch.as_tensor(mv))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jmotion.chroma_mv(
                                      jnp.asarray(mv))))
    assert got[599].item() == -0 and got[598].item() == -1   # -1, -2


def _random_frame(rng):
    """Random flags (written / coded per block / intra), vectors and
    residuals, including residuals whose base + r wraps int32.  Returns
    (coded, intra, written, mv, resid) numpy arrays."""
    n_mb = MB_H * MB_W
    mv = _mvs(rng, n_mb, 300)
    resid = rng.integers(-400, 400, (n_mb, 6, 64)).astype(np.int32)
    resid[0, 0, :3] = [2**31 - 1, -2**31, 2**31 - 100]
    coded = rng.random((n_mb, 6)) < 0.5
    intra = rng.random(n_mb) < 0.3
    written = rng.random(n_mb) < 0.7
    return coded, intra, written, mv, resid


def _meta(coded, intra, written, mv):
    return tframe.frame_meta(torch.as_tensor(coded), torch.as_tensor(intra),
                             torch.as_tensor(written),
                             torch.as_tensor(mv[..., 0]),
                             torch.as_tensor(mv[..., 1]))


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_mc_combine_ref_matches_decode_frame_planes(seed):
    """One random frame through mc_combine_ref against
    decode_frame_planes; the batch entry point on a 1-frame batch of CPU
    tensors takes the plain version and launches nothing."""
    rng = np.random.default_rng(seed)
    n_mb = MB_H * MB_W
    cur, fwd = _planes(rng), _planes(rng)
    coded, intra, written, mv, resid = _random_frame(rng)
    meta = _meta(coded, intra, written, mv)
    tcur, tfwd, _, _ = state_from_numpy(cur, fwd, np.zeros(64),
                                        np.zeros(64), 'cpu')
    got = tframe.mc_combine_ref(tcur, tfwd, torch.as_tensor(resid), meta)
    f = jframe.FrameArrays(
        coef=jnp.zeros((n_mb, 6, 64), jnp.int32), coded=jnp.asarray(coded),
        intra=jnp.asarray(intra), written=jnp.asarray(written),
        mv_h=jnp.asarray(mv[:, 0]), mv_v=jnp.asarray(mv[:, 1]),
        valid=jnp.asarray(True))
    want = jframe.decode_frame_planes(
        jframe.Planes(*map(jnp.asarray, cur)),
        jframe.Planes(*map(jnp.asarray, fwd)), f, MB_H, MB_W,
        resid=jnp.asarray(resid).reshape(n_mb, 6, 8, 8), mc_method='gather')
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # the entry point takes the plain version on CPU tensors
    kernels.reset_launches()
    again = tframe.mc_combine(tcur, tfwd, torch.as_tensor(resid)[None],
                              meta[None])
    assert kernels.launches['mc_combine'] == 0
    for g, a in zip(got, again):
        assert a.shape == (1,) + g.shape
        assert torch.equal(g, a[0])


def _pictures():
    """FrameData of an I and a P picture of a real stream."""
    es, _ = encode_test_stream(MB_W * 16, MB_H * 16, n_frames=2, seed=12,
                               gop=2, f_code=3)
    p = MPEG1Parser()
    p.write(es)
    return p.parse_frame(eof=True), p.parse_frame(eof=True)


def _port_decode(cur, fwd, fas):
    """The port's serial path (decode_coef: K1's IDCT-only mode over the
    stack, then the frame loop decode_frames) from numpy planes."""
    tcur, tfwd, _, _ = state_from_numpy(cur, fwd, np.zeros(64),
                                        np.zeros(64), 'cpu')
    st = stack_frames(fas)
    return decode_coef(tcur, tfwd,
                       tframe.FrameArrays(*[torch.as_tensor(x) for x in st]))


def _jax_steps(cur, fwd, steps, resids=None):
    """jsmpeg_tpu's decode_frame_step over (FrameArrays, valid) steps
    (with precomputed [n_mb, 6, 64] residuals per step when `resids` is
    given); returns the final carry and the outputs of the valid steps."""
    carry = (jframe.Planes(*map(jnp.asarray, cur)),
             jframe.Planes(*map(jnp.asarray, fwd)))
    outs = []
    for i, (fa, valid) in enumerate(steps):
        jf = jframe.FrameArrays(*[jnp.asarray(x) for x in fa],
                                valid=jnp.asarray(valid))
        resid = (None if resids is None
                 else jnp.asarray(resids[i]).reshape(-1, 6, 8, 8))
        carry, out = jframe.decode_frame_step(carry, jf, MB_H, MB_W,
                                              resid=resid,
                                              mc_method='gather')
        if valid:
            outs.append(out)
    return carry, outs


def _assert_planes_equal(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize('pic', [0, 1])
@pytest.mark.parametrize('valid', [True, False])
def test_decode_frame_step_matches_jax(pic, valid):
    """One picture through the port from the same carry as one
    decode_frame_step of jsmpeg_tpu (random planes, so uncoded
    macroblocks expose the stale `cur`).  valid=False puts a JAX padding
    frame before the picture: the port never pads, decodes the picture
    alone, and must end on the same carry."""
    fd = _pictures()[pic]
    assert fd.pic_type == (1 if pic == 0 else 2)
    rng = np.random.default_rng(20 + pic)
    cur, fwd = _planes(rng), _planes(rng)
    fa = frame_to_arrays(fd)
    gcur, gfwd, gouts = _port_decode(cur, fwd, [fa])
    steps = [(fa, True)] if valid else [(fa, False), (fa, True)]
    (wcur, wfwd), wouts = _jax_steps(cur, fwd, steps)
    assert len(gouts) == len(wouts) == 1
    for got, want in ((gcur, wcur), (gfwd, wfwd), (gouts[0], wouts[0])):
        _assert_planes_equal(got, want)


@pytest.mark.parametrize('n_frames', [2, 4])
def test_decode_frames_rotation(n_frames):
    """decode_frames' rotation over a stack of I, P, I, P pictures
    equals stepping jsmpeg_tpu's decode_frame_step: frame k reads
    fwd = output k-1 and cur = output k-2."""
    fas = [frame_to_arrays(fd) for fd in _pictures()] * 2
    rng = np.random.default_rng(30)
    cur, fwd = _planes(rng), _planes(rng)
    gcur, gfwd, gouts = _port_decode(cur, fwd, fas[:n_frames])
    (wcur, wfwd), wouts = _jax_steps(cur, fwd,
                                     [(fa, True) for fa in fas[:n_frames]])
    assert len(gouts) == len(wouts) == n_frames
    for got, want in zip(list(gouts) + [gcur, gfwd],
                         wouts + [wcur, wfwd]):
        _assert_planes_equal(got, want)


def _random_batch(seed, n_frames):
    """Carry planes and n_frames random frames: the port's (resid, meta)
    tensors and jsmpeg_tpu's steps with their residuals."""
    rng = np.random.default_rng(seed)
    cur, fwd = _planes(rng), _planes(rng)
    frames = [_random_frame(rng) for _ in range(n_frames)]
    n_mb = MB_H * MB_W
    steps = [((np.zeros((n_mb, 6, 64), np.int32), coded, intra, written,
               mv[:, 0], mv[:, 1]), True)
             for coded, intra, written, mv, _ in frames]
    resids = [f[4] for f in frames]
    meta = torch.stack([_meta(*f[:4]) for f in frames])
    return cur, fwd, torch.as_tensor(np.stack(resids)), meta, steps, resids


def _planes_at(batch, k):
    return tframe.Planes(*[p[k] for p in batch])


@pytest.mark.parametrize('n_frames', [1, 2, 4])
def test_decode_frames_ref_matches_jax_steps(n_frames):
    """decode_frames_ref over a batch of random frames: its [F, ...]
    outputs and the carry they leave (the last two frames; for F = 1 the
    old fwd and the frame) equal decode_frame_step stepped, bit for bit."""
    cur, fwd, resid, meta, steps, resids = _random_batch(40 + n_frames,
                                                         n_frames)
    tcur, tfwd, _, _ = state_from_numpy(cur, fwd, np.zeros(64),
                                        np.zeros(64), 'cpu')
    got = tframe.decode_frames_ref(tcur, tfwd, resid, meta)
    (wcur, wfwd), wouts = _jax_steps(cur, fwd, steps, resids)
    H, W = MB_H * 16, MB_W * 16
    assert tuple(got.y.shape) == (n_frames, H, W)
    assert tuple(got.cr.shape) == tuple(got.cb.shape) == (n_frames, H // 2,
                                                          W // 2)
    for k in range(n_frames):
        _assert_planes_equal([p[k] for p in got], wouts[k])
    gcur = _planes_at(got, n_frames - 2) if n_frames >= 2 else tfwd
    _assert_planes_equal(gcur, wcur)
    _assert_planes_equal(_planes_at(got, n_frames - 1), wfwd)


@pytest.mark.parametrize('n_frames', [1, 2, 3])
def test_decode_frames_views_alias_the_batch(n_frames):
    """decode_frames hands out each frame as views into the batch tensors
    (frame k at byte offset k * plane size) and the carry as views of the
    last two frames; the batch equals decode_frames_ref."""
    cur, fwd, resid, meta, _, _ = _random_batch(50 + n_frames, n_frames)
    tcur, tfwd, _, _ = state_from_numpy(cur, fwd, np.zeros(64),
                                        np.zeros(64), 'cpu')
    gcur, gfwd, outs = tframe.decode_frames(tcur, tfwd, resid, meta)
    want = tframe.decode_frames_ref(tcur, tfwd, resid, meta)
    assert len(outs) == n_frames
    bases = [outs[0][i]._base for i in range(3)]
    for i, base in enumerate(bases):
        assert torch.equal(base, want[i])
        size = base[0].numel()
        at = lambda k: base.data_ptr() + k * size
        for k, out in enumerate(outs):
            assert out[i]._base is base
            assert out[i].data_ptr() == at(k)
        assert gfwd[i].data_ptr() == at(n_frames - 1)
        if n_frames >= 2:
            assert gcur[i].data_ptr() == at(n_frames - 2)
    if n_frames == 1:
        assert gcur is tfwd


# ---------------------------------------------------------------- segments

@pytest.mark.parametrize('block,n_seg', [(16, 2), (16, 4), (8, 2), (8, 4)])
def test_mc_gather_segments_match_jax(block, n_seg):
    """mc_gather(n_seg) against jsmpeg_tpu's _mc_gather(n_seg): vectors
    of every parity reaching past every segment edge, each output row
    clamped to its own segment."""
    rng = np.random.default_rng(block * n_seg)
    ref = rng.integers(0, 256, (MB_H * block, MB_W * block), dtype=np.uint8)
    mv = _mvs(rng, MB_H * MB_W, 3 * block)
    got = tmotion.mc_gather(torch.as_tensor(ref), torch.as_tensor(mv[:, 0]),
                            torch.as_tensor(mv[:, 1]), MB_H, MB_W, block,
                            n_seg)
    want = jmotion._mc_gather(jnp.asarray(ref), jnp.asarray(mv[:, 0]),
                              jnp.asarray(mv[:, 1]), MB_H, MB_W, block,
                              n_seg=n_seg)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the clamp is load-bearing: one plane gives another prediction
    whole = tmotion.mc_gather(torch.as_tensor(ref), torch.as_tensor(mv[:, 0]),
                              torch.as_tensor(mv[:, 1]), MB_H, MB_W, block)
    assert not torch.equal(got, whole)


def test_mc_gather_refuses_uneven_segments():
    ref = torch.zeros((MB_H * 16, MB_W * 16), dtype=torch.uint8)
    mv = torch.zeros(MB_H * MB_W, dtype=torch.int32)
    with pytest.raises(ValueError, match='segments'):
        tmotion.mc_gather(ref, mv, mv, MB_H, MB_W, 16, 3)


@pytest.mark.parametrize('seg_frames', [[0, 3], [0, 1, 2, 3], [3, 1, 0, 2]])
def test_decode_frames_segments_match_jax_steps(seg_frames):
    """A batch of F = 3 random frames over len(seg_frames) segments,
    segment s live for its first seg_frames[s] frames: decode_frames_ref's
    outputs (a segment past its count shows its forward plane's rows)
    equal decode_frame_step stepped with valid [n_seg] and n_seg, and
    decode_frames' carry is each segment's own last two frames (for a
    count of 1 the old fwd and the frame, for 0 the old carry)."""
    n_seg, F = len(seg_frames), 3
    cur, fwd, resid, meta, steps, resids = _random_batch(60 + n_seg, F)
    tcur, tfwd, _, _ = state_from_numpy(cur, fwd, np.zeros(64),
                                        np.zeros(64), 'cpu')
    got = tframe.decode_frames_ref(tcur, tfwd, resid, meta, n_seg,
                                   seg_frames)
    gcur, gfwd, outs = tframe.decode_frames(tcur, tfwd, resid, meta, n_seg,
                                            seg_frames)
    carry = (jframe.Planes(*map(jnp.asarray, cur)),
             jframe.Planes(*map(jnp.asarray, fwd)))
    for k, (fa, _) in enumerate(steps):
        jf = jframe.FrameArrays(*[jnp.asarray(x) for x in fa], valid=(
            jnp.asarray([k < c for c in seg_frames])))
        carry, out = jframe.decode_frame_step(
            carry, jf, MB_H, MB_W, resid=jnp.asarray(resids[k]).reshape(
                -1, 6, 8, 8), mc_method='gather', n_seg=n_seg)
        _assert_planes_equal(_planes_at(got, k), out)
        _assert_planes_equal(outs[k], out)
    _assert_planes_equal(gcur, carry[0])
    _assert_planes_equal(gfwd, carry[1])


def test_decode_frames_uniform_segments_keep_views():
    """Segments that all decode the same count hand out the carry as
    views of the batch, as one segment does; seg_frames = F for each
    equals seg_frames=None."""
    cur, fwd, resid, meta, _, _ = _random_batch(70, 3)
    tcur, tfwd, _, _ = state_from_numpy(cur, fwd, np.zeros(64),
                                        np.zeros(64), 'cpu')
    gcur, gfwd, outs = tframe.decode_frames(tcur, tfwd, resid, meta, 2,
                                            [3, 3])
    assert gcur.y.data_ptr() == outs[1].y.data_ptr()
    assert gfwd.y.data_ptr() == outs[2].y.data_ptr()
    want = tframe.decode_frames_ref(tcur, tfwd, resid, meta, 2)
    for a, b in zip(outs.planes, want):
        assert torch.equal(a, b)

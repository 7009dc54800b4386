"""The port's motion compensation and frame step (jsmpeg_tpu_torch.ops)
against jsmpeg_tpu.ops on the same numpy inputs: mc_gather / chroma_mv
against the JAX gather formulation, mc_combine_ref against
decode_frame_planes, and the port's frame loop on real I and P pictures
against decode_frame_step (valid and padding) from the same carry.
Exact equality throughout."""

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


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_mc_combine_ref_matches_decode_frame_planes(seed):
    """Random flags (written / coded per block / intra), vectors and
    residuals, including residuals whose base + r wraps int32."""
    rng = np.random.default_rng(seed)
    n_mb = MB_H * MB_W
    cur, fwd = _planes(rng), _planes(rng)
    mv = _mvs(rng, n_mb, 300)
    resid = rng.integers(-400, 400, (n_mb, 6, 64)).astype(np.int32)
    resid[0, 0, :3] = [2**31 - 1, -2**31, 2**31 - 100]
    coded = rng.random((n_mb, 6)) < 0.5
    intra = rng.random(n_mb) < 0.3
    written = rng.random(n_mb) < 0.7
    meta = tframe.frame_meta(torch.as_tensor(coded), torch.as_tensor(intra),
                             torch.as_tensor(written),
                             torch.as_tensor(mv[:, 0]),
                             torch.as_tensor(mv[:, 1]))
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
    again = tframe.mc_combine(tcur, tfwd, torch.as_tensor(resid), meta)
    assert kernels.launches['mc_combine'] == 0
    for g, a in zip(got, again):
        assert torch.equal(g, a)


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


def _jax_steps(cur, fwd, steps):
    """jsmpeg_tpu's decode_frame_step over (FrameArrays, valid) steps;
    returns the final carry and the outputs of the valid steps."""
    carry = (jframe.Planes(*map(jnp.asarray, cur)),
             jframe.Planes(*map(jnp.asarray, fwd)))
    outs = []
    for fa, valid in steps:
        jf = jframe.FrameArrays(*[jnp.asarray(x) for x in fa],
                                valid=jnp.asarray(valid))
        carry, out = jframe.decode_frame_step(carry, jf, MB_H, MB_W,
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
    """decode_frames' host pointer swap over a stack of I, P, I, P
    pictures equals stepping jsmpeg_tpu's decode_frame_step: frame k
    reads fwd = output k-1 and cur = output k-2."""
    fas = [frame_to_arrays(fd) for fd in _pictures()] * 2
    rng = np.random.default_rng(30)
    cur, fwd = _planes(rng), _planes(rng)
    gcur, gfwd, gouts = _port_decode(cur, fwd, fas[:n_frames])
    (wcur, wfwd), wouts = _jax_steps(cur, fwd,
                                     [(fa, True) for fa in fas[:n_frames]])
    assert len(gouts) == len(wouts) == n_frames
    for got, want in zip(gouts + [gcur, gfwd], wouts + [wcur, wfwd]):
        _assert_planes_equal(got, want)

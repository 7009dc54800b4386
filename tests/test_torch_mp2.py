"""The port's MP2 audio path on the CPU against the independent oracle and
against jsmpeg_tpu, on the same seeded streams:

- the exact path (C++ or Python parser) equals the oracle and jsmpeg_tpu's
  exact path bit for bit (stereo, mono, joint stereo, low bitrate, 48 kHz);
- NativeMP2Parser equals MP2Parser in samples, synthesis state and PCM
  (the cases of tests/test_native_mp2.py);
- synthesize_device (float32, torch) is within 1e-6 of jsmpeg_tpu's
  synthesize_tpu and the device mode within 3e-5 of the oracle on
  non-saturated content, its batch within 1e-7 of its frame-by-frame
  decode (the bounds of tests/test_mp2_differential.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jsmpeg_tpu.models.mp2 import MP2Decoder as JaxMP2Decoder
from jsmpeg_tpu.ops import mp2_synth as jax_synth
from jsmpeg_tpu.testing.mp2_enc import encode_stream as jax_encode_stream
from jsmpeg_tpu_torch import tables as T
from jsmpeg_tpu_torch.host import native
from jsmpeg_tpu_torch.host.mp2_parse import MP2Parser
from jsmpeg_tpu_torch.models.mp2 import MP2Decoder
from jsmpeg_tpu_torch.ops import mp2_synth
from jsmpeg_tpu_torch.testing.mp2_enc import encode_stream
from tests.oracle.ref_mp2 import OracleMP2

CPU = {'device': 'cpu'}


def _run(dec, es):
    dec.write(0.0, es)
    outs = []
    while (f := dec.decode()) is not None:
        outs.append(f)
    return outs


EXACT_CASES = {
    'stereo': (4, dict(seed=42, mode=T.MP2_MODE_STEREO)),
    'mono': (4, dict(seed=42, mode=T.MP2_MODE_MONO)),
    'joint': (4, dict(seed=42, mode=T.MP2_MODE_JOINT_STEREO)),
    'low_bitrate': (3, dict(seed=9, bitrate_index=2, density=0.3)),
    '48khz': (3, dict(seed=10, sample_rate_index=1)),
}


def test_encoder_copy_emits_the_same_bytes():
    for n, kw in EXACT_CASES.values():
        assert encode_stream(n, **kw) == jax_encode_stream(n, **kw)
    assert (encode_stream(3, seed=1, sf_range=(24, 63))
            == jax_encode_stream(3, seed=1, sf_range=(24, 63)))


@pytest.mark.parametrize('native_parser', [True, False],
                         ids=['native', 'python'])
@pytest.mark.parametrize('case', sorted(EXACT_CASES))
def test_exact_path_bit_exact(case, native_parser):
    """Port == oracle == jsmpeg_tpu, every sample of every frame (exact
    equality)."""
    n, kw = EXACT_CASES[case]
    es, _ = encode_stream(n, **kw)
    golden = OracleMP2(es).decode_all()
    got = _run(MP2Decoder({'native': native_parser}), es)
    want = _run(JaxMP2Decoder({'native': native_parser}), es)
    assert len(got) == len(golden) == len(want) == n
    for i, (o, g, j) in enumerate(zip(got, golden, want)):
        for ch in range(2):
            assert o[ch].dtype == np.float32
            np.testing.assert_array_equal(o[ch], g[ch], err_msg=f'f{i}')
            np.testing.assert_array_equal(o[ch], j[ch], err_msg=f'f{i}')


# ------------------------------------------------ native vs Python parser

def test_native_parse_and_synthesis_bit_exact():
    es, _ = encode_stream(20, seed=7)
    py = MP2Parser()
    py.write(es)
    nat = native.NativeMP2Parser()
    nat.write(es)
    st = mp2_synth.initial_state()
    n = 0
    while True:
        fp = py.parse_frame()
        fn = nat.parse_frame()
        assert (fp is None) == (fn is None)
        if fp is None:
            break
        np.testing.assert_array_equal(fp.samples, fn.samples)
        assert fp.frame_size == fn.frame_size
        assert fp.sample_rate == fn.sample_rate
        pcm_py, st = mp2_synth.synthesize_exact(fp.samples, st)
        left, right = nat.synthesize(fn.samples)
        np.testing.assert_array_equal(pcm_py[0], left)
        np.testing.assert_array_equal(pcm_py[1], right)
        n += 1
    assert n == 20
    v, pos = nat.get_state()
    np.testing.assert_array_equal(v, st.V)
    assert pos == st.v_pos


def test_native_decode_pcm_full_path():
    es, _ = encode_stream(12, seed=9)
    nat = native.NativeMP2Parser()
    nat.write(es)
    py = MP2Parser()
    py.write(es)
    st = mp2_synth.initial_state()
    while True:
        out = nat.decode_pcm()
        f = py.parse_frame()
        assert (out is None) == (f is None)
        if out is None:
            break
        pcm, st = mp2_synth.synthesize_exact(f.samples, st)
        np.testing.assert_array_equal(pcm[0], out[0])
        np.testing.assert_array_equal(pcm[1], out[1])


def test_native_state_roundtrip():
    es, _ = encode_stream(6, seed=11)
    a = native.NativeMP2Parser()
    a.write(es)
    for _ in range(3):
        a.decode_pcm()
    v, pos = a.get_state()
    b = native.NativeMP2Parser()
    b.write(es)
    b.bits.index = a.bits.index
    b.set_state(v, pos)
    ra = a.decode_pcm()
    rb = b.decode_pcm()
    np.testing.assert_array_equal(ra[0], rb[0])
    np.testing.assert_array_equal(ra[1], rb[1])


def test_native_chunked_writes_and_partial_frames():
    es, _ = encode_stream(8, seed=13)
    nat = native.NativeMP2Parser()
    out = []
    for i in range(0, len(es), 333):
        nat.write(es[i:i + 333])
        while (r := nat.decode_pcm()) is not None:
            out.append(r)
    py = MP2Parser()
    py.write(es)
    st = mp2_synth.initial_state()
    k = 0
    while (f := py.parse_frame()) is not None:
        pcm, st = mp2_synth.synthesize_exact(f.samples, st)
        np.testing.assert_array_equal(pcm[0], out[k][0])
        np.testing.assert_array_equal(pcm[1], out[k][1])
        k += 1
    assert k == len(out) == 8


def test_host_tables_equal_jsmpeg_tpu():
    """The copied host half (the float64 DCT DAG, the tap tables and the
    exact synthesis) is jsmpeg_tpu's, value for value."""
    rng = np.random.default_rng(3)
    s = rng.integers(-2**20, 2**20, (40, 32))
    np.testing.assert_array_equal(mp2_synth.dct32_chunks(s),
                                  jax_synth.dct32_chunks(s))
    np.testing.assert_array_equal(mp2_synth.DCT32_MATRIX,
                                  jax_synth.DCT32_MATRIX)
    np.testing.assert_array_equal(mp2_synth._TAP_D, jax_synth._TAP_D)
    np.testing.assert_array_equal(mp2_synth._TAP_V, jax_synth._TAP_V)


# ------------------------------------------------------------ device mode

def _subband_samples(n_frames, seed):
    """Dequantized samples [36 * n_frames, 2, 32] of a non-saturated
    stream (the parser's own output)."""
    es, _ = encode_stream(n_frames, seed=seed, sf_range=(24, 63))
    p = MP2Parser()
    p.write(es)
    return np.concatenate([p.parse_frame().samples for _ in range(n_frames)])


@pytest.mark.parametrize('start', [0, 5, 41])
@pytest.mark.parametrize('n_sub', [1, 36, 77])
def test_synthesize_device_matches_synthesize_tpu(start, n_sub):
    """A batch of n_sub sub-blocks after `start` others (so from a carried
    V-chunk history and another ring phase each time): the port within
    1e-6 of jsmpeg_tpu's synthesize_tpu (both float32) and the carried
    history within float32 rounding."""
    allsamp = _subband_samples(4, seed=start + n_sub)
    _, hist = jax_synth.synthesize_tpu(jnp.asarray(allsamp[:start]),
                                       jnp.zeros((15, 2, 64)), 0)
    hist = np.array(hist)
    v_pos = (-64 * start) % 1024
    samples = allsamp[start:start + n_sub]
    pcm, new = mp2_synth.synthesize_device(torch.as_tensor(samples),
                                           torch.as_tensor(hist), v_pos)
    jpcm, jnew = jax_synth.synthesize_tpu(jnp.asarray(samples),
                                          jnp.asarray(hist), v_pos)
    assert pcm.dtype == torch.float32 and pcm.shape == (2, n_sub * 32)
    np.testing.assert_allclose(pcm.numpy(), np.asarray(jpcm), rtol=0,
                               atol=1e-6)
    # the history's last chunks are float32 sums of 32 products, each
    # summed in its own order: within the sum of |terms| times float32 eps
    eps = np.abs(samples).max() * np.abs(mp2_synth.DCT32_MATRIX).sum(1).max()
    np.testing.assert_allclose(new.numpy(), np.asarray(jnew), rtol=0,
                               atol=eps * 2.0 ** -23)


def test_device_path_close_to_oracle_and_jax():
    """sf_range keeps the int32 U accumulator in the linear region, like
    real audio; the float device path cannot reproduce the reference's
    deliberate int32 wraparound on saturated content.  Bounds: 3e-5 of
    the oracle, 1e-6 of jsmpeg_tpu's mode='tpu'."""
    es, _ = encode_stream(4, seed=21, sf_range=(24, 63))
    golden = OracleMP2(es).decode_all()
    got = _run(MP2Decoder(CPU, mode='device'), es)
    want = _run(JaxMP2Decoder(mode='tpu'), es)
    assert len(got) == len(want) == 4
    for (gl, gr), (ol, orr), (jl, jr) in zip(golden, got, want):
        np.testing.assert_allclose(ol, gl, atol=3e-5)
        np.testing.assert_allclose(orr, gr, atol=3e-5)
        np.testing.assert_allclose(ol, jl, rtol=0, atol=1e-6)
        np.testing.assert_allclose(orr, jr, rtol=0, atol=1e-6)


def test_device_batch_matches_stepwise():
    es, _ = encode_stream(5, seed=33)
    a = MP2Decoder(CPU, mode='device')
    a.write(0.0, es)
    batch = a.decode_available()
    b = _run(MP2Decoder(CPU, mode='device'), es)
    j = JaxMP2Decoder(mode='tpu')
    j.write(0.0, es)
    jbatch = j.decode_available()
    assert batch.shape == (5, 2, 1152) == jbatch.shape
    for i, (bl, br) in enumerate(b):
        np.testing.assert_allclose(batch[i, 0], bl, atol=1e-7)
        np.testing.assert_allclose(batch[i, 1], br, atol=1e-7)
    np.testing.assert_allclose(batch, jbatch, rtol=0, atol=1e-6)


def test_device_mode_keeps_its_state_on_the_device():
    dec = MP2Decoder(CPU, mode='device')
    assert dec.device == torch.device('cpu')
    assert dec._v_chunks.device == dec.device
    es, _ = encode_stream(2, seed=5)
    _run(dec, es)
    assert isinstance(dec._v_chunks, torch.Tensor)
    assert dec._v_pos == (-64 * 72) % 1024
    assert MP2Decoder().device is None        # exact stays on the host


def test_unknown_mode_refused():
    with pytest.raises(ValueError, match='mode'):
        MP2Decoder(CPU, mode='tpu')


def test_timestamps_and_seek_follow_jsmpeg_tpu():
    """PTS bookkeeping through write/decode/seek, as jsmpeg_tpu's."""
    es, frames = encode_stream(6, seed=17)
    dec, jdec = MP2Decoder(), JaxMP2Decoder()
    for i, f in enumerate(frames):
        dec.write(i * 1152 / 44100, f)
        jdec.write(i * 1152 / 44100, f)
    for _ in range(3):
        a, b = dec.decode(), jdec.decode()
        np.testing.assert_array_equal(a[0], b[0])
    assert dec.current_time == pytest.approx(jdec.current_time)
    dec.seek(0.05)
    jdec.seek(0.05)
    assert dec.current_time == pytest.approx(jdec.current_time)
    a, b = dec.decode(), jdec.decode()
    np.testing.assert_array_equal(a[1], b[1])

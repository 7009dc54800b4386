"""The port's I-picture thumbnails (jsmpeg_tpu_torch.thumbs) on the CPU,
mirroring tests/test_thumbs.py: equal, with tolerance 0, to
tools.thumbs.extract_iframe_planes on the same bytes and to the frames a
full decode gives at those positions; the CLI writes PNGs equal to the
colour conversion of those planes."""

import os
import sys

import numpy as np

from jsmpeg_tpu_torch.models.mpeg1 import MPEG1Decoder
from jsmpeg_tpu_torch.ops.color import ycbcr_to_rgb_int
from jsmpeg_tpu_torch.testing.gen import (encode_realistic_stream,
                                          encode_test_stream)
from jsmpeg_tpu_torch.testing.ts_mux import mux_video
from jsmpeg_tpu_torch.thumbs import extract_iframe_planes, main
from tools.thumbs import extract_iframe_planes as jax_extract

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_sinks_png import read_png  # noqa: E402


def _full_decode(es):
    dec = MPEG1Decoder({'device': 'cpu'})
    dec.write(0.0, es)
    return dec.decode_available(eof=True)


def _same(got, jax_got, full, positions):
    assert len(got) == len(jax_got) == len(positions)
    for i, (t, j, k) in enumerate(zip(got, jax_got, positions)):
        for a, b, c in zip(t, j, full[k]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=f'thumb {i} vs jax')
            np.testing.assert_array_equal(a.numpy(), c.numpy(),
                                          err_msg=f'thumb {i} vs full')


def test_thumbs_match_full_decode():
    es, _ = encode_test_stream(96, 64, n_frames=9, seed=41, gop=3)
    seq, thumbs = extract_iframe_planes(es, device='cpu')
    _, jthumbs = jax_extract(es)
    assert thumbs[0].y.device.type == 'cpu'
    _same(thumbs, jthumbs, _full_decode(es), [0, 3, 6])


def test_thumbs_every_and_limit():
    es, _ = encode_test_stream(96, 64, n_frames=12, seed=42, gop=2)
    _, thumbs = extract_iframe_planes(es, every=2, limit=2, device='cpu')
    _, jthumbs = jax_extract(es, every=2, limit=2)
    # I at 0, 2, 4, ... -> take 0 and 4
    _same(thumbs, jthumbs, _full_decode(es), [0, 4])


def test_thumbs_more_than_one_batch():
    """More I pictures than one batch holds: the selection decodes in
    chunks of BATCH_FRAMES and still equals the one-scan jsmpeg_tpu
    output and the full decode."""
    es, _ = encode_realistic_stream(48, 32, n_frames=7, seed=44, gop=1)
    saved = MPEG1Decoder.BATCH_FRAMES
    MPEG1Decoder.BATCH_FRAMES = 3
    try:
        _, thumbs = extract_iframe_planes(es, device='cpu')
    finally:
        MPEG1Decoder.BATCH_FRAMES = saved
    _, jthumbs = jax_extract(es)
    _same(thumbs, jthumbs, _full_decode(es), list(range(7)))


def test_thumbs_cli_writes_png(tmp_path):
    es, chunks = encode_test_stream(96, 64, n_frames=6, seed=43, gop=3)
    v = chunks[:-1]
    v[-1] = v[-1] + chunks[-1]
    ts = tmp_path / 'c.ts'
    ts.write_bytes(mux_video(v, 30.0))
    out = str(tmp_path / 't_%02d.png')
    assert main([str(ts), '-o', out, '--device', 'cpu']) == 0
    img = read_png(str(tmp_path / 't_01.png'))
    assert img.shape == (64, 96, 3)
    full = _full_decode(es)
    want = ycbcr_to_rgb_int(*full[3], 96, 64)
    np.testing.assert_array_equal(img, want.numpy())
    assert not (tmp_path / 't_02.png').exists()
    np.testing.assert_array_equal(read_png(str(tmp_path / 't_00.png')),
                                  ycbcr_to_rgb_int(*full[0], 96, 64).numpy())


def test_thumbs_run_the_compact_form(monkeypatch):
    """The I-picture batches of the thumbnails reach K1 in its compact
    form only (their packed wire), every row named, equal to jsmpeg_tpu
    and the full decode."""
    from tests.test_torch_unpack import k1_calls
    es, _ = encode_test_stream(96, 64, n_frames=9, seed=41, gop=3)
    calls = k1_calls(monkeypatch)
    _, thumbs = extract_iframe_planes(es, device='cpu')
    # the three I pictures (24 macroblocks, every block coded) in one batch
    assert calls == [('compact', 3 * 24 * 6, 3 * 24 * 6)]
    _same(thumbs, jax_extract(es)[1], _full_decode(es), [0, 3, 6])

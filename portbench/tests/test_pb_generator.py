"""The benchmark's generator is a frozen copy of the port's test encoders:
at the same arguments it writes the same bytes."""

import numpy as np
import pytest

from portbench.gen import gen, mp2_enc, ts_mux


@pytest.mark.parametrize('w,h,n,seed,gop', [(64, 48, 6, 3, 3),
                                             (96, 64, 5, 2**31 + 9, 4),
                                             (176, 144, 3, 0, 12)])
def test_realistic_stream_same_bytes(w, h, n, seed, gop):
    from jsmpeg_tpu_torch.testing.gen import encode_realistic_stream
    assert gen.encode_realistic_stream(w, h, n, seed=seed, gop=gop) == \
        encode_realistic_stream(w, h, n, seed=seed, gop=gop)


def test_statistics_change_the_stream():
    a, _ = gen.encode_realistic_stream(64, 48, 4, seed=1, gop=4)
    b, _ = gen.encode_realistic_stream(64, 48, 4, seed=1, gop=4,
                                       p_skip=0.8, p_mc=0.15)
    assert a != b


def test_mp2_and_mux_same_bytes():
    from jsmpeg_tpu_torch.testing import mp2_enc as port_mp2
    from jsmpeg_tpu_torch.testing import ts_mux as port_mux
    from jsmpeg_tpu_torch.testing.gen import encode_realistic_stream
    assert mp2_enc.encode_stream(6, seed=5, sf_range=(24, 63)) == \
        port_mp2.encode_stream(6, seed=5, sf_range=(24, 63))
    _, v = encode_realistic_stream(64, 48, 4, seed=1, gop=4)
    _, a = port_mp2.encode_stream(5, seed=2)
    assert ts_mux.mux_av(v, 30.0, a, 1152, 44100) == \
        port_mux.mux_av(v, 30.0, a, 1152, 44100)
    assert ts_mux.mux_video(v, 30.0) == port_mux.mux_video(v, 30.0)


def test_feed_schedule():
    """A feed's pictures go out in order, each at its frame time, and
    cover its TS once; picture i is due with picture i + 1's first
    chunk."""
    from portbench.feedgen import build_feed
    from portbench.gen.ts_mux import mux_video
    _, chunks = gen.encode_realistic_stream(64, 48, 4, seed=1, gop=4)
    gops = [chunks[:-1]]
    ts, sends, due = build_feed(gops, [0, 0, 0], 30.0, 0.01)
    assert ts == mux_video(chunks[:-1] * 3, 30.0)
    assert len(sends) == 12 and sends[0][1] == 0 and sends[-1][2] == len(ts)
    assert all(a[2] == b[1] for a, b in zip(sends, sends[1:]))
    np.testing.assert_allclose([x[0] for x in sends],
                               0.01 + np.arange(12) / 30.0)
    np.testing.assert_allclose(due, 0.01 + np.arange(1, 12) / 30.0)


@pytest.mark.parametrize('seed', [0, 2**31 + 5])
def test_fast_mux_same_bytes(seed):
    """Files assembled from units muxed once are `mux_av`'s bytes, with
    units whose first packet is stuffed, and counters that wrap."""
    from portbench.gen import fast_mux
    _, v = gen.encode_realistic_stream(64, 48, 8, seed=seed, gop=4)
    _, a = mp2_enc.encode_stream(6, seed=seed)
    v = v[:-1] + [b'\x00\x00\x01\x00' + bytes(20)]
    rng = np.random.default_rng(seed)
    pick = rng.integers(0, len(v), 50)
    video = [v[i] for i in pick]
    video[-1] += b'\x00\x00\x01\xb7'
    audio = [a[k % len(a)] for k in range(40)]
    units = [fast_mux.mux_unit(0x100, 0xE0, x, False) for x in v]
    last = fast_mux.mux_unit(0x100, 0xE0, video[-1], False)
    cycle = [fast_mux.mux_unit(0x101, 0xC0, x, True) for x in a]
    got = fast_mux.mux_av([units[i] for i in pick[:-1]] + [last], 30.0,
                          [cycle[k % len(a)] for k in range(40)], 1152,
                          44100)
    assert got == ts_mux.mux_av(video, 30.0, audio, 1152, 44100)


def test_files_are_distinct_and_balanced():
    from portbench.loads.offline import file_order
    rng = np.random.default_rng(3)
    orders = [file_order(rng, 6, 75) for _ in range(20)]
    assert len({o.tobytes() for o in orders}) == 20
    for o in orders:
        counts = np.bincount(o, minlength=6)
        assert counts.sum() == 75 and set(counts) <= {12, 13}

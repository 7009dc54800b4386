"""The benchmark's stream generator: a frozen copy of the port's
`testing/gen.py` realistic encoder, whose statistics a configuration may
set (the share of skipped and of motion-only macroblocks in P pictures,
the AC densities).  At its defaults it writes the same bytes as the
port's `encode_realistic_stream` for the same arguments."""

from __future__ import annotations

import numpy as np

from .. import tables as T
from .bitwriter import BitWriter
from .mpeg1_enc import MB, MPEG1Encoder


def _natural_block_levels(rng, mean_ac: float, max_level: int,
                          dc: int | None = None) -> np.ndarray:
    """Zig-zag levels with the low-frequency bias of natural content: a
    geometric number of ACs packed toward early scan positions."""
    lv = np.zeros(64, dtype=np.int64)
    if dc is not None:
        lv[0] = dc
    n_ac = min(int(rng.geometric(1.0 / (mean_ac + 1.0)) - 1), 30)
    if n_ac > 0:
        # early-scan bias: positions ~ floor(u^2 * 48) + 1
        pos = np.unique((rng.random(n_ac) ** 2 * 48).astype(np.int64) + 1)
        mag = rng.integers(1, max_level + 1, size=len(pos))
        sgn = rng.choice((-1, 1), size=len(pos))
        lv[pos] = mag * sgn
    return lv


def encode_realistic_stream(w: int, h: int, n_frames: int, seed: int = 0,
                            gop: int = 12, qscale: int = 10,
                            f_code: int = 2,
                            frame_rate: float = 30.0,
                            p_skip: float = 0.70, p_mc: float = 0.15,
                            i_mean_ac: float = 3.0,
                            i_mean_ac_chroma: float = 0.8,
                            p_mean_ac: float = 1.6,
                            unvisited: list | None = None
                            ) -> tuple[bytes, list[bytes]]:
    """Generate an MPEG1 ES with the *statistics* of real-world content at
    the reference's recommended 720p operating point (~2 Mbit/s,
    jsmpeg/README.md:115,117): I-frames with low-frequency-biased
    AC density, P-frames dominated by skip/MC-only macroblocks with small
    motion vectors and sparse residuals.  Decoded output is synthetic
    (no real motion estimation) but the decode *work* per frame matches
    typical streams, which is what benchmarks must measure.

    A P picture's macroblock is skipped with probability `p_skip`,
    motion-compensated without a residual with `p_mc`, and otherwise
    coded with `p_mean_ac` ACs a block on average; an I picture's blocks
    carry `i_mean_ac` (luma) and `i_mean_ac_chroma` ACs on average.

    `unvisited`, if given, receives the (picture, slice row) of each
    slice whose last macroblock a decoder following the reference never
    decodes (`MPEG1Encoder.unvisited`).

    Returns (full_es, per_frame_es_chunks).
    """
    rng = np.random.default_rng(seed)
    enc = MPEG1Encoder(w, h, frame_rate=frame_rate, qscale=qscale,
                       f_code=f_code)
    mb_w, mb_h = enc.mb_w, enc.mb_h
    cw, ch = mb_w * 16, mb_h * 16
    f = 1 << (f_code - 1)
    mv_cap = min((f << 4) - 1, 14)

    chunks = []
    for t in range(n_frames):
        enc.w = BitWriter()
        if t == 0:
            enc.sequence_header()
        mbs = []
        if t % gop == 0:
            if t == 0:
                enc.gop_header()
            dc_prev = 128
            for _ in range(mb_h * mb_w):
                levels = []
                for b in range(6):
                    dc = int(np.clip(dc_prev + rng.integers(-8, 9),
                                     16, 239))
                    if b < 4:
                        dc_prev = dc
                    levels.append(_natural_block_levels(
                        rng, mean_ac=i_mean_ac if b < 4 else i_mean_ac_chroma,
                        max_level=10, dc=dc))
                mbs.append(MB('intra', levels=levels))
            enc.encode_picture(T.PIC_I, mbs)
        else:
            for rmb in range(mb_h):
                for cmb in range(mb_w):
                    u = rng.random()
                    max_up = min(mv_cap, 2 * (rmb * 16))
                    max_down = max(0, min(mv_cap,
                                          2 * (ch - rmb * 16 - 16 - 2)))
                    max_left = min(mv_cap, 2 * (cmb * 16))
                    max_right = max(0, min(mv_cap,
                                           2 * (cw - cmb * 16 - 16 - 2)))
                    mvh = int(rng.integers(-max_left, max_right + 1))
                    mvv = int(rng.integers(-max_up, max_down + 1))
                    if u < p_skip:
                        mbs.append(MB('skip'))
                    elif u < p_skip + p_mc:
                        mbs.append(MB('mc', mv=(mvh, mvv)))
                    else:
                        levels = [_natural_block_levels(
                            rng, mean_ac=p_mean_ac, max_level=8)
                            for _ in range(6)]
                        mbs.append(MB('mc_coded', mv=(mvh, mvv),
                                      levels=levels))
            enc.encode_picture(T.PIC_P, mbs)
        chunks.append(enc.getvalue())

    if unvisited is not None:
        unvisited.extend(enc.unvisited)
    chunks.append(b'\x00\x00\x01\xb7')    # sequence end
    return b''.join(chunks), chunks

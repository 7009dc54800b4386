"""Synthetic content + stream generation for tests and benchmarks."""

from __future__ import annotations

import numpy as np

from .. import tables as T
from .bitwriter import BitWriter
from .mpeg1_enc import MB, MPEG1Encoder, quantize_intra


def make_ycbcr_frame(w: int, h: int, t: int, seed: int = 0):
    """Deterministic moving-pattern frame: gradients + a moving box."""
    rng = np.random.default_rng(seed + 1000 * t)
    yy, xx = np.mgrid[0:h, 0:w]
    y = ((xx * 2 + yy + t * 5) % 256).astype(np.uint8)
    bx = (t * 7) % max(w - 32, 1)
    by = (t * 3) % max(h - 32, 1)
    y = y.copy()
    y[by:by + 32, bx:bx + 32] = 32 + 8 * (t % 16)
    y[h // 4:h // 4 + 8, :] = rng.integers(0, 255, (8, w), dtype=np.uint8)
    cb = ((xx[::2, ::2] + 40 * np.sin(t / 3.0)) % 256).astype(np.uint8)
    cr = ((yy[::2, ::2] * 2 - 30 * np.cos(t / 5.0)) % 256).astype(np.uint8)
    return y, cb, cr


def _intra_levels(y, cb, cr, mb_row, mb_col, qscale, quant):
    """Levels for the 6 blocks of one intra macroblock (zig-zag order).
    Block order: 4 luma (tl, tr, bl, br), then Cb, then Cr -- matching the
    decoder's block->plane mapping (block 4 lands in the Cb plane)."""
    levels = []
    for b in range(4):
        r0 = (mb_row << 4) + (8 if b & 2 else 0)
        c0 = (mb_col << 4) + (8 if b & 1 else 0)
        levels.append(quantize_intra(
            y[r0:r0 + 8, c0:c0 + 8].astype(np.float64), qscale, quant))
    for plane in (cb, cr):
        r0 = mb_row << 3
        c0 = mb_col << 3
        levels.append(quantize_intra(
            plane[r0:r0 + 8, c0:c0 + 8].astype(np.float64), qscale, quant))
    return levels


def _pad_plane(p: np.ndarray, H: int, W: int) -> np.ndarray:
    out = np.zeros((H, W), dtype=p.dtype)
    out[:p.shape[0], :p.shape[1]] = p
    # replicate edges into the macroblock padding region
    out[p.shape[0]:, :p.shape[1]] = p[-1:, :]
    out[:, p.shape[1]:] = out[:, p.shape[1] - 1:p.shape[1]]
    return out


def random_sparse_levels(rng, density=0.12, max_level=40, escape_prob=0.05):
    """Random zig-zag non-intra levels exercising VLC + escape paths."""
    lv = np.zeros(64, dtype=np.int64)
    for n in range(64):
        if rng.random() < density:
            if rng.random() < escape_prob:
                lv[n] = int(rng.integers(128, 256)) * (1 if rng.random() < .5 else -1)
            else:
                lv[n] = int(rng.integers(1, max_level)) * (1 if rng.random() < .5 else -1)
    return lv


def encode_test_stream(w: int, h: int, n_frames: int, seed: int = 0,
                       gop: int = 6, qscale: int = 8, f_code: int = 2,
                       custom_matrices: bool = False,
                       frame_rate: float = 25.0,
                       full_pel: bool = False,
                       b_stubs: bool = False,
                       stuffing: bool = False,
                       midstream_headers: bool = False
                       ) -> tuple[bytes, list[bytes]]:
    """Generate a legal MPEG1 ES with I and P pictures covering decode paths.

    Returns (full_es, per_frame_es_chunks) -- the chunks are what a muxer
    packs one PES packet each.

    Edge-path options (each exercises a parser branch the reference has,
    jsmpeg/src/mpeg1.js:182-196,294-392):
      full_pel:           P pictures transmit full-pel motion vectors
      b_stubs:            interleave B/D picture stubs decoders must skip
      stuffing:           sprinkle macroblock_stuffing (VLC 34) codes
      midstream_headers:  repeat sequence/GOP headers + user_data between
                          pictures
    """
    rng = np.random.default_rng(seed)
    intra_q = non_intra_q = None
    if custom_matrices:
        intra_q = np.clip(T.DEFAULT_INTRA_QUANT_MATRIX +
                          rng.integers(-3, 4, 64), 1, 255).astype(np.int32)
        non_intra_q = np.clip(16 + rng.integers(-4, 5, 64),
                              1, 255).astype(np.int32)

    enc = MPEG1Encoder(w, h, frame_rate=frame_rate, qscale=qscale,
                       f_code=f_code, intra_q=intra_q,
                       non_intra_q=non_intra_q)
    mb_w, mb_h = enc.mb_w, enc.mb_h
    cw, ch = mb_w * 16, mb_h * 16
    f = 1 << (f_code - 1)
    mv_cap = (f << 4) - 1

    stuff_rng = np.random.default_rng(seed + 7777) if stuffing else None

    chunks = []
    for t in range(n_frames):
        enc.w = BitWriter()
        if t == 0:
            enc.sequence_header()
        elif midstream_headers and t % gop == 0:
            # repeated sequence header + user data between pictures
            enc.sequence_header()
            enc.user_data(bytes(range(1, 17)))
        is_intra = (t % gop == 0)
        y, cb, cr = make_ycbcr_frame(w, h, t, seed)
        y = _pad_plane(y, ch, cw)
        cb = _pad_plane(cb, ch >> 1, cw >> 1)
        cr = _pad_plane(cr, ch >> 1, cw >> 1)

        mbs = []
        if is_intra:
            if t == 0 or midstream_headers or rng.random() < 0.5:
                enc.gop_header()
            for rmb in range(mb_h):
                for cmb in range(mb_w):
                    q = None
                    if rng.random() < 0.08:
                        q = int(rng.integers(1, 31))
                    levels = _intra_levels(y, cb, cr, rmb, cmb,
                                           q or qscale, enc.intra_q)
                    mbs.append(MB('intra', levels=levels, qscale=q))
            enc.encode_picture(T.PIC_I, mbs, stuffing_rng=stuff_rng)
        else:
            for rmb in range(mb_h):
                for cmb in range(mb_w):
                    u = rng.random()
                    # legal MV range keeping reads in-bounds (2px margin)
                    max_up = min(mv_cap, 2 * (rmb * 16))
                    max_down = max(0, min(mv_cap,
                                          2 * (ch - rmb * 16 - 16 - 2)))
                    max_left = min(mv_cap, 2 * (cmb * 16))
                    max_right = max(0, min(mv_cap,
                                           2 * (cw - cmb * 16 - 16 - 2)))
                    mvh = int(rng.integers(-max_left, max_right + 1))
                    mvv = int(rng.integers(-max_up, max_down + 1))
                    if full_pel:
                        mvh &= ~1       # full-pel MVs are even half-pels
                        mvv &= ~1
                    q = int(rng.integers(1, 31)) if rng.random() < 0.05 else None
                    if u < 0.25:
                        mbs.append(MB('skip'))
                    elif u < 0.45:
                        mbs.append(MB('mc', mv=(mvh, mvv)))
                    elif u < 0.60:
                        q2 = q or qscale
                        levels = _intra_levels(y, cb, cr, rmb, cmb,
                                               q2, enc.intra_q)
                        mbs.append(MB('intra', levels=levels, qscale=q))
                    else:
                        levels = [random_sparse_levels(rng)
                                  if rng.random() < 0.8 else
                                  np.zeros(64, dtype=np.int64)
                                  for _ in range(6)]
                        mbs.append(MB('mc_coded', mv=(mvh, mvv),
                                      levels=levels, qscale=q))
            enc.encode_picture(T.PIC_P, mbs, full_pel=full_pel,
                               stuffing_rng=stuff_rng)
            if b_stubs and rng.random() < 0.6:
                # interleaved B (and occasionally D) pictures: decoders
                # must skip them and keep their byte position
                enc.encode_skipped_picture(
                    T.PIC_D if rng.random() < 0.2 else T.PIC_B, rng=rng)
        chunks.append(enc.getvalue())

    chunks.append(b'\x00\x00\x01\xb7')    # sequence end
    return b''.join(chunks), chunks


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
                            frame_rate: float = 30.0) -> tuple[bytes, list[bytes]]:
    """Generate an MPEG1 ES with the *statistics* of real-world content at
    the reference's recommended 720p operating point (~2 Mbit/s,
    jsmpeg/README.md:115,117): I-frames with low-frequency-biased
    AC density, P-frames dominated by skip/MC-only macroblocks with small
    motion vectors and sparse residuals.  Decoded output is synthetic
    (no real motion estimation) but the decode *work* per frame matches
    typical streams, which is what benchmarks must measure.

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
                        rng, mean_ac=3.0 if b < 4 else 0.8,
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
                    if u < 0.70:
                        mbs.append(MB('skip'))
                    elif u < 0.85:
                        mbs.append(MB('mc', mv=(mvh, mvv)))
                    else:
                        levels = [_natural_block_levels(
                            rng, mean_ac=1.6, max_level=8)
                            for _ in range(6)]
                        mbs.append(MB('mc_coded', mv=(mvh, mvv),
                                      levels=levels))
            enc.encode_picture(T.PIC_P, mbs)
        chunks.append(enc.getvalue())

    chunks.append(b'\x00\x00\x01\xb7')    # sequence end
    return b''.join(chunks), chunks

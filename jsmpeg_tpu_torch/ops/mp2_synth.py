"""MP2 polyphase synthesis filterbank.

Two execution paths:

1. `synthesize_exact` (host, numpy): bit-exact with the reference decoder
   (jsmpeg/src/mp2.js:240-484).  The reference computes the
   32->64 matrixing in float64 (JS numbers) with results rounded to float32
   on store, and accumulates the 512-tap windowing into int32 with a
   ToInt32 truncation after EVERY multiply-accumulate.  Bit-exact PCM
   therefore requires replaying the same float op DAG; the fast DCT flow
   below is the (public) kjmp2 Lee-style factorization, vectorized over a
   batch axis.  This is a compatibility path - audio is ~0.1% of decode
   FLOPs.

2. `synthesize_device` (torch, on the device of its inputs): the [32->64]
   matrixing by `DCT32_MATRIX` and the reference's 16-tap windowing per
   output, gathered from the V-chunk history by ring phase, batched over
   sub-blocks and frames.  Float32 throughout; output differs from the
   reference only in float rounding (~1e-7 relative on non-saturated
   content); tests bound the error.  It is the port of jsmpeg_tpu's
   `synthesize_tpu`.

State carried between frames: the V ring (2 channels x 1024 float32) and
the ring position VPos (multiple of 64, decremented mod 1024 per sub-block).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import tables as T


class MP2State(NamedTuple):
    V: np.ndarray       # float32 [2, 1024]
    v_pos: int          # multiple of 64


def initial_state() -> MP2State:
    return MP2State(np.zeros((2, 1024), dtype=np.float32), 0)


# ---------------------------------------------------------------------------
# 32-point matrixing (float64 DAG identical to the reference; vectorized)
# ---------------------------------------------------------------------------

def dct32_chunks(s: np.ndarray) -> np.ndarray:
    """s: float64/int [batch, 32] subband samples -> [batch, 64] V-chunk
    values in float64 (caller rounds to float32 on store).

    The op DAG matches src/mp2.js:346-484 exactly (same kjmp2 Lee
    factorization, same constants, same accumulation order) because the
    float64 rounding of each individual op is observable in the float32
    output.  Vectorized over the batch axis.
    """
    s = np.asarray(s, dtype=np.float64)
    t01 = s[:, 0] + s[:, 31]; t02 = (s[:, 0] - s[:, 31]) * 0.500602998235
    t03 = s[:, 1] + s[:, 30]; t04 = (s[:, 1] - s[:, 30]) * 0.505470959898
    t05 = s[:, 2] + s[:, 29]; t06 = (s[:, 2] - s[:, 29]) * 0.515447309923
    t07 = s[:, 3] + s[:, 28]; t08 = (s[:, 3] - s[:, 28]) * 0.53104259109
    t09 = s[:, 4] + s[:, 27]; t10 = (s[:, 4] - s[:, 27]) * 0.553103896034
    t11 = s[:, 5] + s[:, 26]; t12 = (s[:, 5] - s[:, 26]) * 0.582934968206
    t13 = s[:, 6] + s[:, 25]; t14 = (s[:, 6] - s[:, 25]) * 0.622504123036
    t15 = s[:, 7] + s[:, 24]; t16 = (s[:, 7] - s[:, 24]) * 0.674808341455
    t17 = s[:, 8] + s[:, 23]; t18 = (s[:, 8] - s[:, 23]) * 0.744536271002
    t19 = s[:, 9] + s[:, 22]; t20 = (s[:, 9] - s[:, 22]) * 0.839349645416
    t21 = s[:, 10] + s[:, 21]; t22 = (s[:, 10] - s[:, 21]) * 0.972568237862
    t23 = s[:, 11] + s[:, 20]; t24 = (s[:, 11] - s[:, 20]) * 1.16943993343
    t25 = s[:, 12] + s[:, 19]; t26 = (s[:, 12] - s[:, 19]) * 1.48416461631
    t27 = s[:, 13] + s[:, 18]; t28 = (s[:, 13] - s[:, 18]) * 2.05778100995
    t29 = s[:, 14] + s[:, 17]; t30 = (s[:, 14] - s[:, 17]) * 3.40760841847
    t31 = s[:, 15] + s[:, 16]; t32 = (s[:, 15] - s[:, 16]) * 10.1900081235
    t33 = t01 + t31; t31 = (t01 - t31) * 0.502419286188
    t01 = t03 + t29; t29 = (t03 - t29) * 0.52249861494
    t03 = t05 + t27; t27 = (t05 - t27) * 0.566944034816
    t05 = t07 + t25; t25 = (t07 - t25) * 0.64682178336
    t07 = t09 + t23; t23 = (t09 - t23) * 0.788154623451
    t09 = t11 + t21; t21 = (t11 - t21) * 1.06067768599
    t11 = t13 + t19; t19 = (t13 - t19) * 1.72244709824
    t13 = t15 + t17; t17 = (t15 - t17) * 5.10114861869
    t15 = t33 + t13; t13 = (t33 - t13) * 0.509795579104
    t33 = t01 + t11; t01 = (t01 - t11) * 0.601344886935
    t11 = t03 + t09; t09 = (t03 - t09) * 0.899976223136
    t03 = t05 + t07; t07 = (t05 - t07) * 2.56291544774
    t05 = t15 + t03; t15 = (t15 - t03) * 0.541196100146
    t03 = t33 + t11; t11 = (t33 - t11) * 1.30656296488
    t33 = t05 + t03; t05 = (t05 - t03) * 0.707106781187
    t03 = t15 + t11; t15 = (t15 - t11) * 0.707106781187
    t03 = t03 + t15
    t11 = t13 + t07; t13 = (t13 - t07) * 0.541196100146
    t07 = t01 + t09; t09 = (t01 - t09) * 1.30656296488
    t01 = t11 + t07; t07 = (t11 - t07) * 0.707106781187
    t11 = t13 + t09; t13 = (t13 - t09) * 0.707106781187
    t11 = t11 + t13; t01 = t01 + t11
    t11 = t11 + t07; t07 = t07 + t13
    t09 = t31 + t17; t31 = (t31 - t17) * 0.509795579104
    t17 = t29 + t19; t29 = (t29 - t19) * 0.601344886935
    t19 = t27 + t21; t21 = (t27 - t21) * 0.899976223136
    t27 = t25 + t23; t23 = (t25 - t23) * 2.56291544774
    t25 = t09 + t27; t09 = (t09 - t27) * 0.541196100146
    t27 = t17 + t19; t19 = (t17 - t19) * 1.30656296488
    t17 = t25 + t27; t27 = (t25 - t27) * 0.707106781187
    t25 = t09 + t19; t19 = (t09 - t19) * 0.707106781187
    t25 = t25 + t19
    t09 = t31 + t23; t31 = (t31 - t23) * 0.541196100146
    t23 = t29 + t21; t21 = (t29 - t21) * 1.30656296488
    t29 = t09 + t23; t23 = (t09 - t23) * 0.707106781187
    t09 = t31 + t21; t31 = (t31 - t21) * 0.707106781187
    t09 = t09 + t31; t29 = t29 + t09; t09 = t09 + t23; t23 = t23 + t31
    t17 = t17 + t29; t29 = t29 + t25; t25 = t25 + t09; t09 = t09 + t27
    t27 = t27 + t23; t23 = t23 + t19; t19 = t19 + t31
    t21 = t02 + t32; t02 = (t02 - t32) * 0.502419286188
    t32 = t04 + t30; t04 = (t04 - t30) * 0.52249861494
    t30 = t06 + t28; t28 = (t06 - t28) * 0.566944034816
    t06 = t08 + t26; t08 = (t08 - t26) * 0.64682178336
    t26 = t10 + t24; t10 = (t10 - t24) * 0.788154623451
    t24 = t12 + t22; t22 = (t12 - t22) * 1.06067768599
    t12 = t14 + t20; t20 = (t14 - t20) * 1.72244709824
    t14 = t16 + t18; t16 = (t16 - t18) * 5.10114861869
    t18 = t21 + t14; t14 = (t21 - t14) * 0.509795579104
    t21 = t32 + t12; t32 = (t32 - t12) * 0.601344886935
    t12 = t30 + t24; t24 = (t30 - t24) * 0.899976223136
    t30 = t06 + t26; t26 = (t06 - t26) * 2.56291544774
    t06 = t18 + t30; t18 = (t18 - t30) * 0.541196100146
    t30 = t21 + t12; t12 = (t21 - t12) * 1.30656296488
    t21 = t06 + t30; t30 = (t06 - t30) * 0.707106781187
    t06 = t18 + t12; t12 = (t18 - t12) * 0.707106781187
    t06 = t06 + t12
    t18 = t14 + t26; t26 = (t14 - t26) * 0.541196100146
    t14 = t32 + t24; t24 = (t32 - t24) * 1.30656296488
    t32 = t18 + t14; t14 = (t18 - t14) * 0.707106781187
    t18 = t26 + t24; t24 = (t26 - t24) * 0.707106781187
    t18 = t18 + t24; t32 = t32 + t18
    t18 = t18 + t14; t26 = t14 + t24
    t14 = t02 + t16; t02 = (t02 - t16) * 0.509795579104
    t16 = t04 + t20; t04 = (t04 - t20) * 0.601344886935
    t20 = t28 + t22; t22 = (t28 - t22) * 0.899976223136
    t28 = t08 + t10; t10 = (t08 - t10) * 2.56291544774
    t08 = t14 + t28; t14 = (t14 - t28) * 0.541196100146
    t28 = t16 + t20; t20 = (t16 - t20) * 1.30656296488
    t16 = t08 + t28; t28 = (t08 - t28) * 0.707106781187
    t08 = t14 + t20; t20 = (t14 - t20) * 0.707106781187
    t08 = t08 + t20
    t14 = t02 + t10; t02 = (t02 - t10) * 0.541196100146
    t10 = t04 + t22; t22 = (t04 - t22) * 1.30656296488
    t04 = t14 + t10; t10 = (t14 - t10) * 0.707106781187
    t14 = t02 + t22; t02 = (t02 - t22) * 0.707106781187
    t14 = t14 + t02; t04 = t04 + t14; t14 = t14 + t10; t10 = t10 + t02
    t16 = t16 + t04; t04 = t04 + t08; t08 = t08 + t14; t14 = t14 + t28
    t28 = t28 + t10; t10 = t10 + t20; t20 = t20 + t02; t21 = t21 + t16
    t16 = t16 + t32; t32 = t32 + t04; t04 = t04 + t06; t06 = t06 + t08
    t08 = t08 + t18; t18 = t18 + t14; t14 = t14 + t30; t30 = t30 + t28
    t28 = t28 + t26; t26 = t26 + t10; t10 = t10 + t12; t12 = t12 + t20
    t20 = t20 + t24; t24 = t24 + t02

    batch = s.shape[0]
    d = np.zeros((batch, 64), dtype=np.float64)
    d[:, 48] = -t33
    d[:, 49] = d[:, 47] = -t21
    d[:, 50] = d[:, 46] = -t17
    d[:, 51] = d[:, 45] = -t16
    d[:, 52] = d[:, 44] = -t01
    d[:, 53] = d[:, 43] = -t32
    d[:, 54] = d[:, 42] = -t29
    d[:, 55] = d[:, 41] = -t04
    d[:, 56] = d[:, 40] = -t03
    d[:, 57] = d[:, 39] = -t06
    d[:, 58] = d[:, 38] = -t25
    d[:, 59] = d[:, 37] = -t08
    d[:, 60] = d[:, 36] = -t11
    d[:, 61] = d[:, 35] = -t18
    d[:, 62] = d[:, 34] = -t09
    d[:, 63] = d[:, 33] = -t14
    d[:, 32] = -t05
    d[:, 0] = t05; d[:, 31] = -t30
    d[:, 1] = t30; d[:, 30] = -t27
    d[:, 2] = t27; d[:, 29] = -t28
    d[:, 3] = t28; d[:, 28] = -t07
    d[:, 4] = t07; d[:, 27] = -t26
    d[:, 5] = t26; d[:, 26] = -t23
    d[:, 6] = t23; d[:, 25] = -t10
    d[:, 7] = t10; d[:, 24] = -t15
    d[:, 8] = t15; d[:, 23] = -t12
    d[:, 9] = t12; d[:, 22] = -t19
    d[:, 10] = t19; d[:, 21] = -t20
    d[:, 11] = t20; d[:, 20] = -t13
    d[:, 12] = t13; d[:, 19] = -t24
    d[:, 13] = t24; d[:, 18] = -t31
    d[:, 14] = t31; d[:, 17] = -t02
    d[:, 15] = t02; d[:, 16] = 0.0
    return d


# ---------------------------------------------------------------------------
# Windowing tap tables
# ---------------------------------------------------------------------------

def _trace_window(v_pos: int):
    """Replay the reference's windowing index walk (src/mp2.js:250-270)
    for one ring position; returns (d_idx, v_idx) int arrays [16, 32]:
    step-ordered tap indices for each of the 32 outputs."""
    d_idx = np.zeros((16, 32), dtype=np.int64)
    v_idx = np.zeros((16, 32), dtype=np.int64)
    step = 0
    di = 512 - (v_pos >> 1)
    vi = (v_pos % 128) >> 1
    while vi < 1024:
        for i in range(32):
            d_idx[step, i] = di
            v_idx[step, i] = vi
            di += 1
            vi += 1
        vi += 128 - 32
        di += 64 - 32
        step += 1
    vi = (128 - 32 + 1024) - vi
    di -= (512 - 32)
    while vi < 1024:
        for i in range(32):
            d_idx[step, i] = di
            v_idx[step, i] = vi
            di += 1
            vi += 1
        vi += 128 - 32
        di += 64 - 32
        step += 1
    assert step == 16
    return d_idx, v_idx


_D_DUP = np.concatenate([T.MP2_SYNTHESIS_WINDOW, T.MP2_SYNTHESIS_WINDOW])
# per ring phase (VPos/64): tap coefficient and V index tables
_PHASE_TAPS = [_trace_window(p * 64) for p in range(16)]
_TAP_D = np.stack([_D_DUP[d] for d, _ in _PHASE_TAPS])       # f32 [16,16,32]
_TAP_V = np.stack([v for _, v in _PHASE_TAPS])               # i64 [16,16,32]

def _to_i32_trunc(x: np.ndarray) -> np.ndarray:
    """JS ToInt32 on float64: truncate toward zero, wrap mod 2^32."""
    t = np.trunc(x).astype(np.int64)
    t = (t + 0x80000000) & 0xFFFFFFFF
    return t - 0x80000000


# ---------------------------------------------------------------------------
# Exact host path
# ---------------------------------------------------------------------------

def synthesize_exact(samples: np.ndarray, state: MP2State):
    """samples: int32 [T, 2, 32] dequantized subband samples.
    Returns (pcm float32 [2, T*32], new_state), bit-exact with the
    reference."""
    T_sub = samples.shape[0]
    V = state.V.copy()
    v_pos = state.v_pos
    pcm = np.zeros((2, T_sub * 32), dtype=np.float32)

    # matrixing for all sub-blocks/channels at once (f64 -> f32 at store)
    chunks = dct32_chunks(samples.reshape(T_sub * 2, 32).astype(np.float64))
    chunks = chunks.astype(np.float32).reshape(T_sub, 2, 64)

    for t in range(T_sub):
        v_pos = (v_pos - 64) & 1023
        phase = v_pos >> 6
        tap_d = _TAP_D[phase].astype(np.float64)        # [16, 32]
        tap_v = _TAP_V[phase]                           # [16, 32]
        for ch in range(2):
            V[ch, v_pos:v_pos + 64] = chunks[t, ch]
            u = np.zeros(32, dtype=np.int64)
            vch = V[ch].astype(np.float64)
            for step in range(16):
                u = _to_i32_trunc(u.astype(np.float64) +
                                  tap_d[step] * vch[tap_v[step]])
            pcm[ch, t * 32:(t + 1) * 32] = (u / 2147418112.0).astype(np.float32)
    return pcm, MP2State(V, v_pos)


# ---------------------------------------------------------------------------
# Device path: matrixing + the 16-tap windowing, gathered by ring phase
# ---------------------------------------------------------------------------

def _dct32_matrix() -> np.ndarray:
    """Extract the exact linear map of dct32_chunks as a [32 -> 64] matrix
    (float64 evaluation of the DAG on unit vectors)."""
    eye = np.eye(32, dtype=np.float64)
    return dct32_chunks(eye).T.astype(np.float32)        # [64, 32]


DCT32_MATRIX = _dct32_matrix()

# the windowing taps by ring phase p = VPos/64, as reads of the chunk
# history: ring slot s holds the chunk written (s - p) mod 16 sub-blocks
# ago, so tap (step, i) of phase p reads offset _TAP_V & 63 of the chunk
# of age _TAP_AGE, weighted by _TAP_D
_TAP_AGE = ((_TAP_V >> 6) - np.arange(16)[:, None, None]) % 16   # [16,16,32]
_TAP_OFF = _TAP_V & 63                                            # [16,16,32]

_device_tables: dict = {}


def _tables(device: torch.device):
    """DCT32_MATRIX and the tap tables on `device` (uploaded once)."""
    key = str(device)
    if key not in _device_tables:
        t = lambda a, dt: torch.as_tensor(a, dtype=dt, device=device)
        _device_tables[key] = (t(DCT32_MATRIX, torch.float32),
                               t(_TAP_AGE, torch.int64),
                               t(_TAP_OFF, torch.int64),
                               t(_TAP_D, torch.float32))
    return _device_tables[key]


def synthesize_device(samples: torch.Tensor, v_chunks: torch.Tensor,
                      v_pos: int):
    """Batched float32 synthesis on the device of the inputs.

    samples:   int32/float [T, 2, 32] dequantized subband samples
    v_chunks:  float32 [15, 2, 64] -- V chunks of the 15 previous
               sub-blocks, most recent last (age 1 = index 14).
    v_pos:     ring position before this batch (python int).

    Returns (pcm float32 [2, T*32], new v_chunks [15, 2, 64]).

    Every sum runs as a fixed sequence of float32 multiplies and adds
    (no matmul: a TF32 matmul setting cannot reach it, and no reduction
    kernel picks its order by batch size), so one output value is
    computed the same way whatever T is: a batch equals its frames
    decoded one at a time."""
    dev = samples.device
    Tn = samples.shape[0]
    m, tap_age, tap_off, tap_d = _tables(dev)
    s = samples.to(torch.float32)
    chunks = s[..., 0:1] * m[:, 0]                       # [T, 2, 64]
    for k in range(1, 32):
        chunks = chunks + s[..., k:k + 1] * m[:, k]
    hist = torch.cat([v_chunks.to(torch.float32), chunks])  # [T+15, 2, 64]

    # phase of sub-block t (VPos decremented before use)
    t = torch.arange(Tn, device=dev)
    phases = (v_pos // 64 - 1 - t) % 16                  # [T]
    # tap (step, i) of sub-block t reads hist[t + 15 - age] at `off`
    row = (t[:, None, None] + 15) - tap_age[phases]      # [T, 16, 32]
    flat = hist.permute(1, 0, 2).reshape(2, -1)          # [2, (T+15)*64]
    vals = flat[:, (row * 64 + tap_off[phases]).reshape(-1)].reshape(
        2, Tn, 16, 32)
    d = tap_d[phases]                                    # [T, 16, 32]
    u = vals[:, :, 0] * d[:, 0]                          # [2, T, 32]
    for step in range(1, 16):
        u = u + vals[:, :, step] * d[:, step]
    pcm = (u / 2147418112.0).reshape(2, Tn * 32)
    return pcm, hist[-15:]

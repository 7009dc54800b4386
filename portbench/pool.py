"""The inputs of a run, made from its seed: a pool of distinct closed GOPs
of the configuration's video, and a cycle of MP2 frames for its audio.

Encoding runs at ~0.1-0.25 s a frame, far below the decode rates measured,
so a run loops a pool: files and feeds are the pool's GOPs in seeded
orders.  The pool is cached in `portbench/.cache/pool/`, keyed by the
configuration's content and the seed, so only the first run with a seed
in a checkout pays the encode.  The reference decode of the pool (its
expected planes, and the work each picture asks of the kernels) runs
after the window, GOP by GOP in worker processes.
"""

from __future__ import annotations

import hashlib
import json
import os
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context
from typing import List, NamedTuple, Optional

import numpy as np

CACHE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         '.cache', 'pool')


def derived_seed(seed: int, *path: int) -> int:
    """A 64-bit seed for part `path` of the run seeded `seed`."""
    ss = np.random.SeedSequence([int(seed), *path])
    a, b = (int(x) for x in ss.generate_state(2))
    return (a << 32) | b


def _workers(n: int) -> int:
    return max(1, min(n, (os.cpu_count() or 1), 8))


def encode_gop(cfg: dict, seed: int, g: int) -> List[bytes]:
    """GOP g of the pool of run `seed`: its pictures' ES chunks, the first
    with the sequence and GOP headers.  A GOP is drawn again (from the
    next derived seed) while its first two pictures hold a macroblock
    that a decoder following the reference leaves undecoded: such a
    macroblock keeps what the buffer held two pictures before, which in
    a file is the GOP before's, so the GOP would not decode alike
    wherever it stands."""
    from .gen.gen import encode_realistic_stream
    c = cfg['content']
    for attempt in range(100):
        unvisited: list = []
        _, chunks = encode_realistic_stream(
            cfg['width'], cfg['height'], n_frames=cfg['gop'],
            seed=derived_seed(seed, 1, g, attempt), gop=cfg['gop'],
            qscale=c['qscale'], f_code=c['f_code'],
            frame_rate=float(cfg['fps']), p_skip=c['p_skip'],
            p_mc=c['p_mc'], i_mean_ac=c['i_mean_ac'],
            i_mean_ac_chroma=c['i_mean_ac_chroma'],
            p_mean_ac=c['p_mean_ac'], unvisited=unvisited)
        if all(pic >= 2 for pic, _ in unvisited):
            return chunks[:-1]          # without the sequence end code
    raise RuntimeError('no GOP of the pool decodes alike in every context')


def encode_audio(cfg: dict, seed: int) -> List[bytes]:
    """The audio cycle: `cfg['audio']['cycle_frames']` MP2 frames."""
    from .gen.mp2_enc import encode_stream
    a = cfg['audio']
    _, frames = encode_stream(a['cycle_frames'], seed=seed,
                              sf_range=tuple(a['sf_range']))
    return frames


class Pool(NamedTuple):
    gops: List[List[bytes]]         # [G][gop] picture chunks
    audio: Optional[List[bytes]]    # the MP2 cycle, or None


def _key(cfg: dict, seed: int) -> str:
    body = json.dumps({k: cfg[k] for k in ('width', 'height', 'fps', 'gop',
                                           'content', 'audio', 'pool_gops')},
                      sort_keys=True)
    h = hashlib.sha256(body.encode()).hexdigest()[:16]
    return f"{cfg['name']}-{h}-{int(seed)}"


def _pack(parts: List[bytes]) -> np.ndarray:
    return np.frombuffer(b''.join(parts), np.uint8)


def _unpack(blob: np.ndarray, lens: np.ndarray) -> List[bytes]:
    raw, out, at = blob.tobytes(), [], 0
    for n in lens.tolist():
        out.append(raw[at:at + n])
        at += n
    return out


def make_pool(cfg: dict, seed: int, cache: bool = True) -> Pool:
    """The pool of run `seed`: `cfg['pool_gops']` GOPs, each encoded from
    its own derived seed in a worker process, and the audio cycle; read
    from the cache when a run with this seed made it before."""
    path = os.path.join(CACHE_DIR, _key(cfg, seed) + '.npz')
    n_gops, gop = cfg['pool_gops'], cfg['gop']
    if cache and os.path.exists(path):
        with np.load(path) as z:
            pics = _unpack(z['video'], z['video_lens'])
            audio = (_unpack(z['audio'], z['audio_lens'])
                     if 'audio' in z.files else None)
        return Pool([pics[g * gop:(g + 1) * gop] for g in range(n_gops)],
                    audio)
    want_audio = cfg.get('audio') is not None
    with ProcessPoolExecutor(_workers(n_gops + want_audio),
                             mp_context=get_context('spawn')) as ex:
        futs = [ex.submit(encode_gop, cfg, seed, g) for g in range(n_gops)]
        afut = (ex.submit(encode_audio, cfg, derived_seed(seed, 2))
                if want_audio else None)
        gops = [f.result() for f in futs]
        audio = afut.result() if afut is not None else None
    if cache:
        os.makedirs(CACHE_DIR, exist_ok=True)
        pics = [p for g in gops for p in g]
        arrays = dict(video=_pack(pics),
                      video_lens=np.array([len(p) for p in pics], np.int64))
        if audio is not None:
            arrays.update(audio=_pack(audio), audio_lens=np.array(
                [len(f) for f in audio], np.int64))
        tmp = f'{path}.{os.getpid()}.tmp.npz'
        np.savez(tmp, **arrays)
        os.replace(tmp, path)
    return Pool(gops, audio)


# ------------------------------------------------------------ reference

def reference_gop(chunks: List[bytes], float_idct: bool = False):
    """The plain reference's decode of one GOP: its planes and the work
    each picture asks of the kernels.  `float_idct` computes its IDCT in
    float32 (the correctness control)."""
    from .reference.mpeg1 import ReferenceMPEG1, idct_float32, idct_int
    ref = ReferenceMPEG1(b''.join(chunks),
                         idct=idct_float32 if float_idct else idct_int)
    frames = ref.decode_all()
    if len(frames) != len(chunks):
        raise RuntimeError(f'the reference decoded {len(frames)} of '
                           f'{len(chunks)} pictures of a pool GOP')
    return frames, ref.work


def reference_audio(frames: List[bytes]) -> np.ndarray:
    """The plain reference's PCM of the audio cycle played twice: float32
    [2 * n, 2, 1152].  A frame's PCM depends on it and the frame before
    (the synthesis window spans less than a frame), so the second cycle
    is what every later cycle decodes to."""
    from .reference.mp2 import OracleMP2
    out = OracleMP2(b''.join(frames) * 2).decode_all()
    if len(out) != 2 * len(frames):
        raise RuntimeError(f'the reference decoded {len(out)} of '
                           f'{2 * len(frames)} MP2 frames')
    return np.stack([np.stack(lr) for lr in out])


def expected_pcm(ref_pcm: np.ndarray, n_frames: int) -> np.ndarray:
    """The PCM of a track of n_frames frames of the cycle, from the
    reference's two cycles: float32 [2, n_frames * 1152]."""
    n = ref_pcm.shape[0] // 2
    idx = np.array([k if k < n else n + (k - n) % n
                    for k in range(n_frames)], np.int64)
    return ref_pcm[idx].transpose(1, 0, 2).reshape(2, -1)


def reference(pool: Pool, video: bool = True, audio: bool = True,
              float_idct: bool = False):
    """(frames [G][gop] of (y, cr, cb), work [G][gop], pcm or None): the
    pool's reference decode, GOP by GOP in worker processes."""
    jobs = len(pool.gops) * video + (pool.audio is not None and audio)
    with ProcessPoolExecutor(_workers(jobs),
                             mp_context=get_context('spawn')) as ex:
        futs = [ex.submit(reference_gop, g, float_idct) for g in pool.gops] \
            if video else []
        afut = (ex.submit(reference_audio, pool.audio)
                if pool.audio is not None and audio else None)
        got = [f.result() for f in futs]
        pcm = afut.result() if afut is not None else None
    return [g[0] for g in got], [g[1] for g in got], pcm

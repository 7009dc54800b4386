"""Per-frame views of the packed wire (host side, numpy).

A packed `parse_batch` dict holds one batch's streams back to back; the
parser also records each frame's share of them (`pairs_pf`, `runs_pf`,
`escs_pf`).  `split_packed_frames` cuts a batch into per-frame dicts and
`merge_packed_frames` joins any selection of them into a batch dict that
`models.mpeg1.build_fused_buffer` takes (thumbnails pick the I pictures
this way).  Copies of jsmpeg_tpu/parallel/packed.py's helpers; the mesh
decode that uses them there comes with the port's scale-out.
"""

from __future__ import annotations

from typing import List

import numpy as np

_POPCOUNT8 = np.array([bin(x).count('1') for x in range(256)], np.uint8)

# one RLE run covers at most 65535 MBs (u16 wire field); a tile slab of a
# single picture never comes close (720p is 3600 MBs total)
_RUN_CAP = 0xFFFF


def split_packed_frames(batch: dict) -> List[dict]:
    """Slice a packed parse_batch dict into per-frame packed dicts using
    the per-frame counts the parser records."""
    n = batch['n']
    pp = np.concatenate([[0], np.cumsum(batch['pairs_pf'])]).astype(np.int64)
    rr = np.concatenate([[0], np.cumsum(batch['runs_pf'])]).astype(np.int64)
    ee = np.concatenate([[0], np.cumsum(batch['escs_pf'])]).astype(np.int64)
    # the per-frame cumulative counts cover frames [0, n); frame n-1's
    # streams end at the batch totals
    pp = np.append(pp[:n], len(batch['sp_pos']))
    rr = np.append(rr[:n], len(batch['run_len']))
    ee = np.append(ee[:n], len(batch['sp_esc']))
    out = []
    for i in range(n):
        out.append(dict(
            run_len=batch['run_len'][rr[i]:rr[i + 1]],
            run_flags=batch['run_flags'][rr[i]:rr[i + 1]],
            run_cbp=batch['run_cbp'][rr[i]:rr[i + 1]],
            run_mv=batch['run_mv'][rr[i]:rr[i + 1]],
            sp_pos=batch['sp_pos'][pp[i]:pp[i + 1]],
            sp_v8=batch['sp_v8'][pp[i]:pp[i + 1]],
            sp_esc=batch['sp_esc'][ee[i]:ee[i + 1]],
            pic_type=int(batch['pic_types'][i])))
    return out


def merge_packed_frames(frames: List[dict]) -> dict:
    """Per-frame packed dicts (split_packed_frames output) -> one batch
    dict usable by the single-device packed pipeline."""
    batch = _concat_cell(frames, len(frames))
    batch['n_blocks'] = int(sum(
        (_POPCOUNT8[f['run_cbp']] * f['run_len'].astype(np.int64)).sum()
        for f in frames))
    batch['pic_types'] = np.array([f['pic_type'] for f in frames], np.uint8)
    return batch


def _concat_cell(frames: List[dict], n: int) -> dict:
    """Concatenate per-frame streams into a batch dict (the
    build_fused_buffer contract)."""
    cat = lambda k: (np.concatenate([f[k] for f in frames]) if frames
                     else np.zeros(0))
    return dict(
        n=n,
        run_len=cat('run_len').astype(np.uint16),
        run_flags=cat('run_flags').astype(np.uint8),
        run_cbp=cat('run_cbp').astype(np.uint8),
        run_mv=(np.concatenate([f['run_mv'] for f in frames])
                if frames else np.zeros((0, 2))).astype(np.int16),
        sp_pos=cat('sp_pos').astype(np.uint8),
        sp_v8=cat('sp_v8').astype(np.int8),
        sp_esc=cat('sp_esc').astype(np.int16),
        n_blocks=sum(f.get('n_blocks', 0) for f in frames))

"""`ts_mux.mux_av` at memory speed, for files built from a fixed set of
access units (the pool's pictures and the audio cycle).

Each distinct access unit is muxed once into its TS packets, as
`TSMuxer` writes them alone (continuity counters from 0, PTS 0).  A file
is those packets concatenated in `mux_av`'s order, with each packet's
continuity counter and each unit's PTS written in place: the same bytes
as `mux_av` over the same units (`tests/test_pb_generator.py`).
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np

from .ts_mux import TSMuxer

# a PES header with a PTS: start code and stream id (4), length (2), flags
# (2), header length (1), then the PTS's 5 bytes
_PES_HEADER = 14
_PTS_AT = 9


class Unit(NamedTuple):
    packets: np.ndarray     # [n, 188] uint8, counters from 0, PTS 0
    pts_at: int             # the PTS's offset in the first packet


def mux_unit(pid: int, stream_id: int, data: bytes, bounded: bool) -> Unit:
    """One access unit's TS packets, as `TSMuxer` writes it alone."""
    m = TSMuxer()
    m.add_access_unit(pid, stream_id, data, 0.0, bounded)
    packets = np.frombuffer(m.getvalue(), np.uint8).reshape(-1, 188)
    first = min(184, _PES_HEADER + len(data))
    return Unit(packets, 188 - first + _PTS_AT)


def _pts_bytes(ticks: List[int]) -> np.ndarray:
    """`pes_packet`'s 5 PTS bytes for each tick count: [n, 5] uint8."""
    t = np.asarray(ticks, np.int64) & ((1 << 33) - 1)
    hi, mid, lo = (t >> 30) & 0x7, (t >> 15) & 0x7FFF, t & 0x7FFF
    return np.stack([(0x2 << 4) | (hi << 1) | 1, mid >> 7,
                     ((mid & 0x7F) << 1) | 1, lo >> 7,
                     ((lo & 0x7F) << 1) | 1], 1).astype(np.uint8)


def mux_av(video: List[Unit], frame_rate: float, audio: List[Unit],
           samples_per_frame: int, sample_rate: int) -> bytes:
    """`ts_mux.mux_av` of the units' data (video unbounded on PID 0x100,
    audio bounded on 0x101, the PIDs the units were muxed with)."""
    units = [(i / frame_rate, 'v', i) for i in range(len(video))]
    units += [(i * samples_per_frame / sample_rate, 'a', i)
              for i in range(len(audio))]
    units.sort(key=lambda u: (u[0], u[1]))
    blocks = [(video if kind == 'v' else audio)[i] for _, kind, i in units]
    counts = np.array([len(b.packets) for b in blocks], np.int64)
    out = np.concatenate([b.packets for b in blocks])
    # continuity counters: each PID's packets numbered in file order
    is_video = np.repeat(np.array([k == 'v' for _, k, _ in units]), counts)
    cc = np.empty(len(out), np.int64)
    cc[is_video] = np.arange(int(is_video.sum()))
    cc[~is_video] = np.arange(int((~is_video).sum()))
    out[:, 3] = (out[:, 3] & 0xF0) | (cc & 0xF).astype(np.uint8)
    # each unit's PTS, in its first packet
    first = np.concatenate([[0], np.cumsum(counts)[:-1]])
    at = first * 188 + np.array([b.pts_at for b in blocks], np.int64)
    flat = out.reshape(-1)
    flat[at[:, None] + np.arange(5)] = _pts_bytes(
        [int(round(pts * 90000)) for pts, _, _ in units])
    return out.tobytes()

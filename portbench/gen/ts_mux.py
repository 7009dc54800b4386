"""Minimal MPEG-TS muxer: a frozen copy of the port's `testing/ts_mux.py`.

Packs elementary-stream access units into PES packets and 188-byte TS
packets the way the reference demuxer expects them
(jsmpeg/src/ts.js): PES start codes right after the TS header,
PTS-only PES headers, adaptation-field stuffing (which doubles as the
video frame-end heuristic), continuity counters.
"""

from __future__ import annotations


def pes_packet(stream_id: int, payload: bytes, pts: float | None,
               bounded: bool) -> bytes:
    """Build one PES packet.  `bounded` writes the real packet length
    (required for audio; video uses 0 = unbounded)."""
    header = bytearray([0x00, 0x00, 0x01, stream_id])
    opt = bytearray()
    opt.append(0x80)                      # '10' + no scrambling/flags
    if pts is not None:
        opt.append(0x80)                  # PTS only
        opt.append(5)                     # header data length
        ticks = int(round(pts * 90000)) & ((1 << 33) - 1)
        p32_30 = (ticks >> 30) & 0x7
        p29_15 = (ticks >> 15) & 0x7FFF
        p14_0 = ticks & 0x7FFF
        opt.append((0x2 << 4) | (p32_30 << 1) | 1)
        opt.append(p29_15 >> 7)
        opt.append(((p29_15 & 0x7F) << 1) | 1)
        opt.append(p14_0 >> 7)
        opt.append(((p14_0 & 0x7F) << 1) | 1)
    else:
        opt.append(0x00)
        opt.append(0)
    length = (len(opt) + len(payload)) if bounded else 0
    assert length < 0x10000
    header.append((length >> 8) & 0xFF)
    header.append(length & 0xFF)
    return bytes(header) + bytes(opt) + payload


class TSMuxer:
    def __init__(self):
        self.out = bytearray()
        self._cc = {}                     # pid -> continuity counter

    def _ts_packet(self, pid: int, payload: bytes, payload_start: bool) -> None:
        """Emit one 188-byte packet; stuff with an adaptation field if the
        payload is short."""
        assert len(payload) <= 184
        cc = self._cc.get(pid, 0)
        self._cc[pid] = (cc + 1) & 0xF
        stuffing = 184 - len(payload)
        adaptation = 0x30 if stuffing else 0x10
        hdr = bytes([
            0x47,
            (0x40 if payload_start else 0x00) | ((pid >> 8) & 0x1F),
            pid & 0xFF,
            adaptation | cc,
        ])
        body = bytearray()
        if stuffing:
            body.append(stuffing - 1)     # adaptation_field_length
            if stuffing > 1:
                body.append(0x00)         # flags
                body.extend(b'\xff' * (stuffing - 2))
        body.extend(payload)
        packet = hdr + bytes(body)
        assert len(packet) == 188
        self.out.extend(packet)

    def write_pes(self, pid: int, pes: bytes) -> None:
        first = True
        pos = 0
        while pos < len(pes):
            chunk = pes[pos:pos + 184]
            pos += len(chunk)
            self._ts_packet(pid, chunk, first)
            first = False

    def add_access_unit(self, pid: int, stream_id: int, data: bytes,
                        pts: float | None, bounded: bool) -> None:
        self.write_pes(pid, pes_packet(stream_id, data, pts, bounded))

    def getvalue(self) -> bytes:
        return bytes(self.out)


def mux_video(es_frames: list[bytes], frame_rate: float,
              pid: int = 0x100, start_pts: float = 0.0) -> bytes:
    """Mux per-frame video ES chunks into a .ts byte string."""
    mux = TSMuxer()
    for i, frame in enumerate(es_frames):
        mux.add_access_unit(pid, 0xE0, frame, start_pts + i / frame_rate,
                            bounded=False)
    return mux.getvalue()


def mux_av(es_frames: list[bytes], frame_rate: float,
           audio_frames: list[bytes], samples_per_frame: int,
           sample_rate: int, video_pid: int = 0x100,
           audio_pid: int = 0x101) -> bytes:
    """Interleave video frames and audio frames by PTS."""
    mux = TSMuxer()
    units = []
    for i, f in enumerate(es_frames):
        units.append((i / frame_rate, 'v', f))
    for i, f in enumerate(audio_frames):
        units.append((i * samples_per_frame / sample_rate, 'a', f))
    units.sort(key=lambda u: (u[0], u[1]))
    for pts, kind, data in units:
        if kind == 'v':
            mux.add_access_unit(video_pid, 0xE0, data, pts, bounded=False)
        else:
            mux.add_access_unit(audio_pid, 0xC0, data, pts, bounded=True)
    return mux.getvalue()

"""Stream-parallel decode on ONE device: N independent MPEG1 streams
share one card and one serving surface (the port of
jsmpeg_tpu/parallel/streams.py, round-robin mode).

The reference player decodes exactly one stream per instance
(jsmpeg/src/player.js:27-55); serving wants many camera feeds per card.
Round-robin: every stream keeps its own (cur, fwd) carry on the device,
and each fleet round decodes every stream that has frames in turn, on
the current CUDA stream, through the single-stream batch path
(`models.mpeg1.upload_packed` -> `decode_levels`: one K1 and one K2
launch per stream batch).  Launches are asynchronous, so stream i+1's
wire is built and uploaded while stream i's kernels run, and the card
drains the queue serially.

The streams do not go on separate CUDA streams: K2 is a cooperative
launch whose grid is the co-resident maximum over every SM
(csrc/mc_combine.cu), so two K2 launches cannot be resident together and
would run one after the other anyway.  The joint formulations of
jsmpeg_tpu ('stacked': the streams stacked along MB rows into one
launch pair per round; 'vmap') are not ported yet: ROADMAP.md queue
items 1 and 2.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from ..config import resolve_device
from ..models.mpeg1 import MPEG1Decoder, decode_levels, upload, upload_packed
from ..ops.frame import Planes

_NOT_PORTED = {
    'stacked': 'ROADMAP.md queue item 1 (the stacked mode)',
    'vmap': "ROADMAP.md queue item 2 (the counterpart of 'vmap')",
}


class MultiStreamDecoder:
    """Decode N same-resolution MPEG1 elementary streams on one device.
    write(i, data) feeds stream i; decode_batch() runs the fleet's round
    and returns the newly decoded frames per stream.

    All streams must share coded size and quant matrices (homogeneous
    serving fleets do); the first sequence header to ARRIVE becomes the
    fleet's geometry contract and later headers are checked against it
    (raise by default; quarantine=True marks the mismatched feed dead
    instead, with the reason in .dead[i]).  A stream whose batch cannot
    ride the packed wire (coefficient-dense cap overflow, exactness
    fallback) is demoted to its own MPEG1Decoder and keeps decoding
    bit-exactly outside the round.

    Options: batch_frames (frames per stream per round), streaming (the
    EVICT memory bound per parser: one bool for the fleet, or one per
    stream), buffer_size (its cap), quarantine, mode ('roundrobin';
    'stacked' and 'vmap' are not ported yet), device (None = 'cuda',
    which raises without a GPU; the demoted decoders run on the same
    device)."""

    def __init__(self, n_streams: int, batch_frames: int = 32,
                 streaming: Union[bool, Sequence[bool]] = False,
                 buffer_size: int = 512 * 1024,
                 quarantine: bool = False,
                 mode: str = 'roundrobin',
                 device=None):
        if mode in _NOT_PORTED:
            raise ValueError(f'multi-stream mode {mode!r} is not ported '
                             f"yet ({_NOT_PORTED[mode]}); use "
                             "mode='roundrobin'")
        if mode != 'roundrobin':
            raise ValueError(f'unknown multi-stream mode {mode!r}')
        self.device = resolve_device(device, 'MultiStreamDecoder')
        from ..host import best_parser
        self.n = n_streams
        self.batch_frames = batch_frames
        # streaming=True applies the reference's EVICT-mode memory bound
        # (videoBufferSize semantics): a long-running serving process must
        # not grow with hours of consumed bitstream.  Per stream, so that
        # a static file in a fleet of live feeds keeps every byte (the
        # Player's rule: only a live source is bounded).
        if isinstance(streaming, bool):
            streaming = [streaming] * n_streams
        if len(streaming) != n_streams:
            raise ValueError(f'{len(streaming)} streaming flags for '
                             f'{n_streams} streams')
        self.streaming = [bool(x) for x in streaming]
        self.buffer_size = buffer_size
        self.parsers = [best_parser() for _ in range(n_streams)]
        if not hasattr(self.parsers[0], 'parse_batch'):
            raise RuntimeError('multi-stream decode needs the native '
                               'packed parser (build_native)')
        # quarantine=True (the serving posture) isolates a bad feed --
        # unparseable bytes, resolution/quant mismatch -- instead of
        # failing the whole round; .dead[i] carries the reason and the
        # other feeds keep decoding
        self.quarantine = bool(quarantine)
        self.dead: List[Optional[str]] = [None] * n_streams
        # streams demoted to their own serial-capable decoder (dense cap
        # overflow / exactness fallback); index -> MPEG1Decoder
        self._demoted: dict = {}
        # per-stream (cur, fwd) Planes on the device; None until the
        # stream's first batch
        self._carry: List[Optional[tuple]] = [None] * n_streams
        self._seq = None
        self._quant = None
        self._empty = None

    def _put(self, a: np.ndarray) -> torch.Tensor:
        return upload(a, self.device)

    def write(self, i: int, data: bytes):
        if self.dead[i]:
            return                      # dropped feed: do not buffer bytes
        dec = self._demoted.get(i)
        if dec is not None:
            # pts=None: no timestamp collection (no seek surface here)
            dec.write(None, data)       # demoted: its own caps/evict apply
            return
        self.parsers[i].write(bytes(data))

    def _check_seq(self):
        s0 = self._seq
        for i, p in enumerate(self.parsers):
            s = p.seq
            if s is None or self.dead[i]:
                continue
            if s0 is None:
                s0 = s
                continue
            why = None
            if (s.coded_width, s.coded_height) != (s0.coded_width,
                                                   s0.coded_height):
                why = ('multi-stream decode needs one resolution '
                       f'({s.coded_width}x{s.coded_height} vs '
                       f'{s0.coded_width}x{s0.coded_height})')
            elif (not np.array_equal(s.intra_quant_matrix,
                                     s0.intra_quant_matrix)
                  or not np.array_equal(s.non_intra_quant_matrix,
                                        s0.non_intra_quant_matrix)):
                why = 'multi-stream decode needs shared quant matrices'
            if why:
                if not self.quarantine:
                    raise ValueError(why)
                self.dead[i] = why
        self._seq = s0
        return s0

    def _zero_planes(self, seq) -> Planes:
        cw, ch = seq.coded_width, seq.coded_height
        z = lambda hh, ww: torch.zeros((hh, ww), dtype=torch.uint8,
                                       device=self.device)
        return Planes(z(ch, cw), z(ch >> 1, cw >> 1), z(ch >> 1, cw >> 1))

    def _empty_result(self, seq) -> Planes:
        """Zero-frame Planes for an idle stream's round -- one cached
        allocation per geometry, not three fresh tensors per idle stream
        per round."""
        key = (seq.coded_width, seq.coded_height)
        if self._empty is None or self._empty[0] != key:
            cw, ch = key
            z = lambda hh, ww: torch.zeros((0, hh, ww), dtype=torch.uint8,
                                           device=self.device)
            self._empty = (key, Planes(z(ch, cw), z(ch >> 1, cw >> 1),
                                       z(ch >> 1, cw >> 1)))
        return self._empty[1]

    def _carry_pair(self, i: int):
        """Stream i's (cur, fwd) planes, or None if the stream never
        joined a round."""
        return self._carry[i]

    def _demote(self, i: int, pending: Optional[dict]) -> Optional[Planes]:
        """Hand stream i to its own serial-capable MPEG1Decoder (its
        batch hit a condition the packed wire cannot carry:
        coefficient-dense cap overflow or the exactness fallback).  The
        demoted decoder adopts the stream's PARSER (buffered bytes +
        sequence state) and its carry, so not a frame is lost and the
        stream keeps decoding bit-exactly -- just no longer in the
        round.  Returns the frames decoded from the pending dense batch,
        if any."""
        dec = MPEG1Decoder({'device': self.device,
                            'streaming': self.streaming[i],
                            'videoBufferSize': self.buffer_size})
        dec.parser = self.parsers[i]
        pair = self._carry_pair(i)
        if pair is not None:
            dec._cur, dec._fwd = pair
        elif self.parsers[i].seq is not None:
            dec._init_planes()          # demoted before any round
        dec.can_play = True
        self._demoted[i] = dec
        if pending is not None and pending.get('n', 0):
            return dec._decode_batch(pending).planes
        return None

    def _evict(self, i: int) -> None:
        bits = getattr(self.parsers[i], 'bits', None)
        if bits is None:
            return
        # consumed bytes are never re-read (no seek surface here)
        bits.evict_consumed()
        if self.streaming[i]:
            unread = bits.byte_length - (bits.index >> 3)
            if unread > self.buffer_size:
                # emergency evac: stay current over complete (reference
                # src/buffer.js:30-62 EVICT mode)
                bits.index = bits.byte_length << 3
                bits.evict_consumed()

    def decode_batch(self, eof: bool = False) -> Optional[List[Planes]]:
        """Parse up to batch_frames per stream and decode every stream
        that has frames, one after the other on the device.  Returns one
        Planes per stream ([F_i, H, W] device tensors, cut to the
        stream's real frame count; F_i = 0 for a stream with nothing
        new), or None when no stream produced a frame."""
        F = self.batch_frames
        batches: List[Optional[dict]] = []
        demoted_frames = {}
        newly_demoted = False
        for i, p in enumerate(self.parsers):
            if self.dead[i] or i in self._demoted:
                batches.append(None)
                if i in self._demoted:
                    fr = self._demoted[i].decode_available(eof=eof)
                    # whole-batch tensors, never per-frame slices
                    demoted_frames[i] = (fr.stacked_planes()
                                         if fr is not None else None)
                continue
            try:
                b = p.parse_batch(F, eof=eof)
            except Exception as e:              # noqa: BLE001
                # serving posture: a feed whose bitstream breaks its own
                # parser is quarantined with the reason; the fleet's
                # other feeds keep decoding.  Only the parse is guarded:
                # a device error propagates.
                if not self.quarantine:
                    raise
                self.dead[i] = f'parse error: {e!r}'
                batches.append(None)
                continue
            if b == 'fallback' or (isinstance(b, dict) and b.get('n', 0)
                                   and 'sp_pos' not in b):
                # a per-stream condition the packed wire cannot carry:
                # demote the stream to its own serial-capable decoder
                # (bit-exact continuation) instead of failing the round
                demoted_frames[i] = self._demote(
                    i, b if isinstance(b, dict) else None)
                newly_demoted = True
                batches.append(None)
                continue
            batches.append(b if isinstance(b, dict) and b.get('n', 0)
                           else None)
            self._evict(i)
        seq = self._check_seq()
        # a stream quarantined by the seq check -- this round or earlier
        # -- may have parsed (or demoted-decoded) in another geometry:
        # discard its output and drop its demoted decoder
        batches = [None if self.dead[i] else b
                   for i, b in enumerate(batches)]
        for i in list(self._demoted):
            if self.dead[i]:
                del self._demoted[i]
                demoted_frames.pop(i, None)
        have_demoted = any(v is not None and v.y.shape[0]
                           for v in demoted_frames.values())
        if seq is None or (not any(batches) and not have_demoted
                           and not newly_demoted):
            # a round that just demoted a stream returns an empty result
            # instead of None: the demoted decoder may produce frames
            # next round, so callers must not treat this as drained
            return None
        if self._quant is None:
            self._quant = tuple(
                torch.as_tensor(np.asarray(q, np.int32), device=self.device)
                for q in (seq.intra_quant_matrix,
                          seq.non_intra_quant_matrix))
        iq, nq = self._quant
        result = []
        for i, b in enumerate(batches):
            if b is None:
                result.append(self._empty_result(seq))
                continue
            pair = self._carry[i]
            if pair is None:
                pair = (self._zero_planes(seq), self._zero_planes(seq))
            la = upload_packed(b, seq.mb_size, self._put)
            cur, fwd, outs = decode_levels(pair[0], pair[1], la, iq, nq)
            self._carry[i] = (cur, fwd)
            result.append(outs.planes)
        return self._overlay_demoted(result, demoted_frames)

    @staticmethod
    def _overlay_demoted(result, demoted_frames):
        """Splice demoted streams' outputs in.  Each value is already ONE
        stacked Planes built from whole-batch tensors
        (FrameSeq.stacked_planes / _demote), never per-frame slices."""
        for i, st in demoted_frames.items():
            if st is not None and st.y.shape[0]:
                result[i] = st
        return result

    def decode_all(self, eof: bool = True) -> List[List[Planes]]:
        """Drain every stream: returns, per stream, the list of decoded
        frames (full-resolution Planes, views into the round outputs)."""
        frames: List[List[Planes]] = [[] for _ in range(self.n)]
        while True:
            outs = self.decode_batch(eof=eof)
            if outs is None:        # no stream produced a frame
                break
            for i, st in enumerate(outs):
                for f in range(st.y.shape[0]):
                    frames[i].append(Planes(st.y[f], st.cr[f], st.cb[f]))
        return frames


def decode_streams_offline(streams: Sequence[bytes],
                           batch_frames: int = 32,
                           mode: str = 'roundrobin',
                           **kw) -> List[List[Planes]]:
    """Convenience entry: decode N elementary streams on one device,
    returning per-stream frame lists (test/library entry).  Extra
    keywords (device, quarantine, ...) go to MultiStreamDecoder."""
    dec = MultiStreamDecoder(len(streams), batch_frames=batch_frames,
                             mode=mode, **kw)
    for i, es in enumerate(streams):
        dec.write(i, es)
    return dec.decode_all(eof=True)

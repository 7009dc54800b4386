"""Stream-parallel decode on ONE device: N independent MPEG1 streams
share one card and one serving surface (the port of
jsmpeg_tpu/parallel/streams.py).

The reference player decodes exactly one stream per instance
(jsmpeg/src/player.js:27-55); serving wants many camera feeds per card.
Three formulations of a fleet round, all bit-exact against decoding each
stream alone:

  - 'roundrobin' (default): every stream keeps its own (cur, fwd) carry
    on the device, and each round decodes every stream that has frames
    in turn, on the current CUDA stream, through the single-stream batch
    path (`models.mpeg1.upload_packed` -> `decode_levels`: one K3, one K1
    and one K2 launch per stream batch).  Launches are asynchronous, so stream
    i+1's wire is built and uploaded while stream i's kernels run.
  - 'stacked': the S streams stack along macroblock rows into one joint
    picture per frame (mb_h -> S * mb_h).  The host interleaves the
    streams' per-frame packed records into ONE joint wire
    (`stack_stream_frames`: joint frame f = stream 0's frame f over
    stream 1's ...), and the round is ONE K1 and ONE K2 launch over it.
    K2 clamps motion rows at each stream's segment edge (each stream's
    own frame-edge clamp), and a stream with fewer frames than the round
    rides as a segment that stops at its own count (`seg_frames`), so
    feeds need not stay in lockstep.  The carry is one [S*H, W] plane
    set.
  - 'vmap' (jsmpeg_tpu's `jax.vmap`'d scan): one [S, L] upload of the
    streams' own wire buffers at shared sizes, ONE unpack of them into
    the stacked layout (K3 with a stream axis), then the same K1 + K2
    pair with S segments.  The carry is [S, H, W], which is the stacked
    layout in memory.

The streams do not go on separate CUDA streams: K2 is a cooperative
launch whose grid is the co-resident maximum over every SM
(csrc/mc_combine.cu), so two K2 launches cannot be resident together.

A joint round whose levels lattice would pass the int32 limit of
models.mpeg1.packed_to_levels (49 streams of 720p at batch 32) runs as
the fewest launch pairs whose lattice fits, each on its rows of the
joint carry (`decode_segments`, shared with the GOP mesh of
parallel/packed.py).  `decode_streams_mesh` decodes a fleet's closed
GOPs over a parallel.mesh.Mesh instead.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from ..config import resolve_device
from ..models.mpeg1 import (MPEG1Decoder, build_fused_buffer_sized,
                            check_lattice, decode_levels, lattice_groups,
                            mv_fits_narrow, unpack_wires, upload,
                            upload_packed)
from ..ops.frame import LevelsArrays, Planes
from .packed import _POPCOUNT8, _RUN_CAP, _concat_cell, split_packed_frames

MODES = ('roundrobin', 'stacked', 'vmap')


def decode_segments(cur: Planes, fwd: Planes, counts: List[int], n_mb: int,
                    levels_of, quant):
    """len(counts) segments of n_mb macroblocks each, stacked along the
    rows of the cur/fwd planes ([S*H, W]), segment s decoding its first
    counts[s] frames: ONE decode_levels (one K1 and one K2 launch) per
    run of segments whose levels lattice fits (models.mpeg1.
    lattice_groups: a single run below the int32 limit), each run on its
    rows of the carry.  levels_of(a, b, n_frames) builds segments
    [a, b)'s LevelsArrays over n_frames frames; quant is (intra_q,
    non_intra_q).  Returns (cur, fwd, [Planes of [counts[s], H, W] per
    segment]), the frames views into the launch outputs."""
    S = len(counts)
    rows = lambda p, a, b: Planes(*[x[a * (x.shape[0] // S):
                                      b * (x.shape[0] // S)] for x in p])
    carries, outs = [], []
    for a, b in lattice_groups(S, max(counts), n_mb):
        c, f, k = rows(cur, a, b), rows(fwd, a, b), counts[a:b]
        if max(k):
            c, f, pb = decode_levels(c, f, levels_of(a, b, max(k)), *quant,
                                     n_seg=b - a, seg_frames=k)
            outs += [Planes(*[x.chunk(b - a, dim=1)[s][:n]
                              for x in pb.planes]) for s, n in enumerate(k)]
        else:
            # a run of idle segments (past the limit only): no launch
            outs += [Planes(*[x.new_empty((0, x.shape[0] // (b - a),
                                           x.shape[1])) for x in c])] * len(k)
        carries.append((c, f))
    if len(carries) == 1:
        return (*carries[0], outs)
    cur, fwd = (Planes(*[torch.cat([cf[i][p] for cf in carries])
                         for p in range(3)]) for i in (0, 1))
    return cur, fwd, outs


def _pad_frame_dict(n_mb: int) -> dict:
    """One stream-frame's worth of padding records (flags 0: not written,
    not coded; the segment's frame count hides the rows anyway)."""
    k = -(-n_mb // _RUN_CAP)
    lens = np.full(k, _RUN_CAP, np.int64)
    lens[-1] = n_mb - (k - 1) * _RUN_CAP
    return dict(run_len=lens.astype(np.uint16),
                run_flags=np.zeros(k, np.uint8),
                run_cbp=np.zeros(k, np.uint8),
                run_mv=np.zeros((k, 2), np.int16),
                sp_pos=np.zeros(0, np.uint8),
                sp_v8=np.zeros(0, np.int8),
                sp_esc=np.zeros(0, np.int16))


def stack_stream_frames(per_stream: List[List[dict]], n_mb: int,
                        n_frames: int):
    """Interleave S streams' per-frame packed dicts
    (split_packed_frames output) into ONE joint batch over the stacked
    S*n_mb grid: joint frame f = every stream's frame f concatenated in
    stream order (stream i owns MB rows [i*mb_h, (i+1)*mb_h)).  Streams
    shorter than n_frames pad with flags-0 slabs.  Returns (batch dict
    for build_fused_buffer, valid bool [n_frames, S])."""
    s = len(per_stream)
    pad = _pad_frame_dict(n_mb)
    parts = []
    valid = np.zeros((n_frames, s), bool)
    for f in range(n_frames):
        for i, frames in enumerate(per_stream):
            if f < len(frames):
                parts.append(frames[f])
                valid[f, i] = True
            else:
                parts.append(pad)
    cat = lambda k: np.concatenate([p[k] for p in parts])
    rl = cat('run_len').astype(np.uint16)
    rc = cat('run_cbp').astype(np.uint8)
    batch = dict(
        n=n_frames,
        run_len=rl,
        run_flags=cat('run_flags').astype(np.uint8),
        run_cbp=rc,
        run_mv=np.concatenate([p['run_mv'] for p in parts]).astype(np.int16),
        sp_pos=cat('sp_pos').astype(np.uint8),
        sp_v8=cat('sp_v8').astype(np.int8),
        sp_esc=cat('sp_esc').astype(np.int16),
        n_blocks=int((_POPCOUNT8[rc] * rl.astype(np.int64)).sum()))
    return batch, valid


class MultiStreamDecoder:
    """Decode N same-resolution MPEG1 elementary streams on one device.
    write(i, data) feeds stream i; decode_batch() runs the fleet's round
    (see the module docstring for the three modes) and returns the newly
    decoded frames per stream.

    All streams must share coded size and quant matrices (homogeneous
    serving fleets do); the first sequence header to ARRIVE becomes the
    fleet's geometry contract and later headers are checked against it
    (raise by default; quarantine=True marks the mismatched feed dead
    instead, with the reason in .dead[i]).  A stream whose batch cannot
    ride the packed wire (coefficient-dense cap overflow, exactness
    fallback) is demoted to its own MPEG1Decoder, which adopts its carry,
    and keeps decoding bit-exactly outside the round; in the joint modes
    dead, demoted and idle streams ride as segments of zero frames.

    Options: batch_frames (frames per stream per round), streaming (the
    EVICT memory bound per parser: one bool for the fleet, or one per
    stream), buffer_size (its cap), quarantine, mode ('roundrobin',
    'stacked' or 'vmap'), device (None = 'cuda', which raises without a
    GPU; the demoted decoders run on the same device)."""

    def __init__(self, n_streams: int, batch_frames: int = 32,
                 streaming: Union[bool, Sequence[bool]] = False,
                 buffer_size: int = 512 * 1024,
                 quarantine: bool = False,
                 mode: str = 'roundrobin',
                 device=None):
        if mode not in MODES:
            raise ValueError(f'unknown multi-stream mode {mode!r}')
        self.mode = mode
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
        # roundrobin: per-stream (cur, fwd) Planes, None until the
        # stream's first batch; joint modes: one (cur, fwd) pair of joint
        # planes (_zero_carry), None until the first round
        self._carry = [None] * n_streams if mode == 'roundrobin' else None
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

    def _zero_planes(self, seq, lead: tuple = ()) -> Planes:
        """Zero planes of the fleet's geometry, with leading dimensions
        `lead` ((S,) for the vmap carry)."""
        cw, ch = seq.coded_width, seq.coded_height
        z = lambda hh, ww: torch.zeros(lead + (hh, ww), dtype=torch.uint8,
                                       device=self.device)
        return Planes(z(ch, cw), z(ch >> 1, cw >> 1), z(ch >> 1, cw >> 1))

    def _zero_carry(self, seq):
        """The joint modes' first carry: stacked planes [S*H, W] (stream
        i owns rows [i*H, (i+1)*H)), or vmap planes [S, H, W]."""
        if self.mode == 'stacked':
            p = self._zero_planes(seq)
            p = Planes(*[x.repeat(self.n, 1) for x in p])
        else:
            p = self._zero_planes(seq, (self.n,))
        return p, p

    def _empty_result(self, seq) -> Planes:
        """Zero-frame Planes for an idle stream's round -- one cached
        allocation per geometry, not three fresh tensors per idle stream
        per round."""
        key = (seq.coded_width, seq.coded_height)
        if self._empty is None or self._empty[0] != key:
            self._empty = (key, self._zero_planes(seq, (0,)))
        return self._empty[1]

    def _carry_pair(self, i: int):
        """Stream i's (cur, fwd) planes, or None if the stream never
        joined a round (roundrobin) or no round ran yet (joint modes).
        In the joint modes they are views of stream i's rows."""
        if self.mode == 'roundrobin':
            return self._carry[i]
        if self._carry is None:
            return None
        cut = ((lambda x: x.chunk(self.n)[i]) if self.mode == 'stacked'
               else (lambda x: x[i]))
        return tuple(Planes(*[cut(x) for x in p]) for p in self._carry)

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
        """Parse up to batch_frames per stream and decode the round (one
        stream after another, or one joint launch pair).  Returns one
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
        counts = [b['n'] if b else 0 for b in batches]
        if not any(counts):
            # only demoted streams produced frames this round
            result = [self._empty_result(seq)] * self.n
        elif self.mode == 'roundrobin':
            result = [self._decode_stream(i, b, seq) if b
                      else self._empty_result(seq)
                      for i, b in enumerate(batches)]
        else:
            result = self._decode_joint(batches, counts, seq)
        return self._overlay_demoted(result, demoted_frames)

    def _decode_stream(self, i: int, b: dict, seq) -> Planes:
        """roundrobin: stream i's batch through the single-stream path,
        from and into its own carry."""
        pair = self._carry[i]
        if pair is None:
            pair = (self._zero_planes(seq), self._zero_planes(seq))
        la = upload_packed(b, seq.mb_size, self._put)
        cur, fwd, outs = decode_levels(pair[0], pair[1], la, *self._quant)
        self._carry[i] = (cur, fwd)
        return outs.planes

    def _upload_many(self, batches: List[Optional[dict]], n_frames: int,
                     n_mb: int) -> LevelsArrays:
        """vmap: every stream's wire buffer at shared sizes (an idle
        stream's holds no run), ONE [S, L] upload, and ONE unpack of all
        rows into the stacked [n_frames, S*n_mb] layout (unpack_wires: K3
        on the card, which writes each stream's columns in place).
        Frames past a stream's count read its last run's records; their
        segment ignores them."""
        check_lattice(n_frames, len(batches) * n_mb)
        real = [b for b in batches if b]
        n_pairs = max(max(len(b['sp_pos']) for b in real), 1)
        n_esc = max(max(len(b['sp_esc']) for b in real), 1)
        n_runs = max(max(len(b['run_len']) for b in real), 1)
        n_blk = max(max(b['n_blocks'] for b in real), 1)
        mv_wide = not all(mv_fits_narrow(b['run_mv']) for b in real)
        empty = _concat_cell([], 0)
        bufs = self._put(np.stack([
            build_fused_buffer_sized(b or empty, n_frames, n_pairs, n_runs,
                                     n_mb, mv_wide, n_esc)
            for b in batches]))
        return unpack_wires(bufs, n_frames, n_mb, n_runs, mv_wide, n_pairs,
                            n_esc, n_blk)

    def _decode_joint(self, batches: List[Optional[dict]],
                      counts: List[int], seq) -> List[Planes]:
        """stacked / vmap: the round as ONE K1 and ONE K2 launch over the
        S streams stacked along macroblock rows, stream i decoding its
        first counts[i] frames (more launch pairs only past the lattice
        limit: decode_segments)."""
        S, n_mb = self.n, seq.mb_size
        if self._carry is None:
            self._carry = self._zero_carry(seq)
        cur, fwd = self._carry
        if self.mode == 'stacked':
            frames = [split_packed_frames(b) if b else [] for b in batches]

            def levels_of(a, b, n_frames):
                joint, _ = stack_stream_frames(frames[a:b], n_mb, n_frames)
                return upload_packed(joint, (b - a) * n_mb, self._put)
        else:
            def levels_of(a, b, n_frames):
                return self._upload_many(batches[a:b], n_frames, n_mb)
            # a contiguous [S, H, W] carry is the stacked [S*H, W] layout
            cur, fwd = (Planes(*[x.flatten(0, 1) for x in p])
                        for p in (cur, fwd))
        cur, fwd, outs = decode_segments(cur, fwd, counts, n_mb, levels_of,
                                         self._quant)
        if self.mode == 'vmap':
            cur, fwd = (Planes(*[x.view(S, -1, x.shape[-1]) for x in p])
                        for p in (cur, fwd))
        self._carry = (cur, fwd)
        return outs

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


def decode_streams_mesh(streams: Sequence[bytes], mesh, f_code: int = 2,
                        with_seq: bool = False):
    """Serving fleet over a mesh: N same-resolution streams, every one
    opening with an I picture, so their closed GOPs simply concatenate
    into the mesh's gop rows (parallel/packed.MeshPackedDecoder: stream
    boundaries fall on I-picture splits and every GOP starts from zero
    planes).  Returns per-stream frame lists (and the sequence header
    with with_seq), bit-exact against decoding each stream alone.  A
    stream that joins mid-GOP, or MV reach beyond the tile halo, routes
    the whole job to decode_streams_offline on the device of the
    mesh's first gop row instead, as jsmpeg_tpu does."""
    from ..host import best_parser
    from .packed import MeshPackedDecoder

    all_frames: List[dict] = []
    bounds = [0]
    seq0 = None
    p_first = False
    for si, es in enumerate(streams):
        parser = best_parser()
        parser.write(bytes(es))
        if not hasattr(parser, 'parse_batch'):
            raise RuntimeError('mesh stream decode needs the native parser')
        while True:
            b = parser.parse_batch(32, eof=True)
            if b == 'fallback' or (isinstance(b, dict)
                                   and 'sp_pos' not in b):
                raise RuntimeError(
                    f'stream {si} needs the serial-exact path')
            if b is None:
                break
            all_frames.extend(split_packed_frames(b))
            if b['n'] < 32:
                break
        if (len(all_frames) > bounds[-1]
                and all_frames[bounds[-1]]['pic_type'] != 1):
            # a mid-GOP join would motion-compensate against the
            # PREVIOUS stream's last frame once concatenated
            p_first = True
        bounds.append(len(all_frames))
        seq = parser.seq
        if seq is None:
            continue                      # stream produced no frames
        if seq0 is None:
            seq0 = seq
        elif (seq.coded_width, seq.coded_height) != (seq0.coded_width,
                                                     seq0.coded_height):
            raise ValueError('mesh stream decode needs one resolution')
        elif (not np.array_equal(seq.intra_quant_matrix,
                                 seq0.intra_quant_matrix)
              or not np.array_equal(seq.non_intra_quant_matrix,
                                    seq0.non_intra_quant_matrix)):
            raise ValueError('mesh stream decode needs shared quant '
                             'matrices')
    if seq0 is None or not all_frames:
        result = [[] for _ in streams]
        return (result, seq0) if with_seq else result

    dec = MeshPackedDecoder(mesh, seq0, f_code=f_code)
    if p_first or not dec.fits_mesh(all_frames):
        # per-stream carries on one device (re-parses from the bytes: a
        # fallback path)
        result = decode_streams_offline(streams, device=dec.device)
        return (result, seq0) if with_seq else result
    outs, _, _ = dec.decode(all_frames)
    flat = [Planes(*[x[fi] for x in p]) for p in outs
            for fi in range(p.y.shape[0])]
    result = [flat[bounds[i]:bounds[i + 1]] for i in range(len(streams))]
    return (result, seq0) if with_seq else result

"""MPEG1 video decoder: host parse + PyTorch/CUDA decode pipeline.

The reference's Decoder contract (connect/write/decode/seek, jsmpeg's
src/decoder.js) over the same host frontend as jsmpeg_tpu: the threaded
C++ batch parse emits the packed wire v2 (byte for byte jsmpeg_tpu's),
the device unpacks it into dense levels, kernel K1 (csrc/dequant_idct.cu)
dequantizes + inverse-transforms the whole batch in one launch, and
kernel K2 (csrc/mc_combine.cu) runs each frame's motion compensation and
combine with the reference planes carried as a host pointer swap.
Coefficient-dense batches take the dense-levels wire; quirky or
malformed streams finish on the always-exact serial path (premultiplied
coefficients from `parse_frame`, K1 in its IDCT-only mode, then K2).

Every tensor lives on the decoder's `device` ('cuda' by default).  On
the CPU (device='cpu', the tests) the plain PyTorch versions of both
kernels run instead.
"""

from __future__ import annotations

import time
from typing import List, Optional

import numpy as np
import torch

from ..host.mpeg1_parse import FrameData, MPEG1Parser
from ..ops.frame import FrameArrays, LevelsArrays, Planes, decode_frames, \
    frame_meta
from ..ops.idct import dequant_idct


def frame_to_arrays(f: FrameData) -> FrameArrays:
    """Host FrameData -> FrameArrays of numpy arrays (serial path)."""
    return FrameArrays(
        coef=f.coef.astype(np.int32),
        coded=f.coded,
        intra=f.intra,
        written=f.written,
        mv_h=f.mv[:, 0].astype(np.int32),
        mv_v=f.mv[:, 1].astype(np.int32),
    )


def stack_frames(frames: List[FrameArrays]) -> FrameArrays:
    return FrameArrays(*[np.stack([getattr(f, name) for f in frames])
                         for name in FrameArrays._fields])


# ------------------------------------------------------------ wire v2 (host)

def _bitmap_bytes(n_frames: int, n_mb: int) -> int:
    return (n_frames * n_mb + 7) // 8


def mv_fits_narrow(mv: np.ndarray) -> bool:
    """True when every component of an int16 MV array fits int8 (the
    narrow 4-byte run record)."""
    return bool(mv.size == 0 or (mv.min() >= -128 and mv.max() <= 127))


def fused_buffer_len(n_frames: int, n_mb: int, n_pairs: int, n_runs: int,
                     mv_wide: bool, n_esc: int) -> int:
    """Total wire-v2 buffer length for the given sizes (n_esc sizes the
    int16 escape side stream)."""
    return (n_frames + _bitmap_bytes(n_frames, n_mb)
            + (8 if mv_wide else 4) * n_runs
            + 2 * n_pairs + 2 * n_esc)


def build_fused_buffer_sized(batch: dict, n_frames: int, n_pairs: int,
                             n_runs: int, n_mb: int, mv_wide: bool,
                             n_esc: int) -> np.ndarray:
    """Assemble the single-upload wire buffer (wire v2, see unpack_fused)
    from a packed parse_batch dict with caller-fixed sizes."""
    F = n_frames
    n = batch['n']
    total = len(batch['sp_pos'])
    actual_esc = len(batch['sp_esc'])
    bucket = n_pairs
    rt = len(batch['run_len'])
    assert total <= bucket and actual_esc <= n_esc and rt <= n_runs
    B = _bitmap_bytes(F, n_mb)
    w = 8 if mv_wide else 4
    buf = np.zeros(fused_buffer_len(F, n_mb, bucket, n_runs, mv_wide, n_esc),
                   dtype=np.uint8)
    buf[:F] = np.arange(F) < n
    o = F
    # run-start bitmap: bit (i & 7) of byte (i >> 3) marks MB i opening a
    # run.  Real runs are never empty (the RLE invariant; asserted --
    # an empty mid-stream run would desync slot<->record), so start
    # positions are distinct and the device's bit-cumsum numbers runs in
    # record order.
    lens = batch['run_len'].astype(np.int64)
    assert rt == 0 or (lens.min() > 0 and lens.sum() <= F * n_mb)
    starts = np.cumsum(lens) - lens
    bm = np.zeros(B, np.uint8)
    np.bitwise_or.at(bm, starts >> 3, (1 << (starts & 7)).astype(np.uint8))
    buf[o:o + B] = bm
    o += B
    rec = np.zeros((n_runs, w), np.uint8)
    mv = batch['run_mv']
    if mv_wide:
        rec[:rt, 0:4] = mv.astype('<i2').reshape(rt, 2).view(
            np.uint8).reshape(rt, 4)
        rec[:rt, 4] = batch['run_flags']
        rec[:rt, 5] = batch['run_cbp']
    else:
        assert mv_fits_narrow(mv)
        rec[:rt, 0] = batch['run_flags']
        rec[:rt, 1] = batch['run_cbp']
        rec[:rt, 2:4] = mv.astype(np.int8).reshape(rt, 2).view(np.uint8)
    buf[o:o + w * n_runs] = rec.reshape(-1)
    o += w * n_runs
    # padding pairs: bit 6 set (never scattered), bit 7 clear (do not
    # advance the block slot); padding values 0 (not the escape sentinel)
    buf[o:o + bucket] = 0x40
    buf[o:o + total] = batch['sp_pos']
    o += bucket
    buf[o:o + total] = batch['sp_v8'].view(np.uint8)
    o += bucket
    buf[o:o + 2 * actual_esc] = batch['sp_esc'].view(np.uint8)
    return buf


def build_fused_buffer(batch: dict, n_mb: int):
    """The wire buffer of one packed batch at its exact sizes: F = the
    batch's frame count, and pairs, escapes, runs and coded blocks as
    parsed (at least 1 each, so no stream is empty).  Eager PyTorch has
    no compiled shapes to reuse, so nothing is bucketed.  Returns
    (buf uint8, n_blk, n_runs, mv_wide, n_pairs, n_esc)."""
    n_pairs = max(len(batch['sp_pos']), 1)
    n_esc = max(len(batch['sp_esc']), 1)
    n_runs = max(len(batch['run_len']), 1)
    n_blk = max(batch['n_blocks'], 1)
    mv_wide = not mv_fits_narrow(batch['run_mv'])
    buf = build_fused_buffer_sized(batch, batch['n'], n_pairs, n_runs, n_mb,
                                   mv_wide, n_esc)
    return buf, n_blk, n_runs, mv_wide, n_pairs, n_esc


# ---------------------------------------------------------- wire v2 (device)

def unpack_fused(buf: torch.Tensor, n_frames: int, n_mb: int, n_runs: int,
                 mv_wide: bool, n_pairs: int, n_esc: int):
    """Decode the single-upload wire buffer into per-MB streams.

    Layout (wire v2): [valid F][run-start bitmap B=(F*n_mb+7)//8]
    [run records R*w][sp_pos P][sp_v8 i8 P][sp_esc LE i16 E], with
    P = n_pairs and E = n_esc.  The valid bytes are skipped: the port's
    wire never carries padding frames.  One bit per MB marks run
    starts (bitorder little); a cumsum numbers each MB's run.  Run
    records are w=4 bytes [flags, cbp, mv_h i8, mv_v i8], or w=8 bytes
    [mv_h i16, mv_v i16, flags, cbp, 0, 0] when the batch carries wide
    vectors.  Coefficient values ride as int8 with -128 escaping to the
    int16 side stream.

    Returns (flags[F,n_mb] u8, cbp[F,n_mb] u8, mv16[F,n_mb,2] i16,
    sp_pos[P] u8, sp_val[P] i16)."""
    F = n_frames
    R = n_runs
    B = _bitmap_bytes(F, n_mb)
    w = 8 if mv_wide else 4
    P, E = n_pairs, n_esc
    o = F
    bm = buf[o:o + B]
    o += B
    rec = buf[o:o + w * R].reshape(R, w)
    o += w * R
    sp_pos = buf[o:o + P]
    o += P
    sp_v8 = buf[o:o + P].view(torch.int8)
    o += P
    # the escape stream starts at an arbitrary byte offset, and a 2-byte
    # view needs an even storage offset: copy it out first
    sp_esc = buf[o:o + 2 * E].clone().view(torch.int16)
    is_esc = sp_v8 == -128
    eslot = (torch.cumsum(is_esc, 0, dtype=torch.int32) - 1).clamp(0, E - 1)
    sp_val = torch.where(is_esc, sp_esc[eslot.long()], sp_v8.to(torch.int16))

    # expand runs -> per-MB streams: run slot per MB = (number of run
    # starts at or before the MB) - 1.  MBs past the last run (padding
    # frames of a bucketed wire) read the last real run's values; an
    # all-empty cell reads the zero record.
    shifts = torch.arange(8, dtype=torch.uint8, device=buf.device)
    bits = (bm[:, None] >> shifts) & 1
    slot = (torch.cumsum(bits.reshape(-1)[:F * n_mb], 0, dtype=torch.int32)
            - 1).clamp_min(0)
    taken = rec[slot.long()]                    # [F*n_mb, w] record bytes
    if mv_wide:
        mv16 = taken[:, 0:4].contiguous().view(torch.int16)
        flags, cbp = taken[:, 4], taken[:, 5]
    else:
        mv16 = taken[:, 2:4].contiguous().view(torch.int8).to(torch.int16)
        flags, cbp = taken[:, 0], taken[:, 1]
    return (flags.contiguous().reshape(F, n_mb),
            cbp.contiguous().reshape(F, n_mb), mv16.reshape(F, n_mb, 2),
            sp_pos, sp_val)


def packed_to_levels(flags: torch.Tensor, cbp: torch.Tensor,
                     mv16: torch.Tensor, sp_pos: torch.Tensor,
                     sp_val: torch.Tensor, n_blk: int) -> LevelsArrays:
    """Packed wire -> dense LevelsArrays.  Per-MB metadata rides packed
    into bytes and coefficients as (pos, value) pairs whose block is
    carried by flag bits (bit 7 = first pair of a coded block, bit 6 =
    never scattered: empty-coded-block markers and padding).  Coded-block
    ids in row-major (frame, mb, block) order match the host's emission
    order.  Out-of-range ids (padding) are dropped, as JAX's
    mode='drop' scatters drop them: here they land in a dump slot past
    the end, which is cut off."""
    F, n_mb = flags.shape
    dev = flags.device
    qscale = flags & 31
    intra = (flags & 0x20) != 0
    written = (flags & 0x40) != 0
    coded = ((cbp[..., None]
              >> torch.arange(6, dtype=torch.uint8, device=dev)) & 1) != 0
    oob = F * n_mb * 6
    # coded-block ordinal -> flat block id; ordinals >= n_blk go to the
    # dump slot n_blk, ids never named stay oob
    mask = coded.reshape(-1)
    ordinal = torch.cumsum(mask, 0, dtype=torch.int32) - 1
    dst = torch.where(mask, ordinal.clamp_max(n_blk), n_blk).long()
    blk_dense = torch.full((n_blk + 1,), oob, dtype=torch.int32, device=dev)
    blk_dense[dst] = torch.arange(oob, dtype=torch.int32, device=dev)
    blk_dense = blk_dense[:n_blk]
    slot = torch.cumsum(sp_pos >> 7, 0, dtype=torch.int32) - 1
    pair_ok = (sp_pos & 0x40) == 0
    gid = blk_dense[slot.clamp(0, n_blk - 1).long()]
    total = oob * 64
    fidx = torch.where(pair_ok, gid * 64 + (sp_pos & 63).to(torch.int32),
                       total)
    flat = torch.zeros(total + 1, dtype=torch.int16, device=dev)
    flat[fidx.clamp_max(total).long()] = sp_val
    return LevelsArrays(
        levels=flat[:total].reshape(F, n_mb, 6, 64), qscale=qscale,
        coded=coded, intra=intra, written=written,
        mv_h=mv16[..., 0].to(torch.int32), mv_v=mv16[..., 1].to(torch.int32))


def state_from_numpy(cur, fwd, intra_q, non_intra_q, device):
    """Decoder state from numpy arrays -> the port's tensors on `device`:
    cur/fwd are (y, cr, cb) uint8 planes (e.g. jsmpeg_tpu's carry),
    intra_q/non_intra_q int [64] quant matrices.  Returns
    (cur Planes, fwd Planes, intra_q int32, non_intra_q int32)."""
    def planes(p):
        return Planes(*[torch.as_tensor(np.ascontiguousarray(x, np.uint8),
                                        device=device) for x in p])

    def mat(q):
        return torch.as_tensor(np.asarray(q, np.int32), device=device)

    return planes(cur), planes(fwd), mat(intra_q), mat(non_intra_q)


def decode_levels(cur: Planes, fwd: Planes, la: LevelsArrays,
                  intra_q: torch.Tensor, non_intra_q: torch.Tensor):
    """One batch of the levels wire: K1 over all F*n_mb*6 blocks in one
    launch, then the frame loop (one K2 launch per frame).  Returns
    (cur, fwd, [Planes] * F)."""
    F, n_mb = la.qscale.shape
    resid = dequant_idct(la.levels.reshape(F * n_mb, 6, 64),
                         la.qscale.reshape(-1), la.intra.reshape(-1),
                         intra_q, non_intra_q)
    meta = frame_meta(la.coded, la.intra, la.written, la.mv_h, la.mv_v)
    return decode_frames(cur, fwd, resid.reshape(F, n_mb, 6, 64), meta)


def decode_coef(cur: Planes, fwd: Planes, f: FrameArrays):
    """Stacked premultiplied frames (the serial path): K1 in its IDCT-only
    mode over every block, then the frame loop."""
    F, n_mb = f.intra.shape
    resid = dequant_idct(f.coef.reshape(F * n_mb, 6, 64), premultiplied=True)
    meta = frame_meta(f.coded, f.intra, f.written, f.mv_h, f.mv_v)
    return decode_frames(cur, fwd, resid.reshape(F, n_mb, 6, 64), meta)


# ----------------------------------------------------------------- outputs

def _to_host(p: Planes) -> Planes:
    return Planes(*[x.cpu().numpy() for x in p])


class PlanesBatch:
    """The decoded frames of one device batch (Planes of [H, W] device
    tensors per frame)."""

    def __init__(self, frames: List[Planes]):
        self._frames = frames

    def __len__(self) -> int:
        return len(self._frames)

    def frame(self, i: int) -> Planes:
        return self._frames[i]

    def fetch_all(self) -> Planes:
        """All frames as ONE host copy per plane (numpy [n, H, W])."""
        return Planes(*[torch.stack(ps).cpu().numpy()
                        for ps in zip(*self._frames)])


class FrameSeq:
    """List-like concatenation of PlanesBatch chunks + single Planes.

    Frames decoded under retain=False were rendered to the destination and
    their device tensors released; they count toward len() but indexing
    them raises (there is nothing left to return)."""

    def __init__(self):
        self._chunks: list = []
        self._len = 0
        self._released = 0

    def append_batch(self, batch: PlanesBatch) -> None:
        self._chunks.append(batch)
        self._len += len(batch)

    def append(self, planes: Planes) -> None:
        self._chunks.append(planes)
        self._len += 1

    def count_only(self, n: int) -> None:
        """Record frames that were already consumed (rendered + released)
        without retaining their device tensors."""
        self._released += n

    def __len__(self) -> int:
        return self._released + self._len

    def __getitem__(self, i: int):
        total = self._released + self._len
        if not -total <= i < total:
            raise IndexError(i)
        i = i % total
        if i < self._released:
            raise IndexError(
                f'frame {i} was rendered and released (retain=False)')
        i -= self._released
        for c in self._chunks:
            n = len(c) if isinstance(c, PlanesBatch) else 1
            if i < n:
                return c.frame(i) if isinstance(c, PlanesBatch) else c
            i -= n
        raise IndexError(i)

    def __iter__(self):
        for i in range(self._released, self._released + self._len):
            yield self[i]


# ----------------------------------------------------------------- decoder

class MPEG1Decoder:
    """Streaming-capable MPEG1 video decoder (PyTorch/CUDA pipeline).

    write() bytes in, decode() one frame out -- or decode_available() to
    decode every parsed picture in batches (the high-throughput path).

    Options: 'device' (default 'cuda'; construction raises when no GPU is
    present unless a device is given), 'native' (None = best parser,
    True = C++, False = Python), 'onVideoDecode', 'decodeFirstFrame',
    'streaming', 'videoBufferSize'.
    """

    # frames per parse batch (one K1 launch each)
    BATCH_FRAMES = 32

    def __init__(self, options: Optional[dict] = None):
        options = options or {}
        device = options.get('device')
        if device is None:
            device = 'cuda'
            if not torch.cuda.is_available():
                raise RuntimeError(
                    'MPEG1Decoder: no CUDA device is available; pass '
                    "{'device': 'cpu'} to decode on the CPU")
        self.device = torch.device(device)
        if self.device.type == 'cuda' and not torch.cuda.is_available():
            raise RuntimeError(f'MPEG1Decoder: device {device} requested '
                               'but CUDA is not available')
        use_native = options.get('native')
        if use_native is None:
            from ..host import best_parser
            self.parser = best_parser()
        elif use_native:
            from ..host.native import NativeMPEG1Parser
            self.parser = NativeMPEG1Parser()
        else:
            self.parser = MPEG1Parser()
        self.destination = None
        self._cur: Optional[Planes] = None
        self._fwd: Optional[Planes] = None
        self._quant_key = None
        self._quant_dev = None
        self.frame_rate = 30.0
        self.on_decode = options.get('onVideoDecode')
        self.decode_first_frame = options.get('decodeFirstFrame', False)
        self._first_frame_done = False
        self.frames_decoded = 0
        # timestamp collection for static-file A/V sync + seek
        # (semantics of the reference Decoder.Base, src/decoder.js:36-102)
        self.streaming = bool(options.get('streaming'))
        self.buffer_size = options.get('videoBufferSize', 512 * 1024)
        self.collect_timestamps = not self.streaming
        self.bytes_written = 0
        self.timestamps: list = []      # (bit_index, pts)
        self.timestamp_index = 0
        self.start_time = 0.0
        self.decoded_time = 0.0
        self.can_play = False

    # ------------------------------------------------------- decoder API

    def connect(self, destination) -> None:
        self.destination = destination

    def write(self, pts, buffers) -> None:
        if isinstance(buffers, (bytes, bytearray, memoryview, np.ndarray)):
            buffers = [buffers]
        if self.collect_timestamps and pts is not None:
            if not self.timestamps:
                self.start_time = pts
                self.decoded_time = pts
            self.timestamps.append((self.bytes_written << 3, pts))
        for b in buffers:
            data = bytes(b)
            self.bytes_written += len(data)
            self.parser.write(data)
        if self.streaming:
            self._enforce_buffer_cap()
        self.can_play = True
        if self.parser.has_sequence_header and self._cur is None:
            self._init_planes()
            if self.decode_first_frame and not self._first_frame_done:
                # immediate first-frame decode on header detect (preview
                # while paused; reference src/mpeg1.js:29-42)
                self._first_frame_done = True
                self.decode()

    def _enforce_buffer_cap(self) -> None:
        # EVICT-mode memory bound (reference src/buffer.js:30-62): drop
        # consumed bytes; if unread data still exceeds the cap, drop it all
        # (the reference's emergency evac -- streaming prefers staying
        # current over completeness)
        bits = self.parser.bits
        bits.evict_consumed()
        unread = bits.byte_length - (bits.index >> 3)
        if unread > self.buffer_size:
            bits.index = bits.byte_length << 3
            bits.evict_consumed()

    @property
    def current_time(self) -> float:
        return self.decoded_time

    def seek(self, time: float, to_iframe: bool = False) -> None:
        if not self.collect_timestamps:
            return
        self.timestamp_index = 0
        for i, (_, t) in enumerate(self.timestamps):
            if t > time:
                break
            self.timestamp_index = i
        if self.timestamps:
            idx, t = self.timestamps[self.timestamp_index]
            self.parser.bits.index = idx
            self.decoded_time = t
        else:
            self.parser.bits.index = 0
            self.decoded_time = self.start_time
        if to_iframe and hasattr(self.parser, 'seek_iframe'):
            # snap forward to the next I picture: a clean GOP-aligned
            # resume (the reference decodes from the raw byte position and
            # shows artifacts until the next I refresh)
            self.parser.seek_iframe()

    def advance_decoded_time(self, seconds: float) -> None:
        if self.collect_timestamps:
            new_index = -1
            current = self.parser.bits.index
            for i in range(self.timestamp_index, len(self.timestamps)):
                if self.timestamps[i][0] > current:
                    break
                new_index = i
            if new_index != -1 and new_index != self.timestamp_index:
                self.timestamp_index = new_index
                self.decoded_time = self.timestamps[new_index][1]
                return
        self.decoded_time += seconds

    def _init_planes(self) -> None:
        seq = self.parser.seq
        # forbidden/reserved picture-rate codes map to 0.0
        # (tables.PICTURE_RATE, ISO 11172-2 table 2-5): keep the previous
        # (default 30) rate instead of dividing by zero per decoded frame
        # -- the JS reference silently produces Infinity timestamps here
        # (1/0 in JS); a finite fallback is the documented deviation
        if seq.frame_rate > 0:
            self.frame_rate = seq.frame_rate
        cw, ch = seq.coded_width, seq.coded_height

        def z(h, w):
            return torch.zeros((h, w), dtype=torch.uint8, device=self.device)

        self._cur = Planes(z(ch, cw), z(ch >> 1, cw >> 1), z(ch >> 1, cw >> 1))
        self._fwd = Planes(z(ch, cw), z(ch >> 1, cw >> 1), z(ch >> 1, cw >> 1))
        if self.destination is not None:
            if hasattr(self.destination, 'resize'):
                self.destination.resize(seq.width, seq.height)
            if hasattr(self.destination, 'frame_rate'):
                self.destination.frame_rate = self.frame_rate

    @property
    def seq(self):
        return self.parser.seq

    def decode(self, eof: bool = False):
        """Decode one picture; returns Planes (device tensors, or host
        numpy arrays when a destination is connected) or None."""
        t0 = time.monotonic()
        out = None
        if hasattr(self.parser, 'parse_batch'):
            batch = self.parser.parse_batch(1, eof=eof)
            if batch is None:
                return None
            if isinstance(batch, dict):
                out = self._decode_batch(batch)[0]
        if out is None:
            fd = self.parser.parse_frame(eof=eof)
            if fd is None:
                return None
            out = self._decode_serial([frame_to_arrays(fd)])[0]
        self.advance_decoded_time(1.0 / self.frame_rate)
        self.frames_decoded += 1
        if self.streaming:
            self.parser.bits.evict_consumed()
        if self.destination is not None:
            out = _to_host(out)
            self.destination.render(out.y, out.cr, out.cb)
        if self.on_decode is not None:
            self.on_decode(self, time.monotonic() - t0)
        return out

    def decode_available(self, eof: bool = False, retain: bool = True):
        """Parse every complete picture buffered and decode them in
        batches of up to BATCH_FRAMES.  Returns a FrameSeq of Planes
        (device tensors), or None when nothing was decoded.

        retain=False (requires a connected destination) renders each
        batch as soon as it completes and releases its tensors -- bounded
        device memory for arbitrarily long files; the returned FrameSeq
        then only carries the frame count."""
        if not retain and self.destination is None:
            raise ValueError('retain=False requires a connected destination '
                             '(frames are rendered and released per batch)')
        release = not retain
        outs = FrameSeq()
        needs_serial = (self._decode_available_batch(eof, outs, release)
                        if hasattr(self.parser, 'parse_batch') else True)
        if needs_serial:
            # quirk leak or malformed data (or the Python parser): finish
            # with the always-exact serial coefficient path
            for p in self._decode_available_serial(eof):
                if release:
                    self._render(p)
                    outs.count_only(1)
                else:
                    outs.append(p)
        if not len(outs):
            return None
        if self.destination is not None and not release:
            for p in outs:
                self._render(p)
        return outs

    def _render(self, p: Planes) -> None:
        p = _to_host(p)
        self.destination.render(p.y, p.cr, p.cb)

    def _quant_matrices(self):
        """Quant matrices as device tensors (cached per sequence)."""
        seq = self.parser.seq
        key = (seq.intra_quant_matrix.tobytes(),
               seq.non_intra_quant_matrix.tobytes())
        if self._quant_key != key:
            self._quant_key = key
            self._quant_dev = tuple(
                torch.as_tensor(np.asarray(q, np.int32), device=self.device)
                for q in (seq.intra_quant_matrix,
                          seq.non_intra_quant_matrix))
        return self._quant_dev

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        """Host array -> device tensor (pinned, asynchronous on CUDA, so
        the copy does not wait for the kernels already queued)."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type == 'cuda':
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _upload_packed(self, batch: dict) -> LevelsArrays:
        """One packed batch: ONE wire buffer upload, then the device
        unpack into dense levels."""
        n_mb = self.parser.seq.mb_size
        buf, n_blk, n_runs, mv_wide, n_pairs, n_esc = build_fused_buffer(
            batch, n_mb)
        flags, cbp, mv16, sp_pos, sp_val = unpack_fused(
            self._upload(buf), batch['n'], n_mb, n_runs, mv_wide, n_pairs,
            n_esc)
        return packed_to_levels(flags, cbp, mv16, sp_pos, sp_val, n_blk)

    def _upload_dense(self, batch: dict) -> LevelsArrays:
        """The dense-levels fallback wire (coefficient-dense batches):
        the parser's full slabs, cut to the batch's real frames."""
        n = batch['n']
        up = lambda a: self._upload(a[:n])
        return LevelsArrays(
            levels=up(batch['levels']), qscale=up(batch['qscale']),
            coded=up(batch['coded']).bool(), intra=up(batch['intra']).bool(),
            written=up(batch['written']).bool(),
            mv_h=up(batch['mv'][..., 0]), mv_v=up(batch['mv'][..., 1]))

    def _decode_batch(self, batch: dict) -> List[Planes]:
        """Upload one parsed batch (packed or dense wire) and decode it;
        the kernels run asynchronously.  Returns the frames' Planes."""
        la = (self._upload_packed(batch) if 'sp_pos' in batch
              else self._upload_dense(batch))
        iq, nq = self._quant_matrices()
        self._cur, self._fwd, outs = decode_levels(self._cur, self._fwd, la,
                                                   iq, nq)
        return outs

    def _decode_serial(self, frames: List[FrameArrays]) -> List[Planes]:
        st = stack_frames(frames)
        f = FrameArrays(*[self._upload(x) for x in st])
        self._cur, self._fwd, outs = decode_coef(self._cur, self._fwd, f)
        return outs

    def _decode_available_batch(self, eof: bool, outs_all: FrameSeq,
                                release: bool = False) -> bool:
        """Threaded C++ parse + packed-wire device pipeline.  The parse of
        batch k+1 (C++, GIL released) overlaps the device work of batch
        k, which is only waited for when batch k renders.  Returns
        needs_serial_fallback."""
        batch = self.parser.parse_batch(self.BATCH_FRAMES, eof=eof)
        while True:
            if batch == 'fallback':
                return True
            if batch is None:
                return False
            n = batch['n']
            pb = PlanesBatch(self._decode_batch(batch))
            batch = (self.parser.parse_batch(self.BATCH_FRAMES, eof=eof)
                     if n == self.BATCH_FRAMES else None)
            self.frames_decoded += n
            for _ in range(n):
                self.advance_decoded_time(1.0 / self.frame_rate)
            if release:
                ys, crs, cbs = pb.fetch_all()    # one copy per plane
                for i in range(n):
                    self.destination.render(ys[i], crs[i], cbs[i])
                outs_all.count_only(n)
            else:
                outs_all.append_batch(pb)

    def _decode_available_serial(self, eof: bool = False) -> List[Planes]:
        frames = []
        while True:
            fd = self.parser.parse_frame(eof=eof)
            if fd is None:
                break
            frames.append(frame_to_arrays(fd))
            self.frames_decoded += 1
            self.advance_decoded_time(1.0 / self.frame_rate)
        return self._decode_serial(frames) if frames else []

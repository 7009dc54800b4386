"""ctypes binding for the C++ host frontend (drop-in MPEG1Parser)."""

from __future__ import annotations

import ctypes
import os
import time
from typing import Optional

import numpy as np

from ... import tables as T
from ..mpeg1_parse import FrameData, SequenceInfo

_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    from .build_native import ensure_built
    path = ensure_built()
    lib = ctypes.CDLL(path)
    lib.mpeg1_parser_create.restype = ctypes.c_void_p
    lib.mpeg1_parser_destroy.argtypes = [ctypes.c_void_p]
    lib.mpeg1_parser_write.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                       ctypes.c_int64]
    lib.mpeg1_parser_has_seq.argtypes = [ctypes.c_void_p]
    lib.mpeg1_parser_seq_info.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.mpeg1_parser_quant.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                       ctypes.c_void_p]
    lib.mpeg1_parser_parse_frame.argtypes = [
        ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 6
    lib.mpeg1_parser_parse_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 7
    lib.mpeg1_parser_parse_batch_sparse.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int] + \
        [ctypes.c_void_p] * 8 + [ctypes.c_int64, ctypes.c_void_p]
    lib.mpeg1_parser_parse_batch_packed.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int] + \
        [ctypes.c_void_p] * 9 + [ctypes.c_int64] + [ctypes.c_void_p] * 2
    lib.mpeg1_parser_set_threads.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.mpeg1_parser_seek_iframe.argtypes = [ctypes.c_void_p]
    lib.mp2_decoder_create.restype = ctypes.c_void_p
    lib.mp2_decoder_destroy.argtypes = [ctypes.c_void_p]
    lib.mp2_decoder_write.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                      ctypes.c_int64]
    lib.mp2_decoder_parse_frame.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.mp2_decoder_decode.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 2
    lib.mp2_decoder_synthesize.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 2
    lib.mp2_decoder_sample_rate.argtypes = [ctypes.c_void_p]
    lib.mp2_decoder_bit_index.argtypes = [ctypes.c_void_p]
    lib.mp2_decoder_bit_index.restype = ctypes.c_int64
    lib.mp2_decoder_set_bit_index.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.mp2_decoder_evict.argtypes = [ctypes.c_void_p]
    lib.mp2_decoder_evict.restype = ctypes.c_int64
    lib.mp2_decoder_byte_length.argtypes = [ctypes.c_void_p]
    lib.mp2_decoder_byte_length.restype = ctypes.c_int64
    lib.mp2_decoder_get_state.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                          ctypes.c_void_p]
    lib.mp2_decoder_set_state.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                          ctypes.c_int32]
    lib.mpeg1_parser_bit_index.argtypes = [ctypes.c_void_p]
    lib.mpeg1_parser_bit_index.restype = ctypes.c_int64
    lib.mpeg1_parser_set_bit_index.argtypes = [ctypes.c_void_p,
                                               ctypes.c_int64]
    lib.mpeg1_parser_evict.argtypes = [ctypes.c_void_p]
    lib.mpeg1_parser_evict.restype = ctypes.c_int64
    lib.mpeg1_parser_byte_length.argtypes = [ctypes.c_void_p]
    lib.mpeg1_parser_byte_length.restype = ctypes.c_int64
    lib.ts_demux_create.restype = ctypes.c_void_p
    lib.ts_demux_create.argtypes = [ctypes.c_int]
    lib.ts_demux_destroy.argtypes = [ctypes.c_void_p]
    lib.ts_demux_connect.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.ts_demux_write.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                   ctypes.c_longlong, ctypes.c_void_p,
                                   ctypes.c_longlong]
    lib.ts_demux_write.restype = ctypes.c_longlong
    lib.ts_demux_flush.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_longlong]
    lib.ts_demux_flush.restype = ctypes.c_longlong
    lib.ts_demux_current_time.argtypes = [ctypes.c_void_p]
    lib.ts_demux_current_time.restype = ctypes.c_double
    lib.ts_demux_start_time.argtypes = [ctypes.c_void_p]
    lib.ts_demux_start_time.restype = ctypes.c_double
    lib.ts_demux_packets.argtypes = [ctypes.c_void_p]
    lib.ts_demux_packets.restype = ctypes.c_longlong
    lib.ts_demux_resyncs.argtypes = [ctypes.c_void_p]
    lib.ts_demux_resyncs.restype = ctypes.c_longlong
    lib.ts_demux_pending.argtypes = [ctypes.c_void_p]
    lib.ts_demux_pending.restype = ctypes.c_longlong
    lib.host_canary_cpu.argtypes = [ctypes.c_int64]
    lib.host_canary_cpu.restype = ctypes.c_uint64
    lib.host_canary_mem.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_int64, ctypes.c_int]
    _lib = lib
    return lib


def native_available() -> bool:
    try:
        _load()
        return True
    except Exception:
        return False


def host_canary(cpu_iters: int = 100_000_000, mem_mb: int = 192,
                mem_reps: int = 3, runs: int = 3) -> dict:
    """Fixed-work host-speed probes, the median of `runs` each:
    single-core scalar integer throughput (a serial xorshift64 chain,
    millions of xorshift steps a second) and memory bandwidth (a
    cache-spilling memcpy, GB moved a second).  Compiled with the parse
    stage's toolchain and flags, so a slower parse beside an unchanged
    canary is the code's, and both slower together is the host's."""
    lib = _load()

    def med(xs):
        return sorted(xs)[len(xs) // 2]

    cpu_ts = []
    for _ in range(runs):
        t0 = time.monotonic()
        lib.host_canary_cpu(cpu_iters)
        cpu_ts.append(time.monotonic() - t0)
    # 3 xorshift steps per iteration
    int_mops = cpu_iters * 3 / med(cpu_ts) / 1e6

    n = mem_mb * (1 << 20)
    src = np.ones(n, dtype=np.uint8)
    dst = np.zeros(n, dtype=np.uint8)   # pre-faulted: page-in cost stays
                                        # out of the timed region
    mem_ts = []
    for _ in range(runs):
        t0 = time.monotonic()
        lib.host_canary_mem(_ptr(dst), _ptr(src), n, mem_reps)
        mem_ts.append(time.monotonic() - t0)
    # each rep copies the buffer both ways: 2*n bytes written + 2*n read
    mem_gb_s = 4.0 * n * mem_reps / med(mem_ts) / 1e9
    return {'int_mops': round(int_mops, 1), 'mem_gb_s': round(mem_gb_s, 2)}


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


class NativeMPEG1Parser:
    """Same contract as host.mpeg1_parse.MPEG1Parser, C++ inside."""

    def __init__(self):
        self._lib = _load()
        self._p = ctypes.c_void_p(self._lib.mpeg1_parser_create())
        self.seq: Optional[SequenceInfo] = None
        self.quirk_leaks = 0
        self.frames_parsed = 0

    def __del__(self):
        if getattr(self, '_p', None):
            self._lib.mpeg1_parser_destroy(self._p)
            self._p = None

    def write(self, data) -> None:
        b = bytes(data)
        self._lib.mpeg1_parser_write(self._p, b, len(b))
        if self.seq is None and self._lib.mpeg1_parser_has_seq(self._p):
            self._read_seq()

    def _read_seq(self) -> None:
        info = np.zeros(5, dtype=np.int32)
        self._lib.mpeg1_parser_seq_info(self._p, _ptr(info))
        intra_q = np.zeros(64, dtype=np.int32)
        non_intra_q = np.zeros(64, dtype=np.int32)
        self._lib.mpeg1_parser_quant(self._p, _ptr(intra_q), _ptr(non_intra_q))
        self.seq = SequenceInfo(
            width=int(info[0]), height=int(info[1]),
            mb_width=int(info[2]), mb_height=int(info[3]),
            frame_rate=T.PICTURE_RATE[int(info[4])],
            intra_quant_matrix=intra_q, non_intra_quant_matrix=non_intra_q)

    @property
    def has_sequence_header(self) -> bool:
        return self.seq is not None

    @property
    def bits(self):
        return _BitsProxy(self)

    def set_threads(self, n: int) -> None:
        self._lib.mpeg1_parser_set_threads(self._p, int(n))

    def seek_iframe(self) -> bool:
        """Advance to the next I-picture (GOP-aligned clean resume)."""
        return bool(self._lib.mpeg1_parser_seek_iframe(self._p))

    # average coefficients per block the sparse path reserves for;
    # overflow falls back to the dense batch automatically
    SPARSE_CAP_PER_BLOCK = 16

    def parse_batch(self, max_frames: int, eof: bool = False,
                    sparse: bool = True, packed: bool = True):
        """Threaded batch parse (raw-levels contract).

        Returns a dict of stacked arrays for up to max_frames pictures, or
        None when nothing was parsed, or the string 'fallback' when the
        batch cannot guarantee exactness (escape-zero level / scratch
        invariant / malformed stream) and the caller must use parse_frame().

        Wire formats, by upload cost per coefficient / per MB:
          packed=True (default): run-length-encoded per-MB metadata
            ('run_len'/'run_flags'/'run_cbp'/'run_mv', 8 B/run -- runs of
            identical (flags, cbp, mv) tuples, never crossing a picture) +
            'sp_pos'/'sp_val' pairs (3 B/coefficient, slot flags in the top
            bits of sp_pos -- the device rebuilds global indices from cbp);
          sparse=True: 'sp_idx'/'sp_val' global (index, value) pairs
            (6 B/coefficient) + dense u8/int32 metadata;
          else: dense int16 'levels' slab [F, n_mb, 6, 64].
        Coefficient-dense batches overflow the packed/sparse caps and fall
        back to the dense slab automatically.
        """
        if self.seq is None:
            return None
        n_mb = self.seq.mb_size
        F = max_frames
        if packed:
            saved_index = self._lib.mpeg1_parser_bit_index(self._p)
            cap = n_mb * 6 * self.SPARSE_CAP_PER_BLOCK
            run_len = np.empty(F * n_mb, dtype=np.uint16)
            run_flags = np.empty(F * n_mb, dtype=np.uint8)
            run_cbp = np.empty(F * n_mb, dtype=np.uint8)
            run_mv = np.empty((F * n_mb, 2), dtype=np.int16)
            run_counts = np.zeros(F + 1, dtype=np.int64)
            pic_types = np.zeros(F, dtype=np.uint8)
            sp_pos = np.empty(F * cap, dtype=np.uint8)
            sp_v8 = np.empty(F * cap, dtype=np.int8)
            sp_esc = np.empty(F * (cap // 8), dtype=np.int16)
            sp_counts = np.zeros(F + 2, dtype=np.int64)
            esc_counts = np.zeros(F + 1, dtype=np.int64)
            r = self._lib.mpeg1_parser_parse_batch_packed(
                self._p, 1 if eof else 0, F, _ptr(run_len), _ptr(run_flags),
                _ptr(run_cbp), _ptr(run_mv), _ptr(run_counts),
                _ptr(pic_types), _ptr(sp_pos), _ptr(sp_v8), _ptr(sp_esc),
                cap, _ptr(sp_counts), _ptr(esc_counts))
            if r == -3:
                self._lib.mpeg1_parser_set_bit_index(self._p, saved_index)
                return self.parse_batch(max_frames, eof, sparse=False,
                                        packed=False)
            if r < 0:
                return 'fallback'
            if r == 0:
                return None
            self.frames_parsed += r
            total = int(sp_counts[F])
            rt = int(run_counts[F])
            et = int(esc_counts[F])
            return dict(n=r, run_len=run_len[:rt], run_flags=run_flags[:rt],
                        run_cbp=run_cbp[:rt], run_mv=run_mv[:rt],
                        sp_pos=sp_pos[:total], sp_v8=sp_v8[:total],
                        sp_esc=sp_esc[:et],
                        n_blocks=int(sp_counts[F + 1]),
                        pairs_pf=sp_counts[:r].copy(),
                        runs_pf=run_counts[:r].copy(),
                        escs_pf=esc_counts[:r].copy(),
                        pic_types=pic_types)
        qscale = np.zeros((F, n_mb), dtype=np.uint8)
        coded = np.zeros((F, n_mb, 6), dtype=np.uint8)
        intra = np.zeros((F, n_mb), dtype=np.uint8)
        written = np.zeros((F, n_mb), dtype=np.uint8)
        mv = np.zeros((F, n_mb, 2), dtype=np.int32)
        pic_types = np.zeros(F, dtype=np.uint8)

        if sparse:
            saved_index = self._lib.mpeg1_parser_bit_index(self._p)
            cap = n_mb * 6 * self.SPARSE_CAP_PER_BLOCK
            sp_idx = np.empty(F * cap, dtype=np.int32)
            sp_val = np.empty(F * cap, dtype=np.int16)
            sp_counts = np.zeros(F + 1, dtype=np.int64)
            r = self._lib.mpeg1_parser_parse_batch_sparse(
                self._p, 1 if eof else 0, F, _ptr(qscale), _ptr(coded),
                _ptr(intra), _ptr(written), _ptr(mv), _ptr(pic_types),
                _ptr(sp_idx), _ptr(sp_val), cap, _ptr(sp_counts))
            if r == -3:
                # coefficient-dense stream: retry with the dense slab
                self._lib.mpeg1_parser_set_bit_index(self._p, saved_index)
                return self.parse_batch(max_frames, eof, sparse=False)
            if r < 0:
                return 'fallback'
            if r == 0:
                return None
            self.frames_parsed += r
            total = int(sp_counts[F])
            return dict(n=r, sp_idx=sp_idx[:total], sp_val=sp_val[:total],
                        qscale=qscale, coded=coded, intra=intra,
                        written=written, mv=mv, pic_types=pic_types)

        levels = np.zeros((F, n_mb, 6, 64), dtype=np.int16)
        r = self._lib.mpeg1_parser_parse_batch(
            self._p, 1 if eof else 0, F, _ptr(levels), _ptr(qscale),
            _ptr(coded), _ptr(intra), _ptr(written), _ptr(mv),
            _ptr(pic_types))
        if r < 0:
            return 'fallback'
        if r == 0:
            return None
        self.frames_parsed += r
        # full slabs (padding frames already zero); n marks the valid count
        return dict(n=r, levels=levels, qscale=qscale, coded=coded,
                    intra=intra, written=written, mv=mv,
                    pic_types=pic_types)

    def parse_frame(self, eof: bool = False) -> Optional[FrameData]:
        if self.seq is None:
            return None
        n_mb = self.seq.mb_size
        coef = np.empty((n_mb, 6, 64), dtype=np.int32)
        coded = np.empty((n_mb, 6), dtype=np.uint8)
        intra = np.empty(n_mb, dtype=np.uint8)
        written = np.empty(n_mb, dtype=np.uint8)
        mv = np.empty((n_mb, 2), dtype=np.int32)
        info = np.zeros(3, dtype=np.int64)
        r = self._lib.mpeg1_parser_parse_frame(
            self._p, 1 if eof else 0, _ptr(coef), _ptr(coded), _ptr(intra),
            _ptr(written), _ptr(mv), _ptr(info))
        self.quirk_leaks = int(info[1])
        if not r:
            return None
        self.frames_parsed += 1
        return FrameData(int(info[0]), coef, coded.astype(bool),
                         intra.astype(bool), written.astype(bool), mv)


class _BitsProxy:
    """Exposes the bit-index/evict surface the decoder layer uses, bound
    to one native object's C-function prefix."""

    PREFIX = 'mpeg1_parser'

    def __init__(self, parser):
        self._parser = parser

    def _fn(self, name):
        return getattr(self._parser._lib, self.PREFIX + '_' + name)

    @property
    def index(self) -> int:
        return self._fn('bit_index')(self._parser._p)

    @index.setter
    def index(self, v: int) -> None:
        self._fn('set_bit_index')(self._parser._p, v)

    def evict_consumed(self) -> int:
        return self._fn('evict')(self._parser._p)

    @property
    def byte_length(self) -> int:
        return self._fn('byte_length')(self._parser._p)


class NativeMP2Parser:
    """Same contract as host.mp2_parse.MP2Parser (parse_frame -> MP2Frame),
    C++ inside -- plus decode_pcm() running the bit-exact synthesis in C++
    (the fast host path: parse + dct32 + windowed int32 accumulate without
    crossing the ctypes boundary per sub-block)."""

    def __init__(self):
        self._lib = _load()
        self._p = ctypes.c_void_p(self._lib.mp2_decoder_create())
        self.sample_rate = 44100

    def __del__(self):
        if getattr(self, '_p', None):
            self._lib.mp2_decoder_destroy(self._p)
            self._p = None

    def write(self, data) -> None:
        b = bytes(data)
        self._lib.mp2_decoder_write(self._p, b, len(b))

    def parse_frame(self):
        from ..mp2_parse import MP2Frame
        samples = np.empty((36, 2, 32), dtype=np.int32)
        r = self._lib.mp2_decoder_parse_frame(self._p, _ptr(samples))
        if not r:
            return None
        self.sample_rate = self._lib.mp2_decoder_sample_rate(self._p)
        return MP2Frame(samples, self.sample_rate, int(r))

    def decode_pcm(self):
        """Parse + synthesize one frame fully in C++ (bit-exact).
        Returns (left, right) float32[1152] or None."""
        left = np.empty(1152, dtype=np.float32)
        right = np.empty(1152, dtype=np.float32)
        r = self._lib.mp2_decoder_decode(self._p, _ptr(left), _ptr(right))
        if not r:
            return None
        self.sample_rate = self._lib.mp2_decoder_sample_rate(self._p)
        return left, right

    def synthesize(self, samples: np.ndarray):
        """Bit-exact synthesis of [n, 2, 32] int32 samples using the
        decoder's carried V-ring state."""
        samples = np.ascontiguousarray(samples, dtype=np.int32)
        n = samples.shape[0]
        left = np.empty(n * 32, dtype=np.float32)
        right = np.empty(n * 32, dtype=np.float32)
        self._lib.mp2_decoder_synthesize(self._p, _ptr(samples), n,
                                         _ptr(left), _ptr(right))
        return left, right

    def get_state(self):
        v = np.empty((2, 1024), dtype=np.float32)
        pos = np.zeros(1, dtype=np.int32)
        self._lib.mp2_decoder_get_state(self._p, _ptr(v), _ptr(pos))
        return v, int(pos[0])

    def set_state(self, v: np.ndarray, v_pos: int) -> None:
        v = np.ascontiguousarray(v, dtype=np.float32)
        self._lib.mp2_decoder_set_state(self._p, _ptr(v), int(v_pos))

    @property
    def bits(self):
        return _MP2BitsProxy(self)


class _MP2BitsProxy(_BitsProxy):
    PREFIX = 'mp2_decoder'


class NativeTSDemux:
    """C++ TS packet parse + PES reassembly (ts_demux.cpp).  write()
    returns completed PES packets as [(stream_id, pts, payload bytes)]."""

    def __init__(self, guess_video_frame_end: bool = True):
        self._lib = _load()
        self._h = self._lib.ts_demux_create(1 if guess_video_frame_end
                                            else 0)

    def __del__(self):
        if getattr(self, '_h', None):
            self._lib.ts_demux_destroy(self._h)
            self._h = None

    def connect(self, stream_id: int) -> None:
        self._lib.ts_demux_connect(self._h, stream_id)

    def _events(self, out: np.ndarray, n: int):
        evs = []
        off = 0
        buf = out[:n]
        while off + 16 <= n:
            stream_id, length = np.frombuffer(buf, np.uint32, 2, off)
            pts = float(np.frombuffer(buf, np.float64, 1, off + 8)[0])
            payload = buf[off + 16:off + 16 + int(length)].tobytes()
            evs.append((int(stream_id), pts, payload))
            off += 16 + int(length)
        return evs

    def _cap(self, data_len: int) -> int:
        # every emitted payload byte comes from pending PES payloads,
        # the carried leftover, or this write's bytes; each packet can
        # complete at most two PES packets (the previous at
        # payload_start plus the current)
        pending = int(self._lib.ts_demux_pending(self._h))
        return pending + data_len + 16 * (2 * (data_len + pending) // 188
                                          + 32) + 4096

    def write(self, chunk: bytes):
        data = bytes(chunk)
        cap = self._cap(len(data))
        out = np.empty(cap, np.uint8)
        n = self._lib.ts_demux_write(self._h, data, len(data),
                                     out.ctypes.data_as(ctypes.c_void_p),
                                     cap)
        assert n >= 0, 'ts_demux output buffer overflow'
        return self._events(out, int(n))

    def flush(self):
        cap = self._cap(0)
        out = np.empty(cap, np.uint8)
        n = self._lib.ts_demux_flush(
            self._h, out.ctypes.data_as(ctypes.c_void_p), cap)
        assert n >= 0, 'ts_demux flush buffer overflow'
        return self._events(out, int(n))

    @property
    def current_time(self) -> float:
        return self._lib.ts_demux_current_time(self._h)

    @property
    def start_time(self) -> float:
        return self._lib.ts_demux_start_time(self._h)

    @property
    def packets_parsed(self) -> int:
        return self._lib.ts_demux_packets(self._h)

    @property
    def resyncs(self) -> int:
        return self._lib.ts_demux_resyncs(self._h)

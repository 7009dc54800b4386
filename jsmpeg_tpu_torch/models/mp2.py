"""MP2 audio decoder: host parse + synthesis (exact host path or device
path).

Decoder contract mirrors the reference (connect/write/decode,
jsmpeg/src/jsmpeg.js:43-54); destination receives
play(sample_rate, left, right) with host float32 arrays.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..config import resolve_device
from ..host.mp2_parse import MP2Parser
from ..metrics import span
from ..ops import mp2_synth

MODES = ('exact', 'device')


class MP2Decoder:
    """mode='exact': bit-exact host synthesis (C++ with the native parser,
    else numpy's float64 DAG).  It stays on the host by nature.
    mode='device': float32 synthesis batched on the decoder's device
    (options['device'], default 'cuda'; construction raises without a GPU
    unless a device is given); the V-chunk history and the ring position
    stay there between calls.  It is jsmpeg_tpu's mode='tpu'.

    Options: 'device', 'native' (None = best parser, True = C++,
    False = Python), 'onAudioDecode', 'streaming', 'audioBufferSize'."""

    def __init__(self, options: Optional[dict] = None, mode: str = 'exact'):
        options = options or {}
        if mode not in MODES:
            raise ValueError(f'MP2Decoder: mode must be one of {MODES}, '
                             f'not {mode!r}')
        self.mode = mode
        self.device = (resolve_device(options.get('device'), 'MP2Decoder')
                       if mode == 'device' else None)
        use_native = options.get('native')
        if use_native is None:
            from ..host import best_mp2_parser
            self.parser = best_mp2_parser()
        elif use_native:
            from ..host.native import NativeMP2Parser
            self.parser = NativeMP2Parser()
        else:
            self.parser = MP2Parser()
        self.destination = None
        self.sample_rate = 44100
        self._state = mp2_synth.initial_state()
        self._v_chunks = (torch.zeros((15, 2, 64), dtype=torch.float32,
                                      device=self.device)
                          if self.device is not None else None)
        self._v_pos = 0
        self.on_decode = options.get('onAudioDecode')
        self.streaming = bool(options.get('streaming'))
        self.buffer_size = options.get('audioBufferSize', 128 * 1024)
        self.collect_timestamps = not self.streaming
        self.bytes_written = 0
        self.timestamps: list = []
        self.timestamp_index = 0
        self.start_time = 0.0
        self.decoded_time = 0.0
        self.can_play = False

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
            bits = self.parser.bits
            bits.evict_consumed()
            if bits.byte_length - (bits.index >> 3) > self.buffer_size:
                bits.index = bits.byte_length << 3
                bits.evict_consumed()
        self.can_play = True

    @property
    def current_time(self) -> float:
        enq = 0.0
        if self.destination is not None:
            enq = getattr(self.destination, 'enqueued_time', 0.0)
        return self.decoded_time - enq

    def seek(self, time: float) -> None:
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

    def decode(self):
        """Decode one frame -> (left, right) float32[1152] or None."""
        t0 = time.monotonic()
        if self.mode == 'exact' and hasattr(self.parser, 'decode_pcm'):
            # single native call: parse + bit-exact synthesis in C++
            out = self.parser.decode_pcm()
            if out is None:
                return None
            self.sample_rate = self.parser.sample_rate
            left, right = out
        else:
            frame = self.parser.parse_frame()
            if frame is None:
                return None
            self.sample_rate = frame.sample_rate
            pcm = self._synthesize(frame.samples)
            left, right = pcm[0], pcm[1]
        self.advance_decoded_time(1152.0 / self.sample_rate)
        if self.streaming:
            self.parser.bits.evict_consumed()
        if self.destination is not None:
            self.destination.play(self.sample_rate, left, right)
        if self.on_decode is not None:
            self.on_decode(self, time.monotonic() - t0)
        return left, right

    def decode_available(self):
        """Parse and synthesize every buffered frame in one batch ->
        float32 [n_frames, 2, 1152] (host), or None.  Its three phases
        are the spans 'mp2.parse', 'mp2.synth' and 'mp2.play'."""
        frames = []
        with span('mp2.parse'):
            while True:
                f = self.parser.parse_frame()
                if f is None:
                    break
                frames.append(f)
                self.advance_decoded_time(1152.0 / f.sample_rate)
        if not frames:
            return None
        self.sample_rate = frames[-1].sample_rate
        with span('mp2.synth'):
            samples = np.concatenate([f.samples for f in frames])
            pcm = self._synthesize(samples)
        if self.destination is not None:
            n = 1152
            with span('mp2.play'):
                for i in range(len(frames)):
                    self.destination.play(self.sample_rate,
                                          pcm[0, i * n:(i + 1) * n],
                                          pcm[1, i * n:(i + 1) * n])
        return pcm.reshape(2, len(frames), 1152).transpose(1, 0, 2)

    def _synthesize(self, samples: np.ndarray) -> np.ndarray:
        """int32 [T, 2, 32] subband samples -> float32 [2, T*32] (host)."""
        if self.mode == 'exact':
            if hasattr(self.parser, 'synthesize'):
                # C++ path: bit-exact synthesis with the V ring carried in
                # the native decoder
                left, right = self.parser.synthesize(samples)
                return np.stack([left, right])
            pcm, self._state = mp2_synth.synthesize_exact(samples, self._state)
            return pcm
        pcm, self._v_chunks = mp2_synth.synthesize_device(
            torch.as_tensor(samples, device=self.device), self._v_chunks,
            self._v_pos)
        self._v_pos = (self._v_pos - 64 * samples.shape[0]) % 1024
        return pcm.cpu().numpy()

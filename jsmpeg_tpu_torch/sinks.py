"""Output sinks (the Renderer / AudioOutput equivalents).

Renderer contract (cf. jsmpeg/src/jsmpeg.js:56-62):
  render(y, cr, cb) with coded-size planes, resize(width, height), enabled.
AudioOutput contract (:64-71):
  play(sample_rate, left, right), stop(), enqueued_time, enabled.

Off-browser, the "displays" are files and buffers: Y4M (raw YCbCr 4:2:0),
PPM/PNG via the colour conversion (ops/color.py) on a given device,
WAV/raw PCM, plus collectors and stat-only null sinks for benchmarking.
Sinks take numpy arrays or tensors (on any device).
"""

from __future__ import annotations

import struct
import time
import wave
from typing import List, Optional

import numpy as np

import torch


def host_array(x) -> np.ndarray:
    """A plane or PCM buffer as a host numpy array (tensors are copied
    from their device, numpy arrays pass through)."""
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def rgb_image(y, cr, cb, width: int, height: int, device,
              exact: bool = True) -> np.ndarray:
    """Coded-size planes -> uint8 [height, width, 3] on the host, the
    colour conversion run on `device`."""
    from .ops.color import ycbcr_to_rgb_int, ycbcr_to_rgb_rec601
    fn = ycbcr_to_rgb_int if exact else ycbcr_to_rgb_rec601
    y, cr, cb = (torch.as_tensor(p, device=device) for p in (y, cr, cb))
    return fn(y, cr, cb, width, height).cpu().numpy()


def write_image(path: str, rgb: np.ndarray) -> None:
    """Write an RGB uint8 image ([H, W, 3]) as PNG or PPM by extension
    (SURVEY build plan 7.5 'PNG/y4m dump' sinks).  The PNG encoder is
    stdlib-only (zlib deflate, filter 0) -- this image has no imaging
    libraries."""
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    h, w = rgb.shape[:2]
    if not path.lower().endswith('.png'):
        with open(path, 'wb') as f:
            f.write(b'P6\n%d %d\n255\n' % (w, h))
            f.write(rgb.tobytes())
        return
    import zlib

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack('>I', len(data)) + tag + data
                + struct.pack('>I', zlib.crc32(tag + data) & 0xffffffff))

    # one filter byte (0 = None) per scanline
    raw = np.zeros((h, 1 + w * 3), np.uint8)
    raw[:, 1:] = rgb.reshape(h, w * 3)
    with open(path, 'wb') as f:
        f.write(b'\x89PNG\r\n\x1a\n')
        f.write(chunk(b'IHDR', struct.pack('>IIBBBBB', w, h, 8, 2, 0,
                                           0, 0)))
        f.write(chunk(b'IDAT', zlib.compress(raw.tobytes(), 6)))
        f.write(chunk(b'IEND', b''))


class VideoSinkBase:
    enabled = True
    # set to a writable stream (e.g. sys.stderr) to surface loading
    # progress as a carriage-return bar; None keeps it silent
    progress_stream = None

    def __init__(self):
        self.width = 0
        self.height = 0
        self.frames_rendered = 0
        self._progress_last = -1.0

    def resize(self, width: int, height: int) -> None:
        self.width = width
        self.height = height

    def render(self, y, cr, cb) -> None:
        raise NotImplementedError

    def render_progress(self, progress: float) -> None:
        """Loading-progress surface.  The reference renders a bar on the
        canvas before playback starts (src/webgl.js:283-292,
        src/canvas2d.js:36-46); the off-browser analog is a progress line
        on `progress_stream` (the CLI points it at stderr)."""
        s = self.progress_stream
        if s is None:
            return
        if progress >= 1.0 or progress - self._progress_last >= 0.01:
            self._progress_last = progress
            bar = '=' * int(min(max(progress, 0.0), 1.0) * 24)
            s.write(f'\rloading [{bar:<24}] {progress * 100:3.0f}%')
            if progress >= 1.0:
                s.write('\n')
            s.flush()

    def close(self) -> None:
        pass


class NullVideoSink(VideoSinkBase):
    """Counts frames; forces device sync on request (for benchmarking)."""

    def __init__(self, block: bool = False):
        super().__init__()
        self.block = block
        self.last_frame = None

    def render(self, y, cr, cb) -> None:
        self.frames_rendered += 1
        self.last_frame = (y, cr, cb)
        if self.block:
            host_array(y)


class VideoCollector(VideoSinkBase):
    def __init__(self):
        super().__init__()
        self.frames: List[tuple] = []

    def render(self, y, cr, cb) -> None:
        self.frames_rendered += 1
        self.frames.append((host_array(y), host_array(cr),
                            host_array(cb)))


class Y4MWriter(VideoSinkBase):
    """yuv4mpeg2 writer (playable with ffplay/mpv), display-size cropped."""

    def __init__(self, path: str, frame_rate: float = 30.0):
        super().__init__()
        self.path = path
        self.frame_rate = frame_rate
        self._fh = None

    def resize(self, width: int, height: int) -> None:
        super().resize(width & ~1, height & ~1)

    def _open(self) -> None:
        from fractions import Fraction
        fr = Fraction(self.frame_rate).limit_denominator(1001)
        self._fh = open(self.path, 'wb')
        self._fh.write(
            f'YUV4MPEG2 W{self.width} H{self.height} '
            f'F{fr.numerator}:{fr.denominator} Ip A1:1 C420jpeg\n'
            .encode())

    def render(self, y, cr, cb) -> None:
        if self._fh is None:
            self._open()
        w, h = self.width, self.height
        y = host_array(y)[:h, :w]
        cb_p = host_array(cb)[:h // 2, :w // 2]
        cr_p = host_array(cr)[:h // 2, :w // 2]
        self._fh.write(b'FRAME\n')
        self._fh.write(y.tobytes())
        self._fh.write(cb_p.tobytes())
        self._fh.write(cr_p.tobytes())
        self.frames_rendered += 1

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None


class PPMWriter(VideoSinkBase):
    """One image file per frame (RGB via the bit-exact integer conversion,
    run on `device`: None = 'cuda', which raises without a GPU); a '.png'
    pattern selects the stdlib PNG encoder, anything else PPM."""

    def __init__(self, path_pattern: str = 'frame_%05d.ppm',
                 exact: bool = True, device=None):
        from .config import resolve_device
        super().__init__()
        self.path_pattern = path_pattern
        self.exact = exact
        self.device = resolve_device(device, 'PPMWriter')

    def render(self, y, cr, cb) -> None:
        rgb = rgb_image(y, cr, cb, self.width, self.height, self.device,
                        self.exact)
        write_image(self.path_pattern % self.frames_rendered, rgb)
        self.frames_rendered += 1


# ---------------------------------------------------------------------------
# audio
# ---------------------------------------------------------------------------

class AudioSinkBase:
    enabled = True

    def __init__(self):
        self.sample_rate = 0
        self.samples_played = 0
        # output gain, 0..1 (the reference's audioOut.volume,
        # src/webaudio.js / src/player.js:143-150).  Applied by
        # apply_volume(); exactly 1.0 is a bit-exact passthrough.
        self.volume = 1.0

    def apply_volume(self, left, right):
        if self.volume == 1.0:
            return left, right
        v = np.float32(self.volume)
        return (host_array(left) * v).astype('float32'), \
            (host_array(right) * v).astype('float32')

    def play(self, sample_rate, left, right) -> None:
        raise NotImplementedError

    def stop(self) -> None:
        pass

    @property
    def enqueued_time(self) -> float:
        return 0.0

    def close(self) -> None:
        pass


class NullAudioSink(AudioSinkBase):
    def play(self, sample_rate, left, right) -> None:
        self.sample_rate = sample_rate
        self.samples_played += len(left)


class PCMCollector(AudioSinkBase):
    def __init__(self):
        super().__init__()
        self.chunks: List[tuple] = []

    def play(self, sample_rate, left, right) -> None:
        self.sample_rate = sample_rate
        self.samples_played += len(left)
        left, right = self.apply_volume(left, right)
        self.chunks.append((host_array(left), host_array(right)))

    @property
    def pcm(self) -> np.ndarray:
        ls = np.concatenate([c[0] for c in self.chunks])
        rs = np.concatenate([c[1] for c in self.chunks])
        return np.stack([ls, rs])


class WavWriter(AudioSinkBase):
    """16-bit stereo WAV writer."""

    def __init__(self, path: str):
        super().__init__()
        self.path = path
        self._wav: Optional[wave.Wave_write] = None

    def play(self, sample_rate, left, right) -> None:
        if self._wav is None:
            self._wav = wave.open(self.path, 'wb')
            self._wav.setnchannels(2)
            self._wav.setsampwidth(2)
            self._wav.setframerate(int(sample_rate))
            self.sample_rate = sample_rate
        left, right = self.apply_volume(left, right)
        lr = np.stack([host_array(left), host_array(right)], axis=1)
        s16 = np.clip(np.round(lr * 32767.0), -32768, 32767).astype('<i2')
        self._wav.writeframes(s16.tobytes())
        self.samples_played += len(left)

    def close(self) -> None:
        if self._wav:
            self._wav.close()
            self._wav = None


class PacedAudioSink(AudioSinkBase):
    """Emulates the WebAudio output's gapless scheduling clock: tracks how
    much audio is queued ahead of wallclock (enqueued_time drives the
    player's A/V sync and streaming lag control,
    jsmpeg/src/webaudio.js:37-93)."""

    def __init__(self, downstream: Optional[AudioSinkBase] = None):
        super().__init__()
        self.downstream = downstream
        self._start_time = 0.0

    def play(self, sample_rate, left, right) -> None:
        self.sample_rate = sample_rate
        now = time.monotonic()
        duration = len(left) / sample_rate
        if self._start_time < now:
            self._start_time = now
        self._start_time += duration
        self.samples_played += len(left)
        if self.downstream is not None:
            left, right = self.apply_volume(left, right)
            self.downstream.play(sample_rate, left, right)

    def reset_enqueued_time(self) -> None:
        self._start_time = time.monotonic()

    @property
    def enqueued_time(self) -> float:
        return max(self._start_time - time.monotonic(), 0.0)

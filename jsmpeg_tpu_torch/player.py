"""Player: wires source -> TS demuxer -> decoders -> sinks and schedules
decoding (the reference Player's role, jsmpeg/src/player.js,
with its rAF loop replaced by explicit tick/run/offline drivers).

Scheduling policies kept from the reference:
- static files: audio-clock-driven A/V sync (keep <= max_audio_lag of
  audio decoded ahead; decode video while it trails the audio clock),
  source throttling via headroom, loop/ended/stalled.
- streaming: decode everything available, latest-wins, and disable audio
  when it lags more than max_audio_lag behind.

Plus a batch mode the reference can't do: `decode_offline()` decodes
every buffered picture in batches of 32 (one launch of each CUDA kernel
per batch) for maximum throughput, the exact MP2 decode beside them on
a thread of its own.

Both decoders run on `PlayerConfig.device` ('cuda' by default:
construction raises without a GPU unless {'device': 'cpu'} is given).
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Union

from .config import PlayerConfig, resolve_device
from .demux import TSDemuxer
from .metrics import StageTimer, span
from .models.mp2 import MP2Decoder
from .models.mpeg1 import MPEG1Decoder
from .sinks import (AudioSinkBase, NullAudioSink, NullVideoSink,
                    PacedAudioSink, VideoSinkBase)
from .sources import (BaseSource, BytesSource, FileSource,
                      ProgressiveFileSource, TCPSource)
from . import tables as T


def make_source(target: Union[str, bytes, BaseSource],
                cfg: PlayerConfig) -> BaseSource:
    if isinstance(target, BaseSource):
        return target
    if isinstance(target, (bytes, bytearray, memoryview)):
        return BytesSource(bytes(target))
    if isinstance(target, str):
        if target.startswith('tcp://'):
            host, _, port = target[6:].partition(':')
            return TCPSource(host, int(port or 8082),
                             reconnect_interval=cfg.reconnect_interval)
        if target.startswith(('ws://', 'wss://')):
            from .net.ws import WebSocketSource
            return WebSocketSource(target,
                                   reconnect_interval=cfg.reconnect_interval)
        if target.startswith(('http://', 'https://')):
            if cfg.streaming:
                # chunked/endless body, no Content-Length (the reference
                # Fetch source role): pump incrementally, never HEAD
                from .sources import HTTPStreamSource
                return HTTPStreamSource(
                    target, reconnect_interval=cfg.reconnect_interval)
            from .sources import HTTPSource
            return HTTPSource(target, chunk_size=cfg.chunk_size,
                              progressive=cfg.progressive,
                              throttled=cfg.throttled)
        if cfg.progressive:
            return ProgressiveFileSource(target, chunk_size=cfg.chunk_size,
                                         throttled=cfg.throttled)
        return FileSource(target)
    raise TypeError(f'unsupported source: {type(target)}')


class _PosterTee:
    """Renderer wrapper writing the first decoded frame (the
    decodeFirstFrame preview) to a PPM or PNG file (by extension) -- the
    headless analog of the reference's poster image shown before
    playback (jsmpeg/src/video-element.js:63-73).  The colour conversion
    runs on `device`, the device the Player decodes on."""

    def __init__(self, inner, path: str, device):
        self._inner = inner
        self._path = path
        self._device = device
        self._written = False

    def render(self, y, cr, cb) -> None:
        if not self._written:
            self._written = True
            from .sinks import rgb_image, write_image
            w = getattr(self._inner, 'width', 0) or y.shape[1]
            h = getattr(self._inner, 'height', 0) or y.shape[0]
            write_image(self._path, rgb_image(y, cr, cb, w, h, self._device))
        self._inner.render(y, cr, cb)

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def __setattr__(self, name, value):
        if name.startswith('_'):
            object.__setattr__(self, name, value)
        else:
            setattr(self._inner, name, value)


class Player:
    def __init__(self, source: Union[str, bytes, BaseSource],
                 options: Optional[dict] = None,
                 renderer: Optional[VideoSinkBase] = None,
                 audio_out: Optional[AudioSinkBase] = None):
        with span('player.open'):
            self._open(source, options, renderer, audio_out)

    def _open(self, source, options, renderer, audio_out) -> None:
        cfg = PlayerConfig.from_options(options)
        self.cfg = cfg
        self.device = resolve_device(cfg.device, 'Player')
        self.source = make_source(source, cfg)
        self.streaming = self.source.streaming or cfg.streaming

        self.demuxer = TSDemuxer()
        self.source.connect(self.demuxer)

        # structured per-stage counters (SURVEY.md section 5): decode-time
        # callbacks feed the timer, then the user's own callbacks; traced,
        # its stages are the spans 'player.<stage>'
        self.metrics = StageTimer()

        def _vcb(dec, dt, _user=cfg.on_video_decode):
            self.metrics.seconds['video_decode'] += dt
            self.metrics.counts['video_decode'] += 1
            if _user:
                _user(dec, dt)

        def _acb(dec, dt, _user=cfg.on_audio_decode):
            self.metrics.seconds['audio_decode'] += dt
            self.metrics.counts['audio_decode'] += 1
            if _user:
                _user(dec, dt)

        opts = {'device': self.device,
                'streaming': self.streaming,
                'videoBufferSize': cfg.video_buffer_size,
                'audioBufferSize': cfg.audio_buffer_size,
                'decodeFirstFrame': cfg.decode_first_frame,
                'onVideoDecode': _vcb,
                'onAudioDecode': _acb}
        self.video: Optional[MPEG1Decoder] = None
        self.audio: Optional[MP2Decoder] = None
        self.renderer = renderer if renderer is not None else NullVideoSink()
        if cfg.poster:
            self.renderer = _PosterTee(self.renderer, cfg.poster,
                                       self.device)
        self.audio_out = audio_out if audio_out is not None else \
            (PacedAudioSink(NullAudioSink()) if self.streaming
             else NullAudioSink())

        if cfg.video:
            self.video = MPEG1Decoder(opts)
            self.demuxer.connect(T.TS_STREAM_VIDEO_1, self.video)
            self.video.connect(self.renderer)
        if cfg.audio:
            self.audio = MP2Decoder(opts, mode=cfg.audio_mode)
            self.demuxer.connect(T.TS_STREAM_AUDIO_1, self.audio)
            self.audio.connect(self.audio_out)

        self.paused = True
        self.is_playing = False
        self._wants_to_play = False
        self._start_time = 0.0
        self._ended_fired = False
        self._established_fired = False
        self._completed_fired = False

        if cfg.autoplay:
            self.play()

    # ----------------------------------------------------------- controls

    def play(self) -> None:
        if self.is_playing:
            return
        self._wants_to_play = True
        self.paused = False
        self.is_playing = True
        if not self.source.established and not getattr(
                self.source, '_started', False):
            self.source._started = True
            self.source.start()
        if self.cfg.on_play:
            self.cfg.on_play(self)

    def pause(self) -> None:
        if self.paused:
            return
        self.paused = True
        self.is_playing = False
        self._wants_to_play = False
        if hasattr(self.audio_out, 'stop'):
            self.audio_out.stop()
        if self.cfg.on_pause:
            self.cfg.on_pause(self)

    def stop(self) -> None:
        self.pause()
        self.seek(0.0)
        if (self.video is not None and self.cfg.decode_first_frame
                and not self.streaming):
            # re-render the first frame as the stopped poster (reference
            # src/player.js:153-159); in streaming mode seek() is a no-op,
            # so a decode here would eat an arbitrary live frame instead
            self.video.decode()
        if self.video is not None:
            self.video.can_play = False
        if self.audio is not None:
            self.audio.can_play = False

    def destroy(self) -> None:
        with span('player.close'):
            self.pause()
            self.source.destroy()
            self.renderer.close()
            self.audio_out.close()

    @property
    def volume(self) -> float:
        """Output gain 0..1 (the reference's player.volume,
        src/player.js:143-150)."""
        return self.audio_out.volume if self.audio_out else 0.0

    @volume.setter
    def volume(self, v: float) -> None:
        if self.audio_out:
            self.audio_out.volume = float(v)

    def set_volume(self, v: float) -> None:
        self.volume = v

    @property
    def current_time(self) -> float:
        if self.audio is not None and self.audio.can_play:
            return self.audio.current_time
        if self.video is not None:
            return self.video.current_time
        return 0.0

    @current_time.setter
    def current_time(self, t: float) -> None:
        """Assignment seeks (the reference's writable currentTime,
        src/player.js:57-60)."""
        self.seek(t)

    def seek(self, t: float, to_iframe: bool = False) -> None:
        """Seek to a timestamp.  to_iframe=True snaps forward to the next
        I picture for a clean GOP-aligned resume (no artifacts; the
        checkpoint unit of SURVEY.md section 5)."""
        start = (self.audio.start_time if self.audio and self.audio.can_play
                 else self.video.start_time if self.video else 0.0)
        if self.video is not None:
            self.video.seek(t + start, to_iframe=to_iframe)
        if self.audio is not None:
            self.audio.seek(t + start)

    def next_frame(self):
        if self.source.established and self.video is not None:
            return self.video.decode(eof=self.source.completed)
        return None

    # ---------------------------------------------------------- schedulers

    def tick(self, realtime: bool = False) -> bool:
        """One update: pull from the source, decode per policy.
        Returns False once playback has ended.  Traced, the span
        'player.tick', the source's drain 'tick.drain' inside it."""
        with span('player.tick'):
            return self._tick(realtime)

    def _tick(self, realtime: bool) -> bool:
        if hasattr(self.source, 'drain'):
            with span('tick.drain'):
                self.source.drain()
        if self.source.established and not self._established_fired:
            self._established_fired = True
            if self.cfg.on_source_established:
                self.cfg.on_source_established(self.source)
        if self.source.completed and not self._completed_fired:
            self._completed_fired = True
            if self.cfg.on_source_completed:
                self.cfg.on_source_completed(self.source)
        if not self.source.established or self.paused:
            if not self.source.established:
                self.renderer.render_progress(self.source.progress)
            return not self._ended_fired
        if self.streaming:
            return self._tick_streaming()
        return self._tick_static(realtime)

    def _tick_streaming(self) -> bool:
        if self.video is not None:
            self.video.decode(eof=False)
        if self.audio is not None:
            decoded = True
            while decoded:
                decoded = self.audio.decode() is not None
                if (self.audio_out.enqueued_time > self.cfg.max_audio_lag
                        and hasattr(self.audio_out, 'reset_enqueued_time')):
                    self.audio_out.reset_enqueued_time()
                    break
        return True

    def _tick_static(self, realtime: bool) -> bool:
        eof = self.source.completed
        decoded = False
        headroom = 0.0
        if self.audio is not None and self.audio.can_play:
            # audio is the master clock
            while (self.audio.decoded_time - self.audio.current_time
                   < self.cfg.max_audio_lag):
                if self.audio.decode() is None:
                    break
                decoded = True
            if (self.video is not None and self.video.can_play
                    and self.video.current_time < self.audio.current_time):
                decoded = (self.video.decode(eof=eof) is not None) or decoded
            headroom = self.demuxer.current_time - self.audio.current_time
        elif self.video is not None and self.video.can_play:
            if realtime:
                target = (time.monotonic() - self._start_time
                          + self.video.start_time)
                late = target - self.video.current_time
                if late > 2.0 / self.video.frame_rate:
                    self._start_time += late   # resync after a stall
                if self.video.current_time <= target:
                    decoded = self.video.decode(eof=eof) is not None
                else:
                    decoded = True
            else:
                decoded = self.video.decode(eof=eof) is not None
            headroom = self.demuxer.current_time - self.video.current_time

        self.source.resume(headroom)

        if not decoded:
            if self.source.completed:
                if self.cfg.loop:
                    self.seek(0.0)
                    return True
                self.is_playing = False
                if not self._ended_fired:
                    self._ended_fired = True
                    if self.cfg.on_ended:
                        self.cfg.on_ended(self)
                return False
            if self.cfg.on_stalled:
                self.cfg.on_stalled(self)
        return True

    def run(self, realtime: bool = False, max_seconds: float = None) -> None:
        """Drive tick() until ended (static) or max_seconds (streaming)."""
        self.play()
        self._start_time = time.monotonic()
        deadline = None if max_seconds is None else \
            time.monotonic() + max_seconds
        while self.tick(realtime=realtime):
            if deadline is not None and time.monotonic() > deadline:
                break
            if realtime:
                time.sleep(0.001)

    def decode_offline(self):
        """Throughput mode for static sources: load everything, then batch
        all pictures / audio frames through the device pipelines.
        cfg.mesh decodes closed GOPs over a mesh on cfg.device
        (parallel/mesh.py); cfg.batch_gop=False decodes frame at a time
        instead.

        The exact MP2 decode (host work only, sharing nothing with the
        video) runs on a thread of its own, 'mp2-offline_0', beside the
        video on the calling thread, and is joined (the span
        'player.audio_join') before this returns or raises; its error
        re-raises here.  The device audio mode, and audio with no video,
        decode on the calling thread after the video."""
        with span('player.demux'):
            # a static source writes its bytes to the demuxer on play
            self.play()
            if hasattr(self.source, 'load_all'):
                self.source.load_all()
            self.demuxer.flush()
        beside = (self.video is not None and self.audio is not None
                  and self.audio.mode == 'exact')
        n_video = n_audio = 0
        if beside:
            pool = ThreadPoolExecutor(max_workers=1,
                                      thread_name_prefix='mp2-offline')
            audio = pool.submit(self._decode_audio_offline)
            try:
                n_video = self._decode_video_offline()
            finally:
                with span('player.audio_join'):
                    pool.shutdown(wait=True)
            self.metrics.add('audio_beside_video')
            n_audio = audio.result()
        else:
            if self.video is not None:
                n_video = self._decode_video_offline()
            if self.audio is not None:
                n_audio = self._decode_audio_offline()
        if self.cfg.on_ended:
            self.cfg.on_ended(self)
        return n_video, n_audio

    def _decode_video_offline(self) -> int:
        """decode_offline's video: every buffered picture, rendered and
        released batch by batch -> the decoder's frame count."""
        before = self.video.frames_decoded
        mesh = None
        if self.cfg.mesh is not None:
            from .parallel.mesh import resolve_mesh
            mesh = resolve_mesh(self.cfg.mesh, device=self.device)
        with self.metrics.time('video_batch'):
            # retain=False: render-and-release per batch, so device
            # memory stays bounded for arbitrarily long files
            if self.cfg.batch_gop:
                self.video.decode_available(eof=True, retain=False,
                                            mesh=mesh)
            else:
                while self.video.decode(eof=True) is not None:
                    pass
        # count via the decoder (a decodeFirstFrame preview may have
        # decoded+rendered frame 0 during write, before this call)
        n_video = self.video.frames_decoded
        self.metrics.add('video_batch', n_video - before - 1)
        return n_video

    def _decode_audio_offline(self) -> int:
        """decode_offline's audio: every buffered frame in one batch ->
        the number of frames.  `decode_available` is looked up at call
        time, so a wrapper set on the decoder sees the whole call."""
        with self.metrics.time('audio_batch'):
            pcm = self.audio.decode_available()
        n_audio = pcm.shape[0] if pcm is not None else 0
        self.metrics.add('audio_batch', n_audio - 1)
        return n_audio

"""Closed-loop offline decode: A/V files decoded back to back through the
Player's throughput mode (`Player(...).decode_offline()`), as the CLI's
`--offline`, thumbnails and library transcodes run it.

Each file is `file_seconds` of the configuration's video muxed with its
MP2 audio (the audio cycle repeated).  Its video is the pool's GOPs in
an order of its own, drawn from the seed: a permutation of the pool
taken whole as often as it fits, plus distinct GOPs for the rest, so
that every file asks the same work of the decoder and no two files are
the same bytes.  Set-up muxes the files (`gen.fast_mux`): `warm_files`
for the warm-up, and for the window as many as `planned_fps` would
decode in `--seconds`; a window that decodes more takes them again from
the first.  The window decodes file after file until `--seconds` have
passed, then finishes the file it is in.  A renderer stamps each frame
as its planes reach the host and keeps the planes of a seeded sample
(`sample_frames_per_file` per file); an audio sink counts each file's
samples and keeps the PCM of a seeded sample of `pcm_files` files.
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np

from ..pool import derived_seed, expected_pcm, make_pool, reference
from .base import (Compared, LaunchRecorder, differing_pixels, now,
                   planes_of, sample_plan, say)

SEQUENCE_END = b'\x00\x00\x01\xb7'


def _timed(fn, took: dict, name: str):
    """`fn`, adding the seconds of each call to took[name]."""
    def run(*a, **kw):
        t0 = now()
        try:
            return fn(*a, **kw)
        finally:
            took[name] = took.get(name, 0.0) + now() - t0
    return run


def file_order(rng: np.random.Generator, n_pool: int,
               n_gops: int) -> np.ndarray:
    """A file's GOP order: the pool taken whole as often as it fits, and
    distinct GOPs for the rest, in a permutation drawn from `rng`."""
    whole, rest = divmod(n_gops, n_pool)
    gops = np.concatenate([np.tile(np.arange(n_pool), whole),
                           rng.choice(n_pool, rest, replace=False)])
    return rng.permutation(gops)


class Cell:
    """One run of an offline cell (see the module docstring)."""

    def __init__(self, spec, seed: int, device: str, seconds: float,
                 spans=None, control: bool = False):
        self.spec = spec
        self.cfg = spec.config
        self.mix = spec.traffic
        self.seed = int(seed)
        self.device = device
        self.seconds = float(seconds)
        # the control: the program's own float32 audio synthesis, which
        # breaks the configuration's exact PCM
        self.audio_mode = 'device' if control else 'exact'
        # traced: the benchmark's spans (trace.Spans), installed on each
        # file's Player, and the device trace
        self.spans = spans
        self.trace = None
        self.launches: Optional[LaunchRecorder] = None
        self.slots: List[dict] = []     # the window's files, in order
        self.window = (0.0, 0.0)

    # ------------------------------------------------------------ set-up

    def setup(self) -> None:
        cfg, mix = self.cfg, self.mix
        t0 = now()
        self.pool = make_pool(cfg, self.seed)
        fps, gop = cfg['fps'], cfg['gop']
        self.frames_per_file = int(round(mix['file_seconds'] * fps))
        if self.frames_per_file % gop:
            raise ValueError('a file holds whole GOPs')
        n_gops = self.frames_per_file // gop
        self.n_warm = mix['warm_files']
        self.n_window = max(1, math.ceil(self.seconds * mix['planned_fps']
                                         / self.frames_per_file))
        rng = np.random.default_rng(derived_seed(self.seed, 3))
        self.orders = [file_order(rng, len(self.pool.gops), n_gops)
                       for _ in range(self.n_warm + self.n_window)]
        self.samples = sample_plan(rng, mix['max_files'],
                                   mix['sample_frames_per_file'],
                                   self.frames_per_file)
        # the files whose PCM is held to the reference's (every file's
        # sample count is): the first, and a seeded sample
        self.pcm_slots = {0} | set(rng.choice(
            np.arange(1, mix['pcm_slot_range']), mix['pcm_files'] - 1,
            replace=False).tolist())
        a = cfg['audio']
        spf = 1152
        self.audio_frames = math.ceil(mix['file_seconds'] * a['sample_rate']
                                      / spf)
        from ..gen.fast_mux import mux_av, mux_unit
        pics = [[mux_unit(0x100, 0xE0, c, False) for c in g]
                for g in self.pool.gops]
        ends = [mux_unit(0x100, 0xE0, g[-1] + SEQUENCE_END, False)
                for g in self.pool.gops]
        cycle = [mux_unit(0x101, 0xC0, f, True) for f in self.pool.audio]
        track = [cycle[k % len(cycle)] for k in range(self.audio_frames)]
        self.files = []
        for order in self.orders:
            video = [u for g in order for u in pics[g]]
            video[-1] = ends[order[-1]]
            self.files.append(mux_av(video, float(fps), track, spf,
                                     a['sample_rate']))
        # the benchmark's own inputs, which no user of the program makes:
        # left out of `setup_s`
        self.inputs_s = now() - t0
        say(f'inputs: pool and {len(self.files)} files in '
            f'{self.inputs_s:.1f} s')
        for k in range(self.n_warm):
            self._decode_file(k, keep=None)

    # ------------------------------------------------------------ window

    def _player(self, data: bytes, renderer, audio_out):
        from jsmpeg_tpu_torch.player import Player
        p = Player(data, {'device': self.device,
                          'audioMode': self.audio_mode},
                   renderer=renderer, audio_out=audio_out)
        if self.spans is not None:
            v = p.video
            v.parser.parse_batch = self.spans.wrap('parse_batch',
                                                   v.parser.parse_batch)
            v._feed = self.spans.wrap('_feed', v._feed)
            a = p.audio
            a.decode_available = self.spans.wrap('audio_decode',
                                                 a.decode_available)
        return p

    def _decode_file(self, k: int, keep, keep_pcm: bool = False) -> dict:
        from jsmpeg_tpu_torch.sinks import NullAudioSink, VideoSinkBase

        class Stamp(VideoSinkBase):
            def __init__(self):
                super().__init__()
                self.at: List[float] = []
                self.kept = {}

            def render(self, y, cr, cb):
                i = len(self.at)
                self.at.append(now())
                if keep is not None and i in keep:
                    self.kept[i] = planes_of(y, cr, cb)
                self.frames_rendered += 1

        class Pcm(NullAudioSink):
            def __init__(self):
                super().__init__()
                self.chunks = []

            def play(self, sample_rate, left, right):
                super().play(sample_rate, left, right)
                if keep_pcm:
                    self.chunks.append((left, right))

        video, audio = Stamp(), Pcm()
        t0 = now()
        p = self._player(self.files[k], video, audio)
        took = {'player': now() - t0}
        for part in ('video', 'audio'):
            dec = getattr(p, part)
            if dec is not None:
                dec.decode_available = _timed(dec.decode_available, took,
                                              part)
        p.decode_offline()
        p.destroy()
        end = now()
        took['rest'] = end - t0 - sum(took.values())
        return {'file': k, 'start': t0, 'end': end, 'at': video.at,
                'kept': video.kept, 'pcm': audio.chunks if keep_pcm else None,
                'samples': audio.samples_played, 'took': took}

    def measure(self) -> None:
        """The window: files back to back until `seconds` have passed;
        traced, with the spans, the kernel launches and the device trace
        over the window's whole files."""
        if self.spans is not None and self.device != 'cpu':
            import torch
            from ..trace import Profiler
            prof = Profiler(torch)
            self.launches = LaunchRecorder(self.n_mb())
            prof.start()
            with self.launches:
                prof.open_window()
                self._loop(self.seconds)
                prof.close_window()
            self.trace = prof.stop()
        else:
            self._loop(self.seconds)

    def _say_files(self) -> None:
        """Each file's time, and its parts: the Player's construction,
        the video's and the audio's decode, and the rest (demux, play,
        destroy), min / median / max over the window's files."""
        took = np.array([s['end'] - s['start'] for s in self.slots])
        parts = ', '.join(
            f'{n} ' + ' / '.join(f'{v:.3f}' for v in np.percentile(
                [s['took'].get(n, 0.0) for s in self.slots], (0, 50, 100)))
            for n in ('player', 'video', 'audio', 'rest'))
        say(f'{len(took)} files in {self.window_end - self.window[0]:.2f} s'
            f' ({len(self.files) - self.n_warm} muxed): each '
            f'{np.min(took):.3f} / {np.median(took):.3f} / '
            f'{np.max(took):.3f} s (min / median / max); {parts}')

    def _loop(self, seconds: float) -> None:
        w0 = now()
        w1 = w0 + seconds
        self.window = (w0, w1)
        k = 0
        while True:
            keep = set(self.samples[k].tolist()) \
                if k < len(self.samples) else None
            f = self.n_warm + k % self.n_window
            self.slots.append(self._decode_file(f, keep, k in self.pcm_slots))
            k += 1
            if now() >= w1:
                break
        self.window_end = now()
        self._say_files()

    def release(self) -> None:
        import gc
        gc.collect()
        if self.device != 'cpu':
            import torch
            torch.cuda.empty_cache()

    # ---------------------------------------------------------- results

    def n_mb(self) -> int:
        return ((self.cfg['width'] + 15) // 16) * \
            ((self.cfg['height'] + 15) // 16)

    def layer_window(self):
        """(start, end, frames) of the per-layer metrics: the traced
        window, which holds the window's files whole."""
        if self.trace is not None:
            start, end = self.trace.start, self.trace.end
        else:
            start, end = self.window[0], self.window_end
        return start, end, sum(len(s['at']) for s in self.slots)

    def end_to_end(self) -> dict:
        """The window holds whole files: from its start to the end of
        the file in progress at `seconds`; every frame of them reached
        the host sink in it."""
        frames = sum(len(s['at']) for s in self.slots)
        return {'decode_fps': frames / (self.window_end - self.window[0])}

    def decode_order(self) -> List[tuple]:
        """(gop index in the pool, position) of every frame the window
        decoded, in decode order."""
        gop = self.cfg['gop']
        return [(int(g), j) for s in self.slots
                for g in self.orders[s['file']] for j in range(gop)]

    def attempted(self) -> int:
        return len(self.slots) * (self.frames_per_file + 1)

    def check(self) -> List[Compared]:
        """Every file's frame count; the sampled frames against the
        reference's planes of their pool GOP; every file's PCM against
        the reference's."""
        frames, self.work, pcm = reference(self.pool)
        gop = self.cfg['gop']
        missing = sum(max(0, self.frames_per_file - len(s['at']))
                      + max(0, len(s['at']) - self.frames_per_file)
                      for s in self.slots)
        bad_px = bad_frames = 0
        for k, s in enumerate(self.slots):
            order = self.orders[s['file']]
            for i, got in sorted(s['kept'].items()):
                want = frames[int(order[i // gop])][i % gop]
                d = differing_pixels(got, want)
                bad_px += d
                bad_frames += d > 0
                if d and bad_frames <= 12:
                    say(f'file {k} (of {len(self.slots)}, distinct file '
                        f"{s['file']}) frame {i} (pool GOP "
                        f'{int(order[i // gop])}, picture {i % gop}): '
                        + ', '.join(f'{n} {differing_pixels([g], [w])}'
                                    for n, g, w in zip(('y', 'cr', 'cb'),
                                                       got, want))
                        + ' pixels differ')
        want_pcm = expected_pcm(pcm, self.audio_frames)
        bad_pcm = bad_tracks = 0
        for s in self.slots:
            if s['pcm'] is None:
                # not held: its length only
                d = abs(s['samples'] - want_pcm.shape[1])
                bad_pcm += d
                bad_tracks += d > 0
                continue
            if s['pcm']:
                got = np.stack([np.concatenate([np.asarray(c[ch])
                                                for c in s['pcm']])
                                for ch in (0, 1)])
            else:
                got = np.zeros((2, 0), np.float32)
            if got.shape != want_pcm.shape:
                d = max(got.size, want_pcm.size)
            else:
                d = int(np.count_nonzero(got != want_pcm))
            bad_pcm += d
            bad_tracks += d > 0
        # answers judged: every frame of every file (by its count), and
        # every file's audio track (by its length; the sample's whole)
        self.failed = missing + bad_frames + bad_tracks
        return [Compared('frame_count_error', missing, 0),
                Compared('pixels_differing', bad_px, 0),
                Compared('pcm_samples_differing', bad_pcm, 0)]

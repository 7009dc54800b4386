#!/usr/bin/env python3
"""Time two checkouts of the port on one NVIDIA GPU, in turns: the 720p
main path and the Player's offline decode.

    python3 pipeline_ab.py --baseline DIR [--repeats N]

DIR is another checkout of the repo (for instance a parent commit
unpacked with `git archive` into a directory `.gitignore` lists).  The
stream is chip_smoke.py's: 96 frames of 1280x720 (seed 3, GOP 12), muxed
with 123 MP2 frames for the Player, made once here.  The turns run
baseline, this checkout, this checkout, baseline, each a fresh process
that imports `jsmpeg_tpu_torch` from its own checkout (building its host
library and kernels there), then:
- decodes the ES through `MPEG1Decoder.decode_available` once to warm
  up and N times more, each fenced by `torch.cuda.synchronize()` (as
  chip_smoke's `e_main`): frames per second of the median wall;
- runs `Player.decode_offline` with a VideoCollector once and N times
  more: the video rate from the Player's own `video_batch` timer (as
  `i_player_offline`), the median.
Every turn's frames (main path and Player) must hash equal to the first
turn's, or the script fails.  Prints one JSON line per turn, the card's
name and power limit, and a last JSON line with each checkout's rates
and the host canary (`jsmpeg_tpu_torch.host.native.host_canary`),
taken before the first turn and after the last, so that a slower host
shows beside the rates.
Needs a CUDA device and imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

WORKER = r'''
import gc, hashlib, json, sys, time
import torch
from jsmpeg_tpu_torch.models.mpeg1 import MPEG1Decoder
from jsmpeg_tpu_torch.player import Player
from jsmpeg_tpu_torch.sinks import PCMCollector, VideoCollector

es = open(sys.argv[1], 'rb').read()
ts = open(sys.argv[2], 'rb').read()
repeats = int(sys.argv[3])


def main_path():
    dec = MPEG1Decoder({'device': 'cuda'})
    dec.write(0.0, es)
    outs = dec.decode_available(eof=True)
    torch.cuda.synchronize()
    return outs


def player():
    vc = VideoCollector()
    p = Player(ts, {'progressive': False, 'device': 'cuda'}, renderer=vc,
               audio_out=PCMCollector())
    p.decode_offline()
    torch.cuda.synchronize()
    sec = p.metrics.seconds['video_batch']
    return p.metrics.counts['video_batch'] / sec, vc


def digest(frames):
    h = hashlib.sha256()
    for f in frames:
        for x in f:
            h.update(x.cpu().numpy().tobytes() if hasattr(x, 'cpu')
                     else bytes(x))
    return h.hexdigest()


outs = main_path()
main_digest = digest(outs)
del outs
walls = []
for _ in range(repeats):
    t0 = time.monotonic()
    outs = main_path()
    walls.append(time.monotonic() - t0)
    del outs
_, vc = player()
player_digest = digest(vc.frames)
del vc
gc.collect()
vfps = []
for _ in range(repeats):
    fps, vc = player()
    vfps.append(fps)
    del vc
    gc.collect()
print(json.dumps({'main_walls_s': walls, 'player_video_fps': vfps,
                  'main_digest': main_digest,
                  'player_digest': player_digest}))
'''


def run_turn(tree: str, es_path: str, ts_path: str, repeats: int) -> dict:
    out = subprocess.run([sys.executable, '-c', WORKER, es_path, ts_path,
                          str(repeats)], cwd=tree, check=True,
                         capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=tree))
    return json.loads(out.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--baseline', required=True,
                    help='another checkout of the repo')
    ap.add_argument('--repeats', type=int, default=5)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print('pipeline_ab: no CUDA device is available', file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import chip_smoke
    from jsmpeg_tpu_torch.host.native import host_canary
    canary = host_canary()
    es, _, ts_av, _, _ = chip_smoke.encode_stream()
    trees = {'baseline': os.path.abspath(args.baseline), 'this': HERE}
    rates: dict = {k: {'main_fps': [], 'player_video_fps': []}
                   for k in trees}
    digests = None
    with tempfile.TemporaryDirectory() as tmp:
        es_path, ts_path = (os.path.join(tmp, n) for n in ('v.es', 'av.ts'))
        with open(es_path, 'wb') as f:
            f.write(es)
        with open(ts_path, 'wb') as f:
            f.write(ts_av)
        for turn, name in enumerate(('baseline', 'this', 'this',
                                     'baseline')):
            r = run_turn(trees[name], es_path, ts_path, args.repeats)
            got = (r['main_digest'], r['player_digest'])
            if digests is None:
                digests = got
            elif got != digests:
                raise AssertionError(f'turn {turn} ({name}): frames differ '
                                     'from the first turn')
            main_fps = chip_smoke.N_FRAMES / float(np.median(
                r['main_walls_s']))
            player_fps = float(np.median(r['player_video_fps']))
            rates[name]['main_fps'].append(main_fps)
            rates[name]['player_video_fps'].append(player_fps)
            print(json.dumps({'turn': turn, 'tree': name,
                              'main_fps_median': main_fps,
                              'player_video_fps_median': player_fps,
                              **r}), flush=True)
    canary_end = host_canary()
    print(chip_smoke.phase_gpu(), flush=True)
    print(json.dumps({'frames_equal': True, 'repeats': args.repeats,
                      'rates': rates, 'host_canary': canary,
                      'host_canary_end': canary_end}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())

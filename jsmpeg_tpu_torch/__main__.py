"""Command-line player/transcoder (the VideoElement/demo-page equivalent).

Examples:
  python -m jsmpeg_tpu_torch clip.ts -o out.y4m --wav out.wav
  python -m jsmpeg_tpu_torch clip.ts --stats --offline
  python -m jsmpeg_tpu_torch tcp://localhost:8082 --seconds 10 -o live.y4m
  python -m jsmpeg_tpu_torch clip.ts --device cpu -o out.y4m
  python -m jsmpeg_tpu_torch a.ts b.ts -o out%d.y4m
  python -m jsmpeg_tpu_torch clip.ts --offline --mesh 8 -o out.y4m
  python -m jsmpeg_tpu_torch --selftest

Decoding runs on the GPU ('cuda') unless --device names another device;
without a GPU the default exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog='jsmpeg_tpu_torch',
        description='MPEG1/MP2 player & transcoder on the GPU (PyTorch/CUDA)')
    ap.add_argument('source', nargs='*',
                    help='.ts path, http(s)://, tcp://host:port or '
                         'ws://host:port; several .ts paths decode '
                         'jointly (video only, -o with %%d)')
    ap.add_argument('-o', '--y4m', help='write video to .y4m')
    ap.add_argument('--ppm', help='write frames as PPM or PNG files '
                    '(pattern with %%d; .png selects PNG)')
    ap.add_argument('--wav', help='write audio to .wav')
    ap.add_argument('--poster',
                    help='write the first decoded frame to this .ppm/.png '
                         '(the data-poster analog)')
    ap.add_argument('--stats', action='store_true', help='print decode stats')
    ap.add_argument('--progress', action='store_true',
                    help='show a loading-progress bar on stderr (auto-on '
                         'when stderr is a TTY)')
    ap.add_argument('--realtime', action='store_true',
                    help='pace decoding to wallclock')
    ap.add_argument('--seconds', type=float, default=None,
                    help='stop after N seconds (streaming)')
    ap.add_argument('--offline', action='store_true',
                    help='batch decode at maximum throughput (static files)')
    ap.add_argument('--mesh', default=None,
                    help="decode closed GOPs over a mesh (offline or "
                         "several inputs): 'GxT' (GOPs x macroblock "
                         "tiles), an integer (GOP-parallel) or 'auto' "
                         '(all devices); cells on one device share one '
                         'launch pair')
    ap.add_argument('--streaming', action='store_true',
                    help='treat an http:// source as a live chunked '
                         'stream (no Content-Length; the relay GET output)')
    ap.add_argument('--no-audio', action='store_true')
    ap.add_argument('--no-video', action='store_true')
    ap.add_argument('--audio-mode', choices=['exact', 'device'],
                    default='exact')
    ap.add_argument('--device', default='cuda',
                    help="device to decode on (default 'cuda'; 'cpu' runs "
                         'the plain versions of the kernels)')
    ap.add_argument('--loop', action='store_true')
    ap.add_argument('--selftest', action='store_true',
                    help='decode a synthetic stream and verify bit-exactness')
    args = ap.parse_args(argv)

    from .config import device_name, resolve_device
    try:
        device = resolve_device(args.device, 'jsmpeg_tpu_torch')
    except RuntimeError as e:
        print(e, file=sys.stderr)
        return 1
    if args.selftest:
        return _selftest(device)
    if not args.source:
        ap.error('source required (or --selftest)')
    if len(args.source) > 1:
        return _multi(args, device)
    args.source = args.source[0]

    from .ops import kernels
    from .player import Player
    from .sinks import PPMWriter, WavWriter, Y4MWriter

    renderer = None
    if args.y4m:
        renderer = Y4MWriter(args.y4m)
    elif args.ppm:
        renderer = PPMWriter(args.ppm, device=device)
    audio_out = WavWriter(args.wav) if args.wav else None

    options = {
        'audio': not args.no_audio,
        'video': not args.no_video,
        'audio_mode': args.audio_mode,
        'device': device,
        'loop': args.loop,
        'mesh': args.mesh,
        'streaming': args.streaming,
        'poster': args.poster,
    }
    t0 = time.monotonic()
    p = Player(args.source, options, renderer=renderer, audio_out=audio_out)
    if renderer is None:
        renderer = p.renderer
    if renderer is not None and (args.progress or sys.stderr.isatty()):
        renderer.progress_stream = sys.stderr

    if args.offline:
        n_video, n_audio = p.decode_offline()
    else:
        p.run(realtime=args.realtime, max_seconds=args.seconds)
        n_video = p.renderer.frames_rendered
        n_audio = p.audio_out.samples_played // 1152 if p.audio else 0
    elapsed = time.monotonic() - t0
    p.destroy()

    if args.stats or not (args.y4m or args.ppm or args.wav):
        stats = {
            'video_frames': n_video,
            'audio_frames': n_audio,
            'seconds': round(elapsed, 3),
            'video_fps': round(n_video / elapsed, 2) if elapsed else 0,
            'ts_packets': p.demuxer.packets_parsed,
            'resolution': (f'{p.video.seq.width}x{p.video.seq.height}'
                           if p.video and p.video.seq else None),
            'device': device_name(device),
            'kernel_launches': dict(kernels.launches),
            'stages': p.metrics.summary(),
        }
        print(json.dumps(stats))
    return 0


def _multi(args, device) -> int:
    """Joint decode of several static .ts inputs on one device (the
    stream-parallel serving path, round-robin), or with --mesh the
    streams' closed GOPs over the mesh (parallel/streams.
    decode_streams_mesh).  Video only; -o names per-stream .y4m outputs
    (a %d pattern, or an index is inserted before the suffix)."""
    import torch

    from .config import device_name
    from .demux import demux_to_es
    from .ops import kernels
    from .parallel.streams import MultiStreamDecoder
    from .sinks import Y4MWriter

    if args.wav or args.ppm:
        raise SystemExit('multi-input decode is video-only (-o .y4m)')
    paths = args.source
    streams = []
    for path in paths:
        with open(path, 'rb') as f:
            data = f.read()
        streams.append(demux_to_es(data))
    t0 = time.monotonic()
    if args.mesh:
        from .parallel.mesh import resolve_mesh
        from .parallel.streams import decode_streams_mesh
        frames, seq = decode_streams_mesh(
            streams, resolve_mesh(args.mesh, device=device), with_seq=True)
    else:
        dec = MultiStreamDecoder(len(paths), device=device)
        for i, es_b in enumerate(streams):
            dec.write(i, es_b)
        frames = dec.decode_all(eof=True)
        seq = dec._seq
    if device.type == 'cuda':
        torch.cuda.synchronize(device)
    elapsed = time.monotonic() - t0
    total = 0
    for i, path in enumerate(paths):
        total += len(frames[i])
        if not args.y4m or seq is None or not frames[i]:
            continue
        if '%d' in args.y4m:
            out = args.y4m % i
        else:
            base, dot, ext = args.y4m.rpartition('.')
            out = f'{base}.{i}.{ext}' if dot else f'{args.y4m}.{i}'
        w = Y4MWriter(out, getattr(seq, 'frame_rate', 30.0) or 30.0)
        w.resize(seq.width, seq.height)
        for p in frames[i]:
            w.render(p.y, p.cr, p.cb)
        w.close()
    print(json.dumps({
        'streams': len(paths),
        'video_frames': [len(f) for f in frames],
        'seconds': round(elapsed, 3),
        'aggregate_fps': round(total / elapsed, 2) if elapsed else 0,
        'resolution': f'{seq.width}x{seq.height}' if seq else None,
        'device': device_name(device),
        'kernel_launches': dict(kernels.launches),
    }))
    return 0


def _selftest(device) -> int:
    from .config import device_name
    from .player import Player
    from .sinks import PCMCollector, VideoCollector
    from .testing.gen import encode_test_stream
    from .testing.mp2_enc import encode_stream as mp2_stream
    from .testing.ts_mux import mux_av

    es, chunks = encode_test_stream(96, 64, n_frames=6, seed=5, gop=3)
    audio_es, audio_frames = mp2_stream(8, seed=6)
    vframes = chunks[:-1]
    vframes[-1] += chunks[-1]
    ts = mux_av(vframes, 25.0, audio_frames, 1152, 44100)

    vc, ac = VideoCollector(), PCMCollector()
    p = Player(ts, {'progressive': False, 'device': device}, renderer=vc,
               audio_out=ac)
    n_video, n_audio = p.decode_offline()
    ok = n_video == 6 and n_audio == 8
    print(json.dumps({'selftest': 'ok' if ok else 'FAIL',
                      'video_frames': n_video, 'audio_frames': n_audio,
                      'device': device_name(device)}))
    return 0 if ok else 1


if __name__ == '__main__':
    sys.exit(main())

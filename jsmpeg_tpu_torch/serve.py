"""Joint live serving: decode N live MPEG-TS feeds on one GPU.

Every feed (tcp://, ws://, http:// streaming, or a static .ts path)
demuxes on the host, and its pictures join the fleet's round
(parallel/streams.py): round-robin (each feed with frames decodes in
turn on the card with its own carry) or, with --mode stacked|vmap, one
joint launch pair for every feed.  Feeds run at unequal rates -- a
stalled camera never blocks the others -- and every feed stays
bit-exact.  The reference's closest analog is N separate browser tabs.

Usage:
  python -m jsmpeg_tpu_torch.serve tcp://h:p ws://h:p cam2.ts -o out%d.y4m \\
      [--wav a%d.wav] [--batch 8] [--interval 0.05] [--seconds 10] \\
      [--mode roundrobin|stacked|vmap] [--device cuda]

Decoding runs on the GPU ('cuda') unless --device names another device;
without a GPU the default exits non-zero.  Prints one JSON line of stats
at the end.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


class _ESFeed:
    """Demuxer video sink -> MultiStreamDecoder.write(i, ...)."""

    def __init__(self, dec, i):
        self.dec = dec
        self.i = i

    def write(self, pts, payload):
        if isinstance(payload, (bytes, bytearray, memoryview)):
            self.dec.write(self.i, payload)
        else:
            for p in payload:
                self.dec.write(self.i, p)


def serve(urls, out_pattern=None, batch=8, interval=0.05, seconds=None,
          stats_out=None, wav_pattern=None, mode='roundrobin', device=None):
    """Decode the feeds at `urls` jointly until every source completes
    (or `seconds` pass), writing per-feed y4m (`out_pattern` % i) and wav
    (`wav_pattern` % i) files; returns the stats dict it prints."""
    from .config import PlayerConfig, device_name
    from .demux import TSDemuxer
    from .models.mp2 import MP2Decoder
    from .parallel.streams import MultiStreamDecoder
    from .player import make_source
    from .sinks import WavWriter, Y4MWriter

    n = len(urls)
    # serving reads whole static files up front (no progressive Range
    # throttle to resume()) and treats http:// as an endless chunked
    # live body, matching the advertised feed kinds.  Nothing starts
    # before the decoder has its device.
    cfg = PlayerConfig(progressive=False, streaming=True)
    sources = [make_source(url, cfg) for url in urls]
    # the EVICT memory bound applies to live feeds only, as in the
    # Player: a static file arrives whole, and dropping its unread bytes
    # would drop its frames (jsmpeg_tpu's tools/serve.py bounds every
    # feed, so a static file over the cap loses the rest)
    live = [s.streaming for s in sources]
    dec = MultiStreamDecoder(n, batch_frames=batch, streaming=live,
                             quarantine=True, mode=mode, device=device)
    audio = []
    for i, src in enumerate(sources):
        dem = TSDemuxer()
        dem.connect(0xE0, _ESFeed(dec, i))
        if wav_pattern is not None:
            # audio rides the exact host MP2 path (C++): no reason to
            # batch it on the device
            ad = MP2Decoder({'streaming': live[i]})
            ad.connect(WavWriter(wav_pattern % i))
            dem.connect(0xC0, ad)
            audio.append(ad)
        src.connect(dem)
    for s in sources:
        s.start()

    writers = [None] * n
    counts = [0] * n
    t0 = time.monotonic()
    deadline = t0 + seconds if seconds else None

    def render(outs):
        for i, st in enumerate(outs):
            k = st.y.shape[0]
            if not k:
                continue
            counts[i] += k
            if out_pattern is None:
                continue
            if writers[i] is None:
                seq = dec._seq
                writers[i] = Y4MWriter(
                    out_pattern % i,
                    getattr(seq, 'frame_rate', 30.0) or 30.0)
                writers[i].resize(seq.width, seq.height)
            # ONE copy back per plane per stream per round, then the
            # frames are sliced on the host
            ys, crs, cbs = (p.cpu().numpy() for p in st)
            for f in range(k):
                writers[i].render(ys[f], crs[f], cbs[f])

    reported_dead = set()

    def report_dead():
        for i, why in enumerate(dec.dead):
            if why and i not in reported_dead:
                reported_dead.add(i)
                print(f'[serve] stream {i} ({urls[i]}) dropped: {why}',
                      file=sys.stderr, flush=True)
                sources[i].destroy()    # stop downloading a dead feed

    try:
        while deadline is None or time.monotonic() < deadline:
            for s in sources:
                if hasattr(s, 'drain'):
                    s.drain()
            for ad in audio:
                ad.decode_available()
            outs = dec.decode_batch(eof=False)
            report_dead()
            if all(dec.dead):
                print('[serve] every stream is dead; exiting',
                      file=sys.stderr, flush=True)
                break
            if outs is None:
                if all(getattr(s, 'completed', False) for s in sources):
                    break
                time.sleep(interval)
            else:
                render(outs)
        # drain whatever the parsers still hold
        for s in sources:
            if hasattr(s, 'drain'):
                s.drain()
        while True:
            outs = dec.decode_batch(eof=True)
            if outs is None:
                break
            render(outs)
        for ad in audio:
            ad.decode_available()
    finally:
        for s in sources:
            s.destroy()
        for w in writers:
            if w is not None:
                w.close()
        for ad in audio:
            if ad.destination is not None:
                ad.destination.close()
    elapsed = time.monotonic() - t0
    stats = {
        'streams': n,
        'video_frames': counts,
        'seconds': round(elapsed, 3),
        'aggregate_fps': round(sum(counts) / elapsed, 2) if elapsed else 0,
        'dead': {i: why for i, why in enumerate(dec.dead) if why},
        'device': device_name(dec.device),
    }
    print(json.dumps(stats), file=stats_out or sys.stdout, flush=True)
    return stats


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog='jsmpeg_tpu_torch.serve',
        description='joint live decode of N MPEG-TS feeds on one GPU')
    ap.add_argument('urls', nargs='+',
                    help='tcp://h:p, ws://h:p, http(s)://, or .ts paths')
    ap.add_argument('-o', dest='out', default=None,
                    help='per-stream y4m pattern with %%d')
    ap.add_argument('--wav', default=None,
                    help='per-stream wav pattern with %%d (host MP2 path)')
    ap.add_argument('--batch', type=int, default=8,
                    help='max frames per stream per round')
    ap.add_argument('--interval', type=float, default=0.05,
                    help='idle poll interval (s)')
    ap.add_argument('--seconds', type=float, default=None,
                    help='stop after N seconds')
    from .parallel.streams import MODES
    ap.add_argument('--mode', default='roundrobin', choices=MODES,
                    help='fleet round: each feed in turn, or one joint '
                         'launch pair (bit-exact all three)')
    ap.add_argument('--device', default='cuda',
                    help="device to decode on (default 'cuda'; 'cpu' runs "
                         'the plain versions of the kernels)')
    args = ap.parse_args(argv)
    from .config import resolve_device
    try:
        device = resolve_device(args.device, 'jsmpeg_tpu_torch.serve')
    except RuntimeError as e:
        print(e, file=sys.stderr)
        return 1
    serve(args.urls, args.out, args.batch, args.interval, args.seconds,
          wav_pattern=args.wav, mode=args.mode, device=device)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())

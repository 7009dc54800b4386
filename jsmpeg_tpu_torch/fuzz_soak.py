"""Robustness soak of the port: random fixtures under random corruption
through every ingest layer, and clean differential rounds that hold each
decode formulation to the serial exact decode on the CPU, so that wrong
output shows and not only crashes.

  python -m jsmpeg_tpu_torch.fuzz_soak [--seconds 3600] [--seed N]
      [--log PATH] [--device cuda|cpu]

Each iteration draws a fixture (48-160 x 48-96 pixels, 2-8 frames, GOPs
of 1-4, f_code 1-4, half- or full-pel vectors, with 1-4 MP2 frames,
muxed as TS) and runs, on a schedule by iteration number:
- drain (every iteration): the TS corrupted in one of six modes through
  the demuxer, MPEG1 and MP2 decoders in streaming mode, in random
  chunks; neither may raise;
- differential (1 in 6): the clean stream through a random formulation
  (the C++ or the Python parser, streaming or not, `decode_available`
  or per-frame `decode()`);
- fleet (1 in 3): 2-3 streams through `MultiStreamDecoder(quarantine=
  True)` in a random mode, one of them corrupted: the clean ones must
  equal their own decode;
- mesh (1 in 6): a random `make_mesh(g, t)` (t = 2: two device objects
  of the one device, so the picture decodes in bands) through
  `decode_packed_mesh` and `decode_tiled_levels`; a decode refused by
  policy (its message says why: MV reach past the halo, a GOP not
  closed, the serial exact path) is counted apart, and the round counts
  only when it compared a decode;
- elastic (1 in 12): `decode_gops_elastic` with 3 workers, the one handed
  a random GOP killed.
Every decode of a clean stream is held to the serial exact decode on the
CPU (the Python parser's path), and on the card each drain and fleet
round also to the same round on the CPU, frame for frame.  A failure
logs one JSON line {seed, mode, error, trace} to --log and the soak goes
on; the exit code is 1 when any round failed.  --device defaults to the card and raises
without one.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import time
import traceback

import numpy as np
import torch

CPU = torch.device('cpu')
MODES = ('bitflips', 'truncate', 'garbage_prefix', 'drop_packets',
         'dup_packets', 'mix')
ROUNDS = ('drain', 'differential', 'fleet', 'mesh', 'elastic')
COUNTS = ROUNDS + ('mesh_compared', 'mesh_refused')
DEFAULT_LOG = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'build', 'jsmpeg_tpu_torch',
    'fuzz_soak.jsonl')


def fixture(rng):
    """(elementary stream, the same video muxed with MP2 audio as TS)."""
    from .testing.gen import encode_test_stream
    from .testing.mp2_enc import encode_stream
    from .testing.ts_mux import mux_av
    w = int(rng.choice([48, 96, 160]))
    h = int(rng.choice([48, 64, 96]))
    n = int(rng.integers(2, 9))
    gop = int(rng.integers(1, 5))
    f_code = int(rng.integers(1, 5))
    es, chunks = encode_test_stream(w, h, n_frames=n,
                                    seed=int(rng.integers(1 << 30)),
                                    gop=gop, f_code=f_code,
                                    full_pel=bool(rng.integers(2)))
    _, af = encode_stream(int(rng.integers(1, 5)),
                          seed=int(rng.integers(1 << 30)))
    v = chunks[:-1]
    v[-1] += chunks[-1]
    return es, mux_av(v, 25.0, af, 1152, 44100)


def corrupt(ts: bytes, rng, mode: str) -> bytes:
    b = bytearray(ts)
    if mode == 'bitflips':
        for _ in range(int(rng.integers(1, 60))):
            b[int(rng.integers(0, len(b)))] ^= int(rng.integers(1, 256))
    elif mode == 'truncate':
        b = b[:int(rng.integers(0, len(b)))]
    elif mode == 'garbage_prefix':
        b = bytearray(rng.integers(0, 256, int(rng.integers(1, 5000)),
                                   dtype=np.uint8).tobytes()) + b
    elif mode == 'drop_packets':
        n = len(b) // 188
        keep = [i for i in range(n) if rng.random() > 0.1]
        b = bytearray(b''.join(bytes(b[i * 188:(i + 1) * 188])
                               for i in keep))
    elif mode == 'dup_packets':
        n = len(b) // 188
        out = bytearray()
        for i in range(n):
            pkt = bytes(b[i * 188:(i + 1) * 188])
            out += pkt
            if rng.random() < 0.08:
                out += pkt
        b = out
    elif mode == 'mix':
        for m in ('drop_packets', 'bitflips'):
            b = bytearray(corrupt(bytes(b), rng, m))
    else:
        raise ValueError(f'unknown corruption mode {mode!r}')
    return bytes(b)


def _host(p) -> tuple:
    return tuple(np.asarray(x.cpu() if hasattr(x, 'cpu') else x)
                 for x in p)


def frames_equal(tag: str, got, want) -> None:
    """Two lists of (y, cr, cb) host planes, frame for frame."""
    if len(got) != len(want):
        raise AssertionError(f'{tag}: {len(got)} frames against '
                             f'{len(want)}')
    for k, (g, w) in enumerate(zip(got, want)):
        for pn, a, b in zip(('y', 'cr', 'cb'), g, w):
            if a.shape != b.shape or not np.array_equal(a, b):
                raise AssertionError(f'{tag}: frame {k} plane {pn} differs')


def serial_frames(es: bytes) -> list:
    """The serial exact decode on the CPU: the Python parser, every
    picture through the serial path."""
    from .models.mpeg1 import MPEG1Decoder
    d = MPEG1Decoder({'device': 'cpu', 'native': False})
    d.write(0.0, es)
    return [_host(p) for p in d.decode_available(eof=True) or []]


def drain(ts_bytes: bytes, device) -> list:
    """The corrupted TS through the demuxer and the streaming decoders
    on `device` (audio on the host), in random chunks (resyncs, partial
    packets); then up to 64 video frames by decode(eof=True) and 64 audio
    frames.  Returns the video frames on the host."""
    from .demux import TSDemuxer
    from .models.mp2 import MP2Decoder
    from .models.mpeg1 import MPEG1Decoder
    dem = TSDemuxer()
    vid = MPEG1Decoder({'streaming': True, 'device': device})
    aud = MP2Decoder({'streaming': True})
    dem.connect(0xE0, vid)
    dem.connect(0xC0, aud)
    rng = np.random.default_rng(len(ts_bytes))
    pos = 0
    while pos < len(ts_bytes):
        step = int(rng.integers(1, 4096))
        dem.write(ts_bytes[pos:pos + step])
        pos += step
    dem.flush()
    frames = []
    for _ in range(64):
        p = vid.decode(eof=True)
        if p is None:
            break
        frames.append(_host(p))
    for _ in range(64):
        if aud.decode() is None:
            break
    return frames


def drain_round(ts_bytes: bytes, device) -> None:
    frames = drain(ts_bytes, device)
    if device.type != 'cpu':
        frames_equal(f'drain on {device} vs the CPU', frames,
                     drain(ts_bytes, CPU))


def differential(es: bytes, rng, device) -> None:
    """The clean stream through a random formulation on `device`, held
    to the serial exact decode on the CPU."""
    from .models.mpeg1 import MPEG1Decoder
    flags = {'native': bool(rng.integers(2)),
             'streaming': bool(rng.integers(2)),
             'per_frame': bool(rng.integers(2))}
    d = MPEG1Decoder({'device': device, 'native': flags['native'],
                      'streaming': flags['streaming']})
    d.write(0.0, es)
    if flags['per_frame']:
        got = []
        for _ in range(64):
            p = d.decode(eof=True)
            if p is None:
                break
            got.append(_host(p))
    else:
        got = [_host(p) for p in d.decode_available(eof=True) or []]
    want = serial_frames(es)
    if not want:
        raise AssertionError('differential: the clean stream decoded no '
                             'frame')
    frames_equal(f'differential {flags}', got, want)


# The mesh paths' refusals by policy (parallel/packed.py, parallel/tiles.py),
# told by their messages; any other error, a kernel's included, is a fault.
REFUSALS = ('needs the serial-exact path', 'needs the native parser',
            'MV reach needs', 'GOP not closed')


def _refusal(e: Exception) -> bool:
    return (isinstance(e, (RuntimeError, ValueError))
            and any(m in str(e) for m in REFUSALS))


def mesh_round(es: bytes, rng, device) -> tuple:
    """A random (g, t) mesh over `device`: t = 2 names the device twice
    ('cuda' and 'cuda:0', or 'cpu' and 'cpu:0'), two cells, so the
    picture decodes in bands.  decode_packed_mesh, where it refuses a
    stream for its MV reach or a GOP not closed, gives way to the product
    path decode_available(mesh=), which must fall back off the mesh;
    its refusal of a stream for the serial exact path, and
    decode_tiled_levels' refusals, stand.  Each decode is held to the
    serial one.  Returns (decodes compared, decodes refused)."""
    from .models.mpeg1 import MPEG1Decoder
    from .parallel.mesh import make_mesh
    from .parallel.packed import decode_packed_mesh
    from .parallel.tiles import decode_tiled_levels
    shapes = [(g, t) for g in (1, 2, 4) for t in (1, 2)]
    g, t = shapes[int(rng.integers(len(shapes)))]
    names = [str(device)] if t == 1 else [str(device), f'{device.type}:0']
    mesh = make_mesh(g, t, devices=names)
    want = serial_frames(es)
    tag = f'mesh {g}x{t}'
    compared = refused = 0
    try:
        got = decode_packed_mesh(es, mesh)
    except (RuntimeError, ValueError) as e:
        if not _refusal(e):
            raise
        refused += 1
        got = None
        if 'serial-exact' not in str(e):
            dm = MPEG1Decoder({'device': device})
            dm.write(0.0, es)
            got = dm.decode_available(eof=True, mesh=mesh) or []
            tag += ' (off-mesh fallback)'
    if got is not None:
        frames_equal(f'{tag} decode_packed_mesh', [_host(p) for p in got],
                     want)
        compared += 1
    try:
        tiled = decode_tiled_levels(es, mesh)
    except (RuntimeError, ValueError) as e:
        if not _refusal(e):
            raise
        return compared, refused + 1
    frames_equal(f'{tag} decode_tiled_levels', [_host(p) for p in tiled],
                 want)
    return compared + 1, refused


def _fleet(plan, device) -> tuple:
    """One fleet run of `plan` on `device`: (frames per stream on the
    host, each stream's dead reason)."""
    from .parallel.streams import MultiStreamDecoder
    feeds, steps, streaming, mode = plan
    n = len(feeds)
    dec = MultiStreamDecoder(n, batch_frames=4, quarantine=True,
                             streaming=streaming, mode=mode, device=device)
    frames = [[] for _ in range(n)]

    def harvest(outs):
        for i, st in enumerate(outs or []):
            for f in range(st.y.shape[0]):
                frames[i].append(_host((st.y[f], st.cr[f], st.cb[f])))

    pos = [0] * n
    for row in steps:
        for i, step in enumerate(row):
            dec.write(i, feeds[i][pos[i]:pos[i] + step])
            pos[i] += step
        harvest(dec.decode_batch())
    for i, fs in enumerate(dec.decode_all(eof=True)):
        frames[i].extend(_host(p) for p in fs)
    return frames, list(dec.dead)


def fleet_round(rng, mode: str, device) -> None:
    """A serving fleet under fire: 2-3 streams of one geometry, one
    corrupted in `mode`, through MultiStreamDecoder in quarantine posture
    (random mode and streaming).  Each clean stream that stays alive
    must equal its own serial decode; on the card every stream, the
    corrupted one too, must equal the same run on the CPU."""
    from .testing.gen import encode_test_stream
    w = int(rng.choice([48, 96]))
    h = int(rng.choice([48, 64]))
    n = int(rng.integers(2, 4))
    streams = [encode_test_stream(w, h, n_frames=int(rng.integers(2, 7)),
                                  seed=int(rng.integers(1 << 30)),
                                  gop=int(rng.integers(1, 4)))[0]
               for _ in range(n)]
    bad = int(rng.integers(n))
    feeds = [corrupt(s, rng, mode) if i == bad else s
             for i, s in enumerate(streams)]
    streaming = bool(rng.integers(2))
    fleet_mode = ('stacked', 'vmap', 'roundrobin')[int(rng.integers(3))]
    steps = []
    left = [len(f) for f in feeds]
    while any(x > 0 for x in left):
        row = [int(rng.integers(1, 2048)) for _ in range(n)]
        left = [x - s for x, s in zip(left, row)]
        steps.append(row)
    plan = (feeds, steps, streaming, fleet_mode)
    frames, dead = _fleet(plan, device)
    tag = f'fleet {fleet_mode} of {n}, stream {bad} corrupted'
    if device.type != 'cpu':
        cpu_frames, cpu_dead = _fleet(plan, CPU)
        if dead != cpu_dead:
            raise AssertionError(f'{tag}: dead {dead} on {device}, '
                                 f'{cpu_dead} on the CPU')
        for i in range(n):
            frames_equal(f'{tag}: stream {i} vs the CPU', frames[i],
                         cpu_frames[i])
    for i, es in enumerate(streams):
        if i == bad or dead[i]:
            continue
        frames_equal(f'{tag}: clean stream {i}', frames[i],
                     serial_frames(es))


def elastic_round(es: bytes, rng, device) -> None:
    """The elastic GOP decode on `device` with 3 workers, the one handed
    a random GOP SIGKILLed before it is sent: the re-queued GOP must
    still give the serial decode.  A fixture of one GOP gives way to a
    stream of 2-8 frames in 2 or more GOPs drawn here."""
    from .parallel.elastic import decode_gops_elastic
    from .parallel.multihost import index_gops
    from .testing.gen import encode_test_stream
    if len(index_gops(es)[1]) < 2:
        gop = int(rng.integers(1, 5))
        es = encode_test_stream(int(rng.choice([48, 96, 160])),
                                int(rng.choice([48, 64, 96])),
                                n_frames=int(rng.integers(gop + 1, 9)),
                                seed=int(rng.integers(1 << 30)), gop=gop,
                                f_code=int(rng.integers(1, 5)))[0]
    n_gops = len(index_gops(es)[1])
    if n_gops < 2:
        raise AssertionError(f'elastic: {n_gops} GOP in the drawn stream')
    victim = int(rng.integers(n_gops))
    killed = []

    def on_assign(worker_id, pid, gop_index):
        if gop_index == victim and not killed:
            os.kill(pid, signal.SIGKILL)
            killed.append(worker_id)

    _, frames = decode_gops_elastic(es, n_workers=3, on_assign=on_assign,
                                    device=device, timeout=300)
    if not killed:
        raise AssertionError(f'elastic: GOP {victim} was never handed out')
    frames_equal('elastic, one worker killed', frames, serial_frames(es))


def iteration(it: int, seed: int, device, done: dict) -> str:
    """Iteration `it` of the schedule; adds each round that completed to
    `done`, a mesh round only when it held a decode to the serial one,
    and the mesh decodes compared and refused to `mesh_compared` and
    `mesh_refused`.  Returns the corruption mode."""
    rng = np.random.default_rng(seed)
    mode = MODES[it % len(MODES)]
    es, ts = fixture(rng)
    drain_round(corrupt(ts, rng, mode), device)
    done['drain'] += 1
    if it % len(MODES) == 0:
        differential(es, rng, device)
        done['differential'] += 1
    if it % 3 == 1:
        fleet_round(rng, mode, device)
        done['fleet'] += 1
    if it % 6 == 4:
        compared, refused = mesh_round(es, rng, device)
        done['mesh_compared'] += compared
        done['mesh_refused'] += refused
        done['mesh'] += bool(compared)
    if it % 12 == 7:
        elastic_round(es, rng, device)
        done['elastic'] += 1
    return mode


def main(argv=None, stats: dict = None) -> int:
    """Run the soak; returns 1 if any iteration failed.  `stats`, when
    given, receives the iterations, failures, rounds completed by kind,
    seconds, the first seed and the device."""
    ap = argparse.ArgumentParser(prog='jsmpeg_tpu_torch.fuzz_soak',
                                 description=__doc__.split('\n\n')[0])
    ap.add_argument('--seconds', type=float, default=3600,
                    help='wall to run for (0: until stopped)')
    ap.add_argument('--log', default=DEFAULT_LOG,
                    help='JSON lines, one reproducer per failure')
    ap.add_argument('--seed', type=int, default=None,
                    help='first iteration seed (default: the clock)')
    ap.add_argument('--device', default='cuda',
                    help="device to decode on (default 'cuda'; 'cpu' runs "
                         'the plain versions of the kernels)')
    args = ap.parse_args(argv)
    from .config import resolve_device
    device = resolve_device(args.device, 'jsmpeg_tpu_torch.fuzz_soak')
    os.makedirs(os.path.dirname(os.path.abspath(args.log)), exist_ok=True)
    t0 = time.monotonic()
    t_end = t0 + args.seconds if args.seconds else None
    base = args.seed if args.seed is not None else int(time.time())
    done = dict.fromkeys(COUNTS, 0)
    it = fails = 0
    while t_end is None or time.monotonic() < t_end:
        seed = base + it
        mode = MODES[it % len(MODES)]
        try:
            iteration(it, seed, device, done)
        except Exception as e:                      # log + keep going
            fails += 1
            rec = {'seed': seed, 'mode': mode, 'error': repr(e),
                   'trace': traceback.format_exc()[-2000:]}
            with open(args.log, 'a') as f:
                f.write(json.dumps(rec) + '\n')
            print(f'FAIL it={it} seed={seed} mode={mode}: {e!r}',
                  flush=True)
        it += 1
        if it % 25 == 0:
            print(f'{it} iterations, {fails} failures', flush=True)
    print(f'done: {it} iterations, {fails} failures, rounds {done}',
          flush=True)
    if stats is not None:
        stats.update(iterations=it, failures=fails, rounds=done,
                     seconds=time.monotonic() - t0, seed=base,
                     device=str(device))
    return 1 if fails else 0


if __name__ == '__main__':
    sys.exit(main())

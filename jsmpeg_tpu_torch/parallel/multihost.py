"""Multi-process decode: each process (rank) parses and decodes only its
own block of closed GOPs (the port of jsmpeg_tpu/parallel/multihost.py).

  1. `initialize` joins N processes into one `torch.distributed` process
     group (gloo: two NCCL ranks cannot share one card, and no tensor
     crosses processes here).  The program gives it the address, the
     world size and its rank.
  2. Every rank runs `index_gops`, a start-code scan (no VLC work), to
     find the byte range of every closed GOP, then VLC-parses only its
     own contiguous block of GOPs.
  3. The rank decodes its GOPs over a local parallel.mesh.Mesh of its
     devices (parallel/packed.MeshPackedDecoder: GOP rows and, with
     n_tile > 1, the picture's bands).

jsmpeg_tpu agrees static bucket sizes across hosts with an allgather
(`_agree_maxima`) so that every process compiles one program; the port
runs eagerly at each batch's own sizes, so the ranks have nothing to
agree on and exchange nothing.

  python -m jsmpeg_tpu_torch.parallel.multihost tcp://127.0.0.1:29500 \\
      WORLD RANK stream.es out.npz [--n-tile T] [--device cpu]

decodes the rank's GOPs of an elementary stream and writes its frames
(`frames`, `y`, `cr`, `cb`) to out.npz, then prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

_PIC_START = 0x00
_SEQ_START = 0xB3
_GOP_START = 0xB8
_EXT_START = 0xB5
_USER_START = 0xB2


def _scan_start_codes(es: bytes):
    """Yield (byte_offset, code) for every 00 00 01 xx in the stream."""
    pos = 0
    find = es.find
    while True:
        pos = find(b'\x00\x00\x01', pos)
        if pos < 0 or pos + 3 >= len(es):
            return
        yield pos, es[pos + 3]
        pos += 3


def index_gops(es: bytes) -> Tuple[bytes, List[Tuple[int, int, int]]]:
    """Cheap GOP index: start-code scan only (no VLC decode).

    Returns (header, ranges): `header` is the prefix holding the first
    sequence header (+ quant matrices), and ranges is a list of
    (start, end, n_frames) byte ranges, one per closed GOP, where
    n_frames counts only the I/P pictures the decoder emits (B/D skip,
    cf. jsmpeg/src/mpeg1.js:182-184).  A GOP starts at the
    GOP/repeat-sequence headers immediately preceding an I picture
    (picture_coding_type read at a fixed bit offset -- no VLC)."""
    seen_seq = False
    pending_hdr: Optional[int] = None
    gop_starts: List[int] = []
    pic_counts: List[int] = []
    first_pic = None
    for pos, code in _scan_start_codes(es):
        if code == _SEQ_START:
            if seen_seq:                 # mid-stream repeat header
                if pending_hdr is None:
                    pending_hdr = pos
            else:                        # the initial header stays in the
                seen_seq = True          # shared prefix
                pending_hdr = None
        elif code == _GOP_START:
            if pending_hdr is None:
                pending_hdr = pos
        elif code == _PIC_START:
            if first_pic is None:
                first_pic = pos
            if pos + 5 < len(es):
                # 10 bits temporal_reference then 3 bits coding type,
                # starting right after the 32-bit start code
                b = (es[pos + 4] << 8) | es[pos + 5]
                pic_type = (b >> 3) & 7
            else:
                pic_type = 0
            if pic_type == 1 or not gop_starts:
                gop_starts.append(pending_hdr
                                  if pending_hdr is not None else pos)
                pic_counts.append(0)
            if pic_type in (1, 2):       # I/P only: what the decoder emits
                pic_counts[-1] += 1
            pending_hdr = None
        elif code not in (_EXT_START, _USER_START):
            pending_hdr = None           # slice/other codes break the run
    if first_pic is None or not seen_seq:
        return es, []
    header = es[:gop_starts[0]]
    ends = gop_starts[1:] + [len(es)]
    return header, [(s, e, n)
                    for (s, e, n) in zip(gop_starts, ends, pic_counts)]


def parse_gop_range(header: bytes, es: bytes, start: int, end: int):
    """VLC-parse one GOP byte range into per-frame packed dicts (the
    shared header prefix re-primes a fresh parser for each range)."""
    from ..host import best_parser
    from .packed import split_packed_frames
    parser = best_parser()
    parser.write(header + es[start:end])
    frames: List[dict] = []
    while True:
        b = parser.parse_batch(32, eof=True)
        if b == 'fallback' or (isinstance(b, dict) and 'sp_pos' not in b):
            raise RuntimeError('GOP range needs the serial-exact path')
        if b is None:
            break
        frames.extend(split_packed_frames(b))
        if b['n'] < 32:
            break
    return parser.seq, frames


def initialize(address: str, world_size: int, rank: int) -> None:
    """Join the process group: `address` is its rendezvous
    ('tcp://host:port'), the same in every process."""
    import torch.distributed as dist
    dist.init_process_group('gloo', init_method=address,
                            world_size=world_size, rank=rank)


def _rank_world() -> Tuple[int, int]:
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def rank_gops(n_gops: int, world: int, rank: int, n_gop_local: int):
    """The GOP rows of `rank`: jsmpeg_tpu pads the n_gops GOPs to
    G = ceil(n_gops / n_gop_axis) * n_gop_axis rows (n_gop_axis = world *
    n_gop_local) and gives each rank a contiguous block of G // world.
    Rows past n_gops are padding."""
    n_axis = world * n_gop_local
    G = max(1, -(-n_gops // n_axis)) * n_axis
    per = G // world
    return range(rank * per, (rank + 1) * per)


def decode_packed_multihost(es: bytes, n_tile: int = 1,
                            devices: Optional[Sequence] = None,
                            f_code: int = 2):
    """Decode this rank's GOPs of an elementary stream.  Every rank
    indexes the whole stream, parses only its block of GOPs (`rank_gops`
    with n_gop_local = len(devices) // n_tile, as jsmpeg_tpu lays its
    global mesh out) and decodes them over make_mesh(n_gop_local,
    n_tile, devices).  devices: this rank's devices, by default every
    visible CUDA device (raises without a card); ['cpu'] on the CPU.
    Without a process group the caller is rank 0 of 1.

    Returns (seq, frame_indices, planes): the global frame numbers this
    rank decoded and their planes as host numpy (y, cr, cb)."""
    from ..config import resolve_device
    from ..ops.frame import Planes
    from .mesh import make_mesh
    from .packed import MeshPackedDecoder, gop_closed

    if devices is None:
        resolve_device(None, 'decode_packed_multihost')
        devices = [torch.device('cuda', i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if len(devices) % n_tile:
        raise ValueError(f'{len(devices)} devices do not split into tile '
                         f'rows of {n_tile}')
    header, ranges = index_gops(es)
    if not ranges:
        return None, [], []
    rank, world = _rank_world()
    n_gop_local = len(devices) // n_tile
    seq, mine = None, {}
    for gi in rank_gops(len(ranges), world, rank, n_gop_local):
        if gi < len(ranges):
            s, e, _ = ranges[gi]
            seq, frames = parse_gop_range(header, es, s, e)
            if not gop_closed(frames):
                raise ValueError(
                    f'GOP {gi} not closed (slice-gap frame exposes pre-GOP '
                    'plane content): the multi-process decode cannot '
                    'thread pre-GOP state; use parallel.elastic (prefix '
                    'fallback) or the serial pipeline for this stream')
            mine[gi] = frames
    if seq is None:                       # padding rows only
        return parse_gop_range(header, es, 0, 0)[0], [], []
    mesh = make_mesh(n_gop_local, n_tile, devices=devices)
    dec = MeshPackedDecoder(mesh, seq, f_code=f_code)
    outs, gl, _ = dec.decode([f for gi in sorted(mine) for f in mine[gi]])
    base = np.concatenate([[0], np.cumsum([r[2] for r in ranges])])
    indices = [int(base[gi] + fi) for gi in sorted(mine)
               for fi in range(len(mine[gi]))]
    planes = [Planes(*[x[fi].cpu().numpy() for x in p]) for p in outs
              for fi in range(p.y.shape[0])]
    return seq, indices, planes


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog='python -m jsmpeg_tpu_torch.parallel.multihost',
        description="Decode this rank's GOPs of an MPEG1 elementary stream "
                    'in a process group (torch.distributed, gloo).')
    ap.add_argument('address', help="the group's rendezvous, "
                                    'tcp://host:port')
    ap.add_argument('world', type=int)
    ap.add_argument('rank', type=int)
    ap.add_argument('es', help='elementary stream file')
    ap.add_argument('out', help='npz of the decoded frames')
    ap.add_argument('--n-tile', type=int, default=1)
    ap.add_argument('--device', action='append',
                    help="a device of this rank (repeat for several; "
                         "default every visible CUDA device)")
    ap.add_argument('--f-code', type=int, default=2)
    a = ap.parse_args(argv)
    from ..ops import kernels
    try:
        initialize(a.address, a.world, a.rank)
        with open(a.es, 'rb') as f:
            es = f.read()
        kernels.reset_launches()
        _, indices, planes = decode_packed_multihost(
            es, n_tile=a.n_tile, devices=a.device, f_code=a.f_code)
    except (RuntimeError, ValueError) as e:
        print(f'multihost rank {a.rank}: {e}', file=sys.stderr)
        return 1
    stack = lambda i: (np.stack([p[i] for p in planes]) if planes
                       else np.zeros((0, 0, 0), np.uint8))
    np.savez(a.out, frames=np.asarray(indices, np.int64), y=stack(0),
             cr=stack(1), cb=stack(2))
    print(json.dumps({'rank': a.rank, 'world': a.world,
                      'n_tile': a.n_tile, 'frames': indices,
                      'launches': dict(kernels.launches)}), flush=True)
    import torch.distributed as dist
    dist.destroy_process_group()
    return 0


if __name__ == '__main__':
    sys.exit(main())

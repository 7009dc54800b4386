"""Thumbnail extraction: every (Nth) I picture of a video, decoded in
batches on the device and written as PNG/PPM files.

A capability the reference cannot offer: its decoder walks the stream
serially, so thumbnailing an hour of video costs an hour of decode.
Here I pictures are self-contained (every MB intra-coded), so the
selected pictures are joined into packed batches of up to
`MPEG1Decoder.BATCH_FRAMES` and decode with one K1 and one K2 launch per
batch: no P picture is decoded.

Usage:
  python -m jsmpeg_tpu_torch.thumbs clip.ts -o thumb_%03d.png \\
      [--every N] [--limit K] [--device cuda]

Decoding runs on the GPU ('cuda') unless --device names another device;
without a GPU the default exits non-zero.
"""

from __future__ import annotations

import argparse
import sys
import time


def extract_iframe_planes(es: bytes, every: int = 1, limit: int = 0,
                          device=None):
    """Decode every `every`-th I picture of an elementary stream (at most
    `limit` of them when limit > 0).  Returns (seq, [Planes]) in stream
    order, the planes on `device` (None = 'cuda', which raises without a
    GPU)."""
    import numpy as np
    import torch

    from .config import resolve_device
    from .host import best_parser
    from .models.mpeg1 import (MPEG1Decoder, decode_levels, upload,
                               upload_packed)
    from .ops.frame import Planes
    from .parallel.packed import merge_packed_frames, split_packed_frames

    device = resolve_device(device, 'extract_iframe_planes')
    parser = best_parser()
    parser.write(es)
    if not hasattr(parser, 'parse_batch'):
        raise RuntimeError('thumbnail extraction needs the native parser')
    iframes = []
    n_i = 0
    while True:
        b = parser.parse_batch(32, eof=True)
        if b == 'fallback' or not isinstance(b, dict):
            break
        if 'sp_pos' not in b:
            raise RuntimeError('stream needs the serial-exact path')
        for f in split_packed_frames(b):
            if f['pic_type'] == 1:          # I picture
                if n_i % every == 0:
                    iframes.append(f)
                n_i += 1
        if b['n'] < 32:
            break
        if limit and len(iframes) >= limit:
            break
    if limit:
        iframes = iframes[:limit]
    seq = parser.seq
    if not iframes or seq is None:
        return seq, []

    # every MB of an I picture is intra, so its output reads no reference
    # plane; the carry runs through the chunks all the same, so a
    # picture with a slice gap shows what one scan over the whole
    # selection would (jsmpeg_tpu's tools/thumbs.py)
    cw, ch = seq.coded_width, seq.coded_height
    z = lambda hh, ww: torch.zeros((hh, ww), dtype=torch.uint8,
                                   device=device)
    cur = Planes(z(ch, cw), z(ch >> 1, cw >> 1), z(ch >> 1, cw >> 1))
    fwd = cur
    iq, nq = (torch.as_tensor(np.asarray(q, np.int32), device=device)
              for q in (seq.intra_quant_matrix, seq.non_intra_quant_matrix))
    put = lambda a: upload(a, device)
    out = []
    step = MPEG1Decoder.BATCH_FRAMES
    for k in range(0, len(iframes), step):
        la = upload_packed(merge_packed_frames(iframes[k:k + step]),
                           seq.mb_size, put)
        cur, fwd, outs = decode_levels(cur, fwd, la, iq, nq)
        out += list(outs)
    return seq, out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog='jsmpeg_tpu_torch.thumbs',
        description='batched I-picture thumbnail extraction on the GPU')
    ap.add_argument('source', help='.ts path')
    ap.add_argument('-o', '--out', default='thumb_%03d.png',
                    help='output pattern (%%d; .png or .ppm)')
    ap.add_argument('--every', type=int, default=1,
                    help='take every Nth I picture (default every one)')
    ap.add_argument('--limit', type=int, default=0,
                    help='stop after K thumbnails')
    ap.add_argument('--device', default='cuda',
                    help="device to decode on (default 'cuda'; 'cpu' runs "
                         'the plain versions of the kernels)')
    args = ap.parse_args(argv)

    if args.every < 1:
        ap.error('--every must be >= 1')

    from .config import resolve_device
    from .demux import demux_to_es
    from .ops.color import ycbcr_to_rgb_int
    from .sinks import write_image

    try:
        device = resolve_device(args.device, 'jsmpeg_tpu_torch.thumbs')
    except RuntimeError as e:
        print(e, file=sys.stderr)
        return 1
    with open(args.source, 'rb') as f:
        data = f.read()
    stream = demux_to_es(data)

    t0 = time.monotonic()
    seq, planes = extract_iframe_planes(stream, args.every, args.limit,
                                        device=device)
    if not planes:
        print('no I-frames found')
        return 1
    w, h = seq.width, seq.height
    for i, p in enumerate(planes):
        rgb = ycbcr_to_rgb_int(p.y, p.cr, p.cb, w, h)
        write_image(args.out % i, rgb.cpu().numpy())
    dt = time.monotonic() - t0
    print(f'{len(planes)} thumbnails ({w}x{h}) in {dt:.2f}s '
          f'({len(planes) / dt:.1f} thumbs/s)')
    return 0


if __name__ == '__main__':
    raise SystemExit(main())

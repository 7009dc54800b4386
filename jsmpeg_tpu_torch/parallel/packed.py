"""The packed wire per frame, and the packed-wire mesh decode (the port
of jsmpeg_tpu/parallel/packed.py).

A packed `parse_batch` dict holds one batch's streams back to back; the
parser also records each frame's share of them (`pairs_pf`, `runs_pf`,
`escs_pf`).  `split_packed_frames` cuts a batch into per-frame dicts and
`merge_packed_frames` joins any selection of them into a batch dict that
`models.mpeg1.build_fused_buffer` takes (thumbnails pick the I pictures
this way).  These host helpers are copies of jsmpeg_tpu's.

`MeshPackedDecoder` decodes closed GOPs of per-frame dicts over a
parallel.mesh.Mesh: each device's GOPs become the segments of one joint
wire (parallel/streams.stack_stream_frames) and one K1 + K2 launch pair
(parallel/streams.decode_segments); a gop row whose tile cells sit on
distinct devices decodes its pictures in bands (parallel/tiles.
decode_bands), each picture's wire split per band (`split_frame_tiles`).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..models.mpeg1 import levels_blocks, upload, upload_packed
from ..ops.frame import Planes
from .gop import _seed_planes, split_at_iframes
from .tiles import (batch_max_abs_mv, decode_bands, halo_mb_for_mvs,
                    halo_mb_rows)

_POPCOUNT8 = np.array([bin(x).count('1') for x in range(256)], np.uint8)

# one RLE run covers at most 65535 MBs (u16 wire field); a tile slab of a
# single picture never comes close (720p is 3600 MBs total)
_RUN_CAP = 0xFFFF


def split_packed_frames(batch: dict) -> List[dict]:
    """Slice a packed parse_batch dict into per-frame packed dicts using
    the per-frame counts the parser records."""
    n = batch['n']
    pp = np.concatenate([[0], np.cumsum(batch['pairs_pf'])]).astype(np.int64)
    rr = np.concatenate([[0], np.cumsum(batch['runs_pf'])]).astype(np.int64)
    ee = np.concatenate([[0], np.cumsum(batch['escs_pf'])]).astype(np.int64)
    # the per-frame cumulative counts cover frames [0, n); frame n-1's
    # streams end at the batch totals
    pp = np.append(pp[:n], len(batch['sp_pos']))
    rr = np.append(rr[:n], len(batch['run_len']))
    ee = np.append(ee[:n], len(batch['sp_esc']))
    out = []
    for i in range(n):
        out.append(dict(
            run_len=batch['run_len'][rr[i]:rr[i + 1]],
            run_flags=batch['run_flags'][rr[i]:rr[i + 1]],
            run_cbp=batch['run_cbp'][rr[i]:rr[i + 1]],
            run_mv=batch['run_mv'][rr[i]:rr[i + 1]],
            sp_pos=batch['sp_pos'][pp[i]:pp[i + 1]],
            sp_v8=batch['sp_v8'][pp[i]:pp[i + 1]],
            sp_esc=batch['sp_esc'][ee[i]:ee[i + 1]],
            pic_type=int(batch['pic_types'][i])))
    return out


def _rle(fl: np.ndarray, cb: np.ndarray, mv: np.ndarray):
    """Re-run-length-encode per-MB (flags, cbp, mv) streams (runs of
    identical tuples, the parser's wire invariant)."""
    n = len(fl)
    if n == 0:
        return (np.zeros(0, np.uint16), np.zeros(0, np.uint8),
                np.zeros(0, np.uint8), np.zeros((0, 2), np.int16))
    change = np.ones(n, bool)
    change[1:] = ((fl[1:] != fl[:-1]) | (cb[1:] != cb[:-1])
                  | (mv[1:] != mv[:-1]).any(axis=1))
    starts = np.flatnonzero(change)
    lens = np.diff(np.append(starts, n))
    if lens.max(initial=0) > _RUN_CAP:           # split over-long runs
        reps = -(-lens // _RUN_CAP)
        starts = np.repeat(starts, reps)
        lens = np.repeat(lens, reps)
        k = np.concatenate([np.arange(r) for r in reps])
        lens = np.minimum(lens - k * _RUN_CAP, _RUN_CAP)
    return (lens.astype(np.uint16), fl[starts], cb[starts], mv[starts])


def split_frame_tiles(fr: dict, n_mb: int, mb_w: int, mb_h_local: int,
                      n_tile: int) -> List[dict]:
    """Split one picture's packed streams into n_tile per-slab dicts (the
    wire of tile cells on distinct devices; tile cells on one device take
    the whole picture).

    Tile t owns MB rows [t*mb_h_local, (t+1)*mb_h_local) of the padded
    grid; slabs beyond the real mb_h are padding runs (flags=0: not
    written, not coded -- cropped from the output)."""
    mpt = mb_h_local * mb_w
    run_len = fr['run_len'].astype(np.int64)
    fl_mb = np.repeat(fr['run_flags'], run_len)
    cb_mb = np.repeat(fr['run_cbp'], run_len)
    mv_mb = np.repeat(fr['run_mv'], run_len, axis=0)
    blk_per_mb = _POPCOUNT8[cb_mb]
    cum_blk = np.concatenate([[0], np.cumsum(blk_per_mb)]).astype(np.int64)
    sp_pos = fr['sp_pos']
    starts = np.flatnonzero(sp_pos & 0x80)       # block-start pair indices
    esc_cum = np.concatenate(
        [[0], np.cumsum(fr['sp_v8'] == -128)]).astype(np.int64)
    n_pairs = len(sp_pos)
    tiles = []
    for t in range(n_tile):
        a = min(t * mpt, n_mb)
        b = min((t + 1) * mpt, n_mb)
        rl, rf, rc, rm = _rle(fl_mb[a:b], cb_mb[a:b], mv_mb[a:b])
        pad = mpt - (b - a)
        if pad:
            k = -(-pad // _RUN_CAP)
            pl = np.full(k, _RUN_CAP, np.int64)
            pl[-1] = pad - (k - 1) * _RUN_CAP
            rl = np.concatenate([rl, pl.astype(np.uint16)])
            rf = np.concatenate([rf, np.zeros(k, np.uint8)])
            rc = np.concatenate([rc, np.zeros(k, np.uint8)])
            rm = np.concatenate([rm, np.zeros((k, 2), np.int16)])
        b0, b1 = cum_blk[a], cum_blk[b]
        p0 = starts[b0] if b0 < len(starts) else n_pairs
        p1 = starts[b1] if b1 < len(starts) else n_pairs
        tiles.append(dict(
            run_len=rl, run_flags=rf, run_cbp=rc, run_mv=rm,
            sp_pos=sp_pos[p0:p1], sp_v8=fr['sp_v8'][p0:p1],
            sp_esc=fr['sp_esc'][esc_cum[p0]:esc_cum[p1]],
            n_blocks=int(b1 - b0)))
    return tiles


def gop_closed(gop_frames: List[dict]) -> bool:
    """True when this GOP is an independent decode unit.

    Reference semantics: a macroblock covered by no slice (a slice gap --
    non-conformant but decodable; the reference leaves the plane's stale
    pixels, frame n-2 after the double-buffer swap) exposes PRE-GOP
    content when it sits in the GOP's leading I or first P frame: during
    those two frames the 'current' buffer still holds pixels from before
    the GOP's I refresh.  From frame 2 on the stale buffer is the GOP's
    own frame n-2, which the per-GOP decode carries correctly.  Uncovered
    MB <=> run_flags has neither written (0x40) nor intra (0x20).  This
    predicate guards every GOP-parallel path (jsmpeg_tpu's fuzz soak
    found a slice-gap P frame that decoded differently GOP-parallel)."""
    for f in gop_frames[:2]:
        fl = f.get('run_flags') if isinstance(f, dict) else None
        if fl is not None:
            if len(fl) and bool(((fl & 0x60) == 0).any()):
                return False
            continue
        # FrameData-style objects (gop.py paths)
        w = np.asarray(f['written'] if isinstance(f, dict) else f.written)
        i = np.asarray(f['intra'] if isinstance(f, dict) else f.intra)
        if not bool((w | i).all()):
            return False
    return True


def gops_all_closed(frames: List[dict]) -> bool:
    """gop_closed over every GOP of a frame list (split at I pictures)."""
    pick = (lambda f: f['pic_type']) if isinstance(frames[0], dict) \
        else (lambda f: f.pic_type)
    return all(gop_closed(g) for g in split_at_iframes(frames, pick))


def merge_packed_frames(frames: List[dict]) -> dict:
    """Per-frame packed dicts (split_packed_frames output) -> one batch
    dict usable by the single-device packed pipeline."""
    batch = _concat_cell(frames, len(frames))
    batch['n_blocks'] = int(sum(
        (_POPCOUNT8[f['run_cbp']] * f['run_len'].astype(np.int64)).sum()
        for f in frames))
    batch['pic_types'] = np.array([f['pic_type'] for f in frames], np.uint8)
    return batch


def _concat_cell(frames: List[dict], n: int) -> dict:
    """Concatenate per-frame streams into a batch dict (the
    build_fused_buffer contract)."""
    cat = lambda k: (np.concatenate([f[k] for f in frames]) if frames
                     else np.zeros(0))
    return dict(
        n=n,
        run_len=cat('run_len').astype(np.uint16),
        run_flags=cat('run_flags').astype(np.uint8),
        run_cbp=cat('run_cbp').astype(np.uint8),
        run_mv=(np.concatenate([f['run_mv'] for f in frames])
                if frames else np.zeros((0, 2))).astype(np.int16),
        sp_pos=cat('sp_pos').astype(np.uint8),
        sp_v8=cat('sp_v8').astype(np.int8),
        sp_esc=cat('sp_esc').astype(np.int16),
        n_blocks=sum(f.get('n_blocks', 0) for f in frames))


class MeshPackedDecoder:
    """Decodes closed GOPs of per-frame packed dicts over a Mesh.

    The GOPs of one device stack along macroblock rows as the segments
    of ONE joint wire and ONE K1 + K2 launch pair (seg_frames = the GOP
    lengths; the frame axis is the longest GOP, no padding GOPs or
    frames are launched).  The lattice limit of models.mpeg1 splits a
    device's segments into more launch pairs only when it must
    (parallel/streams.decode_segments).  A gop row whose tile cells sit
    on distinct devices decodes its GOPs in n_tile bands
    (parallel/tiles.decode_bands: K1 once per device, then per frame one
    K2 band launch per band and a halo exchange), its frames joined on
    the row's first device.  halo_for / fits_mesh are jsmpeg_tpu's,
    computed on its padded tile bands, so the port goes off mesh exactly
    when jsmpeg_tpu does; motion clamps at the stream's real height.

    device: where the returned carry lives (the caller's decoder; None =
    the first gop row's device)."""

    def __init__(self, mesh, seq, f_code: int = 2, device=None):
        self.mesh = mesh
        self.seq = seq
        self.n_gop = mesh.shape['gop']
        self.n_tile = mesh.shape['tile']
        rows = mesh.gop_devices()
        self.device = torch.device(device) if device is not None else rows[0]
        self.mb_h = seq.mb_height
        self.mb_w = seq.mb_width
        self.mb_h_pad = -(-self.mb_h // self.n_tile) * self.n_tile
        self.mb_h_local = self.mb_h_pad // self.n_tile
        # floor from the declared f_code; halo_for raises it to the
        # batch's ACTUAL MV reach (covers f_code > 2 / full_pel streams)
        self.halo_mb = halo_mb_rows(f_code)
        self._quant: dict = {}

    def halo_for(self, frames: List[dict]) -> int:
        """Halo (MB rows) this batch needs: the declared-f_code floor
        raised to the data's MV reach.  Callers check it against
        mb_h_local (fits_mesh) before decode()."""
        return max(self.halo_mb, halo_mb_for_mvs(batch_max_abs_mv(frames)))

    def fits_mesh(self, frames: List[dict]) -> bool:
        return self.halo_for(frames) <= self.mb_h_local

    def _quant_on(self, device: torch.device):
        if device not in self._quant:
            self._quant[device] = tuple(
                torch.as_tensor(np.asarray(q, np.int32), device=device)
                for q in (self.seq.intra_quant_matrix,
                          self.seq.non_intra_quant_matrix))
        return self._quant[device]

    def _band_blocks(self, gops: List[list], n_band: int):
        """decode_bands' blocks_of for these GOPs in n_band bands: the
        listed bands' per-picture wire slabs (`split_frame_tiles`) as the
        segments of one joint wire, uploaded and unpacked on the device,
        then K1 over them."""
        from .streams import stack_stream_frames
        n_mb = self.mb_h * self.mb_w
        mpt = -(-self.mb_h // n_band) * self.mb_w
        slabs = [[split_frame_tiles(f, n_mb, self.mb_w, mpt // self.mb_w,
                                    n_band) for f in g] for g in gops]
        n_frames = max(len(g) for g in gops)

        def blocks_of(dev, bands):
            cells = [[fr[t] for fr in g] for t in bands for g in slabs]
            joint, _ = stack_stream_frames(cells, mpt, n_frames)
            la = upload_packed(joint, len(cells) * mpt,
                               lambda x: upload(x, dev))
            return levels_blocks(la, *self._quant_on(dev))
        return blocks_of

    def decode(self, frames: List[dict], init: Optional[Tuple] = None):
        """frames: per-frame packed dicts (split_packed_frames output);
        init: the (cur, fwd) carry a mid-GOP first frame continues from.

        Returns (outs, gop_lengths, carry): outs holds one Planes per GOP
        ([n_i, H, W] on the device that decoded it, or where its bands
        joined), frame fi of GOP gi being input frame
        sum(gop_lengths[:gi]) + fi; carry is the last GOP's (cur, fwd) on
        self.device."""
        from .streams import decode_segments, stack_stream_frames
        gops = split_at_iframes(frames, lambda f: f['pic_type'])
        for gop in gops:
            if not gop_closed(gop):
                raise ValueError(
                    'GOP not closed: a slice-gap macroblock in its '
                    'leading I / first P frame exposes pre-GOP plane '
                    'content (reference stale-pixel semantics); decode '
                    'these frames off-mesh (callers: check '
                    'gops_all_closed() / fits_mesh() first)')
        halo_mb = self.halo_for(frames)
        if halo_mb > self.mb_h_local:
            raise ValueError(
                f'MV reach needs {halo_mb} MB rows of halo > '
                f'{self.mb_h_local} rows per tile; decode these frames '
                f'off-mesh (callers: check fits_mesh() first)')
        n_mb = self.mb_h * self.mb_w
        h, w = self.mb_h * 16, self.mb_w * 16
        outs: list = [None] * len(gops)
        carry = None
        for bands, idx in self.mesh.gop_groups(len(gops)).items():
            local = [gops[i] for i in idx]
            seed = init if idx[0] == 0 else None
            if len(bands) > 1:          # tile cells on distinct devices
                planes, last = decode_bands(
                    bands, [len(g) for g in local], self.mb_h, self.mb_w,
                    halo_mb, self._band_blocks(local, len(bands)), seed)
            else:
                dev = bands[0]

                def levels_of(a, b, n_frames, local=local, dev=dev):
                    joint, _ = stack_stream_frames(local[a:b], n_mb,
                                                   n_frames)
                    return upload_packed(joint, (b - a) * n_mb,
                                         lambda x: upload(x, dev))

                cur, fwd = _seed_planes(seed, len(idx), h, w, dev)
                cur, fwd, planes = decode_segments(
                    cur, fwd, [len(g) for g in local], n_mb, levels_of,
                    self._quant_on(dev))
                last = tuple(Planes(*[x.chunk(len(idx))[-1] for x in p])
                             for p in (cur, fwd))
            for i, p in zip(idx, planes):
                outs[i] = p
            if idx[-1] == len(gops) - 1:
                carry = tuple(Planes(*[x.to(self.device) for x in p])
                              for p in last)
        return outs, [len(g) for g in gops], carry


def decode_packed_mesh(es: bytes, mesh, f_code: int = 2) -> List[Planes]:
    """Parse an elementary stream with the native packed parser and
    decode it over the mesh.  Returns per-frame planes in input order
    (library/test entry; the Player goes through
    MPEG1Decoder.decode_available(mesh=...))."""
    from ..host import best_parser
    parser = best_parser()
    parser.write(bytes(es))
    if not hasattr(parser, 'parse_batch'):
        raise RuntimeError('packed mesh decode needs the native parser')
    frames: List[dict] = []
    while True:
        b = parser.parse_batch(32, eof=True)
        if b == 'fallback' or (isinstance(b, dict) and 'sp_pos' not in b):
            raise RuntimeError('stream needs the serial-exact path')
        if b is None:
            break
        frames.extend(split_packed_frames(b))
        if b['n'] < 32:
            break
    if not frames:
        return []
    dec = MeshPackedDecoder(mesh, parser.seq, f_code=f_code)
    outs, _, _ = dec.decode(frames)
    return [Planes(*[x[fi] for x in p]) for p in outs
            for fi in range(p.y.shape[0])]

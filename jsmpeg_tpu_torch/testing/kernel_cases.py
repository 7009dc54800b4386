"""The kernels' named cases at the port's operating point, one copy for
the rigs that hold the kernels to their plain versions on the card:
chip_smoke.py's d_k2_check / d_k3_check / h_kernel_detail and the
checked rig (host/native/sanitize_check.py `--checked`).

The main stream is 96 frames of 1280x720 in GOPs of 12 from seed 3
(`testing.gen.encode_realistic_stream`), parsed in batches of 32.  The
builders read this module's constants when called, so a CPU rehearsal
may lower them on the module (tests/test_torch_checked.py does)."""

from __future__ import annotations

import numpy as np

W, H = 1280, 720            # the operating point: 3600 macroblocks
N_FRAMES, GOP, SEED = 96, 12, 3
BATCH = 32                  # MPEG1Decoder.BATCH_FRAMES
K2_CHECK_FRAMES = 8         # frames of the K2 batch check
# the segmented K2 check: four 720p streams stacked, one frame count each
K2_SEGMENTS, K2_SEG_FRAMES = 4, [K2_CHECK_FRAMES, 0, 5, 1]
# the band check: a picture of 44 macroblock rows (the last band holds a
# padding row) in 3 bands, 2 segments (one past its frame count), a halo
# of 2 macroblock rows
K2_BANDS, K2_BAND_MB_H, K2_BAND_SEGS, K2_BAND_HALO = 3, 44, 2, 2
K3_CHECK_FRAMES = 8         # frames of K3's random 720p wires
K3_DENSE_FRAMES = 4         # frames of K3's coefficient-dense 720p wire
K3_OFF_TILE_MB = 79 * 45    # macroblocks of K3's stack off its write tile


def stream_quant(es: bytes):
    """The stream's (intra, non-intra) quant matrices, int32 [64] each."""
    from ..models.mpeg1 import MPEG1Decoder
    parser = MPEG1Decoder({'device': 'cpu'}).parser
    parser.write(es)
    parser.parse_batch(BATCH, eof=True)       # the sequence header
    return (np.asarray(parser.seq.intra_quant_matrix, np.int32),
            np.asarray(parser.seq.non_intra_quant_matrix, np.int32))


def k3_retire_overwritten(bufs: np.ndarray, sizes) -> np.ndarray:
    """The wires [S, L] with bit 6 set on every pair that a later pair of
    its coded-block ordinal overwrites (same position, both with bit 6
    clear): the last-wins reference of wires whose blocks name a position
    twice, since the plain version's scatter with repeated indices picks
    no defined winner on the card.  Bit 6 changes no count: ordinals,
    escapes and the last live pair stay."""
    F, n_mb, n_runs, wide, n_pairs, _, n_blk = sizes
    o_pos = F + (F * n_mb + 7) // 8 + (8 if wide else 4) * n_runs
    out = bufs.copy()
    for buf in out:
        pos = buf[o_pos:o_pos + n_pairs]
        live = np.flatnonzero((pos & 0x40) == 0)
        ordinal = np.clip(np.cumsum(pos >> 7) - 1, 0, n_blk - 1)
        key = ordinal[live].astype(np.int64) * 64 + (pos[live] & 63)
        _, last = np.unique(key[::-1], return_index=True)
        keep = np.zeros(len(live), bool)
        keep[len(live) - 1 - last] = True
        pos[live[~keep]] |= 0x40
    return out


def k3_cases(es: bytes) -> list:
    """d_k3_check's wires: (name, host wires uint8 [S, L], sizes (F, n_mb,
    n_runs, mv_wide, n_pairs, n_esc, n_blk), the wires its plain version
    is held on).  The main stream's three packed batches as the decoder
    builds them; random 720p wires with narrow and wide records at exact
    sizes; both padded (a padding frame, runs, escapes and 0x40 pairs:
    the records and the escape stream at odd byte offsets); a pair before
    the first bit-7 pair; coded ordinals past n_blk; more bit-7 pairs than
    n_blk (the tail ordinals' pairs, at distinct positions, clamp into
    ordinal n_blk - 1); every other pair without bit 7 given bit 6 (never
    scattered) and its value kept; an empty wire (every size 1); the main
    batches and an idle stream as a four-stream vmap stack; blocks naming
    positions twice (held on the wire with each overwritten pair
    retired); four random streams of 3555 macroblocks, not a multiple of
    launch B's tile, stacked; a coefficient-dense intra-only batch."""
    from ..models.mpeg1 import MPEG1Decoder
    from .kernel_inputs import (exact_wire, k3_dense_batch,
                                k3_duplicate_positions, k3_random_batch,
                                shared_wires, sized_wires)
    n_mb = (W // 16) * (H // 16)
    rng = np.random.default_rng(SEED + 5)
    cases = []

    def exact(name, batch, ref=None):
        bufs, sizes = exact_wire(batch, n_mb)
        cases.append((name, bufs, sizes,
                      bufs if ref is None else ref(bufs, sizes)))

    def sized(name, batches, F, *sizes):
        bufs, sizes = sized_wires(batches, F, n_mb, *sizes)
        cases.append((name, bufs, sizes, bufs))

    def shared(name, batches, F, mb=n_mb):
        bufs, sizes = shared_wires(batches, F, mb)
        cases.append((name, bufs, sizes, bufs))

    parser = MPEG1Decoder({'device': 'cpu'}).parser
    parser.write(es)
    main = [parser.parse_batch(BATCH, eof=True)
            for _ in range(N_FRAMES // BATCH)]
    for i, b in enumerate(main):
        if not isinstance(b, dict) or 'sp_pos' not in b:
            raise AssertionError(f'main batch {i} is not a packed batch')
        exact(f'main_batch_{i}', b)
    F = K3_CHECK_FRAMES
    for wide in (False, True):
        b = k3_random_batch(rng, F, n_mb, wide)
        kind = 'wide' if wide else 'narrow'
        exact(f'random_{kind}', b)
        # F + 1 frames: F + 1 + bitmap bytes is odd, so the records and
        # the escape stream start at odd offsets
        sized(f'padded_{kind}', [b], F + 1, len(b['sp_pos']) + 777,
              len(b['run_len']) + 5, wide, len(b['sp_esc']) + 3,
              b['n_blocks'])
    b = k3_random_batch(rng, F, n_mb, False)
    # the leading pair names a level ordinal 0's own pairs do not
    own = b['sp_pos'][:1 + int(np.argmax(b['sp_pos'][1:] >> 7))] & 63
    lead = max(set(range(64)) - set(own.tolist()))
    exact('lead_pair', dict(
        b, sp_pos=np.concatenate([[lead], b['sp_pos']]).astype(np.uint8),
        sp_v8=np.concatenate([[-128], b['sp_v8']]).astype(np.int8),
        sp_esc=np.concatenate([[1234], b['sp_esc']]).astype(np.int16)))
    b = k3_random_batch(rng, F, n_mb, False)
    half = b['n_blocks'] // 2
    starts = np.flatnonzero(b['sp_pos'] >> 7)
    exact('past_n_blk', dict(b, sp_pos=b['sp_pos'][:starts[half]],
                             sp_v8=b['sp_v8'][:starts[half]],
                             sp_esc=b['sp_esc'][:int(
                                 (b['sp_v8'][:starts[half]] == -128).sum())],
                             n_blocks=half))
    b = k3_random_batch(rng, F, n_mb, False)
    # the last 6 ordinals carry 8 pairs each at positions 8j .. 8j + 7
    keep = int(np.flatnonzero(b['sp_pos'] >> 7)[-6])
    tail = (np.arange(48) | np.where(np.arange(48) % 8 == 0, 0x80, 0))
    v8 = np.concatenate([b['sp_v8'][:keep],
                         rng.integers(1, 128, 48).astype(np.int8)])
    exact('tail_ordinals', dict(
        b, sp_pos=np.concatenate([b['sp_pos'][:keep], tail]).astype(np.uint8),
        sp_v8=v8, sp_esc=b['sp_esc'][:int((v8 == -128).sum())],
        n_blocks=b['n_blocks'] - 5))
    b = k3_random_batch(rng, F, n_mb, False)
    pos = b['sp_pos'].copy()
    mid = np.flatnonzero((pos & 0x80) == 0)[::2]
    pos[mid] = 0x40 | ((pos[mid] & 63) ^ 1)
    exact('bit6_pairs', dict(b, sp_pos=pos))
    sized('empty', [None], 2, 1, 1, False, 1, 1)
    shared('vmap_4', main + [None], BATCH)
    exact('duplicates', k3_duplicate_positions(
        rng, k3_random_batch(rng, F, n_mb, False)),
        ref=k3_retire_overwritten)
    shared('stack_4_off_tile', [k3_random_batch(rng, F, K3_OFF_TILE_MB, w)
                                for w in (False, False, True, False)],
           F, K3_OFF_TILE_MB)
    exact('dense_intra', k3_dense_batch(rng, K3_DENSE_FRAMES, n_mb))
    return cases


def k3_shape_wires(es: bytes, gop: int) -> list:
    """The wires K3 unpacks in one call on the packed paths, from the
    stream `es` (GOPs of `gop` frames), as (name, host wire uint8 [1, L],
    sizes (F, n_mb, n_runs, mv_wide, n_pairs, n_esc, n_blk), copies):
    'main', the main path's last 32-frame batch; 'gop_mesh', the GOP
    mesh's joint wire (parallel/packed.py: the GOPs side by side as one
    stream of frames `gop` long); 'stacked_4', the stacked fleet's round
    of four 32-frame streams (parallel/streams.py: stack_stream_frames,
    here the stream's three batches and its first again); 'lattice_48',
    48 copies of the main batch stacked, 5.5 M macroblocks, near the
    int32 lattice limit that lattice_groups allows one call.  `copies`:
    the lattice wire's columns hold that many copies of 'main'."""
    from ..models.mpeg1 import MPEG1Decoder, build_fused_buffer
    from ..parallel.packed import split_packed_frames
    from ..parallel.streams import stack_stream_frames
    dec = MPEG1Decoder({'device': 'cpu'})
    dec.parser.write(es)
    batches = []
    while True:
        b = dec.parser.parse_batch(BATCH, eof=True)
        if not isinstance(b, dict):
            break
        batches.append(b)
    n_mb = dec.parser.seq.mb_size
    frames = [f for b in batches for f in split_packed_frames(b)]
    last = split_packed_frames(batches[-1])
    gops = [frames[a:a + gop] for a in range(0, len(frames), gop)]
    per = [frames[a:a + BATCH] for a in range(0, len(frames), BATCH)]
    out = []
    for name, streams, n_frames, copies in (
            ('main', [last], len(last), 1),
            ('gop_mesh', gops, gop, 1),
            ('stacked_4', (per + per)[:4], BATCH, 1),
            ('lattice_48', [last] * 48, len(last), 48)):
        joint = (batches[-1] if name == 'main' else
                 stack_stream_frames(streams, n_mb, n_frames)[0])
        buf, n_blk, n_runs, wide, n_pairs, n_esc = build_fused_buffer(
            joint, len(streams) * n_mb)
        out.append((name, buf[None], (n_frames, len(streams) * n_mb, n_runs,
                                      wide, n_pairs, n_esc, n_blk), copies))
    return out


def k3_copies(torch, main, copies: int):
    """K3's outputs on the wire whose frames each hold `copies` copies of
    the frame of `main` (K3's compact outputs on a wire that numbers its
    coded blocks exactly) side by side: the fields' columns repeated, and
    each frame's rows repeated in turn, their ids moved to each copy's
    columns."""
    from ..ops.frame import LevelsArrays
    F, M = main.qscale.shape
    per = M * 6
    frame = main.blk_ids.long() // per
    ends = torch.bincount(frame, minlength=F).cumsum(0).tolist()
    rows, ids = [], []
    for f in range(F):
        a, b = (ends[f - 1] if f else 0), ends[f]
        for c in range(copies):
            rows.append(main.levels[a:b])
            ids.append(main.blk_ids[a:b] + (f * (copies - 1) + c) * per)
    fields = [torch.cat([x] * copies, dim=1) for x in main[1:7]]
    return LevelsArrays(torch.cat(rows), *fields, blk_ids=torch.cat(ids))

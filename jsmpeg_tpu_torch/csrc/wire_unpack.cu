// K3: the packed wire v2 unpack -- the wire bytes of one batch (or of S
// streams at shared sizes) into the compact int16 levels of the coded
// blocks with each one's block id (K1's compact form reads them) and the
// per-macroblock fields that K1, K2 and frame_meta read.
//
// Replaces: no Pallas kernel.  jsmpeg_tpu runs `unpack_fused` and
// `packed_to_levels` (jsmpeg_tpu/models/mpeg1.py:133,307) as jit-compiled
// jnp inside `decode_scan_fused` (:243), under `jax.vmap` for its vmap
// fleet (jsmpeg_tpu/parallel/streams.py:66-84).  Plain PyTorch version:
// jsmpeg_tpu_torch/models/mpeg1.py:unpack_fused + packed_to_blocks (joined
// over streams by unpack_wires_ref; packed_to_levels, jsmpeg_tpu's dense
// lattice, is that scattered by the ids); this kernel's two launches step
// by step, in plain torch, for the tests: tests/torch_k3_mirror.py.
//
// Wire v2 (per stream, L bytes): [valid F][run-start bitmap B =
// (F*n_mb+7)/8][run records R*w][sp_pos P][sp_v8 i8 P][sp_esc LE i16 E].
// Semantics:
// - macroblock i's run slot = clamp(starts at or before i - 1, 0, R - 1)
//   (bit i & 7 of bitmap byte i >> 3); its record is w = 4 bytes [flags,
//   cbp, mv_h i8, mv_v i8] or w = 8 bytes [mv_h i16, mv_v i16, flags, cbp,
//   0, 0]; qscale = flags & 31, intra = bit 5, written = bit 6, coded
//   block b = cbp bit b (b < 6);
// - pair p's value is sp_v8[p], or, when that is -128, the escape
//   sp_esc[clamp(escapes at or before p - 1, 0, E - 1)];
// - pair p belongs to the coded-block ordinal clamp(bit-7 pairs at or
//   before p - 1, 0, n_blk - 1); coded blocks take ordinals in row-major
//   (frame, macroblock, block) order.  Ordinal k < n_blk is row k of the
//   stream's compact lattice [n_blk, 64]: at position pos & 63 the value of
//   the last pair of ordinal k (wire order) that names it and has bit 6
//   clear, every other level 0; blk_ids[k] is its block's flat id
//   (f * S*n_mb + s*n_mb + m) * 6 + b in the joint layout.  Rows past the
//   stream's coded blocks (a shorter stream of a shared-size stack) are
//   zero with id -1; a coded block past ordinal n_blk - 1 has no row.
// S > 1 streams write stream s's macroblock fields into columns [s*n_mb,
// (s+1)*n_mb) of the joint [F, S*n_mb] layout (the vmap fleet's join) and
// its rows into rows [s*n_blk, (s+1)*n_blk) of the [S*n_blk, 64] lattice.
//
// Bound on the H100: bytes.  A 720p batch of 32 frames writes its coded
// blocks' rows and ids (132 B a block: 13.6 MB at the main stream's last
// batch of 103,123) plus 17 bytes per macroblock (1.96 MB) and reads a few
// MB of wire: ~0.006 ms at 3.35 TB/s (the dense lattice, 88.5 MB, was
// ~0.03); the integer work is a few operations per byte.  Tensor cores
// have nothing to do here: there is no product.
// Design, two launches:
//   A. scan_kernel: all four prefix counts and the per-macroblock fields
//      in one pass.  A CTA takes its tile from an atomic ticket (stream by
//      stream: the macroblock tiles, then the pair tiles), not from
//      blockIdx, so every tile it looks back on was started before it and
//      the look-back cannot deadlock.  The chained scans use decoupled
//      look-back: each tile publishes its aggregate, then its inclusive
//      prefix, as one 64-bit flag-and-value word (st.release.gpu /
//      ld.relaxed.gpu: the word is all a reader takes from its writer);
//      warp 0 walks back 32 tiles a step, a lane each, waiting for and
//      summing aggregates until it meets an inclusive prefix.  (A 256-tile step, 8 a lane,
//      measured slower: a tile then waits on 256 earlier tiles'
//      aggregates, close to a barrier over the grid.)
//      - A macroblock tile (kScanThreads macroblocks, one a thread) first
//        chains its run starts, on a chain that never waits: the CTA
//        walks back kScanThreads tiles a step, a thread taking an earlier
//        tile's inclusive prefix where one is published and else counting
//        that tile's 32 bitmap bytes itself (a popcount, loaded beside the
//        status word), until it meets an inclusive prefix.  So it reads
//        back about as far as the tiles in flight, whatever the wire's
//        length.  (Counting the whole bitmap before each tile, with no
//        chain, was as fast at a 32-frame batch, but its reads grow with
//        the square of a wire's macroblocks, and the GOP mesh and the
//        stacked fleet unpack hundreds of thousands to millions in one
//        call.)  The run starts in the tile come from a ballot.  Then,
//        with each macroblock's run slot, record and fields in hand (a
//        warp's byte and int32 stores contiguous), it chains the scan of
//        the coded blocks, stores each macroblock's first ordinal and cbp
//        (one word) for B and each coded block's id at its ordinal; the
//        stream's last tile stores its count of coded blocks for B.
//      - A pair tile (kPairItems pairs a thread) chains the bit-7 pairs
//        and the escapes as one scan of two counts.  It stores each
//        pair's position and escape-resolved value as one word, each
//        ordinal's first pair, the stream's bit-7 total and its last pair
//        with bit 6 clear (live_end).
//   B. write_kernel: a CTA per kWriteMbs consecutive macroblocks of one
//      frame of one stream (never across a frame or a stream's columns),
//      kWarpMbs a warp, into a zeroed shared-memory tile, the warp's coded
//      blocks at consecutive rows by ordinal (consecutive macroblocks hold
//      consecutive ordinals), that leaves with one TMA bulk store
//      (cp.async.bulk) of those rows only; then the warp zeroes its share
//      of the stream's rows past its coded blocks and sets their ids to -1
//      (none on a stream's own wire).  Every level and id is written
//      exactly once, with no memset of the lattice.  A warp's loads go out
//      together in three dependent rounds for its kWarpMbs macroblocks
//      (their words; their ordinal bounds, a lane each; the first chunk of
//      each one's pairs): the pass is latency-bound per round, so a round
//      serves four macroblocks.  A macroblock's one contiguous pair range
//      is walked 32 pairs at a time in wire order; within a chunk the last
//      lane of each equal (row, position) wins (__match_any_sync, the
//      highest set lane): the CPU's in-order scatter.  Bit-6 pairs are
//      skipped but count for ordinals.  The range is cut after live_end,
//      so the padding pairs of a wire sized for a longer stream (the vmap
//      fleet's shared sizes: every pair the shorter stream lacks, 0x40
//      behind its last real one) are never walked.
// B reads A's ordinal bounds from any tile, so it waits for all of A.  It
// is launched with Programmatic Dependent Launch: A lets it launch once
// every CTA of A has started (griddepcontrol.launch_dependents, the PTX of
// cudaTriggerProgrammaticLaunchCompletion), and B zeroes its tile and then
// waits for A's end before its first read (griddepcontrol.wait, that of
// cudaGridDependencySynchronize), so B's launch and prologue overlap A's
// tail.  Chosen over one cooperative launch with a grid sync, which caps
// the grid at the resident CTAs (K2's case): B's thousands of tiles would
// become a loop in every CTA, behind a barrier that every CTA pays.
// The ticket, the status words and live_end are zeroed by one
// cudaMemsetAsync of those words only, ahead of A on the same stream; no
// state outlives a call, so two calls on two streams share nothing.  The
// caller hands over the scratch as one buffer of scratch_rule()'s bytes, a
// size it computes without knowing the layout; layout() carves it, here
// only.
// The wire's escape stream and wide records sit at arbitrary byte offsets,
// so every multi-byte wire value is read byte by byte, little-endian.
// Element counts are int (F*n_mb*384 is under 2^31, checked by the
// launcher, so a block id fits int32); rows, lattice and byte offsets are
// 64-bit.
// Checked build (-DJT_CHECKED, csrc/checked.cuh): every global and shared
// access goes through its bounds accessor (extents in Wire and Scratch;
// a macroblock's record bytes, its fields and a pair's escape as one
// range each; the aligned bitmap words against the whole [S, L] wire
// buffer, since their masked bytes may lie in a neighbouring stream's
// wire), shared ones through the hazard shadow (A: 4-byte granules; B:
// 2-byte); every prefix must be summed from status words seen complete,
// and the run-start chain must hold no aggregate; a look-back past its
// (scaled) poll limit is a recorded fault; seeded delays sit after the
// ticket draw and before each status word's publish.

#include <cstdint>

#include <cuda_runtime.h>

#define JT_FILE 3
#include "checked.cuh"

namespace {

constexpr int kScanThreads = 256;                     // A: threads per CTA
constexpr int kScanWarps = kScanThreads / 32;
constexpr int kScanCtasPerSm = 4;                     // A: its register cap
constexpr int kMbTile = kScanThreads;                 // A: macroblocks a tile
static_assert(kMbTile % 32 == 0, "a macroblock tile holds whole bitmap words");
constexpr int kPairItems = 8;                         // A: pairs per thread
constexpr int kPairTile = kScanThreads * kPairItems;  // A: pairs a tile
constexpr int kWarpMbs = 4;                           // B: macroblocks a warp
constexpr int kWriteMbs = 32;                         // B: macroblocks a CTA
constexpr int kWriteWarps = kWriteMbs / kWarpMbs;
constexpr int kWriteThreads = kWriteWarps * 32;
constexpr int kWriteCtasPerSm = 4;                    // B: its register cap
constexpr int kMbLevels = 6 * 64;                     // int16 a macroblock
constexpr unsigned kFull = 0xffffffffu;
// a status word: its flag in bits 62-63, its value in bits 0-61 (a pair
// tile's two counts: bit-7 pairs in bits 0-30, escapes from bit kHigh)
constexpr unsigned long long kAggregate = 1ull << 62;
constexpr unsigned long long kInclusive = 2ull << 62;
constexpr unsigned long long kValue = kAggregate - 1;
constexpr int kHigh = 31;
constexpr unsigned long long kLow = (1ull << kHigh) - 1;
// a look-back wait traps after this many polls instead of hanging the card
constexpr long long kMaxPolls = JT_SPIN_SCALE(1ll << 24);

struct Wire {
  const uint8_t* buf;
  long long stride;            // bytes from one stream's wire to the next
  long long o_bm, o_rec, o_pos, o_v8, o_esc;
  int n_streams, n_frames, n_mb, n_runs, wide, n_pairs, n_esc, n_blk;
  int n_items;                 // macroblocks per stream, F * n_mb
  int mb_tiles, pair_tiles;    // per stream
  int pv_stride;               // pair words per stream, pair_tiles * kPairTile
#ifdef JT_CHECKED
  long long bytes;             // the [S, L] wire buffer's
  long long n_out;             // output macroblocks, F * S * n_mb
  long long n_rows;            // lattice rows, S * n_blk
#endif
};

// Scratch, carved from one buffer (layout()).  The head, ticket to
// pair_st, is zeroed ahead of launch A; the rest is written before it is
// read.
struct Scratch {
  unsigned* ticket;              // A's next tile
  int* live1;                    // [S] last pair with bit 6 clear, plus 1
  int* n_b7;                     // [S] bit-7 pairs of the stream
  int* n_cod;                    // [S] coded blocks of the stream
  unsigned long long* run_st;    // [S, mb_tiles]   run-start chain
  unsigned long long* cod_st;    // [S, mb_tiles]   coded-block chain
  unsigned long long* pair_st;   // [S, pair_tiles] bit-7 pair, escape chain
  int* first;                    // [S, n_blk] first pair of each ordinal
  uint32_t* mbw;                 // [S, n_items] first ordinal << 6 | cbp
  uint32_t* pv;                  // [S, pv_stride] value << 16 | position
#ifdef JT_CHECKED
  long long n_first, n_mbw, n_pv;   // their elements
#endif
};

struct Out {
  int16_t* levels;   // [S*n_blk, 64], the coded blocks' rows
  int32_t* blk_ids;  // [S*n_blk], each row's block id (-1: none)
  uint8_t* qscale;   // [F, S*n_mb]
  bool* coded;       // [F, S*n_mb, 6]
  bool* intra;
  bool* written;
  int32_t* mv_h;
  int32_t* mv_v;
};

__device__ __forceinline__ void publish(unsigned long long* p,
                                        unsigned long long v) {
  JT_DELAY(4);
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

// A look-back reads nothing that a status word's writer stored before it
// but the word itself, so a relaxed load does.
__device__ __forceinline__ unsigned long long observe(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p)
               : "memory");
  return v;
}

// The sum of the values of tiles [0, j) of a chain (j >= 1), by warp 0:
// 32 tiles a step back from j - 1, a lane each, each lane waiting for its
// tile's first word, until a step meets an inclusive prefix (the nearest
// one ends the sum).  Every lane returns the sum.  Checked: the chain
// holds `tiles` words.
__device__ unsigned long long look_back(const unsigned long long* chain,
                                        int j JT_ARG(int tiles)) {
  const int lane = threadIdx.x & 31;
  unsigned long long sum = 0;
  for (int top = j - 1;; top -= 32) {
    const int t = top - lane;
    unsigned long long s = kInclusive;            // before tile 0: nothing
    if (t >= 0 && JT_OK(t, tiles)) {
      long long polls = 0;
      while (!((s = observe(chain + t)) >> 62)) {
        if (++polls > kMaxPolls) {
          JT_SPIN_OUT(0);
#ifdef JT_CHECKED
          break;   // s stays incomplete: the prefix check reports it
#endif
        }
        __nanosleep(32);
      }
    }
    const unsigned incl = __ballot_sync(kFull, (s >> 62) == 2);
    // the lanes up to the nearest inclusive prefix (the lowest such lane)
    const unsigned upto = incl ? ((incl & (0u - incl)) << 1) - 1u : kFull;
    JT_FLAG(!((upto >> lane) & 1u) || (s >> 62) != 0, jt::kFlagPrefix);
    unsigned long long v = (upto >> lane) & 1u ? s & kValue : 0;
#pragma unroll
    for (int d = 16; d; d >>= 1) v += __shfl_xor_sync(kFull, v, d);
    sum += v;
    if (incl) return sum;
  }
}

// Tile j's exclusive prefix in `chain`: it publishes its aggregate `agg`
// (as its inclusive prefix when j == 0), looks back, and publishes its
// inclusive prefix.  Called by every thread of the CTA; xs: a shared word.
// Checked: the chain holds `tiles` words.
__device__ unsigned long long chain_prefix(unsigned long long* chain, int j,
                                           unsigned long long agg,
                                           unsigned long long* xs
                                               JT_ARG(int tiles)) {
  if (threadIdx.x < 32) {
    unsigned long long excl = 0;
    if (j == 0) {
      if (threadIdx.x == 0 && JT_OK(0, tiles))
        publish(chain, kInclusive | agg);
    } else {
      if (threadIdx.x == 0 && JT_OK(j, tiles))
        publish(chain + j, kAggregate | agg);
      excl = look_back(chain, j JT_PASS(tiles));
      if (threadIdx.x == 0 && JT_OK(j, tiles))
        publish(chain + j, kInclusive | (excl + agg));
    }
    if (threadIdx.x == 0) JT_SH_ST(xs, 0, 1, excl);
  }
  JT_SYNCTHREADS();
  const unsigned long long e = JT_SH_LD(xs, 0, 1);
  JT_SYNCTHREADS();
  return e;
}

// Inclusive scan of one int a thread over the CTA; *total gets the CTA's
// sum.  sm: kScanWarps ints, free again on return.
__device__ int block_scan(int v, int* sm, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) JT_SH_ST(sm, warp, kScanWarps, x);
  JT_SYNCTHREADS();
  int before = 0, all = 0;
#pragma unroll
  for (int q = 0; q < kScanWarps; ++q) {
    const int v = JT_SH_LD(sm, q, kScanWarps);
    before += q < warp ? v : 0;
    all += v;
  }
  *total = all;
  JT_SYNCTHREADS();
  return before + x;
}

// Set bits at or below each thread's over the CTA (one bit a thread): a
// ballot and a popcount per warp, then the warps before.
__device__ int block_count_bits(uint32_t bit, int* sm, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned bits = __ballot_sync(kFull, bit);
  if (lane == 0) JT_SH_ST(sm, warp, kScanWarps, __popc(bits));
  JT_SYNCTHREADS();
  int before = 0, all = 0;
#pragma unroll
  for (int q = 0; q < kScanWarps; ++q) {
    const int v = JT_SH_LD(sm, q, kScanWarps);
    before += q < warp ? v : 0;
    all += v;
  }
  *total = all;
  JT_SYNCTHREADS();
  return before + __popc(bits & (kFull >> (31 - lane)));
}

// Set bits of macroblock tile t's kMbTile / 8 bitmap bytes at bm (any
// alignment): a popcount of the aligned words that cover them, the bytes
// outside masked off (the words stay inside the wire: the bitmap follows
// the valid bytes and precedes the records).  One thread.  Checked: bm is
// byte `at` of the wire buffer, which holds `bytes`.
__device__ __forceinline__ unsigned tile_starts(const uint8_t* bm,
                                                int t JT_ARG(long long at)
                                                    JT_ARG(long long bytes)) {
  constexpr int kWords = kMbTile / 32;
  const int lead = static_cast<int>(reinterpret_cast<uintptr_t>(bm) & 3u);
  const uint32_t* words =
      reinterpret_cast<const uint32_t*>(bm - lead) + kWords * t;
  unsigned c = 0;
#pragma unroll
  for (int k = 0; k <= kWords; ++k) {
    uint32_t v = (k < kWords || lead) &&
                         JT_OK_N(at - lead + 4ll * (kWords * t + k), 4, bytes)
                     ? words[k]
                     : 0u;
    if (k == 0) v &= ~0u << (8 * lead);
    if (k == kWords) v &= (1u << (8 * lead)) - 1u;
    c += __popc(v);
  }
  return c;
}

// Tile j's run starts before it, on the run-start chain, which holds
// inclusive prefixes only: the CTA walks back kScanThreads tiles a step, a
// thread each, a thread taking its tile's inclusive prefix where one is
// published and else the tile's own count (tile_starts, loaded beside the
// status word), until a step meets an inclusive prefix (the nearest one
// ends the sum); then tile j publishes its own, the sum plus `total`.  No
// thread waits.  Called by every thread of the CTA; sm: kScanWarps ints,
// free again on return.  Checked: the chain holds `tiles` words; bm is
// byte `at` of the wire buffer, which holds `bytes`.
__device__ int run_prefix(unsigned long long* chain, const uint8_t* bm,
                          int j, int total,
                          int* sm JT_ARG(int tiles) JT_ARG(long long at)
                              JT_ARG(long long bytes)) {
  constexpr int kHas = 1 << 30;                 // above any count of starts
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int excl = 0;
  for (int top = j - 1; top >= 0; top -= kScanThreads) {
    const int t = top - static_cast<int>(threadIdx.x);
    unsigned long long s = kInclusive;            // before tile 0: nothing
    if (t >= 0) {
      const unsigned own = tile_starts(bm, t JT_PASS(at) JT_PASS(bytes));
      if (!((s = JT_OK(t, tiles) ? observe(chain + t) : 0ull) >> 62))
        s = own;
      // the chain holds inclusive prefixes only
      JT_FLAG((s >> 62) != 1, jt::kFlagPrefix);
    }
    const unsigned incl = __ballot_sync(kFull, (s >> 62) == 2);
    // the lanes up to the nearest inclusive prefix (the lowest such lane)
    const unsigned upto = incl ? ((incl & (0u - incl)) << 1) - 1u : kFull;
    const int v = __reduce_add_sync(
        kFull, (upto >> lane) & 1u ? static_cast<int>(s & kValue) : 0);
    if (lane == 0) JT_SH_ST(sm, warp, kScanWarps, v | (incl ? kHas : 0));
    JT_SYNCTHREADS();
    bool done = false;
    for (int q = 0; q < kScanWarps && !done; ++q) {
      const int word = JT_SH_LD(sm, q, kScanWarps);
      excl += word & (kHas - 1);
      done = word & kHas;
    }
    JT_SYNCTHREADS();
    if (done) break;
  }
  if (threadIdx.x == 0 && JT_OK(j, tiles))
    publish(chain + j, kInclusive | (excl + total));
  return excl;
}

// Macroblock tile t of stream st: the run starts before it (the run-start
// chain) and in it (a ballot), the fields, the coded-block scan; each
// macroblock's first ordinal and cbp for B, each coded block's id at its
// ordinal's row, and in the stream's last tile its count of coded blocks.
__device__ void mb_tile(const Wire& w, const Scratch& s, const Out& o,
                        int st, int t, int* sm, unsigned long long* xs) {
  const uint8_t* buf = w.buf + st * w.stride;
  const int i = t * kMbTile + static_cast<int>(threadIdx.x);
  const bool in = i < w.n_items;
  const uint32_t start =
      in && JT_OK(st * w.stride + w.o_bm + (i >> 3), w.bytes)
          ? (buf[w.o_bm + (i >> 3)] >> (i & 7)) & 1u
          : 0u;
  int total;
  const int in_tile = block_count_bits(start, sm, &total);
  const int run = in_tile + run_prefix(
      s.run_st + static_cast<long long>(st) * w.mb_tiles, buf + w.o_bm, t,
      total, sm JT_PASS(w.mb_tiles) JT_PASS(st * w.stride + w.o_bm)
                 JT_PASS(w.bytes));
  uint32_t cbp = 0;
  long long j = 0;            // the macroblock's index in the joint layout
  if (in) {
    const int slot = min(max(run - 1, 0), w.n_runs - 1);
    const uint8_t* r =
        buf + w.o_rec + static_cast<long long>(slot) * (w.wide ? 8 : 4);
    uint32_t flags = 0;
    int32_t mvh = 0, mvv = 0;
    // the record's bytes, one range
    if (!JT_OK_N(st * w.stride + w.o_rec +
                     static_cast<long long>(slot) * (w.wide ? 8 : 4),
                 w.wide ? 6 : 4, w.bytes)) {
    } else if (w.wide) {
      mvh = static_cast<int16_t>(r[0] | (r[1] << 8));
      mvv = static_cast<int16_t>(r[2] | (r[3] << 8));
      flags = r[4];
      cbp = r[5];
    } else {
      flags = r[0];
      cbp = r[1];
      mvh = static_cast<int8_t>(r[2]);
      mvv = static_cast<int8_t>(r[3]);
    }
    const int f = i / w.n_mb, m = i - f * w.n_mb;
    j = (static_cast<long long>(f) * w.n_streams + st) * w.n_mb + m;
    // the macroblock's fields: the one index j of every field output
    if (JT_OK(j, w.n_out)) {
      o.qscale[j] = flags & 31u;
      o.intra[j] = (flags >> 5) & 1u;
      o.written[j] = (flags >> 6) & 1u;
      // six coded flags as three 2-byte stores (j * 6 is even)
      uint16_t* c2 = reinterpret_cast<uint16_t*>(o.coded + j * 6);
#pragma unroll
      for (int b = 0; b < 6; b += 2)
        c2[b / 2] = ((cbp >> b) & 1u) | (((cbp >> (b + 1)) & 1u) << 8);
      o.mv_h[j] = mvh;
      o.mv_v[j] = mvv;
    }
    cbp &= 63u;
  }
  const int n_cod = __popc(cbp);
  const int cod_in = block_scan(n_cod, sm, &total);
  const int excl = static_cast<int>(chain_prefix(
      s.cod_st + static_cast<long long>(st) * w.mb_tiles, t, total,
      xs JT_PASS(w.mb_tiles)));
  const int cod = excl + cod_in - n_cod;
  if (in && JT_OK(static_cast<long long>(st) * w.n_items + i, s.n_mbw))
    s.mbw[static_cast<long long>(st) * w.n_items + i] =
        (static_cast<uint32_t>(cod) << 6) | cbp;
  // each coded block's id at its ordinal's row (a block past ordinal
  // n_blk - 1 has none); cbp is 0 past the stream's macroblocks
  uint32_t rest = cbp;
  for (int k = cod; rest && k < w.n_blk; ++k, rest &= rest - 1u) {
    const long long at = static_cast<long long>(st) * w.n_blk + k;
    if (JT_OK(at, w.n_rows))
      o.blk_ids[at] = static_cast<int32_t>(j * 6 + __ffs(rest) - 1);
  }
  if (threadIdx.x == 0 && t == w.mb_tiles - 1 && JT_OK(st, w.n_streams))
    s.n_cod[st] = excl + total;
}

// Pair tile t of stream st: the bit-7 pair and escape scan, each pair's
// word, each ordinal's first pair, live_end and the stream's bit-7 total.
__device__ void pair_tile(const Wire& w, const Scratch& s, int st, int t,
                          int* sm, unsigned long long* xs, int* tile_live) {
  const uint8_t* buf = w.buf + st * w.stride;
  const int p0 = t * kPairTile + static_cast<int>(threadIdx.x) * kPairItems;
  uint32_t pos[kPairItems];
  int v8[kPairItems];
  int n7 = 0, ne = 0, live = -1;
#pragma unroll
  for (int k = 0; k < kPairItems; ++k) {
    const int p = p0 + k;
    const bool in = p < w.n_pairs;
    pos[k] = in && JT_OK(st * w.stride + w.o_pos + p, w.bytes)
                 ? buf[w.o_pos + p]
                 : 0x40u;
    v8[k] = in && JT_OK(st * w.stride + w.o_v8 + p, w.bytes)
                ? static_cast<int8_t>(buf[w.o_v8 + p])
                : 0;
    n7 += pos[k] >> 7;
    ne += v8[k] == -128;
    if (in && !(pos[k] & 0x40u)) live = p;
  }
  int total;
  // both counts in one scan: each under 2^16 a tile
  const int both = block_scan(n7 | (ne << 16), sm, &total);
  const unsigned long long agg =
      static_cast<unsigned long long>(total & 0xffff) |
      (static_cast<unsigned long long>(total >> 16) << kHigh);
  const unsigned long long pre = chain_prefix(
      s.pair_st + static_cast<long long>(st) * w.pair_tiles, t, agg,
      xs JT_PASS(w.pair_tiles));
  int c7 = static_cast<int>(pre & kLow) + (both & 0xffff) - n7;
  int ce = static_cast<int>(pre >> kHigh) + (both >> 16) - ne;
  if (threadIdx.x == 0 && t == w.pair_tiles - 1 && JT_OK(st, w.n_streams))
    s.n_b7[st] = static_cast<int>(pre & kLow) + (total & 0xffff);
  int* first = s.first + static_cast<long long>(st) * w.n_blk;
  uint32_t word[kPairItems];
#pragma unroll
  for (int k = 0; k < kPairItems; ++k) {
    int v = v8[k];
    if (v == -128) {
      ++ce;
      const int e = min(max(ce - 1, 0), w.n_esc - 1);
      const long long a = w.o_esc + 2ll * e;
      v = JT_OK_N(st * w.stride + a, 2, w.bytes)
              ? static_cast<int16_t>(buf[a] | (buf[a + 1] << 8))
              : 0;
    }
    word[k] = (static_cast<uint32_t>(static_cast<uint16_t>(v)) << 16) | pos[k];
    if (pos[k] >> 7) {
      ++c7;
      if (c7 - 1 < w.n_blk &&
          JT_OK(static_cast<long long>(st) * w.n_blk + c7 - 1, s.n_first))
        first[c7 - 1] = p0 + k;
    }
  }
  uint4* dst = reinterpret_cast<uint4*>(
      s.pv + static_cast<long long>(st) * w.pv_stride + p0);
#pragma unroll
  for (int k = 0; k < kPairItems / 4; ++k)
    if (JT_OK_N(static_cast<long long>(st) * w.pv_stride + p0 + 4 * k, 4,
                s.n_pv))
      dst[k] = make_uint4(word[4 * k], word[4 * k + 1], word[4 * k + 2],
                          word[4 * k + 3]);
  // live_end: the tile's last live pair (its reset is ordered before this
  // by the scans' barriers), then one atomic for the tile
  const int wl = __reduce_max_sync(kFull, live + 1);
  if ((threadIdx.x & 31) == 0 && wl &&
      JT_SH_OK(tile_live, 0, 1, 1, jt::kAtomic))
    atomicMax(tile_live, wl);
  JT_SYNCTHREADS();
  if (threadIdx.x == 0 && JT_SH_LD(tile_live, 0, 1) &&
      JT_OK(st, w.n_streams))
    atomicMax(&s.live1[st], JT_SH_LD(tile_live, 0, 1));
}

__global__ void __launch_bounds__(kScanThreads, kScanCtasPerSm)
scan_kernel(Wire w, Scratch s, Out o) {
  __shared__ int sm[kScanWarps];
  __shared__ unsigned long long xs;
  __shared__ unsigned ticket;
  __shared__ int tile_live;
  JT_BEGIN(0);
  if (threadIdx.x == 0) {
    JT_SH_ST(&ticket, 0, 1, JT_OK(0, 1) ? atomicAdd(s.ticket, 1u) : 0u);
    JT_SH_ST(&tile_live, 0, 1, 0);
    JT_DELAY(3);
  }
  JT_SYNCTHREADS();
  // B may launch once every CTA of A has started; it waits for A's end
  // before it reads anything A writes
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  const int per = w.mb_tiles + w.pair_tiles;
  const unsigned tk = JT_SH_LD(&ticket, 0, 1);
  const int st = static_cast<int>(tk) / per;
  const int t = static_cast<int>(tk) - st * per;
  if (t < w.mb_tiles)
    mb_tile(w, s, o, st, t, sm, &xs);
  else
    pair_tile(w, s, st, t - w.mb_tiles, sm, &xs, &tile_live);
}

// The walk of one macroblock's pair range [bnd[0], hi) into rows, its n_c
// coded blocks' zeroed rows of 64 levels in shared memory (ordinal order),
// 32 pairs a chunk; x: the first chunk's words, loaded ahead.  One warp.
// Checked: pv holds pv_words, and `room` levels of the tile are left from
// rows on.
__device__ __forceinline__ void scatter_mb(const uint32_t* pv,
                                           const int* bnd, int hi,
                                           int n_c, uint32_t x,
                                           int16_t* rows JT_ARG(int pv_words)
                                               JT_ARG(int room)) {
  const int lane = threadIdx.x & 31;
  for (int base = bnd[0]; base < hi; base += 32) {
    const int p = base + lane;
    const bool in = p < hi;
    if (base != bnd[0]) x = in && JT_OK(p, pv_words) ? pv[p] : 0x40u;
    // the pair's ordinal within the macroblock: its row
    int q = 0;
#pragma unroll
    for (int r = 1; r < 6; ++r) q += r < n_c && bnd[r] <= p;
    const bool live = in && !(x & 0x40u);
    const uint32_t key = live ? (static_cast<uint32_t>(q) << 6) | (x & 63u)
                              : 0x1000u | lane;
    const unsigned same = __match_any_sync(kFull, key);
    // the last lane of each equal (row, position) wins
    if (live && 31 - __clz(same) == lane)
      JT_SH_ST(rows, q * 64 + (x & 63u), room, static_cast<int16_t>(x >> 16));
    JT_SYNCWARP();
  }
}

// Macroblocks [i0, i0 + n) (stream-local, n <= kWarpMbs) of stream st into
// rows, zeroed rows of 64 levels in shared memory: the coded block of
// ordinal k at row k - k0, k0 the first macroblock's first ordinal (*k0
// gets it).  Returns the rows: the macroblocks' coded ordinals below n_blk,
// consecutive from k0.  One warp.  The loads of the warp's macroblocks go
// out together, in three rounds: the macroblocks' words, then their
// ordinal bounds (lane 8q + r: bound r of macroblock q), then each one's
// first chunk of pairs.  Checked: `room` levels of the tile are left from
// rows on.
__device__ int scatter_mbs(const Wire& w, const Scratch& s, int st, int i0,
                           int n, int16_t* rows, int* k0 JT_ARG(int room)) {
  const int lane = threadIdx.x & 31;
  const uint32_t word =
      lane < n &&
              JT_OK(static_cast<long long>(st) * w.n_items + i0 + lane,
                    s.n_mbw)
          ? s.mbw[static_cast<long long>(st) * w.n_items + i0 + lane]
          : 0u;
  // ordinals with a bit-7 pair start at it; ordinal 0 at pair 0; the
  // others at P, as does the end of ordinal n_blk - 1.  Every bound is cut
  // after the stream's last pair with bit 6 clear.
  const bool st_ok = JT_OK(st, w.n_streams);
  const int named = min(st_ok ? s.n_b7[st] : 0, w.n_blk);
  const int live_hi = st_ok ? s.live1[st] : 0;
  const int first = static_cast<int>(__shfl_sync(kFull, word, 0) >> 6);
  int n_c[kWarpMbs], at[kWarpMbs], n_rows = 0;
#pragma unroll
  for (int q = 0; q < kWarpMbs; ++q) {
    const uint32_t wq = __shfl_sync(kFull, word, q);
    // the macroblock's coded ordinals below n_blk (the rest have no row)
    n_c[q] = min(__popc(wq & 63u),
                 max(w.n_blk - static_cast<int>(wq >> 6), 0));
    at[q] = static_cast<int>(wq >> 6) - first;
    n_rows += n_c[q];
  }
  const int mq = lane >> 3, r = lane & 7;
  const int k = static_cast<int>(__shfl_sync(kFull, word, mq) >> 6) + r;
  int n_cq = 0;
#pragma unroll
  for (int q = 0; q < kWarpMbs; ++q) n_cq = mq == q ? n_c[q] : n_cq;
  int bound = 0;
  if (r <= n_cq && n_cq) {
    bound = k == 0 ? 0
            : k < named
                ? (JT_OK(static_cast<long long>(st) * w.n_blk + k, s.n_first)
                       ? s.first[static_cast<long long>(st) * w.n_blk + k]
                       : 0)
                : w.n_pairs;
    bound = min(bound, live_hi);
  }
  const uint32_t* pv = s.pv + static_cast<long long>(st) * w.pv_stride;
  int hi[kWarpMbs];
  uint32_t x[kWarpMbs];
#pragma unroll
  for (int q = 0; q < kWarpMbs; ++q) {
    hi[q] = __shfl_sync(kFull, bound, 8 * q + n_c[q]);
    const int p = __shfl_sync(kFull, bound, 8 * q) + lane;
    x[q] = n_c[q] && p < hi[q] && JT_OK(p, w.pv_stride) ? pv[p] : 0x40u;
  }
#pragma unroll
  for (int q = 0; q < kWarpMbs; ++q) {
    if (!n_c[q]) continue;
    int bnd[6];
#pragma unroll
    for (int b = 0; b < 6; ++b) bnd[b] = __shfl_sync(kFull, bound, 8 * q + b);
    scatter_mb(pv, bnd, hi[q], n_c[q], x[q],
               rows + at[q] * 64 JT_PASS(w.pv_stride)
                   JT_PASS(room - at[q] * 64));
  }
  *k0 = first;
  return n_rows;
}

// Stream st's rows past its coded blocks, [n_cod, n_blk) (a shorter
// stream's in a shared-size stack), zeroed with id -1: this warp's share,
// the g-th of `warps` equal shares.  One warp.
__device__ void pad_rows(const Wire& w, const Scratch& s, const Out& o,
                         int st, long long g, long long warps) {
  const long long cnt =
      min(JT_OK(st, w.n_streams) ? s.n_cod[st] : w.n_blk, w.n_blk);
  const long long pad = w.n_blk - cnt;
  if (pad <= 0) return;
  const long long share = (pad + warps - 1) / warps;
  const long long r0 = static_cast<long long>(st) * w.n_blk + cnt + g * share;
  const long long r1 = min(r0 + share, (st + 1ll) * w.n_blk);
  const int lane = threadIdx.x & 31;
  uint4* lv = reinterpret_cast<uint4*>(o.levels);
  for (long long e = r0 * 8 + lane; e < r1 * 8; e += 32)
    if (JT_OK_N(e * 8, 8, w.n_rows * 64)) lv[e] = make_uint4(0u, 0u, 0u, 0u);
  for (long long r = r0 + lane; r < r1; r += 32)
    if (JT_OK(r, w.n_rows)) o.blk_ids[r] = -1;
}

__global__ void __launch_bounds__(kWriteThreads, kWriteCtasPerSm)
write_kernel(Wire w, Scratch s, Out o) {
  __shared__ __align__(128) int16_t tile[kWriteMbs * kMbLevels];
  JT_BEGIN(1);
  const int per_frame = (w.n_mb + kWriteMbs - 1) / kWriteMbs;
  const int cta = static_cast<int>(blockIdx.x);
  const int tt = cta % per_frame, fs = cta / per_frame;
  const int f = fs % w.n_frames, st = fs / w.n_frames;
  const int warp = static_cast<int>(threadIdx.x) >> 5;
  // this warp's macroblocks: [m0, m0 + n) of frame f of stream st (none
  // when n <= 0: a frame's last tile may be short)
  const int m0 = tt * kWriteMbs + warp * kWarpMbs;
  const int n = min(kWarpMbs, w.n_mb - m0);
  const int lane = threadIdx.x & 31;
  int16_t* mb = tile + warp * kWarpMbs * kMbLevels;
  uint4* t4 = reinterpret_cast<uint4*>(mb);
#ifdef JT_CHECKED
  // the tile's levels from mb on; negative controls 5 and 6 go into block
  // 0's warp 0
  const int room = (kWriteMbs - warp * kWarpMbs) * kMbLevels;
  const bool plant = blockIdx.x == 0 && threadIdx.x < 32;
#endif
  for (int q = lane; q < n * kMbLevels / 8; q += 32)
    JT_SH_ST(t4, q, room / 8, make_uint4(0u, 0u, 0u, 0u));
  // everything below reads what launch A wrote
  asm volatile("griddepcontrol.wait;" ::: "memory");
  if (n > 0) {
    // negative control 5: the barrier after the zeroing skipped
    if (!JT_INJECT_AT(5, plant)) JT_SYNCWARP();
    int k0;
    const int rows =
        scatter_mbs(w, s, st, f * w.n_mb + m0, n, mb, &k0 JT_PASS(room));
    // the warp's generic-proxy stores, made visible to its bulk copy
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    JT_SYNCWARP();
    // negative control 6: the warp's lattice store skipped
    const long long at = (static_cast<long long>(st) * w.n_blk + k0) * 64;
    if (lane == 0 && rows && !JT_INJECT_AT(6, plant) &&
        JT_SH_OK(mb, 0, rows * 64, room, jt::kRead) &&
        JT_OK_N(at, rows * 64, w.n_rows * 64)) {
      const unsigned src =
          static_cast<unsigned>(__cvta_generic_to_shared(mb));
      asm volatile(
          "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::
              "l"(o.levels + at),
          "r"(src), "r"(rows * 128)
          : "memory");
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      // the tile must outlive the copy's reads of it
      asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
    }
  }
  pad_rows(w, s, o, st,
           (static_cast<long long>(f) * per_frame + tt) * kWriteWarps + warp,
           static_cast<long long>(w.n_frames) * per_frame * kWriteWarps);
}

struct Layout {
  long long ticket, live1, n_b7, n_cod, run_st, cod_st, pair_st, head,
      first, mbw, pv, bytes;
};

long long align128(long long x) { return (x + 127) & ~127ll; }

// The scratch bytes a caller provides: 8 a macroblock, pair and ordinal of
// each stream, 16 KB a stream and 1 KB, a rule that covers layout()'s
// size (checked by every call) without the caller knowing the layout.
long long scratch_rule(int n_streams, int n_items, int n_pairs, int n_blk) {
  return 8ll * n_streams * (static_cast<long long>(n_items) + n_pairs +
                            n_blk + 2048) + 1024;
}

Layout layout(int n_streams, int n_items, int n_pairs, int n_blk) {
  const long long S = n_streams;
  const long long mt = (n_items + kMbTile - 1) / kMbTile;
  const long long pt = (n_pairs + kPairTile - 1) / kPairTile;
  Layout l;
  l.ticket = 0;
  l.live1 = 8;
  l.n_b7 = l.live1 + 4 * S;
  l.n_cod = l.n_b7 + 4 * S;
  l.run_st = (l.n_cod + 4 * S + 7) & ~7ll;
  l.cod_st = l.run_st + 8 * S * mt;
  l.pair_st = l.cod_st + 8 * S * mt;
  l.head = l.pair_st + 8 * S * pt;
  l.first = align128(l.head);
  l.mbw = align128(l.first + 4 * S * n_blk);
  l.pv = align128(l.mbw + 4 * S * n_items);
  l.bytes = align128(l.pv + 4 * S * pt * kPairTile);
  return l;
}

}  // namespace

// Kernel launches of one jt_wire_unpack call (its memset aside).
extern "C" int jt_wire_unpack_launches() { return 2; }

// bufs: uint8 [n_streams, L] wires v2 at the shared sizes (n_frames, n_mb,
// n_runs, mv_wide, n_pairs, n_esc; every count >= 1); n_blk >= 1 coded-block
// ordinals per stream; scratch: scratch_bytes bytes, 128-byte aligned, at
// least 8 * n_streams * (n_frames * n_mb + n_pairs + n_blk + 2048) + 1024
// (scratch_rule; else cudaErrorInvalidValue, nothing launched).  Outputs:
// levels int16 [n_streams * n_blk, 64] (16-byte aligned: the bulk stores)
// and blk_ids int32 [n_streams * n_blk], the coded blocks' rows; over the
// joint [F, S*n_mb] macroblocks qscale uint8, coded bool [.., 6] (2-byte
// aligned), intra bool, written bool, mv_h / mv_v int32.  Queued
// on `stream`: the memset, launch A, launch B; returns the first non-zero
// error of any of them.
extern "C" int jt_wire_unpack(const void* bufs, long long stride,
                              int n_streams, int n_frames, int n_mb,
                              int n_runs, int mv_wide, int n_pairs, int n_esc,
                              int n_blk, void* scratch,
                              long long scratch_bytes, void* levels,
                              void* blk_ids, void* qscale, void* coded,
                              void* intra,
                              void* written, void* mv_h, void* mv_v,
                              void* stream) {
  if (n_streams <= 0 || n_frames <= 0 || n_mb <= 0) return 0;
  Wire w;
  w.buf = static_cast<const uint8_t*>(bufs);
  w.stride = stride;
  w.n_streams = n_streams;
  w.n_frames = n_frames;
  w.n_mb = n_mb;
  w.n_runs = n_runs;
  w.wide = mv_wide;
  w.n_pairs = n_pairs;
  w.n_esc = n_esc;
  w.n_blk = n_blk;
  w.n_items = n_frames * n_mb;
  w.mb_tiles = (w.n_items + kMbTile - 1) / kMbTile;
  w.pair_tiles = (n_pairs + kPairTile - 1) / kPairTile;
  w.pv_stride = w.pair_tiles * kPairTile;
  w.o_bm = n_frames;
  w.o_rec = w.o_bm + (static_cast<long long>(w.n_items) + 7) / 8;
  w.o_pos = w.o_rec + static_cast<long long>(mv_wide ? 8 : 4) * n_runs;
  w.o_v8 = w.o_pos + n_pairs;
  w.o_esc = w.o_v8 + n_pairs;
#ifdef JT_CHECKED
  w.bytes = stride * n_streams;
  w.n_out = static_cast<long long>(n_frames) * n_streams * n_mb;
  w.n_rows = static_cast<long long>(n_streams) * n_blk;
#endif

  const Layout l = layout(n_streams, w.n_items, n_pairs, n_blk);
  if (scratch_bytes < scratch_rule(n_streams, w.n_items, n_pairs, n_blk) ||
      l.bytes > scratch_rule(n_streams, w.n_items, n_pairs, n_blk))
    return static_cast<int>(cudaErrorInvalidValue);
  uint8_t* base = static_cast<uint8_t*>(scratch);
  Scratch s;
  s.ticket = reinterpret_cast<unsigned*>(base + l.ticket);
  s.live1 = reinterpret_cast<int*>(base + l.live1);
  s.n_b7 = reinterpret_cast<int*>(base + l.n_b7);
  s.n_cod = reinterpret_cast<int*>(base + l.n_cod);
  s.run_st = reinterpret_cast<unsigned long long*>(base + l.run_st);
  s.cod_st = reinterpret_cast<unsigned long long*>(base + l.cod_st);
  s.pair_st = reinterpret_cast<unsigned long long*>(base + l.pair_st);
  s.first = reinterpret_cast<int*>(base + l.first);
  s.mbw = reinterpret_cast<uint32_t*>(base + l.mbw);
  s.pv = reinterpret_cast<uint32_t*>(base + l.pv);
#ifdef JT_CHECKED
  s.n_first = static_cast<long long>(n_streams) * n_blk;
  s.n_mbw = static_cast<long long>(n_streams) * w.n_items;
  s.n_pv = static_cast<long long>(n_streams) * w.pv_stride;
#endif
  Out o;
  o.levels = static_cast<int16_t*>(levels);
  o.blk_ids = static_cast<int32_t*>(blk_ids);
  o.qscale = static_cast<uint8_t*>(qscale);
  o.coded = static_cast<bool*>(coded);
  o.intra = static_cast<bool*>(intra);
  o.written = static_cast<bool*>(written);
  o.mv_h = static_cast<int32_t*>(mv_h);
  o.mv_v = static_cast<int32_t*>(mv_v);

  const cudaStream_t cs = static_cast<cudaStream_t>(stream);
  int rc;
#ifdef JT_CHECKED
  {
    // A's shadow at 4-byte granules, B's at 2-byte
    const size_t shared[2] = {
        jt_shared_bytes(reinterpret_cast<const void*>(scan_kernel)),
        jt_shared_bytes(reinterpret_cast<const void*>(write_kernel))};
    const int shift[2] = {2, 1};
    const long long ctas[2] = {
        static_cast<long long>(n_streams) * (w.mb_tiles + w.pair_tiles),
        static_cast<long long>(n_streams) * n_frames *
            ((n_mb + kWriteMbs - 1) / kWriteMbs)};
    if ((rc = jt_configure(2, shared, shift, ctas, 0, 0, cs))) return rc;
  }
#endif
  if ((rc = static_cast<int>(cudaMemsetAsync(base, 0, l.head, cs))))
    return rc;
  scan_kernel<<<n_streams * (w.mb_tiles + w.pair_tiles), kScanThreads, 0,
                cs>>>(w, s, o);
  if ((rc = static_cast<int>(cudaGetLastError()))) return rc;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_streams * n_frames *
                     ((n_mb + kWriteMbs - 1) / kWriteMbs));
  cfg.blockDim = dim3(kWriteThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = cs;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if ((rc = static_cast<int>(cudaLaunchKernelEx(&cfg, write_kernel, w, s,
                                                o))))
    return rc;
  return static_cast<int>(cudaGetLastError());
}

#ifdef JT_CHECKED
JT_CHECKED_EXPORTS(wire_unpack)
#endif

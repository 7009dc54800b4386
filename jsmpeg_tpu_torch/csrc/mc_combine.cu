// K2: the frame loop of one batch -- half-pel motion compensation +
// residual combine of F pictures in one persistent, cooperative launch.
//
// Replaces: no Pallas kernel.  It does the work of jsmpeg_tpu's `lax.scan`
// over `decode_frame_step` (jsmpeg_tpu/ops/frame.py:235-269, driven from
// jsmpeg_tpu/models/mpeg1.py:80-125), whose step XLA lowers as three
// `_mc_gather` calls (with `chroma_mv`) and `_combine` in
// `decode_frame_planes` (jsmpeg_tpu/ops/frame.py:138).  Plain PyTorch
// version: jsmpeg_tpu_torch/ops/frame.py:decode_frames_ref.
//
// Semantics per pixel (reference jsmpeg/src/mpeg1.js:459-687): a written
// macroblock predicts from the forward plane at (y + (mv_v >> 1),
// x + (mv_h >> 1)) with the four taps offset by the half-pel parities,
// each tap clamped to the coded plane, pred = (a + b + c + d + 2) >> 2;
// an unwritten one keeps the stale `cur` pixel.  A coded block then
// replaces (intra) or adds to (non-intra, wrapping int32) that base with
// its residual, clamped to [0, 255].  Chroma vectors are
// sign(mv) * (|mv| >> 1).  Luma block 2*(py >= 8) + (px >= 8) holds pixel
// (py, px) at raster (py & 7) * 8 + (px & 7); Cb reads block 4, Cr block 5.
// Frame k reads fwd = output k-1 and cur = output k-2; frames 0 and 1 read
// the carried planes (the reference's pointer rotation,
// jsmpeg/src/mpeg1.js:220-246).
//
// Segments (the joint fleet modes, jsmpeg_tpu_torch/parallel/streams.py):
// the planes may hold n_seg streams stacked along macroblock rows, segment
// s owning luma rows [s * Hs, (s + 1) * Hs), Hs = H / n_seg, and chroma
// rows at half height.  A macroblock's reference rows clamp to its
// segment's rows, which is each stream's own frame-edge clamp
// (jsmpeg_tpu/ops/motion.py:67-72).  Segment s decodes frames
// k < seg_frames[s] only; at a later frame its rows of the output copy the
// forward plane's (jsmpeg_tpu/ops/frame.py:255-268, `keep`).  Validity is
// a prefix of the frames, so every later frame copies the same rows again
// and the rotation carries them unchanged.  seg_frames == nullptr: every
// segment decodes all F frames.  A launch with segments runs the kernel's
// kSegmented instantiation; a one-stream launch runs the other, which has
// none of the per-macroblock segment work (a division on the chain before
// the window loads cost 7 % of a 720p batch, PERF.md).
//
// Band mode (the tile axis across devices, jsmpeg_tpu's `_tiled_step`,
// jsmpeg_tpu/parallel/tiles.py:344, with `_mc_tiled_gather` :110 and
// `_combine`): a launch is ONE frame of one band of macroblock rows,
// [row0, row0 + mb_h_local) of the picture, for each of its n_seg segments
// (GOPs).  Rows above the band come from a top-halo buffer, the band's own
// rows from its forward plane, rows below from a bottom-halo buffer; the
// caller exchanges the halos between frames (jsmpeg_tpu_torch/parallel/
// tiles.py).  A tap row clamps to the picture's REAL rows [0, 16 * mb_h)
// in global rows, then maps to its source: the serial decode's clamp
// (jsmpeg_tpu clamps at its padded height, tiles.py:130, and differs from
// its own serial decode when the bands do not divide mb_h).  The halo
// covers the vectors' reach, so every clamped row lands in one of the
// three sources.  Segment s decodes the frame when frame < seg_frames[s],
// else its rows keep the forward plane's.  Its own instantiation, so the
// other two compile as before.
//
// Bound on the H100: bytes.  A 720p batch of 32 pictures reads up to 44 MB
// of uint8 reference pixels (the forward window where a macroblock is
// written, else the stale pixel, and neither for a coded intra block) and
// 1.4 MB of metadata, writes 44 MB of planes, and reads the int32
// residuals of its coded blocks only: about 34 us at 3.35 TB/s.  In 16-bit
// lanes a word of 4 predicted pixels costs about 37 integer operations and
// its combine 24, less time than the bytes.  What stands between the
// kernel and that bound is each macroblock's chain of dependent L2 round
// trips: the poll of the rows it reads, its window, the fence that
// publishes its stores.  With every warp on the same step of the chain at
// once, a round trip takes about 1 us, so a frame of the one-stream batch
// takes about 5 us; a joint launch, whose warps each walk many macroblocks
// of a frame, takes its macroblocks per warp times the chain (PERF.md,
// where chip_smoke.py and k2_sweep.py time the batch, one frame, frames
// that only copy the stale plane, and vectors that reach the previous
// frame's far edge).
//
// Design:
// - One cooperative launch per batch (F frames).  The grid is the
//   co-resident maximum (occupancy x SMs), capped so that each warp has a
//   macroblock.  There is no barrier between frames.  Warp w walks the
//   flattened index g = k * n_mb + mb (frame k, macroblock mb) from
//   g = w with the grid's stride, so the warps left over in one frame
//   start the next frame's first macroblocks.
// - Readiness flags: done[k][r] (zeroed by the caller; mb_h counts the
//   stacked rows of every segment) counts the macroblocks of row r of
//   output k that are stored; the row is ready at mb_w.  Each count has a
//   128-byte line of its own: packed, a frame's counts shared two lines,
//   and their polls and adds on one L2 slice made the batch 2.7x slower
//   (PERF.md).  A macroblock waits only for the rows it reads, from its
//   own metadata (wait_set below): a written one for the rows of output
//   k-1 under its 17-row luma and 9-row chroma windows, clamped as the
//   taps are (to its segment's rows, else to the plane); an unwritten one
//   whose blocks read their base (all but the coded intra blocks) for row
//   r of output k-2; one past its segment's count (kKeepFwd) for row r of
//   output k-1.  Frame 0, and frame 1's stale reads, read the carried
//   planes and wait for nothing.  A wait spans at most 3 rows (the luma
//   and chroma windows' starts differ by at most one luma row), so lane i
//   polls row r0 + i with ld.acquire.gpu, with a __nanosleep backoff,
//   until every lane sees its row ready.
// - Visibility: after its stores the warp syncs and a lane adds one to
//   the row's count with red.release.gpu, which covers every lane's stores
//   (the sync orders them before it).  A warp that walks m macroblocks of
//   each frame (a joint launch's frames are large) publishes them up to
//   min(m - 1, kPublishEvery) at a time, one fence for them all, and
//   always before it starts a macroblock of another frame: their readers
//   come about m macroblocks of the walk later.  With m = 1 (a 720p frame
//   is 1.1 grids) it publishes each at once.  A reader's acquire, then
//   __syncwarp, come before its window loads.  Planes this kernel writes
//   and reads again in a later frame are loaded through L2 only
//   (ld.global.cg, or cp.async.cg), never through the non-coherent
//   read-only path or L1: no `const __restrict__` on them and no __ldg.
//   Only `resid` and `meta`, which the kernel never writes, use __ldg.
// - Progress: every wait is for rows of an earlier frame, so on a smaller
//   g, and each warp walks its g in increasing order.  All warps are
//   resident (the cooperative launch) and none waits on a CTA barrier.
//   Take the smallest g not yet published: every g before it is, so the
//   warp that holds it finds every row it or its later macroblocks of the
//   same frame wait for complete, runs on to the frame's end or to its
//   publish count, and publishes it.  The loop cannot deadlock.  A wait
//   that still outlasts ~2^24 polls traps (a launch error, not a hung
//   card).
// - Nothing that does not depend on an earlier frame waits with the
//   chain: each warp holds the metadata of its next 10 macroblocks (one
//   word a lane) and loads the 10 after; once a macroblock is published,
//   the coded residuals of the next one are copied (cp.async) into the
//   warp's shared buffer and those of the one after are asked into L2 (in
//   flight at the publish, its fence would wait for them).
// - One warp per macroblock: lane l computes 3 words of 4 horizontally
//   adjacent pixels: luma word l (rows 0-7), luma word l + 32 (rows 8-15),
//   and chroma word l & 15 of Cr (lanes 0-15) or Cb (16-31).
// - A written macroblock stages its reference window in shared memory:
//   each of the 17 luma rows (clamped) as two aligned 16-byte copies, each
//   of the 9 Cr and 9 Cb rows as two aligned 8-byte loads, 70 in all, all
//   issued before any is waited for (issued one after another, the loads
//   cost three round trips).  The compute reads bytes o .. o + 3 of a
//   staged row as two words and a funnel shift, o = the window's offset in
//   its aligned row + 4 * word + the half-pel tap.  A window whose aligned
//   rows would pass the plane's left or right edge copies, per row, the
//   aligned block that holds all its clamped columns, then picks entry
//   [r][c] = fwd[clamp(sy0 + r)][clamp(sx0 + c)] out of it, offset 0,
//   which equals the per-tap clamps exactly.  The compute has no clamps
//   and no edge cases.
// - The 4-tap average runs in 16-bit lanes of 32-bit words (even and odd
//   bytes masked with 0x00FF00FF, max lane sum 1022, exact); the combine
//   per pixel in wrapping uint32 arithmetic; one uint32 store per word.
// - A band launch is one frame (n_frames == 1): its instantiation has no
//   flags and no waits.
// - CTA shape, from the -Xptxas -v report (build/jsmpeg_tpu_torch/
//   kernels_build.log), the occupancy and k2_sweep.py: 384 threads (12
//   macroblocks), at most 80 registers so 2 CTAs fit an SM, 39 KB of
//   shared memory each.  512 threads would need 52 KB, past the 48 KB of
//   a static allocation, and at their 64 registers the segmented form
//   spilled (PERF.md).
// - Checked build (-DJT_CHECKED, csrc/checked.cuh): every global and
//   shared access goes through its bounds accessor (the planes' and
//   halos' bytes, the residuals', metadata's, counts' and flags' words
//   in Params), the shared ones through the hazard shadow (byte
//   granules); every read of a row of an earlier output must be covered
//   by a wait of the warp that saw it complete (JT_WAITED / JT_READ_ROW),
//   and a publish must follow the stores it covers (JT_PUBLISHING); a
//   wait past its (scaled) spin limit is a recorded fault; seeded delays
//   sit before each publish and between a wait and the window's loads.
//   The luma window's compute reads one word past Window::y (the first
//   of Window::c; see Window), so its extent names that word.

#include <cstdint>

#include <cuda_runtime.h>

#define JT_FILE 2
#include "checked.cuh"

namespace {

constexpr int kThreads = 384;
constexpr int kWarps = kThreads / 32;               // one macroblock each
constexpr int kMinCtasPerSm = 2;                    // at most 80 registers
constexpr int kLumaWin = 17, kChromaWin = 9;        // staged rows = columns
// words per staged row: luma two 16-byte chunks (copied straight to shared
// memory, so rows stay 16-byte aligned), chroma two 8-byte ones and a pad
constexpr int kLumaPitch = 8, kChromaPitch = 5;
constexpr uint32_t kLanes = 0x00FF00FFu;
constexpr int kSpinNs = 32, kSpinMaxNs = 512;       // a wait's poll backoff
constexpr int kSpinLimit = JT_SPIN_SCALE(1 << 24);  // polls before a trap
// words from one row's count to the next: one 128-byte line each, so the
// polls and adds of a frame's rows spread over L2 slices
constexpr int kFlagStride = 32;
constexpr int kChunk = 10;   // macroblocks of metadata a warp holds (30 lanes)
// a warp's macroblocks of one frame published together, at most (<= 32)
constexpr int kPublishEvery = 8;

struct Params {
  const uint8_t* cur[3];   // carried planes y, cr, cb
  const uint8_t* fwd[3];
  const int32_t* resid;    // [F, n_mb, 6, 64]
  const int32_t* meta;     // [F, n_mb, 3]
  uint8_t* out[3];         // [F, H, W], [F, H/2, W/2] x 2
  unsigned int* done;      // [F, mb_h, kFlagStride] stored macroblocks per
                           // row (word 0), 0 at launch; null in band mode
  const int32_t* seg_frames;   // [n_seg] frames of each segment, or null
  int n_frames, mb_h, mb_w;
  int seg_mb_h;                // macroblock rows per segment
  // band mode only
  const uint8_t* top[3];       // [n_seg, halo rows, W] above each band
  const uint8_t* bot[3];       // [n_seg, halo rows, W] below each band
  int row0;                    // the band's first macroblock row
  int real_mb_h;               // the picture's macroblock rows (the clamp)
  int halo_mb;                 // halo macroblock rows
  int frame;                   // the frame's index in the segments' counts
#ifdef JT_CHECKED
  // extents: bytes of one luma / chroma plane of cur, fwd and each output
  // frame, of the top and bottom halo buffers (luma; chroma a quarter);
  // int32 elements of resid; entries of seg_frames (meta's are the
  // walk's total x 3, done's a frame's rows x kFlagStride each)
  long long luma_bytes, chroma_bytes, halo_bytes;
  long long n_resid;
  int n_seg;
#endif
};

// A macroblock's mode past its segment's last frame: not written, not
// coded, its base the forward plane's pixels.
constexpr int32_t kKeepFwd = 1 << 8;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

__device__ __forceinline__ int32_t chroma_mv(int32_t mv) {
  return mv >= 0 ? (mv >> 1) : -((-mv) >> 1);
}

// (a + b + c + d + 2) >> 2 on each of 4 packed bytes, in 16-bit lanes.
__device__ __forceinline__ uint32_t avg4(uint32_t a, uint32_t b, uint32_t c,
                                         uint32_t d) {
  const uint32_t even = (a & kLanes) + (b & kLanes) + (c & kLanes) +
                        (d & kLanes) + 0x00020002u;
  const uint32_t odd = ((a >> 8) & kLanes) + ((b >> 8) & kLanes) +
                       ((c >> 8) & kLanes) + ((d >> 8) & kLanes) + 0x00020002u;
  return ((even >> 2) & kLanes) | (((odd >> 2) & kLanes) << 8);
}

// 4 base pixels combined with their 4 residuals.
__device__ __forceinline__ uint32_t combine(uint32_t base, int4 r4,
                                            bool intra) {
  const int32_t r[4] = {r4.x, r4.y, r4.z, r4.w};
  uint32_t out = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t b = (base >> (8 * j)) & 0xFFu;
    const int32_t v =
        intra ? r[j]
              : static_cast<int32_t>(b + static_cast<uint32_t>(r[j]));
    out |= static_cast<uint32_t>(clampi(v, 0, 255)) << (8 * j);
  }
  return out;
}

// Wait until rows r0 .. r1 (r1 - r0 < 32) of one output are complete:
// their counts reach mb_w.  Lane i polls row r0 + i with acquire loads,
// backing off between polls; the warp syncs after, so every lane's later
// loads see the rows' stores.  A wait that outlasts kSpinLimit polls
// (seconds) traps, so a fault in the wait set fails the launch instead of
// hanging the card.
// Checked: `extent` is the frame's count words.
__device__ __forceinline__ void wait_rows(const unsigned int* done, int r0,
                                          int r1, int mb_w,
                                          int lane JT_ARG(long long extent)) {
  bool ready = r0 + lane > r1;
  for (int ns = kSpinNs, polls = 0;; ns = min(2 * ns, kSpinMaxNs)) {
    if (!ready) {
      unsigned int seen;
      if (JT_OK(static_cast<long long>(r0 + lane) * kFlagStride, extent))
        asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                     : "=r"(seen)
                     : "l"(done + (r0 + lane) * kFlagStride)
                     : "memory");
      else
        seen = static_cast<unsigned int>(mb_w);   // suppressed
      ready = seen >= static_cast<unsigned int>(mb_w);
    }
    if (__all_sync(0xFFFFFFFFu, ready)) break;
    if (++polls == kSpinLimit) JT_SPIN_OUT(ready = true);
    __nanosleep(ns);
  }
  JT_SYNCWARP();
}

// The warp's last n macroblocks' stores are issued (all of one frame, its
// counts `done`; lane i holds the row of the i-th): once every lane's
// stores are ordered before the adds (the warp's sync), lanes 0 .. n-1 add
// one to their rows' counts with release semantics, which makes the
// stores visible at GPU scope with them (one fence for the n).
// Checked: each lane stored 3 words of each of the n, and `extent` is
// the frame's count words.
__device__ __forceinline__ void publish(unsigned int* done, int row, int n,
                                        int lane JT_ARG(long long extent)) {
  JT_DELAY(1);
  JT_SYNCWARP();
  JT_PUBLISHING(n);
  if (lane < n && JT_OK(static_cast<long long>(row) * kFlagStride, extent))
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;"
                 :: "l"(done + row * kFlagStride) : "memory");
}

// One warp's staged reference window: rows of raw aligned words, row r
// holding the plane's bytes from column x0 - off on, where x0 is the
// window's left column (luma: 2 x 16 bytes from a 16-byte boundary;
// chroma: 2 x 8 bytes from an 8-byte boundary).  A window past the left or
// right edge holds the clamped bytes themselves, off = 0.  The last luma
// row's word 8 is read (and unused) past it: c follows.
struct __align__(16) Window {
  uint32_t y[kLumaWin * kLumaPitch];
  uint32_t c[2][kChromaWin * kChromaPitch];   // Cr, Cb
};
// the words the compute reads from y on: its rows and the word after
constexpr int kLumaReadWords = kLumaWin * kLumaPitch + 1;
constexpr int kChromaWords = kChromaWin * kChromaPitch;   // one plane's
constexpr int kLumaBytes = 4 * kLumaWin * kLumaPitch;

// A window past the left or right edge: each row's aligned block that
// holds all of its clamped columns (luma 32 bytes, chroma 16), before the
// clamp picks the window's bytes out of it.
struct __align__(16) EdgeRows {
  uint32_t y[kLumaWin * kLumaPitch];
  uint32_t c[2][kChromaWin * kChromaPitch];   // Cr, Cb
};

// One warp's shared memory: its window, edge rows, and the residual words
// of its macroblock, [j * 32 + lane] for word j of a lane.
struct __align__(16) WarpShared {
  Window win;
  EdgeRows edge;
  int4 res[3 * 32];
};

// 16 bytes from global to shared memory, asynchronously (through L2 only,
// as __ldcg); copy_wait() waits for the thread's copies.
__device__ __forceinline__ void copy16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               :: "r"(static_cast<unsigned>(__cvta_generic_to_shared(dst))),
                  "l"(src)
               : "memory");
}

__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// Bytes o .. o + 3 of a staged row (checked: `room` words readable from
// row on).
__device__ __forceinline__ uint32_t row_bytes(const uint32_t* row,
                                              int o JT_ARG(int room)) {
  return __funnelshift_r(JT_SH_LD(row, o >> 2, room),
                         JT_SH_LD(row, (o >> 2) + 1, room), 8 * (o & 3));
}

// The 4 predicted pixels at byte o of staged row r (half-pel ox, oy);
// checked: `extent` words of win readable.
__device__ __forceinline__ uint32_t predict(const uint32_t* win, int pitch,
                                            int r, int o, int ox,
                                            int oy JT_ARG(int extent)) {
  const uint32_t* r0 = win + r * pitch;
  const uint32_t* r1 = r0 + oy * pitch;
  return avg4(row_bytes(r0, o JT_PASS(extent - r * pitch)),
              row_bytes(r0, o + ox JT_PASS(extent - r * pitch)),
              row_bytes(r1, o JT_PASS(extent - (r + oy) * pitch)),
              row_bytes(r1, o + ox JT_PASS(extent - (r + oy) * pitch)));
}

// A warp's metadata chunk: the kChunk macroblocks g0 + j * stride of its
// walk, lane l holding word l % 3 of macroblock j = l / 3 (0 at or past
// the launch's total and in lanes 30 and 31).
__device__ __forceinline__ int32_t load_chunk(const int32_t* meta, int g0,
                                              int stride, int total,
                                              int lane) {
  const int64_t g = g0 + int64_t(lane / 3) * stride;
  return lane < 3 * kChunk && g < total &&
                 JT_OK(g * 3 + lane % 3, int64_t(total) * 3)
             ? __ldg(meta + g * 3 + lane % 3)
             : 0;
}

// Word f of the metadata of the chunk's macroblock di (di < kChunk).
__device__ __forceinline__ int32_t field(int32_t chunk, int di, int f) {
  return __shfl_sync(0xFFFFFFFFu, chunk, 3 * di + f);
}

// Word f of the metadata of the chunk's macroblock di (di < 2 * kChunk):
// from the chunk for di < kChunk, else from the next one.
__device__ __forceinline__ int32_t field(int32_t chunk, int32_t chunk_next,
                                         int di, int f) {
  const int src = 3 * (di < kChunk ? di : di - kChunk) + f;
  const int32_t a = __shfl_sync(0xFFFFFFFFu, chunk, src);
  const int32_t b = __shfl_sync(0xFFFFFFFFu, chunk_next, src);
  return di < kChunk ? a : b;
}

// Word j of a lane: luma word lane (rows 0-7) for j = 0, luma word
// lane + 32 (rows 8-15) for j = 1, and chroma word lane & 15 of Cr (lanes
// 0-15) or Cb (16-31) for j = 2.  Its row in the macroblock, its word in
// the row, its residual block and its raster offset there.
__device__ __forceinline__ void word_at(int lane, int j, int& py, int& wc,
                                        int& blk, int& ri) {
  if (j < 2) {
    const int i = lane + 32 * j;
    py = i >> 2;
    wc = i & 3;
    blk = ((py >> 3) << 1) | (wc >> 1);
    ri = (py & 7) * 8 + (wc & 1) * 4;
  } else {
    py = (lane & 15) >> 1;
    wc = lane & 1;
    blk = lane >= 16 ? 4 : 5;
    ri = py * 8 + wc * 4;
  }
}

// The residuals of the lane's words that lie in coded blocks, copied
// asynchronously to its slots res[j * 32 + lane] (the combine reads only
// coded words' slots).  Checked: resid_mb is element `at` of resid, which
// holds `extent`.
__device__ __forceinline__ void copy_resid(int4* res, const int32_t* resid_mb,
                                           int32_t mode,
                                           int lane JT_ARG(long long at)
                                               JT_ARG(long long extent)) {
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    int py, wc, blk, ri;
    word_at(lane, j, py, wc, blk, ri);
    if (((mode >> blk) & 1) && JT_OK_N(at + blk * 64 + ri, 4, extent) &&
        JT_SH_OK(res, j * 32 + lane, 1, 3 * 32, jt::kWrite))
      copy16(res + j * 32 + lane, resid_mb + blk * 64 + ri);
  }
}

// Ask L2 for the residual lines of a macroblock's coded blocks (lanes
// 0-11, two 128-byte lines a block).  Checked: as copy_resid.
__device__ __forceinline__ void prefetch_resid(const int32_t* resid_mb,
                                               int32_t mode,
                                               int lane JT_ARG(long long at)
                                                   JT_ARG(long long extent)) {
  if (lane < 12 && ((mode >> (lane >> 1)) & 1) &&
      JT_OK_N(at + lane * 32, 32, extent))
    asm volatile("prefetch.global.L2 [%0];" :: "l"(resid_mb + lane * 32));
}

// Where a plane's staged rows come from: row y (clamped to [lo, hi]) of
// `own`; in a band launch y is a global row, clamped to the picture's real
// rows and then read from the segment's top halo, its own rows (the first
// of them global row row0) or its bottom halo.
struct Src {
  const uint8_t* own;
  const uint8_t* top;   // band only
  const uint8_t* bot;   // band only
#ifdef JT_CHECKED
  // the buffers a row may come from (own's whole plane, the halos) and
  // their bytes; own's output frame (-1: a carried plane, which no wait
  // covers), its rows a macroblock row (log2) and the launch's rows
  const uint8_t *own_base, *top_base, *bot_base;
  long long own_bytes, top_bytes, bot_bytes;
  int frame, row_shift, mb_h;
#endif
};
struct Rows {
  int lo, hi, W;
  int row0, rows, halo;   // band only
};

template <bool kBand>
__device__ __forceinline__ const uint8_t* src_row(Src s, const Rows& g,
                                                  int y) {
  y = clampi(y, g.lo, g.hi);
  if constexpr (!kBand) {
    return s.own + y * g.W;
  } else {
    const int l = clampi(y - g.row0, -g.halo, g.rows + g.halo - 1);
    return l < 0 ? s.top + (l + g.halo) * g.W
                 : l < g.rows ? s.own + l * g.W
                              : s.bot + (l - g.rows) * g.W;
  }
}

#ifdef JT_CHECKED
// The n bytes at `at`, staged from s (rows of w bytes), lie in one of its
// buffers, and a row of an earlier output was waited for.
__device__ __forceinline__ bool k2_src_ok(const Src& s, const uint8_t* at,
                                          int n, int w, int site) {
  const auto in = [&](const uint8_t* base, long long bytes) {
    return base != nullptr && at >= base && at + n <= base + bytes;
  };
  if (in(s.own_base, s.own_bytes))
    return jt_read_row(s.frame,
                       static_cast<int>((at - s.own_base) / w) >> s.row_shift,
                       s.mb_h, site);
  if (in(s.top_base, s.top_bytes) || in(s.bot_base, s.bot_bytes))
    return true;
  jt_record(jt::kBoundsGlobal, site, at - s.own_base, s.own_bytes, -1);
  return false;
}
#define JT_K2_SRC_OK(s, at, n, w) k2_src_ok((s), (at), (n), (w), JT_SITE)
#else
#define JT_K2_SRC_OK(s, at, n, w) true
#endif

// A written macroblock's reference windows on their way to shared memory:
// the chroma loads held in registers until they arrive, and where the
// windows sit in their aligned rows.
struct Staging {
  uint2 cv[2];           // the lane's chroma loads
  int cd[2];             // their word offsets in Window::c, or -1
  int bx, bcx;           // the aligned rows' first columns
  bool inside;           // no clamp: the rows are the window's
};

// Issue the loads of a written macroblock's windows (whole warp): 17 luma
// rows x 2 16-byte copies, then 2 x 9 chroma rows x 2 8-byte loads, 70 in
// all, 3 a lane at most, none waited for here.  Luma rows come from `y`
// (geometry gy), chroma rows from `cr` / `cb` (geometry gc); sy, sx / cy,
// cx are the windows' first rows (in the geometry's numbering) and
// columns.  A window whose aligned rows would pass the plane's left or
// right edge loads, per row, the aligned block that holds all of its
// clamped columns into `edge` instead, the part of it that exists in a
// plane narrower than the block.  Checked: `past` plants negative control
// 3 (lane 0's first luma row read from past the plane's clamp).
template <bool kBand>
__device__ __forceinline__ Staging stage_issue(Window& win, EdgeRows& edge,
                                               int lane, Src y, Src cr,
                                               Src cb, const Rows& gy,
                                               const Rows& gc, int sy, int sx,
                                               int cy,
                                               int cx JT_ARG(bool past)) {
  const int W = gy.W, Wc = gc.W;
  Staging st;
  st.bx = sx & ~15;
  st.bcx = cx & ~7;
  st.inside = st.bx >= 0 && st.bx + 32 <= W && st.bcx >= 0 &&
              st.bcx + 16 <= Wc;
  if (!st.inside) {   // the aligned blocks nearest the window, in the plane
    st.bx = clampi(st.bx, 0, max(W - 32, 0));
    st.bcx = clampi(st.bcx, 0, max(Wc - 16, 0));
  }
  uint32_t* const dy = st.inside ? win.y : edge.y;
  st.cd[0] = st.cd[1] = -1;
#pragma unroll
  for (int it = 0; it < 3; ++it) {
    const int i = lane + 32 * it;
    if (i < 2 * kLumaWin) {
      const int r = i >> 1, h = i & 1;
      if (st.bx + 16 * h < W) {
        const uint8_t* at = src_row<kBand>(y, gy, sy + r) + st.bx + 16 * h;
#ifdef JT_CHECKED
        if (past && i == 0) at = y.own + (gy.hi + 1) * W + st.bx;
#endif
        if (JT_SH_OK(dy, r * kLumaPitch + 4 * h, 4, kLumaWin * kLumaPitch,
                     jt::kWrite) &&
            JT_K2_SRC_OK(y, at, 16, W))
          copy16(dy + r * kLumaPitch + 4 * h, at);
      }
    } else if (it >= 1 && i < 2 * kLumaWin + 4 * kChromaWin) {
      const int j = i - 2 * kLumaWin;
      const int pl = j >= 2 * kChromaWin;   // 0 Cr, 1 Cb
      const int jj = j - pl * 2 * kChromaWin;
      const int r = jj >> 1, h = jj & 1;
      if (st.bcx + 8 * h < Wc) {
        const uint8_t* at =
            src_row<kBand>(pl ? cb : cr, gc, cy + r) + st.bcx + 8 * h;
        st.cv[it - 1] = JT_K2_SRC_OK(pl ? cb : cr, at, 8, Wc)
                            ? __ldcg(reinterpret_cast<const uint2*>(at))
                            : make_uint2(0u, 0u);
        st.cd[it - 1] = pl * kChromaWin * kChromaPitch + r * kChromaPitch +
                        2 * h;
      }
    }
  }
  return st;
}

// Finish the windows once the lane's copies have arrived (whole warp; the
// caller syncs after): store the chroma loads and, for a window past an
// edge, pick entry [r][c] = row[clamp(sx + c)] out of the aligned blocks.
// Sets off_y / off_c to the byte offsets of the windows' left columns in
// their staged rows (0 after a pick).  The compute has no clamps.
__device__ __forceinline__ void stage_finish(Window& win, EdgeRows& edge,
                                             const Staging& st, int lane,
                                             int W, int sx, int cx,
                                             int& off_y, int& off_c) {
  const int Wc = W / 2;
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    if (st.cd[q] >= 0) {
      uint32_t* const d =
          (st.inside ? &win.c[0][0] : &edge.c[0][0]) + st.cd[q];
      JT_SH_ST(d, 0, 2 * kChromaWords - st.cd[q], st.cv[q].x);
      JT_SH_ST(d, 1, 2 * kChromaWords - st.cd[q], st.cv[q].y);
    }
  }
  if (st.inside) {
    off_y = sx - st.bx;
    off_c = cx - st.bcx;
    return;
  }
  off_y = off_c = 0;
  JT_SYNCWARP();
  uint8_t* const wy = reinterpret_cast<uint8_t*>(win.y);
#pragma unroll
  for (int it = 0; it < (kLumaWin * kLumaWin + 31) / 32; ++it) {
    const int i = lane + 32 * it;
    if (i < kLumaWin * kLumaWin) {
      const int r = i / kLumaWin, c = i - r * kLumaWin;
      JT_SH_ST(wy, r * 4 * kLumaPitch + c, kLumaBytes,
               JT_SH_LD(reinterpret_cast<const uint8_t*>(
                            edge.y + r * kLumaPitch),
                        clampi(sx + c, 0, W - 1) - st.bx,
                        kLumaBytes - 4 * r * kLumaPitch));
    }
  }
#pragma unroll
  for (int it = 0; it < (2 * kChromaWin * kChromaWin + 31) / 32; ++it) {
    const int i = lane + 32 * it;
    if (i < 2 * kChromaWin * kChromaWin) {
      const int pl = i >= kChromaWin * kChromaWin;   // 0 Cr, 1 Cb
      const int j = i - pl * kChromaWin * kChromaWin;
      const int r = j / kChromaWin, c = j - r * kChromaWin;
      JT_SH_ST(reinterpret_cast<uint8_t*>(win.c[pl]),
               r * 4 * kChromaPitch + c, 4 * kChromaWords,
               JT_SH_LD(reinterpret_cast<const uint8_t*>(
                            edge.c[pl] + r * kChromaPitch),
                        clampi(cx + c, 0, Wc - 1) - st.bcx,
                        4 * (kChromaWords - r * kChromaPitch)));
    }
  }
}

// A macroblock's mode: its metadata's, or, past its segment's frame count
// (k, the frame's index in the counts), kKeepFwd.
template <bool kSegmented>
__device__ __forceinline__ int32_t effective_mode(const Params& p,
                                                  int32_t mb_mode, int k,
                                                  int seg) {
  if constexpr (!kSegmented) {
    return mb_mode;
  } else {
    return !p.seg_frames ||
                   k < (JT_OK(seg, p.n_seg) ? __ldg(p.seg_frames + seg) : 0)
               ? mb_mode & 0xFF
               : kKeepFwd;
  }
}

// The rows a macroblock of frame k at macroblock row `row` (of the stacked
// rows) waits for before it reads: rows r0 .. r1 of output wk, or none
// (wk = -1).  Its segment, effective mode and vertical vector.  A written
// one waits for the rows of output k-1 under its 17-row luma and 9-row
// chroma windows, each row clamped to its segment's rows as the taps are.
// Mirrors ops/frame.py:k2_wait_rows.
template <bool kSegmented>
__device__ __forceinline__ void wait_set(const Params& p, int k, int row,
                                         int seg, int32_t mode, int32_t mv_v,
                                         int& wk, int& r0, int& r1) {
  wk = -1;
  r0 = r1 = row;
  if ((mode >> 7) & 1) {   // written: the windows of output k-1
    if (k < 1) return;
    wk = k - 1;
    const int lo = kSegmented ? seg * p.seg_mb_h * 16 : 0;
    const int hi = kSegmented ? lo + p.seg_mb_h * 16 - 1 : p.mb_h * 16 - 1;
    const int sy = row * 16 + (mv_v >> 1);
    const int cy = row * 8 + (chroma_mv(mv_v) >> 1);
    r0 = min(clampi(sy, lo, hi) >> 4, clampi(cy, lo >> 1, hi >> 1) >> 3);
    r1 = max(clampi(sy + kLumaWin - 1, lo, hi) >> 4,
             clampi(cy + kChromaWin - 1, lo >> 1, hi >> 1) >> 3);
  } else if (kSegmented && (mode & kKeepFwd)) {   // row r of output k-1
    if (k >= 1) wk = k - 1;
  } else if (!(((mode >> 6) & 1) && (mode & 0x3F) == 0x3F)) {
    if (k >= 2) wk = k - 2;       // a block reads the stale base
  }
}

// kSegmented: the launch has segments (n_seg > 1, or frame counts).  The
// one-stream launch compiles without their per-macroblock division and
// test.  kBand (with kSegmented): a band launch of one frame, without
// flags or waits.
template <bool kSegmented, bool kBand>
__global__ void __launch_bounds__(kThreads, kMinCtasPerSm)
frame_loop_kernel(Params p) {
  __shared__ WarpShared shared[kWarps];
  JT_BEGIN(0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  WarpShared& ws = shared[warp];
  const int cpl = lane >> 4;   // word 2's plane: 0 Cr, 1 Cb
  const int mb_w = p.mb_w, n_mb = p.mb_h * p.mb_w;
  const int W = mb_w * 16, H = p.mb_h * 16, Wc = W / 2;
  const int64_t luma = int64_t(H) * W, chroma = luma / 4;
  const int stride = gridDim.x * kWarps;

  // the warp walks g = k * n_mb + mb from its own index up, by the stride
  const int first = blockIdx.x * kWarps + warp, total = p.n_frames * n_mb;
  if (first >= total) return;
  // metadata in chunks of kChunk macroblocks of the walk, the next chunk
  // loading while this one is used
  int32_t chunk = load_chunk(p.meta, first, stride, total, lane);
  int32_t chunk_next =
      load_chunk(p.meta, first + kChunk * stride, stride, total, lane);
  copy_resid(ws.res, p.resid + int64_t(first) * 384, field(chunk, 0, 2),
             lane JT_PASS(int64_t(first) * 384) JT_PASS(p.n_resid));
  // the walk's position as frame k, macroblock row and column, stepped
  // without divisions
  const int step_rows = stride / mb_w, step_cols = stride - step_rows * mb_w;
  int k = first / n_mb, mb_row = (first - k * n_mb) / mb_w;
  int mb_col = first - k * n_mb - mb_row * mb_w;
  // macroblocks stored but not yet published, lane i holding the row of
  // the i-th; at most one fewer than the warp walks in a frame, so that a
  // pending macroblock's readers, a frame on in the walk, come after its
  // publish
  int pending = 0, pending_row = 0;
  const int publish_every = clampi(n_mb / stride - 1, 1, kPublishEvery);
#ifdef JT_CHECKED
  // negative controls 2-4 go into this warp's first macroblock that can
  // take them, in block 0's warp 0
  bool plant = blockIdx.x == 0 && warp == 0;
  const long long flag_words = int64_t(p.mb_h) * kFlagStride;
#endif
  // di: the macroblock's place in its chunk
  for (int di = 0, g = first; g < total; g += stride) {
    const int seg = kSegmented ? mb_row / p.seg_mb_h : 0;
    const int32_t mv_h = field(chunk, di, 0), mv_v = field(chunk, di, 1);
    const int32_t mode = effective_mode<kSegmented>(
        p, field(chunk, di, 2), k + (kBand ? p.frame : 0), seg);
    const bool intra = (mode >> 6) & 1, written = (mode >> 7) & 1;
    const int32_t cmv_h = chroma_mv(mv_h), cmv_v = chroma_mv(mv_v);
    if constexpr (!kBand) {
      int wk, r0, r1;
      wait_set<kSegmented>(p, k, mb_row, seg, mode, mv_v, wk, r0, r1);
#ifdef JT_CHECKED
      // negative control 2: the first wait skipped
      const bool skip = wk >= 0 && plant && JT_INJECT(2);
      plant &= !skip;
#else
      constexpr bool skip = false;
#endif
      if (wk >= 0 && !skip && JT_OK(wk, p.n_frames)) {
        wait_rows(p.done + int64_t(wk) * p.mb_h * kFlagStride, r0, r1, mb_w,
                  lane JT_PASS(flag_words));
        JT_WAITED(wk, r0, r1, p.mb_h);
      }
      JT_DELAY(2);
    }

    // scalars, not arrays: a dynamically indexed array lands in local memory
    uint8_t* const out_y = p.out[0] + k * luma;
    uint8_t* const out_cr = p.out[1] + k * chroma;
    uint8_t* const out_cb = p.out[2] + k * chroma;
    const uint8_t* const fwd_y = k >= 1 ? out_y - luma : p.fwd[0];
    const uint8_t* const fwd_cr = k >= 1 ? out_cr - chroma : p.fwd[1];
    const uint8_t* const fwd_cb = k >= 1 ? out_cb - chroma : p.fwd[2];

    // the windows' copies, then wait for them and the residuals'
    Staging st;
    const int sx = mb_col * 16 + (mv_h >> 1), cx = mb_col * 8 + (cmv_h >> 1);
    if (written) {   // uniform across the warp
      const int ylo = kSegmented && !kBand ? seg * p.seg_mb_h * 16 : 0;
      const int yhi = kSegmented && !kBand ? ylo + p.seg_mb_h * 16 - 1 : H - 1;
      Src src_y{fwd_y, nullptr, nullptr}, src_cr{fwd_cr, nullptr, nullptr},
          src_cb{fwd_cb, nullptr, nullptr};
      Rows gy{ylo, yhi, W, 0, 0, 0}, gc{ylo >> 1, yhi >> 1, Wc, 0, 0, 0};
      int row = mb_row;   // the macroblock's row in the rows' numbering
      if constexpr (kBand) {
        // global rows, clamped to the picture's real rows; the segment's
        // own rows and halos
        const int rows = p.seg_mb_h * 16, halo = p.halo_mb * 16;
        const int64_t o = int64_t(seg) * rows * W;
        const int64_t oh = int64_t(seg) * halo * W;
        src_y = {fwd_y + o, p.top[0] + oh, p.bot[0] + oh};
        src_cr = {fwd_cr + o / 4, p.top[1] + oh / 4, p.bot[1] + oh / 4};
        src_cb = {fwd_cb + o / 4, p.top[2] + oh / 4, p.bot[2] + oh / 4};
        gy = {0, p.real_mb_h * 16 - 1, W, p.row0 * 16, rows, halo};
        gc = {0, p.real_mb_h * 8 - 1, Wc, p.row0 * 8, rows / 2, halo / 2};
        row = p.row0 + mb_row - seg * p.seg_mb_h;
      }
#ifdef JT_CHECKED
      // the planes the windows read (output k - 1, or the carried fwd) and,
      // in a band launch, the halos
      Src* const srcs[3] = {&src_y, &src_cr, &src_cb};
      for (int q = 0; q < 3; ++q) {
        const long long bytes = q ? p.chroma_bytes : p.luma_bytes;
        srcs[q]->own_base = q == 0 ? fwd_y : q == 1 ? fwd_cr : fwd_cb;
        srcs[q]->own_bytes = bytes;
        srcs[q]->top_base = kBand ? p.top[q] : nullptr;
        srcs[q]->bot_base = kBand ? p.bot[q] : nullptr;
        srcs[q]->top_bytes = srcs[q]->bot_bytes =
            q ? p.halo_bytes / 4 : p.halo_bytes;
        srcs[q]->frame = !kBand && k >= 1 ? k - 1 : -1;
        srcs[q]->row_shift = q ? 3 : 4;
        srcs[q]->mb_h = p.mb_h;
      }
      // negative control 3: a row past the plane's clamp
      const bool past = !kBand && plant && JT_INJECT(3);
      plant &= !past;
#endif
      JT_SYNCWARP();  // the previous macroblock is done with the window
      st = stage_issue<kBand>(ws.win, ws.edge, lane, src_y, src_cr, src_cb,
                              gy, gc, row * 16 + (mv_v >> 1), sx,
                              row * 8 + (cmv_v >> 1), cx JT_PASS(past));
    }
    copy_wait();
    int off_y = 0, off_c = 0;
    if (written) {
      stage_finish(ws.win, ws.edge, st, lane, W, sx, cx, off_y, off_c);
      JT_SYNCWARP();
    }

    // an unwritten macroblock's base words, all loaded before any is used;
    // a coded intra block does not read its base
    uint32_t base[3] = {0, 0, 0};
    if (!written) {
      const uint8_t* const cur_y =
          k >= 2 ? out_y - 2 * luma : (k == 1 ? p.fwd[0] : p.cur[0]);
      const uint8_t* const cur_cr =
          k >= 2 ? out_cr - 2 * chroma : (k == 1 ? p.fwd[1] : p.cur[1]);
      const uint8_t* const cur_cb =
          k >= 2 ? out_cb - 2 * chroma : (k == 1 ? p.fwd[2] : p.cur[2]);
#ifdef JT_CHECKED
      // the output frames they are (-1: a carried plane)
      const int cur_frame = !kBand && k >= 2 ? k - 2 : -1;
      const int fwd_frame = !kBand && k >= 1 ? k - 1 : -1;
#endif
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        int py, wc, blk, ri;
        word_at(lane, j, py, wc, blk, ri);
        const bool chroma_word = j == 2;
        const int bs = chroma_word ? 8 : 16;   // macroblock size in the plane
        const int off =
            (mb_row * bs + py) * (chroma_word ? Wc : W) + mb_col * bs + 4 * wc;
        if (kSegmented && (mode & kKeepFwd)) {
          if (JT_OK_N(off, 4, chroma_word ? p.chroma_bytes : p.luma_bytes) &&
              JT_READ_ROW(fwd_frame, mb_row, p.mb_h))
            base[j] = __ldcg(reinterpret_cast<const unsigned int*>(
                (chroma_word ? (cpl ? fwd_cb : fwd_cr) : fwd_y) + off));
        } else if (!(intra && ((mode >> blk) & 1))) {
          if (JT_OK_N(off, 4, chroma_word ? p.chroma_bytes : p.luma_bytes) &&
              JT_READ_ROW(cur_frame, mb_row, p.mb_h))
            base[j] = __ldcg(reinterpret_cast<const unsigned int*>(
                (chroma_word ? (cpl ? cur_cb : cur_cr) : cur_y) + off));
        }
      }
    }
#ifdef JT_CHECKED
    // negative control 4: a publish of this macroblock before its stores
    if constexpr (!kBand) {
      if (plant && JT_INJECT(4)) {
        publish(p.done + int64_t(k) * p.mb_h * kFlagStride, mb_row, 1,
                lane, flag_words);
        plant = false;
      }
    }
#endif
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      int py, wc, blk, ri;
      word_at(lane, j, py, wc, blk, ri);
      const bool chroma_word = j == 2;
      const int bs = chroma_word ? 8 : 16;   // macroblock size in the plane
      const int off =
          (mb_row * bs + py) * (chroma_word ? Wc : W) + mb_col * bs + 4 * wc;
      const bool coded = (mode >> blk) & 1;
      if (written)
        base[j] = chroma_word
                      ? predict(ws.win.c[cpl], kChromaPitch, py,
                                off_c + 4 * wc, cmv_h & 1,
                                cmv_v & 1 JT_PASS(kChromaWords))
                      : predict(ws.win.y, kLumaPitch, py, off_y + 4 * wc,
                                mv_h & 1, mv_v & 1 JT_PASS(kLumaReadWords));
      const uint32_t v =
          coded ? combine(base[j], JT_SH_LD(ws.res, j * 32 + lane, 3 * 32),
                          intra)
                : base[j];
      if (JT_OK_N(off, 4, chroma_word ? p.chroma_bytes : p.luma_bytes))
        *reinterpret_cast<uint32_t*>(
            (chroma_word ? (cpl ? out_cb : out_cr) : out_y) + off) = v;
      JT_STORED();
    }

    // the walk's next macroblock
    int k_next = k, row_next = mb_row + step_rows;
    int col_next = mb_col + step_cols;
    if (col_next >= mb_w) {
      col_next -= mb_w;
      ++row_next;
    }
    for (; row_next >= p.mb_h; row_next -= p.mb_h) ++k_next;
    if constexpr (!kBand) {
      // publish with the warp's next macroblocks of this frame, at most
      // publish_every, and before any of another frame
      if (lane == pending) pending_row = mb_row;
      if (++pending == publish_every || k_next != k || g + stride >= total) {
        if (JT_OK(k, p.n_frames))
          publish(p.done + int64_t(k) * p.mb_h * kFlagStride, pending_row,
                  pending, lane JT_PASS(flag_words));
        pending = 0;
      }
    }

    // after the publish, whose fence would wait for them: the next
    // macroblock's residuals into shared memory, the one's after into L2
    if (g + stride < total)
      copy_resid(ws.res, p.resid + int64_t(g + stride) * 384,
                 field(chunk, chunk_next, di + 1, 2),
                 lane JT_PASS(int64_t(g + stride) * 384) JT_PASS(p.n_resid));
    if (g + 2 * stride < total)
      prefetch_resid(p.resid + int64_t(g + 2 * stride) * 384,
                     field(chunk, chunk_next, di + 2, 2),
                     lane JT_PASS(int64_t(g + 2 * stride) * 384)
                         JT_PASS(p.n_resid));
    if (++di == kChunk) {   // the next chunk's metadata starts loading
      di = 0;
      chunk = chunk_next;
      chunk_next = load_chunk(p.meta, g + (kChunk + 1) * stride, stride,
                              total, lane);
    }
    k = k_next;
    mb_row = row_next;
    mb_col = col_next;
  }
}

// CTAs of a cooperative launch of `kernel` over n_mb macroblocks (of all
// its frames) on the current device: the co-resident maximum, capped at
// n_mb.  Returns a cudaError_t.
int grid_size(const void* kernel, int n_mb, int* grid) {
  int dev = 0, n_sm = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, kThreads, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  *grid = min(per_sm * n_sm, (n_mb + kWarps - 1) / kWarps);
  return *grid > 0 ? 0 : static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
}

// The planes, residuals and counts of a launch (the band fields zero).
Params make_params(const void* cur_y, const void* cur_cr, const void* cur_cb,
                   const void* fwd_y, const void* fwd_cr, const void* fwd_cb,
                   const void* resid, const void* meta, void* out_y,
                   void* out_cr, void* out_cb, const void* seg_frames,
                   int n_frames, int mb_h, int mb_w, int n_seg) {
  Params p = {};
  p.cur[0] = static_cast<const uint8_t*>(cur_y);
  p.cur[1] = static_cast<const uint8_t*>(cur_cr);
  p.cur[2] = static_cast<const uint8_t*>(cur_cb);
  p.fwd[0] = static_cast<const uint8_t*>(fwd_y);
  p.fwd[1] = static_cast<const uint8_t*>(fwd_cr);
  p.fwd[2] = static_cast<const uint8_t*>(fwd_cb);
  p.resid = static_cast<const int32_t*>(resid);
  p.meta = static_cast<const int32_t*>(meta);
  p.out[0] = static_cast<uint8_t*>(out_y);
  p.out[1] = static_cast<uint8_t*>(out_cr);
  p.out[2] = static_cast<uint8_t*>(out_cb);
  p.seg_frames = static_cast<const int32_t*>(seg_frames);
  p.n_frames = n_frames;
  p.mb_h = mb_h;
  p.mb_w = mb_w;
  p.seg_mb_h = mb_h / n_seg;
#ifdef JT_CHECKED
  p.luma_bytes = 256ll * mb_h * mb_w;
  p.chroma_bytes = p.luma_bytes / 4;
  p.n_resid = 384ll * n_frames * mb_h * mb_w;
  p.n_seg = n_seg;
#endif
  return p;
}

// One cooperative launch of `kernel` over p's macroblocks.  Returns the
// launch's cudaError_t, else cudaGetLastError().
int launch(const void* kernel, Params& p, void* stream) {
  int grid = 0;
  if (const int rc = grid_size(kernel, p.n_frames * p.mb_h * p.mb_w, &grid))
    return rc;
#ifdef JT_CHECKED
  {
    // the shadow at byte granules, a slot a CTA; the waited rows' bits, a
    // row of words a warp
    const size_t shared = jt_shared_bytes(kernel);
    const int shift = 0;
    const long long ctas = grid;
    const long long words =
        p.done ? (static_cast<long long>(p.n_frames) * p.mb_h + 31) / 32 : 0;
    if (const int rc = jt_configure(1, &shared, &shift, &ctas, words,
                                    ctas * kWarps,
                                    static_cast<cudaStream_t>(stream)))
      return rc;
  }
#endif
  void* args[] = {&p};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      kernel, dim3(grid), dim3(kThreads), args, 0,
      static_cast<cudaStream_t>(stream));
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(e != cudaSuccess ? e : last);
}

}  // namespace

// The grid jt_mc_combine launches for n_mb macroblocks in all (frames x
// macroblocks a frame) of one stream on the current device, or minus a
// cudaError_t.
extern "C" int jt_mc_combine_grid(int n_mb) {
  int grid = 0;
  const int rc = grid_size(
      reinterpret_cast<const void*>(frame_loop_kernel<false, false>), n_mb,
      &grid);
  return rc ? -rc : grid;
}

// The int32 words of jt_mc_combine's zeroed `done` for n_frames frames of
// mb_h macroblock rows.
extern "C" long long jt_mc_combine_flag_words(int n_frames, int mb_h) {
  return static_cast<long long>(n_frames) * mb_h * kFlagStride;
}

// cur_* / fwd_*: the carried uint8 planes (Y [16*mb_h, 16*mb_w], Cr and Cb
// [8*mb_h, 8*mb_w]); resid int32 [F, n_mb, 6, 64]; meta int32 [F, n_mb, 3]
// of (mv_h, mv_v, coded bits 0-5 | intra << 6 | written << 7); out_*: the
// F new pictures per plane; done: jt_mc_combine_flag_words(F, mb_h) zeroed
// int32 words (the readiness flags); seg_frames int32 [n_seg] on the
// device, each in [0, F], or null for F each (n_seg must divide mb_h).
// Planes 4-byte and resid 16-byte aligned.  Returns the launch's
// cudaError_t, else cudaGetLastError().
extern "C" int jt_mc_combine(const void* cur_y, const void* cur_cr,
                             const void* cur_cb, const void* fwd_y,
                             const void* fwd_cr, const void* fwd_cb,
                             const void* resid, const void* meta, void* out_y,
                             void* out_cr, void* out_cb, void* done,
                             const void* seg_frames, int n_frames, int mb_h,
                             int mb_w, int n_seg, void* stream) {
  if (n_seg <= 0 || mb_h % n_seg)
    return static_cast<int>(cudaErrorInvalidValue);
  if (mb_h * mb_w <= 0 || n_frames <= 0) return 0;
  const void* kernel =
      n_seg > 1 || seg_frames
          ? reinterpret_cast<const void*>(frame_loop_kernel<true, false>)
          : reinterpret_cast<const void*>(frame_loop_kernel<false, false>);
  Params p = make_params(cur_y, cur_cr, cur_cb, fwd_y, fwd_cr, fwd_cb, resid,
                         meta, out_y, out_cr, out_cb, seg_frames, n_frames,
                         mb_h, mb_w, n_seg);
  p.done = static_cast<unsigned int*>(done);
  return launch(kernel, p, stream);
}

// One frame of a band: planes cur/fwd/out [n_seg * 16 * mb_h_local,
// 16 * mb_w] (chroma half), the segments' bands stacked; top_* / bot_*
// [n_seg * 16 * halo_mb, 16 * mb_w] (chroma half) the halo rows above and
// below each segment's band; resid int32 [n_seg * mb_h_local * mb_w, 6, 64],
// meta int32 [.., 3]; seg_frames int32 [n_seg] (the segments' frame
// counts; null: all decode this frame).  The band's first macroblock row
// is row0 of a picture of real_mb_h rows.  Returns as jt_mc_combine.
extern "C" int jt_mc_combine_band(
    const void* cur_y, const void* cur_cr, const void* cur_cb,
    const void* fwd_y, const void* fwd_cr, const void* fwd_cb,
    const void* top_y, const void* top_cr, const void* top_cb,
    const void* bot_y, const void* bot_cr, const void* bot_cb,
    const void* resid, const void* meta, void* out_y, void* out_cr,
    void* out_cb, const void* seg_frames, int mb_h_local, int mb_w,
    int n_seg, int row0, int real_mb_h, int halo_mb, int frame,
    void* stream) {
  if (n_seg <= 0 || mb_h_local <= 0 || halo_mb < 0 || halo_mb > mb_h_local ||
      row0 < 0 || real_mb_h <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (mb_w <= 0) return 0;
  Params p = make_params(cur_y, cur_cr, cur_cb, fwd_y, fwd_cr, fwd_cb, resid,
                         meta, out_y, out_cr, out_cb, seg_frames, 1,
                         n_seg * mb_h_local, mb_w, n_seg);
  p.top[0] = static_cast<const uint8_t*>(top_y);
  p.top[1] = static_cast<const uint8_t*>(top_cr);
  p.top[2] = static_cast<const uint8_t*>(top_cb);
  p.bot[0] = static_cast<const uint8_t*>(bot_y);
  p.bot[1] = static_cast<const uint8_t*>(bot_cr);
  p.bot[2] = static_cast<const uint8_t*>(bot_cb);
  p.row0 = row0;
  p.real_mb_h = real_mb_h;
  p.halo_mb = halo_mb;
  p.frame = frame;
#ifdef JT_CHECKED
  p.halo_bytes = 256ll * n_seg * halo_mb * mb_w;
#endif
  return launch(
      reinterpret_cast<const void*>(frame_loop_kernel<true, true>), p,
      stream);
}

#ifdef JT_CHECKED
JT_CHECKED_EXPORTS(mc_combine)
#endif

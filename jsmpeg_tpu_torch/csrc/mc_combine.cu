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
// Bound on the H100: bytes, in the count; in practice the frame-to-frame
// barrier.  A 720p batch of 32 pictures reads up to 44 MB of uint8
// reference pixels (the forward window where a macroblock is written,
// else the stale pixel, and neither for a coded intra block) and 1.4 MB
// of metadata, writes 44 MB of planes, and reads the int32 residuals of
// its coded blocks only: about 34 us at 3.35 TB/s.  In 16-bit lanes a word of 4 predicted pixels costs about 37
// integer operations and its combine 24, less time than the bytes.  But
// each frame depends on the one before, so every frame pays a grid-wide
// barrier and, after it, a chain of dependent loads (the window, then the
// compute and the stores that the next barrier must see); chip_smoke.py
// times a batch of frames that only copy the stale plane beside the real
// one, and that floor takes most of a frame's time (PERF.md).
//
// Design:
// - One cooperative launch per batch (F frames).  The grid is the
//   co-resident maximum (occupancy x SMs), capped so that each warp has a
//   macroblock; warps walk a frame's macroblocks with a grid stride, and a
//   hand-written grid barrier (grid_barrier below; cooperative_groups'
//   grid.sync() measured slower) separates the frames.
// - Planes this kernel writes and reads again in a later frame are loaded
//   with ld.global.cg (__ldcg), never through the non-coherent read-only
//   path: no `const __restrict__` on them and no __ldg.  Only `resid` and
//   `meta`, which the kernel never writes, use __ldg.
// - One warp per macroblock, so warps never wait on each other inside a
//   frame: lanes 0-2 load the 3 metadata words and shuffle them to the
//   warp.  Lane l computes 3 words of 4 horizontally adjacent pixels: luma
//   word l (rows 0-7), luma word l + 32 (rows 8-15), and chroma word l & 15
//   of Cr (lanes 0-15) or Cb (16-31).  The residuals of coded blocks are
//   one 16-byte load per word, issued before the window; those of a frame's
//   first macroblock are loaded before the barrier that opens the frame,
//   since they do not depend on earlier frames.
// - A written macroblock stages its reference window in shared memory:
//   each of the 17 luma rows (clamped) as two aligned 16-byte loads, each
//   of the 9 Cr and 9 Cb rows as two aligned 8-byte loads, 70 loads a
//   warp.  The compute reads bytes o .. o + 3 of a staged row as two words
//   and a funnel shift, o = the window's offset in its aligned row + 4 *
//   word + the half-pel tap.  A window whose aligned rows would pass the
//   plane's left or right edge is staged byte by byte with the column
//   clamps applied, offset 0, so entry [r][c] = fwd[clamp(sy0 + r)]
//   [clamp(sx0 + c)], which equals the per-tap clamps exactly.  The compute
//   has no clamps and no edge cases.
// - The 4-tap average runs in 16-bit lanes of 32-bit words (even and odd
//   bytes masked with 0x00FF00FF, max lane sum 1022, exact); the combine
//   per pixel in wrapping uint32 arithmetic; one uint32 store per word.
// - CTA shape, from the -Xptxas -v report (build/jsmpeg_tpu_torch/
//   kernels_build.log) and the occupancy: 512 threads (16 macroblocks),
//   at most 64 registers so 2 CTAs fit an SM.  The grid then holds 4224
//   warps, more than a 720p frame's 3600 macroblocks, so a frame takes one
//   round; shapes of 128 to 1024 threads measured within 0.35 us a frame
//   of it once no registers spilled (PERF.md).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;               // one macroblock each
constexpr int kMinCtasPerSm = 2;                    // at most 64 registers
constexpr int kLumaWin = 17, kChromaWin = 9;        // staged rows = columns
constexpr int kLumaPitch = 9, kChromaPitch = 5;     // words per staged row
constexpr uint32_t kLanes = 0x00FF00FFu;

struct Params {
  const uint8_t* cur[3];   // carried planes y, cr, cb
  const uint8_t* fwd[3];
  const int32_t* resid;    // [F, n_mb, 6, 64]
  const int32_t* meta;     // [F, n_mb, 3]
  uint8_t* out[3];         // [F, H, W], [F, H/2, W/2] x 2
  unsigned int* arrived;   // the grid barrier's counter, 0 at launch
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

// Grid-wide barrier number `k` (0, 1, ...) on a counter that is 0 at
// launch: thread 0 of each CTA adds its arrival with release semantics
// (the CTA's writes, ordered before it by __syncthreads, become visible
// with it) and spins with acquire loads until every CTA has arrived.  The
// cooperative launch guarantees that all CTAs are resident, so the spin
// ends.
__device__ __forceinline__ void grid_barrier(unsigned int* arrived, int k) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned int target = (k + 1) * gridDim.x;
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;"
                 :: "l"(arrived) : "memory");
    unsigned int seen;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                   : "=r"(seen) : "l"(arrived) : "memory");
    } while (seen < target);
  }
  __syncthreads();
}

// One warp's staged reference window: rows of raw aligned words, row r
// holding the plane's bytes from column x0 - off on, where x0 is the
// window's left column (luma: 2 x 16 bytes from a 16-byte boundary;
// chroma: 2 x 8 bytes from an 8-byte boundary).  A window past the left or
// right edge is staged byte by byte with the clamps applied, off = 0.
struct Window {
  uint32_t y[kLumaWin * kLumaPitch];
  uint32_t c[2][kChromaWin * kChromaPitch];   // Cr, Cb
};

// Bytes o .. o + 3 of a staged row.
__device__ __forceinline__ uint32_t row_bytes(const uint32_t* row, int o) {
  return __funnelshift_r(row[o >> 2], row[(o >> 2) + 1], 8 * (o & 3));
}

// The 4 predicted pixels at byte o of staged row r (half-pel ox, oy).
__device__ __forceinline__ uint32_t predict(const uint32_t* win, int pitch,
                                            int r, int o, int ox, int oy) {
  const uint32_t* r0 = win + r * pitch;
  const uint32_t* r1 = r0 + oy * pitch;
  return avg4(row_bytes(r0, o), row_bytes(r0, o + ox), row_bytes(r1, o),
              row_bytes(r1, o + ox));
}

// The lane's 3 metadata words of macroblock `mb` (lanes 0-2; 0 elsewhere).
__device__ __forceinline__ int32_t load_meta(const int32_t* meta, int mb,
                                             int lane) {
  return lane < 3 ? __ldg(meta + mb * 3 + lane) : 0;
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

// The residuals of the lane's words that lie in coded blocks.
__device__ __forceinline__ void load_resid(int4 res[3],
                                           const int32_t* resid_mb,
                                           int32_t mode, int lane) {
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    int py, wc, blk, ri;
    word_at(lane, j, py, wc, blk, ri);
    res[j] = (mode >> blk) & 1
                 ? __ldg(reinterpret_cast<const int4*>(resid_mb + blk * 64 +
                                                        ri))
                 : make_int4(0, 0, 0, 0);
  }
}

// Where a plane's staged rows come from: row y (clamped to [lo, hi]) of
// `own`; in a band launch y is a global row, clamped to the picture's real
// rows and then read from the segment's top halo, its own rows (the first
// of them global row row0) or its bottom halo.
struct Src {
  const uint8_t* own;
  const uint8_t* top;   // band only
  const uint8_t* bot;   // band only
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

// Stage a written macroblock's windows (whole warp; the caller syncs) and
// set off_y / off_c to the byte offsets of the luma and chroma windows'
// left columns in their staged rows.  Luma rows come from `y` (geometry
// gy), chroma rows from `cr` / `cb` (geometry gc); sy / cy are the
// windows' first rows in the geometry's row numbering.
template <bool kBand>
__device__ __forceinline__ void stage(Window& win, int lane, Src y, Src cr,
                                      Src cb, const Rows& gy, const Rows& gc,
                                      int sy, int sx, int cy, int cx,
                                      int& off_y, int& off_c) {
  const int W = gy.W, Wc = gc.W;
  const int bx = sx & ~15, bcx = cx & ~7;   // aligned starts
  if (bx >= 0 && bx + 32 <= W && bcx >= 0 && bcx + 16 <= Wc) {
    off_y = sx - bx;
    off_c = cx - bcx;
    // 17 luma rows x 2 16-byte loads, then 2 x 9 chroma rows x 2 8-byte
    // loads: 70 loads, 3 a lane at most
#pragma unroll
    for (int it = 0; it < 3; ++it) {
      const int i = lane + 32 * it;
      if (i < 2 * kLumaWin) {
        const int r = i >> 1, h = i & 1;
        const uint4 v = __ldcg(reinterpret_cast<const uint4*>(
            src_row<kBand>(y, gy, sy + r) + bx + 16 * h));
        uint32_t* d = win.y + r * kLumaPitch + 4 * h;
        d[0] = v.x;
        d[1] = v.y;
        d[2] = v.z;
        d[3] = v.w;
      } else if (i < 2 * kLumaWin + 4 * kChromaWin) {
        const int j = i - 2 * kLumaWin;
        const int pl = j >= 2 * kChromaWin;   // 0 Cr, 1 Cb
        const int jj = j - pl * 2 * kChromaWin;
        const int r = jj >> 1, h = jj & 1;
        const uint2 v = __ldcg(reinterpret_cast<const uint2*>(
            src_row<kBand>(pl ? cb : cr, gc, cy + r) + bcx + 8 * h));
        uint32_t* d = win.c[pl] + r * kChromaPitch + 2 * h;
        d[0] = v.x;
        d[1] = v.y;
      }
    }
  } else {
    off_y = off_c = 0;
    uint8_t* const wy = reinterpret_cast<uint8_t*>(win.y);
    for (int i = lane; i < kLumaWin * kLumaWin; i += 32) {
      const int r = i / kLumaWin, c = i - r * kLumaWin;
      wy[r * 4 * kLumaPitch + c] =
          __ldcg(src_row<kBand>(y, gy, sy + r) + clampi(sx + c, 0, W - 1));
    }
    for (int i = lane; i < 2 * kChromaWin * kChromaWin; i += 32) {
      const int pl = i >= kChromaWin * kChromaWin;   // 0 Cr, 1 Cb
      const int j = i - pl * kChromaWin * kChromaWin;
      const int r = j / kChromaWin, c = j - r * kChromaWin;
      reinterpret_cast<uint8_t*>(win.c[pl])[r * 4 * kChromaPitch + c] =
          __ldcg(src_row<kBand>(pl ? cb : cr, gc, cy + r) +
                 clampi(cx + c, 0, Wc - 1));
    }
  }
}

// kSegmented: the launch has segments (n_seg > 1, or frame counts).  The
// one-stream launch compiles without their per-macroblock division and
// test, to the same code as before segments existed.  kBand (with
// kSegmented): a band launch of one frame.
template <bool kSegmented, bool kBand>
__global__ void __launch_bounds__(kThreads, kMinCtasPerSm)
frame_loop_kernel(Params p) {
  __shared__ Window windows[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  Window& win = windows[warp];
  const int cpl = lane >> 4;   // word 2's plane: 0 Cr, 1 Cb
  const int mb_w = p.mb_w, n_mb = p.mb_h * p.mb_w;
  const int W = mb_w * 16, H = p.mb_h * 16, Wc = W / 2;
  const int64_t luma = int64_t(H) * W, chroma = luma / 4;
  const int first = blockIdx.x * kWarps + warp, stride = gridDim.x * kWarps;

  // metadata and residuals do not depend on earlier frames: those of each
  // frame's first macroblock are loaded before the barrier that opens it
  int32_t m = 0;
  int4 res[3];
  if (first < n_mb) {
    m = load_meta(p.meta, first, lane);
    load_resid(res, p.resid + int64_t(first) * 384,
               __shfl_sync(0xFFFFFFFFu, m, 2), lane);
  }
  for (int k = 0; k < p.n_frames; ++k) {
    // scalars, not arrays: a dynamically indexed array lands in local memory
    uint8_t* const out_y = p.out[0] + k * luma;
    uint8_t* const out_cr = p.out[1] + k * chroma;
    uint8_t* const out_cb = p.out[2] + k * chroma;
    const uint8_t* const fwd_y = k >= 1 ? out_y - luma : p.fwd[0];
    const uint8_t* const fwd_cr = k >= 1 ? out_cr - chroma : p.fwd[1];
    const uint8_t* const fwd_cb = k >= 1 ? out_cb - chroma : p.fwd[2];
    const uint8_t* const cur_y =
        k >= 2 ? out_y - 2 * luma : (k == 1 ? p.fwd[0] : p.cur[0]);
    const uint8_t* const cur_cr =
        k >= 2 ? out_cr - 2 * chroma : (k == 1 ? p.fwd[1] : p.cur[1]);
    const uint8_t* const cur_cb =
        k >= 2 ? out_cb - 2 * chroma : (k == 1 ? p.fwd[2] : p.cur[2]);
    const int32_t* const meta = p.meta + int64_t(k) * n_mb * 3;
    const int32_t* const resid = p.resid + int64_t(k) * n_mb * 384;
    const bool next = k + 1 < p.n_frames && first < n_mb;
    const int32_t m_next = next ? load_meta(meta + n_mb * 3, first, lane) : 0;

    for (int mb = first; mb < n_mb; mb += stride) {
      if (mb != first) {
        m = load_meta(meta, mb, lane);
        load_resid(res, resid + int64_t(mb) * 384,
                   __shfl_sync(0xFFFFFFFFu, m, 2), lane);
      }
      const int mb_row = mb / mb_w, mb_col = mb - mb_row * mb_w;
      const int seg = kSegmented ? mb_row / p.seg_mb_h : 0;
      const int32_t mv_h = __shfl_sync(0xFFFFFFFFu, m, 0);
      const int32_t mv_v = __shfl_sync(0xFFFFFFFFu, m, 1);
      const int32_t mb_mode = __shfl_sync(0xFFFFFFFFu, m, 2);
      const int32_t mode =
          !kSegmented ? mb_mode
          : !p.seg_frames || k + (kBand ? p.frame : 0) <
                                 __ldg(p.seg_frames + seg)
              ? mb_mode & 0xFF
              : kKeepFwd;
      const bool intra = (mode >> 6) & 1, written = (mode >> 7) & 1;
      const int32_t cmv_h = chroma_mv(mv_h), cmv_v = chroma_mv(mv_v);

      int off_y = 0, off_c = 0;
      if (written) {   // uniform across the warp
        Src src_y{fwd_y, nullptr, nullptr}, src_cr{fwd_cr, nullptr, nullptr},
            src_cb{fwd_cb, nullptr, nullptr};
        Rows gy, gc;
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
        } else {
          const int ylo = kSegmented ? seg * p.seg_mb_h * 16 : 0;
          const int yhi = kSegmented ? ylo + p.seg_mb_h * 16 - 1 : H - 1;
          gy = {ylo, yhi, W, 0, 0, 0};
          gc = {ylo >> 1, yhi >> 1, Wc, 0, 0, 0};
        }
        __syncwarp();  // the previous macroblock is done with the window
        stage<kBand>(win, lane, src_y, src_cr, src_cb, gy, gc,
                     row * 16 + (mv_v >> 1), mb_col * 16 + (mv_h >> 1),
                     row * 8 + (cmv_v >> 1), mb_col * 8 + (cmv_h >> 1),
                     off_y, off_c);
        __syncwarp();
      }

#pragma unroll
      for (int j = 0; j < 3; ++j) {
        int py, wc, blk, ri;
        word_at(lane, j, py, wc, blk, ri);
        const bool chroma_word = j == 2;
        const int bs = chroma_word ? 8 : 16;   // macroblock size in the plane
        const int wp = chroma_word ? Wc : W;
        const int off = (mb_row * bs + py) * wp + mb_col * bs + 4 * wc;
        const bool coded = (mode >> blk) & 1;
        uint32_t base = 0;   // a coded intra block does not read its base
        if (written)
          base = chroma_word
                     ? predict(win.c[cpl], kChromaPitch, py, off_c + 4 * wc,
                               cmv_h & 1, cmv_v & 1)
                     : predict(win.y, kLumaPitch, py, off_y + 4 * wc,
                               mv_h & 1, mv_v & 1);
        else if (kSegmented && (mode & kKeepFwd))
          base = __ldcg(reinterpret_cast<const unsigned int*>(
              (chroma_word ? (cpl ? fwd_cb : fwd_cr) : fwd_y) + off));
        else if (!(intra && coded))
          base = __ldcg(reinterpret_cast<const unsigned int*>(
              (chroma_word ? (cpl ? cur_cb : cur_cr) : cur_y) + off));
        const uint32_t v = coded ? combine(base, res[j], intra) : base;
        *reinterpret_cast<uint32_t*>(
            (chroma_word ? (cpl ? out_cb : out_cr) : out_y) + off) = v;
      }
    }
    if (k + 1 < p.n_frames) {
      if (next) {
        m = m_next;
        load_resid(res, resid + int64_t(n_mb + first) * 384,
                   __shfl_sync(0xFFFFFFFFu, m, 2), lane);
      }
      grid_barrier(p.arrived, k);
    }
  }
}

// CTAs of a cooperative launch of `kernel` over n_mb macroblocks on the
// current device: the co-resident maximum, capped at n_mb.  Returns a
// cudaError_t.
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
  return p;
}

// One cooperative launch of `kernel` over p's macroblocks.  Returns the
// launch's cudaError_t, else cudaGetLastError().
int launch(const void* kernel, Params& p, void* stream) {
  int grid = 0;
  if (const int rc = grid_size(kernel, p.mb_h * p.mb_w, &grid)) return rc;
  void* args[] = {&p};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      kernel, dim3(grid), dim3(kThreads), args, 0,
      static_cast<cudaStream_t>(stream));
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(e != cudaSuccess ? e : last);
}

}  // namespace

// The grid jt_mc_combine launches for n_mb macroblocks of one stream on the
// current device, or minus a cudaError_t.
extern "C" int jt_mc_combine_grid(int n_mb) {
  int grid = 0;
  const int rc = grid_size(
      reinterpret_cast<const void*>(frame_loop_kernel<false, false>), n_mb,
      &grid);
  return rc ? -rc : grid;
}

// cur_* / fwd_*: the carried uint8 planes (Y [16*mb_h, 16*mb_w], Cr and Cb
// [8*mb_h, 8*mb_w]); resid int32 [F, n_mb, 6, 64]; meta int32 [F, n_mb, 3]
// of (mv_h, mv_v, coded bits 0-5 | intra << 6 | written << 7); out_*: the
// F new pictures per plane; seg_frames int32 [n_seg] on the device, each in
// [0, F], or null for F each (n_seg must divide mb_h).  Planes 4-byte and
// resid 16-byte aligned.  Returns the launch's cudaError_t, else
// cudaGetLastError().
extern "C" int jt_mc_combine(const void* cur_y, const void* cur_cr,
                             const void* cur_cb, const void* fwd_y,
                             const void* fwd_cr, const void* fwd_cb,
                             const void* resid, const void* meta, void* out_y,
                             void* out_cr, void* out_cb, void* arrived,
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
  p.arrived = static_cast<unsigned int*>(arrived);
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
  return launch(
      reinterpret_cast<const void*>(frame_loop_kernel<true, true>), p,
      stream);
}

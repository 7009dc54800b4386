// K2: one picture's half-pel motion compensation + residual combine.
//
// Replaces: no Pallas kernel.  It does the work that jsmpeg_tpu's XLA
// frame step lowers as three `_mc_gather` calls (with `chroma_mv`) and
// `_combine` in `decode_frame_planes` (jsmpeg_tpu/ops/frame.py,
// jsmpeg_tpu/ops/motion.py).  Plain PyTorch version:
// jsmpeg_tpu_torch/ops/frame.py:mc_combine_ref.
//
// Semantics per pixel (reference jsmpeg/src/mpeg1.js:459-687): a written
// macroblock predicts from the forward plane at (y + (mv_v >> 1),
// x + (mv_h >> 1)) with the four taps offset by the half-pel parities,
// each tap clamped to the coded plane, pred = (a + b + c + d + 2) >> 2;
// an unwritten one keeps the stale `cur` pixel.  A coded block then
// replaces (intra) or adds to (non-intra) that base with its residual,
// clamped to [0, 255].  Chroma vectors are sign(mv) * (|mv| >> 1).
// Luma block 2*(py >= 8) + (px >= 8) holds pixel (py, px) at raster
// (py & 7) * 8 + (px & 7); Cb reads block 4, Cr block 5.
//
// Bound on the H100: the launch.  A 720p picture needs ~1.4 MB of uint8
// reference pixels (forward where a macroblock is written, else stale),
// the int32 residuals of its coded blocks only (up to 5.5 MB), 43 kB of
// metadata and 1.4 MB of output, against about 27 integer operations per
// predicted pixel: both come to a few microseconds, less than a launch.
// chip_smoke.py reports the measured time beside the bound computed from
// the bytes and operations each picture actually needs.
//
// Design: one CTA of 256 threads per macroblock.  Thread t computes luma
// pixel (t >> 4, t & 15); threads 0-127 also compute one chroma pixel
// (threads 0-63 Cr, 64-127 Cb).  Consecutive threads touch consecutive
// bytes of a plane row, residuals are read only for coded blocks and the
// reference planes only where the macroblock needs them.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

__device__ __forceinline__ int32_t chroma_mv(int32_t mv) {
  return mv >= 0 ? (mv >> 1) : -((-mv) >> 1);
}

// One output pixel at (y, x) of an H x W plane.
__device__ __forceinline__ uint8_t combine_pixel(
    const uint8_t* __restrict__ fwd, const uint8_t* __restrict__ cur, int H,
    int W, int y, int x, int32_t mv_h, int32_t mv_v, bool written,
    const int32_t* resid, bool intra) {
  int32_t base;
  if (written) {
    const int sy = y + (mv_v >> 1), sx = x + (mv_h >> 1);
    const int y0 = clampi(sy, 0, H - 1), y1 = clampi(sy + (mv_v & 1), 0, H - 1);
    const int x0 = clampi(sx, 0, W - 1), x1 = clampi(sx + (mv_h & 1), 0, W - 1);
    base = (fwd[y0 * W + x0] + fwd[y0 * W + x1] + fwd[y1 * W + x0] +
            fwd[y1 * W + x1] + 2) >> 2;
  } else {
    base = cur[y * W + x];
  }
  if (resid == nullptr) return static_cast<uint8_t>(base);
  const int32_t v =
      intra ? *resid
            : static_cast<int32_t>(static_cast<uint32_t>(base) +
                                   static_cast<uint32_t>(*resid));
  return static_cast<uint8_t>(clampi(v, 0, 255));
}

__global__ void __launch_bounds__(256) mc_combine_kernel(
    const uint8_t* __restrict__ cur_y, const uint8_t* __restrict__ cur_cr,
    const uint8_t* __restrict__ cur_cb, const uint8_t* __restrict__ fwd_y,
    const uint8_t* __restrict__ fwd_cr, const uint8_t* __restrict__ fwd_cb,
    const int32_t* __restrict__ resid, const int32_t* __restrict__ meta,
    uint8_t* __restrict__ out_y, uint8_t* __restrict__ out_cr,
    uint8_t* __restrict__ out_cb, int mb_h, int mb_w) {
  const int mb = blockIdx.x;
  const int t = threadIdx.x;
  const int mb_row = mb / mb_w, mb_col = mb - mb_row * mb_w;
  const int32_t mv_h = meta[mb * 3], mv_v = meta[mb * 3 + 1];
  const int32_t mode = meta[mb * 3 + 2];
  const bool intra = (mode >> 6) & 1, written = (mode >> 7) & 1;
  const int32_t* r = resid + static_cast<int64_t>(mb) * 384;

  {
    const int W = mb_w * 16, H = mb_h * 16;
    const int py = t >> 4, px = t & 15;
    const int blk = ((py >> 3) << 1) | (px >> 3);
    const int32_t* res =
        (mode >> blk) & 1 ? r + blk * 64 + (py & 7) * 8 + (px & 7) : nullptr;
    const int y = mb_row * 16 + py, x = mb_col * 16 + px;
    out_y[y * W + x] = combine_pixel(fwd_y, cur_y, H, W, y, x, mv_h, mv_v,
                                     written, res, intra);
  }
  if (t < 128) {
    const bool is_cb = t >= 64;
    const int blk = is_cb ? 4 : 5;
    const int p = t & 63;
    const int W = mb_w * 8, H = mb_h * 8;
    const int y = mb_row * 8 + (p >> 3), x = mb_col * 8 + (p & 7);
    const int32_t* res = (mode >> blk) & 1 ? r + blk * 64 + p : nullptr;
    uint8_t* out = is_cb ? out_cb : out_cr;
    out[y * W + x] = combine_pixel(is_cb ? fwd_cb : fwd_cr,
                                   is_cb ? cur_cb : cur_cr, H, W, y, x,
                                   chroma_mv(mv_h), chroma_mv(mv_v), written,
                                   res, intra);
  }
}

}  // namespace

// cur_* / fwd_*: uint8 planes (Y [16*mb_h, 16*mb_w], Cr and Cb
// [8*mb_h, 8*mb_w]); resid int32 [n_mb, 6, 64]; meta int32 [n_mb, 3] of
// (mv_h, mv_v, coded bits 0-5 | intra << 6 | written << 7); out_*: the
// new planes.  Returns cudaGetLastError().
extern "C" int jt_mc_combine(const void* cur_y, const void* cur_cr,
                             const void* cur_cb, const void* fwd_y,
                             const void* fwd_cr, const void* fwd_cb,
                             const void* resid, const void* meta, void* out_y,
                             void* out_cr, void* out_cb, int mb_h, int mb_w,
                             void* stream) {
  const int n_mb = mb_h * mb_w;
  if (n_mb <= 0) return 0;
  mc_combine_kernel<<<n_mb, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(cur_y), static_cast<const uint8_t*>(cur_cr),
      static_cast<const uint8_t*>(cur_cb), static_cast<const uint8_t*>(fwd_y),
      static_cast<const uint8_t*>(fwd_cr), static_cast<const uint8_t*>(fwd_cb),
      static_cast<const int32_t*>(resid), static_cast<const int32_t*>(meta),
      static_cast<uint8_t*>(out_y), static_cast<uint8_t*>(out_cr),
      static_cast<uint8_t*>(out_cb), mb_h, mb_w);
  return static_cast<int>(cudaGetLastError());
}

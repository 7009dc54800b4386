// K1: fused dequantize + 8x8 integer IDCT over a batch of blocks.
//
// Replaces: the Pallas kernel `dequant_idct_pallas` / `_kernel`
// (tools/idct_pallas_shelved.py), whose contract is
// idct_s32(dequant_premult(...)) of jsmpeg_tpu/ops/idct.py.  A second
// mode runs the IDCT alone on premultiplied int32 coefficients (the
// serial path's FrameArrays.coef).  Plain PyTorch version:
// jsmpeg_tpu_torch/ops/idct.py:dequant_idct_ref.
//
// Semantics (reference jsmpeg/src/mpeg1.js:793-810,916-983): per
// coefficient (2*lv [+ sign(lv) if non-intra]) * qscale * Q >> 4, oddify
// toward zero, clamp to [-2048, 2047], times the premultiplier, zero where
// lv == 0, intra DC = lv << 8; then two butterfly passes (473/196/362,
// `>> 8` after +128) and a final (v + 128) >> 8, all in wrapping int32.
// Signed overflow is undefined in C++, so every + - * runs on uint32_t and
// the value is cast back to int32_t right before each arithmetic `>>`.
//
// Bound on the H100: memory.  Per block it reads 128 B of int16 levels
// (256 B of int32 coefficients in premultiplied mode) and writes 256 B of
// int32 residuals, ~266 MB per 32-frame 720p batch, against about 880
// int32 operations per block (816 for the two butterfly passes, 64 zero
// tests) plus 11 per non-zero level; at the data sheet's 3.35 TB/s and the
// int32 issue rate (a quarter of the 67 TFLOP/s fp32 rate) the bytes take
// longer.  Tensor cores cannot help: the math needs wrapping int32 and
// shifts.  chip_smoke.py reports the measured time beside this bound.
//
// Design: one CTA of 256 threads takes 32 blocks.  The CTA loads its
// blocks into shared memory with coalesced reads, then 8 threads work on
// each block: thread j dequantizes column j into registers and runs pass 1
// over it, the block transposes through shared memory (rows padded to 9
// words, so neither pass has bank conflicts), thread j runs pass 2 over
// row j, and the CTA stores the residuals with coalesced writes.  Quant
// matrices sit in shared memory, the premultiplier in constant memory.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kBlocksPerCta = 32;
constexpr int kThreads = kBlocksPerCta * 8;

// PREMULTIPLIER_MATRIX of jsmpeg_tpu_torch/tables.py (raster order); a
// CPU test holds this copy to the Python table.
__constant__ int32_t kPremult[64] = {
    32, 44, 42, 38, 32, 25, 17, 9,
    44, 62, 58, 52, 44, 35, 24, 12,
    42, 58, 55, 49, 42, 33, 23, 12,
    38, 52, 49, 44, 38, 30, 20, 10,
    32, 44, 42, 38, 32, 25, 17, 9,
    25, 35, 33, 30, 25, 20, 14, 7,
    17, 24, 23, 20, 17, 14, 9, 5,
    9, 12, 12, 10, 9, 7, 5, 2,
};

__device__ __forceinline__ uint32_t shr8(uint32_t v) {
  return static_cast<uint32_t>(static_cast<int32_t>(v) >> 8);
}

// One butterfly pass over r[0..7]; `final` adds the (v + 128) >> 8
// output rounding of the second pass.
__device__ __forceinline__ void butterfly(const uint32_t r[8], uint32_t o[8],
                                          bool final) {
  const uint32_t b1 = r[4];
  const uint32_t b3 = r[2] + r[6];
  const uint32_t b4 = r[5] - r[3];
  const uint32_t tmp1 = r[1] + r[7];
  const uint32_t tmp2 = r[3] + r[5];
  const uint32_t b6 = r[1] - r[7];
  const uint32_t b7 = tmp1 + tmp2;
  const uint32_t m0 = r[0];
  const uint32_t x4 = shr8(b6 * 473u - b4 * 196u + 128u) - b7;
  const uint32_t x0 = x4 - shr8((tmp1 - tmp2) * 362u + 128u);
  const uint32_t x1 = m0 - b1;
  const uint32_t x2 = shr8((r[2] - r[6]) * 362u + 128u) - b3;
  const uint32_t x3 = m0 + b1;
  const uint32_t y3 = x1 + x2;
  const uint32_t y4 = x3 + b3;
  const uint32_t y5 = x1 - x2;
  const uint32_t y6 = x3 - b3;
  const uint32_t y7 = (0u - x0) - shr8(b4 * 473u + b6 * 196u + 128u);
  o[0] = b7 + y4;
  o[1] = x4 + y3;
  o[2] = y5 - x0;
  o[3] = y6 - y7;
  o[4] = y6 + y7;
  o[5] = x0 + y5;
  o[6] = y3 - x4;
  o[7] = y4 - b7;
  if (final) {
#pragma unroll
    for (int i = 0; i < 8; ++i) o[i] = shr8(o[i] + 128u);
  }
}

// Dequantize + oddify + clamp + premultiply one level at raster `pos`.
__device__ __forceinline__ uint32_t dequant(int32_t lv, int pos, bool intra,
                                            uint32_t qs,
                                            const int32_t* quant) {
  if (intra && pos == 0) return static_cast<uint32_t>(lv) << 8;
  if (lv == 0) return 0u;
  uint32_t t = static_cast<uint32_t>(lv) * 2u;
  if (!intra) t += lv > 0 ? 1u : 0xFFFFFFFFu;
  int32_t v = static_cast<int32_t>(
                  t * qs * static_cast<uint32_t>(quant[pos])) >> 4;
  if ((v & 1) == 0) v = v > 0 ? v - 1 : v + 1;
  v = min(max(v, -2048), 2047);
  return static_cast<uint32_t>(v) * static_cast<uint32_t>(kPremult[pos]);
}

__global__ void __launch_bounds__(kThreads) dequant_idct_kernel(
    const int16_t* __restrict__ levels, const int32_t* __restrict__ coef,
    const uint8_t* __restrict__ qscale, const bool* __restrict__ intra,
    const int32_t* __restrict__ intra_q,
    const int32_t* __restrict__ non_intra_q, int32_t* __restrict__ out,
    int n_blocks) {
  __shared__ int32_t tile[kBlocksPerCta][8][9];
  __shared__ int32_t quant[2][64];
  const int tid = threadIdx.x;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kBlocksPerCta;
  const bool premultiplied = coef != nullptr;

  if (!premultiplied && tid < 128)
    quant[tid >> 6][tid & 63] = (tid < 64 ? intra_q : non_intra_q)[tid & 63];
  for (int e = tid; e < kBlocksPerCta * 64; e += kThreads) {
    const int lb = e >> 6, pos = e & 63;
    const int64_t b = first + lb;
    int32_t v = 0;
    if (b < n_blocks)
      v = premultiplied ? coef[b * 64 + pos] : levels[b * 64 + pos];
    tile[lb][pos >> 3][pos & 7] = v;
  }
  __syncthreads();

  const int lb = tid >> 3, j = tid & 7;
  const int64_t b = first + lb;
  uint32_t r[8], o[8];
  if (premultiplied) {
#pragma unroll
    for (int i = 0; i < 8; ++i) r[i] = static_cast<uint32_t>(tile[lb][i][j]);
  } else {
    bool is_intra = false;
    uint32_t qs = 0;
    if (b < n_blocks) {
      is_intra = intra[b / 6];
      qs = qscale[b / 6];
    }
    const int32_t* q = quant[is_intra ? 0 : 1];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      r[i] = dequant(tile[lb][i][j], i * 8 + j, is_intra, qs, q);
  }
  // pass 1 along the row index: thread j owns column j
  butterfly(r, o, false);
#pragma unroll
  for (int i = 0; i < 8; ++i) tile[lb][i][j] = static_cast<int32_t>(o[i]);
  __syncthreads();
  // pass 2 along the column index: thread j owns row j
#pragma unroll
  for (int k = 0; k < 8; ++k) r[k] = static_cast<uint32_t>(tile[lb][j][k]);
  butterfly(r, o, true);
#pragma unroll
  for (int k = 0; k < 8; ++k) tile[lb][j][k] = static_cast<int32_t>(o[k]);
  __syncthreads();

  for (int e = tid; e < kBlocksPerCta * 64; e += kThreads) {
    const int lb2 = e >> 6, pos = e & 63;
    const int64_t b2 = first + lb2;
    if (b2 < n_blocks) out[b2 * 64 + pos] = tile[lb2][pos >> 3][pos & 7];
  }
}

}  // namespace

// levels_or_coef: int16 levels (premultiplied == 0) or int32 premultiplied
// coefficients (premultiplied != 0), [n_blocks, 64]; qscale uint8 and
// intra bool per macroblock (n_blocks / 6); intra_q / non_intra_q int32
// [64]; out int32 [n_blocks, 64].  Returns cudaGetLastError().
extern "C" int jt_dequant_idct(const void* levels_or_coef, const void* qscale,
                               const void* intra, const void* intra_q,
                               const void* non_intra_q, void* out,
                               int n_blocks, int premultiplied,
                               void* stream) {
  if (n_blocks <= 0) return 0;
  const int grid = (n_blocks + kBlocksPerCta - 1) / kBlocksPerCta;
  dequant_idct_kernel<<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      premultiplied ? nullptr : static_cast<const int16_t*>(levels_or_coef),
      premultiplied ? static_cast<const int32_t*>(levels_or_coef) : nullptr,
      static_cast<const uint8_t*>(qscale), static_cast<const bool*>(intra),
      static_cast<const int32_t*>(intra_q),
      static_cast<const int32_t*>(non_intra_q), static_cast<int32_t*>(out),
      n_blocks);
  return static_cast<int>(cudaGetLastError());
}

// K1: fused dequantize + 8x8 integer IDCT over a batch of blocks.
//
// Replaces: the Pallas kernel `dequant_idct_pallas` / `_kernel`
// (tools/idct_pallas_shelved.py), whose contract is
// idct_s32(dequant_premult(...)) of jsmpeg_tpu/ops/idct.py.  Three forms:
// - compact (dequant_idct_compact_kernel, the packed paths): the levels of
//   the coded blocks only, row i of a [n, 64] lattice K3 writes, each
//   row's block named by blk_ids[i] (-1: none); the residual of row i goes
//   to block blk_ids[i] of the dense int32 [n_blocks, 64] output that K2
//   reads, and no other block of it is written (K2 reads coded blocks
//   only).  Plain PyTorch version: ops/idct.py:dequant_idct_compact_ref.
// - levels (dequant_idct_kernel): the dense int16 lattice, every block;
//   the dense-levels and sparse wires, decode_tiled_levels.
// - premultiplied (the same kernel): the IDCT alone on premultiplied int32
//   coefficients (the serial path's FrameArrays.coef).
// Plain PyTorch version of the last two: ops/idct.py:dequant_idct_ref.
//
// Semantics (reference jsmpeg/src/mpeg1.js:793-810,916-983): per
// coefficient (2*lv [+ sign(lv) if non-intra]) * qscale * Q >> 4, oddify
// toward zero, clamp to [-2048, 2047], times the premultiplier, zero where
// lv == 0, intra DC = lv << 8; then two butterfly passes (473/196/362,
// `>> 8` after +128) and a final (v + 128) >> 8, all in wrapping int32.
// Signed overflow is undefined in C++, so every + - * runs on uint32_t and
// the value is cast back to int32_t right before each arithmetic `>>`.
//
// Bound on the H100: memory.  Against about 880 int32 operations per block
// (816 for the two butterfly passes, 64 zero tests) plus 11 per non-zero
// level, a block moves 384 bytes: at the data sheet's 3.35 TB/s and the
// int32 issue rate (a quarter of the 67 TFLOP/s fp32 rate) the bytes take
// longer.  Tensor cores cannot help: the math needs wrapping int32 and
// shifts.  The dense forms move every block of the batch: 128 B of int16
// levels (256 B of int32 coefficients premultiplied) in, 256 B of int32
// residuals out, 266 MB per 32-frame 720p batch (0.0793 ms).  The compact
// form moves the coded blocks only, 128 B of levels and 4 B of id in,
// 256 B out each, plus two bytes of its macroblock's fields: 15-18 % of
// the blocks of a 720p batch, 40 MB (0.0119 ms) at the main stream's last
// batch of 103,123 coded blocks.  chip_smoke.py reports the measured times
// beside both bounds.
//
// Design of the dense forms: one CTA of 256 threads takes 32 blocks.  The
// CTA loads its blocks into shared memory with coalesced reads, then 8
// threads work on each block: thread j dequantizes column j into registers
// and runs pass 1 over it, the block transposes through shared memory
// (rows padded to 9 words, so neither pass has bank conflicts), thread j
// runs pass 2 over row j, and the CTA stores the residuals with coalesced
// writes.  Quant matrices sit in shared memory, the premultiplier in
// constant memory.
// Design of the compact form: the grid covers the n rows, not the batch's
// blocks.  One CTA of 256 threads takes 32 rows, 8 threads (lanes of one
// warp) a row: thread r loads the block's level row r as one 16-byte load
// (a warp reads 512 contiguous bytes), the row's id (one address for its 8
// lanes) and its macroblock's qscale and intra, dequantizes its 8 levels
// against its row of the matrix and premultiplier (16-byte shared loads of
// the tables the CTA stages once), and writes them into the block's tile
// (9-word rows); after a warp barrier thread r runs pass 1 over column r,
// after another pass 2 over row r, and stores its 8 residuals as two
// 16-byte stores at block id's row r: a block's 256 bytes, two whole
// 128-byte lines, come from its 8 lanes.  Only the warp barriers order the
// tile, so a warp never waits on another; the id's offset id * 64 is
// computed in 64 bits.
//
// Checked build (-DJT_CHECKED, csrc/checked.cuh): every global and shared
// access below goes through its bounds accessor and the shared ones
// through the hazard shadow (4-byte granules); the library's checker
// entry points (jt_checked_*) are at the end of this file.

#include <cstdint>

#include <cuda_runtime.h>

#define JT_FILE 1
#include "checked.cuh"

namespace {

constexpr int kBlocksPerCta = 32;
constexpr int kThreads = kBlocksPerCta * 8;
constexpr int kTileWords = kBlocksPerCta * 8 * 9;   // shared tile, flat

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

// Dequantize + oddify + clamp + premultiply one non-zero level (not an
// intra DC) against its matrix entry q and premultiplier pm.
__device__ __forceinline__ uint32_t dequant_value(int32_t lv, bool intra,
                                                  uint32_t qs, int32_t q,
                                                  int32_t pm) {
  uint32_t t = static_cast<uint32_t>(lv) * 2u;
  if (!intra) t += lv > 0 ? 1u : 0xFFFFFFFFu;
  int32_t v = static_cast<int32_t>(t * qs * static_cast<uint32_t>(q)) >> 4;
  if ((v & 1) == 0) v = v > 0 ? v - 1 : v + 1;
  v = min(max(v, -2048), 2047);
  return static_cast<uint32_t>(v) * static_cast<uint32_t>(pm);
}

// Dequantize + oddify + clamp + premultiply one level at raster `pos`.
__device__ __forceinline__ uint32_t dequant(int32_t lv, int pos, bool intra,
                                            uint32_t qs,
                                            const int32_t* quant) {
  if (intra && pos == 0) return static_cast<uint32_t>(lv) << 8;
  if (lv == 0) return 0u;
  return dequant_value(lv, intra, qs, JT_SH_LD(quant, pos, 64),
                       kPremult[pos]);
}

__global__ void __launch_bounds__(kThreads) dequant_idct_kernel(
    const int16_t* __restrict__ levels, const int32_t* __restrict__ coef,
    const uint8_t* __restrict__ qscale, const bool* __restrict__ intra,
    const int32_t* __restrict__ intra_q,
    const int32_t* __restrict__ non_intra_q, int32_t* __restrict__ out,
    int n_blocks) {
  __shared__ int32_t tile[kBlocksPerCta][8][9];
  __shared__ int32_t quant[2][64];
  JT_BEGIN(0);
  int32_t* const flat = &tile[0][0][0];
  const int tid = threadIdx.x;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kBlocksPerCta;
  const bool premultiplied = coef != nullptr;
  const int64_t n_levels = static_cast<int64_t>(n_blocks) * 64;

  if (!premultiplied && tid < 128)
    JT_SH_ST(&quant[0][0], tid, 128,
             JT_OK(tid & 63, 64)
                 ? (tid < 64 ? intra_q : non_intra_q)[tid & 63]
                 : 0);
  for (int e = tid; e < kBlocksPerCta * 64; e += kThreads) {
    const int lb = e >> 6, pos = e & 63;
    const int64_t b = first + lb;
    int32_t v = 0;
    if (b < n_blocks) {
      int64_t i = b * 64 + pos;
      // negative control 1: the last block's last level reads one past
      if (JT_INJECT_AT(1, i == n_levels - 1)) ++i;
      if (JT_OK(i, n_levels)) v = premultiplied ? coef[i] : levels[i];
    }
    JT_SH_ST(flat, (lb * 8 + (pos >> 3)) * 9 + (pos & 7), kTileWords, v);
  }
  JT_SYNCTHREADS();

  const int lb = tid >> 3, j = tid & 7;
  const int64_t b = first + lb;
  uint32_t r[8], o[8];
  if (premultiplied) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      r[i] = static_cast<uint32_t>(
          JT_SH_LD(flat, (lb * 8 + i) * 9 + j, kTileWords));
  } else {
    bool is_intra = false;
    uint32_t qs = 0;
    if (b < n_blocks && JT_OK(b / 6, n_blocks / 6)) {
      is_intra = intra[b / 6];
      qs = qscale[b / 6];
    }
    const int32_t* q = quant[is_intra ? 0 : 1];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      r[i] = dequant(JT_SH_LD(flat, (lb * 8 + i) * 9 + j, kTileWords),
                     i * 8 + j, is_intra, qs, q);
  }
  // pass 1 along the row index: thread j owns column j
  butterfly(r, o, false);
#pragma unroll
  for (int i = 0; i < 8; ++i)
    JT_SH_ST(flat, (lb * 8 + i) * 9 + j, kTileWords,
             static_cast<int32_t>(o[i]));
  JT_SYNCTHREADS();
  // pass 2 along the column index: thread j owns row j
#pragma unroll
  for (int k = 0; k < 8; ++k)
    r[k] = static_cast<uint32_t>(
        JT_SH_LD(flat, (lb * 8 + j) * 9 + k, kTileWords));
  butterfly(r, o, true);
#pragma unroll
  for (int k = 0; k < 8; ++k)
    JT_SH_ST(flat, (lb * 8 + j) * 9 + k, kTileWords,
             static_cast<int32_t>(o[k]));
  JT_SYNCTHREADS();

  for (int e = tid; e < kBlocksPerCta * 64; e += kThreads) {
    const int lb2 = e >> 6, pos = e & 63;
    const int64_t b2 = first + lb2;
    if (b2 < n_blocks && JT_OK(b2 * 64 + pos, n_levels))
      out[b2 * 64 + pos] =
          JT_SH_LD(flat, (lb2 * 8 + (pos >> 3)) * 9 + (pos & 7), kTileWords);
  }
}


// ---- the compact form

constexpr int kCompactThreads = 256;                 // 8 a row: one level row each
constexpr int kCompactRows = kCompactThreads / 8;    // rows a CTA
constexpr int kRowWords = 8 * 9;                     // a row's tile, 9-word rows

// The 8 int32 of two 16-byte words.
__device__ __forceinline__ void words8(uint4 a, uint4 b, int32_t v[8]) {
  v[0] = static_cast<int32_t>(a.x);
  v[1] = static_cast<int32_t>(a.y);
  v[2] = static_cast<int32_t>(a.z);
  v[3] = static_cast<int32_t>(a.w);
  v[4] = static_cast<int32_t>(b.x);
  v[5] = static_cast<int32_t>(b.y);
  v[6] = static_cast<int32_t>(b.z);
  v[7] = static_cast<int32_t>(b.w);
}

__global__ void __launch_bounds__(kCompactThreads) dequant_idct_compact_kernel(
    const int16_t* __restrict__ levels, const int32_t* __restrict__ blk_ids,
    const uint8_t* __restrict__ qscale, const bool* __restrict__ intra,
    const int32_t* __restrict__ intra_q,
    const int32_t* __restrict__ non_intra_q, int32_t* __restrict__ out,
    int n_rows, long long n_blocks) {
  // the intra matrix, the non-intra matrix, the premultiplier
  __shared__ __align__(16) int32_t tables[3 * 64];
  __shared__ int32_t tile[kCompactRows * kRowWords];
  JT_BEGIN(0);
  const int tid = threadIdx.x;
  const int lr = tid >> 3, r = tid & 7;      // the CTA's row, its level row
  const long long row = static_cast<long long>(blockIdx.x) * kCompactRows + lr;
  const long long n_levels = static_cast<long long>(n_rows) * 64;
  // the loads first: none waits for the tables
  int32_t id = -1;
  uint4 lv = make_uint4(0u, 0u, 0u, 0u);
  if (row < n_rows) {
    if (JT_OK(row, n_rows)) id = blk_ids[row];
    if (JT_OK_N(row * 64 + r * 8, 8, n_levels))
      lv = reinterpret_cast<const uint4*>(levels)[row * 8 + r];
  }
  bool is_intra = false;
  uint32_t qs = 0;
  if (id >= 0 && JT_OK(id / 6, n_blocks / 6)) {
    is_intra = intra[id / 6];
    qs = qscale[id / 6];
  }
  if (tid < 3 * 64)
    JT_SH_ST(tables, tid, 3 * 64,
             tid >= 128 ? kPremult[tid - 128]
             : JT_OK(tid & 63, 64) ? (tid < 64 ? intra_q : non_intra_q)[tid & 63]
                                   : 0);
  JT_SYNCTHREADS();
  // row r of the block's matrix and premultiplier, 16 bytes at a time
  const uint4* t4 = reinterpret_cast<const uint4*>(tables);
  int32_t q[8], pm[8];
  words8(JT_SH_LD(t4, (is_intra ? 0 : 16) + 2 * r, 48),
         JT_SH_LD(t4, (is_intra ? 0 : 16) + 2 * r + 1, 48), q);
  words8(JT_SH_LD(t4, 32 + 2 * r, 48), JT_SH_LD(t4, 32 + 2 * r + 1, 48), pm);
  const uint32_t w[4] = {lv.x, lv.y, lv.z, lv.w};
  int32_t* blk = tile + lr * kRowWords;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int32_t l = static_cast<int16_t>(w[c >> 1] >> (16 * (c & 1)));
    const uint32_t v = is_intra && r == 0 && c == 0
                           ? static_cast<uint32_t>(l) << 8
                           : l == 0 ? 0u
                                    : dequant_value(l, is_intra, qs, q[c],
                                                    pm[c]);
    JT_SH_ST(blk, r * 9 + c, kRowWords, static_cast<int32_t>(v));
  }
  JT_SYNCWARP();
  // pass 1 along the row index: thread r owns column r
  uint32_t a[8], o[8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
    a[i] = static_cast<uint32_t>(JT_SH_LD(blk, i * 9 + r, kRowWords));
  butterfly(a, o, false);
#pragma unroll
  for (int i = 0; i < 8; ++i)
    JT_SH_ST(blk, i * 9 + r, kRowWords, static_cast<int32_t>(o[i]));
  JT_SYNCWARP();
  // pass 2 along the column index: thread r owns row r
#pragma unroll
  for (int k = 0; k < 8; ++k)
    a[k] = static_cast<uint32_t>(JT_SH_LD(blk, r * 9 + k, kRowWords));
  butterfly(a, o, true);
  // row r of block id's residuals: 32 bytes; negative control 7: the
  // first row of block 0 left unstored
  const long long at = static_cast<long long>(id) * 64 + r * 8;
  if (id >= 0 && !JT_INJECT_AT(7, blockIdx.x == 0 && lr == 0) &&
      JT_OK_N(at, 8, n_blocks * 64)) {
    uint4* dst = reinterpret_cast<uint4*>(out + at);
    dst[0] = make_uint4(o[0], o[1], o[2], o[3]);
    dst[1] = make_uint4(o[4], o[5], o[6], o[7]);
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
#ifdef JT_CHECKED
  {
    const size_t shared = jt_shared_bytes(
        reinterpret_cast<const void*>(dequant_idct_kernel));
    const int shift = 2;
    const long long ctas = grid;
    if (const int rc = jt_configure(1, &shared, &shift, &ctas, 0, 0,
                                    static_cast<cudaStream_t>(stream)))
      return rc;
  }
#endif
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


// The compact form: levels int16 [n_rows, 64] (16-byte aligned), blk_ids
// int32 [n_rows] (each row's block in out, -1: none), qscale uint8 and
// intra bool per macroblock (n_blocks / 6), intra_q / non_intra_q int32
// [64]; out int32 [n_blocks, 64] (16-byte aligned), written at the named
// blocks only.  Returns cudaGetLastError().
extern "C" int jt_dequant_idct_compact(const void* levels, const void* blk_ids,
                                       const void* qscale, const void* intra,
                                       const void* intra_q,
                                       const void* non_intra_q, void* out,
                                       int n_rows, long long n_blocks,
                                       void* stream) {
  if (n_rows <= 0) return 0;
  const int grid = (n_rows + kCompactRows - 1) / kCompactRows;
#ifdef JT_CHECKED
  {
    const size_t shared = jt_shared_bytes(
        reinterpret_cast<const void*>(dequant_idct_compact_kernel));
    const int shift = 2;
    const long long ctas = grid;
    if (const int rc = jt_configure(1, &shared, &shift, &ctas, 0, 0,
                                    static_cast<cudaStream_t>(stream)))
      return rc;
  }
#endif
  dequant_idct_compact_kernel<<<grid, kCompactThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(levels),
      static_cast<const int32_t*>(blk_ids),
      static_cast<const uint8_t*>(qscale), static_cast<const bool*>(intra),
      static_cast<const int32_t*>(intra_q),
      static_cast<const int32_t*>(non_intra_q), static_cast<int32_t*>(out),
      n_rows, n_blocks);
  return static_cast<int>(cudaGetLastError());
}

#ifdef JT_CHECKED
// The checked library's checker entry points (one set for the library;
// each source exports its own record as jt_checked_fault_<name>).
JT_CHECKED_EXPORTS(dequant_idct)
extern "C" int jt_checked_fault_mc_combine(void* out);
extern "C" int jt_checked_reset_mc_combine();
extern "C" int jt_checked_fault_wire_unpack(void* out);
extern "C" int jt_checked_reset_wire_unpack();

// int32 words of one source's fault record (jt::Fault).
extern "C" int jt_checked_fault_words() { return jt::kFaultWords; }

// The three sources' records, K1's, K2's, K3's, one after another (3 x
// jt_checked_fault_words() int32 words at out).  Returns a cudaError_t.
extern "C" int jt_checked_fault(void* out) {
  int32_t* o = static_cast<int32_t*>(out);
  int rc = jt_checked_fault_dequant_idct(o);
  if (!rc) rc = jt_checked_fault_mc_combine(o + jt::kFaultWords);
  if (!rc) rc = jt_checked_fault_wire_unpack(o + 2 * jt::kFaultWords);
  return rc;
}

extern "C" int jt_checked_reset() {
  int rc = jt_checked_reset_dequant_idct();
  if (!rc) rc = jt_checked_reset_mc_combine();
  if (!rc) rc = jt_checked_reset_wire_unpack();
  return rc;
}

// The checker's buffer: the shadow of shared memory and K2's waited rows,
// `bytes` bytes of device memory that the caller keeps alive.
extern "C" void jt_checked_shadow(void* buf, long long bytes) {
  jt::host.shadow = buf;
  jt::host.shadow_bytes = bytes;
}

// The perturbation seed of the launches that follow (0: no delays).
extern "C" void jt_checked_seed(unsigned long long seed) {
  jt::host.seed = seed;
}

// Plant negative control `id` (ops/kernels.py INJECTIONS) in the launches
// that follow (0: none).
extern "C" void jt_checked_inject(int id) { jt::host.inject = id; }
#endif

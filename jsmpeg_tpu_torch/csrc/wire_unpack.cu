// K3: the packed wire v2 unpack -- the wire bytes of one batch (or of S
// streams at shared sizes) into the dense int16 levels lattice and the
// per-macroblock fields that K1, K2 and frame_meta read.
//
// Replaces: no Pallas kernel.  jsmpeg_tpu runs `unpack_fused` and
// `packed_to_levels` (jsmpeg_tpu/models/mpeg1.py:133,307) as jit-compiled
// jnp inside `decode_scan_fused` (:243), under `jax.vmap` for its vmap
// fleet (jsmpeg_tpu/parallel/streams.py:66-84).  Plain PyTorch version:
// jsmpeg_tpu_torch/models/mpeg1.py:unpack_fused + packed_to_levels (joined
// over streams by unpack_wires_ref); this kernel's decomposition step by
// step, in plain torch: models/mpeg1.py:wire_unpack_mirror.
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
//   (frame, macroblock, block) order.  A coded block of ordinal k < n_blk
//   holds, at position pos & 63, the value of the last pair of ordinal k
//   (wire order) that names it and has bit 6 clear; every other level is
//   0 (uncoded blocks, ordinals >= n_blk: the plain version's dump slot).
// S > 1 streams write stream s's macroblocks into columns [s*n_mb,
// (s+1)*n_mb) of the joint [F, S*n_mb] layout (the vmap fleet's join).
//
// Bound on the H100: bytes.  A 720p batch of 32 frames writes the 88.5 MB
// lattice plus 17 bytes per macroblock (1.96 MB) and reads a few MB of
// wire: ~0.03 ms at 3.35 TB/s; the integer work is a few operations per
// byte.  Design: every level is written exactly once (no memset), by full
// 128-byte lines, and the four prefix counts run as reduce-then-scan over
// five launches, so no block waits on another:
//   1. count:  per tile of kTile macroblocks the run starts, per tile of
//              kTile pairs the bit-7 pairs and the escapes; every ordinal's
//              first pair set to P (none yet);
//   2. scan:   one CTA per (count, stream) turns the tile counts into
//              exclusive tile bases;
//   3. fields: per macroblock the run slot (tile base + in-tile scan), its
//              record, the per-MB outputs, cbp and the coded blocks before
//              it within its tile, and the tile's coded total; per pair its
//              escape-resolved value and, for a bit-7 pair, its ordinal's
//              first pair; the stream's last pair with bit 6 clear (an
//              atomic max per tile);
//   4. scan:   the coded totals into tile bases;
//   5. write:  a warp per macroblock writes its six blocks; a coded block
//              of ordinal k reads the pairs [first(k), first(k + 1)) (the
//              clamps: [0, ...) for k = 0, [..., P) for k = n_blk - 1), cut
//              after the last pair with bit 6 clear, 32 at a time, and
//              applies them in wire order by shuffles.  The cut keeps the
//              padding pairs of a wire sized for a longer stream (the vmap
//              fleet's shared sizes: every pair the shorter stream lacks,
//              0x40 behind its last real one) from running through the
//              one warp of its last coded block (PERF.md, PR 10).
// The wire's escape stream and wide records sit at arbitrary byte offsets,
// so every multi-byte wire value is read byte by byte, little-endian.
// Element counts are int (the lattice F*n_mb*384 is under 2^31, checked by
// the launcher); byte offsets are 64-bit.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;                    // per thread: one bitmap byte
constexpr int kTile = kThreads * kItems;     // macroblocks or pairs per CTA
constexpr int kScanThreads = 1024;
constexpr int kWarpsPerCta = kThreads / 32;  // write: macroblocks per CTA
constexpr unsigned kFull = 0xffffffffu;

struct Wire {
  const uint8_t* buf;
  long long stride;            // bytes from one stream's wire to the next
  long long o_bm, o_rec, o_pos, o_v8, o_esc;
  int n_streams, n_frames, n_mb, n_runs, wide, n_pairs, n_esc, n_blk;
  int n_items;                 // macroblocks per stream, F * n_mb
  int mb_tiles, pair_tiles;    // per stream
};

// Scratch, carved from one buffer by the launcher (no entry needs zeroing:
// each is written before it is read).
struct Scratch {
  int* run_cnt;      // [S, mb_tiles]   run starts, then their tile bases
  int* cod_cnt;      // [S, mb_tiles]   coded blocks, then their tile bases
  int* b7_cnt;       // [S, pair_tiles] bit-7 pairs, then tile bases
  int* esc_cnt;      // [S, pair_tiles] escapes, then tile bases
  int* first;        // [S, n_blk]      first pair of each ordinal, or P
  int* live_end;     // [S]             last pair with bit 6 clear, or -1
  int* mb_cod;       // [S, n_items]    coded blocks before the MB in its tile
  int16_t* val;      // [S, P]          escape-resolved pair values
  uint8_t* mb_cbp;   // [S, n_items]
};

struct Out {
  int16_t* levels;   // [F, S*n_mb, 6, 64]
  uint8_t* qscale;   // [F, S*n_mb]
  bool* coded;       // [F, S*n_mb, 6]
  bool* intra;
  bool* written;
  int32_t* mv_h;
  int32_t* mv_v;
};

// Exclusive scan of one int per thread over the CTA (kT threads); *total
// gets the CTA's sum.  sm: kT / 32 ints of shared memory, free again on
// return.
template <int kT>
__device__ int block_exclusive_scan(int v, int* sm, int* total) {
  constexpr int kWarps = kT / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) sm[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = lane < kWarps ? sm[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, s, d);
      if (lane >= d) s += y;
    }
    if (lane < kWarps) sm[lane] = s;
  }
  __syncthreads();
  const int before = warp ? sm[warp - 1] : 0;
  *total = sm[kWarps - 1];
  __syncthreads();
  return before + x - v;
}

// The bitmap byte of macroblocks [i0, i0 + 8), bits past the last
// macroblock cleared.
__device__ __forceinline__ uint32_t bitmap_byte(const uint8_t* buf,
                                                const Wire& w, int i0) {
  if (i0 >= w.n_items) return 0;
  uint32_t b = buf[w.o_bm + (i0 >> 3)];
  const int left = w.n_items - i0;
  if (left < 8) b &= (1u << left) - 1u;
  return b;
}

__global__ void __launch_bounds__(kThreads)
count_kernel(Wire w, Scratch s) {
  __shared__ int sm[32];
  const int st = blockIdx.y;
  const uint8_t* buf = w.buf + st * w.stride;
  for (int j = static_cast<int>(blockIdx.x * kThreads + threadIdx.x);
       j < w.n_blk; j += static_cast<int>(gridDim.x) * kThreads)
    s.first[static_cast<long long>(st) * w.n_blk + j] = w.n_pairs;
  const int bx = blockIdx.x, tid = threadIdx.x;
  if (bx == 0 && tid == 0) s.live_end[st] = -1;
  int total;
  if (bx < w.mb_tiles) {
    const int t = bx;
    const uint32_t bits = bitmap_byte(buf, w, t * kTile + tid * kItems);
    block_exclusive_scan<kThreads>(__popc(bits), sm, &total);
    if (tid == 0) s.run_cnt[st * w.mb_tiles + t] = total;
    return;
  }
  const int t = bx - w.mb_tiles;
  const int p0 = t * kTile + tid * kItems;
  int n7 = 0, ne = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int p = p0 + k;
    if (p < w.n_pairs) {
      n7 += buf[w.o_pos + p] >> 7;
      ne += static_cast<int8_t>(buf[w.o_v8 + p]) == -128;
    }
  }
  block_exclusive_scan<kThreads>(n7, sm, &total);
  if (tid == 0) s.b7_cnt[st * w.pair_tiles + t] = total;
  block_exclusive_scan<kThreads>(ne, sm, &total);
  if (tid == 0) s.esc_cnt[st * w.pair_tiles + t] = total;
}

struct ScanSet {
  int* a[3];
  int n[3];
};

// CTA (x, y) turns array x of stream y, n[x] counts, into exclusive bases.
__global__ void __launch_bounds__(kScanThreads) scan_kernel(ScanSet set) {
  __shared__ int sm[32];
  const int n = set.n[blockIdx.x];
  int* a = set.a[blockIdx.x] + static_cast<long long>(blockIdx.y) * n;
  int carry = 0;
  for (int base = 0; base < n; base += kScanThreads) {
    const int i = base + threadIdx.x;
    const int v = i < n ? a[i] : 0;
    int total;
    const int before = block_exclusive_scan<kScanThreads>(v, sm, &total);
    if (i < n) a[i] = carry + before;
    carry += total;
  }
}

__global__ void __launch_bounds__(kThreads)
fields_kernel(Wire w, Scratch s, Out o) {
  __shared__ int sm[32];
  const int st = blockIdx.y;
  const uint8_t* buf = w.buf + st * w.stride;
  const int bx = blockIdx.x, tid = threadIdx.x;
  int total;
  if (bx < w.mb_tiles) {
    const int t = bx;
    const int i0 = t * kTile + tid * kItems;
    const uint32_t bits = bitmap_byte(buf, w, i0);
    int run = s.run_cnt[st * w.mb_tiles + t] +
              block_exclusive_scan<kThreads>(__popc(bits), sm, &total);
    const int rec_w = w.wide ? 8 : 4;
    uint32_t cbps[kItems];
    int n_coded = 0;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      cbps[k] = 0;
      const int i = i0 + k;
      if (i >= w.n_items) continue;
      run += (bits >> k) & 1u;
      const int slot = min(max(run - 1, 0), w.n_runs - 1);
      const uint8_t* r = buf + w.o_rec + static_cast<long long>(slot) * rec_w;
      uint32_t flags, cbp;
      int32_t mvh, mvv;
      if (w.wide) {
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
      const long long j = static_cast<long long>(f) * w.n_streams * w.n_mb +
                          static_cast<long long>(st) * w.n_mb + m;
      o.qscale[j] = flags & 31u;
      o.intra[j] = (flags >> 5) & 1u;
      o.written[j] = (flags >> 6) & 1u;
#pragma unroll
      for (int b = 0; b < 6; ++b) o.coded[j * 6 + b] = (cbp >> b) & 1u;
      o.mv_h[j] = mvh;
      o.mv_v[j] = mvv;
      s.mb_cbp[static_cast<long long>(st) * w.n_items + i] =
          static_cast<uint8_t>(cbp);
      cbps[k] = cbp & 63u;
      n_coded += __popc(cbps[k]);
    }
    int before = block_exclusive_scan<kThreads>(n_coded, sm, &total);
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int i = i0 + k;
      if (i >= w.n_items) continue;
      s.mb_cod[static_cast<long long>(st) * w.n_items + i] = before;
      before += __popc(cbps[k]);
    }
    if (tid == 0) s.cod_cnt[st * w.mb_tiles + t] = total;
    return;
  }
  const int t = bx - w.mb_tiles;
  const int p0 = t * kTile + tid * kItems;
  __shared__ int tile_live;
  if (tid == 0) tile_live = -1;
  uint32_t pos[kItems];
  int v8[kItems];
  int n7 = 0, ne = 0, live = -1;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int p = p0 + k;
    pos[k] = p < w.n_pairs ? buf[w.o_pos + p] : 0x40u;
    v8[k] = p < w.n_pairs ? static_cast<int8_t>(buf[w.o_v8 + p]) : 0;
    n7 += pos[k] >> 7;
    ne += v8[k] == -128;
    if (!(pos[k] & 0x40u)) live = p;
  }
  int c7 = s.b7_cnt[st * w.pair_tiles + t] +
           block_exclusive_scan<kThreads>(n7, sm, &total);
  int ce = s.esc_cnt[st * w.pair_tiles + t] +
           block_exclusive_scan<kThreads>(ne, sm, &total);
  // tile_live's reset is ordered before this by the scans' barriers
  if (live >= 0) atomicMax(&tile_live, live);
  __syncthreads();
  if (tid == 0 && tile_live >= 0) atomicMax(&s.live_end[st], tile_live);
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int p = p0 + k;
    if (p >= w.n_pairs) continue;
    int v = v8[k];
    if (v == -128) {
      ++ce;
      const int e = min(max(ce - 1, 0), w.n_esc - 1);
      const long long a = w.o_esc + 2ll * e;
      v = static_cast<int16_t>(buf[a] | (buf[a + 1] << 8));
    }
    s.val[static_cast<long long>(st) * w.n_pairs + p] = static_cast<int16_t>(v);
    if (pos[k] >> 7) {
      ++c7;
      if (c7 - 1 < w.n_blk)
        s.first[static_cast<long long>(st) * w.n_blk + c7 - 1] = p;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
write_kernel(Wire w, Scratch s, Out o) {
  const int st = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int i = static_cast<int>(blockIdx.x) * kWarpsPerCta +
                static_cast<int>(threadIdx.x >> 5);
  if (i >= w.n_items) return;             // the whole warp
  const uint8_t* buf = w.buf + st * w.stride;
  const long long si = static_cast<long long>(st) * w.n_items + i;
  const uint32_t cbp = s.mb_cbp[si] & 63u;
  int k = s.cod_cnt[st * w.mb_tiles + i / kTile] + s.mb_cod[si];
  const int* first = s.first + static_cast<long long>(st) * w.n_blk;
  const int live_end = s.live_end[st];
  const int16_t* val = s.val + static_cast<long long>(st) * w.n_pairs;
  const int f = i / w.n_mb, m = i - f * w.n_mb;
  const long long j = static_cast<long long>(f) * w.n_streams * w.n_mb +
                      static_cast<long long>(st) * w.n_mb + m;
  uint32_t* dst = reinterpret_cast<uint32_t*>(o.levels + j * 6 * 64);
  for (int b = 0; b < 6; ++b) {
    uint32_t lo16 = 0, hi16 = 0;         // positions 2 * lane, 2 * lane + 1
    if ((cbp >> b) & 1u) {
      if (k < w.n_blk) {
        const int lo = k == 0 ? 0 : first[k];
        const int hi = min(k == w.n_blk - 1 ? w.n_pairs : first[k + 1],
                           live_end + 1);
        for (int base = lo; base < hi; base += 32) {
          const int p = base + lane;
          uint32_t pp = 0x40u;
          uint32_t vv = 0;
          if (p < hi) {
            pp = buf[w.o_pos + p];
            vv = static_cast<uint16_t>(val[p]);
          }
          const int n = min(32, hi - base);
          for (int q = 0; q < n; ++q) {
            const uint32_t pq = __shfl_sync(kFull, pp, q);
            const uint32_t vq = __shfl_sync(kFull, vv, q);
            if (pq & 0x40u) continue;
            const uint32_t c = pq & 63u;
            if (c == 2u * lane) lo16 = vq;
            if (c == 2u * lane + 1u) hi16 = vq;
          }
        }
      }
      ++k;
    }
    dst[b * 32 + lane] = lo16 | (hi16 << 16);
  }
}

struct Layout {
  long long run_cnt, cod_cnt, b7_cnt, esc_cnt, first, live_end, mb_cod, val,
      mb_cbp;
  long long bytes;
};

long long align256(long long x) { return (x + 255) & ~255ll; }

Layout layout(int n_streams, int n_items, int n_pairs, int n_blk) {
  const long long S = n_streams;
  const long long mt = (n_items + kTile - 1) / kTile;
  const long long pt = (n_pairs + kTile - 1) / kTile;
  Layout l;
  long long o = 0;
  l.run_cnt = o; o = align256(o + 4 * S * mt);
  l.cod_cnt = o; o = align256(o + 4 * S * mt);
  l.b7_cnt = o;  o = align256(o + 4 * S * pt);
  l.esc_cnt = o; o = align256(o + 4 * S * pt);
  l.first = o;   o = align256(o + 4 * S * n_blk);
  l.live_end = o; o = align256(o + 4 * S);
  l.mb_cod = o;  o = align256(o + 4 * S * n_items);
  l.val = o;     o = align256(o + 2 * S * n_pairs);
  l.mb_cbp = o;  o = align256(o + S * n_items);
  l.bytes = o;
  return l;
}

}  // namespace

// Bytes of scratch a jt_wire_unpack call with these sizes needs.
extern "C" long long jt_wire_unpack_scratch_bytes(int n_streams, int n_frames,
                                                  int n_mb, int n_pairs,
                                                  int n_blk) {
  return layout(n_streams, n_frames * n_mb, n_pairs, n_blk).bytes;
}

// Sub-launches of one jt_wire_unpack call.
extern "C" int jt_wire_unpack_launches() { return 5; }

// bufs: uint8 [n_streams, L] wires v2 at the shared sizes (n_frames, n_mb,
// n_runs, mv_wide, n_pairs, n_esc; every count >= 1); n_blk >= 1 coded-block
// ordinals per stream; scratch: jt_wire_unpack_scratch_bytes bytes, 256-byte
// aligned.  Outputs over the joint [F, S*n_mb] macroblocks: levels int16
// [.., 6, 64], qscale uint8, coded bool [.., 6], intra bool, written bool,
// mv_h / mv_v int32.  Five launches on `stream`; returns the first non-zero
// cudaGetLastError().
extern "C" int jt_wire_unpack(const void* bufs, long long stride,
                              int n_streams, int n_frames, int n_mb,
                              int n_runs, int mv_wide, int n_pairs, int n_esc,
                              int n_blk, void* scratch, void* levels,
                              void* qscale, void* coded, void* intra,
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
  w.mb_tiles = (w.n_items + kTile - 1) / kTile;
  w.pair_tiles = (n_pairs + kTile - 1) / kTile;
  w.o_bm = n_frames;
  w.o_rec = w.o_bm + (static_cast<long long>(w.n_items) + 7) / 8;
  w.o_pos = w.o_rec + static_cast<long long>(mv_wide ? 8 : 4) * n_runs;
  w.o_v8 = w.o_pos + n_pairs;
  w.o_esc = w.o_v8 + n_pairs;

  const Layout l = layout(n_streams, w.n_items, n_pairs, n_blk);
  uint8_t* base = static_cast<uint8_t*>(scratch);
  Scratch s;
  s.run_cnt = reinterpret_cast<int*>(base + l.run_cnt);
  s.cod_cnt = reinterpret_cast<int*>(base + l.cod_cnt);
  s.b7_cnt = reinterpret_cast<int*>(base + l.b7_cnt);
  s.esc_cnt = reinterpret_cast<int*>(base + l.esc_cnt);
  s.first = reinterpret_cast<int*>(base + l.first);
  s.live_end = reinterpret_cast<int*>(base + l.live_end);
  s.mb_cod = reinterpret_cast<int*>(base + l.mb_cod);
  s.val = reinterpret_cast<int16_t*>(base + l.val);
  s.mb_cbp = base + l.mb_cbp;
  Out o;
  o.levels = static_cast<int16_t*>(levels);
  o.qscale = static_cast<uint8_t*>(qscale);
  o.coded = static_cast<bool*>(coded);
  o.intra = static_cast<bool*>(intra);
  o.written = static_cast<bool*>(written);
  o.mv_h = static_cast<int32_t*>(mv_h);
  o.mv_v = static_cast<int32_t*>(mv_v);

  const cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const dim3 tiles(w.mb_tiles + w.pair_tiles, n_streams);
  int rc;
  count_kernel<<<tiles, kThreads, 0, cs>>>(w, s);
  if ((rc = static_cast<int>(cudaGetLastError()))) return rc;
  ScanSet counts = {{s.run_cnt, s.b7_cnt, s.esc_cnt},
                    {w.mb_tiles, w.pair_tiles, w.pair_tiles}};
  scan_kernel<<<dim3(3, n_streams), kScanThreads, 0, cs>>>(counts);
  if ((rc = static_cast<int>(cudaGetLastError()))) return rc;
  fields_kernel<<<tiles, kThreads, 0, cs>>>(w, s, o);
  if ((rc = static_cast<int>(cudaGetLastError()))) return rc;
  ScanSet coded_set = {{s.cod_cnt, nullptr, nullptr}, {w.mb_tiles, 0, 0}};
  scan_kernel<<<dim3(1, n_streams), kScanThreads, 0, cs>>>(coded_set);
  if ((rc = static_cast<int>(cudaGetLastError()))) return rc;
  const dim3 mbs((w.n_items + kWarpsPerCta - 1) / kWarpsPerCta, n_streams);
  write_kernel<<<mbs, kThreads, 0, cs>>>(w, s, o);
  return static_cast<int>(cudaGetLastError());
}

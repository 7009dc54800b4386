// The checked build of K1-K3: one header, compiled away in the product.
//
// Each of csrc/dequant_idct.cu, mc_combine.cu and wire_unpack.cu defines
// JT_FILE (its id in the site table, ops/kernels.py SITE_FILES) and
// includes this header.  Built without JT_CHECKED (the product library)
// every macro below is the plain access or barrier it stands for, so the
// product kernels compile as they did before the header existed.  Built
// with -DJT_CHECKED (ops/kernels.py build(checked=True), its own library,
// bound only by kernels.bind_checked()) every launch checks:
//
// (a) Bounds.  JT_OK(i, extent) / JT_OK_N(i, n, extent) test the element
//     range [i, i + n) of a global buffer against its extent (the extents
//     travel in the launch's own structs, filled by the C entry points);
//     JT_SH_LD / JT_SH_ST / JT_SH_OK do the same for a shared array.  A
//     violation is recorded and the access suppressed: a load gives 0, a
//     store or copy is dropped, so the launch runs to its end.
// (b) Shared-memory hazards.  Every barrier of kernel code is
//     JT_SYNCTHREADS() or JT_SYNCWARP(), which advance the thread's CTA or
//     warp epoch.  A shadow of each shared granule (1, 2 or 4 bytes, per
//     kernel: its role's `shift`) in global memory, one slot a CTA, holds
//     its last writer and a summary of its readers, each with the epochs
//     of the access.  An access by one thread that another thread's access
//     to the same granule precedes with no barrier between (not the same
//     CTA epoch, nor for two threads of one warp the same warp epoch), one
//     of the two a write, is a RAW, WAR or WAW hazard.  Atomics on shared
//     memory are unordered with each other by design, not with plain
//     accesses.  A thread's epochs live in global memory at its hardware
//     slot (%smid, %warpid, lane), so helpers need no extra argument, and
//     the kernels' shared memory and K2's cooperative grid stay as they are.
// (c) Flag protocols.  JT_FLAG(cond, kind) records a protocol fault when
//     `cond` is false: K2 reads a row of an earlier output that no wait of
//     its warp saw complete (JT_WAITED / JT_READ_ROW), or publishes before
//     the stores it covers; K3 sums a prefix from a status word it did not
//     see complete.  A spin past its (checked) limit is a recorded fault
//     instead of a trap, so the record survives.
// (d) Schedule perturbation.  JT_DELAY(tag) sleeps 0 .. kMaxDelayNs ns,
//     from a counter-based hash of (seed, block, warp, tag); seed 0 (the
//     default) sleeps nothing.
// Negative controls: JT_INJECT(id) is true where defect `id`
// (ops/kernels.py INJECTIONS) is planted, when the host asked for it.
//
// A launch keeps its first fault (kind, site = JT_FILE << 16 | line,
// index, extent, block, thread, the other thread of a hazard) and a count
// per kind in a record per source, which jt_checked_fault copies out.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#ifndef JT_FILE
#error "define JT_FILE (the source's id in the site table) first"
#endif

#ifndef JT_CHECKED

#define JT_SYNCTHREADS() __syncthreads()
#define JT_SYNCWARP() __syncwarp()
#define JT_OK(i, extent) true
#define JT_OK_N(i, n, extent) true
#define JT_SH_LD(a, i, extent) (a)[i]
#define JT_SH_ST(a, i, extent, v) ((a)[i] = (v))
#define JT_SH_OK(a, i, n, extent, access) true
#define JT_FLAG(cond, kind) ((void)0)
#define JT_DELAY(tag) ((void)0)
#define JT_INJECT(id) false
#define JT_INJECT_AT(id, where) false
#define JT_BEGIN(role) ((void)0)
#define JT_STORED() ((void)0)
#define JT_PUBLISHING(n) ((void)0)
#define JT_WAITED(wk, r0, r1, mb_h) ((void)0)
#define JT_READ_ROW(frame, row, mb_h) true
#define JT_SPIN_OUT(escape) __trap()
#define JT_SPIN_SCALE(n) (n)
#define JT_ARG(decl)
#define JT_PASS(expr)

#else  // JT_CHECKED

namespace jt {

enum Kind : int {
  kNone = 0,
  kBoundsGlobal,   // (a) a global access past its buffer
  kBoundsShared,   // (a) a shared access past its array
  kRaw,            // (b) read after an unordered write
  kWar,            // (b) write after an unordered read
  kWaw,            // (b) write after an unordered write
  kFlagRead,       // (c) K2: a row read that no wait saw complete
  kFlagPublish,    // (c) K2: a publish before the stores it covers
  kFlagPrefix,     // (c) K3: a prefix from an incomplete status word
  kSpin,           // (c) a wait past its spin limit
  kChecker,        // the checker's own state out of its range
  kKinds
};
enum Access : int { kRead = 0, kWrite = 1, kAtomic = 2 };

// One launch role (K3: launch A = 0, launch B = 1; K1, K2: 0), set by the
// C entry point before each launch.
struct Config {
  unsigned long long* shadow;   // [nslot, granules, 2] zeroed
  unsigned* waited;             // K2: [warps, waited_words] zeroed bits
  int granules;                 // shadow granules a CTA
  int nslot;                    // CTA slots of the shadow
  int shift;                    // log2 of a granule's bytes
  int waited_words;             // K2: bit words a warp ((frame, row)s)
  int inject;                   // the defect to plant, 0 none
  int pad;
  unsigned long long seed;      // perturbation seed, 0 none
};

struct Fault {
  unsigned count[kKinds];       // faults of each kind
  unsigned claimed;             // set by the first
  int kind, site, block, thread, other;
  long long index, extent;
};

// A thread's checker state at its hardware slot.
struct ThreadState {
  unsigned cta_ep, warp_ep;     // barriers passed since the kernel began
  unsigned stores;              // K2: output stores since the last publish
  unsigned role;
  unsigned block, thread;       // the owner, checked at every barrier
  unsigned pad[2];
};

constexpr int kMaxSms = 160, kHwWarps = 64;
constexpr int kMaxDelayNs = 2048;
constexpr int kFaultWords = sizeof(Fault) / 4;

}  // namespace jt

namespace {

// per source (each is its own device module): the roles' configs, the
// fault record and the threads' states
__constant__ jt::Config jt_cfg[2];
__device__ jt::Fault jt_fault;
__device__ jt::ThreadState jt_threads[jt::kMaxSms * jt::kHwWarps * 32];

__device__ __noinline__ void jt_record(int kind, int site, long long index,
                                       long long extent, int other) {
  atomicAdd(&jt_fault.count[kind], 1u);
  if (atomicCAS(&jt_fault.claimed, 0u, 1u) == 0u) {
    jt_fault.kind = kind;
    jt_fault.site = site;
    jt_fault.block = static_cast<int>(blockIdx.x);
    jt_fault.thread = static_cast<int>(threadIdx.x);
    jt_fault.other = other;
    jt_fault.index = index;
    jt_fault.extent = extent;
  }
}

__device__ __forceinline__ jt::ThreadState* jt_state() {
  unsigned sm, w;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
  asm volatile("mov.u32 %0, %%warpid;" : "=r"(w));
  sm = min(sm, static_cast<unsigned>(jt::kMaxSms - 1));
  return &jt_threads[(sm * jt::kHwWarps + (w & (jt::kHwWarps - 1))) * 32 +
                     (threadIdx.x & 31)];
}

__device__ __forceinline__ void jt_begin(unsigned role) {
  jt::ThreadState* s = jt_state();
  s->cta_ep = s->warp_ep = s->stores = 0;
  s->role = role;
  s->block = blockIdx.x;
  s->thread = threadIdx.x;
}

__device__ __forceinline__ jt::ThreadState* jt_owned(int site) {
  jt::ThreadState* s = jt_state();
  if (s->block != blockIdx.x || s->thread != threadIdx.x)
    jt_record(jt::kChecker, site, s->thread, threadIdx.x, -1);
  return s;
}

__device__ __forceinline__ void jt_cta_barrier(int site) {
  __syncthreads();
  jt::ThreadState* s = jt_owned(site);
  ++s->cta_ep;
}

__device__ __forceinline__ void jt_warp_barrier(int site) {
  __syncwarp();
  jt::ThreadState* s = jt_owned(site);
  ++s->warp_ep;
}

__device__ __noinline__ bool jt_ok(long long i, long long n,
                                   long long extent, int site, int kind) {
  if (i >= 0 && n >= 0 && i <= extent - n) return true;
  jt_record(kind, site, i, extent, -1);
  return false;
}

// ---- (b) the shadow of shared memory

// An access as the shadow keeps it: the CTA's stamp (19 bits, 0 = none),
// the thread (10), two flags (a writer: atomic; readers: several threads,
// several warps) and the CTA and warp epochs (16 bits each; two accesses
// 65536 barriers apart would look unordered: no kernel here comes near).
struct JtAcc {
  unsigned stamp, tid, f1, f2, cta, warp;
};

__device__ __forceinline__ unsigned long long jt_pack(const JtAcc& a) {
  return (static_cast<unsigned long long>(a.stamp & 0x7FFFFu) << 45) |
         (static_cast<unsigned long long>(a.tid & 0x3FFu) << 35) |
         (static_cast<unsigned long long>(a.f1 & 1u) << 34) |
         (static_cast<unsigned long long>(a.f2 & 1u) << 33) |
         (static_cast<unsigned long long>(a.cta & 0xFFFFu) << 16) |
         (a.warp & 0xFFFFu);
}

__device__ __forceinline__ JtAcc jt_unpack(unsigned long long v) {
  JtAcc a;
  a.stamp = static_cast<unsigned>(v >> 45) & 0x7FFFFu;
  a.tid = static_cast<unsigned>(v >> 35) & 0x3FFu;
  a.f1 = static_cast<unsigned>(v >> 34) & 1u;
  a.f2 = static_cast<unsigned>(v >> 33) & 1u;
  a.cta = static_cast<unsigned>(v >> 16) & 0xFFFFu;
  a.warp = static_cast<unsigned>(v) & 0xFFFFu;
  return a;
}

// The earlier access `p` (a writer, or a single reader) is ordered before
// `me`: another CTA's (or none), the same thread's, a CTA barrier between,
// or a warp barrier between two threads of one warp.
__device__ __forceinline__ bool jt_ordered(const JtAcc& p, const JtAcc& me) {
  return p.stamp != me.stamp || p.tid == me.tid || p.cta != me.cta ||
         ((p.tid >> 5) == (me.tid >> 5) && p.warp != me.warp);
}

// Every read the summary `r` stands for is ordered before `me`.  A summary
// holds reads of one CTA epoch; without the `cross` flag (f2) all of one
// warp and one warp epoch; `multi` (f1): of more than one thread.
__device__ __forceinline__ bool jt_readers_ordered(const JtAcc& r,
                                                   const JtAcc& me) {
  if (r.stamp != me.stamp || r.cta != me.cta) return true;
  if (!r.f1 && r.tid == me.tid) return true;
  return !r.f2 && (r.tid >> 5) == (me.tid >> 5) && r.warp != me.warp;
}

__device__ __forceinline__ JtAcc jt_merge(const JtAcc& r, const JtAcc& me) {
  if (jt_readers_ordered(r, me)) return JtAcc{me.stamp, me.tid, 0, 0,
                                              me.cta, me.warp};
  JtAcc m = r;
  m.f1 = r.f1 | (r.tid != me.tid ? 1u : 0u);
  m.f2 = r.f2 | ((r.tid >> 5) != (me.tid >> 5) ? 1u : 0u);
  return m;
}

__device__ __forceinline__ unsigned long long jt_load(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p)
               : "memory");
  return v;
}

// Orders a thread's shadow update before its look at the other word, as
// the threads of its CTA (the only ones that use its slot) see them.
__device__ __forceinline__ void jt_fence() {
  asm volatile("fence.sc.cta;" ::: "memory");
}

// Record `bytes` bytes of shared memory at `p` read, written or updated
// atomically by this thread; report an unordered earlier access.
__device__ __noinline__ void jt_shadow(const void* p, int bytes, int access,
                                       int site) {
  jt::ThreadState* s = jt_state();
  const jt::Config& c = jt_cfg[s->role & 1u];
  if (c.shadow == nullptr || bytes <= 0) return;
  const unsigned slot = blockIdx.x % static_cast<unsigned>(c.nslot);
  const JtAcc me{blockIdx.x / static_cast<unsigned>(c.nslot) + 1u,
                 threadIdx.x, access == jt::kAtomic ? 1u : 0u, 0u,
                 s->cta_ep, s->warp_ep};
  const unsigned addr =
      static_cast<unsigned>(__cvta_generic_to_shared(p));
  const unsigned g0 = addr >> c.shift;
  const unsigned g1 = (addr + static_cast<unsigned>(bytes) - 1u) >> c.shift;
  if (g1 >= static_cast<unsigned>(c.granules)) {
    jt_record(jt::kChecker, site, addr, static_cast<long long>(c.granules)
                                            << c.shift, -1);
    return;
  }
  unsigned long long* base =
      c.shadow + 2ull * (static_cast<unsigned long long>(slot) * c.granules);
  bool raw = false, war = false, waw = false;
  int other = -1;
  for (unsigned g = g0; g <= g1; ++g) {
    unsigned long long* w = base + 2ull * g;
    unsigned long long* r = w + 1;
    if (access == jt::kRead) {
      // join the readers, then look at the writer (a write does the
      // reverse, so of two unordered accesses one sees the other)
      unsigned long long old = jt_load(r);
      for (;;) {
        const unsigned long long now =
            jt_pack(jt_merge(jt_unpack(old), me));
        const unsigned long long seen = atomicCAS(r, old, now);
        if (seen == old) break;
        old = seen;
      }
      jt_fence();
      const JtAcc wr = jt_unpack(jt_load(w));
      if (!jt_ordered(wr, me)) {
        raw = true;
        other = static_cast<int>(wr.tid);
      }
    } else {
      const JtAcc ow = jt_unpack(atomicExch(w, jt_pack(me)));
      jt_fence();
      const JtAcc rd = jt_unpack(jt_load(r));
      if (!jt_ordered(ow, me) && !(access == jt::kAtomic && ow.f1)) {
        waw = true;
        other = static_cast<int>(ow.tid);
      }
      if (!jt_readers_ordered(rd, me)) {
        war = true;
        other = static_cast<int>(rd.tid);
      }
    }
  }
  if (raw) jt_record(jt::kRaw, site, addr, bytes, other);
  if (war) jt_record(jt::kWar, site, addr, bytes, other);
  if (waw) jt_record(jt::kWaw, site, addr, bytes, other);
}

// A shared access of n elements at a + i: bounds, then the shadow.
template <typename T>
__device__ __forceinline__ bool jt_sh(const T* a, long long i, long long n,
                                      long long extent, int access,
                                      int site) {
  if (!jt_ok(i, n, extent, site, jt::kBoundsShared)) return false;
  jt_shadow(a + i, static_cast<int>(n * sizeof(T)), access, site);
  return true;
}

template <typename T>
__device__ __forceinline__ T jt_sh_ld(const T* a, long long i,
                                      long long extent, int site) {
  return jt_sh(a, i, 1, extent, jt::kRead, site) ? a[i] : T();
}

template <typename T, typename V>
__device__ __forceinline__ void jt_sh_st(T* a, long long i, long long extent,
                                         V v, int site) {
  if (jt_sh(a, i, 1, extent, jt::kWrite, site)) a[i] = static_cast<T>(v);
}

// ---- (c) flag protocols

__device__ __forceinline__ void jt_flag(bool ok, int kind, int site) {
  if (!ok) jt_record(kind, site, 0, 0, -1);
}

// K2: the warp's index in the launch and its bit of (frame, row).
__device__ __forceinline__ unsigned* jt_waited_word(long long bit,
                                                    int site) {
  const jt::Config& c = jt_cfg[0];
  if (c.waited == nullptr) return nullptr;
  if (bit < 0 || bit >= 32ll * c.waited_words) {
    jt_record(jt::kChecker, site, bit, 32ll * c.waited_words, -1);
    return nullptr;
  }
  const long long warp =
      static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) +
      (threadIdx.x >> 5);
  return c.waited + warp * c.waited_words + (bit >> 5);
}

// Rows r0 .. r1 of output wk were seen complete by the warp's wait (whole
// warp; lane i sets row r0 + i).
__device__ __forceinline__ void jt_waited(int wk, int r0, int r1, int mb_h,
                                          int site) {
  const int lane = threadIdx.x & 31;
  if (wk < 0 || r0 + lane > r1) return;
  unsigned* w = jt_waited_word(static_cast<long long>(wk) * mb_h + r0 + lane,
                               site);
  if (w) atomicOr(w, 1u << ((static_cast<long long>(wk) * mb_h + r0 + lane)
                            & 31));
}

// A read of row `row` of output `frame` (-1: a carried input plane, which
// no wait covers) is covered by a wait of the warp.
__device__ __forceinline__ bool jt_read_row(int frame, int row, int mb_h,
                                            int site) {
  if (frame < 0) return true;
  const long long bit = static_cast<long long>(frame) * mb_h + row;
  const unsigned* w = jt_waited_word(bit, site);
  if (w == nullptr) return true;
  if ((__ldcg(w) >> (bit & 31)) & 1u) return true;
  jt_record(jt::kFlagRead, site, bit, static_cast<long long>(mb_h), -1);
  return false;
}

__device__ __forceinline__ void jt_stored() { ++jt_state()->stores; }

// A publish of n macroblocks: each lane stored 3 words of each.
__device__ __forceinline__ void jt_publishing(int n, int site) {
  jt::ThreadState* s = jt_state();
  if (s->stores != 3u * static_cast<unsigned>(n))
    jt_record(jt::kFlagPublish, site, s->stores, 3ll * n, -1);
  s->stores = 0;
}

// ---- (d) perturbation

__device__ __forceinline__ void jt_delay(unsigned tag) {
  const unsigned long long seed = jt_cfg[0].seed;
  if (!seed) return;
  unsigned long long z = seed ^ (static_cast<unsigned long long>(blockIdx.x)
                                 << 32) ^
                         (static_cast<unsigned long long>(threadIdx.x >> 5)
                          << 16) ^ tag;
  z += 0x9E3779B97F4A7C15ull;   // splitmix64
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
  z ^= z >> 31;
  __nanosleep(static_cast<unsigned>(z % jt::kMaxDelayNs));
}

}  // namespace

#define JT_SITE ((JT_FILE << 16) | __LINE__)
#define JT_SYNCTHREADS() jt_cta_barrier(JT_SITE)
#define JT_SYNCWARP() jt_warp_barrier(JT_SITE)
#define JT_OK(i, extent)                                                   \
  jt_ok(static_cast<long long>(i), 1, static_cast<long long>(extent),     \
        JT_SITE, jt::kBoundsGlobal)
#define JT_OK_N(i, n, extent)                                              \
  jt_ok(static_cast<long long>(i), static_cast<long long>(n),             \
        static_cast<long long>(extent), JT_SITE, jt::kBoundsGlobal)
#define JT_SH_LD(a, i, extent) jt_sh_ld((a), (i), (extent), JT_SITE)
#define JT_SH_ST(a, i, extent, v) jt_sh_st((a), (i), (extent), (v), JT_SITE)
#define JT_SH_OK(a, i, n, extent, access)                                  \
  jt_sh((a), (i), (n), (extent), (access), JT_SITE)
#define JT_FLAG(cond, kind) jt_flag((cond), (kind), JT_SITE)
#define JT_DELAY(tag) jt_delay(tag)
#define JT_INJECT(id) (jt_cfg[0].inject == (id))
#define JT_INJECT_AT(id, where) (JT_INJECT(id) && (where))
#define JT_BEGIN(role) jt_begin(role)
#define JT_STORED() jt_stored()
#define JT_PUBLISHING(n) jt_publishing((n), JT_SITE)
#define JT_WAITED(wk, r0, r1, mb_h) jt_waited((wk), (r0), (r1), (mb_h), \
                                              JT_SITE)
#define JT_READ_ROW(frame, row, mb_h) jt_read_row((frame), (row), (mb_h), \
                                                  JT_SITE)
#define JT_SPIN_OUT(escape) (jt_record(jt::kSpin, JT_SITE, 0, 0, -1), (escape))
// checked launches run slower and sleep where (d) says: their waits may
// poll 4 times as often before the spin counts as a fault
#define JT_SPIN_SCALE(n) ((n) * 4)
#define JT_ARG(decl) , decl
#define JT_PASS(expr) , expr

// Host side.  jt::host holds what the exported setters gave (one for the
// library: an inline variable); each source sets its own roles' configs on
// the stream ahead of a launch and copies out or resets its fault record.
namespace jt {

struct Host {
  void* shadow = nullptr;       // the checker's buffer (jt_checked_shadow)
  long long shadow_bytes = 0;
  unsigned long long seed = 0;  // jt_checked_seed
  int inject = 0;               // jt_checked_inject
};

inline Host host;

}  // namespace jt

namespace {

// Carve n_roles configs from the shadow buffer, role r for CTAs of
// shared_bytes[r] bytes of static shared memory at granules of
// 1 << shift[r] bytes over grid[r] CTAs (at most one slot a CTA; fewer
// when the buffer is short, CTAs then share slots by blockIdx modulo, which
// can only hide a hazard), K2's waited bits (waited_words a warp over
// waited_warps warps) after them; zero what each uses and copy the configs
// to the device, all on `stream`.  Returns a cudaError_t.
inline int jt_configure(int n_roles, const size_t* shared_bytes,
                        const int* shift, const long long* grid,
                        long long waited_words, long long waited_warps,
                        cudaStream_t stream) {
  const jt::Host& h = jt::host;
  if (h.shadow == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, reserved = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&reserved,
                               cudaDevAttrReservedSharedMemoryPerBlock, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  jt::Config cfg[2] = {};
  unsigned char* at = static_cast<unsigned char*>(h.shadow);
  const long long waited =
      (waited_words * waited_warps * 4 + 255) / 256 * 256;
  long long left = h.shadow_bytes - waited;
  for (int r = 0; r < n_roles; ++r) {
    const long long granules =
        (static_cast<long long>(shared_bytes[r]) + reserved +
         (1ll << shift[r]) - 1) >> shift[r];
    const long long per_cta = granules * 16;
    const long long cap = left / (n_roles - r) / per_cta;
    const long long nslot = grid[r] < cap ? grid[r] : cap;
    if (nslot < 1) return static_cast<int>(cudaErrorMemoryAllocation);
    const long long used = (nslot * per_cta + 255) / 256 * 256;
    cfg[r].shadow = reinterpret_cast<unsigned long long*>(at);
    cfg[r].granules = static_cast<int>(granules);
    cfg[r].nslot = static_cast<int>(nslot);
    cfg[r].shift = shift[r];
    cfg[r].inject = h.inject;
    cfg[r].seed = h.seed;
    if ((e = cudaMemsetAsync(at, 0, nslot * per_cta, stream)))
      return static_cast<int>(e);
    at += used;
    left -= used;
  }
  if (waited_words > 0) {
    cfg[0].waited = reinterpret_cast<unsigned*>(at);
    cfg[0].waited_words = static_cast<int>(waited_words);
    if ((e = cudaMemsetAsync(at, 0, waited, stream)))
      return static_cast<int>(e);
  }
  return static_cast<int>(cudaMemcpyToSymbolAsync(
      jt_cfg, cfg, sizeof(cfg), 0, cudaMemcpyHostToDevice, stream));
}

// The static shared bytes of a kernel (its shadow's extent).
inline size_t jt_shared_bytes(const void* kernel) {
  cudaFuncAttributes a = {};
  return cudaFuncGetAttributes(&a, kernel) == cudaSuccess ? a.sharedSizeBytes
                                                           : 0;
}

}  // namespace

// Each source exports its fault record: jt_checked_fault_<name>(out)
// copies it (jt::kFaultWords int32 words) to host memory, and
// jt_checked_reset_<name>() zeroes it; the library's jt_checked_fault and
// jt_checked_reset (csrc/dequant_idct.cu) do all three sources.
#define JT_CHECKED_EXPORTS(name)                                            \
  extern "C" int jt_checked_fault_##name(void* out) {                       \
    return static_cast<int>(                                                \
        cudaMemcpyFromSymbol(out, jt_fault, sizeof(jt::Fault)));             \
  }                                                                         \
  extern "C" int jt_checked_reset_##name() {                                \
    const jt::Fault zero = {};                                              \
    return static_cast<int>(                                                \
        cudaMemcpyToSymbol(jt_fault, &zero, sizeof(zero)));                  \
  }

#endif  // JT_CHECKED

// Standalone driver for sanitizer runs over the port's native host code
// (frontend.cpp, mp2.cpp, ts_demux.cpp): ASan+UBSan for memory errors and
// undefined behaviour, TSan for the threaded batch parse.  It calls every
// entry point that host/native/__init__.py binds, with the same argument
// lists (a declaration that differs from the definition links silently
// and is undefined behaviour, so keep the two in step):
//
//   san video.es audio.mp2 [stream.ts]
//
// Built and run by sanitize_check.py beside it, which generates
// vlc_tables.h into a temporary directory and passes it with -I.
// Exits 0 and prints one "sanitize OK" line when every part ran; a
// sanitizer report aborts it (ASan/UBSan) or sets its exit code (TSan).

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {
void* mpeg1_parser_create();
void mpeg1_parser_destroy(void*);
void mpeg1_parser_write(void*, const uint8_t*, int64_t);
int mpeg1_parser_has_seq(void*);
void mpeg1_parser_seq_info(void*, int32_t*);
void mpeg1_parser_quant(void*, int32_t*, int32_t*);
int mpeg1_parser_parse_frame(void*, int, int32_t*, uint8_t*, uint8_t*,
                             uint8_t*, int32_t*, int64_t*);
int mpeg1_parser_parse_batch(void*, int, int, int16_t*, uint8_t*, uint8_t*,
                             uint8_t*, uint8_t*, int32_t*, uint8_t*);
int mpeg1_parser_parse_batch_sparse(void*, int, int, uint8_t*, uint8_t*,
                                    uint8_t*, uint8_t*, int32_t*, uint8_t*,
                                    int32_t*, int16_t*, int64_t, int64_t*);
int mpeg1_parser_parse_batch_packed(void*, int, int, uint16_t*, uint8_t*,
                                    uint8_t*, int16_t*, int64_t*, uint8_t*,
                                    uint8_t*, int8_t*, int16_t*, int64_t,
                                    int64_t*, int64_t*);
void mpeg1_parser_set_threads(void*, int);
void mpeg1_parser_set_timing(void*, int);
void mpeg1_parser_last_timing(void*, int64_t*);
int64_t mpeg1_parser_bit_index(void*);
void mpeg1_parser_set_bit_index(void*, int64_t);
int64_t mpeg1_parser_evict(void*);
int mpeg1_parser_seek_iframe(void*);
int64_t mpeg1_parser_byte_length(void*);
int64_t mpeg1_parser_frames_parsed(void*);
uint64_t host_canary_cpu(int64_t);
void host_canary_mem(uint8_t*, const uint8_t*, int64_t, int);

void* mp2_decoder_create();
void mp2_decoder_destroy(void*);
void mp2_decoder_write(void*, const uint8_t*, int64_t);
int mp2_decoder_parse_frame(void*, int32_t*);
int mp2_decoder_decode(void*, float*, float*);
void mp2_decoder_synthesize(void*, const int32_t*, int, float*, float*);
int mp2_decoder_sample_rate(void*);
int64_t mp2_decoder_bit_index(void*);
void mp2_decoder_set_bit_index(void*, int64_t);
int64_t mp2_decoder_evict(void*);
int64_t mp2_decoder_byte_length(void*);
void mp2_decoder_get_state(void*, float*, int32_t*);
void mp2_decoder_set_state(void*, const float*, int32_t);

void* ts_demux_create(int);
void ts_demux_destroy(void*);
void ts_demux_connect(void*, int);
long long ts_demux_write(void*, const uint8_t*, long long, uint8_t*,
                         long long);
long long ts_demux_flush(void*, uint8_t*, long long);
long long ts_demux_pending(void*);
double ts_demux_current_time(void*);
double ts_demux_start_time(void*);
long long ts_demux_packets(void*);
long long ts_demux_resyncs(void*);
}

namespace {

// the parser wrapper's reserve (NativeMPEG1Parser.SPARSE_CAP_PER_BLOCK)
const int64_t kCapPerBlock = 16;

std::vector<uint8_t> slurp(const char* path) {
  FILE* f = std::fopen(path, "rb");
  if (!f) { std::perror(path); std::exit(2); }
  std::fseek(f, 0, SEEK_END);
  long n = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> v(n);
  if (std::fread(v.data(), 1, n, f) != (size_t)n) std::exit(2);
  std::fclose(f);
  return v;
}

// The picture's macroblocks, from the sequence header's fields; reads
// the quant matrices too, as the binding does once a header is in.
int64_t mb_count(void* p) {
  int32_t info[5] = {};
  mpeg1_parser_seq_info(p, info);
  int32_t iq[64], nq[64];
  mpeg1_parser_quant(p, iq, nq);
  return (int64_t)info[2] * info[3];
}

// One serial picture (the decoder's exact path after a batch refusal).
int serial_one(void* p, int eof) {
  int64_t n_mb = mb_count(p);
  std::vector<int32_t> coef(n_mb * 6 * 64), mv(n_mb * 2);
  std::vector<uint8_t> coded(n_mb * 6), intra(n_mb), written(n_mb);
  int64_t info[3];
  return mpeg1_parser_parse_frame(p, eof, coef.data(), coded.data(),
                                  intra.data(), written.data(), mv.data(),
                                  info);
}

// The dense-levels batch wire; returns the parser's code.
int dense_batch(void* p, int eof, int F) {
  int64_t n_mb = mb_count(p);
  std::vector<int16_t> levels(F * n_mb * 6 * 64);
  std::vector<uint8_t> qs(F * n_mb), coded(F * n_mb * 6), intra(F * n_mb),
      written(F * n_mb), pt(F);
  std::vector<int32_t> mv(F * n_mb * 2);
  return mpeg1_parser_parse_batch(p, eof, F, levels.data(), qs.data(),
                                  coded.data(), intra.data(), written.data(),
                                  mv.data(), pt.data());
}

// The sparse batch wire; a cap overflow (-3) reruns as the dense wire.
int sparse_batch(void* p, int eof, int F) {
  int64_t n_mb = mb_count(p);
  int64_t cap = n_mb * 6 * kCapPerBlock;
  std::vector<uint8_t> qs(F * n_mb), coded(F * n_mb * 6), intra(F * n_mb),
      written(F * n_mb), pt(F);
  std::vector<int32_t> mv(F * n_mb * 2), sp_idx(F * cap);
  std::vector<int16_t> sp_val(F * cap);
  std::vector<int64_t> counts(F + 1);
  int64_t saved = mpeg1_parser_bit_index(p);
  int r = mpeg1_parser_parse_batch_sparse(
      p, eof, F, qs.data(), coded.data(), intra.data(), written.data(),
      mv.data(), pt.data(), sp_idx.data(), sp_val.data(), cap,
      counts.data());
  if (r == -3) {
    mpeg1_parser_set_bit_index(p, saved);
    r = dense_batch(p, eof, F);
  }
  return r;
}

// The packed wire v2 (the main path's); a cap overflow reruns dense.
int packed_batch(void* p, int eof, int F) {
  int64_t n_mb = mb_count(p);
  int64_t cap = n_mb * 6 * kCapPerBlock;
  std::vector<uint16_t> rl(F * n_mb);
  std::vector<uint8_t> rf(F * n_mb), rc(F * n_mb), pt(F), sp_pos(F * cap);
  std::vector<int16_t> rm(F * n_mb * 2), sp_esc(F * (cap / 8));
  std::vector<int64_t> rcounts(F + 1), sp_counts(F + 2), esc_counts(F + 1);
  std::vector<int8_t> sp_v8(F * cap);
  int64_t saved = mpeg1_parser_bit_index(p);
  int r = mpeg1_parser_parse_batch_packed(
      p, eof, F, rl.data(), rf.data(), rc.data(), rm.data(), rcounts.data(),
      pt.data(), sp_pos.data(), sp_v8.data(), sp_esc.data(), cap,
      sp_counts.data(), esc_counts.data());
  if (r == -3) {
    mpeg1_parser_set_bit_index(p, saved);
    r = dense_batch(p, eof, F);
  }
  return r;
}

typedef int (*BatchFn)(void*, int, int);

// Batches of F pictures on `threads` threads while the stream arrives in
// `chunk`-byte writes, evicting consumed bytes after each; a refused
// batch (quirk leak, malformed data) decodes one picture serially, as
// the decoder does.  `timed`: with the phase timing on, each batch's
// stamps must not decrease.  Returns the pictures parsed.
int batches(const std::vector<uint8_t>& es, BatchFn fn, int F, int threads,
            size_t chunk, bool timed = false) {
  void* p = mpeg1_parser_create();
  mpeg1_parser_set_threads(p, threads);
  mpeg1_parser_set_timing(p, timed ? 1 : 0);
  int64_t stamps[5];
  int frames = 0;
  for (size_t off = 0; off < es.size(); off += chunk) {
    size_t n = off + chunk <= es.size() ? chunk : es.size() - off;
    mpeg1_parser_write(p, es.data() + off, (int64_t)n);
    if (!mpeg1_parser_has_seq(p)) continue;
    int eof = off + chunk >= es.size();
    while (true) {
      int r = fn(p, eof, F);
      if (timed) {
        mpeg1_parser_last_timing(p, stamps);
        for (int k = 1; k < 5; k++)
          if (stamps[k] < stamps[k - 1]) std::exit(4);
      }
      if (r < 0) r = serial_one(p, eof);
      if (r <= 0) break;
      frames += r;
    }
    mpeg1_parser_evict(p);
    (void)mpeg1_parser_byte_length(p);
  }
  if (mpeg1_parser_frames_parsed(p) < 0) std::exit(4);
  mpeg1_parser_destroy(p);
  return frames;
}

// The serial exact path, then the thumbnails' I-picture seek from the
// stream's start.  Returns (serial pictures, I pictures found).
void serial_and_seek(const std::vector<uint8_t>& es, int* serial,
                     int* iframes) {
  void* p = mpeg1_parser_create();
  mpeg1_parser_write(p, es.data(), (int64_t)es.size());
  *serial = *iframes = 0;
  if (mpeg1_parser_has_seq(p)) {
    while (serial_one(p, 1)) (*serial)++;
    mpeg1_parser_set_bit_index(p, 0);
    while (mpeg1_parser_seek_iframe(p)) {
      (*iframes)++;
      if (!serial_one(p, 1)) break;
    }
  }
  mpeg1_parser_destroy(p);
}

// MP2: chunked writes with eviction and the full decode; then the parse
// and the synthesis apart on one decoder, its filter state and bit
// position carried into a second decoder every few frames, whose full
// decode of the next frame must equal the first's.  Returns the frames.
int mp2(const std::vector<uint8_t>& aes) {
  void* a = mp2_decoder_create();
  int frames = 0;
  std::vector<float> left(1152), right(1152);
  for (size_t off = 0; off < aes.size(); off += 777) {
    size_t n = off + 777 <= aes.size() ? 777 : aes.size() - off;
    mp2_decoder_write(a, aes.data() + off, (int64_t)n);
    while (mp2_decoder_decode(a, left.data(), right.data())) frames++;
    mp2_decoder_evict(a);
  }
  mp2_decoder_destroy(a);

  void* s = mp2_decoder_create();
  void* d = mp2_decoder_create();
  mp2_decoder_write(s, aes.data(), (int64_t)aes.size());
  mp2_decoder_write(d, aes.data(), (int64_t)aes.size());
  std::vector<int32_t> samples(36 * 2 * 32);
  std::vector<float> v(2 * 1024), l2(1152), r2(1152);
  int32_t pos = 0;
  for (int k = 0;; k++) {
    if (k % 3 == 2) {
      mp2_decoder_get_state(s, v.data(), &pos);
      mp2_decoder_set_state(d, v.data(), pos);
      mp2_decoder_set_bit_index(d, mp2_decoder_bit_index(s));
      if (!mp2_decoder_decode(d, l2.data(), r2.data())) break;
    }
    if (!mp2_decoder_parse_frame(s, samples.data())) break;
    mp2_decoder_synthesize(s, samples.data(), 36, left.data(), right.data());
    if (k % 3 == 2 &&
        (std::memcmp(left.data(), l2.data(), 1152 * sizeof(float)) ||
         std::memcmp(right.data(), r2.data(), 1152 * sizeof(float)))) {
      std::fprintf(stderr, "mp2: resumed decode differs at frame %d\n", k);
      std::exit(4);
    }
    (void)mp2_decoder_sample_rate(s);
  }
  if (mp2_decoder_byte_length(s) != (int64_t)aes.size()) std::exit(4);
  mp2_decoder_destroy(s);
  mp2_decoder_destroy(d);
  return frames;
}

// The capacity NativeTSDemux._cap reserves for one write.
long long ts_cap(void* d, long long n) {
  long long pending = ts_demux_pending(d);
  return pending + n + 16 * (2 * (n + pending) / 188 + 32) + 4096;
}

// TS demux: clean in 3-packet writes, bytes corrupted (sync marks too)
// in odd writes, and a garbage prefix.  Returns the rounds that emitted.
long long ts(const std::vector<uint8_t>& stream) {
  long long rounds_with_events = 0;
  for (int round = 0; round < 3; round++) {
    std::vector<uint8_t> in = stream;
    if (round == 1)
      for (size_t k = 0; k < in.size(); k += 531) in[k] ^= 0x5A;
    if (round == 2) in.insert(in.begin(), 399, 0x11);
    void* d = ts_demux_create(round != 1);
    ts_demux_connect(d, 0xE0);
    ts_demux_connect(d, 0xC0);
    size_t step = round == 0 ? 188 * 3 : 997;
    long long events = 0;
    for (size_t off = 0; off < in.size(); off += step) {
      size_t n = off + step <= in.size() ? step : in.size() - off;
      long long cap = ts_cap(d, (long long)n);
      std::vector<uint8_t> out(cap);
      long long r = ts_demux_write(d, in.data() + off, (long long)n,
                                   out.data(), cap);
      if (r < 0) { std::fprintf(stderr, "ts overflow\n"); std::exit(3); }
      events += r > 0;
    }
    std::vector<uint8_t> out(ts_cap(d, 0));
    if (ts_demux_flush(d, out.data(), (long long)out.size()) < 0)
      std::exit(3);
    if (std::isnan(ts_demux_current_time(d)) ||
        std::isnan(ts_demux_start_time(d)) || ts_demux_packets(d) < 0 ||
        ts_demux_resyncs(d) < 0)
      std::exit(4);
    ts_demux_destroy(d);
    rounds_with_events += events > 0;
  }
  return rounds_with_events;
}

}  // namespace

int main(int argc, char** argv) {
  if (argc < 3) {
    std::fprintf(stderr, "usage: %s video.es audio.mp2 [stream.ts]\n",
                 argv[0]);
    return 2;
  }
  std::vector<uint8_t> ves = slurp(argv[1]);
  std::vector<uint8_t> aes = slurp(argv[2]);

  // the packed wire at the JAX driver's width and at the main path's
  // (BATCH_FRAMES = 32 on 8 threads: writes of 16 KB bring the 40-frame
  // fixture's batches over 8 pictures; phase timing on), then the sparse
  // and dense wires
  int packed8 = batches(ves, packed_batch, 8, 4, 1000);
  int packed32 = batches(ves, packed_batch, 32, 8, 16384, true);
  int sparse = batches(ves, sparse_batch, 8, 4, 1500);
  int dense = batches(ves, dense_batch, 8, 4, 1500);
  int serial, iframes;
  serial_and_seek(ves, &serial, &iframes);
  int audio = mp2(aes);
  long long ts_rounds = argc > 3 ? ts(slurp(argv[3])) : 0;

  // the host canary at a tiny size
  std::vector<uint8_t> src(1 << 16, 1), dst(1 << 16, 0);
  uint64_t x = host_canary_cpu(1000);
  host_canary_mem(dst.data(), src.data(), (int64_t)src.size(), 2);
  if (!x || dst[12345] != 1) return 4;

  std::printf("sanitize OK: packed_f8=%d packed_f32=%d sparse=%d dense=%d "
              "serial=%d iframes=%d audio=%d ts_rounds_with_events=%lld\n",
              packed8, packed32, sparse, dense, serial, iframes, audio,
              ts_rounds);
  return 0;
}

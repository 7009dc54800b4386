// MP2 (MPEG-1 Audio Layer II) host decoder: frame parse + dequant +
// bit-exact polyphase synthesis.
//
// C++ twin of jsmpeg_tpu/host/mp2_parse.py + ops/mp2_synth.synthesize_exact
// (same contract, same semantics; behaviour being reproduced:
// jsmpeg/src/mp2.js:77-484).  Bit-exactness requires replaying the
// reference's float op DAG: the 32->64 matrixing runs in double (JS
// numbers) with results rounded to float on store into the V ring, and the
// 512-tap windowing accumulates into int32 with a ToInt32 truncation after
// every multiply-accumulate step.
//
// Exposed as a C ABI consumed via ctypes; output arrays are caller-
// allocated numpy buffers (zero copy).  Built into libjsmpeg_host.so by
// build_native.py.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#include "bitview.h"
#include "vlc_tables.h"

namespace {

constexpr int MODE_JOINT_STEREO = 1;
constexpr int MODE_MONO = 3;

// JS ToInt32: truncate toward zero, wrap mod 2^32
static inline int32_t to_i32(double x) {
  double t = std::trunc(x);
  if (t >= 9223372036854775808.0 || t <= -9223372036854775808.0 ||
      t != t)
    t = std::fmod(t, 4294967296.0);
  return (int32_t)(uint32_t)(uint64_t)(int64_t)t;
}

// 32-point matrixing: the kjmp2 Lee-style factorization with the exact op
// order of the reference (src/mp2.js:346-484); double throughout, caller
// rounds to float on store.
static void dct32(const double* s, double* d) {
  double t01 = s[0] + s[31], t02 = (s[0] - s[31]) * 0.500602998235;
  double t03 = s[1] + s[30], t04 = (s[1] - s[30]) * 0.505470959898;
  double t05 = s[2] + s[29], t06 = (s[2] - s[29]) * 0.515447309923;
  double t07 = s[3] + s[28], t08 = (s[3] - s[28]) * 0.53104259109;
  double t09 = s[4] + s[27], t10 = (s[4] - s[27]) * 0.553103896034;
  double t11 = s[5] + s[26], t12 = (s[5] - s[26]) * 0.582934968206;
  double t13 = s[6] + s[25], t14 = (s[6] - s[25]) * 0.622504123036;
  double t15 = s[7] + s[24], t16 = (s[7] - s[24]) * 0.674808341455;
  double t17 = s[8] + s[23], t18 = (s[8] - s[23]) * 0.744536271002;
  double t19 = s[9] + s[22], t20 = (s[9] - s[22]) * 0.839349645416;
  double t21 = s[10] + s[21], t22 = (s[10] - s[21]) * 0.972568237862;
  double t23 = s[11] + s[20], t24 = (s[11] - s[20]) * 1.16943993343;
  double t25 = s[12] + s[19], t26 = (s[12] - s[19]) * 1.48416461631;
  double t27 = s[13] + s[18], t28 = (s[13] - s[18]) * 2.05778100995;
  double t29 = s[14] + s[17], t30 = (s[14] - s[17]) * 3.40760841847;
  double t31 = s[15] + s[16], t32 = (s[15] - s[16]) * 10.1900081235;
  double t33 = t01 + t31; t31 = (t01 - t31) * 0.502419286188;
  t01 = t03 + t29; t29 = (t03 - t29) * 0.52249861494;
  t03 = t05 + t27; t27 = (t05 - t27) * 0.566944034816;
  t05 = t07 + t25; t25 = (t07 - t25) * 0.64682178336;
  t07 = t09 + t23; t23 = (t09 - t23) * 0.788154623451;
  t09 = t11 + t21; t21 = (t11 - t21) * 1.06067768599;
  t11 = t13 + t19; t19 = (t13 - t19) * 1.72244709824;
  t13 = t15 + t17; t17 = (t15 - t17) * 5.10114861869;
  t15 = t33 + t13; t13 = (t33 - t13) * 0.509795579104;
  t33 = t01 + t11; t01 = (t01 - t11) * 0.601344886935;
  t11 = t03 + t09; t09 = (t03 - t09) * 0.899976223136;
  t03 = t05 + t07; t07 = (t05 - t07) * 2.56291544774;
  t05 = t15 + t03; t15 = (t15 - t03) * 0.541196100146;
  t03 = t33 + t11; t11 = (t33 - t11) * 1.30656296488;
  t33 = t05 + t03; t05 = (t05 - t03) * 0.707106781187;
  t03 = t15 + t11; t15 = (t15 - t11) * 0.707106781187;
  t03 = t03 + t15;
  t11 = t13 + t07; t13 = (t13 - t07) * 0.541196100146;
  t07 = t01 + t09; t09 = (t01 - t09) * 1.30656296488;
  t01 = t11 + t07; t07 = (t11 - t07) * 0.707106781187;
  t11 = t13 + t09; t13 = (t13 - t09) * 0.707106781187;
  t11 = t11 + t13; t01 = t01 + t11;
  t11 = t11 + t07; t07 = t07 + t13;
  t09 = t31 + t17; t31 = (t31 - t17) * 0.509795579104;
  t17 = t29 + t19; t29 = (t29 - t19) * 0.601344886935;
  t19 = t27 + t21; t21 = (t27 - t21) * 0.899976223136;
  t27 = t25 + t23; t23 = (t25 - t23) * 2.56291544774;
  t25 = t09 + t27; t09 = (t09 - t27) * 0.541196100146;
  t27 = t17 + t19; t19 = (t17 - t19) * 1.30656296488;
  t17 = t25 + t27; t27 = (t25 - t27) * 0.707106781187;
  t25 = t09 + t19; t19 = (t09 - t19) * 0.707106781187;
  t25 = t25 + t19;
  t09 = t31 + t23; t31 = (t31 - t23) * 0.541196100146;
  t23 = t29 + t21; t21 = (t29 - t21) * 1.30656296488;
  t29 = t09 + t23; t23 = (t09 - t23) * 0.707106781187;
  t09 = t31 + t21; t31 = (t31 - t21) * 0.707106781187;
  t09 = t09 + t31; t29 = t29 + t09; t09 = t09 + t23; t23 = t23 + t31;
  t17 = t17 + t29; t29 = t29 + t25; t25 = t25 + t09; t09 = t09 + t27;
  t27 = t27 + t23; t23 = t23 + t19; t19 = t19 + t31;
  double u21 = t02 + t32; t02 = (t02 - t32) * 0.502419286188;
  t32 = t04 + t30; t04 = (t04 - t30) * 0.52249861494;
  t30 = t06 + t28; t28 = (t06 - t28) * 0.566944034816;
  t06 = t08 + t26; t08 = (t08 - t26) * 0.64682178336;
  t26 = t10 + t24; t10 = (t10 - t24) * 0.788154623451;
  t24 = t12 + t22; t22 = (t12 - t22) * 1.06067768599;
  t12 = t14 + t20; t20 = (t14 - t20) * 1.72244709824;
  t14 = t16 + t18; t16 = (t16 - t18) * 5.10114861869;
  t18 = u21 + t14; t14 = (u21 - t14) * 0.509795579104;
  u21 = t32 + t12; t32 = (t32 - t12) * 0.601344886935;
  t12 = t30 + t24; t24 = (t30 - t24) * 0.899976223136;
  t30 = t06 + t26; t26 = (t06 - t26) * 2.56291544774;
  t06 = t18 + t30; t18 = (t18 - t30) * 0.541196100146;
  t30 = u21 + t12; t12 = (u21 - t12) * 1.30656296488;
  u21 = t06 + t30; t30 = (t06 - t30) * 0.707106781187;
  t06 = t18 + t12; t12 = (t18 - t12) * 0.707106781187;
  t06 = t06 + t12;
  t18 = t14 + t26; t26 = (t14 - t26) * 0.541196100146;
  t14 = t32 + t24; t24 = (t32 - t24) * 1.30656296488;
  t32 = t18 + t14; t14 = (t18 - t14) * 0.707106781187;
  t18 = t26 + t24; t24 = (t26 - t24) * 0.707106781187;
  t18 = t18 + t24; t32 = t32 + t18;
  t18 = t18 + t14; t26 = t14 + t24;
  t14 = t02 + t16; t02 = (t02 - t16) * 0.509795579104;
  t16 = t04 + t20; t04 = (t04 - t20) * 0.601344886935;
  t20 = t28 + t22; t22 = (t28 - t22) * 0.899976223136;
  t28 = t08 + t10; t10 = (t08 - t10) * 2.56291544774;
  t08 = t14 + t28; t14 = (t14 - t28) * 0.541196100146;
  t28 = t16 + t20; t20 = (t16 - t20) * 1.30656296488;
  t16 = t08 + t28; t28 = (t08 - t28) * 0.707106781187;
  t08 = t14 + t20; t20 = (t14 - t20) * 0.707106781187;
  t08 = t08 + t20;
  t14 = t02 + t10; t02 = (t02 - t10) * 0.541196100146;
  t10 = t04 + t22; t22 = (t04 - t22) * 1.30656296488;
  t04 = t14 + t10; t10 = (t14 - t10) * 0.707106781187;
  t14 = t02 + t22; t02 = (t02 - t22) * 0.707106781187;
  t14 = t14 + t02; t04 = t04 + t14; t14 = t14 + t10; t10 = t10 + t02;
  t16 = t16 + t04; t04 = t04 + t08; t08 = t08 + t14; t14 = t14 + t28;
  t28 = t28 + t10; t10 = t10 + t20; t20 = t20 + t02; u21 = u21 + t16;
  t16 = t16 + t32; t32 = t32 + t04; t04 = t04 + t06; t06 = t06 + t08;
  t08 = t08 + t18; t18 = t18 + t14; t14 = t14 + t30; t30 = t30 + t28;
  t28 = t28 + t26; t26 = t26 + t10; t10 = t10 + t12; t12 = t12 + t20;
  t20 = t20 + t24; t24 = t24 + t02;

  d[48] = -t33;
  d[49] = d[47] = -u21;
  d[50] = d[46] = -t17;
  d[51] = d[45] = -t16;
  d[52] = d[44] = -t01;
  d[53] = d[43] = -t32;
  d[54] = d[42] = -t29;
  d[55] = d[41] = -t04;
  d[56] = d[40] = -t03;
  d[57] = d[39] = -t06;
  d[58] = d[38] = -t25;
  d[59] = d[37] = -t08;
  d[60] = d[36] = -t11;
  d[61] = d[35] = -t18;
  d[62] = d[34] = -t09;
  d[63] = d[33] = -t14;
  d[32] = -t05;
  d[0] = t05; d[31] = -t30;
  d[1] = t30; d[30] = -t27;
  d[2] = t27; d[29] = -t28;
  d[3] = t28; d[28] = -t07;
  d[4] = t07; d[27] = -t26;
  d[5] = t26; d[26] = -t23;
  d[6] = t23; d[25] = -t10;
  d[7] = t10; d[24] = -t15;
  d[8] = t15; d[23] = -t12;
  d[9] = t12; d[22] = -t19;
  d[10] = t19; d[21] = -t20;
  d[11] = t20; d[20] = -t13;
  d[12] = t13; d[19] = -t24;
  d[13] = t24; d[18] = -t31;
  d[14] = t31; d[17] = -t02;
  d[15] = t02; d[16] = 0.0;
}

struct QuantSpec {
  int32_t levels, group, bits;
};

// Owns the byte stream via ByteBuffer: its PAD contract covers the worst-
// case value-read overrun of a malformed frame body (~4.6 KB of
// allocation/scfsi/scale-factor/sample bits), so corrupt frames parse
// deterministic zeros instead of stale heap bytes.
struct MP2Decoder : ByteBuffer {
  int sample_rate = 44100;
  float V[2][1024] = {};
  int v_pos = 0;

  static void read_raw(BitView& b, const QuantSpec* q, int64_t* out) {
    if (!q) {
      out[0] = out[1] = out[2] = 0;
      return;
    }
    if (q->group) {
      int64_t val = b.read(q->bits);
      out[0] = val % q->levels;
      val /= q->levels;
      out[1] = val % q->levels;
      out[2] = val / q->levels;
    } else {
      out[0] = b.read(q->bits);
      out[1] = b.read(q->bits);
      out[2] = b.read(q->bits);
    }
  }

  static int64_t resolve_sf(int sf) {
    if (sf == 63) return 0;
    int shift = sf / 3;
    return ((int64_t)MP2_SCALEFACTOR_BASE[sf % 3] +
            ((1LL << shift) >> 1)) >> shift;
  }

  // Parse + dequantize one frame if fully buffered.  Fills samples
  // [36, 2, 32] int32 and returns the frame size in bytes (0 = no frame;
  // the bit index advances exactly frame_size bytes from the frame start,
  // matching the reference's frame-size-driven advance, src/mp2.js:54).
  int parse_frame(int32_t* samples) {
    int64_t pos = bit_index >> 3;
    if (pos >= byte_length) return 0;
    BitView b{buf.data(), byte_length, pos << 3};
    if (!b.has(48)) return 0;
    if (b.read(11) != 0x7FF) return 0;
    int version = b.read(2);
    int layer = b.read(2);
    bool has_crc = !b.read(1);
    if (version != 0x3 || layer != 0x2) return 0;
    int bitrate_index = (int)b.read(4) - 1;
    if (bitrate_index > 13 || bitrate_index < 0) return 0;
    int sample_rate_index = b.read(2);
    if (sample_rate_index == 3) return 0;
    int padding = b.read(1);
    b.read(1);
    int mode = b.read(2);
    int bound = 0;
    if (mode == MODE_JOINT_STEREO) {
      bound = ((int)b.read(2) + 1) << 2;
    } else {
      b.skip(2);
      bound = mode == MODE_MONO ? 0 : 32;
    }
    b.skip(4);
    if (has_crc) b.skip(16);

    int bitrate = MP2_BIT_RATE[bitrate_index];
    int srate = MP2_SAMPLE_RATE[sample_rate_index];
    int frame_size = 144000 * bitrate / srate + padding;
    if (byte_length - pos < frame_size) return 0;

    int tab1 = mode == MODE_MONO ? 0 : 1;
    int tab2 = MP2_Q1[tab1][bitrate_index];
    int tab3 = MP2_Q2[tab2][sample_rate_index];
    int sblimit = tab3 & 63;
    tab3 >>= 6;
    if (bound > sblimit) bound = sblimit;
    int channels = mode == MODE_MONO ? 1 : 2;

    auto read_allocation = [&](int sb) -> const QuantSpec* {
      int tab4 = MP2_Q3[tab3][sb];
      int qtab = MP2_Q4[tab4 & 15][b.read(tab4 >> 4)];
      return qtab ? (const QuantSpec*)MP2_QTAB[qtab - 1] : nullptr;
    };

    const QuantSpec* alloc[2][32] = {};
    for (int sb = 0; sb < bound; sb++) {
      alloc[0][sb] = read_allocation(sb);
      alloc[1][sb] = read_allocation(sb);
    }
    for (int sb = bound; sb < sblimit; sb++)
      alloc[0][sb] = alloc[1][sb] = read_allocation(sb);

    int scfsi[2][32] = {};
    for (int sb = 0; sb < sblimit; sb++) {
      for (int ch = 0; ch < channels; ch++)
        if (alloc[ch][sb]) scfsi[ch][sb] = b.read(2);
      if (mode == MODE_MONO) scfsi[1][sb] = scfsi[0][sb];
    }

    int64_t sf_res[2][32][3] = {};
    for (int sb = 0; sb < sblimit; sb++) {
      for (int ch = 0; ch < channels; ch++) {
        if (alloc[ch][sb]) {
          int raw[3];
          switch (scfsi[ch][sb]) {
            case 0:
              raw[0] = b.read(6); raw[1] = b.read(6); raw[2] = b.read(6);
              break;
            case 1:
              raw[0] = raw[1] = b.read(6); raw[2] = b.read(6);
              break;
            case 2:
              raw[0] = raw[1] = raw[2] = b.read(6);
              break;
            default:
              raw[0] = b.read(6); raw[1] = raw[2] = b.read(6);
              break;
          }
          for (int part = 0; part < 3; part++)
            sf_res[ch][sb][part] = resolve_sf(raw[part]);
        }
      }
      if (mode == MODE_MONO)
        for (int part = 0; part < 3; part++)
          sf_res[1][sb][part] = sf_res[0][sb][part];
    }

    std::memset(samples, 0, 36 * 2 * 32 * 4);
    // samples layout: [36, 2, 32] (sub-block, channel, subband)
    auto S = [samples](int g, int ch, int sb) -> int32_t& {
      return samples[(g * 2 + ch) * 32 + sb];
    };
    for (int part = 0; part < 3; part++) {
      for (int granule = 0; granule < 4; granule++) {
        int g = part * 4 + granule;
        int64_t raw[2][32][3] = {};
        for (int sb = 0; sb < bound; sb++) {
          read_raw(b, alloc[0][sb], raw[0][sb]);
          read_raw(b, alloc[1][sb], raw[1][sb]);
        }
        for (int sb = bound; sb < sblimit; sb++) {
          read_raw(b, alloc[0][sb], raw[0][sb]);
          raw[1][sb][0] = raw[0][sb][0];
          raw[1][sb][1] = raw[0][sb][1];
          raw[1][sb][2] = raw[0][sb][2];
        }
        // dequantize (exact int math).  For shared bands (sb >= bound)
        // the reference copies channel 0's POST-multiplied samples to
        // channel 1 -- channel 1's scale factor is read from the stream
        // but unused (src/mp2.js:224-229).
        for (int ch = 0; ch < 2; ch++) {
          for (int sb = 0; sb < sblimit; sb++) {
            const QuantSpec* q = alloc[ch][sb];
            if (!q) continue;
            if (ch == 1 && sb >= bound) {
              for (int k = 0; k < 3; k++)
                S(g * 3 + k, 1, sb) = S(g * 3 + k, 0, sb);
              continue;
            }
            int64_t sf = sf_res[ch][sb][part];
            int64_t scale = 65536 / (q->levels + 1);
            int64_t adj = ((q->levels + 1) >> 1) - 1;
            for (int k = 0; k < 3; k++) {
              int64_t val = (adj - raw[ch][sb][k]) * scale;
              S(g * 3 + k, ch, sb) = (int32_t)(
                  (val * (sf >> 12) +
                   ((val * (sf & 4095) + 2048) >> 12)) >> 12);
            }
          }
        }
      }
    }
    bit_index = (pos + frame_size) << 3;
    sample_rate = srate;
    return frame_size;
  }

  // Bit-exact synthesis of [n_sub, 2, 32] int32 samples into interleaved
  // per-channel PCM (n_sub*32 floats each); mirrors synthesize_exact.
  void synthesize(const int32_t* samples, int n_sub, float* left,
                  float* right) {
    for (int t = 0; t < n_sub; t++) {
      v_pos = (v_pos - 64) & 1023;
      for (int ch = 0; ch < 2; ch++) {
        double s[32], d[64];
        for (int i = 0; i < 32; i++)
          s[i] = (double)samples[(t * 2 + ch) * 32 + i];
        dct32(s, d);
        for (int i = 0; i < 64; i++)
          V[ch][v_pos + i] = (float)d[i];
        // windowed accumulation (src/mp2.js:250-270): ToInt32 after every
        // multiply-accumulate
        int32_t U[32] = {};
        int di = 512 - (v_pos >> 1);
        int vi = (v_pos % 128) >> 1;
        while (vi < 1024) {
          for (int i = 0; i < 32; i++)
            U[i] = to_i32((double)U[i] +
                          (double)MP2_D[di++] * (double)V[ch][vi++]);
          vi += 128 - 32;
          di += 64 - 32;
        }
        vi = (128 - 32 + 1024) - vi;
        di -= (512 - 32);
        while (vi < 1024) {
          for (int i = 0; i < 32; i++)
            U[i] = to_i32((double)U[i] +
                          (double)MP2_D[di++] * (double)V[ch][vi++]);
          vi += 128 - 32;
          di += 64 - 32;
        }
        float* out = ch == 0 ? left : right;
        for (int i = 0; i < 32; i++)
          out[t * 32 + i] = (float)((double)U[i] / 2147418112.0);
      }
    }
  }
};

}  // namespace

extern "C" {

void* mp2_decoder_create() { return new MP2Decoder(); }
void mp2_decoder_destroy(void* p) { delete (MP2Decoder*)p; }

void mp2_decoder_write(void* p, const uint8_t* data, int64_t len) {
  ((MP2Decoder*)p)->append(data, len);
}

// parse-only contract (feeds the TPU synthesis path): samples [36, 2, 32]
// int32; returns frame_size bytes consumed, 0 if no complete frame
int mp2_decoder_parse_frame(void* p, int32_t* samples) {
  return ((MP2Decoder*)p)->parse_frame(samples);
}

// parse + bit-exact host synthesis: left/right are float[1152];
// returns frame_size, 0 if no complete frame
int mp2_decoder_decode(void* p, float* left, float* right) {
  MP2Decoder* d = (MP2Decoder*)p;
  int32_t samples[36 * 2 * 32];
  int r = d->parse_frame(samples);
  if (r) d->synthesize(samples, 36, left, right);
  return r;
}

// synthesis only (resume from externally parsed samples)
void mp2_decoder_synthesize(void* p, const int32_t* samples, int n_sub,
                            float* left, float* right) {
  ((MP2Decoder*)p)->synthesize(samples, n_sub, left, right);
}

int mp2_decoder_sample_rate(void* p) {
  return ((MP2Decoder*)p)->sample_rate;
}

int64_t mp2_decoder_bit_index(void* p) { return ((MP2Decoder*)p)->bit_index; }
void mp2_decoder_set_bit_index(void* p, int64_t idx) {
  ((MP2Decoder*)p)->bit_index = idx;
}
int64_t mp2_decoder_evict(void* p) { return ((MP2Decoder*)p)->evict(); }
int64_t mp2_decoder_byte_length(void* p) {
  return ((MP2Decoder*)p)->byte_length;
}

// V-ring state access (checkpoint/resume of the synthesis filter)
void mp2_decoder_get_state(void* p, float* v, int32_t* v_pos) {
  MP2Decoder* d = (MP2Decoder*)p;
  std::memcpy(v, d->V, sizeof(d->V));
  *v_pos = d->v_pos;
}
void mp2_decoder_set_state(void* p, const float* v, int32_t v_pos) {
  MP2Decoder* d = (MP2Decoder*)p;
  std::memcpy(d->V, v, sizeof(d->V));
  d->v_pos = v_pos;
}

}  // extern "C"

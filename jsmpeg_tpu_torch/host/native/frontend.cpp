// MPEG-1 video host frontend: bitstream walk + VLC parse -> dense tensors.
//
// C++ twin of jsmpeg_tpu_torch/host/mpeg1_parse.py (same contract, same
// semantics incl. the persistent block-data quirk; see that file and
// jsmpeg/src/mpeg1.js:78-457,698-811 for the behaviour being
// reproduced).  Exposed as a C ABI consumed via ctypes; output arrays are
// caller-allocated numpy buffers (zero copy).
//
// Two parse modes:
//  - serial frame-at-a-time, emitting PREMULTIPLIED DEQUANTIZED int32
//    coefficients (the always-exact path, incl. cross-block leaks of the
//    reference's partially-cleared coefficient scratch);
//  - threaded batch parse over pictures, emitting RAW int16 levels +
//    per-MB quantizer (device does dequant) -- pictures are
//    parse-independent (every predictor resets per slice), so a picture
//    per worker scales the host frontend across cores.  If the scratch-
//    leak quirk would cross block/picture boundaries the batch aborts and
//    the caller falls back to the serial path.
//
// Build: see build_native.py (g++ -O3 -shared -fPIC).

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#include "bitview.h"
#include "vlc_tables.h"

namespace {

constexpr int START_PICTURE = 0x00;
constexpr int START_SLICE_FIRST = 0x01;
constexpr int START_SLICE_LAST = 0xAF;
constexpr int START_USER_DATA = 0xB2;
constexpr int START_SEQUENCE = 0xB3;
constexpr int START_EXTENSION = 0xB5;
constexpr int START_SEQUENCE_END = 0xB7;
constexpr int START_GROUP = 0xB8;

constexpr int PIC_I = 1;
constexpr int PIC_P = 2;
constexpr int PIC_B = 3;

inline int32_t vlc(BitView& bits, const uint32_t* lut, int maxbits) {
  uint32_t enc = lut[bits.peek(maxbits)];
  int n = enc >> 24;
  if (n == 0) return INT32_MIN;
  bits.skip(n);
  return (int32_t)(enc & 0xFFFFFF) - 0x800000;
}

// L1-resident primary level over the 2^16-entry DCT-coefficient LUT (256 KB
// -- every lookup spills to L2; see L1d 48 KiB on the bench host).  Codes of
// <= DCT_PRIMARY_BITS bits (the overwhelming majority of coefficients, incl.
// EOB and the 6-bit escape prefix) resolve from a 4 KB table; longer codes
// fall through to the full table.
constexpr int DCT_PRIMARY_BITS = 10;
uint32_t DCT_PRIMARY[1 << DCT_PRIMARY_BITS];
const bool dct_primary_init = [] {
  for (int p = 0; p < (1 << DCT_PRIMARY_BITS); p++) {
    uint32_t enc =
        VLC_DCT_COEFF[p << (VLC_DCT_COEFF_BITS - DCT_PRIMARY_BITS)];
    int n = enc >> 24;
    DCT_PRIMARY[p] = (n != 0 && n <= DCT_PRIMARY_BITS) ? enc : 0;
  }
  return true;
}();

struct SeqInfo {
  int width = 0, height = 0, mb_w = 0, mb_h = 0, mb_size = 0;
  int frame_rate_code = 0;
  int32_t intra_q[64], non_intra_q[64];
};

// Output slabs for one picture.
struct FrameOut {
  int32_t* coef = nullptr;    // [n_mb, 6, 64]   (serial/exact mode)
  int16_t* levels = nullptr;  // [n_mb, 6, 64]   (batch/levels mode)
  uint8_t* qscale = nullptr;  // [n_mb]          (batch mode)
  uint8_t* coded = nullptr;   // [n_mb, 6]
  uint8_t* intra = nullptr;   // [n_mb]
  uint8_t* written = nullptr; // [n_mb]
  int32_t* mv = nullptr;      // [n_mb, 2]
  // sparse coefficient mode: (global index, value) pairs; index base is
  // added by the caller per picture
  int32_t* sp_idx = nullptr;
  int16_t* sp_val = nullptr;
  int64_t sp_cap = 0;
  int64_t sp_count = 0;       // filled by the parser
  int64_t sp_base = 0;        // frame offset in the batch-global index
  bool sp_overflow = false;
  // packed coefficient mode (~2 bytes/coefficient on the wire): sp_pos
  // replaces sp_idx; bit 7 = first pair of a coded block, bit 6 = slot-
  // advancing marker for a coded block with no nonzero level (the device
  // reconstructs global indices from the cbp bitmap + these flags).
  // Values ride as int8 (sp_v8); -128 is an escape sentinel whose real
  // int16 value goes to the sp_esc side stream (capped at sp_cap/8;
  // overflow falls back to the dense batch like a pair overflow).
  uint8_t* sp_pos = nullptr;
  int8_t* sp_v8 = nullptr;
  int16_t* sp_esc = nullptr;
  int64_t esc_cap = 0;
  int64_t esc_count = 0;
};

// Parses pictures; owns the per-slice/MB state and the persistent
// coefficient scratch (quirk emulation).
struct PictureParser {
  const SeqInfo* seq;
  BitView bits;
  int32_t block_data[64] = {0};
  int16_t raw_levels[64] = {0};
  // nonzero (position, value) list of the current block, recorded during
  // the VLC loop so sparse/packed emission never rescans all 64 slots.
  // Scan positions are unique within a block (n is strictly increasing),
  // and the device scatters pairs by position -- emission order within a
  // block is free.
  uint8_t nz_pos[64];
  int16_t nz_val[64];
  int nz = 0;
  bool bd_dirty = false;      // scratch holds stale non-DC values
  bool leaky = false;         // a stale value reached an emitted block
  bool dup_coded = false;     // a block coded twice (corrupted/duplicated
                              // slice data revisits a macroblock): the
                              // append-only pair wire cannot express it
                              // (slot advances would exceed cbp-derived
                              // ordinals and desync every later block),
                              // so batch modes fall back to serial
  bool error = false;
  int64_t quirk_leaks = 0;

  int pic_type = 0;
  bool full_pel = false;
  int fw_f = 0, fw_r_size = 0;
  int qscale = 0;
  bool slice_begin = false;
  int64_t mb_address = 0;
  int motion_h = 0, motion_v = 0, motion_h_prev = 0, motion_v_prev = 0;
  int32_t dc_y = 0, dc_cr = 0, dc_cb = 0;
  FrameOut out;

  // assumes bits positioned right AFTER the 00 00 01 00 picture start code
  bool decode_picture() {
    leaky = bd_dirty;   // stale data entering this picture
    bits.skip(10);
    pic_type = bits.read(3);
    bits.skip(16);
    if (pic_type <= 0 || pic_type >= PIC_B) return false;
    if (pic_type == PIC_P) {
      full_pel = bits.read(1);
      int f_code = bits.read(3);
      if (f_code == 0) return false;
      fw_r_size = f_code - 1;
      fw_f = 1 << fw_r_size;
    }

    int n_mb = seq->mb_size;
    if (out.coef) std::memset(out.coef, 0, (size_t)n_mb * 6 * 64 * 4);
    if (out.levels) std::memset(out.levels, 0, (size_t)n_mb * 6 * 64 * 2);
    if (out.qscale) std::memset(out.qscale, 0, (size_t)n_mb);
    std::memset(out.coded, 0, (size_t)n_mb * 6);
    std::memset(out.intra, 0, (size_t)n_mb);
    std::memset(out.written, 0, (size_t)n_mb);
    std::memset(out.mv, 0, (size_t)n_mb * 2 * 4);

    int code = bits.find_next_start_code();
    while (code == START_EXTENSION || code == START_USER_DATA)
      code = bits.find_next_start_code();
    while (code >= START_SLICE_FIRST && code <= START_SLICE_LAST) {
      decode_slice(code & 0xFF);
      code = bits.find_next_start_code();
    }
    if (code != -1) bits.rewind(32);
    return true;
  }

  void decode_slice(int slice) {
    slice_begin = true;
    mb_address = (int64_t)(slice - 1) * seq->mb_w - 1;
    motion_h = motion_h_prev = 0;
    motion_v = motion_v_prev = 0;
    dc_y = dc_cr = dc_cb = 128;
    qscale = bits.read(5);
    while (bits.read(1)) bits.skip(8);
    do {
      decode_macroblock();
      if (error) return;
    } while (!bits.next_bytes_are_start_code());
  }

  void decode_macroblock() {
    int64_t increment = 0;
    int32_t t = vlc(bits, VLC_MB_INCR, VLC_MB_INCR_BITS);
    while (t == 34) t = vlc(bits, VLC_MB_INCR, VLC_MB_INCR_BITS);
    while (t == 35) {
      increment += 33;
      t = vlc(bits, VLC_MB_INCR, VLC_MB_INCR_BITS);
    }
    if (t == INT32_MIN) { error = true; return; }
    increment += t;

    if (slice_begin) {
      slice_begin = false;
      mb_address += increment;
    } else {
      if (mb_address + increment >= seq->mb_size) return;
      if (increment > 1) {
        dc_y = dc_cr = dc_cb = 128;
        if (pic_type == PIC_P) {
          motion_h = motion_h_prev = 0;
          motion_v = motion_v_prev = 0;
        }
      }
      while (increment > 1) {
        mb_address++;
        if (mb_address >= 0 && mb_address < seq->mb_size) {
          out.written[mb_address] = 1;
          out.mv[mb_address * 2] = motion_h;
          out.mv[mb_address * 2 + 1] = motion_v;
        }
        increment--;
      }
      mb_address++;
    }
    int64_t addr = mb_address;
    bool in_range = addr >= 0 && addr < seq->mb_size;

    const uint32_t* type_lut;
    int type_bits;
    if (pic_type == PIC_I) { type_lut = VLC_MB_TYPE_I; type_bits = VLC_MB_TYPE_I_BITS; }
    else if (pic_type == PIC_P) { type_lut = VLC_MB_TYPE_P; type_bits = VLC_MB_TYPE_P_BITS; }
    else { type_lut = VLC_MB_TYPE_B; type_bits = VLC_MB_TYPE_B_BITS; }
    int32_t mb_type = vlc(bits, type_lut, type_bits);
    if (mb_type == INT32_MIN) { error = true; return; }
    bool intra = mb_type & 0x01;
    bool mot_fw = mb_type & 0x08;

    if (mb_type & 0x10) qscale = bits.read(5);

    if (intra) {
      motion_h = motion_h_prev = 0;
      motion_v = motion_v_prev = 0;
      if (in_range) out.intra[addr] = 1;
    } else {
      dc_y = dc_cr = dc_cb = 128;
      decode_motion_vectors(mot_fw);
      if (in_range) {
        out.written[addr] = 1;
        out.mv[addr * 2] = motion_h;
        out.mv[addr * 2 + 1] = motion_v;
      }
    }
    if (in_range && out.qscale) out.qscale[addr] = (uint8_t)qscale;

    int cbp;
    if (mb_type & 0x02) {
      cbp = vlc(bits, VLC_CBP, VLC_CBP_BITS);
      if (cbp == INT32_MIN) { error = true; return; }
    } else {
      cbp = intra ? 0x3F : 0;
    }

    for (int block = 0, mask = 0x20; block < 6; block++, mask >>= 1) {
      if (cbp & mask) {
        decode_block(block, intra, in_range ? addr : -1);
        if (error) return;
      }
    }
  }

  void decode_motion_vectors(bool mot_fw) {
    if (mot_fw) {
      for (int axis = 0; axis < 2; axis++) {
        int32_t code = vlc(bits, VLC_MOTION, VLC_MOTION_BITS);
        if (code == INT32_MIN) { error = true; return; }
        int32_t d;
        if (code != 0 && fw_f != 1) {
          int32_t r = bits.read(fw_r_size);
          d = (((code < 0 ? -code : code) - 1) << fw_r_size) + r + 1;
          if (code < 0) d = -d;
        } else {
          d = code;
        }
        int& prev = axis == 0 ? motion_h_prev : motion_v_prev;
        int& cur = axis == 0 ? motion_h : motion_v;
        prev += d;
        if (prev > (fw_f << 4) - 1) prev -= fw_f << 5;
        else if (prev < -(fw_f << 4)) prev += fw_f << 5;
        cur = prev;
        if (full_pel) cur *= 2;
      }
    } else if (pic_type == PIC_P) {
      motion_h = motion_h_prev = 0;
      motion_v = motion_v_prev = 0;
    }
  }

  void decode_block(int block, bool intra, int64_t addr) {
    int n = 0;
    const int32_t* quant;
    int first_pos = -1;   // position of the first (possibly only) coeff
    // batch modes consume only raw_levels (the device does dequant); the
    // serial exact path additionally needs the premultiplied dequantized
    // coefficients in block_data
    const bool emit_coef = out.coef != nullptr;
    nz = 0;

    if (intra) {
      int32_t predictor, dct_size;
      if (block < 4) {
        predictor = dc_y;
        dct_size = vlc(bits, VLC_DC_LUMA, VLC_DC_LUMA_BITS);
      } else {
        predictor = block == 4 ? dc_cr : dc_cb;
        dct_size = vlc(bits, VLC_DC_CHROMA, VLC_DC_CHROMA_BITS);
      }
      if (dct_size == INT32_MIN) { error = true; return; }
      if (dct_size > 0) {
        int32_t differential = bits.read(dct_size);
        if (differential & (1 << (dct_size - 1)))
          block_data[0] = predictor + differential;
        else
          block_data[0] = predictor + ((int32_t)(~0u << dct_size) | (differential + 1));
      } else {
        block_data[0] = predictor;
      }
      if (block < 4) dc_y = block_data[0];
      else if (block == 4) dc_cr = block_data[0];
      else dc_cb = block_data[0];
      raw_levels[0] = (int16_t)block_data[0];
      if (raw_levels[0] != 0) { nz_pos[nz] = 0; nz_val[nz++] = raw_levels[0]; }
      if (block_data[0] != (int32_t)raw_levels[0]) leaky = true;  // overflow
      if (emit_coef)
        block_data[0] = (int32_t)((uint32_t)block_data[0] << 8);
      quant = seq->intra_q;
      n = 1;
      first_pos = 0;
    } else {
      quant = seq->non_intra_q;
    }

    while (true) {
      // one 24-bit window per coefficient: VLC code (<= 16 bits), the
      // EOB/'11' discriminator bit, and the sign bit all come from the
      // same peek (the per-coefficient hot path)
      uint32_t win = bits.peek(24);
      uint32_t enc = DCT_PRIMARY[win >> (24 - DCT_PRIMARY_BITS)];
      if (enc == 0) enc = VLC_DCT_COEFF[win >> (24 - VLC_DCT_COEFF_BITS)];
      int nb = enc >> 24;
      if (nb == 0) { error = true; return; }
      int32_t packed = (int32_t)(enc & 0xFFFFFF) - 0x800000;
      int32_t run, level;
      if (packed == 0xFFFF) {                 // escape
        bits.skip(nb);
        run = bits.read(6);
        level = bits.read(8);
        if (level == 0) level = bits.read(8);
        else if (level == 128) level = (int32_t)bits.read(8) - 256;
        else if (level > 128) level -= 256;
        if (level == 0) leaky = true;  // escape-coded zero: device dequant
                                       // cannot reproduce oddify(0)=+1
      } else {
        int consume = nb;
        if (packed == 0x0001 && n > 0) {
          consume++;
          if (((win >> (24 - consume)) & 1) == 0) {   // end of block
            bits.skip(consume);
            break;
          }
        }
        run = packed >> 8;
        level = packed & 0xFF;
        if ((win >> (23 - consume)) & 1) level = -level;
        bits.skip(consume + 1);
      }
      bool first_coeff = (n == (intra ? 1 : 0));
      n += run;
      if (n > 63) { error = true; return; }
      int dez = ZIG_ZAG[n];
      if (first_coeff) first_pos = dez;
      n++;
      raw_levels[dez] = (int16_t)level;
      if (level != 0) { nz_pos[nz] = (uint8_t)dez; nz_val[nz++] = (int16_t)level; }
      if (emit_coef) {
        level *= 2;   // (x*2 == x<<1; shifting negatives is formally UB)
        if (!intra) level += level < 0 ? -1 : 1;
        level = (int32_t)((int64_t)level * qscale * quant[dez]) >> 4;
        if ((level & 1) == 0) level -= level > 0 ? 1 : -1;
        if (level > 2047) level = 2047;
        else if (level < -2048) level = -2048;
        block_data[dez] = level * PREMULTIPLIER[dez];
      }
    }

    if (addr >= 0) {
      uint8_t& c = out.coded[addr * 6 + block];
      if (c) dup_coded = true;
      c = 1;
    }

    auto emit_nz = [&]() {
      // emit the recorded nonzero pairs of this block (VLC scan order;
      // the device scatters by position, so within-block order is free)
      if (addr < 0) return;
      if (out.sp_pos) {
        // packed mode: every coded block advances the device-side slot
        // counter exactly once (bit 7), even when it has no nonzero level
        // (marker with bit 6: consumed as a slot advance, never scattered)
        uint8_t first = 0x80;
        for (int k = 0; k < nz; k++) {
          int16_t v = nz_val[k];
          if (out.sp_count >= out.sp_cap) { out.sp_overflow = true; return; }
          out.sp_pos[out.sp_count] = nz_pos[k] | first;
          if (v >= -127 && v <= 127) {
            out.sp_v8[out.sp_count] = (int8_t)v;
          } else {
            if (out.esc_count >= out.esc_cap) {
              out.sp_overflow = true;
              return;
            }
            out.sp_v8[out.sp_count] = -128;
            out.sp_esc[out.esc_count++] = v;
          }
          out.sp_count++;
          first = 0;
        }
        if (first) {
          if (out.sp_count >= out.sp_cap) { out.sp_overflow = true; return; }
          out.sp_pos[out.sp_count] = 0xC0;
          out.sp_v8[out.sp_count] = 0;
          out.sp_count++;
        }
        return;
      }
      if (!out.sp_idx) return;
      int64_t base = out.sp_base + (addr * 6 + block) * 64;
      for (int k = 0; k < nz; k++) {
        if (out.sp_count >= out.sp_cap) { out.sp_overflow = true; return; }
        out.sp_idx[out.sp_count] = (int32_t)(base + nz_pos[k]);
        out.sp_val[out.sp_count] = nz_val[k];
        out.sp_count++;
      }
    };

    if (n == 1) {
      // DC-only fast path.  The emitted block is a pure-DC block (IDCT-
      // identical to the reference's fill); any just-written run>0
      // coefficient stays stale in block_data (the quirk -- proven
      // unreachable: n==1 forces the coefficient to scan position 0).
      if (addr >= 0) {
        if (out.coef) out.coef[(addr * 6 + block) * 64] = block_data[0];
        if (first_pos == 0) {
          if (out.levels)
            out.levels[(addr * 6 + block) * 64] = raw_levels[0];
          emit_nz();   // n==1 forces the coefficient to slot 0, so the nz
                       // list is exactly {pos 0} or empty here
        }
        // first_pos != 0 (leak case): reference adds (0+128)>>8 == 0, so
        // an all-zero levels block is exact for THIS block.
      }
      if (first_pos != 0) {
        quirk_leaks++;
        bd_dirty = true;
        leaky = true;
      }
      block_data[0] = 0;
      raw_levels[0] = 0;
      if (first_pos > 0) raw_levels[first_pos] = 0;
    } else {
      if (bd_dirty) leaky = true;   // stale values flow into this block
      bd_dirty = false;
      if (addr >= 0) {
        if (out.coef)
          std::memcpy(out.coef + (addr * 6 + block) * 64, block_data, 64 * 4);
        if (out.levels)
          std::memcpy(out.levels + (addr * 6 + block) * 64, raw_levels,
                      64 * 2);
        emit_nz();
      }
      if (emit_coef)
        std::memset(block_data, 0, sizeof(block_data));
      else
        block_data[0] = 0;    // only the DC slot is written in batch mode
      // selective scratch clear: every nonzero write is in the nz list
      // (escape-zero levels write a zero, which needs no clearing)
      raw_levels[0] = 0;
      for (int k = 0; k < nz; k++) raw_levels[nz_pos[k]] = 0;
    }
  }
};

// ---------------------------------------------------------------------------
// Owning parser: buffer management, sequence header, picture discovery.
// ---------------------------------------------------------------------------

struct Parser : ByteBuffer {
  SeqInfo seq;
  bool has_seq = false;
  PictureParser serial;     // persistent state for the serial path
  int64_t frames_parsed = 0;
  int n_threads;

  Parser() {
    buf.resize(1 << 16, 0);
    serial.seq = &seq;
    unsigned hc = std::thread::hardware_concurrency();
    n_threads = hc ? (hc > 16 ? 16 : hc) : 4;
  }

  void write(const uint8_t* data, int64_t len) {
    append(data, len);
    if (!has_seq) try_sequence_header();
  }

  BitView view() const {
    return BitView{buf.data(), byte_length, bit_index};
  }

  void try_sequence_header() {
    BitView b = view();
    if (b.find_start_code(START_SEQUENCE) == -1) return;
    // decode the header only once all of it is buffered: jsmpeg (and
    // jsmpeg_tpu) decode a header split across writes from the zero pad
    // past the buffered bytes, e.g. a height of 0 from its first 6 bytes
    if (!sequence_header_buffered(b)) return;
    decode_sequence_header(b);
    bit_index = b.index;
  }

  // True when the sequence header after the start code at b.index is
  // buffered: 62 bits of fields, a flag, 512 bits of intra matrix if
  // set, a flag, 512 bits of non-intra matrix if set.
  bool sequence_header_buffered(BitView b) const {
    int64_t avail = byte_length * 8 - b.index;
    int64_t need = 63;
    if (avail < need) return false;
    b.skip(62);
    if (b.read(1)) {
      need += 512;
      b.skip(512);
    }
    need += 1;
    if (avail < need) return false;
    if (b.read(1)) need += 512;
    return avail >= need;
  }

  void decode_sequence_header(BitView& b) {
    seq.width = b.read(12);
    seq.height = b.read(12);
    b.skip(4);
    seq.frame_rate_code = b.read(4);
    b.skip(18 + 1 + 10 + 1);
    std::memcpy(seq.intra_q, DEFAULT_INTRA_Q, sizeof(seq.intra_q));
    std::memcpy(seq.non_intra_q, DEFAULT_NON_INTRA_Q, sizeof(seq.non_intra_q));
    if (b.read(1))
      for (int i = 0; i < 64; i++) seq.intra_q[ZIG_ZAG[i]] = b.read(8);
    if (b.read(1))
      for (int i = 0; i < 64; i++) seq.non_intra_q[ZIG_ZAG[i]] = b.read(8);
    seq.mb_w = (seq.width + 15) >> 4;
    seq.mb_h = (seq.height + 15) >> 4;
    seq.mb_size = seq.mb_w * seq.mb_h;
    has_seq = true;
  }

  bool picture_complete() const {
    int64_t i = (bit_index + 7) >> 3;
    const uint8_t* b = buf.data();
    bool seen_picture = false;
    for (; i + 3 < byte_length; i++) {
      if (b[i] == 0 && b[i + 1] == 0 && b[i + 2] == 1) {
        int c = b[i + 3];
        if (!seen_picture) {
          if (c == START_PICTURE) seen_picture = true;
        } else if (c == START_PICTURE || c == START_SEQUENCE ||
                   c == START_GROUP || c == START_SEQUENCE_END) {
          return true;
        }
        i += 3;
      }
    }
    return false;
  }

  // serial exact path (premultiplied coef contract)
  int parse_frame(bool eof, const FrameOut& dst) {
    if (!has_seq) return 0;
    serial.out = dst;
    while (true) {
      if (!eof && !picture_complete()) return 0;
      BitView b = view();
      if (b.find_start_code(START_PICTURE) == -1) return 0;
      serial.bits = b;
      serial.error = false;
      bool produced = serial.decode_picture();
      bit_index = serial.bits.index;
      if (produced) {
        frames_parsed++;
        return 1;
      }
      if (eof && ((byte_length << 3) - bit_index) < 32) return 0;
    }
  }

  // ------------------------------------------------------------- batch

  struct PicSpan {
    int64_t bit_pos;    // right after the picture start code
    int64_t end_byte;   // exclusive byte bound of the picture data
    int pic_type;
    bool emit;
  };

  // discover up to max_frames emitted pictures; returns consumed bit pos
  int64_t discover(bool eof, int max_frames, std::vector<PicSpan>& spans) {
    const uint8_t* b = buf.data();
    int64_t i = (bit_index + 7) >> 3;
    int64_t consumed = bit_index;
    int emitted = 0;
    int64_t pending = -1;   // byte pos of a picture start code being scanned
    PicSpan cur{};
    while (i + 3 < byte_length) {
      if (!(b[i] == 0 && b[i + 1] == 0 && b[i + 2] == 1)) { i++; continue; }
      int c = b[i + 3];
      bool boundary = (c == START_PICTURE || c == START_SEQUENCE ||
                       c == START_GROUP || c == START_SEQUENCE_END);
      if (pending >= 0 && boundary) {
        cur.end_byte = i;
        spans.push_back(cur);
        consumed = i << 3;
        if (cur.emit) {
          emitted++;
          if (emitted >= max_frames) { pending = -1; break; }
        }
        pending = -1;
      }
      if (c == START_PICTURE) {
        pending = i;
        cur = PicSpan{};
        cur.bit_pos = (i + 4) << 3;
        // classify: 10 bits temporal ref, 3 bits type
        BitView pv{buf.data(), byte_length, cur.bit_pos + 10};
        cur.pic_type = pv.read(3);
        cur.emit = cur.pic_type == PIC_I || cur.pic_type == PIC_P;
        if (cur.pic_type == PIC_P) {
          pv.skip(16 + 1);              // vbv_delay + full_pel
          if (pv.read(3) == 0) cur.emit = false;   // zero f_code
        }
      }
      i += 4;
    }
    if (pending >= 0 && eof) {
      cur.end_byte = byte_length;
      spans.push_back(cur);
      consumed = byte_length << 3;
    }
    return consumed;
  }

  // returns number of frames parsed; -1 => exactness fallback (serial),
  // -2 => malformed stream (serial), -3 => sparse overflow (dense batch)
  //
  // packed mode (run_len != nullptr): per-MB metadata goes out run-length
  // encoded over (flags, cbp, mv) tuples -- flags u8 =
  // qscale|intra<<5|written<<6, cbp u8 bit b = block b coded, mv int16
  // pairs, run lengths u16 never crossing a picture boundary (8 B/run;
  // skip-dominated P pictures collapse to a handful of runs).
  // Coefficients go out as (pos u8, val i8) pairs with slot flags (see
  // FrameOut::sp_pos) plus an int16 escape side stream for |val| > 127.
  // sp_counts needs max_frames+2 slots (total pairs, total coded blocks);
  // run_counts and esc_counts need max_frames+1 (totals last).
  int parse_batch(bool eof, int max_frames, int64_t n_mb_stride,
                  int16_t* levels, uint8_t* qscale, uint8_t* coded,
                  uint8_t* intra, uint8_t* written, int32_t* mv,
                  uint8_t* pic_types, int32_t* sp_idx, int16_t* sp_val,
                  int64_t sp_cap_per_frame, int64_t* sp_counts,
                  uint16_t* run_len = nullptr, uint8_t* run_flags = nullptr,
                  uint8_t* run_cbp = nullptr, int16_t* run_mv = nullptr,
                  int64_t* run_counts = nullptr,
                  uint8_t* sp_pos = nullptr, int8_t* sp_v8 = nullptr,
                  int16_t* sp_esc = nullptr,
                  int64_t* esc_counts = nullptr) {
    if (!has_seq) return 0;
    // the serial scratch must be clean, else its state can't transfer
    if (serial.bd_dirty) return -1;
    std::vector<PicSpan> spans;
    int64_t consumed = discover(eof, max_frames, spans);
    if (spans.empty()) return 0;

    std::vector<const PicSpan*> emit;
    for (auto& s : spans)
      if (s.emit) emit.push_back(&s);
    int n = (int)emit.size();
    if (n == 0) {
      bit_index = consumed;
      return 0;
    }

    int workers = n_threads < n ? n_threads : n;
    std::atomic<int> next(0);
    std::atomic<bool> any_leak(false);
    std::atomic<bool> any_error(false);
    std::atomic<bool> any_overflow(false);
    std::atomic<int64_t> total_blocks(0);
    bool packed = run_len != nullptr;
    bool sparse = sp_idx != nullptr || packed;

    auto work = [&]() {
      PictureParser pp;
      pp.seq = &seq;
      // packed mode parses into thread-local slabs, then compresses the
      // per-MB metadata into the caller's wire buffers
      std::vector<uint8_t> q_s, c_s, i_s, w_s;
      std::vector<int32_t> mv_s;
      if (packed) {
        q_s.resize(n_mb_stride);
        c_s.resize(n_mb_stride * 6);
        i_s.resize(n_mb_stride);
        w_s.resize(n_mb_stride);
        mv_s.resize(n_mb_stride * 2);
      }
      while (true) {
        int k = next.fetch_add(1);
        if (k >= n) break;
        const PicSpan* s = emit[k];
        // fresh scratch per picture: valid unless the quirk leaks across
        // pictures, which we detect and reject below
        std::memset(pp.block_data, 0, sizeof(pp.block_data));
        std::memset(pp.raw_levels, 0, sizeof(pp.raw_levels));
        pp.bd_dirty = false;
        pp.leaky = false;
        pp.dup_coded = false;
        pp.error = false;
        pp.bits = BitView{buf.data(), s->end_byte, s->bit_pos};
        pp.out = FrameOut{};
        pp.out.levels = sparse ? nullptr
                               : levels + (int64_t)k * n_mb_stride * 6 * 64;
        if (packed) {
          pp.out.qscale = q_s.data();
          pp.out.coded = c_s.data();
          pp.out.intra = i_s.data();
          pp.out.written = w_s.data();
          pp.out.mv = mv_s.data();
          pp.out.sp_pos = sp_pos + (int64_t)k * sp_cap_per_frame;
          pp.out.sp_v8 = sp_v8 + (int64_t)k * sp_cap_per_frame;
          pp.out.sp_cap = sp_cap_per_frame;
          pp.out.sp_esc = sp_esc + (int64_t)k * (sp_cap_per_frame / 8);
          pp.out.esc_cap = sp_cap_per_frame / 8;
        } else {
          pp.out.qscale = qscale + (int64_t)k * n_mb_stride;
          pp.out.coded = coded + (int64_t)k * n_mb_stride * 6;
          pp.out.intra = intra + (int64_t)k * n_mb_stride;
          pp.out.written = written + (int64_t)k * n_mb_stride;
          pp.out.mv = mv + (int64_t)k * n_mb_stride * 2;
          if (sparse) {
            pp.out.sp_idx = sp_idx + (int64_t)k * sp_cap_per_frame;
            pp.out.sp_val = sp_val + (int64_t)k * sp_cap_per_frame;
            pp.out.sp_cap = sp_cap_per_frame;
            pp.out.sp_base = (int64_t)k * n_mb_stride * 6 * 64;
          }
        }
        bool produced = pp.decode_picture();
        pic_types[k] = (uint8_t)pp.pic_type;
        if (!produced) pic_types[k] = 0;     // shouldn't happen (classified)
        if (sparse) sp_counts[k] = pp.out.sp_count;
        if (packed) esc_counts[k] = pp.out.esc_count;
        if (packed) {
          // run-length encode the (flags, cbp, mv) tuple stream of this
          // picture into its run segment (worst case n_mb runs)
          uint16_t* rl = run_len + (int64_t)k * n_mb_stride;
          uint8_t* rf = run_flags + (int64_t)k * n_mb_stride;
          uint8_t* rc = run_cbp + (int64_t)k * n_mb_stride;
          int16_t* rm = run_mv + (int64_t)k * n_mb_stride * 2;
          int64_t blocks = 0;
          int64_t n_runs = 0;
          uint8_t pf = 0, pc = 0;
          int16_t ph = 0, pv = 0;
          for (int64_t m = 0; m < n_mb_stride; m++) {
            uint8_t f = (uint8_t)((q_s[m] & 31) | (i_s[m] ? 0x20 : 0) |
                                  (w_s[m] ? 0x40 : 0));
            uint8_t c = 0;
            for (int b = 0; b < 6; b++)
              if (c_s[m * 6 + b]) { c |= (uint8_t)(1 << b); blocks++; }
            int16_t mh = (int16_t)mv_s[m * 2];
            int16_t mvv = (int16_t)mv_s[m * 2 + 1];
            if (n_runs > 0 && f == pf && c == pc && mh == ph && mvv == pv &&
                rl[n_runs - 1] < 65535) {
              rl[n_runs - 1]++;
            } else {
              rl[n_runs] = 1;
              rf[n_runs] = f;
              rc[n_runs] = c;
              rm[n_runs * 2] = mh;
              rm[n_runs * 2 + 1] = mvv;
              pf = f; pc = c; ph = mh; pv = mvv;
              n_runs++;
            }
          }
          run_counts[k] = n_runs;
          total_blocks.fetch_add(blocks);
        }
        if (pp.leaky || pp.bd_dirty || pp.dup_coded) any_leak.store(true);
        if (pp.error) any_error.store(true);
        if (pp.out.sp_overflow) any_overflow.store(true);
      }
    };

    std::vector<std::thread> threads;
    for (int w = 0; w < workers - 1; w++) threads.emplace_back(work);
    work();
    for (auto& t : threads) t.join();

    if (any_leak.load()) return -1;   // caller re-runs via the serial path
    if (any_error.load()) return -2;  // malformed stream: serial fallback
    if (any_overflow.load()) return -3;  // caller re-runs via dense batch

    if (sparse) {
      // compact per-picture segments into a contiguous prefix
      int64_t total = sp_counts[0];
      int64_t esc_total = packed ? esc_counts[0] : 0;
      for (int k = 1; k < n; k++) {
        int64_t off = (int64_t)k * sp_cap_per_frame;
        if (packed) {
          std::memmove(sp_pos + total, sp_pos + off, sp_counts[k]);
          std::memmove(sp_v8 + total, sp_v8 + off, sp_counts[k]);
          std::memmove(sp_esc + esc_total,
                       sp_esc + (int64_t)k * (sp_cap_per_frame / 8),
                       esc_counts[k] * 2);
          esc_total += esc_counts[k];
        } else {
          std::memmove(sp_idx + total, sp_idx + off, sp_counts[k] * 4);
          std::memmove(sp_val + total, sp_val + off, sp_counts[k] * 2);
        }
        total += sp_counts[k];
      }
      sp_counts[max_frames] = total;   // caller-provided extra slot
      if (packed) {
        esc_counts[max_frames] = esc_total;
        sp_counts[max_frames + 1] = total_blocks.load();
        int64_t rtotal = run_counts[0];
        for (int k = 1; k < n; k++) {
          int64_t off = (int64_t)k * n_mb_stride;
          std::memmove(run_len + rtotal, run_len + off, run_counts[k] * 2);
          std::memmove(run_flags + rtotal, run_flags + off, run_counts[k]);
          std::memmove(run_cbp + rtotal, run_cbp + off, run_counts[k]);
          std::memmove(run_mv + rtotal * 2, run_mv + off * 2,
                       run_counts[k] * 4);
          rtotal += run_counts[k];
        }
        run_counts[max_frames] = rtotal;
      }
    }

    bit_index = consumed;
    frames_parsed += n;
    return n;
  }
};

}  // namespace

extern "C" {

void* mpeg1_parser_create() { return new Parser(); }
void mpeg1_parser_destroy(void* p) { delete (Parser*)p; }

void mpeg1_parser_write(void* p, const uint8_t* data, int64_t len) {
  ((Parser*)p)->write(data, len);
}

int mpeg1_parser_has_seq(void* p) { return ((Parser*)p)->has_seq ? 1 : 0; }

// info: [width, height, mb_w, mb_h, frame_rate_code]
void mpeg1_parser_seq_info(void* p, int32_t* info) {
  Parser* ps = (Parser*)p;
  info[0] = ps->seq.width;
  info[1] = ps->seq.height;
  info[2] = ps->seq.mb_w;
  info[3] = ps->seq.mb_h;
  info[4] = ps->seq.frame_rate_code;
}

void mpeg1_parser_quant(void* p, int32_t* intra_q, int32_t* non_intra_q) {
  Parser* ps = (Parser*)p;
  std::memcpy(intra_q, ps->seq.intra_q, sizeof(ps->seq.intra_q));
  std::memcpy(non_intra_q, ps->seq.non_intra_q, sizeof(ps->seq.non_intra_q));
}

int mpeg1_parser_parse_frame(void* p, int eof, int32_t* coef, uint8_t* coded,
                             uint8_t* intra, uint8_t* written, int32_t* mv,
                             int64_t* info_out) {
  Parser* ps = (Parser*)p;
  FrameOut out;
  out.coef = coef;
  out.coded = coded;
  out.intra = intra;
  out.written = written;
  out.mv = mv;
  int r = ps->parse_frame(eof != 0, out);
  info_out[0] = ps->serial.pic_type;
  info_out[1] = ps->serial.quirk_leaks;
  info_out[2] = ps->serial.error ? 1 : 0;
  return r;
}

int mpeg1_parser_parse_batch(void* p, int eof, int max_frames,
                             int16_t* levels, uint8_t* qscale, uint8_t* coded,
                             uint8_t* intra, uint8_t* written, int32_t* mv,
                             uint8_t* pic_types) {
  Parser* ps = (Parser*)p;
  return ps->parse_batch(eof != 0, max_frames, ps->seq.mb_size, levels,
                         qscale, coded, intra, written, mv, pic_types,
                         nullptr, nullptr, 0, nullptr);
}

// sparse coefficient variant: sp_counts must have max_frames+1 slots (the
// last receives the compacted total)
int mpeg1_parser_parse_batch_sparse(
    void* p, int eof, int max_frames, uint8_t* qscale, uint8_t* coded,
    uint8_t* intra, uint8_t* written, int32_t* mv, uint8_t* pic_types,
    int32_t* sp_idx, int16_t* sp_val, int64_t sp_cap_per_frame,
    int64_t* sp_counts) {
  Parser* ps = (Parser*)p;
  return ps->parse_batch(eof != 0, max_frames, ps->seq.mb_size, nullptr,
                         qscale, coded, intra, written, mv, pic_types,
                         sp_idx, sp_val, sp_cap_per_frame, sp_counts);
}

// packed-wire variant: 3 bytes/coefficient + run-length-encoded per-MB
// metadata (8 bytes/run).  Run arrays need max_frames*n_mb capacity;
// sp_counts max_frames+2 slots ([F] = compacted total pairs, [F+1] =
// total coded blocks); run_counts max_frames+1 ([F] = compacted total).
int mpeg1_parser_parse_batch_packed(
    void* p, int eof, int max_frames, uint16_t* run_len, uint8_t* run_flags,
    uint8_t* run_cbp, int16_t* run_mv, int64_t* run_counts,
    uint8_t* pic_types, uint8_t* sp_pos, int8_t* sp_v8, int16_t* sp_esc,
    int64_t sp_cap_per_frame, int64_t* sp_counts, int64_t* esc_counts) {
  Parser* ps = (Parser*)p;
  return ps->parse_batch(eof != 0, max_frames, ps->seq.mb_size, nullptr,
                         nullptr, nullptr, nullptr, nullptr, nullptr,
                         pic_types, nullptr, nullptr, sp_cap_per_frame,
                         sp_counts, run_len, run_flags, run_cbp, run_mv,
                         run_counts, sp_pos, sp_v8, sp_esc, esc_counts);
}

void mpeg1_parser_set_threads(void* p, int n) {
  ((Parser*)p)->n_threads = n < 1 ? 1 : n;
}

int64_t mpeg1_parser_bit_index(void* p) { return ((Parser*)p)->bit_index; }
void mpeg1_parser_set_bit_index(void* p, int64_t idx) {
  ((Parser*)p)->bit_index = idx;
}

int64_t mpeg1_parser_evict(void* p) {
  return ((Parser*)p)->evict();
}

// Advance bit_index to the next I-picture start code at or after the
// current position (clean GOP-aligned resume; the reference seeks to raw
// byte positions and decodes artifacts until the next I refresh,
// src/decoder.js:49-71 + src/mpeg1.js:51).  Returns 1 if found.
int mpeg1_parser_seek_iframe(void* p) {
  Parser* ps = (Parser*)p;
  BitView b = ps->view();
  while (true) {
    int code = b.find_next_start_code();
    if (code == -1) return 0;
    if (code != START_PICTURE) continue;
    BitView pv = b;
    pv.skip(10);
    if ((int)pv.read(3) == PIC_I) {
      // position on the byte holding the start code prefix
      ps->bit_index = b.index - 32;
      return 1;
    }
  }
}

int64_t mpeg1_parser_byte_length(void* p) {
  return ((Parser*)p)->byte_length;
}

int64_t mpeg1_parser_frames_parsed(void* p) {
  return ((Parser*)p)->frames_parsed;
}

// --------------------------------------------------------------------------
// Host-speed canary: fixed-work probes compiled with the same toolchain and
// flags as the parse stage, so bench captures on this shared box are
// comparable across rounds (a halved host_parse_fps with an unchanged canary
// is a real regression; halved together it is outside load).
// --------------------------------------------------------------------------

// Serial xorshift64 dependency chain: not vectorizable, measures
// single-core scalar integer throughput.  Returns the final state so the
// loop cannot be optimized away.
uint64_t host_canary_cpu(int64_t iters) {
  uint64_t x = 0x9E3779B97F4A7C15ull;
  for (int64_t i = 0; i < iters; i++) {
    x ^= x << 13;
    x ^= x >> 7;
    x ^= x << 17;
  }
  return x;
}

// Streaming copy over caller-provided buffers (sized to spill every cache
// level): measures effective memory bandwidth.
void host_canary_mem(uint8_t* dst, const uint8_t* src, int64_t len,
                     int reps) {
  for (int r = 0; r < reps; r++) {
    std::memcpy(dst, src, (size_t)len);
    // alternate direction so neither buffer stays resident in cache
    std::memcpy(const_cast<uint8_t*>(src), dst, (size_t)len);
  }
}

}  // extern "C"

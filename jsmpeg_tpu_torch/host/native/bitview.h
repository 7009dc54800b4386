// Non-owning MSB-first bit reader over a byte range (caller guarantees
// >= 8 bytes of readable padding past `len` -- the owning buffer provides
// it).  Shared by the MPEG1 and MP2 host frontends; semantics of the
// reference BitBuffer (jsmpeg/src/buffer.js:115-187).
#pragma once

#include <cstdint>
#include <cstring>
#include <vector>

// Growable append-only byte buffer owning the bytes a BitView walks.
//
// Padding contract: parsers read *values* (not structure) without bounds
// checks, so a malformed frame can legitimately walk a few KB past the
// valid bytes before a structural bound (start-code check, section count,
// error code) stops it.  PAD zeroed bytes always follow byte_length, so
// such reads are in-allocation and deterministic (they see zeros, exactly
// like the Python BitReader's zero-padded numpy buffer).
struct ByteBuffer {
  // upper bound on any parser's value-read overrun past the end of valid
  // data (MP2 worst case: allocation+scfsi+scale factors+sample bits of
  // one frame ~4.6 KB; MPEG1 block/VLC overruns are far smaller)
  static constexpr int64_t PAD = 8192;

  std::vector<uint8_t> buf;
  int64_t byte_length = 0;
  int64_t bit_index = 0;

  void append(const uint8_t* data, int64_t len) {
    if (byte_length + len + PAD > (int64_t)buf.size())
      buf.resize((byte_length + len + PAD) * 2, 0);
    std::memcpy(buf.data() + byte_length, data, len);
    byte_length += len;
    std::memset(buf.data() + byte_length, 0, PAD);
  }

  int64_t evict() {
    // Parsers legitimately leave bit_index a few bits PAST byte_length
    // (value reads run into the zero PAD, e.g. a sequence header split
    // across writes -- the padding contract above).  Clamp the evict
    // point to the valid bytes: without this the memmove length goes
    // negative and wraps to ~2^64, trampling the heap (found by the
    // round-5 fuzz soak: truncated header + evict_consumed).
    int64_t pos = bit_index >> 3;
    if (pos > byte_length) pos = byte_length;
    if (pos <= 0) return 0;
    std::memmove(buf.data(), buf.data() + pos, byte_length - pos);
    byte_length -= pos;
    bit_index -= pos << 3;
    std::memset(buf.data() + byte_length, 0, PAD);
    return pos;
  }
};

struct BitView {
  const uint8_t* data = nullptr;
  int64_t len = 0;       // valid bytes
  int64_t index = 0;     // bit position

  // one unaligned 64-bit load + byte swap per peek (the owning buffer
  // pads >= 8 readable bytes past len); supports count <= 57
  static inline uint64_t load_be64(const uint8_t* p) {
    uint64_t w;
    std::memcpy(&w, p, 8);
#if defined(__clang__) || defined(__GNUC__)
    return __builtin_bswap64(w);
#else
    return ((w & 0xFFull) << 56) | ((w & 0xFF00ull) << 40) |
           ((w & 0xFF0000ull) << 24) | ((w & 0xFF000000ull) << 8) |
           ((w >> 8) & 0xFF000000ull) | ((w >> 24) & 0xFF0000ull) |
           ((w >> 40) & 0xFF00ull) | (w >> 56);
#endif
  }

  inline uint32_t peek(int count) const {
    uint64_t w = load_be64(data + (index >> 3));
    return (uint32_t)((w << (index & 7)) >> (64 - count));
  }

  inline uint32_t read(int count) {
    uint32_t v = peek(count);
    index += count;
    return v;
  }

  inline void skip(int64_t count) { index += count; }
  inline void rewind(int64_t count) {
    index = index >= count ? index - count : 0;
  }
  bool has(int64_t count) const { return (len << 3) - index >= count; }

  int find_next_start_code() {
    int64_t i = (index + 7) >> 3;
    const uint8_t* b = data;
    while (i < len) {
      if (b[i] == 0 && b[i + 1] == 0 && b[i + 2] == 1) {
        index = (i + 4) << 3;
        return (i + 3 < len) ? b[i + 3] : 0;
      }
      i++;
    }
    index = len << 3;
    return -1;
  }

  int find_start_code(int code) {
    while (true) {
      int c = find_next_start_code();
      if (c == code || c == -1) return c;
    }
  }

  bool next_bytes_are_start_code() const {
    int64_t i = (index + 7) >> 3;
    if (i >= len) return true;
    return data[i] == 0 && data[i + 1] == 0 && data[i + 2] == 1;
  }
};

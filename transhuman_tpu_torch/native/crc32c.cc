// CRC32C (Castagnoli) for the TFRecord event writer (utils/tb_writer.py).
//
// The reference's tensorboardX depends on the `crc32c` wheel's C code for
// exactly this hot spot; image summary records are hundreds of KB and a
// per-byte Python loop costs tens of ms per add_image on a small host.
// A copy of the JAX package's transhuman_tpu/native/crc32c.cc.  native/build.py
// compiles it with -msse4.2 on x86-64, where it becomes the SSE4.2 CRC32
// instruction (~1 byte/cycle/lane, GBs/s); a compiler without SSE4.2 gets
// the slicing-by-8 software tables below.  ABI: one function,
// ctypes-friendly.

#include <cstddef>
#include <cstdint>

#if defined(__SSE4_2__)
#include <nmmintrin.h>
#endif

namespace {

#if defined(__SSE4_2__)
uint32_t crc_hw(uint32_t crc, const uint8_t* p, size_t n) {
  while (n >= 8) {
    uint64_t w;
    __builtin_memcpy(&w, p, 8);
    crc = static_cast<uint32_t>(_mm_crc32_u64(crc, w));
    p += 8;
    n -= 8;
  }
  while (n--) crc = _mm_crc32_u8(crc, *p++);
  return crc;
}
#else

struct Tables {
  uint32_t t[8][256];
  Tables() {
    const uint32_t poly = 0x82F63B78u;  // Castagnoli, reflected
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c & 1) ? (c >> 1) ^ poly : c >> 1;
      t[0][i] = c;
    }
    for (int k = 1; k < 8; ++k)
      for (uint32_t i = 0; i < 256; ++i)
        t[k][i] = t[0][t[k - 1][i] & 0xFF] ^ (t[k - 1][i] >> 8);
  }
};

uint32_t crc_hw(uint32_t crc, const uint8_t* p, size_t n) {
  static const Tables tb;
  while (n >= 8) {
    crc ^= static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[1]) << 8) |
           (static_cast<uint32_t>(p[2]) << 16) |
           (static_cast<uint32_t>(p[3]) << 24);
    crc = tb.t[7][crc & 0xFF] ^ tb.t[6][(crc >> 8) & 0xFF] ^
          tb.t[5][(crc >> 16) & 0xFF] ^ tb.t[4][crc >> 24] ^ tb.t[3][p[4]] ^
          tb.t[2][p[5]] ^ tb.t[1][p[6]] ^ tb.t[0][p[7]];
    p += 8;
    n -= 8;
  }
  while (n--) crc = tb.t[0][(crc ^ *p++) & 0xFF] ^ (crc >> 8);
  return crc;
}
#endif

}  // namespace

extern "C" uint32_t crc32c_raw(const uint8_t* data, size_t n) {
  return crc_hw(0xFFFFFFFFu, data, n) ^ 0xFFFFFFFFu;
}

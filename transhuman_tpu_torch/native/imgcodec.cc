// Host image codec of the PyTorch port: a Huffman JPEG decoder, a baseline
// JPEG encoder, the PNG row unfilter and the byte-serial decoders of the
// other frame formats (BMP RLE4/RLE8, TIFF PackBits and LZW, GIF, Radiance
// HDR; WebP is webp.cc's), behind a plain C ABI (ctypes).
//
// The JPEG decoder covers sequential (SOF0/SOF1) and progressive (SOF2)
// Huffman coding: 8-bit samples, 1, 3 or 4 components, any sampling
// factors, restart intervals, Huffman tables redefined between scans.  It
// reproduces libjpeg-turbo's default decode (3.x), what OpenCV's imread
// returns:
//   * progressive scans (jdphuff.c: DC and AC first and refinement scans,
//     end-of-band runs) into a whole-image coefficient buffer (jdcoefct.c),
//     and the block smoothing of decompress_smooth_data when the scans leave
//     one of the first 9 AC coefficients imprecise (a truncated file);
//   * the ISLOW integer IDCT (jidctint.c: CONST_BITS 13, PASS1_BITS 2) and
//     its range-limit table;
//   * fancy upsampling (jdsample.c: h2v1, h2v2 and h1v2 triangle filters
//     with their biases, edge rows and columns replicated at the
//     component's downsampled size), box replication otherwise;
//   * the fixed-point YCbCr -> RGB tables of jdcolor.c, YCCK -> CMYK, and
//     OpenCV's CMYK -> BGR (grfmt_jpeg.cpp, icvCvt_CMYK2BGR_8u_C4C3R);
//   * the EXIF orientation (APP1), applied as imread applies it.
// Lossless, hierarchical and arithmetic coding and 12-bit samples are
// refused with a message naming the marker.
//
// Every entry returns 0 on success or a non-zero code, with a message in
// the caller's buffer.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Error {
  int code;
  std::string msg;
};

[[noreturn]] void fail(int code, const std::string& msg) {
  throw Error{code, msg};
}

constexpr int kErrFormat = 1;       // malformed or truncated header
constexpr int kErrUnsupported = 2;  // a coding or layout refused by name
constexpr int kErrArgs = 3;         // the caller's buffers do not match

const int kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

struct Huffman {
  bool defined = false;
  // canonical code tables (JPEG Annex C / F.2.2.3)
  int32_t maxcode[18];
  int32_t valptr[17];
  int32_t mincode[17];
  uint8_t vals[256];
  // 9-bit lookahead: (length << 8) | value, 0 when the code is longer
  uint16_t look[512];
};

void build_huffman(Huffman& h, const uint8_t* counts, const uint8_t* vals,
                   int nvals) {
  memset(h.look, 0, sizeof(h.look));
  memcpy(h.vals, vals, nvals);
  int code = 0, k = 0;
  for (int len = 1; len <= 16; len++) {
    h.valptr[len] = k;
    h.mincode[len] = code;
    code += counts[len - 1];
    k += counts[len - 1];
    h.maxcode[len] = counts[len - 1] ? code - 1 : -1;
    if (code > (1 << len)) fail(kErrFormat, "bad Huffman table (DHT)");
    code <<= 1;
  }
  h.maxcode[17] = 0x7fffffff;
  // fill the lookahead table for codes of at most 9 bits
  k = 0;
  code = 0;
  for (int len = 1; len <= 9; len++) {
    for (int i = 0; i < counts[len - 1]; i++, k++) {
      int c = h.mincode[len] + i;
      int shift = 9 - len;
      for (int j = 0; j < (1 << shift); j++)
        h.look[(c << shift) | j] = (uint16_t)((len << 8) | vals[k]);
    }
  }
  h.defined = true;
}

struct Component {
  int id, h, v, tq;
  int td = 0, ta = 0;
  int width = 0, height = 0;      // downsampled size (ceil)
  int wib = 0, hib = 0;           // blocks across / down in the component
  int bw = 0, bh = 0;             // blocks across / down, MCU-padded
  std::vector<uint8_t> plane;     // bw*8 x bh*8 samples
  int dc_pred = 0;
  bool decoded = false;
  uint16_t q[64] = {};            // quantization table, latched at the
  bool q_latched = false;         // component's first scan (natural order)
  // progressive: bw x bh blocks of 64 coefficients (natural order), the
  // point transform of the last scan of each zigzag coefficient (-1: none
  // yet), libjpeg's coef_bits, and their values before the component's
  // last scan
  std::vector<int16_t> coef;
  int coef_bits[64];
  int prev_bits[64] = {};
  Component() { std::fill(coef_bits, coef_bits + 64, -1); }
};

struct BitReader {
  const uint8_t* data;
  size_t n;
  size_t pos;
  uint64_t buf = 0;
  int bits = 0;
  int real = 0;  // bits of buf read from the data, not padding
  bool hit_marker = false;
  // libjpeg's insufficient_data: a read went past the segment's data (the
  // rest of that MCU decodes zero bits; the segment's later MCUs are
  // skipped)
  bool insufficient = false;

  void fill() {
    while (bits <= 56) {
      uint32_t byte = 0;
      if (!hit_marker && pos < n) {
        byte = data[pos];
        if (byte == 0xFF) {
          uint8_t next = pos + 1 < n ? data[pos + 1] : 0xD9;
          if (next == 0x00) {
            pos += 2;
          } else {
            // a marker ends the entropy-coded segment: zeros after it
            hit_marker = true;
            byte = 0;
          }
        } else {
          pos++;
        }
      } else {
        hit_marker = true;  // the data's end: libjpeg's source adds an EOI
      }
      if (!hit_marker) real += 8;
      buf |= (uint64_t)byte << (56 - bits);
      bits += 8;
    }
  }
  int peek(int k) {
    if (bits < k) fill();
    return (int)(buf >> (64 - k));
  }
  void skip(int k) {
    if (k > real) insufficient = true;
    real = k > real ? 0 : real - k;
    buf <<= k;
    bits -= k;
  }
  int get(int k) {
    if (k == 0) return 0;
    int v = peek(k);
    skip(k);
    return v;
  }
  // Byte-align and consume the expected restart marker, which starts a
  // new segment; at any other marker or the data's end the next segment
  // reads as empty (jdmarker.c's resync leaves that marker unread).
  void restart(int expect) {
    buf = 0;
    bits = real = 0;
    // skip to the marker (padding bits were 1s inside the last byte)
    while (pos + 1 < n && !(data[pos] == 0xFF && data[pos + 1] != 0x00 &&
                            data[pos + 1] != 0xFF))
      pos++;
    hit_marker = !(pos + 1 < n && data[pos + 1] == 0xD0 + expect);
    if (!hit_marker) {
      pos += 2;
      insufficient = false;
    }
  }
};

inline int decode_huff(BitReader& br, const Huffman& h) {
  int look = br.peek(9);
  int e = h.look[look];
  if (e) {
    br.skip(e >> 8);
    return e & 0xFF;
  }
  int len = 10;
  int code = br.peek(len);
  while (len <= 16 && code > h.maxcode[len]) {
    len++;
    code = br.peek(len);
  }
  if (len > 16) {
    br.skip(17);
    return 0;  // corrupt data: libjpeg warns and returns 0
  }
  br.skip(len);
  return h.vals[h.valptr[len] + code - h.mincode[len]];
}

inline int extend(int v, int t) {
  return v < (1 << (t - 1)) ? v - (1 << t) + 1 : v;
}

// ---------------------------------------------------------- ISLOW IDCT
constexpr int CONST_BITS = 13;
constexpr int PASS1_BITS = 2;
constexpr int64_t FIX_0_298631336 = 2446;
constexpr int64_t FIX_0_390180644 = 3196;
constexpr int64_t FIX_0_541196100 = 4433;
constexpr int64_t FIX_0_765366865 = 6270;
constexpr int64_t FIX_0_899976223 = 7373;
constexpr int64_t FIX_1_175875602 = 9633;
constexpr int64_t FIX_1_501321110 = 12299;
constexpr int64_t FIX_1_847759065 = 15137;
constexpr int64_t FIX_1_961570560 = 16069;
constexpr int64_t FIX_2_053119869 = 16819;
constexpr int64_t FIX_2_562915447 = 20995;
constexpr int64_t FIX_3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) {
  return (x + ((int64_t)1 << (n - 1))) >> n;
}

// the post-IDCT range limit of libjpeg-turbo's SIMD IDCT (what OpenCV's
// build runs): x + 128 saturated to 0..255.  jdmaster.c's table, which the
// C IDCT uses, wraps past +-512 instead; only corrupt or truncated data
// reaches there.
inline uint8_t idct_limit(int64_t x) {
  return (uint8_t)(x < -128 ? 0 : (x > 127 ? 255 : x + 128));
}

// coef in natural order, dequantised by q (natural order)
void idct_islow(const int16_t* coef, const uint16_t* q, uint8_t* out,
                int stride) {
  int64_t ws[64];
  for (int c = 0; c < 8; c++) {
    const int16_t* in = coef + c;
    const uint16_t* qp = q + c;
    int64_t* w = ws + c;
    if (in[8] == 0 && in[16] == 0 && in[24] == 0 && in[32] == 0 &&
        in[40] == 0 && in[48] == 0 && in[56] == 0) {
      int64_t dc = ((int64_t)in[0] * qp[0]) * (1 << PASS1_BITS);
      for (int k = 0; k < 8; k++) w[8 * k] = dc;
      continue;
    }
    int64_t z2 = (int64_t)in[16] * qp[16];
    int64_t z3 = (int64_t)in[48] * qp[48];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * (-FIX_1_847759065);
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = (int64_t)in[0] * qp[0];
    z3 = (int64_t)in[32] * qp[32];
    int64_t tmp0 = (z2 + z3) * (1 << CONST_BITS);
    int64_t tmp1 = (z2 - z3) * (1 << CONST_BITS);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = (int64_t)in[56] * qp[56];
    tmp1 = (int64_t)in[40] * qp[40];
    tmp2 = (int64_t)in[24] * qp[24];
    tmp3 = (int64_t)in[8] * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 = tmp0 * FIX_0_298631336;
    tmp1 = tmp1 * FIX_2_053119869;
    tmp2 = tmp2 * FIX_3_072711026;
    tmp3 = tmp3 * FIX_1_501321110;
    z1 = z1 * (-FIX_0_899976223);
    z2 = z2 * (-FIX_2_562915447);
    z3 = z3 * (-FIX_1_961570560);
    z4 = z4 * (-FIX_0_390180644);
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int s = CONST_BITS - PASS1_BITS;
    w[8 * 0] = descale(tmp10 + tmp3, s);
    w[8 * 7] = descale(tmp10 - tmp3, s);
    w[8 * 1] = descale(tmp11 + tmp2, s);
    w[8 * 6] = descale(tmp11 - tmp2, s);
    w[8 * 2] = descale(tmp12 + tmp1, s);
    w[8 * 5] = descale(tmp12 - tmp1, s);
    w[8 * 3] = descale(tmp13 + tmp0, s);
    w[8 * 4] = descale(tmp13 - tmp0, s);
  }
  for (int r = 0; r < 8; r++) {
    const int64_t* w = ws + 8 * r;
    uint8_t* o = out + (size_t)r * stride;
    const int s = CONST_BITS + PASS1_BITS + 3;
    if (w[1] == 0 && w[2] == 0 && w[3] == 0 && w[4] == 0 && w[5] == 0 &&
        w[6] == 0 && w[7] == 0) {
      uint8_t v = idct_limit(descale(w[0], PASS1_BITS + 3));
      for (int k = 0; k < 8; k++) o[k] = v;
      continue;
    }
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * (-FIX_1_847759065);
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = (w[0] + w[4]) * (1 << CONST_BITS);
    int64_t tmp1 = (w[0] - w[4]) * (1 << CONST_BITS);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 = tmp0 * FIX_0_298631336;
    tmp1 = tmp1 * FIX_2_053119869;
    tmp2 = tmp2 * FIX_3_072711026;
    tmp3 = tmp3 * FIX_1_501321110;
    z1 = z1 * (-FIX_0_899976223);
    z2 = z2 * (-FIX_2_562915447);
    z3 = z3 * (-FIX_1_961570560);
    z4 = z4 * (-FIX_0_390180644);
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    o[0] = idct_limit(descale(tmp10 + tmp3, s));
    o[7] = idct_limit(descale(tmp10 - tmp3, s));
    o[1] = idct_limit(descale(tmp11 + tmp2, s));
    o[6] = idct_limit(descale(tmp11 - tmp2, s));
    o[2] = idct_limit(descale(tmp12 + tmp1, s));
    o[5] = idct_limit(descale(tmp12 - tmp1, s));
    o[3] = idct_limit(descale(tmp13 + tmp0, s));
    o[4] = idct_limit(descale(tmp13 - tmp0, s));
  }
}

// ---------------------------------------------------------- the decoder
// natural-order index of zigzag position k; past 63 it is 63, as in
// libjpeg's padded jpeg_natural_order (corrupt runs land there)
inline int natural(int k) { return k < 64 ? kZigzag[k] : 63; }

// The IFD0 orientation tag (0x0112) of a TIFF block (an EXIF APP1 body
// after "Exif\0\0", or a PNG eXIf chunk): its value, read as 16 bits, or -1
// when the block has no valid TIFF header or no such tag.
int tiff_orientation(const uint8_t* t, size_t tl) {
  if (tl < 8) return -1;
  bool le;
  if (t[0] == 'I' && t[1] == 'I' && t[2] == 42 && t[3] == 0) le = true;
  else if (t[0] == 'M' && t[1] == 'M' && t[2] == 0 && t[3] == 42) le = false;
  else return -1;
  auto rd16 = [&](size_t o) -> int {
    if (o + 2 > tl) return -1;
    return le ? (t[o] | (t[o + 1] << 8)) : ((t[o] << 8) | t[o + 1]);
  };
  auto rd32 = [&](size_t o) -> int64_t {
    if (o + 4 > tl) return -1;
    return le ? ((int64_t)t[o] | ((int64_t)t[o + 1] << 8) |
                 ((int64_t)t[o + 2] << 16) | ((int64_t)t[o + 3] << 24))
              : (((int64_t)t[o] << 24) | ((int64_t)t[o + 1] << 16) |
                 ((int64_t)t[o + 2] << 8) | (int64_t)t[o + 3]);
  };
  int64_t ifd = rd32(4);
  if (ifd < 0) return -1;
  int count = rd16((size_t)ifd);
  for (int i = 0; i < count; i++) {
    size_t e = (size_t)ifd + 2 + 12 * (size_t)i;
    int tag = rd16(e);
    if (tag < 0) return -1;
    if (tag == 0x0112) return rd16(e + 8);
  }
  return -1;
}

// (height, width) of an h x w image after EXIF orientation o
inline void oriented_size(int o, int h, int w, int* oh, int* ow) {
  bool swap = o >= 5 && o <= 8;
  *oh = swap ? w : h;
  *ow = swap ? h : w;
}

// OpenCV's EXIF orientation of an (h, w, 3) image: flips for 2 and 4, 180
// degrees for 3, transposes for 5-8; any other value leaves it as it is.
void orient_rgb(const uint8_t* src, int h, int w, int o, uint8_t* dst) {
  int oh, ow;
  oriented_size(o, h, w, &oh, &ow);
  for (int y = 0; y < oh; y++) {
    uint8_t* d = dst + (size_t)y * ow * 3;
    for (int x = 0; x < ow; x++) {
      int sy, sx;
      switch (o) {
        case 2: sy = y; sx = w - 1 - x; break;
        case 3: sy = h - 1 - y; sx = w - 1 - x; break;
        case 4: sy = h - 1 - y; sx = x; break;
        case 5: sy = x; sx = y; break;
        case 6: sy = h - 1 - x; sx = y; break;
        case 7: sy = h - 1 - x; sx = w - 1 - y; break;
        case 8: sy = x; sx = w - 1 - y; break;
        default: sy = y; sx = x;
      }
      const uint8_t* s = src + ((size_t)sy * w + sx) * 3;
      d[3 * x] = s[0];
      d[3 * x + 1] = s[1];
      d[3 * x + 2] = s[2];
    }
  }
}

struct Jpeg {
  const uint8_t* data;
  size_t n;
  size_t pos = 0;
  int width = 0, height = 0, precision = 0;
  int sof = -1;
  bool progressive = false;
  int scans = 0;
  int hmax = 1, vmax = 1;
  int mcux = 0, mcuy = 0;
  int restart_interval = 0;
  bool jfif = false, adobe = false;
  int adobe_transform = -1;
  int orientation = 1;
  bool exif_seen = false;
  // the colour space libtiff sets (TIFF JPEG): 1 YCbCr -> RGB, 0 none;
  // -1 the file's own markers decide
  int force_ycc = -1;
  std::vector<Component> comps;
  uint16_t qt[4][64];  // natural order
  bool qt_defined[4] = {false, false, false, false};
  Huffman dc[4], ac[4];
  bool frame_done = false;
  // the iMCU row of the MCU in which a scan's data ran out (-1: none);
  // libjpeg smooths the rows after it (last_good_iMCU_row) as the scans
  // before that one left them
  int short_imcu = -1;

  Jpeg(const uint8_t* d, size_t len) : data(d), n(len) {}

  int u8() {
    if (pos >= n) fail(kErrFormat, "truncated JPEG header");
    return data[pos++];
  }
  int u16() {
    int a = u8();
    return (a << 8) | u8();
  }

  // APP1 "Exif\0\0" + TIFF: the first segment whose IFD0 holds the
  // orientation tag sets it, whatever its value (OpenCV's reading)
  void parse_exif(size_t start, size_t len) {
    if (exif_seen || len < 14 || memcmp(data + start, "Exif\0\0", 6) != 0)
      return;
    int v = tiff_orientation(data + start + 6, len - 6);
    if (v < 0) return;
    orientation = v;
    exif_seen = true;
  }

  // A tables-only stream (TIFF's JPEGTables: SOI, DQT and DHT segments,
  // EOI), read as libjpeg's jpeg_read_header reads one: its tables stay for
  // the next stream; the reset at that stream's SOI drops the rest.
  void read_tables() {
    if (n < 4 || data[0] != 0xFF || data[1] != 0xD8)
      fail(kErrFormat, "JPEG tables without an SOI marker");
    pos = 2;
    for (;;) {
      int b = u8();
      if (b != 0xFF) continue;
      int m = u8();
      while (m == 0xFF) m = u8();
      if (m == 0xD9) return;
      if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;
      int len = u16();
      if (len < 2 || pos + len - 2 > n)
        fail(kErrFormat, "truncated JPEG marker segment");
      size_t end = pos + len - 2;
      if (m == 0xC4) {
        read_dht(end);
      } else if (m == 0xDB) {
        read_dqt(end);
      } else if (m == 0xDA || (m >= 0xC0 && m <= 0xCF && m != 0xC4 &&
                               m != 0xC8 && m != 0xCC)) {
        fail(kErrFormat, "JPEG tables holding a frame or a scan");
      }
      pos = end;
    }
  }

  // The next stream (the image after a tables stream): SOI's reset.
  void next_stream(const uint8_t* d, size_t len) {
    data = d;
    n = len;
    pos = 0;
    restart_interval = 0;
    jfif = adobe = false;
    adobe_transform = -1;
  }

  // Markers up to the end of the image, decoding every scan; with
  // headers_only, up to the first scan (SOS), which is not read.  A
  // progressive image ends at EOI or at the end of the data once it has a
  // scan, as libjpeg's data sources end short data with a fake EOI.
  void read_headers(bool headers_only = false) {
    if (n < 4 || data[0] != 0xFF || data[1] != 0xD8)
      fail(kErrFormat, "not a JPEG file (no SOI marker)");
    pos = 2;
    for (;;) {
      if (pos + 1 >= n && progressive && scans > 0) {  // no marker fits
        frame_done = true;
        return;
      }
      int b = u8();
      if (b != 0xFF) continue;  // garbage between markers: skip, as libjpeg
      int m = u8();
      while (m == 0xFF) m = u8();
      if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;
      if (m == 0xD9) {
        if (progressive && scans > 0) {
          frame_done = true;
          return;
        }
        fail(kErrFormat, "JPEG ends (EOI) before a scan");
      }
      int len = u16();
      if (len < 2 || pos + len - 2 > n)
        fail(kErrFormat, "truncated JPEG marker segment");
      size_t seg = pos, end = pos + len - 2;
      if (m == 0xC0 || m == 0xC1 || m == 0xC2) {
        read_sof(m);
      } else if ((m >= 0xC3 && m <= 0xCF) && m != 0xC4 && m != 0xC8 &&
                 m != 0xCC) {
        char buf[128];
        const char* kind = m >= 0xC9 ? "arithmetic-coded"
                           : m == 0xC3 ? "lossless"
                                       : "hierarchical";
        snprintf(buf, sizeof buf,
                 "%s JPEG (SOF%d, marker 0xFF%02X) is not supported", kind,
                 m - 0xC0, m);
        fail(kErrUnsupported, buf);
      } else if (m == 0xCC) {
        fail(kErrUnsupported,
             "arithmetic-coded JPEG (DAC, marker 0xFFCC) is not supported");
      } else if (m == 0xC4) {
        read_dht(end);
      } else if (m == 0xDB) {
        read_dqt(end);
      } else if (m == 0xDD) {
        restart_interval = u16();
      } else if (m == 0xE0) {
        if (len >= 7 && memcmp(data + seg, "JFIF\0", 5) == 0) jfif = true;
      } else if (m == 0xE1) {
        if (scans == 0) parse_exif(seg, len - 2);
      } else if (m == 0xEE) {
        if (len >= 14 && memcmp(data + seg, "Adobe", 5) == 0) {
          adobe = true;
          adobe_transform = data[seg + 11];
        }
      } else if (m == 0xDA) {
        if (headers_only) {
          if (sof < 0)
            fail(kErrFormat, "JPEG scan (SOS) before the frame (SOF)");
          return;
        }
        pos = seg;
        read_sos();
        if (frame_done) return;
        continue;  // pos now after the scan's entropy data
      }
      pos = end;
    }
  }

  void read_sof(int m) {
    if (sof >= 0) fail(kErrFormat, "more than one frame (SOF) in a JPEG");
    sof = m - 0xC0;
    progressive = m == 0xC2;
    precision = u8();
    height = u16();
    width = u16();
    int nc = u8();
    if (precision != 8) {
      char buf[96];
      snprintf(buf, sizeof buf,
               "%d-bit JPEG samples (SOF%d) are not supported; only 8-bit",
               precision, sof);
      fail(kErrUnsupported, buf);
    }
    if (nc != 1 && nc != 3 && nc != 4) {
      char buf[64];
      snprintf(buf, sizeof buf, "%d-component JPEG (SOF) is not supported",
               nc);
      fail(kErrUnsupported, buf);
    }
    if (width <= 0 || height <= 0)
      fail(kErrFormat, "JPEG frame (SOF) has an empty or DNL-defined size");
    comps.resize(nc);
    for (auto& c : comps) {
      c.id = u8();
      int hv = u8();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = u8();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
        fail(kErrFormat, "bad JPEG component (SOF)");
      hmax = c.h > hmax ? c.h : hmax;
      vmax = c.v > vmax ? c.v : vmax;
    }
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (auto& c : comps) {
      c.width = (int)(((int64_t)width * c.h + hmax - 1) / hmax);
      c.height = (int)(((int64_t)height * c.v + vmax - 1) / vmax);
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      c.wib = (c.width + 7) / 8;
      c.hib = (c.height + 7) / 8;
    }
  }

  void alloc_planes() {
    for (auto& c : comps)
      if (c.plane.empty())
        c.plane.assign((size_t)c.bw * 8 * c.bh * 8, 0);
  }

  void read_dht(size_t end) {
    while (pos < end) {
      int tc = u8();
      int cls = tc >> 4, id = tc & 15;
      if (cls > 1 || id > 3) fail(kErrFormat, "bad Huffman table (DHT)");
      uint8_t counts[16];
      int total = 0;
      for (int i = 0; i < 16; i++) total += counts[i] = (uint8_t)u8();
      if (total > 256 || pos + total > end)
        fail(kErrFormat, "bad Huffman table (DHT)");
      build_huffman(cls ? ac[id] : dc[id], counts, data + pos, total);
      pos += total;
    }
  }

  void read_dqt(size_t end) {
    while (pos < end) {
      int pq = u8();
      int prec = pq >> 4, id = pq & 15;
      if (id > 3 || prec > 1) fail(kErrFormat, "bad quantization table (DQT)");
      for (int i = 0; i < 64; i++)
        qt[id][kZigzag[i]] = (uint16_t)(prec ? u16() : u8());
      qt_defined[id] = true;
    }
  }

  void read_sos() {
    if (sof < 0) fail(kErrFormat, "JPEG scan (SOS) before the frame (SOF)");
    int ns = u8();
    if (ns < 1 || ns > (int)comps.size())
      fail(kErrFormat, "bad JPEG scan (SOS)");
    std::vector<Component*> sc;
    int blocks = 0;
    for (int i = 0; i < ns; i++) {
      int id = u8(), t = u8();
      Component* found = nullptr;
      for (auto& c : comps)
        if (c.id == id) found = &c;
      if (!found) fail(kErrFormat, "JPEG scan (SOS) names no component");
      found->td = t >> 4;
      found->ta = t & 15;
      if (found->td > 3 || found->ta > 3)
        fail(kErrFormat, "bad Huffman table index (SOS)");
      sc.push_back(found);
      blocks += found->h * found->v;
    }
    if (ns > 1 && blocks > 10)  // libjpeg's D_MAX_BLOCKS_IN_MCU
      fail(kErrFormat, "sampling factors too large for an interleaved scan");
    int ss = u8(), se = u8(), ahal = u8();
    int ah = ahal >> 4, al = ahal & 15;
    if (progressive) {
      // jdphuff.c start_pass_phuff_decoder's checks
      bool bad = ss == 0 ? se != 0 : (ss > se || se > 63 || ns != 1);
      if ((ah != 0 && al != ah - 1) || al > 13) bad = true;
      if (bad) fail(kErrFormat, "bad progressive JPEG scan (SOS)");
    } else if (ss != 0 || se != 63 || ahal != 0) {
      fail(kErrFormat, "bad sequential JPEG scan (SOS spectral selection)");
    }
    for (auto* c : sc) {
      if (!qt_defined[c->tq])
        fail(kErrFormat,
             "JPEG component uses an undefined quantization table (DQT)");
      bool need_dc = !progressive || (ss == 0 && ah == 0);
      bool need_ac = !progressive || ss > 0;
      if ((need_dc && !dc[c->td].defined) || (need_ac && !ac[c->ta].defined))
        fail(kErrFormat, "JPEG scan uses an undefined Huffman table (DHT)");
      c->dc_pred = 0;
      if (!c->q_latched) {  // jdinput.c latch_quant_tables
        memcpy(c->q, qt[c->tq], sizeof c->q);
        c->q_latched = true;
      }
    }
    if (progressive) {
      for (auto* c : sc) {
        if (c->coef.empty()) c->coef.assign((size_t)c->bw * c->bh * 64, 0);
        // jdphuff.c start_pass_phuff_decoder
        for (int k = std::min(ss, 1); k <= std::max(se, 9); k++)
          c->prev_bits[k] = scans > 0 ? c->coef_bits[k] : 0;
        for (int k = ss; k <= se; k++) c->coef_bits[k] = al;
      }
      decode_progressive_scan(sc, ss, se, ah, al);
      scans++;
      return;
    }
    alloc_planes();
    decode_scan(sc);
    scans++;
    for (auto* c : sc) c->decoded = true;
    bool all = true;
    for (auto& c : comps) all = all && c.decoded;
    frame_done = all;
  }

  void decode_block(BitReader& br, Component& c, int bx, int by) {
    int16_t coef[64];
    memset(coef, 0, sizeof coef);
    int t = decode_huff(br, dc[c.td]);
    int diff = t ? extend(br.get(t), t) : 0;
    c.dc_pred += diff;
    coef[0] = (int16_t)c.dc_pred;
    const Huffman& h = ac[c.ta];
    for (int k = 1; k < 64;) {
      int rs = decode_huff(br, h);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        if (k > 63) break;
        coef[kZigzag[k]] = (int16_t)extend(br.get(s), s);
        k++;
      } else {
        if (r != 15) break;
        k += 16;
      }
    }
    int stride = c.bw * 8;
    idct_islow(coef, c.q, c.plane.data() + (size_t)by * 8 * stride +
                              (size_t)bx * 8, stride);
  }

  // The MCUs of a scan, in order: fn(component, block column, block row)
  // for each block, or skip(...) for each block of an MCU that starts once
  // the segment's data ran out; restart markers consumed and fn_restart()
  // called at each restart interval.  A scan of one component covers its
  // ceil(width / 8) x ceil(height / 8) blocks; an interleaved scan covers
  // the MCU-padded grid.
  template <class Block, class Skip, class Restart>
  void for_each_mcu(const std::vector<Component*>& sc, BitReader& br,
                    Block fn, Skip skip, Restart fn_restart) {
    int mcus, per_row;
    if (sc.size() == 1) {
      per_row = sc[0]->wib;
      mcus = per_row * sc[0]->hib;
    } else {
      per_row = mcux;
      mcus = mcux * mcuy;
    }
    int next_rst = 0;
    for (int m = 0; m < mcus; m++) {
      if (restart_interval && m > 0 && m % restart_interval == 0) {
        br.restart(next_rst);
        next_rst = (next_rst + 1) & 7;
        for (auto* c : sc) c->dc_pred = 0;
        fn_restart();
      }
      int mx = m % per_row, my = m / per_row;
      const bool skipped = br.insufficient;
      auto visit = [&](Component& c, int bx, int by) {
        if (skipped) skip(c, bx, by);
        else fn(c, bx, by);
      };
      if (sc.size() == 1) {
        visit(*sc[0], mx, my);
      } else {
        for (auto* c : sc)
          for (int v = 0; v < c->v; v++)
            for (int h = 0; h < c->h; h++)
              visit(*c, mx * c->h + h, my * c->v + v);
      }
      if (br.insufficient && short_imcu < 0)
        short_imcu = sc.size() == 1 ? my / sc[0]->v : my;
    }
    // continue after the scan: find the next marker
    pos = br.pos;
    while (pos + 1 < n && !(data[pos] == 0xFF && data[pos + 1] != 0x00 &&
                            !(data[pos + 1] >= 0xD0 && data[pos + 1] <= 0xD7)))
      pos++;
  }

  void decode_scan(const std::vector<Component*>& sc) {
    BitReader br{data, n, pos};
    for_each_mcu(
        sc, br,
        [&](Component& c, int bx, int by) { decode_block(br, c, bx, by); },
        [&](Component& c, int bx, int by) {  // zero coefficients: mid-grey
          const size_t stride = (size_t)c.bw * 8;
          for (int y = 0; y < 8; y++)
            memset(&c.plane[((size_t)by * 8 + y) * stride + (size_t)bx * 8],
                   128, 8);
        },
        [] {});
  }

  // ------------------------------------- progressive Huffman (jdphuff.c)
  // Each scan adds to the whole-image coefficient buffer (jdcoefct.c);
  // the blocks go through the IDCT once the last scan is in.
  void decode_progressive_scan(const std::vector<Component*>& sc, int ss,
                               int se, int ah, int al) {
    BitReader br{data, n, pos};
    int eobrun = 0;  // blocks left in an end-of-band run
    const int p1 = 1 << al, m1 = -(1 << al);
    auto refine = [&](int16_t& coef) {  // a correction bit of a nonzero
      if (br.get(1) && (coef & p1) == 0)
        coef = (int16_t)(coef >= 0 ? coef + p1 : coef + m1);
    };
    auto block = [&](Component& c, int bx, int by) {
      int16_t* blk = c.coef.data() + ((size_t)by * c.bw + bx) * 64;
      if (ss == 0) {  // DC: first scan or one refinement bit
        if (ah == 0) {
          int t = decode_huff(br, dc[c.td]);
          c.dc_pred += t ? extend(br.get(t), t) : 0;
          blk[0] = (int16_t)((unsigned)c.dc_pred << al);
        } else if (br.get(1)) {
          blk[0] = (int16_t)(blk[0] | p1);
        }
        return;
      }
      const Huffman& h = ac[c.ta];
      if (ah == 0) {  // decode_mcu_AC_first
        if (eobrun > 0) {
          eobrun--;
          return;
        }
        for (int k = ss; k <= se; k++) {
          int rs = decode_huff(br, h);
          int r = rs >> 4, s = rs & 15;
          if (s) {
            k += r;
            blk[natural(k)] = (int16_t)((unsigned)extend(br.get(s), s) << al);
          } else if (r == 15) {
            k += 15;
          } else {
            eobrun = 1 << r;
            if (r) eobrun += br.get(r);
            eobrun--;
            break;
          }
        }
        return;
      }
      // decode_mcu_AC_refine: correction bits go to coefficients already
      // nonzero; a run counts only the zero ones
      int k = ss;
      if (eobrun == 0) {
        for (; k <= se; k++) {
          int rs = decode_huff(br, h);
          int r = rs >> 4, s = rs & 15;
          if (s) {
            s = br.get(1) ? p1 : m1;
          } else if (r != 15) {
            eobrun = 1 << r;
            if (r) eobrun += br.get(r);
            break;
          }
          do {
            int16_t& coef = blk[natural(k)];
            if (coef != 0) {
              refine(coef);
            } else if (--r < 0) {
              break;
            }
            k++;
          } while (k <= se);
          if (s) blk[natural(k)] = (int16_t)s;
        }
      }
      if (eobrun > 0) {
        for (; k <= se; k++) {
          int16_t& coef = blk[natural(k)];
          if (coef != 0) refine(coef);
        }
        eobrun--;
      }
    };
    for_each_mcu(
        sc, br, block, [](Component&, int, int) {}, [&] { eobrun = 0; });
  }

  // ------------------------- the coefficient buffer's output (jdcoefct.c)
  // jdcoefct.c smoothing_ok: every component has its quantization table,
  // nonzero at DC and the first 9 AC positions, and some DC bits; some of
  // those 9 AC coefficients are not yet known to full precision.
  bool smoothing_ok() const {
    static const int pos[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
    bool useful = false;
    for (auto& c : comps) {
      if (!c.q_latched) return false;
      for (int p : pos)
        if (c.q[p] == 0) return false;
      if (c.coef_bits[0] < 0) return false;
      for (int k = 1; k < 10; k++) useful = useful || c.coef_bits[k] != 0;
    }
    return useful;
  }

  void output_coefficients() {
    alloc_planes();
    bool smooth = smoothing_ok();
    for (auto& c : comps) {
      if (c.coef.empty()) c.coef.assign((size_t)c.bw * c.bh * 64, 0);
      if (smooth) {
        smooth_component(c);
        continue;
      }
      const size_t stride = (size_t)c.bw * 8;
      for (int by = 0; by < c.hib; by++)
        for (int bx = 0; bx < c.wib; bx++)
          idct_islow(&c.coef[((size_t)by * c.bw + bx) * 64], c.q,
                     &c.plane[(size_t)by * 8 * stride + (size_t)bx * 8],
                     stride);
    }
  }

  // jdcoefct.c decompress_smooth_data (libjpeg-turbo 2.1 and later): the
  // first 9 AC coefficients that are still zero and not fully known are
  // estimated from the DC values of the block's 5 x 5 neighbourhood, and
  // when no AC coefficient has any data the DC too (a Gaussian-like
  // kernel).  Neighbour rows and columns are replicated at the edges as
  // libjpeg replicates them.
  void smooth_component(Component& c) {
    // smoothing_ok's latches: rows up to the one where the data ran out
    // take the coefficient bits of every scan, later rows those before each
    // component's last scan (libjpeg-turbo 2.1's incomplete-scan rule)
    int prev_latch[10];
    for (int k = 1; k < 10; k++)
      prev_latch[k] = scans > 1 ? c.prev_bits[k] : -1;
    const int* cb = c.coef_bits;
    bool change_dc = false;
    const int64_t Q00 = c.q[0], Q01 = c.q[1], Q10 = c.q[8], Q20 = c.q[16],
                  Q11 = c.q[9], Q02 = c.q[2], Q03 = c.q[3], Q12 = c.q[10],
                  Q21 = c.q[17], Q30 = c.q[24];
    auto predict = [](int64_t num, int64_t q, int al) -> int {
      bool neg = num < 0;
      int pred = (int)(((q << 7) + (neg ? -num : num)) / (q << 8));
      if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
      return neg ? -pred : pred;
    };
    const size_t stride = (size_t)c.bw * 8;
    const int last_imcu = mcuy - 1, last_col = c.wib - 1;
    auto row = [&](int r) {
      r = r < 0 ? 0 : (r >= c.bh ? c.bh - 1 : r);
      return &c.coef[(size_t)r * c.bw * 64];
    };
    for (int imcu = 0; imcu < mcuy; imcu++) {
      cb = short_imcu >= 0 && imcu > short_imcu ? prev_latch : c.coef_bits;
      change_dc = cb[1] == -1 && cb[2] == -1 && cb[3] == -1 && cb[4] == -1 &&
                  cb[5] == -1 && cb[6] == -1 && cb[7] == -1 && cb[8] == -1 &&
                  cb[9] == -1;
      int block_rows = c.v;
      if (imcu == last_imcu) {
        block_rows = c.hib % c.v;
        if (block_rows == 0) block_rows = c.v;
      }
      // libjpeg numbers the rows by this iMCU row's count of block rows,
      // so a short last iMCU row sees its neighbours as libjpeg does (a
      // dummy row of the MCU padding included)
      const int image_rows = block_rows * mcuy;
      for (int br = 0; br < block_rows; br++) {
        const int r = imcu * c.v + br, ir = imcu * block_rows + br;
        const int16_t* cur = row(r);
        const int16_t* prev = ir > 0 ? row(r - 1) : cur;
        const int16_t* prev2 = ir > 1 ? row(r - 2) : prev;
        const int16_t* next = ir < image_rows - 1 ? row(r + 1) : cur;
        const int16_t* next2 = ir < image_rows - 2 ? row(r + 2) : next;
        // DC01..DC25: the 5 x 5 neighbourhood, row by row (sliding)
        int d[26];
        for (int i = 1; i <= 5; i++) {
          d[i] = prev2[0];
          d[5 + i] = prev[0];
          d[10 + i] = cur[0];
          d[15 + i] = next[0];
          d[20 + i] = next2[0];
        }
        for (int b = 0; b < c.wib; b++) {
          int16_t ws[64];
          memcpy(ws, cur, sizeof ws);
          if (b == 0 && b < last_col) {
            d[4] = d[5] = prev2[64];
            d[9] = d[10] = prev[64];
            d[14] = d[15] = cur[64];
            d[19] = d[20] = next[64];
            d[24] = d[25] = next2[64];
          }
          if (b + 1 < last_col) {
            const size_t o = 2 * 64;
            d[5] = prev2[o];
            d[10] = prev[o];
            d[15] = cur[o];
            d[20] = next[o];
            d[25] = next2[o];
          }
          int al;
          if ((al = cb[1]) != 0 && ws[1] == 0) {
            int64_t num = Q00 * (change_dc
                ? (-d[1] - d[2] + d[4] + d[5] - 3 * d[6] + 13 * d[7] -
                   13 * d[9] + 3 * d[10] - 3 * d[11] + 38 * d[12] -
                   38 * d[14] + 3 * d[15] - 3 * d[16] + 13 * d[17] -
                   13 * d[19] + 3 * d[20] - d[21] - d[22] + d[24] + d[25])
                : (-7 * d[11] + 50 * d[12] - 50 * d[14] + 7 * d[15]));
            ws[1] = (int16_t)predict(num, Q01, al);
          }
          if ((al = cb[2]) != 0 && ws[8] == 0) {
            int64_t num = Q00 * (change_dc
                ? (-d[1] - 3 * d[2] - 3 * d[3] - 3 * d[4] - d[5] - d[6] +
                   13 * d[7] + 38 * d[8] + 13 * d[9] - d[10] + d[16] -
                   13 * d[17] - 38 * d[18] - 13 * d[19] + d[20] + d[21] +
                   3 * d[22] + 3 * d[23] + 3 * d[24] + d[25])
                : (-7 * d[3] + 50 * d[8] - 50 * d[18] + 7 * d[23]));
            ws[8] = (int16_t)predict(num, Q10, al);
          }
          if ((al = cb[3]) != 0 && ws[16] == 0) {
            int64_t num = Q00 * (change_dc
                ? (d[3] + 2 * d[7] + 7 * d[8] + 2 * d[9] - 5 * d[12] -
                   14 * d[13] - 5 * d[14] + 2 * d[17] + 7 * d[18] +
                   2 * d[19] + d[23])
                : (-d[3] + 13 * d[8] - 24 * d[13] + 13 * d[18] - d[23]));
            ws[16] = (int16_t)predict(num, Q20, al);
          }
          if ((al = cb[4]) != 0 && ws[9] == 0) {
            int64_t num = Q00 * (change_dc
                ? (-d[1] + d[5] + 9 * d[7] - 9 * d[9] - 9 * d[17] +
                   9 * d[19] + d[21] - d[25])
                : (d[10] + d[16] - 10 * d[17] + 10 * d[19] - d[2] - d[20] +
                   d[22] - d[24] + d[4] - d[6] + 10 * d[7] - 10 * d[9]));
            ws[9] = (int16_t)predict(num, Q11, al);
          }
          if ((al = cb[5]) != 0 && ws[2] == 0) {
            int64_t num = Q00 * (change_dc
                ? (2 * d[7] - 5 * d[8] + 2 * d[9] + d[11] + 7 * d[12] -
                   14 * d[13] + 7 * d[14] + d[15] + 2 * d[17] - 5 * d[18] +
                   2 * d[19])
                : (-d[11] + 13 * d[12] - 24 * d[13] + 13 * d[14] - d[15]));
            ws[2] = (int16_t)predict(num, Q02, al);
          }
          if (change_dc) {
            if ((al = cb[6]) != 0 && ws[3] == 0)
              ws[3] = (int16_t)predict(
                  Q00 * (d[7] - d[9] + 2 * d[12] - 2 * d[14] + d[17] - d[19]),
                  Q03, al);
            if ((al = cb[7]) != 0 && ws[10] == 0)
              ws[10] = (int16_t)predict(
                  Q00 * (d[7] - 3 * d[8] + d[9] - d[17] + 3 * d[18] - d[19]),
                  Q12, al);
            if ((al = cb[8]) != 0 && ws[17] == 0)
              ws[17] = (int16_t)predict(
                  Q00 * (d[7] - d[9] - 3 * d[12] + 3 * d[14] + d[17] - d[19]),
                  Q21, al);
            if ((al = cb[9]) != 0 && ws[24] == 0)
              ws[24] = (int16_t)predict(
                  Q00 * (d[7] + 2 * d[8] + d[9] - d[17] - 2 * d[18] - d[19]),
                  Q30, al);
            int64_t num = Q00 *
                (-2 * d[1] - 6 * d[2] - 8 * d[3] - 6 * d[4] - 2 * d[5] -
                 6 * d[6] + 6 * d[7] + 42 * d[8] + 6 * d[9] - 6 * d[10] -
                 8 * d[11] + 42 * d[12] + 152 * d[13] + 42 * d[14] -
                 8 * d[15] - 6 * d[16] + 6 * d[17] + 42 * d[18] + 6 * d[19] -
                 6 * d[20] - 2 * d[21] - 6 * d[22] - 8 * d[23] - 6 * d[24] -
                 2 * d[25]);
            ws[0] = (int16_t)predict(num, Q00, 0);
          }
          idct_islow(ws, c.q,
                     &c.plane[(size_t)r * 8 * stride + (size_t)b * 8],
                     stride);
          for (int i = 1; i <= 21; i += 5)
            for (int j = 0; j < 4; j++) d[i + j] = d[i + j + 1];
          prev2 += 64;
          prev += 64;
          cur += 64;
          next += 64;
          next2 += 64;
        }
      }
    }
  }

  // ------------------------------------------------ upsampling (jdsample.c)
  // row y of component c, the first and last rows replicated past the
  // component's downsampled height (libjpeg's context rows)
  static inline const uint8_t* row_at(const Component& c, int y) {
    y = y < 0 ? 0 : (y >= c.height ? c.height - 1 : y);
    return &c.plane[(size_t)y * c.bw * 8];
  }

  // full-size plane (width x height) of component c
  void upsample(const Component& c, std::vector<uint8_t>& out) const {
    out.resize((size_t)width * height);
    int hf = hmax / c.h, vf = vmax / c.v;
    bool h_int = hmax % c.h == 0, v_int = vmax % c.v == 0;
    if (!h_int || !v_int)
      fail(kErrUnsupported,
           "JPEG sampling factors that are not integer ratios (SOF)");
    const size_t stride = (size_t)c.bw * 8;
    if (hf == 1 && vf == 1) {
      for (int y = 0; y < height; y++)
        memcpy(&out[(size_t)y * width], &c.plane[(size_t)y * stride], width);
      return;
    }
    if (hf == 2 && vf == 1 && c.width > 2) {  // h2v1_fancy_upsample
      std::vector<uint8_t> row((size_t)c.width * 2);
      for (int y = 0; y < height; y++) {
        const uint8_t* in = &c.plane[(size_t)y * stride];
        int n = c.width;
        uint8_t* o = row.data();
        int v = in[0];
        *o++ = (uint8_t)v;
        *o++ = (uint8_t)((v * 3 + in[1] + 2) >> 2);
        for (int i = 1; i < n - 1; i++) {
          v = in[i] * 3;
          *o++ = (uint8_t)((v + in[i - 1] + 1) >> 2);
          *o++ = (uint8_t)((v + in[i + 1] + 2) >> 2);
        }
        v = in[n - 1];
        *o++ = (uint8_t)((v * 3 + in[n - 2] + 1) >> 2);
        *o++ = (uint8_t)v;
        memcpy(&out[(size_t)y * width], row.data(), width);
      }
      return;
    }
    if (hf == 2 && vf == 2 && c.width > 2) {  // h2v2_fancy_upsample
      std::vector<uint8_t> row((size_t)c.width * 2);
      for (int y = 0; y < height; y++) {
        int iy = y >> 1;
        int ny = (y & 1) ? iy + 1 : iy - 1;
        const uint8_t* in0 = row_at(c, iy);
        const uint8_t* in1 = row_at(c, ny);
        int n = c.width;
        uint8_t* o = row.data();
        int this_s = in0[0] * 3 + in1[0];
        int next_s = in0[1] * 3 + in1[1];
        *o++ = (uint8_t)((this_s * 4 + 8) >> 4);
        *o++ = (uint8_t)((this_s * 3 + next_s + 7) >> 4);
        int last_s = this_s;
        this_s = next_s;
        for (int i = 2; i < n; i++) {
          next_s = in0[i] * 3 + in1[i];
          *o++ = (uint8_t)((this_s * 3 + last_s + 8) >> 4);
          *o++ = (uint8_t)((this_s * 3 + next_s + 7) >> 4);
          last_s = this_s;
          this_s = next_s;
        }
        *o++ = (uint8_t)((this_s * 3 + last_s + 8) >> 4);
        *o++ = (uint8_t)((this_s * 4 + 7) >> 4);
        memcpy(&out[(size_t)y * width], row.data(), width);
      }
      return;
    }
    if (hf == 1 && vf == 2) {  // h1v2_fancy_upsample
      for (int y = 0; y < height; y++) {
        int iy = y >> 1;
        const uint8_t* in0 = row_at(c, iy);
        const uint8_t* in1 = row_at(c, (y & 1) ? iy + 1 : iy - 1);
        int bias = (y & 1) ? 2 : 1;
        uint8_t* o = &out[(size_t)y * width];
        for (int x = 0; x < width; x++)
          o[x] = (uint8_t)((in0[x] * 3 + in1[x] + bias) >> 2);
      }
      return;
    }
    // box replication (int_upsample, and h2v1/h2v2 at 2 samples or fewer)
    for (int y = 0; y < height; y++) {
      const uint8_t* in = &c.plane[(size_t)(y / vf) * stride];
      uint8_t* o = &out[(size_t)y * width];
      for (int x = 0; x < width; x++) o[x] = in[x / hf];
    }
  }

  // RGB as OpenCV's imread returns it (before EXIF orientation): grey
  // replicated; YCbCr, RGB or (4 components) CMYK / YCCK as libjpeg
  // outputs them, CMYK then converted by OpenCV's icvCvt_CMYK2BGR.
  void to_rgb(uint8_t* out) const {
    const size_t npx = (size_t)width * height;
    if (comps.size() == 1) {
      std::vector<uint8_t> g;
      upsample(comps[0], g);
      for (size_t i = 0; i < npx; i++)
        out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = g[i];
      return;
    }
    const int nc = (int)comps.size();
    std::vector<uint8_t> p[4];
    for (int i = 0; i < nc; i++) upsample(comps[i], p[i]);
    // jdapimin.c default_decompress_parms: the colour space of the file
    bool ycc;
    if (nc == 4) ycc = adobe && adobe_transform != 0;  // YCCK, else CMYK
    else if (jfif) ycc = true;
    else if (adobe) ycc = adobe_transform != 0;
    else ycc = !(comps[0].id == 82 && comps[1].id == 71 && comps[2].id == 66);
    if (force_ycc >= 0) ycc = force_ycc == 1;
    if (nc == 3 && !ycc) {
      for (size_t i = 0; i < npx; i++) {
        out[3 * i] = p[0][i];
        out[3 * i + 1] = p[1][i];
        out[3 * i + 2] = p[2][i];
      }
      return;
    }
    // jdcolor.c build_ycc_rgb_table / ycc_rgb_convert (ycck_cmyk_convert
    // inverts the result)
    const int SCALEBITS = 16;
    const int64_t ONE_HALF = (int64_t)1 << (SCALEBITS - 1);
    auto FIX = [](double x) {
      return (int64_t)(x * (double)(1L << 16) + 0.5);
    };
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    for (int i = 0, x = -128; i < 256; i++, x++) {
      cr_r[i] = (int)((FIX(1.40200) * x + ONE_HALF) >> SCALEBITS);
      cb_b[i] = (int)((FIX(1.77200) * x + ONE_HALF) >> SCALEBITS);
      cr_g[i] = (-FIX(0.71414)) * x;
      cb_g[i] = (-FIX(0.34414)) * x + ONE_HALF;
    }
    auto clamp = [](int v) -> uint8_t {
      return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
    };
    for (size_t i = 0; i < npx; i++) {
      int a = p[0][i], b = p[1][i], c = p[2][i];
      if (ycc) {
        int y = a, cb = b, cr = c;
        a = clamp(y + cr_r[cr]);
        b = clamp(y + (int)((cb_g[cb] + cr_g[cr]) >> SCALEBITS));
        c = clamp(y + cb_b[cb]);
        if (nc == 4) {
          a = 255 - a;
          b = 255 - b;
          c = 255 - c;
        }
      }
      if (nc == 4) {
        int k = p[3][i];
        a = k - ((255 - a) * k >> 8);
        b = k - ((255 - b) * k >> 8);
        c = k - ((255 - c) * k >> 8);
      }
      out[3 * i] = (uint8_t)a;
      out[3 * i + 1] = (uint8_t)b;
      out[3 * i + 2] = (uint8_t)c;
    }
  }

  // the components as they are (libjpeg's JCS_UNKNOWN output), each
  // upsampled to the frame's size, interleaved
  void components(uint8_t* out) const {
    const size_t npx = (size_t)width * height;
    const size_t nc = comps.size();
    std::vector<uint8_t> p;
    for (size_t c = 0; c < nc; c++) {
      upsample(comps[c], p);
      for (size_t i = 0; i < npx; i++) out[i * nc + c] = p[i];
    }
  }

  // the decoded image, EXIF-oriented, into out (the oriented shape)
  void decode(uint8_t* out) {
    if (progressive) output_coefficients();
    if (orientation < 2 || orientation > 8) {
      to_rgb(out);
      return;
    }
    std::vector<uint8_t> rgb((size_t)width * height * 3);
    to_rgb(rgb.data());
    orient_rgb(rgb.data(), height, width, orientation, out);
  }
};

// ---------------------------------------------------------------- encoder
// A baseline JPEG encoder written as libjpeg(-turbo)'s default compression
// is, what OpenCV's imencode writes: JFIF APP0 (1.01, no density unit), the
// Annex K tables scaled by IJG quality (jcparam.c), 4:2:0 (Y 2x2, Cb and Cr
// 1x1), the fixed-point RGB -> YCbCr of jccolor.c, h2v2 box downsampling
// with the alternating 1/2 bias of jcsample.c, edges replicated as
// jcprepct.c and jcsample.c replicate them, the ISLOW forward DCT
// (jfdctint.c), rounding quantisation (jcdctmgr.c), the dummy blocks of
// jccoefct.c past the image edge, and the standard Huffman tables
// (jstdhuff.c), markers in jcmarker.c's order.

const uint8_t kStdLumQuant[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const uint8_t kStdChromQuant[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

// code counts of lengths 1..16, then the values (jstdhuff.c)
const uint8_t kDcLumBits[16] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromBits[16] = {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumBits[16] = {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcChromBits[16] = {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcLumVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct HuffEnc {
  const uint8_t* bits;
  const uint8_t* vals;
  int nvals;
  uint16_t code[256];
  uint8_t size[256];

  HuffEnc(const uint8_t* b, const uint8_t* v, int n) : bits(b), vals(v), nvals(n) {
    // canonical codes (jpeg_make_c_derived_tbl)
    std::memset(size, 0, sizeof(size));
    uint32_t c = 0;
    int k = 0;
    for (int len = 1; len <= 16; ++len) {
      for (int i = 0; i < bits[len - 1]; ++i, ++k) {
        code[vals[k]] = (uint16_t)c++;
        size[vals[k]] = (uint8_t)len;
      }
      c <<= 1;
    }
  }
};

struct BitWriter {
  std::vector<uint8_t>& out;
  uint32_t acc = 0;
  int nacc = 0;

  explicit BitWriter(std::vector<uint8_t>& o) : out(o) {}

  void byte(uint8_t b) {
    out.push_back(b);
    if (b == 0xFF) out.push_back(0);  // byte stuffing
  }
  void put(uint32_t v, int n) {
    if (n == 0) return;
    acc = (acc << n) | (v & ((1u << n) - 1));
    nacc += n;
    while (nacc >= 8) {
      byte((uint8_t)(acc >> (nacc - 8)));
      nacc -= 8;
    }
    acc &= (1u << nacc) - 1;
  }
  void flush() { put(0x7F, 7); acc = 0; nacc = 0; }  // pad with 1-bits
};

// jfdctint.c's jpeg_fdct_islow: in place, output scaled up by 8
void fdct_islow(int32_t* d) {
  for (int r = 0; r < 8; ++r) {
    int32_t* p = d + 8 * r;
    int64_t tmp0 = p[0] + p[7], tmp7 = p[0] - p[7];
    int64_t tmp1 = p[1] + p[6], tmp6 = p[1] - p[6];
    int64_t tmp2 = p[2] + p[5], tmp5 = p[2] - p[5];
    int64_t tmp3 = p[3] + p[4], tmp4 = p[3] - p[4];
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    p[0] = (int32_t)((tmp10 + tmp11) * (1 << PASS1_BITS));
    p[4] = (int32_t)((tmp10 - tmp11) * (1 << PASS1_BITS));
    int64_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
    p[2] = (int32_t)descale(z1 + tmp13 * FIX_0_765366865, CONST_BITS - PASS1_BITS);
    p[6] = (int32_t)descale(z1 + tmp12 * -FIX_1_847759065, CONST_BITS - PASS1_BITS);
    z1 = tmp4 + tmp7;
    int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp4 *= FIX_0_298631336;
    tmp5 *= FIX_2_053119869;
    tmp6 *= FIX_3_072711026;
    tmp7 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    p[7] = (int32_t)descale(tmp4 + z1 + z3, CONST_BITS - PASS1_BITS);
    p[5] = (int32_t)descale(tmp5 + z2 + z4, CONST_BITS - PASS1_BITS);
    p[3] = (int32_t)descale(tmp6 + z2 + z3, CONST_BITS - PASS1_BITS);
    p[1] = (int32_t)descale(tmp7 + z1 + z4, CONST_BITS - PASS1_BITS);
  }
  for (int c = 0; c < 8; ++c) {
    int32_t* p = d + c;
    int64_t tmp0 = p[0] + p[56], tmp7 = p[0] - p[56];
    int64_t tmp1 = p[8] + p[48], tmp6 = p[8] - p[48];
    int64_t tmp2 = p[16] + p[40], tmp5 = p[16] - p[40];
    int64_t tmp3 = p[24] + p[32], tmp4 = p[24] - p[32];
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    p[0] = (int32_t)descale(tmp10 + tmp11, PASS1_BITS);
    p[32] = (int32_t)descale(tmp10 - tmp11, PASS1_BITS);
    int64_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
    p[16] = (int32_t)descale(z1 + tmp13 * FIX_0_765366865, CONST_BITS + PASS1_BITS);
    p[48] = (int32_t)descale(z1 + tmp12 * -FIX_1_847759065, CONST_BITS + PASS1_BITS);
    z1 = tmp4 + tmp7;
    int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp4 *= FIX_0_298631336;
    tmp5 *= FIX_2_053119869;
    tmp6 *= FIX_3_072711026;
    tmp7 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    p[56] = (int32_t)descale(tmp4 + z1 + z3, CONST_BITS + PASS1_BITS);
    p[40] = (int32_t)descale(tmp5 + z2 + z4, CONST_BITS + PASS1_BITS);
    p[24] = (int32_t)descale(tmp6 + z2 + z3, CONST_BITS + PASS1_BITS);
    p[8] = (int32_t)descale(tmp7 + z1 + z4, CONST_BITS + PASS1_BITS);
  }
}

// jcparam.c: jpeg_quality_scaling then jpeg_add_quant_table (baseline)
void scale_quant(const uint8_t* base, int quality, uint16_t* out) {
  if (quality <= 0) quality = 1;
  if (quality > 100) quality = 100;
  int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  for (int i = 0; i < 64; ++i) {
    long t = ((long)base[i] * scale + 50L) / 100L;
    if (t <= 0L) t = 1L;
    if (t > 255L) t = 255L;
    out[i] = (uint16_t)t;
  }
}

// One component plane, edge-replicated to whole blocks, with the
// coefficients of each of its blocks (natural order, quantised).
struct Plane {
  int w = 0, h = 0;  // padded size, multiples of 8
  std::vector<uint8_t> px;
  uint8_t at(int y, int x) const { return px[(size_t)y * w + x]; }
};

void quantize_block(const Plane& p, int by, int bx, const uint16_t* q,
                    int32_t* coef) {
  int32_t d[64];
  for (int y = 0; y < 8; ++y)
    for (int x = 0; x < 8; ++x) d[8 * y + x] = (int32_t)p.at(8 * by + y, 8 * bx + x) - 128;
  fdct_islow(d);
  for (int i = 0; i < 64; ++i) {
    int32_t qv = (int32_t)q[i] << 3;  // the ISLOW divisors are scaled by 8
    int32_t t = d[i];
    coef[i] = t < 0 ? -((-t + (qv >> 1)) / qv) : (t + (qv >> 1)) / qv;
  }
}

void encode_block(BitWriter& bw, const int32_t* coef, int32_t& last_dc,
                  const HuffEnc& dc, const HuffEnc& ac) {
  int32_t t = coef[0] - last_dc, t2 = t;
  last_dc = coef[0];
  if (t < 0) { t = -t; --t2; }
  int nbits = 0;
  while (t) { ++nbits; t >>= 1; }
  bw.put(dc.code[nbits], dc.size[nbits]);
  bw.put((uint32_t)t2, nbits);
  int run = 0;
  for (int k = 1; k < 64; ++k) {
    int32_t v = coef[kZigzag[k]];
    if (v == 0) { ++run; continue; }
    while (run > 15) { bw.put(ac.code[0xF0], ac.size[0xF0]); run -= 16; }
    int32_t v2 = v;
    if (v < 0) { v = -v; --v2; }
    nbits = 1;
    while ((v >>= 1)) ++nbits;
    int sym = (run << 4) + nbits;
    bw.put(ac.code[sym], ac.size[sym]);
    bw.put((uint32_t)v2, nbits);
    run = 0;
  }
  if (run > 0) bw.put(ac.code[0], ac.size[0]);
}

void marker(std::vector<uint8_t>& o, uint8_t m, const std::vector<uint8_t>& body) {
  size_t len = body.size() + 2;
  o.insert(o.end(), {0xFF, m, (uint8_t)(len >> 8), (uint8_t)(len & 0xFF)});
  o.insert(o.end(), body.begin(), body.end());
}

void dht(std::vector<uint8_t>& o, int cls_id, const uint8_t* bits,
         const uint8_t* vals, int nvals) {
  std::vector<uint8_t> b{(uint8_t)cls_id};
  b.insert(b.end(), bits, bits + 16);
  b.insert(b.end(), vals, vals + nvals);
  marker(o, 0xC4, b);
}

std::vector<uint8_t> encode_jpeg(const uint8_t* rgb, int H, int W, int quality) {
  if (H <= 0 || W <= 0 || H > 65535 || W > 65535)
    fail(kErrArgs, "JPEG frame size must be 1..65535 on each side");
  // jccolor.c's rgb_ycc tables: 16 fractional bits, Cb/Cr with 0.5 - eps
  constexpr int SB = 16;
  auto fix = [](double x) { return (int32_t)(x * (1L << SB) + 0.5); };
  const int32_t one_half = 1 << (SB - 1), cbcr_off = 128 << SB;
  const int32_t ry = fix(0.29900), gy = fix(0.58700), by_ = fix(0.11400);
  const int32_t rcb = -fix(0.16874), gcb = -fix(0.33126), bcb = fix(0.5);
  const int32_t gcr = -fix(0.41869), bcr = -fix(0.08131);
  const int mcu_rows = (H + 15) / 16, mcu_cols = (W + 15) / 16;
  const int ybw = (W + 7) / 8, ybh = (H + 7) / 8;  // Y blocks in the image
  // full-resolution Y, Cb, Cr of the image, edge-replicated to whole MCUs
  const int fw = mcu_cols * 16, fh = mcu_rows * 16;
  std::vector<uint8_t> Y((size_t)fw * fh), Cb((size_t)fw * fh), Cr((size_t)fw * fh);
  for (int y = 0; y < fh; ++y) {
    const uint8_t* row = rgb + (size_t)std::min(y, H - 1) * W * 3;
    for (int x = 0; x < fw; ++x) {
      const uint8_t* p = row + (size_t)std::min(x, W - 1) * 3;
      int32_t r = p[0], g = p[1], b = p[2];
      size_t i = (size_t)y * fw + x;
      Y[i] = (uint8_t)((ry * r + gy * g + by_ * b + one_half) >> SB);
      Cb[i] = (uint8_t)((rcb * r + gcb * g + bcb * b + cbcr_off + one_half - 1) >> SB);
      Cr[i] = (uint8_t)((bcb * r + gcr * g + bcr * b + cbcr_off + one_half - 1) >> SB);
    }
  }
  Plane py;
  py.w = fw;
  py.h = fh;
  py.px = std::move(Y);
  // h2v2 downsampling over ceil(H/2) rows, then the last one replicated
  // down to whole MCU rows (jcprepct.c pads the downsampled rows)
  Plane pc[2];
  const int cw = mcu_cols * 8, ch = mcu_rows * 8, crows = (H + 1) / 2;
  const std::vector<uint8_t>* full[2] = {&Cb, &Cr};
  for (int c = 0; c < 2; ++c) {
    pc[c].w = cw;
    pc[c].h = ch;
    pc[c].px.resize((size_t)cw * ch);
    const std::vector<uint8_t>& f = *full[c];
    for (int y = 0; y < ch; ++y) {
      int sy = 2 * std::min(y, crows - 1);
      // the row below the last odd row is the last row replicated
      int sy1 = std::min(sy + 1, H - 1);
      for (int x = 0; x < cw; ++x) {
        int bias = (x & 1) ? 2 : 1;
        int s = f[(size_t)sy * fw + 2 * x] + f[(size_t)sy * fw + 2 * x + 1] +
                f[(size_t)sy1 * fw + 2 * x] + f[(size_t)sy1 * fw + 2 * x + 1];
        pc[c].px[(size_t)y * cw + x] = (uint8_t)((s + bias) >> 2);
      }
    }
  }
  uint16_t ql[64], qc[64];
  scale_quant(kStdLumQuant, quality, ql);
  scale_quant(kStdChromQuant, quality, qc);
  const HuffEnc dcl(kDcLumBits, kDcVals, 12), dcc(kDcChromBits, kDcVals, 12);
  const HuffEnc acl(kAcLumBits, kAcLumVals, 162), acc(kAcChromBits, kAcChromVals, 162);

  std::vector<uint8_t> o{0xFF, 0xD8};
  marker(o, 0xE0, {'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1, 0, 0});
  const uint16_t* qs[2] = {ql, qc};
  for (int t = 0; t < 2; ++t) {
    std::vector<uint8_t> b{(uint8_t)t};
    for (int i = 0; i < 64; ++i) b.push_back((uint8_t)qs[t][kZigzag[i]]);
    marker(o, 0xDB, b);
  }
  marker(o, 0xC0, {8, (uint8_t)(H >> 8), (uint8_t)H, (uint8_t)(W >> 8), (uint8_t)W, 3,
                   1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1});
  dht(o, 0x00, kDcLumBits, kDcVals, 12);
  dht(o, 0x10, kAcLumBits, kAcLumVals, 162);
  dht(o, 0x01, kDcChromBits, kDcVals, 12);
  dht(o, 0x11, kAcChromBits, kAcChromVals, 162);
  marker(o, 0xDA, {3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0});

  BitWriter bw(o);
  int32_t last[3] = {0, 0, 0};
  int32_t blocks[4][64], coef[64];
  for (int my = 0; my < mcu_rows; ++my) {
    for (int mx = 0; mx < mcu_cols; ++mx) {
      // Y: 2x2 blocks; one past the image's last block column or row is a
      // dummy (zero AC, the DC of the block before it in the MCU)
      for (int k = 0; k < 4; ++k) {
        int bx = 2 * mx + (k & 1), byy = 2 * my + (k >> 1);
        if (byy >= ybh) {
          std::memset(blocks[k], 0, sizeof(blocks[k]));
          blocks[k][0] = blocks[(k >> 1) * 2 - 1][0];
        } else if (bx >= ybw) {
          std::memset(blocks[k], 0, sizeof(blocks[k]));
          blocks[k][0] = blocks[k - 1][0];
        } else {
          quantize_block(py, byy, bx, ql, blocks[k]);
        }
        encode_block(bw, blocks[k], last[0], dcl, acl);
      }
      for (int c = 0; c < 2; ++c) {
        quantize_block(pc[c], my, mx, qc, coef);
        encode_block(bw, coef, last[1 + c], dcc, acc);
      }
    }
  }
  bw.flush();
  o.push_back(0xFF);
  o.push_back(0xD9);
  return o;
}

// ------------------------------------------------------- BMP RLE4 / RLE8
// OpenCV's BMP decoder (grfmt_bmp.cpp) on a run-length coded bitmap, as
// palette indices: a pixel that an end-of-line, a delta or the
// end-of-bitmap skips takes index 0 (OpenCV fills it with palette entry 0),
// and the skip runs on in raster order across rows.  An encoded run of
// RLE8 that ends on a row's last pixel moves to the next row, so an
// end-of-line right after it is ignored; an absolute run (and any run of
// RLE4) stays at the row's end until a code moves on.  Rows are in file
// order (the caller flips a bottom-up bitmap).
struct RleBmp {
  const uint8_t* in;
  size_t n, pos = 0;
  int height, width, x = 0, y = 0;
  uint8_t* out;

  int byte() {
    if (pos >= n) fail(kErrFormat, "BMP run-length data ends early");
    return in[pos++];
  }
  // FillUniColor: count pixels of index v in raster order
  void fill(long count, uint8_t v) {
    do {
      long end = std::min<long>(x + count, width);
      count -= end - x;
      if (end > x) memset(out + (size_t)y * width + x, v, (size_t)(end - x));
      x = (int)end;
      if (x >= width) {
        x = 0;
        if (++y >= height) break;
      }
    } while (count > 0);
  }
  void past_row_end() {
    fail(kErrFormat, "BMP run-length run past the end of a row");
  }
  void skip(int code) {  // 0 end-of-line, 1 end-of-bitmap, 2 delta
    long xs = width - x, ys = height - y;
    if (code == 2) {
      xs = byte();
      ys = byte();
    }
    fill(xs + (code == 0 ? 0 : ys * width), 0);
  }

  void rle8() {
    bool wrapped = false;  // the last run moved to a new row
    while (y < height) {
      int len = byte(), code = byte();
      if (len) {
        if (x + len > width) past_row_end();
        int y0 = y;
        fill(len, (uint8_t)code);
        wrapped = y != y0;
      } else if (code > 2) {
        if (x + code > width) past_row_end();
        size_t sz = (size_t)(code + 1) & ~(size_t)1;
        if (pos + sz > n) fail(kErrFormat, "BMP run-length data ends early");
        memcpy(out + (size_t)y * width + x, in + pos, (size_t)code);
        pos += sz;
        x += code;
        wrapped = false;
      } else {
        if (code || !wrapped || x > 0) skip(code);
        wrapped = false;
      }
    }
  }

  void rle4() {
    while (y < height) {
      int len = byte(), code = byte();
      if (len) {
        if (x + len > width) past_row_end();
        uint8_t c[2] = {(uint8_t)(code >> 4), (uint8_t)(code & 15)};
        uint8_t* row = out + (size_t)y * width;
        for (int i = 0; i < len; i++) row[x + i] = c[i & 1];
        x += len;
      } else if (code > 2) {
        if (x + code > width) past_row_end();
        size_t sz = (size_t)((((code + 1) >> 1) + 1) & ~1);
        if (pos + sz > n) fail(kErrFormat, "BMP run-length data ends early");
        uint8_t* row = out + (size_t)y * width;
        for (int i = 0; i < code; i++) {
          int b = in[pos + i / 2];
          row[x + i] = (uint8_t)((i & 1) ? b & 15 : b >> 4);
        }
        pos += sz;
        x += code;
      } else {
        skip(code);
      }
    }
  }
};

// ------------------------------------------------- TIFF PackBits and LZW
// libtiff's PackBitsDecode over one strip or tile: a run longer than the
// room left is cut, and data that ends before `nout` bytes is an error.
void packbits(const uint8_t* in, size_t n, uint8_t* out, size_t nout) {
  size_t pos = 0, o = 0;
  while (pos < n && o < nout) {
    int c = (int8_t)in[pos++];
    if (c == -128) continue;
    if (c < 0) {
      size_t run = std::min<size_t>((size_t)(1 - c), nout - o);
      if (pos >= n) break;
      memset(out + o, in[pos++], run);
      o += run;
    } else {
      size_t run = std::min<size_t>((size_t)c + 1, nout - o);
      if (pos + run > n) break;
      memcpy(out + o, in + pos, run);
      pos += (size_t)c + 1;
      o += run;
    }
  }
  if (o < nout) fail(kErrFormat, "TIFF PackBits data ends before its strip");
}

// libtiff's LZWDecode (the current, MSB-first coding): codes of 9 to 12
// bits, the width growing one code early, 256 clears the table and 257
// ends; output past `nout` bytes is dropped, data that ends short of it is
// an error.
void tiff_lzw(const uint8_t* in, size_t n, uint8_t* out, size_t nout) {
  if (n >= 2 && in[0] == 0 && (in[1] & 1))
    fail(kErrUnsupported,
         "old-style (LSB-first) TIFF LZW is not supported");
  std::vector<uint16_t> prefix(4096);
  std::vector<uint8_t> suffix(4096), first(4096);
  std::vector<uint16_t> length(4096);
  std::vector<uint8_t> stack(4096);
  for (int i = 0; i < 256; i++) {
    suffix[i] = first[i] = (uint8_t)i;
    length[i] = 1;
  }
  size_t pos = 0, o = 0;
  uint32_t bits = 0;
  int nbits_held = 0, nbits = 9, free_ent = 258, old = -1;
  auto next = [&]() -> int {
    while (nbits_held < nbits) {
      if (pos >= n) return 257;  // not terminated: libtiff ends here too
      bits = (bits << 8) | in[pos++];
      nbits_held += 8;
    }
    nbits_held -= nbits;
    return (int)((bits >> nbits_held) & ((1u << nbits) - 1));
  };
  auto emit = [&](int code) {
    int len = length[code];
    int k = len;
    for (int c = code; k > 0; c = prefix[c]) stack[--k] = suffix[c];
    size_t m = std::min<size_t>((size_t)len, nout - o);
    memcpy(out + o, stack.data(), m);
    o += m;
  };
  while (o < nout) {
    int code = next();
    if (code == 257) break;
    if (code == 256) {
      nbits = 9;
      free_ent = 258;
      code = next();
      if (code == 257) break;
      if (code > 255) fail(kErrFormat, "corrupt TIFF LZW data");
      emit(code);
      old = code;
      continue;
    }
    if (old < 0 || code > free_ent || free_ent >= 4096)
      fail(kErrFormat, "corrupt TIFF LZW data");
    // the new entry: old's string + the first byte of code's (or of old's
    // own for the code being defined now)
    int fb = code < free_ent ? first[code] : first[old];
    prefix[free_ent] = (uint16_t)old;
    suffix[free_ent] = (uint8_t)fb;
    first[free_ent] = first[old];
    length[free_ent] = (uint16_t)(length[old] + 1);
    free_ent++;
    emit(code);
    old = code;
    if (free_ent >= (1 << nbits) - 1 && nbits < 12) nbits++;
  }
  if (o < nout) fail(kErrFormat, "TIFF LZW data ends before its strip");
}

// --------------------------------------------------------------- GIF
// OpenCV 5's own GIF decoder (grfmt_gif.cpp), first frame only: the whole
// block structure is walked up to the trailer (a file cut anywhere is
// refused, as cv2 refuses it while reading the header), the first image
// is decoded with LSB-first LZW (codes from the minimum code size + 1 to
// 12 bits, clear and end codes) and must give exactly its width * height
// indices, each below its colour table's size, read as cv2 reads them
// (random mutations against cv2 show it): an end code before the frame is
// full resets the table and drops the rest of its byte, a code that
// overruns the frame fails the file, and once the frame is full the next
// code ends the stream and fails the file unless the data ends with it
// (cv2 would read what follows as further blocks); a graphic control
// extension before it must be 4 bytes with a disposal method of 0-3, and an
// application extension with a 3-byte data sub-block must be NETSCAPE2.0's
// (cv2 reads nothing otherwise); a frame outside the logical screen, which
// cv2 reads as nothing, is refused by name.  The screen starts
// as the global table's background colour, or black without a global
// table, whatever the disposal method; the frame's transparent pixels keep
// the screen's colour.
struct Gif {
  const uint8_t* d;
  size_t n, pos = 0;
  int width = 0, height = 0;

  int byte() {
    if (pos >= n) fail(kErrFormat, "GIF file ends early");
    return d[pos++];
  }
  int word() {
    int lo = byte();
    return lo | byte() << 8;
  }
  // the data sub-blocks from pos, appended to `out` (or skipped)
  void sub_blocks(std::vector<uint8_t>* out) {
    for (int len = byte(); len; len = byte()) {
      if (pos + len > n) fail(kErrFormat, "GIF file ends early");
      if (out) out->insert(out->end(), d + pos, d + pos + len);
      pos += len;
    }
  }

  // An application extension: cv2 reads nothing of one that holds a data
  // sub-block of 3 bytes unless its first sub-block is NETSCAPE2.0's
  // identifier
  void application() {
    bool netscape = false, three = false;
    for (int len = byte(), k = 0; len; len = byte(), k++) {
      if (pos + len > n) fail(kErrFormat, "GIF file ends early");
      if (k == 0) netscape = len == 11 && !memcmp(d + pos, "NETSCAPE2.0", 11);
      three = three || len == 3;
      pos += len;
    }
    if (three && !netscape)
      fail(kErrFormat, "GIF application extension of a 3-byte sub-block");
  }

  void header() {
    if (n < 13 || memcmp(d, "GIF8", 4) || (d[4] != '7' && d[4] != '9') ||
        d[5] != 'a')
      fail(kErrFormat, "not a GIF file");
    pos = 6;
    width = word();
    height = word();
    if (width <= 0 || height <= 0) fail(kErrFormat, "GIF screen of 0 pixels");
  }

  void decode(uint8_t* out) {
    header();
    int flags = byte(), bg = byte();
    byte();
    int gsize = flags & 0x80 ? 2 << (flags & 7) : 0;
    if (pos + 3 * gsize > n) fail(kErrFormat, "GIF file ends early");
    const uint8_t* gtable = d + pos;
    pos += 3 * gsize;
    if (gsize && bg >= gsize)
      fail(kErrFormat, "GIF background index past its colour table");
    int transparent = -1;
    bool done = false;
    for (;;) {
      int tag = byte();
      if (tag == 0x3B) break;
      if (tag == 0x21) {
        int label = byte();
        if (label == 0xF9 && !done) {
          // before the first frame: 4 bytes and a disposal method of 0-3
          int len = byte();
          if (len != 4 || pos + len > n || (d[pos] >> 2 & 7) > 3)
            fail(kErrFormat, "bad GIF graphic control extension");
          transparent = d[pos] & 1 ? d[pos + 3] : -1;
          pos += len;
          sub_blocks(nullptr);
        } else if (label == 0xFF) {
          application();
        } else {
          sub_blocks(nullptr);
        }
      } else if (tag == 0x2C) {
        if (done) {
          pos += 8;
          int f = byte();
          if (f & 0x80) pos += 3 * (2 << (f & 7));
          byte();
          sub_blocks(nullptr);
          continue;
        }
        image(out, gtable, gsize, bg, transparent);
        done = true;
      } else {
        fail(kErrFormat, "bad GIF block");
      }
    }
    if (!done) fail(kErrFormat, "GIF without an image");
  }

  void image(uint8_t* out, const uint8_t* gtable, int gsize, int bg,
             int transparent) {
    int left = word(), top = word(), w = word(), h = word();
    int flags = byte();
    if (w <= 0 || h <= 0) fail(kErrFormat, "GIF frame of 0 pixels");
    if (left + w > width || top + h > height)
      fail(kErrUnsupported, "GIF frame outside its logical screen");
    const uint8_t* table = gtable;
    int tsize = gsize;
    if (flags & 0x80) {
      tsize = 2 << (flags & 7);
      if (pos + 3 * tsize > n) fail(kErrFormat, "GIF file ends early");
      table = d + pos;
      pos += 3 * tsize;
    }
    uint8_t fill[3] = {0, 0, 0};
    if (gsize) memcpy(fill, gtable + 3 * bg, 3);
    size_t npx = (size_t)width * height;
    for (size_t i = 0; i < npx; i++) memcpy(out + 3 * i, fill, 3);
    int mcs = byte();
    if (mcs < 1 || mcs > 11) fail(kErrFormat, "bad GIF LZW code size");
    std::vector<uint8_t> code;
    sub_blocks(&code);
    std::vector<uint8_t> idx((size_t)w * h);
    lzw(code, mcs, idx);
    // rows in stream order -> image rows (4-pass interlace)
    std::vector<int> rows;
    if (flags & 0x40) {
      const int start[4] = {0, 4, 2, 1}, step[4] = {8, 8, 4, 2};
      for (int p = 0; p < 4; p++)
        for (int y = start[p]; y < h; y += step[p]) rows.push_back(y);
    } else {
      for (int y = 0; y < h; y++) rows.push_back(y);
    }
    for (int r = 0; r < h; r++) {
      const uint8_t* src = idx.data() + (size_t)r * w;
      uint8_t* dst = out + ((size_t)(top + rows[r]) * width + left) * 3;
      for (int x = 0; x < w; x++) {
        int v = src[x];
        if (v >= tsize) fail(kErrFormat, "GIF colour index past its table");
        if (v != transparent) memcpy(dst + 3 * x, table + 3 * v, 3);
      }
    }
  }

  static void lzw(const std::vector<uint8_t>& in, int mcs,
                  std::vector<uint8_t>& out) {
    const int clear = 1 << mcs, end = clear + 1;
    std::vector<uint16_t> prefix(4096);
    std::vector<uint8_t> suffix(4096), first(4096), stack(4097);
    for (int i = 0; i < clear; i++) suffix[i] = first[i] = (uint8_t)i;
    int width = mcs + 1, next = end + 1, old = -1;
    uint32_t acc = 0;
    int held = 0;
    size_t pos = 0, o = 0;
    for (;;) {
      while (held < width && pos < in.size()) {
        acc |= (uint32_t)in[pos++] << held;
        held += 8;
      }
      if (held < width) break;
      int c = (int)(acc & ((1u << width) - 1));
      acc >>= width;
      held -= width;
      if (o == out.size()) {
        // the frame is full: the next code ends it, and the data must end
        // with that code
        if (pos < in.size())
          fail(kErrFormat, "GIF LZW data goes on past its frame");
        break;
      }
      if (c == end) {  // before the frame is full: a reset, the byte's
        width = mcs + 1;  // other bits dropped
        next = end + 1;
        old = -1;
        acc = 0;
        held = 0;
        continue;
      }
      if (c == clear) {
        width = mcs + 1;
        next = end + 1;
        old = -1;
        continue;
      }
      if (c > next || (c == next && old < 0))
        fail(kErrFormat, "corrupt GIF LZW data");
      int k = 0, s = c == next ? old : c;
      for (; s >= clear; s = prefix[s]) stack[k++] = suffix[s];
      stack[k++] = (uint8_t)s;
      uint8_t head = (uint8_t)s;
      if (c == next) {
        // the code being defined now: old's string + its own first byte
        memmove(stack.data() + 1, stack.data(), k);
        stack[0] = head;
        k++;
      }
      if (o + k > out.size()) fail(kErrFormat, "GIF LZW data past its frame");
      for (int i = 0; i < k; i++) out[o++] = stack[k - 1 - i];
      if (old >= 0 && next < 4096) {
        prefix[next] = (uint16_t)old;
        suffix[next] = head;
        next++;
        if (next == 1 << width && width < 12) width++;
      }
      old = c;
    }
    if (o != out.size()) fail(kErrFormat, "GIF LZW data ends before its frame");
  }
};

// ------------------------------------------------------- Radiance HDR
// OpenCV's rgbe.cpp and grfmt_hdr.cpp: header lines up to
// "FORMAT=32-bit_rle_rgbe", a blank line, then "-Y H +X W"; new-style
// run-length scanlines (a scanline that does not start 2, 2 switches the
// rest of the image to flat pixels), flat pixels below 8 or above 32767
// columns; each pixel m * 2^(e - 136) in float, then the 8-bit result as
// imread converts it: saturate(round-half-even(v * 255)), 0 at 2^31 and
// above (cvRound's INT_MIN).  The XYZE format
// and the layouts other than -Y +X, which cv2 reads as nothing, are
// refused by name.
struct Hdr {
  const uint8_t* d;
  size_t n, pos = 0;
  int width = 0, height = 0;

  // the next line as fgets reads it into cv2's 128-byte buffer
  bool line(std::string& s) {
    s.clear();
    if (pos >= n) return false;
    while (pos < n && s.size() < 127) {
      char c = (char)d[pos++];
      s.push_back(c);
      if (c == '\n') break;
    }
    return true;
  }

  void header() {
    std::string s;
    if (!line(s)) fail(kErrFormat, "Radiance HDR header ends early");
    for (;;) {
      if (s.empty() || s[0] == '\n' || s[0] == '\0')
        fail(kErrFormat, "Radiance HDR header without its FORMAT line");
      if (s == "FORMAT=32-bit_rle_rgbe\n") break;
      if (s == "FORMAT=32-bit_rle_xyze\n")
        fail(kErrUnsupported, "Radiance HDR in XYZE (32-bit_rle_xyze)");
      if (!line(s)) fail(kErrFormat, "Radiance HDR header ends early");
    }
    if (!line(s) || s != "\n")
      fail(kErrFormat, "Radiance HDR without a blank line after FORMAT");
    if (!line(s) || sscanf(s.c_str(), "-Y %d +X %d", &height, &width) < 2)
      fail(kErrUnsupported,
           "Radiance HDR layout other than -Y H +X W: " +
               s.substr(0, s.find('\n')));
    if (width <= 0 || height <= 0)
      fail(kErrFormat, "Radiance HDR of 0 pixels");
  }

  static void put(const uint8_t* rgbe, uint8_t* o) {
    if (!rgbe[3]) {
      o[0] = o[1] = o[2] = 0;
      return;
    }
    float f = (float)ldexp(1.0, rgbe[3] - 136);
    for (int c = 0; c < 3; c++) {
      // cvRound past int32's range gives INT_MIN, which saturates to 0
      float v = (float)rgbe[c] * f * 255.0f;
      o[c] = v >= 2147483648.0f ? 0 : v >= 255.0f ? 255 : (uint8_t)nearbyintf(v);
    }
  }

  void flat(uint8_t* o, size_t count) {
    if (pos + 4 * count > n) fail(kErrFormat, "Radiance HDR data ends early");
    for (size_t i = 0; i < count; i++) put(d + pos + 4 * i, o + 3 * i);
    pos += 4 * count;
  }

  void decode(uint8_t* out) {
    header();
    size_t w = (size_t)width;
    if (w < 8 || w > 0x7fff) return flat(out, w * height);
    std::vector<uint8_t> buf(4 * w);
    for (int y = 0; y < height; y++) {
      uint8_t* o = out + (size_t)y * w * 3;
      if (pos + 4 > n) fail(kErrFormat, "Radiance HDR data ends early");
      const uint8_t* p = d + pos;
      if (p[0] != 2 || p[1] != 2 || (p[2] & 0x80)) {
        put(p, o);
        pos += 4;
        return flat(o + 3, w * (height - y) - 1);
      }
      if ((size_t)(p[2] << 8 | p[3]) != w)
        fail(kErrFormat, "Radiance HDR scanline of the wrong width");
      pos += 4;
      for (int c = 0; c < 4; c++) {
        uint8_t* q = buf.data() + c * w;
        uint8_t* qend = q + w;
        while (q < qend) {
          if (pos + 2 > n) fail(kErrFormat, "Radiance HDR data ends early");
          int a = d[pos], b = d[pos + 1];
          pos += 2;
          int count = a > 128 ? a - 128 : a;
          if (count == 0 || count > qend - q)
            fail(kErrFormat, "bad Radiance HDR scanline data");
          if (a > 128) {
            memset(q, b, count);
            q += count;
          } else {
            *q++ = (uint8_t)b;
            if (--count > 0) {
              if (pos + count > n)
                fail(kErrFormat, "Radiance HDR data ends early");
              memcpy(q, d + pos, count);
              pos += count;
              q += count;
            }
          }
        }
      }
      for (size_t x = 0; x < w; x++) {
        uint8_t px[4] = {buf[x], buf[w + x], buf[2 * w + x], buf[3 * w + x]};
        put(px, o + 3 * x);
      }
    }
  }
};

int report(const Error& e, char* err, int errlen) {
  if (err && errlen > 0) snprintf(err, (size_t)errlen, "%s", e.msg.c_str());
  return e.code;
}

}  // namespace

extern "C" {

// (height, width) of a JPEG after its EXIF orientation, after checking
// that it is one this decoder takes (headers up to the first scan).
int thc_jpeg_info(const uint8_t* data, int64_t n, int* height, int* width,
                  char* err, int errlen) {
  try {
    Jpeg j(data, (size_t)n);
    j.read_headers(true);
    oriented_size(j.orientation, j.height, j.width, height, width);
    return 0;
  } catch (const Error& e) {
    return report(e, err, errlen);
  } catch (const std::exception& e) {
    return report(Error{kErrFormat, e.what()}, err, errlen);
  }
}

// Decode into out, (height, width, 3) RGB uint8 in the oriented shape.
int thc_jpeg_decode(const uint8_t* data, int64_t n, uint8_t* out, int height,
                    int width, char* err, int errlen) {
  try {
    Jpeg j(data, (size_t)n);
    j.read_headers();
    if (!j.frame_done)
      fail(kErrFormat, "JPEG ends before every component was scanned");
    int oh, ow;
    oriented_size(j.orientation, j.height, j.width, &oh, &ow);
    if (oh != height || ow != width)
      fail(kErrArgs, "output size does not match the JPEG frame");
    j.decode(out);
    return 0;
  } catch (const Error& e) {
    return report(e, err, errlen);
  } catch (const std::exception& e) {
    return report(Error{kErrFormat, e.what()}, err, errlen);
  }
}

// One JPEG-compressed TIFF strip or tile (compression 7) as libtiff's
// JPEGPreDecode / JPEGDecode read it: the tables stream (tag 347; n_tables
// 0 for none) first, then the strip's own stream, whose frame must hold
// `ncomp` components, component 0 sampled hs x vs and the rest 1 x 1, and
// be `width` wide and `height` high (with taller, a last strip's frame may
// be higher: the rows past `height` are not read).  out: height x width x
// ncomp samples as libjpeg outputs them with no colour conversion, or
// with ycbcr (contiguous YCbCr: TIFFRGBAImage sets JPEGCOLORMODE_RGB)
// height x width x 3 RGB, libjpeg's YCbCr -> RGB.
int thc_tiff_jpeg(const uint8_t* tables, int64_t n_tables, const uint8_t* data,
                  int64_t n, int ycbcr, int hs, int vs, int ncomp,
                  int height, int width, int taller, uint8_t* out, char* err,
                  int errlen) {
  try {
    Jpeg j(tables, (size_t)n_tables);
    if (n_tables > 0) j.read_tables();
    j.next_stream(data, (size_t)n);
    j.read_headers();
    if (!j.frame_done)
      fail(kErrFormat, "JPEG ends before every component was scanned");
    if ((int)j.comps.size() != ncomp)
      fail(kErrFormat, "TIFF JPEG stream of another component count");
    for (size_t c = 0; c < j.comps.size(); c++)
      if (j.comps[c].h != (c ? 1 : hs) || j.comps[c].v != (c ? 1 : vs))
        fail(kErrFormat, "TIFF JPEG stream of other sampling factors");
    if (j.width != width || j.height < height ||
        (j.height > height && !taller))
      fail(kErrFormat, "TIFF JPEG stream of another size than its strip "
                       "or tile");
    if (ycbcr && ncomp != 3)
      fail(kErrFormat, "YCbCr TIFF JPEG stream of other than 3 components");
    if (j.progressive) j.output_coefficients();
    const int nc = ycbcr ? 3 : ncomp;
    std::vector<uint8_t> img((size_t)j.width * j.height * nc);
    if (ycbcr) {
      j.force_ycc = 1;
      j.to_rgb(img.data());
    } else {
      j.components(img.data());
    }
    memcpy(out, img.data(), (size_t)width * height * nc);
    return 0;
  } catch (const Error& e) {
    return report(e, err, errlen);
  } catch (const std::exception& e) {
    return report(Error{kErrFormat, e.what()}, err, errlen);
  }
}

// The EXIF orientation of a TIFF block (a PNG eXIf chunk), -1 for none.
int thc_exif_orientation(const uint8_t* tiff, int64_t n) {
  return tiff_orientation(tiff, (size_t)n);
}

// (height, width, 3) uint8 src, EXIF-oriented into dst (the oriented
// shape: height and width swap for 5-8).
void thc_orient_rgb(const uint8_t* src, int height, int width,
                    int orientation, uint8_t* dst) {
  orient_rgb(src, height, width, orientation, dst);
}

// Undo the PNG filters of `height` rows of `rowbytes` bytes each (the
// inflated stream: one filter-type byte, then the row), `bpp` bytes per
// complete pixel (at least 1).  out: height * rowbytes bytes.
int thc_png_unfilter(const uint8_t* in, int64_t n, int height,
                     int64_t rowbytes, int bpp, uint8_t* out, char* err,
                     int errlen) {
  try {
    if (n < (int64_t)height * (rowbytes + 1))
      fail(kErrFormat, "PNG image data (IDAT) is shorter than its rows");
    const uint8_t* prev = nullptr;
    for (int y = 0; y < height; y++) {
      const uint8_t* src = in + (size_t)y * (rowbytes + 1);
      int ft = src[0];
      src++;
      uint8_t* row = out + (size_t)y * rowbytes;
      switch (ft) {
        case 0:
          memcpy(row, src, rowbytes);
          break;
        case 1:  // Sub
          for (int64_t i = 0; i < rowbytes; i++)
            row[i] = (uint8_t)(src[i] + (i >= bpp ? row[i - bpp] : 0));
          break;
        case 2:  // Up
          for (int64_t i = 0; i < rowbytes; i++)
            row[i] = (uint8_t)(src[i] + (prev ? prev[i] : 0));
          break;
        case 3:  // Average
          for (int64_t i = 0; i < rowbytes; i++) {
            int a = i >= bpp ? row[i - bpp] : 0;
            int b = prev ? prev[i] : 0;
            row[i] = (uint8_t)(src[i] + ((a + b) >> 1));
          }
          break;
        case 4:  // Paeth
          for (int64_t i = 0; i < rowbytes; i++) {
            int a = i >= bpp ? row[i - bpp] : 0;
            int b = prev ? prev[i] : 0;
            int c = (prev && i >= bpp) ? prev[i - bpp] : 0;
            int p = a + b - c;
            int pa = p > a ? p - a : a - p;
            int pb = p > b ? p - b : b - p;
            int pc = p > c ? p - c : c - p;
            int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
            row[i] = (uint8_t)(src[i] + pred);
          }
          break;
        default: {
          char buf[64];
          snprintf(buf, sizeof buf, "bad PNG filter type %d (IDAT)", ft);
          fail(kErrFormat, buf);
        }
      }
      prev = row;
    }
    return 0;
  } catch (const Error& e) {
    return report(e, err, errlen);
  }
}


// Encode (height, width, 3) RGB uint8 as a baseline 4:2:0 JPEG at the IJG
// quality (1..100); *out is malloc'd, freed by thc_free.
int thc_jpeg_encode(const uint8_t* rgb, int height, int width, int quality,
                    uint8_t** out, int64_t* n, char* err, int errlen) {
  try {
    *out = nullptr;
    *n = 0;
    std::vector<uint8_t> o = encode_jpeg(rgb, height, width, quality);
    *out = static_cast<uint8_t*>(std::malloc(o.size()));
    if (!*out) fail(kErrArgs, "out of memory for the JPEG stream");
    std::memcpy(*out, o.data(), o.size());
    *n = (int64_t)o.size();
    return 0;
  } catch (const Error& e) {
    return report(e, err, errlen);
  } catch (const std::exception& e) {
    return report(Error{kErrFormat, e.what()}, err, errlen);
  }
}

// Palette indices of a run-length coded BMP (bits 8: RLE8, 4: RLE4) into
// out, (height, width) in file row order, as OpenCV decodes it.
int thc_bmp_rle(const uint8_t* in, int64_t n, int bits, int height,
                int width, uint8_t* out, char* err, int errlen) {
  try {
    RleBmp r{in, (size_t)n};
    r.height = height;
    r.width = width;
    r.out = out;
    memset(out, 0, (size_t)height * width);
    if (bits == 8)
      r.rle8();
    else
      r.rle4();
    return 0;
  } catch (const Error& e) {
    return report(e, err, errlen);
  }
}

// One TIFF strip or tile of nout bytes, PackBits-coded.
int thc_packbits(const uint8_t* in, int64_t n, uint8_t* out, int64_t nout,
                 char* err, int errlen) {
  try {
    packbits(in, (size_t)n, out, (size_t)nout);
    return 0;
  } catch (const Error& e) {
    return report(e, err, errlen);
  }
}

// One TIFF strip or tile of nout bytes, LZW-coded.
int thc_tiff_lzw(const uint8_t* in, int64_t n, uint8_t* out, int64_t nout,
                 char* err, int errlen) {
  try {
    tiff_lzw(in, (size_t)n, out, (size_t)nout);
    return 0;
  } catch (const Error& e) {
    return report(e, err, errlen);
  }
}

// (height, width) of a GIF's logical screen (kind 0) or a Radiance HDR
// image (kind 1), from its header.
int thc_image_info(int kind, const uint8_t* data, int64_t n, int* height,
                   int* width, char* err, int errlen) {
  try {
    if (kind == 0) {
      Gif g{data, (size_t)n};
      g.header();
      *height = g.height;
      *width = g.width;
    } else {
      Hdr r{data, (size_t)n};
      r.header();
      *height = r.height;
      *width = r.width;
    }
    return 0;
  } catch (const Error& e) {
    return report(e, err, errlen);
  }
}

// Decode a GIF's first frame on its screen (kind 0) or a Radiance HDR
// image (kind 1) into out, (height, width, 3) RGB uint8.
int thc_image_decode(int kind, const uint8_t* data, int64_t n, uint8_t* out,
                     int height, int width, char* err, int errlen) {
  try {
    if (kind == 0) {
      Gif g{data, (size_t)n};
      g.header();
      if (g.height != height || g.width != width)
        fail(kErrArgs, "output size does not match the GIF screen");
      g.decode(out);
    } else {
      Hdr r{data, (size_t)n};
      r.header();
      if (r.height != height || r.width != width)
        fail(kErrArgs, "output size does not match the HDR image");
      r.pos = 0;
      r.decode(out);
    }
    return 0;
  } catch (const Error& e) {
    return report(e, err, errlen);
  } catch (const std::exception& e) {
    return report(Error{kErrFormat, e.what()}, err, errlen);
  }
}

void thc_free(void* p) { std::free(p); }

}  // extern "C"

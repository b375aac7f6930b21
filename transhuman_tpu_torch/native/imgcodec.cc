// Host image codec of the PyTorch port: a sequential Huffman JPEG decoder,
// a baseline JPEG encoder and the PNG row unfilter, behind a plain C ABI
// (ctypes).
//
// The JPEG decoder covers baseline and extended sequential Huffman coding
// (SOF0/SOF1): 8-bit samples, 1 or 3 components, any sampling factors,
// restart intervals.  It reproduces libjpeg-turbo's default decode, what
// OpenCV's imread returns:
//   * the ISLOW integer IDCT (jidctint.c: CONST_BITS 13, PASS1_BITS 2) and
//     its range-limit table;
//   * fancy upsampling (jdsample.c: h2v1, h2v2 and h1v2 triangle filters
//     with their biases, edge rows and columns replicated at the
//     component's downsampled size), box replication otherwise;
//   * the fixed-point YCbCr -> RGB tables of jdcolor.c.
// Progressive, lossless, hierarchical and arithmetic coding, 12-bit
// samples, 4-component (CMYK/YCCK) files and an EXIF orientation other than
// 1 are refused with a message naming the marker.
//
// Every entry returns 0 on success or a non-zero code, with a message in
// the caller's buffer.

#include <algorithm>
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
  int bw = 0, bh = 0;             // blocks across / down, MCU-padded
  std::vector<uint8_t> plane;     // bw*8 x bh*8 samples
  int dc_pred = 0;
  bool decoded = false;
};

struct BitReader {
  const uint8_t* data;
  size_t n;
  size_t pos;
  uint64_t buf = 0;
  int bits = 0;
  bool hit_marker = false;

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
            // a marker ends the entropy-coded segment: feed zeros after it,
            // as libjpeg does for a premature end
            hit_marker = true;
            byte = 0;
          }
        } else {
          pos++;
        }
      }
      buf |= (uint64_t)byte << (56 - bits);
      bits += 8;
    }
  }
  int peek(int k) {
    if (bits < k) fill();
    return (int)(buf >> (64 - k));
  }
  void skip(int k) {
    buf <<= k;
    bits -= k;
  }
  int get(int k) {
    if (k == 0) return 0;
    int v = peek(k);
    skip(k);
    return v;
  }
  // byte-align and consume a restart marker
  void restart(int expect) {
    buf = 0;
    bits = 0;
    hit_marker = false;
    // skip to the marker (padding bits were 1s inside the last byte)
    while (pos + 1 < n && !(data[pos] == 0xFF && data[pos + 1] != 0x00 &&
                            data[pos + 1] != 0xFF))
      pos++;
    if (pos + 1 < n && data[pos + 1] == 0xD0 + expect) pos += 2;
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
    br.skip(16);
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

// jdmaster.c's post-IDCT range limit: x & 1023, then clamp with wrap
inline uint8_t idct_limit(int64_t x) {
  int y = (int)(x & 1023);
  if (y < 128) return (uint8_t)(y + 128);
  if (y < 512) return 255;
  if (y < 896) return 0;
  return (uint8_t)(y - 896);
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
struct Jpeg {
  const uint8_t* data;
  size_t n;
  size_t pos = 0;
  int width = 0, height = 0, precision = 0;
  int sof = -1;
  int hmax = 1, vmax = 1;
  int mcux = 0, mcuy = 0;
  int restart_interval = 0;
  bool jfif = false, adobe = false;
  int adobe_transform = -1;
  int orientation = 1;
  std::vector<Component> comps;
  uint16_t qt[4][64];  // natural order
  bool qt_defined[4] = {false, false, false, false};
  Huffman dc[4], ac[4];
  bool frame_done = false;

  Jpeg(const uint8_t* d, size_t len) : data(d), n(len) {}

  int u8() {
    if (pos >= n) fail(kErrFormat, "truncated JPEG header");
    return data[pos++];
  }
  int u16() {
    int a = u8();
    return (a << 8) | u8();
  }

  void parse_exif(size_t start, size_t len) {
    // APP1 "Exif\0\0" + TIFF: find IFD0's orientation tag (0x0112)
    if (len < 14 || memcmp(data + start, "Exif\0\0", 6) != 0) return;
    const uint8_t* t = data + start + 6;
    size_t tl = len - 6;
    bool le;
    if (t[0] == 'I' && t[1] == 'I') le = true;
    else if (t[0] == 'M' && t[1] == 'M') le = false;
    else return;
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
    if (ifd < 0) return;
    int count = rd16((size_t)ifd);
    for (int i = 0; i < count; i++) {
      size_t e = (size_t)ifd + 2 + 12 * (size_t)i;
      if (rd16(e) == 0x0112) {
        int v = rd16(e + 8);
        if (v > 0) orientation = v;
        return;
      }
    }
  }

  void read_headers() {
    if (n < 4 || data[0] != 0xFF || data[1] != 0xD8)
      fail(kErrFormat, "not a JPEG file (no SOI marker)");
    pos = 2;
    for (;;) {
      int b = u8();
      if (b != 0xFF) continue;  // garbage between markers: skip, as libjpeg
      int m = u8();
      while (m == 0xFF) m = u8();
      if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;
      if (m == 0xD9) fail(kErrFormat, "JPEG ends (EOI) before a scan");
      int len = u16();
      if (len < 2 || pos + len - 2 > n)
        fail(kErrFormat, "truncated JPEG marker segment");
      size_t seg = pos, end = pos + len - 2;
      if (m == 0xC0 || m == 0xC1) {
        read_sof(m);
      } else if (m == 0xC2 || m == 0xC6 || m == 0xCA || m == 0xCE) {
        char buf[96];
        snprintf(buf, sizeof buf,
                 "progressive JPEG (SOF%d, marker 0xFF%02X) is not supported",
                 m - 0xC0, m);
        fail(kErrUnsupported, buf);
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
        parse_exif(seg, len - 2);
        if (orientation != 1) {
          char buf[96];
          snprintf(buf, sizeof buf,
                   "EXIF orientation %d (APP1 marker 0xFFE1) is not "
                   "supported; only 1 (no rotation)", orientation);
          fail(kErrUnsupported, buf);
        }
      } else if (m == 0xEE) {
        if (len >= 14 && memcmp(data + seg, "Adobe", 5) == 0) {
          adobe = true;
          adobe_transform = data[seg + 11];
        }
      } else if (m == 0xDA) {
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
    if (nc == 4)
      fail(kErrUnsupported,
           "4-component (CMYK/YCCK) JPEG (SOF) is not supported");
    if (nc != 1 && nc != 3) {
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
    alloc_planes();
    int ns = u8();
    if (ns < 1 || ns > (int)comps.size())
      fail(kErrFormat, "bad JPEG scan (SOS)");
    std::vector<Component*> sc;
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
    }
    int ss = u8(), se = u8(), ahal = u8();
    if (ss != 0 || se != 63 || ahal != 0)
      fail(kErrFormat, "bad sequential JPEG scan (SOS spectral selection)");
    for (auto* c : sc) {
      if (!dc[c->td].defined || !ac[c->ta].defined)
        fail(kErrFormat, "JPEG scan uses an undefined Huffman table (DHT)");
      if (!qt_defined[c->tq])
        fail(kErrFormat,
             "JPEG component uses an undefined quantization table (DQT)");
      c->dc_pred = 0;
    }
    decode_scan(sc);
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
    idct_islow(coef, qt[c.tq], c.plane.data() + (size_t)by * 8 * stride +
                                   (size_t)bx * 8, stride);
  }

  void decode_scan(const std::vector<Component*>& sc) {
    BitReader br{data, n, pos};
    int mcus, per_row;
    if (sc.size() == 1) {
      Component& c = *sc[0];
      per_row = (c.width + 7) / 8;
      mcus = per_row * ((c.height + 7) / 8);
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
      }
      int mx = m % per_row, my = m / per_row;
      if (sc.size() == 1) {
        decode_block(br, *sc[0], mx, my);
      } else {
        for (auto* c : sc)
          for (int v = 0; v < c->v; v++)
            for (int h = 0; h < c->h; h++)
              decode_block(br, *c, mx * c->h + h, my * c->v + v);
      }
    }
    // continue after the scan: find the next marker
    pos = br.pos;
    while (pos + 1 < n && !(data[pos] == 0xFF && data[pos + 1] != 0x00 &&
                            !(data[pos + 1] >= 0xD0 && data[pos + 1] <= 0xD7)))
      pos++;
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

  void to_rgb(uint8_t* out) const {
    if (comps.size() == 1) {
      std::vector<uint8_t> g;
      upsample(comps[0], g);
      for (size_t i = 0; i < g.size(); i++)
        out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = g[i];
      return;
    }
    std::vector<uint8_t> p[3];
    for (int i = 0; i < 3; i++) upsample(comps[i], p[i]);
    bool rgb;
    if (jfif) rgb = false;
    else if (adobe) rgb = adobe_transform == 0;
    else rgb = comps[0].id == 82 && comps[1].id == 71 && comps[2].id == 66;
    size_t npx = (size_t)width * height;
    if (rgb) {
      for (size_t i = 0; i < npx; i++) {
        out[3 * i] = p[0][i];
        out[3 * i + 1] = p[1][i];
        out[3 * i + 2] = p[2][i];
      }
      return;
    }
    // jdcolor.c build_ycc_rgb_table / ycc_rgb_convert
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
      int y = p[0][i], cb = p[1][i], cr = p[2][i];
      out[3 * i] = clamp(y + cr_r[cr]);
      out[3 * i + 1] = clamp(y + (int)((cb_g[cb] + cr_g[cr]) >> SCALEBITS));
      out[3 * i + 2] = clamp(y + cb_b[cb]);
    }
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

int report(const Error& e, char* err, int errlen) {
  if (err && errlen > 0) snprintf(err, (size_t)errlen, "%s", e.msg.c_str());
  return e.code;
}

}  // namespace

extern "C" {

// (height, width) of a JPEG, after checking that it is one this decoder
// takes (headers up to the first scan).
int thc_jpeg_info(const uint8_t* data, int64_t n, int* height, int* width,
                  char* err, int errlen) {
  try {
    Jpeg j(data, (size_t)n);
    j.read_headers();
    *height = j.height;
    *width = j.width;
    return 0;
  } catch (const Error& e) {
    return report(e, err, errlen);
  } catch (const std::exception& e) {
    return report(Error{kErrFormat, e.what()}, err, errlen);
  }
}

// Decode into out, (height, width, 3) RGB uint8.
int thc_jpeg_decode(const uint8_t* data, int64_t n, uint8_t* out, int height,
                    int width, char* err, int errlen) {
  try {
    Jpeg j(data, (size_t)n);
    j.read_headers();
    if (!j.frame_done)
      fail(kErrFormat, "JPEG ends before every component was scanned");
    if (j.height != height || j.width != width)
      fail(kErrArgs, "output size does not match the JPEG frame");
    j.to_rgb(out);
    return 0;
  } catch (const Error& e) {
    return report(e, err, errlen);
  } catch (const std::exception& e) {
    return report(Error{kErrFormat, e.what()}, err, errlen);
  }
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

void thc_free(void* p) { std::free(p); }

}  // extern "C"

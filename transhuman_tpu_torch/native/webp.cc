// WebP decoder of the PyTorch port's host codec: the RIFF container (simple
// VP8 and VP8L files, VP8X with ALPH, ANIM and ANMF), VP8L lossless and
// VP8 lossy key frames, decoded to RGB as OpenCV 5's imread decodes them
// through libwebp's simple API (grfmt_webp.cpp; WebPDecodeBGRInto, or
// WebPAnimDecoder for an animation), then BGR -> RGB:
//   * VP8L (src/dec/vp8l_dec.c): the simple and normal prefix codes, the
//     colour cache, LZ77 backward references with the 120-entry distance
//     map, meta prefix codes, and the predictor (14 modes), cross-colour,
//     subtract-green and colour-indexing (pixel bundling) transforms;
//   * VP8 (src/dec/vp8_dec.c, tree_dec.c, quant_dec.c, frame_dec.c): the
//     boolean decoder, segments, 1 to 8 token partitions, coefficient
//     probability updates, the 16x16, 4x4 and chroma intra predictors, the
//     WHT and the 4x4 inverse transforms as libwebp's x86-64 build runs
//     them, the simple and normal loop filters, then the fancy upsampler
//     (UpsampleRgbLinePair) and the 14-bit VP8YUVToR/G/B of dsp/yuv.h; no
//     dithering;
//   * the alpha of a VP8X file (ALPH, raw or VP8L-coded) is decoded, so a
//     malformed one fails as libwebp fails, and dropped: imread's 3-channel
//     result keeps the colour as it is (no premultiplication);
//   * an animation reads as its first frame on a transparent black canvas
//     (WebPAnimDecoder's key frame), whatever the background colour and
//     blending say.
// The EXIF orientation of a VP8X file, which imread applies, is the
// caller's (data/image_formats.py).
// Every entry returns 0 on success or a non-zero code, with a message in
// the caller's buffer (2: a variant refused by name).

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

constexpr int kErrFormat = 1;       // malformed or truncated
constexpr int kErrUnsupported = 2;  // a variant refused by name
constexpr int kErrArgs = 3;         // the caller's buffers do not match

[[noreturn]] void bad(const char* what) {
  fail(kErrFormat, std::string("bad WebP ") + what);
}

inline uint32_t le24(const uint8_t* p) {
  return p[0] | p[1] << 8 | (uint32_t)p[2] << 16;
}
inline uint32_t le32(const uint8_t* p) {
  return le24(p) | (uint32_t)p[3] << 24;
}

// ================================================================ VP8L
// LSB-first bit reader; reading past the end gives zeros, and reading
// past the end of libwebp's 64-bit window (the data, or 8 bytes where the
// data is shorter) marks the stream as ended, which fails the decode
// (VP8LIsEndOfStream).
struct LBits {
  const uint8_t* d;
  size_t n;
  uint64_t pos = 0;  // bits consumed

  uint32_t peek(int nbits) const {
    size_t byte = (size_t)(pos >> 3);
    uint64_t v = 0;
    if (byte + 8 <= n) {
      memcpy(&v, d + byte, 8);  // little-endian hosts only (x86-64, arm64)
    } else {
      for (size_t i = 0; i < 8 && byte + i < n; i++)
        v |= (uint64_t)d[byte + i] << (8 * i);
    }
    return (uint32_t)(v >> (pos & 7)) & ((1u << nbits) - 1);
  }
  uint32_t read(int nbits) {
    uint32_t v = nbits ? peek(nbits) : 0;
    pos += nbits;
    return v;
  }
  bool eos() const { return pos > 8 * std::max<uint64_t>(n, 8); }
};

// A canonical prefix code (shorter codes first, symbols in order within a
// length; bits arrive most significant first): an 8-bit table for short
// codes, a walk down the lengths for the others.  A single used symbol is
// a code of 0 bits.
struct Prefix {
  static constexpr int kFast = 8;
  std::vector<uint16_t> sym;       // symbols by (length, value)
  uint16_t count[16] = {0};
  uint32_t fast[1 << kFast] = {0};  // length << 16 | symbol, 0: slow path
  int single = -1;

  // false for lengths that do not make a complete code
  bool build(const uint8_t* lengths, int n) {
    memset(count, 0, sizeof count);
    for (int s = 0; s < n; s++) count[lengths[s]]++;
    int used = n - count[0];
    if (used == 0) return false;
    sym.clear();
    for (int len = 1; len < 16; len++)
      for (int s = 0; s < n; s++)
        if (lengths[s] == len) sym.push_back((uint16_t)s);
    if (used == 1) {
      single = sym[0];
      return true;
    }
    int open = 1;
    for (int len = 1; len < 16; len++) {
      open = 2 * open - count[len];
      if (open < 0) return false;
    }
    if (open != 0) return false;
    count[0] = 0;
    memset(fast, 0, sizeof fast);
    int code = 0, k = 0;
    for (int len = 1; len <= kFast; len++) {
      for (int i = 0; i < count[len]; i++, code++, k++) {
        // the table is indexed by the next kFast bits, first bit lowest
        int rev = 0;
        for (int b = 0; b < len; b++) rev |= ((code >> (len - 1 - b)) & 1) << b;
        for (int f = rev; f < (1 << kFast); f += 1 << len)
          fast[f] = (uint32_t)len << 16 | sym[k];
      }
      code <<= 1;
    }
    return true;
  }

  int decode(LBits& br) const {
    if (single >= 0) return single;
    uint32_t bits = br.peek(15);
    uint32_t e = fast[bits & ((1 << kFast) - 1)];
    if (e) {
      br.pos += e >> 16;
      return (int)(e & 0xffff);
    }
    int code = 0, first = 0, index = 0;
    for (int len = 1; len < 16; len++) {
      code |= (bits >> (len - 1)) & 1;
      int c = count[len];
      if (code - first < c) {
        br.pos += len;
        return sym[index + code - first];
      }
      index += c;
      first = (first + c) << 1;
      code <<= 1;
    }
    return 0;  // unreachable for a complete code
  }
};

constexpr int kCodeLengthOrder[19] = {17, 18, 0, 1,  2,  3,  4,  5,  16, 6,
                                      7,  8,  9, 10, 11, 12, 13, 14, 15};
// RFC 9649 section 4.2.2: the (x, y) offsets of the first 120 distance
// codes
constexpr int8_t kDistanceMap[120][2] = {
    {0, 1},  {1, 0},  {1, 1},  {-1, 1}, {0, 2},  {2, 0},  {1, 2},  {-1, 2},
    {2, 1},  {-2, 1}, {2, 2},  {-2, 2}, {0, 3},  {3, 0},  {1, 3},  {-1, 3},
    {3, 1},  {-3, 1}, {2, 3},  {-2, 3}, {3, 2},  {-3, 2}, {0, 4},  {4, 0},
    {1, 4},  {-1, 4}, {4, 1},  {-4, 1}, {3, 3},  {-3, 3}, {2, 4},  {-2, 4},
    {4, 2},  {-4, 2}, {0, 5},  {3, 4},  {-3, 4}, {4, 3},  {-4, 3}, {5, 0},
    {1, 5},  {-1, 5}, {5, 1},  {-5, 1}, {2, 5},  {-2, 5}, {5, 2},  {-5, 2},
    {4, 4},  {-4, 4}, {3, 5},  {-3, 5}, {5, 3},  {-5, 3}, {0, 6},  {6, 0},
    {1, 6},  {-1, 6}, {6, 1},  {-6, 1}, {2, 6},  {-2, 6}, {6, 2},  {-6, 2},
    {4, 5},  {-4, 5}, {5, 4},  {-5, 4}, {3, 6},  {-3, 6}, {6, 3},  {-6, 3},
    {0, 7},  {7, 0},  {1, 7},  {-1, 7}, {5, 5},  {-5, 5}, {7, 1},  {-7, 1},
    {4, 6},  {-4, 6}, {6, 4},  {-6, 4}, {2, 7},  {-2, 7}, {7, 2},  {-7, 2},
    {3, 7},  {-3, 7}, {7, 3},  {-7, 3}, {5, 6},  {-5, 6}, {6, 5},  {-6, 5},
    {8, 0},  {4, 7},  {-4, 7}, {7, 4},  {-7, 4}, {8, 1},  {8, 2},  {6, 6},
    {-6, 6}, {8, 3},  {5, 7},  {-5, 7}, {7, 5},  {-7, 5}, {8, 4},  {6, 7},
    {-6, 7}, {7, 6},  {-7, 6}, {8, 5},  {7, 7},  {-7, 7}, {8, 6},  {8, 7}};

inline int subsample(int size, int bits) {
  return (size + (1 << bits) - 1) >> bits;
}

struct Transform {
  int type, bits, xsize, ysize;
  std::vector<uint32_t> data;
};

struct Vp8l {
  LBits br;
  std::vector<Transform> transforms;
  unsigned seen = 0;
  bool alpha = false;  // an ALPH chunk's stream

  explicit Vp8l(const uint8_t* d, size_t n) : br{d, n} {}

  void check() {
    if (br.eos()) bad("lossless data (ends early)");
  }

  // one prefix code of `alphabet` symbols
  void read_code(int alphabet, Prefix& code) {
    std::vector<uint8_t> lengths(alphabet, 0);
    if (br.read(1)) {  // simple code
      int nsym = br.read(1) + 1;
      int s = br.read(br.read(1) ? 8 : 1);
      if (s < alphabet) lengths[s] = 1;
      if (nsym == 2) {
        s = br.read(8);
        if (s < alphabet) lengths[s] = 1;
      }
    } else {
      uint8_t cl[19] = {0};
      int ncodes = br.read(4) + 4;
      for (int i = 0; i < ncodes; i++) cl[kCodeLengthOrder[i]] = br.read(3);
      Prefix lcode;
      if (!lcode.build(cl, 19)) bad("lossless code-length code");
      int max_symbol = alphabet;
      if (br.read(1)) {
        int nbits = 2 + 2 * br.read(3);
        max_symbol = 2 + br.read(nbits);
        if (max_symbol > alphabet) bad("lossless code lengths");
      }
      int prev = 8, s = 0;
      while (s < alphabet) {
        if (max_symbol-- == 0) break;
        int c = lcode.decode(br);
        if (c < 16) {
          lengths[s++] = (uint8_t)c;
          if (c) prev = c;
        } else {
          static const int extra[3] = {2, 3, 7}, offset[3] = {3, 3, 11};
          int repeat = br.read(extra[c - 16]) + offset[c - 16];
          if (s + repeat > alphabet) bad("lossless code lengths");
          int len = c == 16 ? prev : 0;
          while (repeat-- > 0) lengths[s++] = (uint8_t)len;
        }
        if (br.eos()) break;
      }
    }
    check();
    if (!code.build(lengths.data(), alphabet)) bad("lossless prefix code");
  }

  static int extra_value(LBits& br, int sym) {
    if (sym < 4) return sym + 1;
    int nbits = (sym - 2) >> 1;
    int offset = (2 + (sym & 1)) << nbits;
    return offset + br.read(nbits) + 1;
  }

  // An entropy-coded image of xsize * ysize ARGB pixels (the main image
  // when level0: transforms first, meta prefix codes allowed).
  std::vector<uint32_t> image(int xsize, int ysize, bool level0) {
    if (level0) {
      while (br.read(1)) read_transform(xsize, ysize);
    }
    int cache_bits = 0;
    if (br.read(1)) {
      cache_bits = br.read(4);
      if (cache_bits < 1 || cache_bits > 11) bad("lossless colour cache");
    }
    int meta_bits = 0, meta_xsize = 0, ngroups = 1;
    std::vector<uint32_t> meta;
    if (level0 && br.read(1)) {
      meta_bits = br.read(3) + 2;
      meta_xsize = subsample(xsize, meta_bits);
      meta = image(meta_xsize, subsample(ysize, meta_bits), false);
      for (uint32_t& m : meta) {
        m = (m >> 8) & 0xffff;
        ngroups = std::max(ngroups, (int)m + 1);
      }
    }
    check();
    const int cache_size = cache_bits ? 1 << cache_bits : 0;
    const int alphabets[5] = {256 + 24 + cache_size, 256, 256, 256, 40};
    std::vector<Prefix> codes((size_t)ngroups * 5);
    for (size_t i = 0; i < codes.size(); i++)
      read_code(alphabets[i % 5], codes[i]);
    // An alpha stream of one colour-indexing transform, no colour cache and
    // one-symbol red, blue and alpha codes goes through libwebp's 8-bit
    // DecodeAlphaData, which lets the last symbol read past the end
    bool lenient = level0 && alpha && cache_bits == 0 &&
                   transforms.size() == 1 && transforms[0].type == 3;
    for (size_t i = 0; lenient && i < codes.size(); i++)
      lenient = i % 5 == 0 || i % 5 == 4 || codes[i].single >= 0;
    std::vector<uint32_t> px((size_t)xsize * ysize);
    std::vector<uint32_t> cache(cache_size ? cache_size : 1, 0);
    const size_t total = px.size();
    size_t p = 0, cached = 0;
    int x = 0, y = 0;
    auto insert = [&]() {
      for (; cached < p; cached++)
        cache[(0x1e35a7bdu * px[cached]) >> (32 - cache_bits)] = px[cached];
    };
    while (p < total) {
      const Prefix* g = codes.data();
      if (meta_bits)
        g += 5 * (size_t)meta[(size_t)(y >> meta_bits) * meta_xsize +
                              (x >> meta_bits)];
      int c = g[0].decode(br);
      if (c < 256) {
        int r = g[1].decode(br), b = g[2].decode(br), a = g[3].decode(br);
        px[p++] = (uint32_t)a << 24 | r << 16 | c << 8 | b;
        if (++x == xsize) {
          x = 0;
          y++;
          if (cache_bits) insert();
        }
      } else if (c < 256 + 24) {
        int length = extra_value(br, c - 256);
        int dcode = extra_value(br, g[4].decode(br));
        int dist;
        if (dcode > 120) {
          dist = dcode - 120;
        } else {
          const int8_t* o = kDistanceMap[dcode - 1];
          dist = std::max(1, o[1] * xsize + o[0]);
        }
        if ((size_t)dist > p || (size_t)length > total - p)
          bad("lossless backward reference");
        for (int i = 0; i < length; i++, p++) px[p] = px[p - dist];
        x += length;
        while (x >= xsize) {
          x -= xsize;
          y++;
        }
        if (cache_bits) insert();
      } else {
        if (c - 280 >= cache_size) bad("lossless colour cache index");
        insert();
        px[p++] = cache[c - 280];
        if (++x == xsize) {
          x = 0;
          y++;
          if (cache_bits) insert();
        }
      }
      if (br.eos()) break;
    }
    if (!(lenient && p == total)) check();
    return px;
  }

  void read_transform(int& xsize, int ysize) {
    Transform t;
    t.type = br.read(2);
    if (seen & (1u << t.type)) bad("lossless stream (a transform twice)");
    seen |= 1u << t.type;
    t.xsize = xsize;
    t.ysize = ysize;
    t.bits = 0;
    if (t.type == 0 || t.type == 1) {  // predictor, cross-colour
      t.bits = br.read(3) + 2;
      t.data = image(subsample(xsize, t.bits), subsample(ysize, t.bits),
                     false);
    } else if (t.type == 3) {  // colour indexing
      int ncolours = br.read(8) + 1;
      t.bits = ncolours > 16 ? 0 : ncolours > 4 ? 1 : ncolours > 2 ? 2 : 3;
      std::vector<uint32_t> pal = image(ncolours, 1, false);
      // the table is delta-coded per byte; entries past it are 0
      t.data.assign((size_t)1 << (8 >> t.bits), 0);
      uint8_t* dst = reinterpret_cast<uint8_t*>(t.data.data());
      const uint8_t* src = reinterpret_cast<const uint8_t*>(pal.data());
      for (int i = 0; i < 4 * ncolours; i++)
        dst[i] = (uint8_t)(src[i] + (i >= 4 ? dst[i - 4] : 0));
      xsize = subsample(xsize, t.bits);
    }
    transforms.push_back(std::move(t));
  }

  static uint32_t add(uint32_t a, uint32_t b) {
    uint32_t ag = (a & 0xff00ff00u) + (b & 0xff00ff00u);
    uint32_t rb = (a & 0x00ff00ffu) + (b & 0x00ff00ffu);
    return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
  }
  static uint32_t avg2(uint32_t a, uint32_t b) {
    return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b);
  }
  static int clip255(int v) { return v < 0 ? 0 : v > 255 ? 255 : v; }
  static uint32_t select(uint32_t a, uint32_t b, uint32_t c) {
    int d = 0;
    for (int s = 0; s < 32; s += 8) {
      int ac = (int)((a >> s) & 255), bc = (int)((b >> s) & 255),
          cc = (int)((c >> s) & 255);
      d += std::abs(bc - cc) - std::abs(ac - cc);
    }
    return d <= 0 ? a : b;
  }
  static uint32_t predict(int mode, const uint32_t* out, const uint32_t* top) {
    uint32_t L = out[-1], T = top[0], TR = top[1], TL = top[-1];
    switch (mode) {
      case 1: return L;
      case 2: return T;
      case 3: return TR;
      case 4: return TL;
      case 5: return avg2(avg2(L, TR), T);
      case 6: return avg2(L, TL);
      case 7: return avg2(L, T);
      case 8: return avg2(TL, T);
      case 9: return avg2(T, TR);
      case 10: return avg2(avg2(L, TL), avg2(T, TR));
      case 11: return select(T, L, TL);
      case 12: {
        uint32_t r = 0;
        for (int s = 0; s < 32; s += 8)
          r |= (uint32_t)clip255((int)((L >> s) & 255) + (int)((T >> s) & 255) -
                                 (int)((TL >> s) & 255)) << s;
        return r;
      }
      case 13: {
        uint32_t a = avg2(L, T), r = 0;
        for (int s = 0; s < 32; s += 8) {
          int ac = (int)((a >> s) & 255), cc = (int)((TL >> s) & 255);
          r |= (uint32_t)clip255(ac + (ac - cc) / 2) << s;
        }
        return r;
      }
      default: return 0xff000000u;  // 0, and 14 and 15
    }
  }

  // the inverse transforms, last read first; px grows to the full width
  void invert(std::vector<uint32_t>& px) {
    for (size_t k = transforms.size(); k-- > 0;) {
      const Transform& t = transforms[k];
      const int w = t.xsize, h = t.ysize;
      if (t.type == 0) {
        uint32_t* o = px.data();
        const int tiles = subsample(w, t.bits);
        o[0] = add(o[0], 0xff000000u);
        for (int x = 1; x < w; x++) o[x] = add(o[x], o[x - 1]);
        for (int y = 1; y < h; y++) {
          uint32_t* row = o + (size_t)y * w;
          const uint32_t* top = row - w;
          const uint32_t* modes = t.data.data() + (size_t)(y >> t.bits) * tiles;
          row[0] = add(row[0], top[0]);
          for (int x = 1; x < w; x++) {
            int mode = (modes[x >> t.bits] >> 8) & 15;
            row[x] = add(row[x], predict(mode, row + x, top + x));
          }
        }
      } else if (t.type == 1) {
        const int tiles = subsample(w, t.bits);
        for (int y = 0; y < h; y++) {
          uint32_t* row = px.data() + (size_t)y * w;
          const uint32_t* codes = t.data.data() + (size_t)(y >> t.bits) * tiles;
          for (int x = 0; x < w; x++) {
            uint32_t code = codes[x >> t.bits];
            int8_t g2r = (int8_t)(code & 255), g2b = (int8_t)((code >> 8) & 255),
                   r2b = (int8_t)((code >> 16) & 255);
            uint32_t argb = row[x];
            int8_t green = (int8_t)(argb >> 8);
            int red = (argb >> 16) & 255, blue = argb & 255;
            red = (red + ((g2r * green) >> 5)) & 255;
            blue += (g2b * green) >> 5;
            blue += (r2b * (int8_t)red) >> 5;
            blue &= 255;
            row[x] = (argb & 0xff00ff00u) | (uint32_t)red << 16 | (uint32_t)blue;
          }
        }
      } else if (t.type == 2) {
        for (uint32_t& v : px) {
          uint32_t g = (v >> 8) & 255;
          uint32_t rb = ((v & 0x00ff00ffu) + (g << 16 | g)) & 0x00ff00ffu;
          v = (v & 0xff00ff00u) | rb;
        }
      } else {
        const int packed_w = subsample(w, t.bits);
        std::vector<uint32_t> out((size_t)w * h);
        const int per = 1 << t.bits, bpp = 8 >> t.bits,
                  bmask = (1 << bpp) - 1;
        for (int y = 0; y < h; y++) {
          const uint32_t* src = px.data() + (size_t)y * packed_w;
          uint32_t* dst = out.data() + (size_t)y * w;
          uint32_t packed = 0;
          for (int x = 0; x < w; x++) {
            if ((x & (per - 1)) == 0) packed = (*src++ >> 8) & 255;
            dst[x] = t.data[packed & bmask];
            packed >>= bpp;
          }
        }
        px.swap(out);
      }
    }
  }

  // the ARGB pixels of an image stream of width * height (a VP8L file's
  // after its 5-byte header, or an ALPH chunk's lossless data)
  std::vector<uint32_t> decode(int width, int height) {
    std::vector<uint32_t> px = image(width, height, true);
    invert(px);
    return px;
  }
};

// (width, height) of a VP8L bitstream's header; fails for a bad one
void vp8l_header(const uint8_t* d, size_t n, int* w, int* h) {
  if (n < 5 || d[0] != 0x2f) bad("lossless header");
  if (d[4] >> 5)
    fail(kErrUnsupported, "WebP lossless version " + std::to_string(d[4] >> 5));
  uint32_t v = le32(d + 1);
  *w = (int)(v & 0x3fff) + 1;
  *h = (int)((v >> 14) & 0x3fff) + 1;
}

std::vector<uint32_t> vp8l_argb(const uint8_t* d, size_t n, int* w, int* h) {
  vp8l_header(d, n, w, h);
  Vp8l dec(d, n);
  dec.br.pos = 40;
  return dec.decode(*w, *h);
}

// ================================================================= VP8
// RFC 6386 section 13.4: the probabilities that a coefficient probability
// is updated, [type][band][context][node]
const uint8_t kCoeffsUpdateProba[4][8][3][11] = {{{{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
   {{176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255},
     {249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255}},
   {{255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255},
     {234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
   {{255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
   {{255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
   {{255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
   {{255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255},
     {250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255},
     {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
   {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}}},
 {{{217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255},
     {234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255}},
   {{255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255}},
   {{255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
   {{255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
   {{255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
   {{255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
   {{255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255},
     {250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
   {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}}},
 {{{186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255},
     {234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255},
     {251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255}},
   {{255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255}},
   {{255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
   {{255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
   {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
   {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
   {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
   {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}}},
 {{{248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255},
     {248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255}},
   {{255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255},
     {246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255},
     {252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255}},
   {{255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255},
     {248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255},
     {253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255}},
   {{255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
   {{255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255},
     {252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
   {{255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
   {{255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255},
     {250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
   {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}}}};
// RFC 6386 section 13.5: the default coefficient probabilities
const uint8_t kCoeffsProba0[4][8][3][11] = {{{{128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
     {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
     {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}},
   {{253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128},
     {189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128},
     {106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128}},
   {{1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128},
     {181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128},
     {78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128}},
   {{1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128},
     {184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128},
     {77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128}},
   {{1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128},
     {170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128},
     {37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128}},
   {{1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128},
     {207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128},
     {102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128}},
   {{1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128},
     {177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128},
     {80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128}},
   {{1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
     {246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
     {255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}}},
 {{{198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62},
     {131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1},
     {68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128}},
   {{1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128},
     {184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128},
     {81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128}},
   {{1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128},
     {99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128},
     {23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128}},
   {{1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128},
     {109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128},
     {44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128}},
   {{1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128},
     {94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128},
     {22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128}},
   {{1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128},
     {124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128},
     {35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128}},
   {{1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128},
     {121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128},
     {45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128}},
   {{1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128},
     {203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128},
     {137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128}}},
 {{{253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128},
     {175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128},
     {73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128}},
   {{1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128},
     {239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128},
     {155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128}},
   {{1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128},
     {201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128},
     {69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128}},
   {{1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128},
     {223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128},
     {141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128}},
   {{1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128},
     {190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128},
     {149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
   {{1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128},
     {247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128},
     {240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
   {{1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128},
     {213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128},
     {55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
   {{128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
     {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
     {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}}},
 {{{202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255},
     {126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128},
     {61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128}},
   {{1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128},
     {166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128},
     {39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128}},
   {{1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128},
     {124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128},
     {24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128}},
   {{1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128},
     {149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128},
     {28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128}},
   {{1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128},
     {123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128},
     {20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128}},
   {{1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128},
     {168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128},
     {47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128}},
   {{1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128},
     {141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128},
     {42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128}},
   {{1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
     {244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
     {238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128}}}};
// RFC 6386 section 11.5: the key frame 4x4 mode probabilities,
// [above][left][node], the modes in libwebp's order (DC, TM, VE, HE, RD,
// VR, LD, VL, HD, HU)
const uint8_t kBModesProba[10][10][9] = {{{231, 120, 48, 89, 115, 113, 120, 152, 112},
   {152, 179, 64, 126, 170, 118, 46, 70, 95},
   {175, 69, 143, 80, 85, 82, 72, 155, 103},
   {56, 58, 10, 171, 218, 189, 17, 13, 152},
   {114, 26, 17, 163, 44, 195, 21, 10, 173},
   {121, 24, 80, 195, 26, 62, 44, 64, 85},
   {144, 71, 10, 38, 171, 213, 144, 34, 26},
   {170, 46, 55, 19, 136, 160, 33, 206, 71},
   {63, 20, 8, 114, 114, 208, 12, 9, 226},
   {81, 40, 11, 96, 182, 84, 29, 16, 36}},
 {{134, 183, 89, 137, 98, 101, 106, 165, 148},
   {72, 187, 100, 130, 157, 111, 32, 75, 80},
   {66, 102, 167, 99, 74, 62, 40, 234, 128},
   {41, 53, 9, 178, 241, 141, 26, 8, 107},
   {74, 43, 26, 146, 73, 166, 49, 23, 157},
   {65, 38, 105, 160, 51, 52, 31, 115, 128},
   {104, 79, 12, 27, 217, 255, 87, 17, 7},
   {87, 68, 71, 44, 114, 51, 15, 186, 23},
   {47, 41, 14, 110, 182, 183, 21, 17, 194},
   {66, 45, 25, 102, 197, 189, 23, 18, 22}},
 {{88, 88, 147, 150, 42, 46, 45, 196, 205},
   {43, 97, 183, 117, 85, 38, 35, 179, 61},
   {39, 53, 200, 87, 26, 21, 43, 232, 171},
   {56, 34, 51, 104, 114, 102, 29, 93, 77},
   {39, 28, 85, 171, 58, 165, 90, 98, 64},
   {34, 22, 116, 206, 23, 34, 43, 166, 73},
   {107, 54, 32, 26, 51, 1, 81, 43, 31},
   {68, 25, 106, 22, 64, 171, 36, 225, 114},
   {34, 19, 21, 102, 132, 188, 16, 76, 124},
   {62, 18, 78, 95, 85, 57, 50, 48, 51}},
 {{193, 101, 35, 159, 215, 111, 89, 46, 111},
   {60, 148, 31, 172, 219, 228, 21, 18, 111},
   {112, 113, 77, 85, 179, 255, 38, 120, 114},
   {40, 42, 1, 196, 245, 209, 10, 25, 109},
   {88, 43, 29, 140, 166, 213, 37, 43, 154},
   {61, 63, 30, 155, 67, 45, 68, 1, 209},
   {100, 80, 8, 43, 154, 1, 51, 26, 71},
   {142, 78, 78, 16, 255, 128, 34, 197, 171},
   {41, 40, 5, 102, 211, 183, 4, 1, 221},
   {51, 50, 17, 168, 209, 192, 23, 25, 82}},
 {{138, 31, 36, 171, 27, 166, 38, 44, 229},
   {67, 87, 58, 169, 82, 115, 26, 59, 179},
   {63, 59, 90, 180, 59, 166, 93, 73, 154},
   {40, 40, 21, 116, 143, 209, 34, 39, 175},
   {47, 15, 16, 183, 34, 223, 49, 45, 183},
   {46, 17, 33, 183, 6, 98, 15, 32, 183},
   {57, 46, 22, 24, 128, 1, 54, 17, 37},
   {65, 32, 73, 115, 28, 128, 23, 128, 205},
   {40, 3, 9, 115, 51, 192, 18, 6, 223},
   {87, 37, 9, 115, 59, 77, 64, 21, 47}},
 {{104, 55, 44, 218, 9, 54, 53, 130, 226},
   {64, 90, 70, 205, 40, 41, 23, 26, 57},
   {54, 57, 112, 184, 5, 41, 38, 166, 213},
   {30, 34, 26, 133, 152, 116, 10, 32, 134},
   {39, 19, 53, 221, 26, 114, 32, 73, 255},
   {31, 9, 65, 234, 2, 15, 1, 118, 73},
   {75, 32, 12, 51, 192, 255, 160, 43, 51},
   {88, 31, 35, 67, 102, 85, 55, 186, 85},
   {56, 21, 23, 111, 59, 205, 45, 37, 192},
   {55, 38, 70, 124, 73, 102, 1, 34, 98}},
 {{125, 98, 42, 88, 104, 85, 117, 175, 82},
   {95, 84, 53, 89, 128, 100, 113, 101, 45},
   {75, 79, 123, 47, 51, 128, 81, 171, 1},
   {57, 17, 5, 71, 102, 57, 53, 41, 49},
   {38, 33, 13, 121, 57, 73, 26, 1, 85},
   {41, 10, 67, 138, 77, 110, 90, 47, 114},
   {115, 21, 2, 10, 102, 255, 166, 23, 6},
   {101, 29, 16, 10, 85, 128, 101, 196, 26},
   {57, 18, 10, 102, 102, 213, 34, 20, 43},
   {117, 20, 15, 36, 163, 128, 68, 1, 26}},
 {{102, 61, 71, 37, 34, 53, 31, 243, 192},
   {69, 60, 71, 38, 73, 119, 28, 222, 37},
   {68, 45, 128, 34, 1, 47, 11, 245, 171},
   {62, 17, 19, 70, 146, 85, 55, 62, 70},
   {37, 43, 37, 154, 100, 163, 85, 160, 1},
   {63, 9, 92, 136, 28, 64, 32, 201, 85},
   {75, 15, 9, 9, 64, 255, 184, 119, 16},
   {86, 6, 28, 5, 64, 255, 25, 248, 1},
   {56, 8, 17, 132, 137, 255, 55, 116, 128},
   {58, 15, 20, 82, 135, 57, 26, 121, 40}},
 {{164, 50, 31, 137, 154, 133, 25, 35, 218},
   {51, 103, 44, 131, 131, 123, 31, 6, 158},
   {86, 40, 64, 135, 148, 224, 45, 183, 128},
   {22, 26, 17, 131, 240, 154, 14, 1, 209},
   {45, 16, 21, 91, 64, 222, 7, 1, 197},
   {56, 21, 39, 155, 60, 138, 23, 102, 213},
   {83, 12, 13, 54, 192, 255, 68, 47, 28},
   {85, 26, 85, 85, 128, 128, 32, 146, 171},
   {18, 11, 7, 63, 144, 171, 4, 4, 246},
   {35, 27, 10, 146, 174, 171, 12, 26, 128}},
 {{190, 80, 35, 99, 180, 80, 126, 54, 45},
   {85, 126, 47, 87, 176, 51, 41, 20, 32},
   {101, 75, 128, 139, 118, 146, 116, 128, 85},
   {56, 41, 15, 176, 236, 85, 37, 9, 62},
   {71, 30, 17, 119, 118, 255, 17, 18, 138},
   {101, 38, 60, 138, 55, 70, 43, 26, 142},
   {146, 36, 19, 30, 171, 255, 97, 27, 20},
   {138, 45, 61, 62, 219, 1, 81, 188, 64},
   {32, 41, 20, 117, 151, 142, 20, 21, 163},
   {112, 19, 12, 61, 195, 128, 48, 4, 24}}};

constexpr uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
// band of each coefficient position (a 17th entry for the position after
// the last)
constexpr uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
constexpr uint8_t kCat3[] = {173, 148, 140, 0};
constexpr uint8_t kCat4[] = {176, 155, 140, 135, 0};
constexpr uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
constexpr uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
constexpr const uint8_t* kCat3456[4] = {kCat3, kCat4, kCat5, kCat6};
// RFC 6386 section 14.1: dequantization of the quantizer indices
constexpr uint8_t kDcTable[128] = {
    4,   5,   6,   7,   8,   9,   10,  10,  11,  12,  13,  14,  15,  16,  17,
    17,  18,  19,  20,  20,  21,  21,  22,  22,  23,  23,  24,  25,  25,  26,
    27,  28,  29,  30,  31,  32,  33,  34,  35,  36,  37,  37,  38,  39,  40,
    41,  42,  43,  44,  45,  46,  46,  47,  48,  49,  50,  51,  52,  53,  54,
    55,  56,  57,  58,  59,  60,  61,  62,  63,  64,  65,  66,  67,  68,  69,
    70,  71,  72,  73,  74,  75,  76,  76,  77,  78,  79,  80,  81,  82,  83,
    84,  85,  86,  87,  88,  89,  91,  93,  95,  96,  98,  100, 101, 102, 104,
    106, 108, 110, 112, 114, 116, 118, 122, 124, 126, 128, 130, 132, 134, 136,
    138, 140, 143, 145, 148, 151, 154, 157};
constexpr uint16_t kAcTable[128] = {
    4,   5,   6,   7,   8,   9,   10,  11,  12,  13,  14,  15,  16,  17,  18,
    19,  20,  21,  22,  23,  24,  25,  26,  27,  28,  29,  30,  31,  32,  33,
    34,  35,  36,  37,  38,  39,  40,  41,  42,  43,  44,  45,  46,  47,  48,
    49,  50,  51,  52,  53,  54,  55,  56,  57,  58,  60,  62,  64,  66,  68,
    70,  72,  74,  76,  78,  80,  82,  84,  86,  88,  90,  92,  94,  96,  98,
    100, 102, 104, 106, 108, 110, 112, 114, 116, 119, 122, 125, 128, 131, 134,
    137, 140, 143, 146, 149, 152, 155, 158, 161, 164, 167, 170, 173, 177, 181,
    185, 189, 193, 197, 201, 205, 209, 213, 217, 221, 225, 229, 234, 239, 245,
    249, 254, 259, 264, 269, 274, 279, 284};

// libwebp's mode numbers: 4x4 modes DC, TM, VE, HE, RD, VR, LD, VL, HD, HU;
// the 16x16 and chroma modes DC, TM, V (= VE), H (= HE)
enum { B_DC, B_TM, B_VE, B_HE, B_RD, B_VR, B_LD, B_VL, B_HD, B_HU };
enum { DC_NOTOP = 4, DC_NOLEFT, DC_NOTOPLEFT };

// libwebp's boolean decoder (bit_reader_utils, x86-64 build): a 64-bit
// value refilled 7 bytes at a time while 8 remain (the shift drops what a
// stream that is not a valid arithmetic code leaves above the window),
// then byte by byte; needing a byte past the end shifts in zeros and marks
// the reader as ended (eof), which fails the partition.  Sign bits go
// through VP8GetSigned's own arithmetic, which a valid stream cannot tell
// from a bit at probability 128.
struct BoolDec {
  const uint8_t* d = nullptr;
  const uint8_t* end = nullptr;
  uint64_t value = 0;
  uint32_t range = 255 - 1;
  int bits = -8;
  bool eof = false;

  void init(const uint8_t* p, size_t n) {
    d = p;
    end = p + n;
    value = 0;
    range = 254;
    bits = -8;
    eof = false;
    load();
  }
  void load() {
    if (end - d >= 8) {
      uint64_t v = 0;
      for (int i = 0; i < 7; i++) v = v << 8 | d[i];
      d += 7;
      value = v | value << 56;
      bits += 56;
    } else if (d < end) {
      value = value << 8 | *d++;
      bits += 8;
    } else if (!eof) {
      value <<= 8;
      bits += 8;
      eof = true;
    } else {
      bits = 0;
    }
  }
  int bit(int prob) {
    if (bits < 0) load();
    uint32_t r = range;
    const uint32_t split = (r * (uint32_t)prob) >> 8;
    const uint32_t v = (uint32_t)(value >> bits);
    int b = v > split;
    if (b) {
      r -= split;
      value -= (uint64_t)(split + 1) << bits;
    } else {
      r = split + 1;
    }
    int shift = 7 ^ (31 - __builtin_clz(r));
    r <<= shift;
    bits -= shift;
    range = r - 1;
    return b;
  }
  // VP8GetSigned: v or -v
  int sign(int v) {
    if (bits < 0) load();
    const int pos = bits;
    const uint32_t split = range >> 1;
    const uint32_t val = (uint32_t)(value >> pos);
    const int32_t mask = (int32_t)(split - val) >> 31;
    bits -= 1;
    range += (uint32_t)mask;
    range |= 1;
    value -= (uint64_t)((split + 1) & (uint32_t)mask) << pos;
    return (v ^ mask) - mask;
  }
  int value_bits(int n) {
    int v = 0;
    while (n-- > 0) v |= bit(0x80) << n;
    return v;
  }
  int signed_value(int n) {
    int v = value_bits(n);
    return bit(0x80) ? -v : v;
  }
};

inline uint8_t clip8(int v) { return v < 0 ? 0 : v > 255 ? 255 : (uint8_t)v; }

constexpr int BPS = 32;  // the stride of the macroblock work area

struct MBData {
  int16_t coeffs[384];
  uint8_t is_i4x4, segment, skip, uvmode;
  uint8_t imodes[16];
  // NzCodeBits of each luma block (3: coefficients past the third, 2: only
  // the first three, 1: only the DC, 0: none), and of each chroma plane
  // (2: some block has AC coefficients, 1: DC only, 0: none): which inverse
  // transform reconstructs the block, as DoTransform and DoUVTransform
  // choose it
  uint8_t ycode[16], uvcode[2];
};

struct FInfo {
  int limit = 0, ilevel = 0, hev = 0;
  bool inner = false;
};

struct Vp8 {
  int width = 0, height = 0, mbw = 0, mbh = 0;
  BoolDec br;
  BoolDec parts[8];
  int nparts = 1;
  // segments and filter header
  bool use_segment = false, update_map = false, absolute_delta = true;
  int seg_quant[4] = {0}, seg_filter[4] = {0};
  uint8_t seg_proba[3] = {255, 255, 255};
  int filter_simple = 0, filter_level = 0, sharpness = 0;
  bool use_lf_delta = false;
  int ref_lf_delta[4] = {0}, mode_lf_delta[4] = {0};
  int filter_type = 0;
  struct Quant {
    int y1[2], y2[2], uv[2];
  } dqm[4];
  uint8_t proba[4][8][3][11];
  bool use_skip = false;
  int skip_p = 0;
  FInfo fstrengths[4][2];
  // planes at whole macroblocks
  std::vector<uint8_t> Y, U, V;
  int ystride = 0, uvstride = 0;

  // VP8GetInfo on the chunk's `chunk_n` bytes, then VP8GetHeaders on the
  // `n` readable from d
  void headers(const uint8_t* d, size_t chunk_n, size_t n) {
    if (n < 10) bad("lossy frame (too short)");
    uint32_t bits = le24(d);
    bool key = !(bits & 1);
    int profile = (bits >> 1) & 7;
    bool show = (bits >> 4) & 1;
    uint32_t part0 = bits >> 5;
    if (!key) bad("lossy frame (not a key frame)");
    if (profile > 3) bad("lossy frame (profile)");
    if (!show) bad("lossy frame (not shown)");
    if (d[3] != 0x9d || d[4] != 0x01 || d[5] != 0x2a)
      bad("lossy frame (start code)");
    width = (d[6] | d[7] << 8) & 0x3fff;
    height = (d[8] | d[9] << 8) & 0x3fff;
    if (!width || !height) bad("lossy frame (0 pixels)");
    d += 10;
    n -= 10;
    if (part0 >= chunk_n || part0 > n) bad("lossy frame (partition length)");
    mbw = (width + 15) >> 4;
    mbh = (height + 15) >> 4;
    br.init(d, part0);
    const uint8_t* rest = d + part0;
    size_t rest_n = n - part0;
    br.bit(0x80);  // colour space
    br.bit(0x80);  // clamping type
    // segments
    use_segment = br.bit(0x80);
    if (use_segment) {
      update_map = br.bit(0x80);
      if (br.bit(0x80)) {
        absolute_delta = br.bit(0x80);
        for (int s = 0; s < 4; s++)
          seg_quant[s] = br.bit(0x80) ? br.signed_value(7) : 0;
        for (int s = 0; s < 4; s++)
          seg_filter[s] = br.bit(0x80) ? br.signed_value(6) : 0;
      }
      if (update_map)
        for (int s = 0; s < 3; s++)
          seg_proba[s] = br.bit(0x80) ? (uint8_t)br.value_bits(8) : 255;
    }
    if (br.eof) bad("lossy frame (segment header)");
    // filter
    filter_simple = br.bit(0x80);
    filter_level = br.value_bits(6);
    sharpness = br.value_bits(3);
    use_lf_delta = br.bit(0x80);
    if (use_lf_delta && br.bit(0x80)) {
      for (int i = 0; i < 4; i++)
        if (br.bit(0x80)) ref_lf_delta[i] = br.signed_value(6);
      for (int i = 0; i < 4; i++)
        if (br.bit(0x80)) mode_lf_delta[i] = br.signed_value(6);
    }
    filter_type = filter_level == 0 ? 0 : filter_simple ? 1 : 2;
    if (br.eof) bad("lossy frame (filter header)");
    // token partitions
    nparts = 1 << br.value_bits(2);
    size_t last = (size_t)nparts - 1;
    if (rest_n < 3 * last) bad("lossy frame (partitions)");
    const uint8_t* sz = rest;
    const uint8_t* start = rest + 3 * last;
    size_t left = rest_n - 3 * last;
    for (size_t p = 0; p < last; p++) {
      size_t psize = le24(sz + 3 * p);
      if (psize > left) psize = left;
      parts[p].init(start, psize);
      start += psize;
      left -= psize;
    }
    parts[last].init(start, left);
    if (start >= rest + rest_n) bad("lossy frame (partitions end early)");
    // quantizers
    int base = br.value_bits(7);
    int dq[5];
    for (int& v : dq) v = br.bit(0x80) ? br.signed_value(4) : 0;
    for (int s = 0; s < 4; s++) {
      int q;
      if (use_segment) {
        q = seg_quant[s] + (absolute_delta ? 0 : base);
      } else {
        if (s > 0) {
          dqm[s] = dqm[0];
          continue;
        }
        q = base;
      }
      auto clip = [](int v, int m) { return v < 0 ? 0 : v > m ? m : v; };
      Quant& m = dqm[s];
      m.y1[0] = kDcTable[clip(q + dq[0], 127)];
      m.y1[1] = kAcTable[clip(q, 127)];
      m.y2[0] = kDcTable[clip(q + dq[1], 127)] * 2;
      m.y2[1] = (kAcTable[clip(q + dq[2], 127)] * 101581) >> 16;
      if (m.y2[1] < 8) m.y2[1] = 8;
      m.uv[0] = kDcTable[clip(q + dq[3], 117)];
      m.uv[1] = kAcTable[clip(q + dq[4], 127)];
    }
    br.bit(0x80);  // refresh entropy probabilities: ignored
    for (int t = 0; t < 4; t++)
      for (int b = 0; b < 8; b++)
        for (int c = 0; c < 3; c++)
          for (int p = 0; p < 11; p++)
            proba[t][b][c][p] = br.bit(kCoeffsUpdateProba[t][b][c][p])
                                    ? (uint8_t)br.value_bits(8)
                                    : kCoeffsProba0[t][b][c][p];
    use_skip = br.bit(0x80);
    if (use_skip) skip_p = br.value_bits(8);
    filter_strengths();
  }

  void filter_strengths() {
    if (!filter_type) return;
    for (int s = 0; s < 4; s++) {
      int base = filter_level;
      if (use_segment) base = seg_filter[s] + (absolute_delta ? 0 : filter_level);
      for (int i4 = 0; i4 <= 1; i4++) {
        FInfo& f = fstrengths[s][i4];
        int level = base;
        if (use_lf_delta) {
          level += ref_lf_delta[0];
          if (i4) level += mode_lf_delta[0];
        }
        level = level < 0 ? 0 : level > 63 ? 63 : level;
        if (level > 0) {
          int ilevel = level;
          if (sharpness > 0) {
            ilevel >>= sharpness > 4 ? 2 : 1;
            if (ilevel > 9 - sharpness) ilevel = 9 - sharpness;
          }
          if (ilevel < 1) ilevel = 1;
          f.ilevel = ilevel;
          f.limit = 2 * level + ilevel;
          f.hev = level >= 40 ? 2 : level >= 15 ? 1 : 0;
        } else {
          f.limit = 0;
        }
        f.inner = i4;
      }
    }
  }

  // ---------------------------------------------------- modes, tokens
  std::vector<uint8_t> intra_t;  // 4 per macroblock column
  uint8_t intra_l[4];

  void parse_modes(MBData& b, int mbx) {
    uint8_t* top = intra_t.data() + 4 * mbx;
    uint8_t* left = intra_l;
    b.segment = update_map ? (!br.bit(seg_proba[0]) ? br.bit(seg_proba[1])
                                                    : br.bit(seg_proba[2]) + 2)
                           : 0;
    b.skip = use_skip ? br.bit(skip_p) : 0;
    b.is_i4x4 = !br.bit(145);
    if (!b.is_i4x4) {
      int ymode = br.bit(156) ? (br.bit(128) ? B_TM : B_HE)
                              : (br.bit(163) ? B_VE : B_DC);
      b.imodes[0] = (uint8_t)ymode;
      memset(top, ymode, 4);
      memset(left, ymode, 4);
    } else {
      uint8_t* modes = b.imodes;
      for (int y = 0; y < 4; y++) {
        int ymode = left[y];
        for (int x = 0; x < 4; x++) {
          const uint8_t* p = kBModesProba[top[x]][ymode];
          ymode = !br.bit(p[0])   ? B_DC
                  : !br.bit(p[1]) ? B_TM
                  : !br.bit(p[2]) ? B_VE
                  : !br.bit(p[3])
                      ? (!br.bit(p[4]) ? B_HE : (!br.bit(p[5]) ? B_RD : B_VR))
                      : (!br.bit(p[6])
                             ? B_LD
                             : (!br.bit(p[7]) ? B_VL
                                              : (!br.bit(p[8]) ? B_HD : B_HU)));
          top[x] = (uint8_t)ymode;
        }
        memcpy(modes, top, 4);
        modes += 4;
        left[y] = (uint8_t)ymode;
      }
    }
    b.uvmode = !br.bit(142)   ? B_DC
               : !br.bit(114) ? B_VE
               : br.bit(183)  ? B_TM
                              : B_HE;
  }

  static int large_value(BoolDec& t, const uint8_t* p) {
    int v;
    if (!t.bit(p[3])) {
      v = !t.bit(p[4]) ? 2 : 3 + t.bit(p[5]);
    } else if (!t.bit(p[6])) {
      if (!t.bit(p[7])) {
        v = 5 + t.bit(159);
      } else {
        v = 7 + 2 * t.bit(165);
        v += t.bit(145);
      }
    } else {
      int bit1 = t.bit(p[8]);
      int bit0 = t.bit(p[9 + bit1]);
      int cat = 2 * bit1 + bit0;
      v = 0;
      for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab) v += v + t.bit(*tab);
      v += 3 + (8 << cat);
    }
    return v;
  }

  // GetCoeffs: the position after the last coded coefficient
  int coeffs(BoolDec& t, int type, int ctx, const int* dq, int n,
             int16_t* out) {
    const uint8_t* p = proba[type][kBands[n]][ctx];
    for (; n < 16; ++n) {
      if (!t.bit(p[0])) return n;
      while (!t.bit(p[1])) {
        p = proba[type][kBands[++n]][0];
        if (n == 16) return 16;
      }
      int v;
      if (!t.bit(p[2])) {
        v = 1;
        p = proba[type][kBands[n + 1]][1];
      } else {
        v = large_value(t, p);
        p = proba[type][kBands[n + 1]][2];
      }
      out[kZigzag[n]] = (int16_t)(t.sign(v) * dq[n > 0]);
    }
    return 16;
  }

  static void wht(const int16_t* in, int16_t* out) {
    int tmp[16];
    for (int i = 0; i < 4; ++i) {
      const int a0 = in[0 + i] + in[12 + i];
      const int a1 = in[4 + i] + in[8 + i];
      const int a2 = in[4 + i] - in[8 + i];
      const int a3 = in[0 + i] - in[12 + i];
      tmp[0 + i] = a0 + a1;
      tmp[8 + i] = a0 - a1;
      tmp[4 + i] = a3 + a2;
      tmp[12 + i] = a3 - a2;
    }
    for (int i = 0; i < 4; ++i) {
      const int dc = tmp[0 + i * 4] + 3;
      const int a0 = dc + tmp[3 + i * 4];
      const int a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
      const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4];
      const int a3 = dc - tmp[3 + i * 4];
      out[0] = (int16_t)((a0 + a1) >> 3);
      out[16] = (int16_t)((a3 + a2) >> 3);
      out[32] = (int16_t)((a0 - a1) >> 3);
      out[48] = (int16_t)((a3 - a2) >> 3);
      out += 64;
    }
  }

  // non-zero flags of the 4 luma, 2 + 2 chroma columns (top, per
  // macroblock column) and rows (left), and of the luma DC (Y2)
  struct Nz {
    uint8_t y[4], u[2], v[2], dc;
  };
  std::vector<Nz> nz_top;
  Nz nz_left;

  // ParseResiduals: true if any block has a non-zero NzCodeBits
  bool residuals(BoolDec& t, MBData& b, int mbx) {
    const Quant& q = dqm[b.segment];
    int16_t* dst = b.coeffs;
    memset(dst, 0, sizeof b.coeffs);
    Nz& top = nz_top[mbx];
    Nz& left = nz_left;
    bool any = false;
    int first, ytype;
    if (!b.is_i4x4) {
      int16_t dc[16] = {0};
      int ctx = top.dc + left.dc;
      int nz = coeffs(t, 1, ctx, q.y2, 0, dc);
      top.dc = left.dc = nz > 0;
      wht(dc, dst);
      first = 1;
      ytype = 0;
    } else {
      first = 0;
      ytype = 3;
    }
    for (int y = 0; y < 4; y++) {
      for (int x = 0; x < 4; x++) {
        int ctx = left.y[y] + top.y[x];
        int nz = coeffs(t, ytype, ctx, q.y1, first, dst);
        top.y[x] = left.y[y] = nz > first;
        int code = nz > 3 ? 3 : nz > 1 ? 2 : dst[0] != 0;
        b.ycode[4 * y + x] = (uint8_t)code;
        any |= code != 0;
        dst += 16;
      }
    }
    for (int ch = 0; ch < 2; ch++) {
      uint8_t* tnz = ch ? top.v : top.u;
      uint8_t* lnz = ch ? left.v : left.u;
      int uv = 0;
      for (int y = 0; y < 2; y++) {
        for (int x = 0; x < 2; x++) {
          int ctx = lnz[y] + tnz[x];
          int nz = coeffs(t, 2, ctx, q.uv, 0, dst);
          tnz[x] = lnz[y] = nz > 0;
          uv = std::max(uv, nz > 1 ? 2 : dst[0] != 0 ? 1 : 0);
          dst += 16;
        }
      }
      b.uvcode[ch] = (uint8_t)uv;
      any |= uv != 0;
    }
    return any;
  }

  // ------------------------------------------------- reconstruction
  static constexpr int kYOff = BPS * 1 + 8;
  static constexpr int kUOff = kYOff + BPS * 16 + BPS;
  static constexpr int kVOff = kUOff + 16;
  uint8_t work[BPS * 17 + BPS * 9];  // yuv_b_
  struct TopSamples {
    uint8_t y[16], u[8], v[8];
  };
  std::vector<TopSamples> yuv_t;

  // The inverse transforms as libwebp runs them on x86-64: the full one
  // (Transform_SSE2) in 16-bit lanes that wrap, with the multiplications
  // as _mm_mulhi_epi16 (20091 and 35468 - 65536) and the sum saturated to
  // 8 bits; TransformAC3 and TransformDC in C.  On the coefficients a
  // stream can give they agree with TransformOne_C.
  static int16_t w16(int v) { return (int16_t)v; }
  static int16_t mulhi(int16_t a, int k) { return (int16_t)((a * k) >> 16); }
  static void transform(const int16_t* in, uint8_t* dst) {
    constexpr int k1 = 20091, k2 = -30068;
    int16_t v[4][4];  // [output row of the first pass][column]
    for (int i = 0; i < 4; ++i) {
      const int16_t i0 = in[i], i1 = in[4 + i], i2 = in[8 + i],
                    i3 = in[12 + i];
      const int16_t a = w16(i0 + i2), b = w16(i0 - i2);
      const int16_t c = w16(w16(i1 - i3) + w16(mulhi(i1, k2) - mulhi(i3, k1)));
      const int16_t d = w16(w16(i1 + i3) + w16(mulhi(i1, k1) + mulhi(i3, k2)));
      v[0][i] = w16(a + d);
      v[1][i] = w16(b + c);
      v[2][i] = w16(b - c);
      v[3][i] = w16(a - d);
    }
    for (int r = 0; r < 4; ++r, dst += BPS) {
      const int16_t* t = v[r];
      const int16_t dc = w16(t[0] + 4);
      const int16_t a = w16(dc + t[2]), b = w16(dc - t[2]);
      const int16_t c = w16(w16(t[1] - t[3]) + w16(mulhi(t[1], k2) - mulhi(t[3], k1)));
      const int16_t d = w16(w16(t[1] + t[3]) + w16(mulhi(t[1], k1) + mulhi(t[3], k2)));
      const int16_t o[4] = {w16(a + d), w16(b + c), w16(b - c), w16(a - d)};
      for (int k = 0; k < 4; k++) dst[k] = clip8(w16(dst[k] + (o[k] >> 3)));
    }
  }
  static void transform_ac3(const int16_t* in, uint8_t* dst) {
    auto mul1 = [](int x) { return ((x * 20091) >> 16) + x; };
    auto mul2 = [](int x) { return (x * 35468) >> 16; };
    const int a = in[0] + 4;
    const int c4 = mul2(in[4]), d4 = mul1(in[4]);
    const int c1 = mul2(in[1]), d1 = mul1(in[1]);
    const int rows[4] = {a + d4, a + c4, a - c4, a - d4};
    for (int r = 0; r < 4; r++, dst += BPS) {
      const int o[4] = {rows[r] + d1, rows[r] + c1, rows[r] - c1,
                        rows[r] - d1};
      for (int k = 0; k < 4; k++) dst[k] = clip8(dst[k] + (o[k] >> 3));
    }
  }
  static void transform_dc(const int16_t* in, uint8_t* dst) {
    const int dc = (in[0] + 4) >> 3;
    for (int r = 0; r < 4; r++, dst += BPS)
      for (int k = 0; k < 4; k++) dst[k] = clip8(dst[k] + dc);
  }
  // DoTransform
  static void luma_transform(int code, const int16_t* in, uint8_t* dst) {
    if (code == 3)
      transform(in, dst);
    else if (code == 2)
      transform_ac3(in, dst);
    else if (code == 1)
      transform_dc(in, dst);
  }
  // DoUVTransform: the four blocks of a chroma plane
  static void chroma_transform(int code, const int16_t* in, uint8_t* dst) {
    for (int n = 0; n < 4; n++, in += 16) {
      uint8_t* d = dst + (n & 1) * 4 + (n >> 1) * 4 * BPS;
      if (code == 2)
        transform(in, d);
      else if (code == 1 && in[0])
        transform_dc(in, d);
    }
  }

  static void true_motion(uint8_t* dst, int size) {
    const uint8_t* top = dst - BPS;
    for (int y = 0; y < size; ++y) {
      for (int x = 0; x < size; ++x)
        dst[x] = clip8(top[x] + dst[-1] - top[-1]);
      dst += BPS;
    }
  }

  // 16x16 (size 16) and chroma (size 8) prediction, mode after CheckMode
  static void predict_block(uint8_t* dst, int mode, int size) {
    const int shift = size == 16 ? 4 : 3;
    int dc = 0;
    switch (mode) {
      case B_TM:
        return true_motion(dst, size);
      case B_VE:
        for (int y = 0; y < size; y++) memcpy(dst + y * BPS, dst - BPS, size);
        return;
      case B_HE:
        for (int y = 0; y < size; y++)
          memset(dst + y * BPS, dst[y * BPS - 1], size);
        return;
      case B_DC:
        for (int i = 0; i < size; i++) dc += dst[i - BPS] + dst[-1 + i * BPS];
        dc = (dc + size) >> (shift + 1);
        break;
      case DC_NOTOP:
        for (int i = 0; i < size; i++) dc += dst[-1 + i * BPS];
        dc = (dc + (size >> 1)) >> shift;
        break;
      case DC_NOLEFT:
        for (int i = 0; i < size; i++) dc += dst[i - BPS];
        dc = (dc + (size >> 1)) >> shift;
        break;
      default:
        dc = 0x80;
    }
    for (int y = 0; y < size; y++) memset(dst + y * BPS, dc, size);
  }

  static uint8_t avg3(int a, int b, int c) {
    return (uint8_t)((a + 2 * b + c + 2) >> 2);
  }
  static uint8_t avg2(int a, int b) { return (uint8_t)((a + b + 1) >> 1); }

  static void predict4(uint8_t* dst, int mode) {
#define DST(x, y) dst[(x) + (y) * BPS]
    const uint8_t* top = dst - BPS;
    const int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS],
              L = dst[-1 + 3 * BPS], X = top[-1], A = top[0], B = top[1],
              C = top[2], D = top[3], E = top[4], F = top[5], G = top[6],
              H = top[7];
    switch (mode) {
      case B_DC: {
        uint32_t dc = 4;
        for (int i = 0; i < 4; ++i) dc += dst[i - BPS] + dst[-1 + i * BPS];
        dc >>= 3;
        for (int i = 0; i < 4; ++i) memset(dst + i * BPS, (int)dc, 4);
        break;
      }
      case B_TM:
        true_motion(dst, 4);
        break;
      case B_VE: {
        const uint8_t vals[4] = {avg3(X, A, B), avg3(A, B, C), avg3(B, C, D),
                                 avg3(C, D, E)};
        for (int i = 0; i < 4; ++i) memcpy(dst + i * BPS, vals, 4);
        break;
      }
      case B_HE:
        memset(dst, avg3(X, I, J), 4);
        memset(dst + BPS, avg3(I, J, K), 4);
        memset(dst + 2 * BPS, avg3(J, K, L), 4);
        memset(dst + 3 * BPS, avg3(K, L, L), 4);
        break;
      case B_RD:
        DST(0, 3) = avg3(J, K, L);
        DST(1, 3) = DST(0, 2) = avg3(I, J, K);
        DST(2, 3) = DST(1, 2) = DST(0, 1) = avg3(X, I, J);
        DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = avg3(A, X, I);
        DST(3, 2) = DST(2, 1) = DST(1, 0) = avg3(B, A, X);
        DST(3, 1) = DST(2, 0) = avg3(C, B, A);
        DST(3, 0) = avg3(D, C, B);
        break;
      case B_LD:
        DST(0, 0) = avg3(A, B, C);
        DST(1, 0) = DST(0, 1) = avg3(B, C, D);
        DST(2, 0) = DST(1, 1) = DST(0, 2) = avg3(C, D, E);
        DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = avg3(D, E, F);
        DST(3, 1) = DST(2, 2) = DST(1, 3) = avg3(E, F, G);
        DST(3, 2) = DST(2, 3) = avg3(F, G, H);
        DST(3, 3) = avg3(G, H, H);
        break;
      case B_VR:
        DST(0, 0) = DST(1, 2) = avg2(X, A);
        DST(1, 0) = DST(2, 2) = avg2(A, B);
        DST(2, 0) = DST(3, 2) = avg2(B, C);
        DST(3, 0) = avg2(C, D);
        DST(0, 3) = avg3(K, J, I);
        DST(0, 2) = avg3(J, I, X);
        DST(0, 1) = DST(1, 3) = avg3(I, X, A);
        DST(1, 1) = DST(2, 3) = avg3(X, A, B);
        DST(2, 1) = DST(3, 3) = avg3(A, B, C);
        DST(3, 1) = avg3(B, C, D);
        break;
      case B_VL:
        DST(0, 0) = avg2(A, B);
        DST(1, 0) = DST(0, 2) = avg2(B, C);
        DST(2, 0) = DST(1, 2) = avg2(C, D);
        DST(3, 0) = DST(2, 2) = avg2(D, E);
        DST(0, 1) = avg3(A, B, C);
        DST(1, 1) = DST(0, 3) = avg3(B, C, D);
        DST(2, 1) = DST(1, 3) = avg3(C, D, E);
        DST(3, 1) = DST(2, 3) = avg3(D, E, F);
        DST(3, 2) = avg3(E, F, G);
        DST(3, 3) = avg3(F, G, H);
        break;
      case B_HU:
        DST(0, 0) = avg2(I, J);
        DST(2, 0) = DST(0, 1) = avg2(J, K);
        DST(2, 1) = DST(0, 2) = avg2(K, L);
        DST(1, 0) = avg3(I, J, K);
        DST(3, 0) = DST(1, 1) = avg3(J, K, L);
        DST(3, 1) = DST(1, 2) = avg3(K, L, L);
        DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) =
            DST(3, 3) = (uint8_t)L;
        break;
      case B_HD:
        DST(0, 0) = DST(2, 1) = avg2(I, X);
        DST(0, 1) = DST(2, 2) = avg2(J, I);
        DST(0, 2) = DST(2, 3) = avg2(K, J);
        DST(0, 3) = avg2(L, K);
        DST(3, 0) = avg3(A, B, C);
        DST(2, 0) = avg3(X, A, B);
        DST(1, 0) = DST(3, 1) = avg3(I, X, A);
        DST(1, 1) = DST(3, 2) = avg3(J, I, X);
        DST(1, 2) = DST(3, 3) = avg3(K, J, I);
        DST(1, 3) = avg3(L, K, J);
        break;
    }
#undef DST
  }

  static int check_mode(int mbx, int mby, int mode) {
    if (mode != B_DC) return mode;
    if (mbx == 0) return mby == 0 ? DC_NOTOPLEFT : DC_NOLEFT;
    return mby == 0 ? (int)DC_NOTOP : (int)B_DC;
  }

  // ReconstructRow: prediction from the unfiltered samples of the work
  // area (left) and yuv_t (top), the residuals added, the macroblocks
  // copied into the planes
  void reconstruct_row(int mby, const std::vector<MBData>& row) {
    uint8_t* const ydst = work + kYOff;
    uint8_t* const udst = work + kUOff;
    uint8_t* const vdst = work + kVOff;
    for (int j = 0; j < 16; ++j) ydst[j * BPS - 1] = 129;
    for (int j = 0; j < 8; ++j) udst[j * BPS - 1] = vdst[j * BPS - 1] = 129;
    if (mby > 0) {
      ydst[-1 - BPS] = udst[-1 - BPS] = vdst[-1 - BPS] = 129;
    } else {
      memset(ydst - BPS - 1, 127, 16 + 4 + 1);
      memset(udst - BPS - 1, 127, 8 + 1);
      memset(vdst - BPS - 1, 127, 8 + 1);
    }
    for (int mbx = 0; mbx < mbw; ++mbx) {
      const MBData& b = row[mbx];
      if (mbx > 0) {
        for (int j = -1; j < 16; ++j)
          memcpy(ydst + j * BPS - 4, ydst + j * BPS + 12, 4);
        for (int j = -1; j < 8; ++j) {
          memcpy(udst + j * BPS - 4, udst + j * BPS + 4, 4);
          memcpy(vdst + j * BPS - 4, vdst + j * BPS + 4, 4);
        }
      }
      TopSamples* top = yuv_t.data() + mbx;
      if (mby > 0) {
        memcpy(ydst - BPS, top[0].y, 16);
        memcpy(udst - BPS, top[0].u, 8);
        memcpy(vdst - BPS, top[0].v, 8);
      }
      if (b.is_i4x4) {
        uint8_t* top_right = ydst - BPS + 16;
        if (mby > 0) {
          if (mbx >= mbw - 1)
            memset(top_right, top[0].y[15], 4);
          else
            memcpy(top_right, top[1].y, 4);
        }
        for (int k = 1; k <= 3; k++) memcpy(top_right + 4 * k * BPS, top_right, 4);
        for (int n = 0; n < 16; ++n) {
          uint8_t* dst = ydst + (n & 3) * 4 + (n >> 2) * 4 * BPS;
          predict4(dst, b.imodes[n]);
          luma_transform(b.ycode[n], b.coeffs + n * 16, dst);
        }
      } else {
        predict_block(ydst, check_mode(mbx, mby, b.imodes[0]), 16);
        for (int n = 0; n < 16; ++n)
          luma_transform(b.ycode[n], b.coeffs + n * 16,
                         ydst + (n & 3) * 4 + (n >> 2) * 4 * BPS);
      }
      const int uvmode = check_mode(mbx, mby, b.uvmode);
      predict_block(udst, uvmode, 8);
      predict_block(vdst, uvmode, 8);
      chroma_transform(b.uvcode[0], b.coeffs + 16 * 16, udst);
      chroma_transform(b.uvcode[1], b.coeffs + 20 * 16, vdst);
      if (mby < mbh - 1) {
        memcpy(top[0].y, ydst + 15 * BPS, 16);
        memcpy(top[0].u, udst + 7 * BPS, 8);
        memcpy(top[0].v, vdst + 7 * BPS, 8);
      }
      uint8_t* yo = Y.data() + (size_t)mby * 16 * ystride + mbx * 16;
      uint8_t* uo = U.data() + (size_t)mby * 8 * uvstride + mbx * 8;
      uint8_t* vo = V.data() + (size_t)mby * 8 * uvstride + mbx * 8;
      for (int j = 0; j < 16; ++j) memcpy(yo + j * ystride, ydst + j * BPS, 16);
      for (int j = 0; j < 8; ++j) {
        memcpy(uo + j * uvstride, udst + j * BPS, 8);
        memcpy(vo + j * uvstride, vdst + j * BPS, 8);
      }
    }
  }

  // ---------------------------------------------------- loop filter
  static int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }
  static int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }

  static void filter2(uint8_t* p, int step) {
    const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
    const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
    const int a1 = sclip2((a + 4) >> 3);
    const int a2 = sclip2((a + 3) >> 3);
    p[-step] = clip8(p0 + a2);
    p[0] = clip8(q0 - a1);
  }
  static void filter4(uint8_t* p, int step) {
    const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
    const int a = 3 * (q0 - p0);
    const int a1 = sclip2((a + 4) >> 3);
    const int a2 = sclip2((a + 3) >> 3);
    const int a3 = (a1 + 1) >> 1;
    p[-2 * step] = clip8(p1 + a3);
    p[-step] = clip8(p0 + a2);
    p[0] = clip8(q0 - a1);
    p[step] = clip8(q1 - a3);
  }
  static void filter6(uint8_t* p, int step) {
    const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
    const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
    const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
    const int a1 = (27 * a + 63) >> 7;
    const int a2 = (18 * a + 63) >> 7;
    const int a3 = (9 * a + 63) >> 7;
    p[-3 * step] = clip8(p2 + a3);
    p[-2 * step] = clip8(p1 + a2);
    p[-step] = clip8(p0 + a1);
    p[0] = clip8(q0 - a1);
    p[step] = clip8(q1 - a2);
    p[2 * step] = clip8(q2 - a3);
  }
  static bool hev(const uint8_t* p, int step, int thresh) {
    const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
    return std::abs(p1 - p0) > thresh || std::abs(q1 - q0) > thresh;
  }
  static bool needs(const uint8_t* p, int step, int t) {
    const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
    return 4 * std::abs(p0 - q0) + std::abs(p1 - q1) <= t;
  }
  static bool needs2(const uint8_t* p, int step, int t, int it) {
    const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step];
    const int p0 = p[-step], q0 = p[0];
    const int q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
    if (4 * std::abs(p0 - q0) + std::abs(p1 - q1) > t) return false;
    return std::abs(p3 - p2) <= it && std::abs(p2 - p1) <= it &&
           std::abs(p1 - p0) <= it && std::abs(q3 - q2) <= it &&
           std::abs(q2 - q1) <= it && std::abs(q1 - q0) <= it;
  }
  // the simple filter across one edge of 16 pixels: hstride steps across
  // the edge, vstride along it; loop() is the normal filter's, 6 taps on a
  // macroblock edge and 4 inside
  static void simple(uint8_t* p, int hstride, int vstride, int thresh) {
    const int t2 = 2 * thresh + 1;
    for (int i = 0; i < 16; ++i, p += vstride)
      if (needs(p, hstride, t2)) filter2(p, hstride);
  }
  static void loop(uint8_t* p, int hstride, int vstride, int size, int thresh,
                   int ithresh, int hev_t, bool edge) {
    const int t2 = 2 * thresh + 1;
    for (; size-- > 0; p += vstride) {
      if (!needs2(p, hstride, t2, ithresh)) continue;
      if (hev(p, hstride, hev_t))
        filter2(p, hstride);
      else if (edge)
        filter6(p, hstride);
      else
        filter4(p, hstride);
    }
  }

  // DoFilter for one macroblock, in raster order over the frame
  void filter_mb(int mbx, int mby, const FInfo& f) {
    const int limit = f.limit;
    if (limit == 0) return;
    uint8_t* y = Y.data() + (size_t)mby * 16 * ystride + mbx * 16;
    const int ys = ystride;
    if (filter_type == 1) {
      if (mbx > 0) simple(y, 1, ys, limit + 4);
      if (f.inner)
        for (int k = 1; k <= 3; k++) simple(y + 4 * k, 1, ys, limit);
      if (mby > 0) simple(y, ys, 1, limit + 4);
      if (f.inner)
        for (int k = 1; k <= 3; k++) simple(y + 4 * k * ys, ys, 1, limit);
      return;
    }
    const int us = uvstride;
    uint8_t* u = U.data() + (size_t)mby * 8 * us + mbx * 8;
    uint8_t* v = V.data() + (size_t)mby * 8 * us + mbx * 8;
    const int il = f.ilevel, ht = f.hev;
    if (mbx > 0) {
      loop(y, 1, ys, 16, limit + 4, il, ht, true);
      loop(u, 1, us, 8, limit + 4, il, ht, true);
      loop(v, 1, us, 8, limit + 4, il, ht, true);
    }
    if (f.inner) {
      for (int k = 1; k <= 3; k++) loop(y + 4 * k, 1, ys, 16, limit, il, ht, false);
      loop(u + 4, 1, us, 8, limit, il, ht, false);
      loop(v + 4, 1, us, 8, limit, il, ht, false);
    }
    if (mby > 0) {
      loop(y, ys, 1, 16, limit + 4, il, ht, true);
      loop(u, us, 1, 8, limit + 4, il, ht, true);
      loop(v, us, 1, 8, limit + 4, il, ht, true);
    }
    if (f.inner) {
      for (int k = 1; k <= 3; k++)
        loop(y + 4 * k * ys, ys, 1, 16, limit, il, ht, false);
      loop(u + 4 * us, us, 1, 8, limit, il, ht, false);
      loop(v + 4 * us, us, 1, 8, limit, il, ht, false);
    }
  }

  // ParseFrame: modes of a row from the first partition, then its tokens,
  // then the row reconstructed and filtered (filtering a row only touches
  // pixels no later prediction reads: prediction reads the work area)
  void decode_frame() {
    ystride = mbw * 16;
    uvstride = mbw * 8;
    Y.assign((size_t)ystride * mbh * 16, 0);
    U.assign((size_t)uvstride * mbh * 8, 0);
    V.assign((size_t)uvstride * mbh * 8, 0);
    intra_t.assign((size_t)4 * mbw, B_DC);
    nz_top.assign(mbw, Nz{});
    yuv_t.assign(mbw, TopSamples{});
    memset(work, 0, sizeof work);
    std::vector<MBData> row(mbw);
    std::vector<FInfo> finfo(mbw);
    for (int mby = 0; mby < mbh; ++mby) {
      memset(intra_l, B_DC, sizeof intra_l);
      for (int mbx = 0; mbx < mbw; ++mbx) parse_modes(row[mbx], mbx);
      if (br.eof) bad("lossy frame (first partition ends early)");
      BoolDec& t = parts[mby & (nparts - 1)];
      nz_left = Nz{};
      for (int mbx = 0; mbx < mbw; ++mbx) {
        MBData& b = row[mbx];
        bool skip = use_skip ? b.skip : false;
        if (!skip) {
          skip = !residuals(t, b, mbx);
        } else {
          Nz& top = nz_top[mbx];
          uint8_t dct = top.dc, dcl = nz_left.dc;
          top = Nz{};
          nz_left = Nz{};
          if (b.is_i4x4) {
            top.dc = dct;
            nz_left.dc = dcl;
          }
          memset(b.ycode, 0, sizeof b.ycode);
          memset(b.uvcode, 0, sizeof b.uvcode);
        }
        if (filter_type > 0) {
          finfo[mbx] = fstrengths[b.segment][b.is_i4x4];
          finfo[mbx].inner |= !skip;
        }
        if (t.eof) bad("lossy frame (token partition ends early)");
      }
      reconstruct_row(mby, row);
      if (filter_type > 0)
        for (int mbx = 0; mbx < mbw; ++mbx) filter_mb(mbx, mby, finfo[mbx]);
    }
  }
};

// ------------------------------------------------- YUV 4:2:0 -> RGB
inline int mult_hi(int v, int coeff) { return (v * coeff) >> 8; }
inline uint8_t yuv_clip8(int v) {
  return (v & ~16383) == 0 ? (uint8_t)(v >> 6) : v < 0 ? 0 : 255;
}
inline void yuv_to_rgb(int y, int u, int v, uint8_t* rgb) {
  rgb[0] = yuv_clip8(mult_hi(y, 19077) + mult_hi(v, 26149) - 14234);
  rgb[1] = yuv_clip8(mult_hi(y, 19077) - mult_hi(u, 6419) - mult_hi(v, 13320) +
                     8708);
  rgb[2] = yuv_clip8(mult_hi(y, 19077) + mult_hi(u, 33050) - 17685);
}

// UpsampleRgbLinePair: two output rows from one luma row each and the
// chroma rows above (top_*) and below (cur_*) them, each chroma sample
// weighted 9-3-3-1 with its neighbours
void upsample_pair(const uint8_t* top_y, const uint8_t* bottom_y,
                   const uint8_t* top_u, const uint8_t* top_v,
                   const uint8_t* cur_u, const uint8_t* cur_v,
                   uint8_t* top_dst, uint8_t* bottom_dst, int len) {
  const int last_pair = (len - 1) >> 1;
  int tl_u = top_u[0], tl_v = top_v[0], l_u = cur_u[0], l_v = cur_v[0];
  yuv_to_rgb(top_y[0], (3 * tl_u + l_u + 2) >> 2, (3 * tl_v + l_v + 2) >> 2,
             top_dst);
  if (bottom_y)
    yuv_to_rgb(bottom_y[0], (3 * l_u + tl_u + 2) >> 2,
               (3 * l_v + tl_v + 2) >> 2, bottom_dst);
  for (int x = 1; x <= last_pair; ++x) {
    const int t_u = top_u[x], t_v = top_v[x], u = cur_u[x], v = cur_v[x];
    const int avg_u = tl_u + t_u + l_u + u + 8, avg_v = tl_v + t_v + l_v + v + 8;
    const int d12_u = (avg_u + 2 * (t_u + l_u)) >> 3;
    const int d12_v = (avg_v + 2 * (t_v + l_v)) >> 3;
    const int d03_u = (avg_u + 2 * (tl_u + u)) >> 3;
    const int d03_v = (avg_v + 2 * (tl_v + v)) >> 3;
    yuv_to_rgb(top_y[2 * x - 1], (d12_u + tl_u) >> 1, (d12_v + tl_v) >> 1,
               top_dst + 3 * (2 * x - 1));
    yuv_to_rgb(top_y[2 * x], (d03_u + t_u) >> 1, (d03_v + t_v) >> 1,
               top_dst + 3 * (2 * x));
    if (bottom_y) {
      yuv_to_rgb(bottom_y[2 * x - 1], (d03_u + l_u) >> 1, (d03_v + l_v) >> 1,
                 bottom_dst + 3 * (2 * x - 1));
      yuv_to_rgb(bottom_y[2 * x], (d12_u + u) >> 1, (d12_v + v) >> 1,
                 bottom_dst + 3 * (2 * x));
    }
    tl_u = t_u;
    tl_v = t_v;
    l_u = u;
    l_v = v;
  }
  if (!(len & 1)) {
    yuv_to_rgb(top_y[len - 1], (3 * tl_u + l_u + 2) >> 2,
               (3 * tl_v + l_v + 2) >> 2, top_dst + 3 * (len - 1));
    if (bottom_y)
      yuv_to_rgb(bottom_y[len - 1], (3 * l_u + tl_u + 2) >> 2,
                 (3 * l_v + tl_v + 2) >> 2, bottom_dst + 3 * (len - 1));
  }
}

// EmitFancyRGB over the whole frame into out (h rows of `stride` bytes)
void vp8_rgb(const Vp8& d, uint8_t* out, size_t stride) {
  const int w = d.width, h = d.height;
  const uint8_t* y = d.Y.data();
  const uint8_t* u = d.U.data();
  const uint8_t* v = d.V.data();
  const int ys = d.ystride, uvs = d.uvstride;
  upsample_pair(y, nullptr, u, v, u, v, out, nullptr, w);
  int row = 0;
  for (; row + 2 < h; row += 2) {
    const uint8_t* tu = u + (size_t)(row / 2) * uvs;
    const uint8_t* tv = v + (size_t)(row / 2) * uvs;
    upsample_pair(y + (size_t)(row + 1) * ys, y + (size_t)(row + 2) * ys, tu, tv,
                  tu + uvs, tv + uvs, out + (row + 1) * stride,
                  out + (row + 2) * stride, w);
  }
  if (!(h & 1)) {
    const uint8_t* cu = u + (size_t)(row / 2) * uvs;
    const uint8_t* cv = v + (size_t)(row / 2) * uvs;
    upsample_pair(y + (size_t)(h - 1) * ys, nullptr, cu, cv, cu, cv,
                  out + (h - 1) * stride, nullptr, w);
  }
}

// --------------------------------------------------------- alpha (ALPH)
// ALPHInit and the VP8L alpha stream: decoded only so that a malformed
// chunk fails the file as libwebp fails it
void check_alpha(const uint8_t* d, size_t n, int w, int h) {
  if (n <= 1) bad("alpha chunk");
  int method = d[0] & 3, filter = (d[0] >> 2) & 3, pre = (d[0] >> 4) & 3,
      rsrv = d[0] >> 6;
  (void)filter;
  if (method > 1 || pre > 1 || rsrv != 0) bad("alpha chunk header");
  if (method == 0) {
    if (n - 1 < (size_t)w * h) bad("alpha chunk (ends early)");
    return;
  }
  Vp8l dec(d + 1, n - 1);
  dec.alpha = true;
  dec.decode(w, h);
}

// ------------------------------------------------------------ container
struct Chunk {
  uint32_t tag;
  const uint8_t* d;
  size_t n;
};
constexpr uint32_t fourcc(const char* s) {
  return (uint32_t)(uint8_t)s[0] | (uint32_t)(uint8_t)s[1] << 8 |
         (uint32_t)(uint8_t)s[2] << 16 | (uint32_t)(uint8_t)s[3] << 24;
}

// The chunk at d[pos], whose payload must lie within n bytes
Chunk chunk_at(const uint8_t* d, size_t n, size_t pos) {
  if (pos + 8 > n) bad("chunk (ends early)");
  size_t size = le32(d + pos + 4);
  if (size > n - pos - 8) bad("chunk (ends early)");
  return {le32(d + pos), d + pos + 8, size};
}

// The picture of a file (its first frame for an animation): its canvas
// size, the frame's offset on the canvas, its bitstream and its ALPH
// chunk.  As in libwebp, a still image's bitstream runs to the end of the
// file (the last token partition, or the lossless stream, may read past
// its chunk), a frame's to the end of its padded chunk.
struct Picture {
  int canvas_w = 0, canvas_h = 0, x = 0, y = 0;
  const uint8_t* image = nullptr;
  size_t chunk_n = 0, avail = 0;  // the chunk's size, the bytes readable
  Chunk alpha{0, nullptr, 0};
  bool lossless = false;
  int w = 0, h = 0;

  void set_image(const Chunk& c, size_t readable) {
    image = c.d;
    chunk_n = c.n;
    avail = readable;
    lossless = c.tag == fourcc("VP8L");
    if (lossless) {
      vp8l_header(image, chunk_n, &w, &h);
      return;
    }
    // VP8GetInfo
    const uint8_t* d = image;
    if (std::min(chunk_n, avail) < 10 || d[3] != 0x9d || d[4] != 0x01 ||
        d[5] != 0x2a)
      bad("lossy frame header");
    const uint32_t bits = le24(d);
    if ((bits & 1) || ((bits >> 1) & 7) > 3 || !((bits >> 4) & 1) ||
        (bits >> 5) >= chunk_n)
      bad("lossy frame header (not a shown key frame, or sizes)");
    w = (d[6] | d[7] << 8) & 0x3fff;
    h = (d[8] | d[9] << 8) & 0x3fff;
    if (!w || !h) bad("lossy frame (0 pixels)");
  }
};

inline bool is_image(uint32_t tag) {
  return tag == fourcc("VP8 ") || tag == fourcc("VP8L");
}

Picture parse_animation(const uint8_t* d, size_t end, size_t pos,
                        Picture p);

// ParseHeadersInternal (a still file) and WebPDemux's first frame (an
// animation)
Picture parse(const uint8_t* d, size_t n) {
  if (n < 12 || memcmp(d, "RIFF", 4) || memcmp(d + 8, "WEBP", 4))
    bad("file (no RIFF WEBP header)");
  // OpenCV reads nothing of a file shorter than its WEBP_HEADER_SIZE
  if (n < 32) bad("file (shorter than 32 bytes)");
  size_t riff = le32(d + 4);
  if (riff < 12) bad("RIFF size");
  if (riff > n - 8) bad("file (ends before its RIFF size)");
  const size_t end = riff + 8;
  Picture p;
  Chunk first = chunk_at(d, end, 12);
  if (is_image(first.tag)) {
    p.set_image(first, n - 20);
    p.canvas_w = p.w;
    p.canvas_h = p.h;
    return p;
  }
  if (first.tag != fourcc("VP8X"))
    bad("file (no VP8, VP8L or VP8X chunk first)");
  if (first.n != 10) bad("VP8X chunk");
  const uint8_t* x = first.d;
  const bool animated = x[0] & 2;
  p.canvas_w = (int)le24(x + 4) + 1;
  p.canvas_h = (int)le24(x + 7) + 1;
  if ((uint64_t)p.canvas_w * p.canvas_h >= (1ull << 32)) bad("canvas size");
  size_t pos = 12 + 8 + 10;
  if (!animated) {
    // optional chunks (the last ALPH counts) up to the image
    for (;;) {
      Chunk c = chunk_at(d, end, pos);
      if (is_image(c.tag)) {
        p.set_image(c, n - (size_t)(c.d - d));
        break;
      }
      if (c.tag == fourcc("ALPH")) p.alpha = c;
      pos += 8 + c.n + (c.n & 1);
    }
    if (p.w != p.canvas_w || p.h != p.canvas_h)
      bad("file (image size differs from the VP8X canvas)");
    if (p.lossless) p.alpha = Chunk{0, nullptr, 0};
    return p;
  }
  return parse_animation(d, end, pos, p);
}

// WebPDemux of an animation, as WebPAnimDecoder parses it: the chunks after
// VP8X tile the RIFF payload exactly (padding included); ANIM comes before
// the first ANMF; an ANMF holds an optional ALPH (not with VP8L) and one
// VP8 or VP8L chunk whose header reads, within its payload, each frame
// complete and on the canvas; the VP8X flags name no unknown feature.  The
// first frame is the picture; its bitstream runs to the end of its padded
// chunk.
Picture parse_animation(const uint8_t* d, size_t end, size_t pos,
                        Picture p) {
  if (d[20] & ~0x3E) bad("VP8X flags");
  bool anim = false, first = true;
  while (pos != end) {
    if (end - pos < 8) bad("file (a chunk past the RIFF size)");
    const uint32_t tag = le32(d + pos);
    const size_t size = le32(d + pos + 4), padded = size + (size & 1);
    if (padded > end - pos - 8) bad("file (a chunk past the RIFF size)");
    if (tag == fourcc("VP8X") || is_image(tag) || tag == fourcc("ALPH"))
      bad("animation (an image outside ANMF)");
    if (tag == fourcc("ANIM")) {
      if (padded < 6) bad("ANIM chunk");
      anim = true;
    }
    if (tag != fourcc("ANMF")) {
      pos += 8 + padded;
      continue;
    }
    if (!anim) bad("animation (ANMF before ANIM)");
    if (padded < 16) bad("ANMF chunk");
    const size_t payload = padded - 16;
    const int x = 2 * (int)le24(d + pos + 8), y = 2 * (int)le24(d + pos + 11);
    pos += 8 + 16;
    const size_t start = pos;
    if (end - pos < 8 || end - pos < payload) bad("ANMF chunk (ends early)");
    // StoreFrame: ALPH, then VP8 or VP8L; another chunk ends the frame
    Picture f = p;
    f.x = x;
    f.y = y;
    f.alpha = Chunk{0, nullptr, 0};
    bool alpha = false, image = false;
    while (true) {
      const uint32_t t = le32(d + pos);
      const size_t n = le32(d + pos + 4), np = n + (n & 1);
      if (np > end - pos - 8) bad("ANMF frame (a chunk past the RIFF size)");
      const Chunk c{t, d + pos + 8, n};
      if (t == fourcc("ALPH") && !alpha) {
        alpha = true;
        f.alpha = c;
      } else if (is_image(t) && !image) {
        if (t == fourcc("VP8L") && alpha) bad("ANMF frame (ALPH with VP8L)");
        image = true;
        f.set_image(c, np);
      } else {
        break;
      }
      pos += 8 + np;
      if (pos == end) break;
      if (end - pos < 8) bad("ANMF frame (a chunk past the RIFF size)");
    }
    if (pos - start > payload) bad("ANMF frame (past its chunk)");
    if (alpha && !image) bad("ANMF frame (no image)");
    if (image) {
      if (f.x + f.w > f.canvas_w || f.y + f.h > f.canvas_h)
        bad("ANMF frame (outside the canvas)");
      if (first) p = f;
      first = false;
    }
  }
  if (first) bad("animation (no ANMF frame)");
  return p;
}

// the RGB of the picture's frame, at (x, y) of a zeroed canvas
void decode(const Picture& p, uint8_t* out) {
  memset(out, 0, (size_t)p.canvas_w * p.canvas_h * 3);
  uint8_t* dst = out + ((size_t)p.y * p.canvas_w + p.x) * 3;
  const size_t stride = (size_t)p.canvas_w * 3;
  if (p.lossless) {
    int w, h;
    std::vector<uint32_t> argb = vp8l_argb(p.image, p.avail, &w, &h);
    for (int y = 0; y < h; y++) {
      uint8_t* o = dst + y * stride;
      const uint32_t* s = argb.data() + (size_t)y * w;
      for (int x = 0; x < w; x++) {
        o[3 * x] = (uint8_t)(s[x] >> 16);
        o[3 * x + 1] = (uint8_t)(s[x] >> 8);
        o[3 * x + 2] = (uint8_t)s[x];
      }
    }
    return;
  }
  Vp8 v;
  v.headers(p.image, p.chunk_n, p.avail);
  v.decode_frame();
  if (p.alpha.d) check_alpha(p.alpha.d, p.alpha.n, v.width, v.height);
  vp8_rgb(v, dst, stride);
}

int report(const Error& e, char* err, int errlen) {
  if (err && errlen > 0) snprintf(err, (size_t)errlen, "%s", e.msg.c_str());
  return e.code;
}

}  // namespace

extern "C" {

// (height, width) of a WebP file's canvas, after checking its container.
int thc_webp_info(const uint8_t* data, int64_t n, int* height, int* width,
                  char* err, int errlen) {
  try {
    Picture p = parse(data, (size_t)n);
    *height = p.canvas_h;
    *width = p.canvas_w;
    return 0;
  } catch (const Error& e) {
    return report(e, err, errlen);
  } catch (const std::exception& e) {
    return report(Error{kErrFormat, e.what()}, err, errlen);
  }
}

// Decode into out, (height, width, 3) RGB uint8: the image, or the first
// frame of an animation on its canvas.
int thc_webp_decode(const uint8_t* data, int64_t n, uint8_t* out, int height,
                    int width, char* err, int errlen) {
  try {
    Picture p = parse(data, (size_t)n);
    if (p.canvas_h != height || p.canvas_w != width)
      fail(kErrArgs, "output size does not match the WebP canvas");
    decode(p, out);
    return 0;
  } catch (const Error& e) {
    return report(e, err, errlen);
  } catch (const std::exception& e) {
    return report(Error{kErrFormat, e.what()}, err, errlen);
  }
}

}  // extern "C"

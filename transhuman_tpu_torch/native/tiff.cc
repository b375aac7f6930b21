// TIFF codings and colour spaces of libtiff 4.7, what cv2.imread reads
// through libtiff's RGBA image (TIFFReadRGBAStrip / TIFFReadRGBATile),
// behind a plain C ABI (ctypes); built into libimgcodec.so with
// -ffp-contract=off, so that CIELab's float operations are libtiff's, one
// rounding each, in its order.
//
//   * CCITT bilevel strips and tiles (tif_fax3.c): modified Huffman rows
//     byte-aligned (compression 2, RLE), Group 3 (3) with an EOL before each
//     row, 1-D or, with T4Options bit 0, a tag bit choosing 1-D or 2-D
//     (READ) coding per row, and Group 4 (4, MMR) against an all-white
//     first reference line; bits taken MSB first, or LSB first under
//     FillOrder 2.  The runs are libtiff's: its EOL search (SYNC_EOL), the
//     changing element b1 as CHECK_b1 moves it, zero-length run pairs
//     dropped, a row that an EOL, an uncompressed-mode extension or an
//     unknown code ends early filled white to its end (CLEANUP_RUNS), and
//     the bits past the data's end read as zeros while any remain; a strip
//     whose data ends before its last row is an error.  Decoded bits are 1
//     for black runs, 0 for white, as _TIFFFax3fillruns writes them.
//   * YCbCr -> RGB (tif_color.c TIFFYCbCrToRGBInit, TIFFYCbCrtoRGB) with
//     the put routines of tif_getimage.c for subsamplings 1x1, 1x2, 2x1,
//     2x2, 4x1, 4x2 and 4x4: each block's chroma replicated over its luma
//     samples, a partial block at the right or bottom edge cut, and a
//     tile's skip to its next row of blocks taken as each routine computes
//     it (putcontig8bitYCbCr44tile skips 10 bytes a block, not 18).
//   * CMYK -> RGB (tif_getimage.c putRGBcontig8bitCMYKtile).
//   * CIELab -> RGB (tif_color.c TIFFCIELabToRGBInit with tif_getimage.c's
//     display_sRGB, TIFFCIELab16ToXYZ, TIFFXYZToRGB): 8-bit samples as
//     L * 257, a * 256 and b * 256 of the 16-bit form.
//
// Every entry returns 0 on success or a non-zero code, with a message in
// the caller's buffer.

#include <cmath>
#include <cstdint>
#include <cstdio>
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

constexpr int kErrFormat = 1;       // malformed or truncated data
constexpr int kErrUnsupported = 2;  // a coding refused by name
constexpr int kErrArgs = 3;         // the caller's arguments do not match

int report(const Error& e, char* err, int errlen) {
  if (err && errlen > 0) snprintf(err, (size_t)errlen, "%s", e.msg.c_str());
  return e.code;
}

// ------------------------------------------------------------- CCITT
// Code tables of ITU-T T.4: (bits, length, run) of the terminating and
// make-up codes; runs of 1792 and more are the make-up codes both colours
// share.
struct Code {
  const char* bits;
  int run;
};

const Code kWhite[] = {
    {"00110101", 0},     {"000111", 1},       {"0111", 2},
    {"1000", 3},         {"1011", 4},         {"1100", 5},
    {"1110", 6},         {"1111", 7},         {"10011", 8},
    {"10100", 9},        {"00111", 10},       {"01000", 11},
    {"001000", 12},      {"000011", 13},      {"110100", 14},
    {"110101", 15},      {"101010", 16},      {"101011", 17},
    {"0100111", 18},     {"0001100", 19},     {"0001000", 20},
    {"0010111", 21},     {"0000011", 22},     {"0000100", 23},
    {"0101000", 24},     {"0101011", 25},     {"0010011", 26},
    {"0100100", 27},     {"0011000", 28},     {"00000010", 29},
    {"00000011", 30},    {"00011010", 31},    {"00011011", 32},
    {"00010010", 33},    {"00010011", 34},    {"00010100", 35},
    {"00010101", 36},    {"00010110", 37},    {"00010111", 38},
    {"00101000", 39},    {"00101001", 40},    {"00101010", 41},
    {"00101011", 42},    {"00101100", 43},    {"00101101", 44},
    {"00000100", 45},    {"00000101", 46},    {"00001010", 47},
    {"00001011", 48},    {"01010010", 49},    {"01010011", 50},
    {"01010100", 51},    {"01010101", 52},    {"00100100", 53},
    {"00100101", 54},    {"01011000", 55},    {"01011001", 56},
    {"01011010", 57},    {"01011011", 58},    {"01001010", 59},
    {"01001011", 60},    {"00110010", 61},    {"00110011", 62},
    {"00110100", 63},    {"11011", 64},       {"10010", 128},
    {"010111", 192},     {"0110111", 256},    {"00110110", 320},
    {"00110111", 384},   {"01100100", 448},   {"01100101", 512},
    {"01101000", 576},   {"01100111", 640},   {"011001100", 704},
    {"011001101", 768},  {"011010010", 832},  {"011010011", 896},
    {"011010100", 960},  {"011010101", 1024}, {"011010110", 1088},
    {"011010111", 1152}, {"011011000", 1216}, {"011011001", 1280},
    {"011011010", 1344}, {"011011011", 1408}, {"010011000", 1472},
    {"010011001", 1536}, {"010011010", 1600}, {"011000", 1664},
    {"010011011", 1728}};

const Code kBlack[] = {
    {"0000110111", 0},     {"010", 1},            {"11", 2},
    {"10", 3},             {"011", 4},            {"0011", 5},
    {"0010", 6},           {"00011", 7},          {"000101", 8},
    {"000100", 9},         {"0000100", 10},       {"0000101", 11},
    {"0000111", 12},       {"00000100", 13},      {"00000111", 14},
    {"000011000", 15},     {"0000010111", 16},    {"0000011000", 17},
    {"0000001000", 18},    {"00001100111", 19},   {"00001101000", 20},
    {"00001101100", 21},   {"00000110111", 22},   {"00000101000", 23},
    {"00000010111", 24},   {"00000011000", 25},   {"000011001010", 26},
    {"000011001011", 27},  {"000011001100", 28},  {"000011001101", 29},
    {"000001101000", 30},  {"000001101001", 31},  {"000001101010", 32},
    {"000001101011", 33},  {"000011010010", 34},  {"000011010011", 35},
    {"000011010100", 36},  {"000011010101", 37},  {"000011010110", 38},
    {"000011010111", 39},  {"000001101100", 40},  {"000001101101", 41},
    {"000011011010", 42},  {"000011011011", 43},  {"000001010100", 44},
    {"000001010101", 45},  {"000001010110", 46},  {"000001010111", 47},
    {"000001100100", 48},  {"000001100101", 49},  {"000001010010", 50},
    {"000001010011", 51},  {"000000100100", 52},  {"000000110111", 53},
    {"000000111000", 54},  {"000000100111", 55},  {"000000101000", 56},
    {"000001011000", 57},  {"000001011001", 58},  {"000000101011", 59},
    {"000000101100", 60},  {"000001011010", 61},  {"000001100110", 62},
    {"000001100111", 63},  {"0000001111", 64},    {"000011001000", 128},
    {"000011001001", 192}, {"000001011011", 256}, {"000000110011", 320},
    {"000000110100", 384}, {"000000110101", 448}, {"0000001101100", 512},
    {"0000001101101", 576},  {"0000001001010", 640},
    {"0000001001011", 704},  {"0000001001100", 768},
    {"0000001001101", 832},  {"0000001110010", 896},
    {"0000001110011", 960},  {"0000001110100", 1024},
    {"0000001110101", 1088}, {"0000001110110", 1152},
    {"0000001110111", 1216}, {"0000001010010", 1280},
    {"0000001010011", 1344}, {"0000001010100", 1408},
    {"0000001010101", 1472}, {"0000001011010", 1536},
    {"0000001011011", 1600}, {"0000001100100", 1664},
    {"0000001100101", 1728}};

const Code kMakeUp[] = {
    {"00000001000", 1792},  {"00000001100", 1856},  {"00000001101", 1920},
    {"000000010010", 1984}, {"000000010011", 2048}, {"000000010100", 2112},
    {"000000010101", 2176}, {"000000010110", 2240}, {"000000010111", 2304},
    {"000000011100", 2368}, {"000000011101", 2432}, {"000000011110", 2496},
    {"000000011111", 2560}};

// states of a table entry (tif_fax3.h's)
enum State {
  S_Null = 0, S_Pass, S_Horiz, S_V0, S_VR, S_VL, S_Ext, S_TermW, S_TermB,
  S_MakeUpW, S_MakeUpB, S_MakeUp, S_EOL
};

struct Entry {
  uint8_t state = S_Null, width = 0;
  int32_t param = 0;
};

// A lookup table of `bits`-bit prefixes: each code fills every entry that
// starts with it.
struct Table {
  int bits;
  std::vector<Entry> e;
  explicit Table(int b) : bits(b), e((size_t)1 << b) {}
  void add(const char* code, uint8_t state, int32_t param) {
    int len = (int)strlen(code), v = 0;
    for (int i = 0; i < len; i++) v = v << 1 | (code[i] == '1');
    int shift = bits - len;
    for (int j = 0; j < (1 << shift); j++) {
      Entry& t = e[((size_t)v << shift) | j];
      t.state = state;
      t.width = (uint8_t)len;
      t.param = param;
    }
  }
};

struct Tables {
  Table white{12}, black{13}, main{12};
  Tables() {
    for (const Code& c : kWhite)
      white.add(c.bits, c.run < 64 ? S_TermW : S_MakeUpW, c.run);
    for (const Code& c : kBlack)
      black.add(c.bits, c.run < 64 ? S_TermB : S_MakeUpB, c.run);
    for (const Code& c : kMakeUp) {
      white.add(c.bits, S_MakeUp, c.run);
      black.add(c.bits, S_MakeUp, c.run);
    }
    white.add("000000000001", S_EOL, 0);
    black.add("000000000001", S_EOL, 0);
    main.add("0001", S_Pass, 0);
    main.add("001", S_Horiz, 0);
    main.add("1", S_V0, 0);
    main.add("011", S_VR, 1);
    main.add("000011", S_VR, 2);
    main.add("0000011", S_VR, 3);
    main.add("010", S_VL, 1);
    main.add("000010", S_VL, 2);
    main.add("0000010", S_VL, 3);
    main.add("0000001", S_Ext, 0);
    main.add("000000000001", S_EOL, 0);
  }
};

const Tables& tables() {
  static const Tables t;
  return t;
}

struct FaxEOF {};  // the data ended where a code was due

// The strip's bits, MSB first (LSB first when reversed); past the end they
// read as zeros while any bit of the data is left unread, as libtiff's
// NeedBits pads its accumulator.
struct Bits {
  const uint8_t* data;
  size_t n;
  bool reversed;
  uint64_t pos = 0;  // in bits
  int bit(uint64_t p) const {
    if (p >= 8 * (uint64_t)n) return 0;
    int b = data[p >> 3];
    return reversed ? (b >> (p & 7)) & 1 : (b >> (7 - (p & 7))) & 1;
  }
  void need() const {
    if (pos >= 8 * (uint64_t)n) throw FaxEOF{};
  }
  uint32_t peek(int k) const {
    need();
    uint32_t v = 0;
    for (int i = 0; i < k; i++) v = v << 1 | (uint32_t)bit(pos + i);
    return v;
  }
  void skip(int k) { pos += (uint64_t)k; }
  const Entry& lookup(const Table& t) {
    const Entry& e = t.e[peek(t.bits)];
    if (e.state != S_Null) skip(e.width);
    return e;
  }
};

struct Fax {
  Bits b;
  int lastx;
  int mode;  // 2 RLE, 3 Group 3, 4 Group 4
  bool two_d;
  std::vector<int32_t> cur, ref;
  int eolcnt = 0;
  // run state of the row being decoded (tif_fax3.h's locals)
  int32_t a0 = 0, run_length = 0, b1 = 0;
  size_t pa = 0, pb = 0;

  Fax(const uint8_t* data, size_t n, bool reversed, int width, int m,
      bool two)
      : b{data, n, reversed}, lastx(width), mode(m), two_d(two),
        cur((size_t)2 * width + 8), ref((size_t)2 * width + 8) {
    ref[0] = width;  // an all-white reference line (Fax3PreDecode)
    ref[1] = 0;
  }

  void setvalue(int32_t x) {
    if (pa >= cur.size()) fail(kErrFormat, "CCITT row of too many runs");
    cur[pa++] = run_length + x;
    a0 += x;
    run_length = 0;
  }

  // CLEANUP_RUNS: the row's runs made to end at lastx
  void cleanup() {
    if (run_length) setvalue(0);
    if (a0 != lastx) {
      while (a0 > lastx && pa > 0) a0 -= cur[--pa];
      if (a0 < lastx) {
        if (a0 < 0) a0 = 0;
        if (pa & 1) setvalue(0);
        setvalue(lastx - a0);
      } else if (a0 > lastx) {
        setvalue(lastx);
        setvalue(0);
      }
    }
  }

  // one run of a colour (make-up codes, then a terminating code); false
  // where an EOL (in a 1-D row, noted) or a code the table lacks ends the
  // row
  bool run(bool black, bool one_d) {
    const Table& t = black ? tables().black : tables().white;
    for (;;) {
      const Entry& e = b.lookup(t);
      switch (e.state) {
        case S_TermW:
        case S_TermB:
          setvalue(e.param);
          return true;
        case S_MakeUpW:
        case S_MakeUpB:
        case S_MakeUp:
          a0 += e.param;
          run_length += e.param;
          break;
        case S_EOL:
          if (one_d) eolcnt = 1;
          return false;
        default:
          return false;  // libtiff's "unexpected": the row ends
      }
    }
  }

  // EXPAND1D: runs white, black, ... until the row is full
  void expand1d() {
    for (;;) {
      if (!run(false, true) || a0 >= lastx) break;
      if (!run(true, true) || a0 >= lastx) break;
      if (pa >= 2 && cur[pa - 1] == 0 && cur[pa - 2] == 0) pa -= 2;
    }
    cleanup();
  }

  void check_b1() {
    if (pa != 0)
      while (b1 <= a0 && b1 < lastx) {
        if (pb + 1 >= ref.size()) fail(kErrFormat, "CCITT reference runs");
        b1 += ref[pb] + ref[pb + 1];
        pb += 2;
      }
  }

  // EXPAND2D against the reference runs
  void expand2d() {
    while (a0 < lastx) {
      const Entry& e = b.lookup(tables().main);
      switch (e.state) {
        case S_Pass:
          check_b1();
          if (pb + 1 >= ref.size()) fail(kErrFormat, "CCITT reference runs");
          b1 += ref[pb++];
          run_length += b1 - a0;
          a0 = b1;
          b1 += ref[pb++];
          break;
        case S_Horiz: {
          bool black = pa & 1;
          if (!run(black, false) || !run(!black, false)) {
            cleanup();
            return;
          }
          check_b1();
          break;
        }
        case S_V0:
        case S_VR:
          check_b1();
          setvalue(b1 - a0 + (e.state == S_VR ? e.param : 0));
          if (pb >= ref.size()) fail(kErrFormat, "CCITT reference runs");
          b1 += ref[pb++];
          break;
        case S_VL:
          check_b1();
          if (b1 < a0 + e.param) {
            cleanup();
            return;
          }
          setvalue(b1 - a0 - e.param);
          if (pb == 0) fail(kErrFormat, "CCITT reference runs");
          b1 -= ref[--pb];
          break;
        case S_EOL:
          if (pa >= cur.size()) fail(kErrFormat, "CCITT row of too many runs");
          cur[pa++] = lastx - a0;
          b.peek(1);
          b.skip(4);
          eolcnt = 1;
          cleanup();
          return;
        case S_Ext:  // uncompressed mode: not supported by libtiff either
          if (pa >= cur.size()) fail(kErrFormat, "CCITT row of too many runs");
          cur[pa++] = lastx - a0;
          cleanup();
          return;
        default:
          cleanup();
          return;
      }
    }
    if (run_length) {
      if (run_length + a0 < lastx) {  // a final V0 is due
        if (!b.peek(1)) {
          cleanup();
          return;
        }
        b.skip(1);
      }
      setvalue(0);
    }
    cleanup();
  }

  // SYNC_EOL: past the EOL (and any fill) that starts a Group 3 row
  void sync_eol() {
    if (eolcnt == 0)
      for (;;) {
        if (b.peek(11) == 0) break;
        b.skip(1);
      }
    for (;;) {
      if (b.peek(8)) break;
      b.skip(8);
    }
    while (b.peek(1) == 0) b.skip(1);
    b.skip(1);
    eolcnt = 0;
  }

  // _TIFFFax3fillruns: white runs as 0 bits, black as 1 (runs past the
  // row's end cut in place)
  void fill(uint8_t* row) {
    memset(row, 0, (size_t)(lastx + 7) / 8);
    size_t end = pa;
    if (end & 1) {
      if (end >= cur.size()) fail(kErrFormat, "CCITT row of too many runs");
      cur[end++] = 0;
    }
    int32_t x = 0;
    for (size_t i = 0; i < end; i += 2) {
      int32_t r = cur[i];
      if (x + r > lastx || r > lastx) r = cur[i] = lastx - x;
      x += r;
      r = cur[i + 1];
      if (x + r > lastx || r > lastx) r = cur[i + 1] = lastx - x;
      for (int32_t k = x; k < x + r; k++) row[k >> 3] |= 0x80 >> (k & 7);
      x += r;
    }
  }

  void decode(uint8_t* out, int rows, size_t rowbytes) {
    for (int y = 0; y < rows; y++) {
      a0 = 0;
      run_length = 0;
      pa = 0;
      bool one_d = true;
      if (mode == 3) {
        sync_eol();
        if (two_d) {
          one_d = b.peek(1);
          b.skip(1);
        }
      } else if (mode == 4) {
        one_d = false;
      }
      if (one_d) {
        expand1d();
      } else {
        pb = 0;
        b1 = ref[pb++];
        expand2d();
      }
      if (mode == 4 && eolcnt)
        fail(kErrFormat, "CCITT Group 4 data ends (EOFB) before its rows");
      fill(out + (size_t)y * rowbytes);
      if (mode == 2) b.pos = (b.pos + 7) & ~(uint64_t)7;  // byte-aligned
      if (mode == 4 || (mode == 3 && two_d)) {
        if (pa < cur.size()) setvalue(0);  // imaginary change for reference
        cur.swap(ref);
      }
    }
  }
};

// ------------------------------------------------------------- YCbCr
constexpr int kShift = 16;
constexpr int32_t kOneHalf = (int32_t)1 << (kShift - 1);

inline int32_t fix(float x) {
  return (int32_t)(x * (1L << kShift) + 0.5);
}
inline float clampf(float f, float lo, float hi) {
  return f < lo ? lo : (f > hi ? hi : f);
}
// !((f) >= (min)) written that way to take NaN as min (CLAMPw)
inline float clampw(float f, float lo, float hi) {
  return !(f >= lo) ? lo : (f > hi ? hi : f);
}
inline float code2v(int32_t c, float rb, float rw, float cr) {
  return (((float)(c - (int32_t)rb)) * cr) /
         (float)((rw - rb != 0) ? (rw - rb) : 1);
}

struct YCbCr {
  int32_t cr_r[256], cb_b[256], cr_g[256], cb_g[256], y_tab[256];
  YCbCr(const float* luma, const float* rbw) {
    float f1 = 2 - 2 * luma[0];
    int32_t d1 = fix(clampf(f1, 0.0F, 2.0F));
    float f2 = luma[0] * f1 / luma[1];
    int32_t d2 = -fix(clampf(f2, 0.0F, 2.0F));
    float f3 = 2 - 2 * luma[2];
    int32_t d3 = fix(clampf(f3, 0.0F, 2.0F));
    float f4 = luma[2] * f3 / luma[1];
    int32_t d4 = -fix(clampf(f4, 0.0F, 2.0F));
    for (int i = 0, x = -128; i < 256; i++, x++) {
      int32_t cr = (int32_t)clampw(
          code2v(x, rbw[4] - 128.0F, rbw[5] - 128.0F, 127), -128.0F * 32,
          128.0F * 32);
      int32_t cb = (int32_t)clampw(
          code2v(x, rbw[2] - 128.0F, rbw[3] - 128.0F, 127), -128.0F * 32,
          128.0F * 32);
      cr_r[i] = (int32_t)((d1 * cr + kOneHalf) >> kShift);
      cb_b[i] = (int32_t)((d3 * cb + kOneHalf) >> kShift);
      cr_g[i] = d2 * cr;
      cb_g[i] = d4 * cb + kOneHalf;
      y_tab[i] = (int32_t)clampw(code2v(x + 128, rbw[0], rbw[1], 255),
                                 -128.0F * 32, 128.0F * 32);
    }
  }
  static uint8_t clamp8(int32_t v) {
    return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
  }
  void rgb(int y, int cb, int cr, uint8_t* o) const {
    o[0] = clamp8(y_tab[y] + cr_r[cr]);
    o[1] = clamp8(y_tab[y] + (int32_t)((cb_g[cb] + cr_g[cr]) >> kShift));
    o[2] = clamp8(y_tab[y] + cb_b[cb]);
  }
};

// ------------------------------------------------------------- CIELab
constexpr int kLabRange = 1500;  // CIELABTORGB_TABLE_RANGE

struct Lab {
  // display_sRGB of tif_getimage.c
  const float mat[3][3] = {{3.2410F, -1.5374F, -0.4986F},
                           {-0.9692F, 1.8760F, 0.0416F},
                           {0.0556F, -0.2040F, 1.0570F}};
  const float y0 = 1.0F, yc = 100.0F;  // d_Y0R.., d_YCR..
  const uint32_t vrw = 255;            // d_Vrwr..
  float step, x0, y0w, z0;
  float table[kLabRange + 1];

  explicit Lab(const float* white) {
    float ref[3];
    ref[1] = 100.0F;
    ref[0] = white[0] / white[1] * ref[1];
    ref[2] = (1.0F - white[0] - white[1]) / white[1] * ref[1];
    double gamma = 1.0 / 2.4F;
    step = (yc - y0) / kLabRange;  // rstep, and gstep and bstep alike
    for (int i = 0; i <= kLabRange; i++)
      table[i] = vrw * ((float)pow((double)i / kLabRange, gamma));
    x0 = ref[0];
    y0w = ref[1];
    z0 = ref[2];
  }

  void rgb(uint32_t l, int32_t a, int32_t b, uint8_t* o) const {
    float L = (float)l * 100.0F / 65535.0F;
    float cby, tmp, X, Y, Z;
    if (L < 8.856F) {
      Y = (L * y0w) / 903.292F;
      cby = 7.787F * (Y / y0w) + 16.0F / 116.0F;
    } else {
      cby = (L + 16.0F) / 116.0F;
      Y = y0w * cby * cby * cby;
    }
    tmp = (float)a / 256.0F / 500.0F + cby;
    if (tmp < 0.2069F)
      X = x0 * (tmp - 0.13793F) / 7.787F;
    else
      X = x0 * tmp * tmp * tmp;
    tmp = cby - (float)b / 256.0F / 200.0F;
    if (tmp < 0.2069F)
      Z = z0 * (tmp - 0.13793F) / 7.787F;
    else
      Z = z0 * tmp * tmp * tmp;
    for (int c = 0; c < 3; c++) {
      float v = mat[c][0] * X + mat[c][1] * Y + mat[c][2] * Z;
      v = v > y0 ? v : y0;
      v = v < yc ? v : yc;
      size_t i = (size_t)((v - y0) / step);
      i = i < (size_t)kLabRange ? i : (size_t)kLabRange;
      float t = table[i];
      uint32_t r = (uint32_t)(t > 0 ? (t + 0.5) : (t - 0.5));
      o[c] = (uint8_t)(r < vrw ? r : vrw);
    }
  }
};

}  // namespace

extern "C" {

// One CCITT-coded strip or tile of `rows` rows of `width` pixels into out,
// rows of `rowbytes` bytes, MSB-first bits (1: a black run).  mode 2: RLE,
// 3: Group 3 (two_d: T4Options bit 0), 4: Group 4; reversed: FillOrder 2.
int thc_tiff_fax(const uint8_t* in, int64_t n, int mode, int two_d,
                 int reversed, int width, int rows, uint8_t* out,
                 int64_t rowbytes, char* err, int errlen) {
  try {
    if (width <= 0 || rows <= 0 || rowbytes < (width + 7) / 8 ||
        (mode != 2 && mode != 3 && mode != 4))
      fail(kErrArgs, "CCITT strip arguments");
    Fax f(in, (size_t)n, reversed != 0, width, mode, two_d != 0);
    try {
      f.decode(out, rows, (size_t)rowbytes);
    } catch (const FaxEOF&) {
      fail(kErrFormat, "CCITT data ends before the strip's last row");
    }
    return 0;
  } catch (const Error& e) {
    return report(e, err, errlen);
  } catch (const std::exception& e) {
    return report(Error{kErrFormat, e.what()}, err, errlen);
  }
}

// RGB of one contiguous YCbCr strip or tile as tif_getimage.c's put
// routine for subsampling hs x vs draws it: `rows` rows of `width` pixels
// (the part inside the image) from blocks of hs * vs luma samples, Cb and
// Cr, `tile_width` pixels of blocks a row of blocks; luma: the three
// YCbCrCoefficients, rbw: the six ReferenceBlackWhite values.  out:
// rows x width x 3.
int thc_tiff_ycbcr(const uint8_t* in, int64_t n, int rows, int width,
                   int tile_width, int hs, int vs, const float* luma,
                   const float* rbw, uint8_t* out, char* err, int errlen) {
  try {
    const int code = hs << 4 | vs;
    if (code != 0x11 && code != 0x12 && code != 0x21 && code != 0x22 &&
        code != 0x41 && code != 0x42 && code != 0x44)
      fail(kErrUnsupported, "YCbCr subsampling");
    if (rows <= 0 || width <= 0 || tile_width < width)
      fail(kErrArgs, "YCbCr strip arguments");
    const YCbCr t(luma, rbw);
    const int unit = hs * vs + 2;
    // each routine's skip past the blocks right of the image, per row of
    // blocks
    int64_t skew = tile_width - width;
    skew = code == 0x44 ? skew / 4 * (4 * 2 + 2) : skew / hs * unit;
    const int64_t across = (width + hs - 1) / hs;
    const int64_t stride = across * unit + skew;
    const int64_t down = (rows + vs - 1) / vs;
    if ((down - 1) * stride + across * unit > n)
      fail(kErrFormat, "YCbCr strip or tile ends early");
    for (int64_t by = 0; by < down; by++)
      for (int64_t bx = 0; bx < across; bx++) {
        const uint8_t* u = in + by * stride + bx * unit;
        const int cb = u[hs * vs], cr = u[hs * vs + 1];
        for (int j = 0; j < vs; j++) {
          const int64_t y = by * vs + j;
          if (y >= rows) break;
          for (int i = 0; i < hs; i++) {
            const int64_t x = bx * hs + i;
            if (x >= width) break;
            t.rgb(u[j * hs + i], cb, cr, out + (y * width + x) * 3);
          }
        }
      }
    return 0;
  } catch (const Error& e) {
    return report(e, err, errlen);
  } catch (const std::exception& e) {
    return report(Error{kErrFormat, e.what()}, err, errlen);
  }
}

// RGB of `count` CMYK pixels of `spp` samples each (C, M, Y, K first):
// putRGBcontig8bitCMYKtile's (255 - k) * (255 - c) / 255.
int thc_tiff_cmyk(const uint8_t* in, int64_t count, int spp, uint8_t* out,
                  char* err, int errlen) {
  if (spp < 4) return report(Error{kErrArgs, "CMYK of fewer than 4 samples"},
                             err, errlen);
  for (int64_t i = 0; i < count; i++) {
    const uint8_t* p = in + i * spp;
    const uint32_t k = 255 - p[3];
    for (int c = 0; c < 3; c++)
      out[3 * i + c] = (uint8_t)(k * (255 - p[c]) / 255);
  }
  return 0;
}

// RGB of `count` CIELab pixels (L, a, b: 8-bit samples, a and b signed,
// or with sixteen native-order 16-bit ones) under the white point's
// chromaticity white[0], white[1].
int thc_tiff_lab(const uint8_t* in, int64_t count, int sixteen,
                 const float* white, uint8_t* out, char* err, int errlen) {
  try {
    if (white[1] == 0.0F) fail(kErrFormat, "TIFF WhitePoint with y 0");
    const Lab t(white);
    for (int64_t i = 0; i < count; i++) {
      if (sixteen) {
        const uint16_t* p = (const uint16_t*)in + 3 * i;
        t.rgb(p[0], (int16_t)p[1], (int16_t)p[2], out + 3 * i);
      } else {
        const uint8_t* p = in + 3 * i;
        t.rgb((uint32_t)p[0] * 257, (int32_t)(int8_t)p[1] * 256,
              (int32_t)(int8_t)p[2] * 256, out + 3 * i);
      }
    }
    return 0;
  } catch (const Error& e) {
    return report(e, err, errlen);
  } catch (const std::exception& e) {
    return report(Error{kErrFormat, e.what()}, err, errlen);
  }
}

}  // extern "C"

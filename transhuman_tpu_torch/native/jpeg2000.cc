// JPEG 2000 decoder of the PyTorch port's host codec: JP2 files and raw
// codestreams (ISO/IEC 15444-1), decoded to RGB as OpenCV 5's imread decodes
// them through OpenJPEG 2.5 (grfmt_jpeg2000_openjpeg.cpp at IMREAD_COLOR,
// then BGR -> RGB):
//   * the JP2 boxes: the signature, ftyp, then jp2h (ihdr, the first colr,
//     enumerated or ICC; pclr with cmap, the palette applied; cdef, the
//     channels reordered) before jp2c; other boxes are skipped;
//   * the main and tile-part headers: SIZ, COD, COC, QCD, QCC, RGN, POC,
//     PPM, PPT, SOT, SOD and EOC, several tile-parts a tile; TLM, PLM, PLT,
//     CRG, COM and unknown segments are skipped;
//   * tier 2 (t2.c, pi.c): tag trees, coding passes and Lblock, the five
//     progression orders as OpenJPEG's iterators walk them (a packet once,
//     whatever the POC list says), quality layers, precincts, SOP and EPH;
//   * tier 1 (t1.c, mqc.c): the MQ decoder and the three coding passes with
//     every code-block style bit (BYPASS, RESET, TERMALL, VSC, PTERM,
//     SEGSYM), OpenJPEG's mid-point reconstruction and its ROI max-shift;
//   * dequantisation, the integer 5/3 and the float32 9/7 inverse wavelets
//     (dwt.c, the lifting steps of its SSE build, one float operation at a
//     time: this file is compiled with -ffp-contract=off), the RCT and ICT
//     (mct.c), the DC level shift with lrintf (tcd.c);
//   * OpenCV's 8-bit image: each sample >> (highest precision - 8), cast to
//     8 bits; grey replicated under a JP2 grey colour space, else 3 or 4
//     components (alpha dropped), sYCC through cvtColor's fixed-point
//     YUV -> BGR; what cv2 reads as nothing is refused by name.
// Every entry returns 0 on success or a non-zero code, with a message in
// the caller's buffer (2: a variant refused by name, as cv2.imread reads it
// as nothing or this decoder does not reach it).

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

constexpr int kErrFormat = 1;       // malformed
constexpr int kErrUnsupported = 2;  // refused by name
constexpr int kErrArgs = 3;         // the caller's buffers do not match

[[noreturn]] void bad(const std::string& what) {
  fail(kErrFormat, "bad JPEG 2000 " + what);
}
[[noreturn]] void refuse(const std::string& what) {
  fail(kErrUnsupported, "JPEG 2000 " + what);
}

inline uint32_t be16(const uint8_t* p) { return (uint32_t)p[0] << 8 | p[1]; }
inline uint32_t be32(const uint8_t* p) {
  return (uint32_t)p[0] << 24 | (uint32_t)p[1] << 16 | (uint32_t)p[2] << 8 |
         p[3];
}

inline int64_t ceildiv(int64_t a, int64_t b) { return (a + b - 1) / b; }
inline int64_t ceildivpow2(int64_t a, int b) {
  return (a + ((int64_t)1 << b) - 1) >> b;
}
inline int64_t floordivpow2(int64_t a, int b) { return a >> b; }

// ------------------------------------------------------------- parameters
struct Step {
  int expn = 0, mant = 0;
};

struct Tccp {  // one component's coding style and quantisation
  int csty = 0;     // bit 0: precinct sizes given
  int numres = 0;   // decomposition levels + 1
  int cblkw = 0, cblkh = 0;  // log2 of the nominal code-block size
  int cblksty = 0;
  int qmfbid = 0;   // 1: reversible 5/3, 0: irreversible 9/7
  int prcw[33] = {}, prch[33] = {};
  int qntsty = 0, numgbits = 0;
  Step steps[97];
  int roishift = 0;
};

struct Poc {
  int resno0, compno0, layno1, resno1, compno1, prg;
};

struct Tcp {  // one tile's (or the main header's) parameters
  int csty = 0, prg = 0, numlayers = 0, mct = 0;
  bool cod = false, qcd = false;
  std::vector<Tccp> tccps;
  std::vector<Poc> pocs;
  std::vector<std::pair<int, std::vector<uint8_t>>> ppt;  // (Zppt, Ippt)
  std::vector<uint8_t> data;  // the tile-parts' bodies, in order
  int parts = 0;
  int tnsot = 0;  // the tile's count of tile-parts, 0 until a SOT gives it
  bool seen = false;
};

struct Comp {
  int prec = 0, sgnd = 0, dx = 1, dy = 1;
};

enum {
  CBLK_LAZY = 1, CBLK_RESET = 2, CBLK_TERMALL = 4, CBLK_VSC = 8,
  CBLK_PTERM = 16, CBLK_SEGSYM = 32
};

struct Codestream {
  int64_t x0 = 0, y0 = 0, x1 = 0, y1 = 0;       // image area
  int64_t tx0 = 0, ty0 = 0, tdx = 0, tdy = 0;   // tile grid
  int tw = 0, th = 0;
  std::vector<Comp> comps;
  Tcp def;  // the main header's
  std::vector<Tcp> tiles;
  std::vector<std::pair<int, std::vector<uint8_t>>> ppm;  // (Zppm, Ippm)
  std::vector<uint8_t> ppm_data;  // the merged PPM headers
  size_t ppm_pos = 0;
  bool have_ppm = false;
};

// ------------------------------------------------------------ marker reads
struct Seg {  // one marker segment's body
  const uint8_t* p;
  size_t n, pos = 0;
  Seg(const uint8_t* p_, size_t n_) : p(p_), n(n_) {}
  void need(size_t k, const char* m) const {
    if (pos + k > n) bad(std::string(m) + " segment too short");
  }
  uint32_t u8(const char* m) { need(1, m); return p[pos++]; }
  uint32_t u16(const char* m) { need(2, m); pos += 2; return be16(p + pos - 2); }
  uint32_t u32(const char* m) { need(4, m); pos += 4; return be32(p + pos - 4); }
  size_t left() const { return n - pos; }
};

void read_siz(Codestream& cs, Seg s) {
  uint32_t rsiz = s.u16("SIZ");
  if (rsiz & 0x4000) refuse("HTJ2K (Part 15) codestream (Rsiz)");
  cs.x1 = s.u32("SIZ");
  cs.y1 = s.u32("SIZ");
  cs.x0 = s.u32("SIZ");
  cs.y0 = s.u32("SIZ");
  cs.tdx = s.u32("SIZ");
  cs.tdy = s.u32("SIZ");
  cs.tx0 = s.u32("SIZ");
  cs.ty0 = s.u32("SIZ");
  uint32_t nc = s.u16("SIZ");
  if (cs.x0 != 0 || cs.y0 != 0 || cs.tx0 != 0 || cs.ty0 != 0)
    refuse("image with an image or tile-grid offset (cv2 reads no "
           "offset image)");
  if (cs.x1 <= cs.x0 || cs.y1 <= cs.y0) bad("SIZ (empty image)");
  if (cs.tdx == 0 || cs.tdy == 0) bad("SIZ (empty tiles)");
  if (nc == 0 || nc > 16384) bad("SIZ (component count)");
  if (s.left() != 3 * (size_t)nc) bad("SIZ (length)");
  cs.comps.resize(nc);
  for (auto& c : cs.comps) {
    uint32_t ssiz = s.u8("SIZ");
    c.prec = (int)(ssiz & 0x7f) + 1;
    c.sgnd = (int)(ssiz >> 7);
    c.dx = (int)s.u8("SIZ");
    c.dy = (int)s.u8("SIZ");
    if (c.dx == 0 || c.dy == 0) bad("SIZ (component subsampling of 0)");
    if (c.prec > 31) refuse("component precision above 31 bits");
  }
  cs.tw = (int)ceildiv(cs.x1 - cs.tx0, cs.tdx);
  cs.th = (int)ceildiv(cs.y1 - cs.ty0, cs.tdy);
  if ((int64_t)cs.tw * cs.th > 65535) bad("SIZ (more than 65535 tiles)");
  cs.def.tccps.assign(nc, Tccp());
}

// SPcod / SPcoc of tccp (after Scod / Scoc's precinct bit in tccp.csty)
void read_spcod(Seg& s, Tccp& t) {
  t.numres = (int)s.u8("COD/COC") + 1;
  if (t.numres > 33) bad("COD/COC (more than 32 decomposition levels)");
  t.cblkw = (int)s.u8("COD/COC") + 2;
  t.cblkh = (int)s.u8("COD/COC") + 2;
  if (t.cblkw > 10 || t.cblkh > 10 || t.cblkw + t.cblkh > 12)
    bad("COD/COC (code-block size)");
  t.cblksty = (int)s.u8("COD/COC");
  if (t.cblksty & 0xC0)
    refuse("HTJ2K (Part 15) code-blocks (code-block style " +
           std::to_string(t.cblksty) + ")");
  uint32_t tr = s.u8("COD/COC");
  if (tr > 1) refuse("wavelet " + std::to_string(tr) + " (Part 2)");
  t.qmfbid = (int)tr;
  for (int r = 0; r < t.numres; r++) {
    if (t.csty & 1) {
      uint32_t v = s.u8("COD/COC");
      t.prcw[r] = (int)(v & 15);
      t.prch[r] = (int)(v >> 4);
      if (r != 0 && (t.prcw[r] == 0 || t.prch[r] == 0))
        refuse("precinct size of 1 beyond the lowest resolution (OpenJPEG "
               "reads it as an invalid precinct size)");
    } else {
      t.prcw[r] = t.prch[r] = 15;
    }
  }
}

void copy_coding(Tcp& tcp) {
  for (size_t i = 1; i < tcp.tccps.size(); i++) {
    Tccp& d = tcp.tccps[i];
    const Tccp& r = tcp.tccps[0];
    d.numres = r.numres;
    d.cblkw = r.cblkw;
    d.cblkh = r.cblkh;
    d.cblksty = r.cblksty;
    d.qmfbid = r.qmfbid;
    memcpy(d.prcw, r.prcw, sizeof d.prcw);
    memcpy(d.prch, r.prch, sizeof d.prch);
  }
}

void read_cod(Tcp& tcp, Seg s) {
  if (tcp.cod) bad("codestream (a second COD in one header)");
  tcp.cod = true;
  tcp.csty = (int)s.u8("COD");
  if (tcp.csty & ~7) bad("COD (coding style " + std::to_string(tcp.csty) + ")");
  tcp.prg = (int)s.u8("COD");
  if (tcp.prg > 4) bad("COD (progression order)");
  tcp.numlayers = (int)s.u16("COD");
  if (tcp.numlayers == 0 || tcp.numlayers > 65535) bad("COD (no layers)");
  tcp.mct = (int)s.u8("COD");
  if (tcp.mct > 1)
    refuse("component transform " + std::to_string(tcp.mct) + " (Part 2)");
  for (auto& t : tcp.tccps) t.csty = tcp.csty & 1;
  read_spcod(s, tcp.tccps[0]);
  if (s.left()) bad("COD (length)");
  copy_coding(tcp);
}

uint32_t read_compno(Seg& s, size_t nc, const char* m) {
  uint32_t c = nc <= 256 ? s.u8(m) : s.u16(m);
  if (c >= nc) bad(std::string(m) + " (component index)");
  return c;
}

void read_coc(Tcp& tcp, Seg s) {
  uint32_t c = read_compno(s, tcp.tccps.size(), "COC");
  tcp.tccps[c].csty = (int)s.u8("COC");
  read_spcod(s, tcp.tccps[c]);
  if (s.left()) bad("COC (length)");
}

void read_sqcd(Seg& s, Tccp& t, const char* m) {
  uint32_t v = s.u8(m);
  t.qntsty = (int)(v & 0x1f);
  t.numgbits = (int)(v >> 5);
  if (t.qntsty > 2) bad(std::string(m) + " (quantization style)");
  size_t nb = t.qntsty == 1 ? 1 : t.qntsty == 0 ? s.left() : s.left() / 2;
  for (int b = 0; b < 97; b++) t.steps[b] = Step();
  for (size_t b = 0; b < nb; b++) {
    Step st;
    if (t.qntsty == 0) {
      st.expn = (int)(s.u8(m) >> 3);
    } else {
      uint32_t w = s.u16(m);
      st.expn = (int)(w >> 11);
      st.mant = (int)(w & 0x7ff);
    }
    if (b < 97) t.steps[b] = st;
  }
  if (t.qntsty == 1) {  // scalar derived
    for (int b = 1; b < 97; b++) {
      int e = t.steps[0].expn - (b - 1) / 3;
      t.steps[b].expn = e > 0 ? e : 0;
      t.steps[b].mant = t.steps[0].mant;
    }
  }
}

void read_qcd(Tcp& tcp, Seg s) {
  read_sqcd(s, tcp.tccps[0], "QCD");
  if (s.left()) bad("QCD (length)");
  for (size_t i = 1; i < tcp.tccps.size(); i++) {
    Tccp& d = tcp.tccps[i];
    d.qntsty = tcp.tccps[0].qntsty;
    d.numgbits = tcp.tccps[0].numgbits;
    memcpy(d.steps, tcp.tccps[0].steps, sizeof d.steps);
  }
  tcp.qcd = true;
}

void read_qcc(Tcp& tcp, Seg s) {
  uint32_t c = read_compno(s, tcp.tccps.size(), "QCC");
  read_sqcd(s, tcp.tccps[c], "QCC");
  if (s.left()) bad("QCC (length)");
}

void read_rgn(Tcp& tcp, Seg s) {
  uint32_t c = read_compno(s, tcp.tccps.size(), "RGN");
  if (s.u8("RGN") != 0) bad("RGN (ROI style other than implicit)");
  tcp.tccps[c].roishift = (int)s.u8("RGN");
}

void read_poc(Tcp& tcp, Seg s, size_t nc) {
  size_t each = nc <= 256 ? 7 : 9;
  if (s.left() == 0 || s.left() % each) bad("POC (length)");
  while (s.left()) {
    Poc p;
    p.resno0 = (int)s.u8("POC");
    p.compno0 = (int)read_compno(s, nc, "POC");
    p.layno1 = (int)s.u16("POC");
    p.resno1 = (int)s.u8("POC");
    p.compno1 = (int)(nc <= 256 ? s.u8("POC") : s.u16("POC"));
    if (p.compno1 > (int)nc) p.compno1 = (int)nc;
    p.prg = (int)s.u8("POC");
    if (p.prg > 4) bad("POC (progression order)");
    tcp.pocs.push_back(p);
  }
}

// ------------------------------------------------------------ tier 2: bits
struct Bio {  // packet header bits (opj_bio), with bit stuffing after 0xFF
  const uint8_t* start;
  const uint8_t* bp;
  const uint8_t* end;
  uint32_t buf = 0;
  int ct = 0;
  Bio(const uint8_t* p, size_t n) : start(p), bp(p), end(p + n) {}
  void bytein() {
    buf = (buf << 8) & 0xffff;
    ct = buf == 0xff00 ? 7 : 8;
    if (bp < end) buf |= *bp++;
  }
  uint32_t bit() {
    if (ct == 0) bytein();
    ct--;
    return (buf >> ct) & 1;
  }
  uint32_t read(int n) {
    uint32_t v = 0;
    for (int i = n - 1; i >= 0; i--) v |= bit() << i;
    return v;
  }
  void inalign() {
    if ((buf & 0xff) == 0xff) bytein();
    ct = 0;
  }
  size_t numbytes() const { return (size_t)(bp - start); }
};

struct TagTree {
  struct Node {
    int parent, value, low;
  };
  std::vector<Node> nodes;
  void build(int w, int h) {
    nodes.clear();
    std::vector<int> lw{w}, lh{h};
    int n;
    do {
      n = lw.back() * lh.back();
      lw.push_back((lw.back() + 1) / 2);
      lh.push_back((lh.back() + 1) / 2);
    } while (n > 1);
    size_t levels = lw.size() - 1;
    std::vector<int> base(levels + 1, 0);
    for (size_t l = 0; l < levels; l++) base[l + 1] = base[l] + lw[l] * lh[l];
    nodes.resize(base[levels]);
    for (size_t l = 0; l < levels; l++)
      for (int j = 0; j < lh[l]; j++)
        for (int i = 0; i < lw[l]; i++) {
          Node& nd = nodes[base[l] + j * lw[l] + i];
          nd.parent = l + 1 < levels
                          ? base[l + 1] + (j / 2) * lw[l + 1] + i / 2 : -1;
          nd.value = 999;
          nd.low = 0;
        }
  }
  uint32_t decode(Bio& bio, int leaf, int threshold) {
    int stk[64], sp = 0;
    int node = leaf;
    while (nodes[node].parent >= 0) {
      stk[sp++] = node;
      node = nodes[node].parent;
    }
    int low = 0;
    for (;;) {
      Node& nd = nodes[node];
      if (low > nd.low) nd.low = low; else low = nd.low;
      while (low < threshold && low < nd.value) {
        if (bio.bit()) nd.value = low; else ++low;
      }
      nd.low = low;
      if (sp == 0) break;
      node = stk[--sp];
    }
    return nodes[node].value < threshold ? 1 : 0;
  }
};

// --------------------------------------------------------- tile structure
struct CodeSeg {
  uint32_t len = 0, numpasses = 0, maxpasses = 0, newlen = 0, numnewpasses = 0;
};

struct Cblk {
  int x0, y0, x1, y1;  // band coordinates
  int numbps = 0, numlenbits = 0, numnewpasses = 0;
  int numsegs = 0;
  std::vector<CodeSeg> segs;
  std::vector<uint8_t> data;
};

struct Precinct {
  int cw = 0, ch = 0;
  std::vector<Cblk> cblks;
  TagTree incl, imsb;
};

struct Band {
  int bandno;  // 0 LL, 1 HL, 2 LH, 3 HH
  int64_t x0, y0, x1, y1;
  int numbps;
  float stepsize;
  std::vector<Precinct> precs;
  bool empty() const { return x1 - x0 == 0 || y1 - y0 == 0; }
};

struct Res {
  int64_t x0, y0, x1, y1;
  int pdx, pdy, pw, ph;
  std::vector<Band> bands;
};

struct TileComp {
  int64_t x0, y0, x1, y1;
  int numres;
  std::vector<Res> res;
  std::vector<int32_t> data;  // int32, or float32 bits for the 9/7
  int64_t w() const { return x1 - x0; }
  int64_t h() const { return y1 - y0; }
};

void init_seg(Cblk& cb, int index, int cblksty, bool first) {
  if ((int)cb.segs.size() <= index) cb.segs.resize(index + 1);
  CodeSeg& s = cb.segs[index];
  s = CodeSeg();
  if (cblksty & CBLK_TERMALL) {
    s.maxpasses = 1;
  } else if (cblksty & CBLK_LAZY) {
    if (first) {
      s.maxpasses = 10;
    } else {
      uint32_t prev = cb.segs[index - 1].maxpasses;
      s.maxpasses = (prev == 1 || prev == 10) ? 2 : 1;
    }
  } else {
    s.maxpasses = 109;
  }
}

void init_tilecomp(TileComp& tc, const Comp& comp, const Tccp& tccp,
                   int64_t tx0, int64_t ty0, int64_t tx1, int64_t ty1) {
  tc.x0 = tx0;  // components are not sub-sampled (parse refuses them)
  tc.y0 = ty0;
  tc.x1 = tx1;
  tc.y1 = ty1;
  tc.numres = tccp.numres;
  tc.res.resize(tc.numres);
  tc.data.assign((size_t)(tc.w() * tc.h()), 0);
  for (int r = 0; r < tc.numres; r++) {
    Res& res = tc.res[r];
    int levelno = tc.numres - 1 - r;
    res.x0 = ceildivpow2(tc.x0, levelno);
    res.y0 = ceildivpow2(tc.y0, levelno);
    res.x1 = ceildivpow2(tc.x1, levelno);
    res.y1 = ceildivpow2(tc.y1, levelno);
    res.pdx = tccp.prcw[r];
    res.pdy = tccp.prch[r];
    int64_t px0 = floordivpow2(res.x0, res.pdx) << res.pdx;
    int64_t py0 = floordivpow2(res.y0, res.pdy) << res.pdy;
    int64_t px1 = ceildivpow2(res.x1, res.pdx) << res.pdx;
    int64_t py1 = ceildivpow2(res.y1, res.pdy) << res.pdy;
    res.pw = res.x0 == res.x1 ? 0 : (int)((px1 - px0) >> res.pdx);
    res.ph = res.y0 == res.y1 ? 0 : (int)((py1 - py0) >> res.pdy);
    if ((int64_t)res.pw * res.ph > (1 << 24)) bad("tile (too many precincts)");
    int64_t cbgx0, cbgy0;
    int cbgw, cbgh;
    if (r == 0) {
      cbgx0 = px0;
      cbgy0 = py0;
      cbgw = res.pdx;
      cbgh = res.pdy;
    } else {
      cbgx0 = ceildivpow2(px0, 1);
      cbgy0 = ceildivpow2(py0, 1);
      cbgw = res.pdx - 1;
      cbgh = res.pdy - 1;
    }
    int cbw = std::min(tccp.cblkw, cbgw);
    int cbh = std::min(tccp.cblkh, cbgh);
    int nb = r == 0 ? 1 : 3;
    res.bands.resize(nb);
    for (int b = 0; b < nb; b++) {
      Band& band = res.bands[b];
      band.bandno = r == 0 ? 0 : b + 1;
      if (r == 0) {
        band.x0 = ceildivpow2(tc.x0, levelno);
        band.y0 = ceildivpow2(tc.y0, levelno);
        band.x1 = ceildivpow2(tc.x1, levelno);
        band.y1 = ceildivpow2(tc.y1, levelno);
      } else {
        int64_t xob = band.bandno & 1, yob = band.bandno >> 1;
        band.x0 = ceildivpow2(tc.x0 - (xob << levelno), levelno + 1);
        band.y0 = ceildivpow2(tc.y0 - (yob << levelno), levelno + 1);
        band.x1 = ceildivpow2(tc.x1 - (xob << levelno), levelno + 1);
        band.y1 = ceildivpow2(tc.y1 - (yob << levelno), levelno + 1);
      }
      const Step& st = tccp.steps[r == 0 ? 0 : 3 * (r - 1) + b + 1];
      // tcd.c: the 9/7's log2 gain is 0 in the decoder (its
      // BUG_WEIRD_TWO_INVK; the inverse wavelet scales by 2/K)
      int gain = tccp.qmfbid == 0 ? 0 : band.bandno == 0 ? 0
                 : band.bandno == 3 ? 2 : 1;
      int rb = comp.prec + gain;
      band.stepsize = (float)((1.0 + st.mant / 2048.0) *
                              pow(2.0, (int)(rb - st.expn)));
      band.numbps = st.expn + tccp.numgbits - 1;
      int nprec = res.pw * res.ph;
      band.precs.resize(nprec);
      for (int p = 0; p < nprec; p++) {
        Precinct& pr = band.precs[p];
        int64_t gx0 = cbgx0 + (int64_t)(p % res.pw) * ((int64_t)1 << cbgw);
        int64_t gy0 = cbgy0 + (int64_t)(p / res.pw) * ((int64_t)1 << cbgh);
        int64_t gx1 = gx0 + ((int64_t)1 << cbgw);
        int64_t gy1 = gy0 + ((int64_t)1 << cbgh);
        int64_t prx0 = std::max(gx0, band.x0), pry0 = std::max(gy0, band.y0);
        int64_t prx1 = std::min(gx1, band.x1), pry1 = std::min(gy1, band.y1);
        int64_t cx0 = floordivpow2(prx0, cbw) << cbw;
        int64_t cy0 = floordivpow2(pry0, cbh) << cbh;
        int64_t cx1 = ceildivpow2(prx1, cbw) << cbw;
        int64_t cy1 = ceildivpow2(pry1, cbh) << cbh;
        pr.cw = (int)std::max<int64_t>(0, (cx1 - cx0) >> cbw);
        pr.ch = (int)std::max<int64_t>(0, (cy1 - cy0) >> cbh);
        int n = pr.cw * pr.ch;
        pr.cblks.resize(n);
        for (int k = 0; k < n; k++) {
          Cblk& cb = pr.cblks[k];
          int64_t bx0 = cx0 + (int64_t)(k % pr.cw) * ((int64_t)1 << cbw);
          int64_t by0 = cy0 + (int64_t)(k / pr.cw) * ((int64_t)1 << cbh);
          cb.x0 = (int)std::max(bx0, prx0);
          cb.y0 = (int)std::max(by0, pry0);
          cb.x1 = (int)std::min(bx0 + ((int64_t)1 << cbw), prx1);
          cb.y1 = (int)std::min(by0 + ((int64_t)1 << cbh), pry1);
        }
        if (n) {
          pr.incl.build(pr.cw, pr.ch);
          pr.imsb.build(pr.cw, pr.ch);
        }
      }
    }
  }
}

// ------------------------------------------------------ progression order
struct Packet {
  int layno, resno, compno, precno;
};

// the packets of a tile in OpenJPEG's order (pi.c: opj_pi_next_*)
std::vector<Packet> packet_order(const Codestream& cs, const Tcp& tcp,
                                 const std::vector<TileComp>& tcs,
                                 int64_t tx0, int64_t ty0, int64_t tx1,
                                 int64_t ty1) {
  const int nc = (int)cs.comps.size();
  int maxres = 0, maxprec = 0;
  for (int c = 0; c < nc; c++) {
    maxres = std::max(maxres, tcs[c].numres);
    for (const Res& r : tcs[c].res) maxprec = std::max(maxprec, r.pw * r.ph);
  }
  const int64_t step_p = 1, step_c = (int64_t)maxprec * step_p,
                step_r = nc * step_c, step_l = maxres * step_r;
  std::vector<uint8_t> include((size_t)(tcp.numlayers * step_l), 0);
  std::vector<Packet> out;
  auto emit = [&](int l, int r, int c, int p) {
    size_t idx = (size_t)(l * step_l + r * step_r + c * step_c + p * step_p);
    if (idx >= include.size()) bad("tile (packet index out of range)");
    if (!include[idx]) {
      include[idx] = 1;
      out.push_back({l, r, c, p});
    }
  };
  std::vector<Poc> pocs;
  if (!tcp.pocs.empty()) {
    for (const Poc& p : tcp.pocs) {
      Poc q = p;
      q.layno1 = std::min(p.layno1, tcp.numlayers);
      pocs.push_back(q);
    }
  } else {
    pocs.push_back({0, 0, tcp.numlayers, maxres, nc, tcp.prg});
  }
  // precinct position test of RPCL, PCRL and CPRL at (x, y)
  auto at = [&](int c, int r, int64_t x, int64_t y, int* precno) -> bool {
    const TileComp& tc = tcs[c];
    if (r >= tc.numres) return false;
    const Res& res = tc.res[r];
    int levelno = tc.numres - 1 - r;
    if (levelno >= 32) return false;
    int64_t trx0 = ceildivpow2(tx0, levelno), try0 = ceildivpow2(ty0, levelno);
    int64_t trx1 = ceildivpow2(tx1, levelno), try1 = ceildivpow2(ty1, levelno);
    int rpx = res.pdx + levelno, rpy = res.pdy + levelno;
    if (rpx >= 31 || rpy >= 31) return false;
    if (!((y % ((int64_t)1 << rpy) == 0) ||
          (y == ty0 && ((try0 << levelno) % ((int64_t)1 << rpy)))))
      return false;
    if (!((x % ((int64_t)1 << rpx) == 0) ||
          (x == tx0 && ((trx0 << levelno) % ((int64_t)1 << rpx)))))
      return false;
    if (res.pw == 0 || res.ph == 0) return false;
    if (trx0 == trx1 || try0 == try1) return false;
    int64_t prci = floordivpow2(ceildivpow2(x, levelno), res.pdx) -
                   floordivpow2(trx0, res.pdx);
    int64_t prcj = floordivpow2(ceildivpow2(y, levelno), res.pdy) -
                   floordivpow2(try0, res.pdy);
    *precno = (int)(prci + prcj * res.pw);
    return true;
  };
  auto steps = [&](int c0, int c1, int64_t* dx, int64_t* dy) {
    *dx = 0;
    *dy = 0;
    for (int c = c0; c < c1; c++)
      for (int r = 0; r < tcs[c].numres; r++) {
        const Res& res = tcs[c].res[r];
        int levelno = tcs[c].numres - 1 - r;
        if (res.pdx + levelno < 32) {
          int64_t d = (int64_t)1 << (res.pdx + levelno);
          *dx = *dx ? std::min(*dx, d) : d;
        }
        if (res.pdy + levelno < 32) {
          int64_t d = (int64_t)1 << (res.pdy + levelno);
          *dy = *dy ? std::min(*dy, d) : d;
        }
      }
    if (*dx == 0 || *dy == 0) bad("tile (precinct step)");
  };
  for (const Poc& poc : pocs) {
    const int l1 = poc.layno1;
    int64_t dx, dy;
    switch (poc.prg) {
      case 0:  // LRCP
        for (int l = 0; l < l1; l++)
          for (int r = poc.resno0; r < poc.resno1; r++)
            for (int c = poc.compno0; c < poc.compno1; c++) {
              if (r >= tcs[c].numres) continue;
              int np = tcs[c].res[r].pw * tcs[c].res[r].ph;
              for (int p = 0; p < np; p++) emit(l, r, c, p);
            }
        break;
      case 1:  // RLCP
        for (int r = poc.resno0; r < poc.resno1; r++)
          for (int l = 0; l < l1; l++)
            for (int c = poc.compno0; c < poc.compno1; c++) {
              if (r >= tcs[c].numres) continue;
              int np = tcs[c].res[r].pw * tcs[c].res[r].ph;
              for (int p = 0; p < np; p++) emit(l, r, c, p);
            }
        break;
      case 2:  // RPCL
        steps(0, nc, &dx, &dy);
        for (int r = poc.resno0; r < poc.resno1; r++)
          for (int64_t y = ty0; y < ty1; y += dy - y % dy)
            for (int64_t x = tx0; x < tx1; x += dx - x % dx)
              for (int c = poc.compno0; c < poc.compno1; c++) {
                int p;
                if (!at(c, r, x, y, &p)) continue;
                for (int l = 0; l < l1; l++) emit(l, r, c, p);
              }
        break;
      case 3:  // PCRL
        steps(0, nc, &dx, &dy);
        for (int64_t y = ty0; y < ty1; y += dy - y % dy)
          for (int64_t x = tx0; x < tx1; x += dx - x % dx)
            for (int c = poc.compno0; c < poc.compno1; c++)
              for (int r = poc.resno0;
                   r < std::min(poc.resno1, tcs[c].numres); r++) {
                int p;
                if (!at(c, r, x, y, &p)) continue;
                for (int l = 0; l < l1; l++) emit(l, r, c, p);
              }
        break;
      case 4:  // CPRL
        for (int c = poc.compno0; c < poc.compno1; c++) {
          steps(c, c + 1, &dx, &dy);
          for (int64_t y = ty0; y < ty1; y += dy - y % dy)
            for (int64_t x = tx0; x < tx1; x += dx - x % dx)
              for (int r = poc.resno0;
                   r < std::min(poc.resno1, tcs[c].numres); r++) {
                int p;
                if (!at(c, r, x, y, &p)) continue;
                for (int l = 0; l < l1; l++) emit(l, r, c, p);
              }
        }
        break;
    }
  }
  return out;
}

// ---------------------------------------------------------- tier 2: packets
uint32_t getnumpasses(Bio& bio) {
  if (!bio.bit()) return 1;
  if (!bio.bit()) return 2;
  uint32_t n = bio.read(2);
  if (n != 3) return 3 + n;
  n = bio.read(5);
  if (n != 31) return 6 + n;
  return 37 + bio.read(7);
}

inline int floorlog2(uint32_t v) {
  int l = 0;
  while (v > 1) {
    v >>= 1;
    l++;
  }
  return l;
}

// One packet: its header from hdr (at *hpos, of hlen bytes: the tile's body
// or the PPM/PPT headers), its body from body at *bpos.
void read_packet(const Tcp& tcp, TileComp& tc, const Packet& pk,
                 const uint8_t* hdr, size_t hlen, size_t* hpos,
                 const uint8_t* body, size_t blen, size_t* bpos,
                 bool separate) {
  const Tccp& tccp = tcp.tccps[pk.compno];
  Res& res = tc.res[pk.resno];
  if (tcp.csty & 2) {  // SOP
    if (blen - *bpos >= 6 && body[*bpos] == 0xff && body[*bpos + 1] == 0x91)
      *bpos += 6;
  }
  if (!separate) *hpos = *bpos;
  Bio bio(hdr + *hpos, hlen - *hpos);
  bool present = bio.bit();
  if (present) {
    for (Band& band : res.bands) {
      if (band.empty()) continue;
      Precinct& pr = band.precs[pk.precno];
      for (int k = 0; k < (int)pr.cblks.size(); k++) {
        Cblk& cb = pr.cblks[k];
        uint32_t included;
        if (!cb.numsegs)
          included = pr.incl.decode(bio, k, pk.layno + 1);
        else
          included = bio.bit();
        if (!included) {
          cb.numnewpasses = 0;
          continue;
        }
        if (!cb.numsegs) {
          int i = 0;
          while (!pr.imsb.decode(bio, k, i)) {
            ++i;
            if (i > 74) bad("packet header (zero bit-planes)");
          }
          cb.numbps = band.numbps + 1 - i;
          cb.numlenbits = 3;
        }
        cb.numnewpasses = (int)getnumpasses(bio);
        uint32_t inc = 0;
        while (bio.bit()) {
          if (++inc > 32) bad("packet header (Lblock)");
        }
        cb.numlenbits += (int)inc;
        int segno = 0;
        if (!cb.numsegs) {
          init_seg(cb, 0, tccp.cblksty, true);
        } else {
          segno = cb.numsegs - 1;
          if (cb.segs[segno].numpasses == cb.segs[segno].maxpasses) {
            ++segno;
            init_seg(cb, segno, tccp.cblksty, false);
          }
        }
        int n = cb.numnewpasses;
        do {
          CodeSeg& sg = cb.segs[segno];
          sg.numnewpasses = std::min<uint32_t>(sg.maxpasses - sg.numpasses,
                                               (uint32_t)n);
          int bits = cb.numlenbits + floorlog2(sg.numnewpasses);
          if (bits > 32) bad("packet header (length bits)");
          sg.newlen = bio.read(bits);
          n -= (int)sg.numnewpasses;
          if (n > 0) {
            ++segno;
            init_seg(cb, segno, tccp.cblksty, false);
          }
        } while (n > 0);
      }
    }
  }
  bio.inalign();
  size_t h = *hpos + bio.numbytes();
  if (tcp.csty & 4) {  // EPH
    if (hlen - h >= 2 && hdr[h] == 0xff && hdr[h + 1] == 0x92) h += 2;
  }
  *hpos = h;
  if (!separate) *bpos = h;
  if (!present) return;
  for (Band& band : res.bands) {
    if (band.empty()) continue;
    Precinct& pr = band.precs[pk.precno];
    for (Cblk& cb : pr.cblks) {
      if (!cb.numnewpasses) continue;
      int segno;
      if (!cb.numsegs) {
        segno = 0;
        cb.numsegs = 1;
      } else {
        segno = cb.numsegs - 1;
        if (cb.segs[segno].numpasses == cb.segs[segno].maxpasses) {
          ++segno;
          ++cb.numsegs;
        }
      }
      do {
        CodeSeg& sg = cb.segs[segno];
        if (sg.newlen > blen - *bpos)
          fail(kErrUnsupported,
               "cut JPEG 2000 codestream (a code-block's data runs past its "
               "tile-part)");
        cb.data.insert(cb.data.end(), body + *bpos, body + *bpos + sg.newlen);
        *bpos += sg.newlen;
        sg.len += sg.newlen;
        sg.numpasses += sg.numnewpasses;
        cb.numnewpasses -= (int)sg.numnewpasses;
        if (cb.numnewpasses > 0) {
          ++segno;
          ++cb.numsegs;
        }
      } while (cb.numnewpasses > 0);
    }
  }
}

// ---------------------------------------------------------- tier 1: MQ
struct QeState {
  uint16_t qe;
  uint8_t nmps, nlps, sw;
};
const QeState kQe[47] = {
    {0x5601, 1, 1, 1},   {0x3401, 2, 6, 0},   {0x1801, 3, 9, 0},
    {0x0AC1, 4, 12, 0},  {0x0521, 5, 29, 0},  {0x0221, 38, 33, 0},
    {0x5601, 7, 6, 1},   {0x5401, 8, 14, 0},  {0x4801, 9, 14, 0},
    {0x3801, 10, 14, 0}, {0x3001, 11, 17, 0}, {0x2401, 12, 18, 0},
    {0x1C01, 13, 20, 0}, {0x1601, 29, 21, 0}, {0x5601, 15, 14, 1},
    {0x5401, 16, 14, 0}, {0x5101, 17, 15, 0}, {0x4801, 18, 16, 0},
    {0x3801, 19, 17, 0}, {0x3401, 20, 18, 0}, {0x3001, 21, 19, 0},
    {0x2801, 22, 19, 0}, {0x2401, 23, 20, 0}, {0x2201, 24, 21, 0},
    {0x1C01, 25, 22, 0}, {0x1801, 26, 23, 0}, {0x1601, 27, 24, 0},
    {0x1401, 28, 25, 0}, {0x1201, 29, 26, 0}, {0x1101, 30, 27, 0},
    {0x0AC1, 31, 28, 0}, {0x09C1, 32, 29, 0}, {0x08A1, 33, 30, 0},
    {0x0521, 34, 31, 0}, {0x0441, 35, 32, 0}, {0x02A1, 36, 33, 0},
    {0x0221, 37, 34, 0}, {0x0141, 38, 35, 0}, {0x0111, 39, 36, 0},
    {0x0085, 40, 37, 0}, {0x0049, 41, 38, 0}, {0x0025, 42, 39, 0},
    {0x0015, 43, 40, 0}, {0x0009, 44, 41, 0}, {0x0005, 45, 42, 0},
    {0x0001, 45, 43, 0}, {0x5601, 46, 46, 0}};

enum { CTX_ZC = 0, CTX_SC = 9, CTX_MAG = 14, CTX_AGG = 17, CTX_UNI = 18,
       NUM_CTX = 19 };

struct Mqc {
  const uint8_t* bp;  // the segment, followed by 0xFF 0xFF
  uint32_t a = 0, c = 0, ct = 0;
  uint8_t state[NUM_CTX], mps[NUM_CTX];

  void reset_states() {
    memset(state, 0, sizeof state);
    memset(mps, 0, sizeof mps);
    state[CTX_UNI] = 46;
    state[CTX_AGG] = 3;
    state[CTX_ZC] = 4;
  }
  void bytein() {
    uint32_t next = bp[1];
    if (*bp == 0xff) {
      if (next > 0x8f) {
        c += 0xff00;
        ct = 8;
      } else {
        bp++;
        c += next << 9;
        ct = 7;
      }
    } else {
      bp++;
      c += next << 8;
      ct = 8;
    }
  }
  void init(const uint8_t* p) {
    bp = p;
    c = (uint32_t)*bp << 16;
    bytein();
    c <<= 7;
    ct -= 7;
    a = 0x8000;
  }
  void renorm() {
    do {
      if (ct == 0) bytein();
      a <<= 1;
      c <<= 1;
      ct--;
    } while (a < 0x8000);
  }
  inline __attribute__((always_inline)) int decode(int cx) {
    const QeState& s = kQe[state[cx]];
    uint32_t qe = s.qe;
    int d;
    a -= qe;
    if ((c >> 16) < qe) {  // LPS exchange
      if (a < qe) {
        a = qe;
        d = mps[cx];
        state[cx] = s.nmps;
      } else {
        a = qe;
        d = 1 - mps[cx];
        if (s.sw) mps[cx] = (uint8_t)(1 - mps[cx]);
        state[cx] = s.nlps;
      }
      renorm();
    } else {
      c -= qe << 16;
      if ((a & 0x8000) == 0) {  // MPS exchange
        if (a < qe) {
          d = 1 - mps[cx];
          if (s.sw) mps[cx] = (uint8_t)(1 - mps[cx]);
          state[cx] = s.nlps;
        } else {
          d = mps[cx];
          state[cx] = s.nmps;
        }
        renorm();
      } else {
        d = mps[cx];
      }
    }
    return d;
  }
  // BYPASS (raw) segments
  void raw_init(const uint8_t* p) {
    bp = p;
    c = 0;
    ct = 0;
  }
  int raw() {
    if (ct == 0) {
      if (c == 0xff) {
        if (*bp > 0x8f) {
          c = 0xff;
          ct = 8;
        } else {
          c = *bp++;
          ct = 7;
        }
      } else {
        c = *bp++;
        ct = 8;
      }
    }
    ct--;
    return (int)((c >> ct) & 1);
  }
};

// ---------------------------------------------------------- tier 1: passes
// Per-sample flags: which of the eight neighbours are significant, the
// signs of the four direct ones, and the sample's own state.
enum : uint32_t {
  F_N = 1, F_S = 2, F_W = 4, F_E = 8, F_NW = 16, F_NE = 32, F_SW = 64,
  F_SE = 128, F_NEG_N = 256, F_NEG_S = 512, F_NEG_W = 1024, F_NEG_E = 2048,
  F_SIG = 4096, F_VISIT = 8192, F_REFINED = 16384
};

struct Luts {
  uint8_t zc[4][256];
  uint8_t sc[256], spb[256];  // index: (F_N..F_E) | negs >> 4
  Luts() {
    for (int o = 0; o < 4; o++)
      for (int f = 0; f < 256; f++) {
        int h = !!(f & F_W) + !!(f & F_E);
        int v = !!(f & F_N) + !!(f & F_S);
        int d = !!(f & F_NW) + !!(f & F_NE) + !!(f & F_SW) + !!(f & F_SE);
        int ctx;
        if (o == 1) std::swap(h, v);
        if (o == 3) {
          int hv = h + v;
          if (d >= 3) ctx = 8;
          else if (d == 2) ctx = hv >= 1 ? 7 : 6;
          else if (d == 1) ctx = hv >= 2 ? 5 : hv == 1 ? 4 : 3;
          else ctx = hv >= 2 ? 2 : hv == 1 ? 1 : 0;
        } else {
          if (h == 2) ctx = 8;
          else if (h == 1) ctx = v >= 1 ? 7 : d >= 1 ? 6 : 5;
          else if (v == 2) ctx = 4;
          else if (v == 1) ctx = 3;
          else ctx = d >= 2 ? 2 : d == 1 ? 1 : 0;
        }
        zc[o][f] = (uint8_t)ctx;
      }
    for (int f = 0; f < 256; f++) {
      // bits 0-3: N, S, W, E significant; bits 4-7: their signs
      auto contrib = [&](int sigbit, int negbit) {
        if (!(f & sigbit)) return 0;
        return (f & negbit) ? -1 : 1;
      };
      int hc = contrib(4, 64) + contrib(8, 128);
      int vc = contrib(1, 16) + contrib(2, 32);
      hc = std::max(-1, std::min(1, hc));
      vc = std::max(-1, std::min(1, vc));
      int ctx, x = 0;
      if (hc == 0 && vc == 0) ctx = 9;
      else if (hc == 0) { ctx = 10; x = vc < 0; }
      else if (hc == 1) ctx = vc == 1 ? 13 : vc == 0 ? 12 : 11;
      else { ctx = vc == -1 ? 13 : vc == 0 ? 12 : 11; x = 1; }
      sc[f] = (uint8_t)ctx;
      spb[f] = (uint8_t)x;
    }
  }
};
const Luts kLuts;

struct T1 {
  int w = 0, h = 0, stride = 0;
  std::vector<uint32_t> flags;  // (h + 2) x (w + 2), a border around
  std::vector<int32_t> data;    // h x w
  Mqc mqc;
  int orient = 0;
  bool vsc = false;

  uint32_t* fl(int x, int y) { return &flags[(size_t)(y + 1) * stride + x + 1]; }

  void set_sig(int x, int y, int neg) {
    uint32_t* f = fl(x, y);
    *f |= F_SIG;
    f[-1] |= F_E | (neg ? (uint32_t)F_NEG_E : 0u);
    f[1] |= F_W | (neg ? (uint32_t)F_NEG_W : 0u);
    if (!(vsc && (y & 3) == 0)) {  // the stripe above, unless causal
      uint32_t* n = f - stride;
      n[0] |= F_S | (neg ? (uint32_t)F_NEG_S : 0u);
      n[-1] |= F_SE;
      n[1] |= F_SW;
    }
    uint32_t* s = f + stride;
    s[0] |= F_N | (neg ? (uint32_t)F_NEG_N : 0u);
    s[-1] |= F_NE;
    s[1] |= F_NW;
  }
  int sign_ctx(uint32_t f, int* x) {
    int i = (int)((f & 15) | ((f >> 8) & 15) << 4);
    *x = kLuts.spb[i];
    return CTX_SC + kLuts.sc[i] - 9;
  }
  int decode_sign(uint32_t f) {
    int x;
    int cx = sign_ctx(f, &x);
    return mqc.decode(cx) ^ x;
  }

  void sigpass(int bp, bool raw) {
    const int32_t one = 1 << bp, oneplushalf = one | (one >> 1);
    for (int y0 = 0; y0 < h; y0 += 4)
      for (int x = 0; x < w; x++)
        for (int y = y0; y < std::min(y0 + 4, h); y++) {
          uint32_t* f = fl(x, y);
          if ((*f & (F_SIG | F_VISIT)) || !(*f & 0xff)) continue;
          int v;
          if (raw) {
            v = mqc.raw();
          } else {
            v = mqc.decode(CTX_ZC + kLuts.zc[orient][*f & 0xff]);
          }
          if (v) {
            int neg = raw ? mqc.raw() : decode_sign(*f);
            data[(size_t)y * w + x] = neg ? -oneplushalf : oneplushalf;
            set_sig(x, y, neg);
          }
          *f |= F_VISIT;
        }
  }
  void refpass(int bp, bool raw) {
    const int32_t poshalf = (1 << bp) >> 1;
    for (int y0 = 0; y0 < h; y0 += 4)
      for (int x = 0; x < w; x++)
        for (int y = y0; y < std::min(y0 + 4, h); y++) {
          uint32_t* f = fl(x, y);
          if ((*f & (F_SIG | F_VISIT)) != F_SIG) continue;
          int v;
          if (raw) {
            v = mqc.raw();
          } else {
            int cx = (*f & F_REFINED) ? CTX_MAG + 2
                     : (*f & 0xff) ? CTX_MAG + 1 : CTX_MAG;
            v = mqc.decode(cx);
          }
          int32_t& d = data[(size_t)y * w + x];
          d += (v ^ (d < 0)) ? poshalf : -poshalf;
          *f |= F_REFINED;
        }
  }
  void clnpass(int bp, bool segsym) {
    const int32_t one = 1 << bp, oneplushalf = one | (one >> 1);
    auto step = [&](int x, int y, bool decided) {
      uint32_t* f = fl(x, y);
      if (!decided) {
        if (*f & (F_SIG | F_VISIT)) return;
        if (!mqc.decode(CTX_ZC + kLuts.zc[orient][*f & 0xff])) return;
      }
      int neg = decode_sign(*f);
      data[(size_t)y * w + x] = neg ? -oneplushalf : oneplushalf;
      set_sig(x, y, neg);
    };
    for (int y0 = 0; y0 < h; y0 += 4)
      for (int x = 0; x < w; x++) {
        int y = y0;
        if (y0 + 4 <= h) {
          bool agg = true;
          for (int k = 0; k < 4 && agg; k++) {
            uint32_t f = *fl(x, y0 + k);
            if ((f & (F_SIG | F_VISIT)) || (f & 0xff)) agg = false;
          }
          if (agg) {
            if (!mqc.decode(CTX_AGG)) continue;
            int r = mqc.decode(CTX_UNI) << 1;
            r |= mqc.decode(CTX_UNI);
            step(x, y0 + r, true);
            y = y0 + r + 1;
          }
        }
        for (; y < std::min(y0 + 4, h); y++) step(x, y, false);
        for (int k = y0; k < std::min(y0 + 4, h); k++) *fl(x, k) &= ~F_VISIT;
      }
    if (segsym) {
      for (int k = 0; k < 4; k++) mqc.decode(CTX_UNI);
    }
  }

  // decode one code-block (t1.c: opj_t1_decode_cblk) into data
  void decode(const Cblk& cb, int orient_, int roishift, int cblksty) {
    w = std::max(0, cb.x1 - cb.x0);
    h = std::max(0, cb.y1 - cb.y0);
    stride = w + 2;
    orient = orient_;
    vsc = (cblksty & CBLK_VSC) != 0;
    flags.assign((size_t)(h + 2) * stride, 0);
    data.assign((size_t)w * h, 0);
    if (w == 0 || h == 0) return;
    int bpno_plus_one = roishift + cb.numbps;
    if (bpno_plus_one >= 31) bad("code-block (more than 30 bit-planes)");
    int passtype = 2;
    mqc.reset_states();
    std::vector<uint8_t> seg;
    size_t pos = 0;
    for (int s = 0; s < cb.numsegs; s++) {
      const CodeSeg& sg = cb.segs[s];
      bool raw = bpno_plus_one <= cb.numbps - 4 && passtype < 2 &&
                 (cblksty & CBLK_LAZY);
      seg.assign(cb.data.begin() + pos, cb.data.begin() + pos + sg.len);
      seg.push_back(0xff);
      seg.push_back(0xff);
      pos += sg.len;
      if (raw) mqc.raw_init(seg.data()); else mqc.init(seg.data());
      for (uint32_t p = 0; p < sg.numpasses && bpno_plus_one >= 1; p++) {
        switch (passtype) {
          case 0: sigpass(bpno_plus_one, raw); break;
          case 1: refpass(bpno_plus_one, raw); break;
          case 2: clnpass(bpno_plus_one, (cblksty & CBLK_SEGSYM) != 0); break;
        }
        if ((cblksty & CBLK_RESET) && !raw) mqc.reset_states();
        if (++passtype == 3) {
          passtype = 0;
          bpno_plus_one--;
        }
      }
    }
    if (roishift) {
      if (roishift >= 31) {
        std::fill(data.begin(), data.end(), 0);
      } else {
        const int32_t thresh = 1 << roishift;
        for (int32_t& v : data) {
          int32_t mag = std::abs(v);
          if (mag >= thresh) {
            mag >>= roishift;
            v = v < 0 ? -mag : mag;
          }
        }
      }
    }
  }
};

// --------------------------------------------------------- inverse wavelets
// x: n interleaved samples of L lanes (x[k * L + lane]), the first at
// parity cas (0: low-pass); each lane is one row or column, lifted alone
template <int L>
void idwt53(int32_t* x, int n, int cas) {
  if (n == 1) {
    if (cas)
      for (int i = 0; i < L; i++) x[i] /= 2;
    return;
  }
  for (int k = cas; k < n; k += 2) {  // lows: even coordinates
    const int32_t* l = x + (k > 0 ? k - 1 : k + 1) * L;
    const int32_t* r = x + (k + 1 < n ? k + 1 : k - 1) * L;
    int32_t* d = x + k * L;
    for (int i = 0; i < L; i++) d[i] -= (l[i] + r[i] + 2) >> 2;
  }
  for (int k = 1 - cas; k < n; k += 2) {
    const int32_t* l = x + (k > 0 ? k - 1 : k + 1) * L;
    const int32_t* r = x + (k + 1 < n ? k + 1 : k - 1) * L;
    int32_t* d = x + k * L;
    for (int i = 0; i < L; i++) d[i] += (l[i] + r[i]) >> 1;
  }
}

const float kK = 1.230174105f;
const float kTwoInvK = 1.625732422f;
const float kAlpha = -1.586134342f, kBeta = -0.052980118f,
            kGamma = 0.882911075f, kDelta = 0.443506852f;

template <int L>
inline void lift97(float* x, int n, int first, float c) {
  for (int k = first; k < n; k += 2) {
    const float* l = x + (k > 0 ? k - 1 : k + 1) * L;
    const float* r = x + (k + 1 < n ? k + 1 : k - 1) * L;
    float* d = x + k * L;
    for (int i = 0; i < L; i++) d[i] = d[i] + (l[i] + r[i]) * c;
  }
}

template <int L>
void idwt97(float* x, int n, int cas) {
  if (n == 1) return;  // opj_v8dwt_decode leaves one sample as it is
  int a = cas, b = 1 - cas;  // first low, first high
  for (int k = a; k < n; k += 2)
    for (int i = 0; i < L; i++) x[k * L + i] = x[k * L + i] * kK;
  for (int k = b; k < n; k += 2)
    for (int i = 0; i < L; i++) x[k * L + i] = x[k * L + i] * kTwoInvK;
  lift97<L>(x, n, a, -kDelta);
  lift97<L>(x, n, b, -kGamma);
  lift97<L>(x, n, a, -kBeta);
  lift97<L>(x, n, b, -kAlpha);
}

// One resolution at a time, rows then columns (dwt.c), the columns 8 at a
// time (the same float operations on each, as OpenJPEG's SSE lanes).
template <typename T, void (*Row)(T*, int, int), void (*Cols)(T*, int, int)>
void idwt2d(TileComp& tc) {
  constexpr int kLanes = 8;
  T* d = reinterpret_cast<T*>(tc.data.data());
  const int64_t stride = tc.w();
  std::vector<T> buf;
  for (int r = 1; r < tc.numres; r++) {
    const Res& lo = tc.res[r - 1];
    const Res& res = tc.res[r];
    int sw = (int)(lo.x1 - lo.x0), sh = (int)(lo.y1 - lo.y0);
    int rw = (int)(res.x1 - res.x0), rh = (int)(res.y1 - res.y0);
    int cw = (int)(res.x0 & 1), ch = (int)(res.y0 & 1);
    buf.assign((size_t)std::max(rw, rh) * kLanes, T());
    for (int y = 0; y < rh; y++) {
      T* row = d + y * stride;
      for (int i = 0; i < sw; i++) buf[cw + 2 * i] = row[i];
      for (int i = 0; i < rw - sw; i++) buf[1 - cw + 2 * i] = row[sw + i];
      Row(buf.data(), rw, cw);
      for (int i = 0; i < rw; i++) row[i] = buf[i];
    }
    for (int x0 = 0; x0 < rw; x0 += kLanes) {
      const int nl = std::min(kLanes, rw - x0);
      T* col = d + x0;
      for (int i = 0; i < rh; i++) {
        const T* src = col + i * stride;
        T* dst = buf.data() + (size_t)(i < sh ? ch + 2 * i
                                              : 1 - ch + 2 * (i - sh)) * kLanes;
        for (int k = 0; k < nl; k++) dst[k] = src[k];
      }
      Cols(buf.data(), rh, ch);
      for (int i = 0; i < rh; i++) {
        const T* src = buf.data() + (size_t)i * kLanes;
        T* dst = col + i * stride;
        for (int k = 0; k < nl; k++) dst[k] = src[k];
      }
    }
  }
}

// ------------------------------------------------------------ decode tile
void decode_tile(Codestream& cs, int tileno,
                 std::vector<std::vector<int32_t>>& image,
                 int64_t width) {
  Tcp& tcp = cs.tiles[tileno];
  const int nc = (int)cs.comps.size();
  int p = tileno % cs.tw, q = tileno / cs.tw;
  int64_t tx0 = std::max(cs.tx0 + p * cs.tdx, cs.x0);
  int64_t ty0 = std::max(cs.ty0 + q * cs.tdy, cs.y0);
  int64_t tx1 = std::min(cs.tx0 + (p + 1) * cs.tdx, cs.x1);
  int64_t ty1 = std::min(cs.ty0 + (q + 1) * cs.tdy, cs.y1);
  std::vector<TileComp> tcs(nc);
  for (int c = 0; c < nc; c++)
    init_tilecomp(tcs[c], cs.comps[c], tcp.tccps[c], tx0, ty0, tx1, ty1);

  // tier 2
  std::vector<Packet> order = packet_order(cs, tcp, tcs, tx0, ty0, tx1, ty1);
  std::vector<uint8_t> ppt;
  if (!tcp.ppt.empty()) {
    std::stable_sort(tcp.ppt.begin(), tcp.ppt.end(),
                     [](const auto& a, const auto& b) {
                       return a.first < b.first;
                     });
    for (auto& part : tcp.ppt) ppt.insert(ppt.end(), part.second.begin(),
                                          part.second.end());
  }
  const uint8_t* body = tcp.data.data();
  size_t blen = tcp.data.size(), bpos = 0, hpos = 0;
  for (const Packet& pk : order) {
    if (cs.have_ppm) {
      read_packet(tcp, tcs[pk.compno], pk, cs.ppm_data.data(),
                  cs.ppm_data.size(), &cs.ppm_pos, body, blen, &bpos, true);
    } else if (!tcp.ppt.empty()) {
      read_packet(tcp, tcs[pk.compno], pk, ppt.data(), ppt.size(), &hpos,
                  body, blen, &bpos, true);
    } else {
      read_packet(tcp, tcs[pk.compno], pk, body, blen, &hpos, body, blen,
                  &bpos, false);
    }
  }

  // tier 1, dequantisation, inverse wavelet
  T1 t1;
  for (int c = 0; c < nc; c++) {
    TileComp& tc = tcs[c];
    const Tccp& tccp = tcp.tccps[c];
    const int64_t stride = tc.w();
    for (int r = 0; r < tc.numres; r++) {
      Res& res = tc.res[r];
      for (Band& band : res.bands) {
        if (band.empty()) continue;
        int64_t ox = 0, oy = 0;
        if (band.bandno & 1) ox = tc.res[r - 1].x1 - tc.res[r - 1].x0;
        if (band.bandno & 2) oy = tc.res[r - 1].y1 - tc.res[r - 1].y0;
        const float stepsize = 0.5f * band.stepsize;
        for (Precinct& pr : band.precs)
          for (Cblk& cb : pr.cblks) {
            if (cb.x1 <= cb.x0 || cb.y1 <= cb.y0) continue;
            t1.decode(cb, band.bandno, tccp.roishift, tccp.cblksty);
            int64_t x = cb.x0 - band.x0 + ox, y = cb.y0 - band.y0 + oy;
            const int w = t1.w, h = t1.h;
            for (int j = 0; j < h; j++) {
              int32_t* dst = tc.data.data() + (y + j) * stride + x;
              const int32_t* src = t1.data.data() + (size_t)j * w;
              if (tccp.qmfbid == 1) {
                for (int i = 0; i < w; i++) dst[i] = src[i] / 2;
              } else {
                float* fd = reinterpret_cast<float*>(dst);
                for (int i = 0; i < w; i++) fd[i] = (float)src[i] * stepsize;
              }
            }
          }
      }
    }
    if (tccp.qmfbid == 1) idwt2d<int32_t, idwt53<1>, idwt53<8>>(tc);
    else idwt2d<float, idwt97<1>, idwt97<8>>(tc);
  }

  // multiple component transform (tcd.c: opj_tcd_mct_decode)
  if (tcp.mct == 1 && nc >= 3) {
    for (int c = 1; c < 3; c++)
      if (tcs[c].numres != tcs[0].numres || tcs[c].w() != tcs[0].w() ||
          tcs[c].h() != tcs[0].h())
        refuse("component transform over components of unequal sizes (cv2 "
               "reads nothing)");
    const size_t n = tcs[0].data.size();
    int32_t* c0 = tcs[0].data.data();
    int32_t* c1 = tcs[1].data.data();
    int32_t* c2 = tcs[2].data.data();
    if (tcp.tccps[0].qmfbid == 1) {
      for (size_t i = 0; i < n; i++) {
        int32_t y = c0[i], u = c1[i], v = c2[i];
        int32_t g = y - ((u + v) >> 2);
        c0[i] = v + g;
        c1[i] = g;
        c2[i] = u + g;
      }
    } else {
      float* f0 = reinterpret_cast<float*>(c0);
      float* f1 = reinterpret_cast<float*>(c1);
      float* f2 = reinterpret_cast<float*>(c2);
      for (size_t i = 0; i < n; i++) {
        float y = f0[i], u = f1[i], v = f2[i];
        float r = y + (v * 1.402f);
        float g = y - (u * 0.34413f) - (v * 0.71414f);
        float b = y + (u * 1.772f);
        f0[i] = r;
        f1[i] = g;
        f2[i] = b;
      }
    }
  }

  // DC level shift, clamp, into the image (tcd.c: opj_tcd_dc_level_shift)
  for (int c = 0; c < nc; c++) {
    const Comp& comp = cs.comps[c];
    TileComp& tc = tcs[c];
    // unsigned samples (parse refuses signed ones)
    const int64_t shift = (int64_t)1 << (comp.prec - 1);
    const int64_t lo = 0, hi = ((int64_t)1 << comp.prec) - 1;
    const bool rev = tcp.tccps[c].qmfbid == 1;
    for (int64_t j = 0; j < tc.h(); j++) {
      int32_t* src = tc.data.data() + j * tc.w();
      int32_t* dst = image[c].data() + (tc.y0 + j) * width + tc.x0;
      for (int64_t i = 0; i < tc.w(); i++) {
        int64_t v;
        if (rev) {
          v = (int64_t)src[i] + shift;
        } else {
          float f;
          memcpy(&f, &src[i], 4);
          if (f > (float)INT32_MAX) {
            dst[i] = (int32_t)hi;
            continue;
          }
          if (f < (float)INT32_MIN) {
            dst[i] = (int32_t)lo;
            continue;
          }
          v = (int64_t)lrintf(f) + shift;
        }
        dst[i] = (int32_t)std::max(lo, std::min(hi, v));
      }
    }
  }
}

// ------------------------------------------------------------- codestream
enum : uint32_t {
  M_SOC = 0xff4f, M_CAP = 0xff50, M_SIZ = 0xff51, M_COD = 0xff52,
  M_COC = 0xff53, M_QCD = 0xff5c, M_QCC = 0xff5d, M_RGN = 0xff5e,
  M_POC = 0xff5f, M_PPM = 0xff60, M_PPT = 0xff61, M_SOT = 0xff90,
  M_SOD = 0xff93, M_EOC = 0xffd9
};

void header_marker(Codestream& cs, Tcp& tcp, uint32_t m, Seg s, bool main) {
  switch (m) {
    case M_COD: read_cod(tcp, s); break;
    case M_COC: read_coc(tcp, s); break;
    case M_QCD: read_qcd(tcp, s); break;
    case M_QCC: read_qcc(tcp, s); break;
    case M_RGN: read_rgn(tcp, s); break;
    case M_POC: read_poc(tcp, s, cs.comps.size()); break;
    case M_CAP: refuse("HTJ2K (Part 15) codestream (CAP marker)");
    case M_PPM:
      if (!main) bad("codestream (PPM in a tile-part header)");
      if (s.n < 1) bad("PPM segment too short");
      cs.ppm.push_back({s.p[0], std::vector<uint8_t>(s.p + 1, s.p + s.n)});
      cs.have_ppm = true;
      break;
    case M_PPT:
      if (main) bad("codestream (PPT in the main header)");
      if (s.n < 1) bad("PPT segment too short");
      tcp.ppt.push_back({s.p[0], std::vector<uint8_t>(s.p + 1, s.p + s.n)});
      break;
    default:  // TLM, PLM, PLT, CRG, COM and the unknown: skipped
      if (m < 0xff30 || m == M_SOT || m == M_SOD || m == M_SOC)
        bad("codestream (marker " + std::to_string(m) + " in a header)");
      break;
  }
}

// the merged PPM headers: the Ippm bodies by Zppm, their Nppm fields out
void merge_ppm(Codestream& cs) {
  std::stable_sort(cs.ppm.begin(), cs.ppm.end(),
                   [](const auto& a, const auto& b) { return a.first < b.first; });
  std::vector<uint8_t> all;
  for (auto& part : cs.ppm)
    all.insert(all.end(), part.second.begin(), part.second.end());
  size_t pos = 0;
  while (pos < all.size()) {
    if (pos + 4 > all.size()) bad("PPM (Nppm)");
    uint32_t n = be32(&all[pos]);
    pos += 4;
    if (n > all.size() - pos) bad("PPM (Nppm past its data)");
    cs.ppm_data.insert(cs.ppm_data.end(), all.begin() + pos,
                       all.begin() + pos + n);
    pos += n;
  }
}

// Every tile has come with its count of tile-parts (TNsot), all of them.
bool all_tile_parts(const Codestream& cs) {
  for (const Tcp& t : cs.tiles)
    if (!t.seen || t.tnsot == 0 || t.parts < t.tnsot) return false;
  return true;
}

// The bytes t[0..n) after the last tile-part, once every tile has all its
// tile-parts, as OpenJPEG 2.5 reads them (its decoder stops once the last
// tile is decoded): an EOC; a SOT; or, as the stream's last two bytes,
// anything ("does not end with EOC").  Before that, when the first tile to
// complete has more than one tile-part, its tile-part count check
// (opj_j2k_need_nb_tile_parts_correction) walks the SOTs that follow by
// their Psot: a SOT of that tile whose TPsot equals its TNsot makes it
// expect one more tile-part, read then as an empty one if its TPsot says
// so; a SOT cut short or of another length fails the file.  cv2 reads
// nothing of every other trailer.
void trailer(const Codestream& cs, const uint8_t* t, size_t n,
             int first_done) {
  const char* none =
      "bytes other than an EOC or a SOT after the last tile-part (cv2 "
      "reads nothing)";
  uint32_t m = be16(t);
  if (m != M_EOC && m != M_SOT) {
    if (n == 2) return;
    refuse(none);
  }
  if (m != M_SOT || first_done < 0 || cs.tiles[first_done].tnsot < 2) return;
  for (size_t p = 0;;) {
    if (p + 2 > n || be16(t + p) != M_SOT) return;
    if (p + 12 > n || be16(t + p + 2) != 10)
      refuse("a SOT cut short or of another length after the last "
             "tile-part (cv2 reads nothing)");
    uint32_t isot = be16(t + p + 4), psot = be32(t + p + 6);
    uint32_t tpsot = t[p + 10], tnsot = t[p + 11];
    if ((int)isot == first_done) {
      if (tpsot != tnsot) return;
      // one more tile-part of that tile: empty, to the EOC
      size_t rest = n - (p + 12);
      const uint8_t* r = t + p + 12;
      bool empty = (rest == 2 && be16(r) == M_EOC) ||
                   (rest == 4 && be16(r) == M_SOD && be16(r + 2) == M_EOC);
      if ((int)tpsot == cs.tiles[first_done].parts && empty &&
          (psot == 0 || psot == 12 + (rest == 4 ? 2u : 0u)))
        return;
      refuse("a SOT after the last tile-part that OpenJPEG takes for "
             "another tile-part of the first tile (cv2 reads nothing)");
    }
    if (psot < 14 || p + psot > n) return;
    p += psot;
  }
}

void parse_codestream(Codestream& cs, const uint8_t* d, size_t n,
                      bool header_only) {
  if (n < 4 || be16(d) != M_SOC || be16(d + 2) != M_SIZ)
    bad("codestream (no SOC and SIZ)");
  size_t pos = 2;
  bool siz = false;
  // main header
  for (;;) {
    if (pos + 4 > n) refuse("cut codestream (in its main header)");
    uint32_t m = be16(d + pos);
    if (m == M_SOT) break;
    uint32_t len = be16(d + pos + 2);
    if (len < 2) bad("codestream (marker length)");
    if (pos + 2 + len > n) refuse("cut codestream (in its main header)");
    Seg s(d + pos + 4, len - 2);
    if (m == M_SIZ) {
      if (siz) bad("codestream (a second SIZ)");
      read_siz(cs, s);
      siz = true;
    } else {
      if (!siz) bad("codestream (SIZ not first)");
      header_marker(cs, cs.def, m, s, true);
    }
    pos += 2 + len;
  }
  if (!cs.def.cod) bad("codestream (no COD in the main header)");
  if (!cs.def.qcd) bad("codestream (no QCD in the main header)");
  if (header_only) return;
  if (cs.have_ppm) merge_ppm(cs);
  cs.tiles.assign((size_t)cs.tw * cs.th, Tcp());
  int first_done = -1;  // the first tile whose last tile-part came
  // tile-parts, to the EOC
  for (;;) {
    if (pos + 2 > n)
      refuse("cut codestream (no EOC after its last tile-part, as OpenJPEG's "
             "strict mode reads it)");
    uint32_t m = be16(d + pos);
    if (m == M_EOC) break;
    if (all_tile_parts(cs)) {
      // OpenJPEG has decoded every tile: it reads what follows as trailer
      trailer(cs, d + pos, n - pos, first_done);
      break;
    }
    if (m != M_SOT) bad("codestream (no SOT or EOC where a tile-part begins)");
    if (pos + 12 > n) break;  // a SOT cut short: OpenJPEG stops before it
    size_t sot = pos;
    if (be16(d + pos + 2) != 10) bad("SOT (length)");
    uint32_t isot = be16(d + pos + 4), psot = be32(d + pos + 6);
    uint32_t tpsot = d[pos + 10], tnsot = d[pos + 11];
    if (isot >= cs.tiles.size()) bad("SOT (tile index)");
    size_t end;
    if (psot == 0) {  // to the EOC
      end = n >= 2 && be16(d + n - 2) == M_EOC ? n - 2 : n;
    } else {
      if (psot < 14) bad("SOT (tile-part length)");
      if (psot > n - sot)
        refuse("cut codestream (tile-part length past the end of the "
               "stream, as OpenJPEG's strict mode reads it)");
      end = sot + psot;
    }
    Tcp& tcp = cs.tiles[isot];
    if (!tcp.seen) {
      tcp = cs.def;
      tcp.cod = tcp.qcd = false;
      tcp.ppt.clear();
      tcp.data.clear();
      tcp.seen = true;
    }
    if ((int)tpsot != tcp.parts) bad("SOT (tile-part index out of order)");
    tcp.parts++;
    if (tcp.tnsot == 0) tcp.tnsot = (int)tnsot;
    if (first_done < 0 && tcp.tnsot && tcp.parts == tcp.tnsot)
      first_done = (int)isot;
    pos += 12;
    for (;;) {
      if (pos + 2 > end) bad("tile-part (no SOD)");
      uint32_t mm = be16(d + pos);
      if (mm == M_SOD) {
        pos += 2;
        break;
      }
      if (pos + 4 > end) bad("tile-part header");
      uint32_t len = be16(d + pos + 2);
      if (len < 2 || pos + 2 + len > end) bad("tile-part (marker length)");
      Seg s(d + pos + 4, len - 2);
      if (tpsot != 0 && (mm == M_COD || mm == M_COC || mm == M_QCD ||
                         mm == M_QCC || mm == M_RGN))
        bad("tile-part (coding marker past the tile's first part)");
      header_marker(cs, tcp, mm, s, false);
      pos += 2 + len;
    }
    tcp.data.insert(tcp.data.end(), d + pos, d + end);
    pos = end;
  }
}

// --------------------------------------------------------------- JP2 boxes
struct Jp2 {
  bool jp2h = false;
  int64_t ihdr_h = -1, ihdr_w = -1;
  int enumcs = 0;  // 0: none or an ICC profile
  bool has_colr = false;
  // palette
  bool pclr = false;
  int nr_entries = 0, nr_channels = 0;
  std::vector<int> channel_size, channel_sign;
  std::vector<int64_t> entries;
  struct Cmap { int cmp, mtyp, pcol; };
  std::vector<Cmap> cmap;
  struct Cdef { int cn, typ, asoc; };
  std::vector<Cdef> cdef;
  const uint8_t* cs = nullptr;
  size_t cs_n = 0;
};

// jp2.c's order: the signature, ftyp, then jp2h (with an ihdr) before jp2c
void read_boxes(const uint8_t* d, size_t n, Jp2& jp, bool top) {
  size_t pos = 0;
  int index = 0;
  while (pos + 8 <= n) {
    uint64_t len = be32(d + pos);
    uint32_t type = be32(d + pos + 4);
    size_t hdr = 8;
    if (len == 1) {
      if (pos + 16 > n) bad("JP2 box (XLBox)");
      len = (uint64_t)be32(d + pos + 8) << 32 | be32(d + pos + 12);
      hdr = 16;
    } else if (len == 0) {
      len = n - pos;
    }
    if (len < hdr) bad("JP2 box (length)");
    const uint8_t* b = d + pos + hdr;
    size_t bn = len - hdr;
    if (top && index == 1 && type != 0x66747970)
      refuse("JP2 file whose second box is not ftyp (cv2 reads none)");
    index++;
    if (type == 0x6a703263 && top) {  // jp2c: the codestream, to the end
      if (!jp.jp2h)
        refuse("JP2 file without a header box (jp2h) before its codestream "
               "(cv2 reads none)");
      jp.cs = b;
      jp.cs_n = std::min<uint64_t>(bn, n - pos - hdr);
      return;
    }
    if (len > n - pos) refuse("cut JP2 file (a box runs past its end)");
    switch (type) {
      case 0x6a703268:  // jp2h
        if (top && !jp.jp2h) {
          jp.jp2h = true;
          read_boxes(b, bn, jp, false);
          if (jp.ihdr_h < 0)
            refuse("JP2 header box without ihdr (cv2 reads none)");
        }
        break;
      case 0x69686472:  // ihdr
        if (!top && bn >= 8) {
          jp.ihdr_h = be32(b);
          jp.ihdr_w = be32(b + 4);
        }
        break;
      case 0x636f6c72:  // colr: the first only
        if (!top && !jp.has_colr && bn >= 3) {
          int meth = b[0];
          if (meth == 1) {
            if (bn < 7) bad("JP2 colr box");
            jp.enumcs = (int)be32(b + 3);
            jp.has_colr = true;
          } else if (meth == 2) {
            jp.has_colr = true;
          }
        }
        break;
      case 0x70636c72: {  // pclr
        if (top || bn < 3) break;
        jp.pclr = true;
        jp.nr_entries = (int)be16(b);
        jp.nr_channels = b[2];
        if (jp.nr_entries == 0 || jp.nr_entries > 1024 || jp.nr_channels == 0)
          bad("JP2 pclr box");
        if (bn < 3 + (size_t)jp.nr_channels) bad("JP2 pclr box");
        size_t p = 3 + jp.nr_channels;
        for (int i = 0; i < jp.nr_channels; i++) {
          jp.channel_size.push_back((b[3 + i] & 0x7f) + 1);
          jp.channel_sign.push_back(b[3 + i] >> 7);
        }
        for (int e = 0; e < jp.nr_entries; e++)
          for (int i = 0; i < jp.nr_channels; i++) {
            int bytes = (jp.channel_size[i] + 7) >> 3;
            if (p + bytes > bn) bad("JP2 pclr box (entries)");
            int64_t v = 0;
            for (int k = 0; k < bytes; k++) v = v << 8 | b[p + k];
            jp.entries.push_back(v);
            p += bytes;
          }
        break;
      }
      case 0x636d6170:  // cmap
        if (top) break;
        for (size_t p = 0; p + 4 <= bn; p += 4)
          jp.cmap.push_back({(int)be16(b + p), b[p + 2], b[p + 3]});
        break;
      case 0x63646566: {  // cdef
        if (top || bn < 2) break;
        size_t k = be16(b);
        if (bn < 2 + 6 * k) bad("JP2 cdef box");
        for (size_t i = 0; i < k; i++)
          jp.cdef.push_back({(int)be16(b + 2 + 6 * i),
                             (int)be16(b + 4 + 6 * i),
                             (int)be16(b + 6 + 6 * i)});
        break;
      }
      default:
        break;
    }
    pos += len;
  }
  if (top) refuse("JP2 file without a codestream (jp2c box), or cut before "
                  "it");
}

struct Image {
  int64_t w = 0, h = 0;
  Codestream cs;
  Jp2 jp;
  bool is_jp2 = false;
  int maxprec = 0;
};

void parse(Image& im, const uint8_t* d, size_t n, bool header_only) {
  static const uint8_t kSig[12] = {0, 0, 0, 12, 0x6a, 0x50, 0x20, 0x20,
                                   0x0d, 0x0a, 0x87, 0x0a};
  const uint8_t* cd = d;
  size_t cn = n;
  if (n >= 12 && memcmp(d, kSig, 12) == 0) {
    im.is_jp2 = true;
    read_boxes(d, n, im.jp, true);
    cd = im.jp.cs;
    cn = im.jp.cs_n;
  }
  parse_codestream(im.cs, cd, cn, header_only);
  const Codestream& cs = im.cs;
  im.w = cs.x1 - cs.x0;
  im.h = cs.y1 - cs.y0;
  if (im.is_jp2 && (im.jp.ihdr_h != im.h || im.jp.ihdr_w != im.w))
    refuse("JP2 file whose ihdr size is not its codestream's (cv2 reads "
           "none)");
  // grfmt_jpeg2000_openjpeg.cpp: readHeader
  if (cs.comps.size() > 4)
    refuse("image of " + std::to_string(cs.comps.size()) +
           " components (cv2 reads 1 to 4)");
  for (size_t c = 0; c < cs.comps.size(); c++) {
    if (cs.comps[c].sgnd)
      refuse("signed component " + std::to_string(c) + " (cv2 reads none)");
    if (cs.comps[c].dx != 1 || cs.comps[c].dy != 1)
      refuse("sub-sampled component " + std::to_string(c));
    im.maxprec = std::max(im.maxprec, cs.comps[c].prec);
  }
  if (im.maxprec < 8)
    refuse("precision below 8 bits (cv2 reads none)");
  // readData: the colour space after the palette
  const int e = im.is_jp2 ? im.jp.enumcs : 0;
  const size_t nch = im.is_jp2 && im.jp.pclr && !im.jp.cmap.empty()
                         ? (size_t)im.jp.nr_channels : cs.comps.size();
  if (e == 24) refuse("e-sYCC colour space (cv2 reads none)");
  if (e == 12) refuse("CMYK colour space (cv2 reads none)");
  if (e == 18 && nch < 3)
    refuse("sYCC image of fewer than 3 components (cv2 reads none)");
  if (e != 17 && e != 18 && nch < 3)
    refuse("image of " + std::to_string(nch) +
           " components without a JP2 grey colour space (cv2 reads an sRGB "
           "or unspecified one of 3 or 4 only)");
}

// the JP2 palette (jp2.c: opj_jp2_check_color, opj_jp2_apply_pclr) and
// channel definitions (opj_jp2_apply_cdef) on comps
void apply_jp2(const Image& im, std::vector<std::vector<int32_t>>& comps) {
  const Jp2& jp = im.jp;
  size_t nch = comps.size();
  bool use_pclr = jp.pclr && !jp.cmap.empty();
  if (use_pclr) {
    if ((int)jp.cmap.size() != jp.nr_channels)
      bad("JP2 cmap box (channel count)");
    for (int i = 0; i < jp.nr_channels; i++) {
      const auto& m = jp.cmap[i];
      if (m.cmp != 0 || m.mtyp != 1 || m.pcol != i || comps.size() != 1)
        refuse("palette mapping other than every palette column from one "
               "index component");
    }
    nch = jp.nr_channels;
  }
  if (!jp.cdef.empty()) {
    for (const auto& c : jp.cdef) {
      if ((size_t)c.cn >= nch) bad("JP2 cdef box (component index)");
      if (c.asoc != 65535 && c.asoc > 0 && (size_t)(c.asoc - 1) >= nch)
        bad("JP2 cdef box (association)");
    }
    for (size_t k = nch; k > 0; k--) {
      bool found = false;
      for (const auto& c : jp.cdef) found |= (size_t)c.cn == k - 1;
      if (!found) bad("JP2 cdef box (incomplete channel definitions)");
    }
  }
  if (use_pclr) {
    const std::vector<int32_t> idx = comps[0];
    comps.assign(jp.nr_channels, std::vector<int32_t>(idx.size()));
    const int top = jp.nr_entries - 1;
    for (int i = 0; i < jp.nr_channels; i++) {
      for (size_t j = 0; j < idx.size(); j++) {
        int k = idx[j] < 0 ? 0 : idx[j] > top ? top : idx[j];
        comps[i][j] = (int32_t)jp.entries[(size_t)k * jp.nr_channels + i];
      }
    }
  }
  if (!jp.cdef.empty()) {
    std::vector<Jp2::Cdef> info = jp.cdef;
    for (size_t i = 0; i < info.size(); i++) {
      int asoc = info[i].asoc, cn = info[i].cn;
      if ((size_t)cn >= comps.size()) continue;
      if (asoc == 0 || asoc == 65535) continue;
      int acn = asoc - 1;
      if ((size_t)acn >= comps.size()) continue;
      if (cn != acn && info[i].typ == 0) {
        std::swap(comps[cn], comps[acn]);
        for (size_t j = i + 1; j < info.size(); j++) {
          if (info[j].cn == cn) info[j].cn = acn;
          else if (info[j].cn == acn) info[j].cn = cn;
        }
      }
    }
  }
}

void decode(Image& im, uint8_t* out) {
  Codestream& cs = im.cs;
  const size_t nc = cs.comps.size();
  std::vector<std::vector<int32_t>> comps(nc);
  for (size_t c = 0; c < nc; c++) comps[c].assign((size_t)(im.w * im.h), 0);
  bool any = false;
  for (size_t t = 0; t < cs.tiles.size(); t++) {
    if (!cs.tiles[t].seen) continue;  // its samples stay 0, as OpenJPEG's
    any = true;
    if (cs.tiles[t].data.empty())  // j2k.c: opj_j2k_decode_tile
      refuse("tile " + std::to_string(t) + " of no packet data (OpenJPEG "
             "fails it, cv2 reads nothing)");
    decode_tile(cs, (int)t, comps, im.w);
  }
  if (!any) refuse("codestream of no tile-part");
  if (im.is_jp2) apply_jp2(im, comps);
  // grfmt_jpeg2000_openjpeg.cpp: readData at IMREAD_COLOR
  const int shift = im.maxprec - 8;
  const size_t n = (size_t)(im.w * im.h);
  const int e = im.is_jp2 ? im.jp.enumcs : 0;
  const bool grey = e == 17;
  if (e == 18) {
    // cvtColor's YUV -> BGR in 14-bit fixed point
    for (size_t i = 0; i < n; i++) {
      int y = (uint8_t)(comps[0][i] >> shift);
      int u = (int)(uint8_t)(comps[1][i] >> shift) - 128;
      int v = (int)(uint8_t)(comps[2][i] >> shift) - 128;
      int b = y + ((u * 33292 + (1 << 13)) >> 14);
      int g = y + ((u * -6472 + v * -9519 + (1 << 13)) >> 14);
      int r = y + ((v * 18678 + (1 << 13)) >> 14);
      out[3 * i] = (uint8_t)std::max(0, std::min(255, r));
      out[3 * i + 1] = (uint8_t)std::max(0, std::min(255, g));
      out[3 * i + 2] = (uint8_t)std::max(0, std::min(255, b));
    }
    return;
  }
  for (size_t i = 0; i < n; i++) {
    if (grey) {
      uint8_t v = (uint8_t)(comps[0][i] >> shift);
      out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = v;
    } else {
      for (int k = 0; k < 3; k++)
        out[3 * i + k] = (uint8_t)(comps[k][i] >> shift);
    }
  }
}

int report(const Error& e, char* err, int errlen) {
  if (err && errlen > 0) snprintf(err, (size_t)errlen, "%s", e.msg.c_str());
  return e.code;
}

}  // namespace

extern "C" {

// (height, width) of a JP2 file or a raw codestream, after its headers.
int thc_j2k_info(const uint8_t* data, int64_t n, int* height, int* width,
                 char* err, int errlen) {
  try {
    Image im;
    parse(im, data, (size_t)n, true);
    if (im.w > INT32_MAX || im.h > INT32_MAX) bad("SIZ (image too large)");
    *height = (int)im.h;
    *width = (int)im.w;
    return 0;
  } catch (const Error& e) {
    return report(e, err, errlen);
  } catch (const std::exception& e) {
    return report(Error{kErrFormat, e.what()}, err, errlen);
  }
}

// Decode into out, (height, width, 3) RGB uint8.
int thc_j2k_decode(const uint8_t* data, int64_t n, uint8_t* out, int height,
                   int width, char* err, int errlen) {
  try {
    Image im;
    parse(im, data, (size_t)n, false);
    if (im.h != height || im.w != width)
      fail(kErrArgs, "output size does not match the JPEG 2000 image");
    decode(im, out);
    return 0;
  } catch (const Error& e) {
    return report(e, err, errlen);
  } catch (const std::exception& e) {
    return report(Error{kErrFormat, e.what()}, err, errlen);
  }
}

}  // extern "C"

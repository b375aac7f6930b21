// AV1 intra-frame decoder of the PyTorch port's host codec, for the still
// images of AVIF files (data/image_formats.py parses the HEIF container and
// hands over the item's OBUs), decoded as libaom 3.14 decodes them, then
// converted to 8-bit RGB as libavif 1.4's avifImageYUVToRGB converts them
// for OpenCV 5's imread:
//   * OBUs: temporal delimiters, padding and metadata skipped; the sequence
//     header (reduced still-picture or full, color_config at profiles 0-2);
//     the frame header and tile groups (or a frame OBU) of one shown key
//     frame;
//   * the frame header: uniform and non-uniform tile spacing, quantizer
//     deltas with separate U/V deltas and quantizer matrices, segmentation,
//     delta q and delta lf, the loop filter, CDEF, loop restoration,
//     tx_mode, the reduced transform set and film grain;
//   * the symbol decoder (libaom's od_ec_dec) with the default CDFs, their
//     adaptation, and the coefficient CDF set chosen by base_q_idx;
//   * partitions of 64x64 and 128x128 superblocks; intra modes with angle
//     deltas, CFL and filter intra; segment ids, skip, cdef_idx, delta q
//     and delta lf; transform sizes and the intra transform types (the
//     reduced set too); coefficients (EOB, base and range levels, signs,
//     Golomb) with libaom's contexts and scans;
//   * dequantisation through the lookups at 8, 10 and 12 bits and the
//     quantizer matrices; the inverse DCT 4-64, ADST 4-16, identity 4-32
//     and WHT, with libaom's stage clamps; every intra predictor with the
//     edge filter and upsampling;
//   * the deblocking filter (4-, 6-, 8- and 14-tap, per-segment and delta
//     levels) and CDEF;
//   * loop restoration: the frame's types and unit sizes, each unit's
//     coefficients read at its superblock (Wiener taps and self-guided
//     sets and projections against the tile's references), the Wiener and
//     self-guided filters in 64-row stripes over the CDEF'd frame with the
//     deblocked rows around each stripe;
//   * film grain on the output picture, as libaom's av1_add_film_grain;
//   * screen-content tools: palettes (colours from the neighbours' cache,
//     literal and delta-coded; the colour index map in wavefront order)
//     and intra block copy (the vector's candidates from the spatial
//     neighbours, its read and validity checks, the variable transform
//     tree and the inter transform sets, the bilinear copy from the
//     frame's unfiltered picture);
//   * the planes scaled to an item's ispe as libavif's avifImageScale
//     scales them (libyuv's ScalePlane routines, thc_avif_scale_plane).
// Refused by name: superres, frames other than one shown key frame,
// tile-list OBUs, more than one operating point's layers, and the colours
// cv2 reads as nothing (the identity matrix of subsampled chroma, YCgCo of
// limited range, matrices without a conversion).
// Every entry returns 0 on success or a non-zero code, with a message in
// the caller's buffer (2: a tool refused by name).

#include <algorithm>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <type_traits>
#include <vector>

#include "av1_tables.h"

namespace {

struct Error {
  int code;
  std::string msg;
};

constexpr int kErrFormat = 1;       // malformed or truncated
constexpr int kErrUnsupported = 2;  // a tool refused by name
constexpr int kErrArgs = 3;         // the caller's buffers do not match

[[noreturn]] void fail(int code, const std::string& msg) {
  throw Error{code, msg};
}
[[noreturn]] void bad(const std::string& what) {
  fail(kErrFormat, "bad AV1 " + what);
}
[[noreturn]] void refuse(const std::string& what) {
  fail(kErrUnsupported, "AV1 " + what);
}

template <class T>
inline T clip3(T lo, T hi, T v) {
  return v < lo ? lo : v > hi ? hi : v;
}
inline int round2(int64_t x, int n) {
  return n == 0 ? (int)x : (int)((x + ((int64_t)1 << (n - 1))) >> n);
}
inline int round2signed(int64_t x, int n) {
  return x >= 0 ? round2(x, n) : -round2(-x, n);
}
inline int floor_log2(uint32_t x) {
  int s = 0;
  while (x > 1) {
    x >>= 1;
    s++;
  }
  return s;
}

// ------------------------------------------------------- bit reader
struct Bits {
  const uint8_t* d;
  size_t n;
  size_t pos = 0;  // bits
  Bits(const uint8_t* data, size_t size) : d(data), n(size) {}
  uint32_t f(int bits) {
    uint32_t v = 0;
    for (int i = 0; i < bits; i++) {
      if ((pos >> 3) >= n) bad("header (ends early)");
      v = v << 1 | ((d[pos >> 3] >> (7 - (pos & 7))) & 1);
      pos++;
    }
    return v;
  }
  int su(int bits) {
    int v = (int)f(bits);
    int sign = 1 << (bits - 1);
    return v & sign ? v - 2 * sign : v;
  }
  uint32_t uvlc() {
    int zeros = 0;
    while (!f(1)) {
      if (++zeros >= 32) return 0xFFFFFFFFu;
    }
    return zeros ? f(zeros) + ((1u << zeros) - 1) : 0;
  }
  uint32_t ns(uint32_t nv) {
    int w = floor_log2(nv) + 1;
    uint32_t m = (1u << w) - nv;
    uint32_t v = f(w - 1);
    if (v < m) return v;
    return (v << 1) - m + f(1);
  }
  void byte_align() { pos = (pos + 7) & ~(size_t)7; }
};

uint64_t leb128(const uint8_t* d, size_t n, size_t* at) {
  uint64_t v = 0;
  for (int i = 0; i < 8; i++) {
    if (*at >= n) bad("OBU size (ends early)");
    uint8_t b = d[(*at)++];
    v |= (uint64_t)(b & 0x7f) << (7 * i);
    if (!(b & 0x80)) return v;
  }
  bad("OBU size (leb128 over 8 bytes)");
}

// ------------------------------------------------------- enumerations
enum { DC_PRED, V_PRED, H_PRED, D45_PRED, D135_PRED, D113_PRED, D157_PRED,
       D203_PRED, D67_PRED, SMOOTH_PRED, SMOOTH_V_PRED, SMOOTH_H_PRED,
       PAETH_PRED, UV_CFL_PRED };
enum { PARTITION_NONE, PARTITION_HORZ, PARTITION_VERT, PARTITION_SPLIT,
       PARTITION_HORZ_A, PARTITION_HORZ_B, PARTITION_VERT_A, PARTITION_VERT_B,
       PARTITION_HORZ_4, PARTITION_VERT_4 };
enum { TX_4X4, TX_8X8, TX_16X16, TX_32X32, TX_64X64, TX_4X8, TX_8X4,
       TX_8X16, TX_16X8, TX_16X32, TX_32X16, TX_32X64, TX_64X32, TX_4X16,
       TX_16X4, TX_8X32, TX_32X8, TX_16X64, TX_64X16, TX_SIZES_ALL };
enum { DCT_DCT, ADST_DCT, DCT_ADST, ADST_ADST, FLIPADST_DCT, DCT_FLIPADST,
       FLIPADST_FLIPADST, ADST_FLIPADST, FLIPADST_ADST, IDTX, V_DCT, H_DCT,
       V_ADST, H_ADST, V_FLIPADST, H_FLIPADST };
enum { BLOCK_4X4, BLOCK_4X8, BLOCK_8X4, BLOCK_8X8, BLOCK_8X16, BLOCK_16X8,
       BLOCK_16X16, BLOCK_16X32, BLOCK_32X16, BLOCK_32X32, BLOCK_32X64,
       BLOCK_64X32, BLOCK_64X64, BLOCK_64X128, BLOCK_128X64, BLOCK_128X128,
       BLOCK_4X16, BLOCK_16X4, BLOCK_8X32, BLOCK_32X8, BLOCK_16X64,
       BLOCK_64X16, BLOCK_SIZES_ALL, BLOCK_INVALID = 255 };

const uint8_t kBw4Log2[BLOCK_SIZES_ALL] = {0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 3,
                                           4, 4, 4, 5, 5, 0, 2, 1, 3, 2, 4};
const uint8_t kBh4Log2[BLOCK_SIZES_ALL] = {0, 1, 0, 1, 2, 1, 2, 3, 2, 3, 4,
                                           3, 4, 5, 4, 5, 2, 0, 3, 1, 4, 2};
// block size of (log2 w4, log2 h4), 0..5 each
uint8_t block_of(int wl, int hl) {
  for (int b = 0; b < BLOCK_SIZES_ALL; b++)
    if (kBw4Log2[b] == wl && kBh4Log2[b] == hl) return (uint8_t)b;
  return BLOCK_INVALID;
}
const uint8_t kTxWLog2[TX_SIZES_ALL] = {2, 3, 4, 5, 6, 2, 3, 3, 4, 4, 5,
                                        5, 6, 2, 4, 3, 5, 4, 6};
const uint8_t kTxHLog2[TX_SIZES_ALL] = {2, 3, 4, 5, 6, 3, 2, 4, 3, 5, 4,
                                        6, 5, 4, 2, 5, 3, 6, 4};
int tx_of(int wl, int hl) {  // log2 pixel dims -> TX size
  for (int t = 0; t < TX_SIZES_ALL; t++)
    if (kTxWLog2[t] == wl && kTxHLog2[t] == hl) return t;
  return -1;
}
const uint8_t kSplitTx[TX_SIZES_ALL] = {
    TX_4X4,   TX_4X4,   TX_8X8,   TX_16X16, TX_32X32, TX_4X4,  TX_4X4,
    TX_8X8,   TX_8X8,   TX_16X16, TX_16X16, TX_32X32, TX_32X32, TX_4X8,
    TX_8X4,   TX_8X16,  TX_16X8,  TX_16X32, TX_32X16};
inline int tx_sqr(int t) {  // TX size of the smaller side, squared
  int l = std::min(kTxWLog2[t], kTxHLog2[t]);
  return tx_of(l, l);
}
inline int tx_sqr_up(int t) {
  int l = std::max(kTxWLog2[t], kTxHLog2[t]);
  return tx_of(l, l);
}
inline int max_tx_rect(int bsize) {
  return tx_of(std::min(kBw4Log2[bsize] + 2, 6), std::min(kBh4Log2[bsize] + 2, 6));
}
// the transform size libaom's quantizer matrices, scans and contexts use
// for a 64-point side (32)
inline int adjusted_tx(int t) {
  return tx_of(std::min<int>(kTxWLog2[t], 5), std::min<int>(kTxHLog2[t], 5));
}

// ------------------------------------------------------- CDFs
struct Cdfs {
  uint16_t txb_skip[5][13][3];
  uint16_t eob_extra[5][2][9][3];
  uint16_t dc_sign[2][3][3];
  uint16_t eob16[2][2][6], eob32[2][2][7], eob64[2][2][8], eob128[2][2][9],
      eob256[2][2][10], eob512[2][2][11], eob1024[2][2][12];
  uint16_t base_eob[5][2][4][4];
  uint16_t base[5][2][42][5];
  uint16_t br[5][2][21][5];
  uint16_t skip[3][3];
  uint16_t seg_spatial[3][9];
  uint16_t filter_intra[22][3];
  uint16_t filter_intra_mode[6];
  uint16_t uv_mode[2][13][15];
  uint16_t partition[20][11];
  uint16_t kf_y[5][5][14];
  uint16_t angle_delta[8][8];
  uint16_t tx_size[4][3][4];
  uint16_t delta_q[5];
  uint16_t delta_lf_multi[4][5];
  uint16_t delta_lf[5];
  uint16_t intra_ext_tx[3][4][13][17];
  uint16_t cfl_sign[9];
  uint16_t cfl_alpha[6][17];
  uint16_t switchable_restore[4];
  uint16_t wiener_restore[3];
  uint16_t sgrproj_restore[3];
  uint16_t palette_y_size[7][8], palette_uv_size[7][8];
  uint16_t palette_y_color[7][5][9], palette_uv_color[7][5][9];
  uint16_t palette_y_mode[7][3][3], palette_uv_mode[2][3];
  uint16_t txfm_split[21][3];
  uint16_t intrabc[3];
  uint16_t inter_ext_tx[4][4][17];
  struct DvComponent {  // libaom's nmv_component, in its order
    uint16_t classes[12], class0_fp[2][5], fp[5], sign[3], class0_hp[3], hp[3],
        class0[3], bits[10][3];
  };
  struct Dv {
    uint16_t joints[5];
    DvComponent comps[2];  // row, column
  } dv;
};
static_assert(sizeof(Cdfs::Dv) == sizeof(kDefDv), "the IntraBC vector's CDFs");

void default_cdfs(Cdfs* c, int base_q_idx) {
  int q = base_q_idx <= 20 ? 0 : base_q_idx <= 60 ? 1 : base_q_idx <= 120 ? 2 : 3;
#define CP(dst, src) memcpy(dst, src, sizeof(dst))
  CP(c->txb_skip, kDefTxbSkip[q]);
  CP(c->eob_extra, kDefEobExtra[q]);
  CP(c->dc_sign, kDefDcSign[q]);
  CP(c->eob16, kDefEob16[q]);
  CP(c->eob32, kDefEob32[q]);
  CP(c->eob64, kDefEob64[q]);
  CP(c->eob128, kDefEob128[q]);
  CP(c->eob256, kDefEob256[q]);
  CP(c->eob512, kDefEob512[q]);
  CP(c->eob1024, kDefEob1024[q]);
  CP(c->base_eob, kDefBaseEob[q]);
  CP(c->base, kDefBase[q]);
  CP(c->br, kDefBr[q]);
  CP(c->skip, kDefSkip);
  CP(c->seg_spatial, kDefSegSpatial);
  CP(c->filter_intra, kDefFilterIntra);
  CP(c->filter_intra_mode, kDefFilterIntraMode);
  CP(c->uv_mode, kDefUvMode);
  CP(c->partition, kDefPartition);
  CP(c->kf_y, kDefKfY);
  CP(c->angle_delta, kDefAngleDelta);
  CP(c->tx_size, kDefTxSize);
  CP(c->delta_q, kDefDeltaQ);
  CP(c->delta_lf_multi, kDefDeltaLfMulti);
  CP(c->delta_lf, kDefDeltaLf);
  CP(c->intra_ext_tx, kDefIntraExtTx);
  CP(c->cfl_sign, kDefCflSign);
  CP(c->cfl_alpha, kDefCflAlpha);
  CP(c->switchable_restore, kDefSwitchableRestore);
  CP(c->wiener_restore, kDefWienerRestore);
  CP(c->sgrproj_restore, kDefSgrprojRestore);
  CP(c->palette_y_size, kDefPaletteYSize);
  CP(c->palette_uv_size, kDefPaletteUvSize);
  CP(c->palette_y_color, kDefPaletteYColor);
  CP(c->palette_uv_color, kDefPaletteUvColor);
  CP(c->palette_y_mode, kDefPaletteYMode);
  CP(c->palette_uv_mode, kDefPaletteUvMode);
  CP(c->txfm_split, kDefTxfmSplit);
  CP(c->intrabc, kDefIntrabc);
  CP(c->inter_ext_tx, kDefInterExtTx);
  memcpy(&c->dv, kDefDv, sizeof(kDefDv));
#undef CP
}

// ------------------------------------------------------- symbol decoder
// libaom's od_ec_dec with a 64-bit window; CDFs in the inverted form
// (32768 - cumulative probability), a counter after the last symbol.
struct SymbolDecoder {
  const uint8_t* bptr;
  const uint8_t* end;
  uint64_t dif;
  uint32_t rng;
  int cnt;
  bool update;

  void init(const uint8_t* buf, size_t size, bool allow_update) {
    bptr = buf;
    end = buf + size;
    dif = ((uint64_t)1 << 63) - 1;
    rng = 0x8000;
    cnt = -15;
    update = allow_update;
    refill();
  }
  void refill() {
    int s = 64 - 9 - (cnt + 15);
    for (; s >= 0 && bptr < end; s -= 8, bptr++) {
      dif ^= (uint64_t)bptr[0] << s;
      cnt += 8;
    }
    if (bptr >= end) cnt = 0x4000;
  }
  int normalize(uint64_t d, uint32_t r, int ret) {
    int shift = 15 - floor_log2(r);
    cnt -= shift;
    dif = ((d + 1) << shift) - 1;
    rng = r << shift;
    if (cnt < 0) refill();
    return ret;
  }
  int bool_q15(uint32_t f) {
    uint32_t v = ((rng >> 8) * (f >> 6) >> 1) + 4;
    uint64_t vw = (uint64_t)v << 48;
    int ret = 1;
    uint32_t r_new = v;
    uint64_t d = dif;
    if (d >= vw) {
      r_new = rng - v;
      d -= vw;
      ret = 0;
    }
    return normalize(d, r_new, ret);
  }
  int bit() { return bool_q15(16384); }
  int literal(int bits) {
    int v = 0;
    for (int i = 0; i < bits; i++) v = v << 1 | bit();
    return v;
  }
  int symbol(uint16_t* icdf, int nsyms) {
    uint32_t c = (uint32_t)(dif >> 48);
    uint32_t u, v = rng;
    int ret = -1;
    const int N = nsyms - 1;
    do {
      u = v;
      v = ((rng >> 8) * (uint32_t)(icdf[++ret] >> 6) >> 1) + 4 * (N - ret);
    } while (c < v);
    uint32_t r = u - v;
    uint64_t d = dif - ((uint64_t)v << 48);
    normalize(d, r, ret);
    if (update) adapt(icdf, ret, nsyms);
    return ret;
  }
  static void adapt(uint16_t* cdf, int val, int nsyms) {
    static const int speed[17] = {0, 0, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2};
    int count = cdf[nsyms];
    int rate = 3 + (count > 15) + (count > 31) + speed[nsyms];
    int tmp = 32768;
    for (int i = 0; i < nsyms - 1; i++) {
      if (i == val) tmp = 0;
      if (tmp < cdf[i])
        cdf[i] -= (uint16_t)((cdf[i] - tmp) >> rate);
      else
        cdf[i] += (uint16_t)((tmp - cdf[i]) >> rate);
    }
    cdf[nsyms] += (cdf[nsyms] < 32);
  }
  // a symbol of a two-entry CDF made for one read, not adapted
  int symbol_fixed(uint16_t icdf0) {
    uint16_t tmp[3] = {icdf0, 0, 0};
    bool u = update;
    update = false;
    int r = symbol(tmp, 2);
    update = u;
    return r;
  }
  // the specification's NS(n) and decode_signed_subexp_with_ref_bool
  // (libaom's aom_read_primitive_quniform and _refsubexpfin)
  int quniform(int n) {
    if (n <= 1) return 0;
    int l = floor_log2((uint32_t)n) + 1, m = (1 << l) - n;
    int v = literal(l - 1);
    return v < m ? v : (v << 1) - m + bit();
  }
  int subexp_ref(int low, int high, int k, int ref) {
    int n = high - low, r = ref - low, mk = 0, v;
    for (int i = 0;; i++) {
      int b2 = i ? k + i - 1 : k, a = 1 << b2;
      if (n <= mk + 3 * a) {
        v = quniform(n - mk) + mk;
        break;
      }
      if (!bit()) {
        v = literal(b2) + mk;
        break;
      }
      mk += a;
    }
    auto recenter = [](int r0, int v0) {
      return v0 > 2 * r0 ? v0 : (v0 & 1) ? r0 - ((v0 + 1) >> 1) : r0 + (v0 >> 1);
    };
    return low + ((r << 1) <= n ? recenter(r, v) : n - 1 - recenter(n - 1 - r, v));
  }
  int golomb() {
    int length = 0, i = 0;
    while (!i) {
      i = bit();
      if (++length > 20) bad("Golomb code (over 20 bits)");
    }
    int x = 1;
    for (i = 0; i < length - 1; i++) x = (x << 1) + bit();
    return x - 1;
  }
};

// ------------------------------------------------------- headers
struct SequenceHeader {
  int profile = 0, still = 0, reduced = 0;
  int op_idc = 0;
  int frame_width_bits = 0, frame_height_bits = 0, max_w = 0, max_h = 0;
  int frame_id_numbers_present = 0, delta_frame_id_len = 0, frame_id_len = 0;
  int sb128 = 0, filter_intra = 0, intra_edge = 0;
  int order_hint_bits = 0, enable_order_hint = 0;
  int screen_content = 0, integer_mv = 0;
  int superres = 0, cdef = 0, restoration = 0;
  int bit_depth = 8, mono = 0, ssx = 1, ssy = 1;
  int cp = 2, tc = 2, mc = 2, full_range = 0;
  int separate_uv_delta_q = 0;
  int film_grain = 0;
  int timing_info = 0, decoder_model_info = 0, equal_picture_interval = 0;
  int buffer_delay_len = 0, buffer_removal_time_len = 0;
  int frame_presentation_time_len = 0;
  int op_count = 1;
  int decoder_model_present[32] = {0};
  int op_idcs[32] = {0};
  bool seen = false;
};

void parse_sequence_header(Bits& b, SequenceHeader& s) {
  s.profile = b.f(3);
  if (s.profile > 2) bad("sequence header (profile " + std::to_string(s.profile) + ")");
  s.still = b.f(1);
  s.reduced = b.f(1);
  if (s.reduced) {
    s.op_idcs[0] = 0;
    b.f(5);  // seq_level_idx
  } else {
    s.timing_info = b.f(1);
    if (s.timing_info) {
      b.f(32);
      b.f(32);
      s.equal_picture_interval = b.f(1);
      if (s.equal_picture_interval) b.uvlc();
      s.decoder_model_info = b.f(1);
      if (s.decoder_model_info) {
        s.buffer_delay_len = b.f(5) + 1;
        b.f(32);  // num_units_in_decoding_tick
        s.buffer_removal_time_len = b.f(5) + 1;
        s.frame_presentation_time_len = b.f(5) + 1;
      }
    }
    int initial_display_delay = b.f(1);
    s.op_count = b.f(5) + 1;
    for (int i = 0; i < s.op_count; i++) {
      s.op_idcs[i] = b.f(12);
      int level = b.f(5);
      if (level > 7) b.f(1);
      if (s.decoder_model_info) {
        s.decoder_model_present[i] = b.f(1);
        if (s.decoder_model_present[i]) {  // operating_parameters_info
          b.f(s.buffer_delay_len);
          b.f(s.buffer_delay_len);
          b.f(1);
        }
      }
      if (initial_display_delay && b.f(1)) b.f(4);
    }
  }
  s.op_idc = s.op_idcs[0];
  s.frame_width_bits = b.f(4) + 1;
  s.frame_height_bits = b.f(4) + 1;
  s.max_w = b.f(s.frame_width_bits) + 1;
  s.max_h = b.f(s.frame_height_bits) + 1;
  if (!s.reduced) s.frame_id_numbers_present = b.f(1);
  if (s.frame_id_numbers_present) {
    s.delta_frame_id_len = b.f(4) + 2;
    s.frame_id_len = b.f(3) + s.delta_frame_id_len + 1;
  }
  s.sb128 = b.f(1);
  s.filter_intra = b.f(1);
  s.intra_edge = b.f(1);
  s.screen_content = 2;
  s.integer_mv = 2;
  if (!s.reduced) {
    b.f(1);  // enable_interintra_compound
    b.f(1);  // enable_masked_compound
    b.f(1);  // enable_warped_motion
    b.f(1);  // enable_dual_filter
    s.enable_order_hint = b.f(1);
    if (s.enable_order_hint) {
      b.f(1);  // enable_jnt_comp
      b.f(1);  // enable_ref_frame_mvs
    }
    if (b.f(1))
      s.screen_content = 2;
    else
      s.screen_content = b.f(1);
    if (s.screen_content > 0) {
      if (b.f(1))
        s.integer_mv = 2;
      else
        s.integer_mv = b.f(1);
    }
    if (s.enable_order_hint) s.order_hint_bits = b.f(3) + 1;
  }
  s.superres = b.f(1);
  s.cdef = b.f(1);
  s.restoration = b.f(1);
  // color_config
  int high = b.f(1);
  if (s.profile == 2 && high)
    s.bit_depth = b.f(1) ? 12 : 10;
  else
    s.bit_depth = high ? 10 : 8;
  s.mono = s.profile == 1 ? 0 : b.f(1);
  if (b.f(1)) {
    s.cp = b.f(8);
    s.tc = b.f(8);
    s.mc = b.f(8);
  } else {
    s.cp = s.tc = s.mc = 2;
  }
  if (s.mono) {
    s.full_range = b.f(1);
    s.ssx = s.ssy = 1;
    s.separate_uv_delta_q = 0;
  } else if (s.cp == 1 && s.tc == 13 && s.mc == 0) {
    s.full_range = 1;
    s.ssx = s.ssy = 0;
    if (s.profile != 1 && !(s.profile == 2 && s.bit_depth == 12))
      bad("sequence header (sRGB identity needs 4:4:4)");
    s.separate_uv_delta_q = b.f(1);
  } else {
    s.full_range = b.f(1);
    if (s.profile == 0) {
      s.ssx = s.ssy = 1;
    } else if (s.profile == 1) {
      s.ssx = s.ssy = 0;
    } else if (s.bit_depth == 12) {
      s.ssx = b.f(1);
      s.ssy = s.ssx ? b.f(1) : 0;
    } else {
      s.ssx = 1;
      s.ssy = 0;
    }
    if (s.ssx && s.ssy) b.f(2);  // chroma_sample_position
    s.separate_uv_delta_q = b.f(1);
  }
  s.film_grain = b.f(1);
  s.seen = true;
}

// libaom's RestorationType
enum { RESTORE_NONE, RESTORE_WIENER, RESTORE_SGRPROJ, RESTORE_SWITCHABLE };

struct FilmGrain {
  int apply = 0, seed = 0;
  int num_y = 0, num_cb = 0, num_cr = 0;
  int y_points[14][2], cb_points[10][2], cr_points[10][2];  // (value, scaling)
  int scaling_from_luma = 0, scaling_shift = 8;
  int ar_lag = 0, ar_shift = 6, grain_scale_shift = 0;
  int ar_y[24], ar_cb[25], ar_cr[25];  // minus 128
  int cb_mult = 0, cb_luma_mult = 0, cb_offset = 0;
  int cr_mult = 0, cr_luma_mult = 0, cr_offset = 0;
  int overlap = 0, restricted = 0;
};

struct FrameHeader {
  int width = 0, height = 0;
  int mi_cols = 0, mi_rows = 0;
  int disable_cdf_update = 0, screen_content = 0, allow_intrabc = 0;
  int disable_frame_end_update_cdf = 1;
  // tiles
  int tile_cols = 1, tile_rows = 1, tile_cols_log2 = 0, tile_rows_log2 = 0;
  std::vector<int> mi_col_starts, mi_row_starts;
  int tile_size_bytes = 4;
  // quantization
  int base_q_idx = 0;
  int dq_y_dc = 0, dq_u_dc = 0, dq_u_ac = 0, dq_v_dc = 0, dq_v_ac = 0;
  int using_qmatrix = 0, qm_y = 15, qm_u = 15, qm_v = 15;
  // segmentation
  int seg_enabled = 0;
  int feature_enabled[8][8] = {{0}};
  int feature_data[8][8] = {{0}};
  int seg_id_pre_skip = 0, last_active_seg_id = 0;
  // deltas
  int delta_q_present = 0, delta_q_res = 0;
  int delta_lf_present = 0, delta_lf_res = 0, delta_lf_multi = 0;
  int lossless[8] = {0};
  int coded_lossless = 0, all_lossless = 0;
  int seg_qm_level[3][8] = {{0}};
  // loop filter
  int lf_level[4] = {0};
  int lf_sharpness = 0, lf_delta_enabled = 0;
  int lf_ref_deltas[8] = {1, 0, 0, 0, -1, 0, -1, -1};
  int lf_mode_deltas[2] = {0, 0};
  // CDEF
  int cdef_damping = 3, cdef_bits = 0;
  int cdef_y_pri[8] = {0}, cdef_y_sec[8] = {0}, cdef_uv_pri[8] = {0},
      cdef_uv_sec[8] = {0};
  // loop restoration: the type (RESTORE_*) of each plane, and its unit size
  // where any plane has a type
  int lr_type[3] = {RESTORE_NONE, RESTORE_NONE, RESTORE_NONE};
  int lr_unit_size[3] = {0, 0, 0};
  int tx_mode_select = 0, only_4x4 = 0;
  int reduced_tx_set = 0;
  FilmGrain grain;
  bool seen = false;
};

const int kSegFeatureBits[8] = {8, 6, 6, 6, 6, 3, 0, 0};
const int kSegFeatureSigned[8] = {1, 1, 1, 1, 1, 0, 0, 0};
const int kSegFeatureMax[8] = {255, 63, 63, 63, 63, 7, 0, 0};

int tile_log2(int blk, int target) {
  int k = 0;
  while ((blk << k) < target) k++;
  return k;
}

int read_delta_q(Bits& b) { return b.f(1) ? b.su(7) : 0; }

void read_points(Bits& b, int n, int max, int (*pts)[2], const char* what) {
  if (n > max) bad(std::string("film grain (") + what + " points)");
  for (int i = 0; i < n; i++) {
    pts[i][0] = b.f(8);
    pts[i][1] = b.f(8);
    if (i && pts[i][0] <= pts[i - 1][0])
      bad(std::string("film grain (") + what + " points not increasing)");
  }
}

void parse_film_grain(Bits& b, const SequenceHeader& s, FilmGrain& g) {
  g.apply = b.f(1);
  if (!g.apply) return;
  g.seed = b.f(16);
  // update_grain is 1 in a key frame
  g.num_y = b.f(4);
  read_points(b, g.num_y, 14, g.y_points, "luma");
  g.scaling_from_luma = s.mono ? 0 : (int)b.f(1);
  if (!s.mono && !g.scaling_from_luma && !(s.ssx && s.ssy && !g.num_y)) {
    g.num_cb = b.f(4);
    read_points(b, g.num_cb, 10, g.cb_points, "cb");
    g.num_cr = b.f(4);
    read_points(b, g.num_cr, 10, g.cr_points, "cr");
    if (s.ssx && s.ssy && !g.num_cb != !g.num_cr)
      bad("film grain (4:2:0 grain on one chroma plane)");
  }
  g.scaling_shift = b.f(2) + 8;
  g.ar_lag = b.f(2);
  int num_pos = 2 * g.ar_lag * (g.ar_lag + 1);
  if (g.num_y)
    for (int i = 0; i < num_pos; i++) g.ar_y[i] = (int)b.f(8) - 128;
  int num_chroma = num_pos + (g.num_y > 0);
  if (g.scaling_from_luma || g.num_cb)
    for (int i = 0; i < num_chroma; i++) g.ar_cb[i] = (int)b.f(8) - 128;
  if (g.scaling_from_luma || g.num_cr)
    for (int i = 0; i < num_chroma; i++) g.ar_cr[i] = (int)b.f(8) - 128;
  g.ar_shift = b.f(2) + 6;
  g.grain_scale_shift = b.f(2);
  if (g.num_cb) {
    g.cb_mult = b.f(8);
    g.cb_luma_mult = b.f(8);
    g.cb_offset = b.f(9);
  }
  if (g.num_cr) {
    g.cr_mult = b.f(8);
    g.cr_luma_mult = b.f(8);
    g.cr_offset = b.f(9);
  }
  g.overlap = b.f(1);
  g.restricted = b.f(1);
}

void parse_frame_header(Bits& b, const SequenceHeader& s, FrameHeader& h,
                        int temporal_id, int spatial_id) {
  int frame_type = 0, show_frame = 1;
  if (!s.reduced) {
    if (b.f(1)) refuse("show_existing_frame (a frame not coded in the item)");
    frame_type = b.f(2);
    show_frame = b.f(1);
    if (show_frame && s.decoder_model_info && !s.equal_picture_interval)
      b.f(s.frame_presentation_time_len);
    if (!show_frame) b.f(1);  // showable_frame
    if (frame_type != 3 && !(frame_type == 0 && show_frame))
      b.f(1);  // error_resilient_mode
  }
  if (frame_type != 0 || !show_frame)
    refuse("frame other than a shown key frame (an image sequence's or a "
           "layered image's)");
  h.disable_cdf_update = b.f(1);
  h.screen_content = s.screen_content == 2 ? (int)b.f(1) : s.screen_content;
  // force_integer_mv: 1 in an intra frame whatever is coded
  if (h.screen_content && s.integer_mv == 2) b.f(1);
  if (s.frame_id_numbers_present) b.f(s.frame_id_len);
  int frame_size_override = s.reduced ? 0 : b.f(1);
  b.f(s.order_hint_bits);  // order_hint
  // primary_ref_frame: none for a key frame
  if (s.decoder_model_info) {
    if (b.f(1)) {  // buffer_removal_time_present_flag
      for (int op = 0; op < s.op_count; op++) {
        if (!s.decoder_model_present[op]) continue;
        int idc = s.op_idcs[op];
        int in_t = (idc >> temporal_id) & 1, in_s = (idc >> (spatial_id + 8)) & 1;
        if (idc == 0 || (in_t && in_s)) b.f(s.buffer_removal_time_len);
      }
    }
  }
  // refresh_frame_flags is 0xFF for a shown key frame
  if (frame_size_override) {
    h.width = b.f(s.frame_width_bits) + 1;
    h.height = b.f(s.frame_height_bits) + 1;
  } else {
    h.width = s.max_w;
    h.height = s.max_h;
  }
  if (s.superres && b.f(1)) refuse("superres");
  h.mi_cols = 2 * ((h.width + 7) >> 3);
  h.mi_rows = 2 * ((h.height + 7) >> 3);
  if (b.f(1)) {  // render_and_frame_size_different
    b.f(16);
    b.f(16);
  }
  // superres is refused, so the upscaled width is the frame width
  if (h.screen_content) h.allow_intrabc = b.f(1);
  if (s.reduced || h.disable_cdf_update)
    h.disable_frame_end_update_cdf = 1;
  else
    h.disable_frame_end_update_cdf = b.f(1);
  // tile_info
  {
    int sb_cols = s.sb128 ? (h.mi_cols + 31) >> 5 : (h.mi_cols + 15) >> 4;
    int sb_rows = s.sb128 ? (h.mi_rows + 31) >> 5 : (h.mi_rows + 15) >> 4;
    int sb_shift = s.sb128 ? 5 : 4;
    int sb_size = sb_shift + 2;
    int max_tile_width_sb = 4096 >> sb_size;
    int max_tile_area_sb = (4096 * 2304) >> (2 * sb_size);
    int min_log2_tile_cols = tile_log2(max_tile_width_sb, sb_cols);
    int max_log2_tile_cols = tile_log2(1, std::min(sb_cols, 64));
    int max_log2_tile_rows = tile_log2(1, std::min(sb_rows, 64));
    int min_log2_tiles = std::max(min_log2_tile_cols,
                                  tile_log2(max_tile_area_sb, sb_rows * sb_cols));
    h.mi_col_starts.clear();
    h.mi_row_starts.clear();
    if (b.f(1)) {  // uniform_tile_spacing_flag
      h.tile_cols_log2 = min_log2_tile_cols;
      while (h.tile_cols_log2 < max_log2_tile_cols && b.f(1)) h.tile_cols_log2++;
      int tw = (sb_cols + (1 << h.tile_cols_log2) - 1) >> h.tile_cols_log2;
      for (int start = 0; start < sb_cols; start += tw)
        h.mi_col_starts.push_back(start << sb_shift);
      h.tile_cols = (int)h.mi_col_starts.size();
      h.mi_col_starts.push_back(h.mi_cols);
      int min_log2_tile_rows = std::max(min_log2_tiles - h.tile_cols_log2, 0);
      h.tile_rows_log2 = min_log2_tile_rows;
      while (h.tile_rows_log2 < max_log2_tile_rows && b.f(1)) h.tile_rows_log2++;
      int th = (sb_rows + (1 << h.tile_rows_log2) - 1) >> h.tile_rows_log2;
      for (int start = 0; start < sb_rows; start += th)
        h.mi_row_starts.push_back(start << sb_shift);
      h.tile_rows = (int)h.mi_row_starts.size();
      h.mi_row_starts.push_back(h.mi_rows);
    } else {
      int widest = 0, start = 0;
      while (start < sb_cols) {
        h.mi_col_starts.push_back(start << sb_shift);
        int size = (int)b.ns((uint32_t)std::min(sb_cols - start, max_tile_width_sb)) + 1;
        widest = std::max(widest, size);
        start += size;
      }
      h.tile_cols = (int)h.mi_col_starts.size();
      h.mi_col_starts.push_back(h.mi_cols);
      h.tile_cols_log2 = tile_log2(1, h.tile_cols);
      int area = min_log2_tiles > 0 ? (sb_rows * sb_cols) >> (min_log2_tiles + 1)
                                    : sb_rows * sb_cols;
      int max_tile_height_sb = std::max(area / widest, 1);
      start = 0;
      while (start < sb_rows) {
        h.mi_row_starts.push_back(start << sb_shift);
        int size = (int)b.ns((uint32_t)std::min(sb_rows - start, max_tile_height_sb)) + 1;
        start += size;
      }
      h.tile_rows = (int)h.mi_row_starts.size();
      h.mi_row_starts.push_back(h.mi_rows);
      h.tile_rows_log2 = tile_log2(1, h.tile_rows);
    }
    if (h.tile_cols > 64 || h.tile_rows > 64) bad("tile info (over 64 tiles a side)");
    if (h.tile_cols_log2 > 0 || h.tile_rows_log2 > 0) {
      b.f(h.tile_rows_log2 + h.tile_cols_log2);  // context_update_tile_id
      h.tile_size_bytes = b.f(2) + 1;
    }
  }
  // quantization_params
  h.base_q_idx = b.f(8);
  h.dq_y_dc = read_delta_q(b);
  if (!s.mono) {
    int diff_uv = s.separate_uv_delta_q ? b.f(1) : 0;
    h.dq_u_dc = read_delta_q(b);
    h.dq_u_ac = read_delta_q(b);
    if (diff_uv) {
      h.dq_v_dc = read_delta_q(b);
      h.dq_v_ac = read_delta_q(b);
    } else {
      h.dq_v_dc = h.dq_u_dc;
      h.dq_v_ac = h.dq_u_ac;
    }
  }
  h.using_qmatrix = b.f(1);
  if (h.using_qmatrix) {
    h.qm_y = b.f(4);
    h.qm_u = b.f(4);
    h.qm_v = s.separate_uv_delta_q ? (int)b.f(4) : h.qm_u;
  }
  // segmentation_params
  h.seg_enabled = b.f(1);
  if (h.seg_enabled) {
    // primary_ref_frame is none: update_map = 1, update_data = 1
    for (int i = 0; i < 8; i++)
      for (int j = 0; j < 8; j++) {
        int v = 0;
        h.feature_enabled[i][j] = b.f(1);
        if (h.feature_enabled[i][j]) {
          int bits = kSegFeatureBits[j], lim = kSegFeatureMax[j];
          if (kSegFeatureSigned[j])
            v = clip3(-lim, lim, b.su(1 + bits));
          else
            v = clip3(0, lim, (int)b.f(bits));
        }
        h.feature_data[i][j] = v;
      }
    for (int i = 0; i < 8; i++)
      for (int j = 0; j < 8; j++)
        if (h.feature_enabled[i][j]) {
          h.last_active_seg_id = i;
          if (j >= 5) h.seg_id_pre_skip = 1;
        }
  }
  // delta_q_params, delta_lf_params
  if (h.base_q_idx > 0) h.delta_q_present = b.f(1);
  if (h.delta_q_present) {
    h.delta_q_res = b.f(2);
    if (!h.allow_intrabc) h.delta_lf_present = b.f(1);
    if (h.delta_lf_present) {
      h.delta_lf_res = b.f(2);
      h.delta_lf_multi = b.f(1);
    }
  }
  h.coded_lossless = 1;
  for (int seg = 0; seg < 8; seg++) {
    int q = h.base_q_idx;
    if (h.seg_enabled && h.feature_enabled[seg][0])
      q = clip3(0, 255, q + h.feature_data[seg][0]);
    h.lossless[seg] = q == 0 && !h.dq_y_dc && !h.dq_u_ac && !h.dq_u_dc &&
                      !h.dq_v_ac && !h.dq_v_dc;
    if (!h.lossless[seg]) h.coded_lossless = 0;
    if (h.using_qmatrix && !h.lossless[seg]) {
      h.seg_qm_level[0][seg] = h.qm_y;
      h.seg_qm_level[1][seg] = h.qm_u;
      h.seg_qm_level[2][seg] = h.qm_v;
    } else {
      h.seg_qm_level[0][seg] = h.seg_qm_level[1][seg] = h.seg_qm_level[2][seg] = 15;
    }
  }
  h.all_lossless = h.coded_lossless;
  // loop_filter_params, cdef_params and lr_params: none with intra block
  // copy
  if (!h.coded_lossless && !h.allow_intrabc) {
    h.lf_level[0] = b.f(6);
    h.lf_level[1] = b.f(6);
    if (!s.mono && (h.lf_level[0] || h.lf_level[1])) {
      h.lf_level[2] = b.f(6);
      h.lf_level[3] = b.f(6);
    }
    h.lf_sharpness = b.f(3);
    h.lf_delta_enabled = b.f(1);
    if (h.lf_delta_enabled && b.f(1)) {
      for (int i = 0; i < 8; i++)
        if (b.f(1)) h.lf_ref_deltas[i] = b.su(7);
      for (int i = 0; i < 2; i++)
        if (b.f(1)) h.lf_mode_deltas[i] = b.su(7);
    }
  }
  // cdef_params
  if (!h.coded_lossless && !h.allow_intrabc && s.cdef) {
    h.cdef_damping = b.f(2) + 3;
    h.cdef_bits = b.f(2);
    for (int i = 0; i < (1 << h.cdef_bits); i++) {
      h.cdef_y_pri[i] = b.f(4);
      h.cdef_y_sec[i] = b.f(2);
      if (h.cdef_y_sec[i] == 3) h.cdef_y_sec[i]++;
      if (!s.mono) {
        h.cdef_uv_pri[i] = b.f(4);
        h.cdef_uv_sec[i] = b.f(2);
        if (h.cdef_uv_sec[i] == 3) h.cdef_uv_sec[i]++;
      }
    }
  }
  // lr_params
  if (!h.all_lossless && !h.allow_intrabc && s.restoration) {
    static const int remap[4] = {RESTORE_NONE, RESTORE_SWITCHABLE, RESTORE_WIENER,
                                 RESTORE_SGRPROJ};
    bool uses = false, uses_chroma = false;
    for (int p = 0; p < (s.mono ? 1 : 3); p++) {
      h.lr_type[p] = remap[b.f(2)];
      if (h.lr_type[p] != RESTORE_NONE) {
        uses = true;
        uses_chroma = uses_chroma || p > 0;
      }
    }
    if (uses) {
      int shift = b.f(1);
      if (s.sb128)
        shift++;
      else if (shift)
        shift += b.f(1);
      int uv_shift = s.ssx && s.ssy && uses_chroma ? (int)b.f(1) : 0;
      for (int p = 0; p < (s.mono ? 1 : 3); p++)
        h.lr_unit_size[p] = (256 >> (2 - shift)) >> (p ? uv_shift : 0);
    }
  }
  // read_tx_mode
  if (h.coded_lossless)
    h.only_4x4 = 1;
  else
    h.tx_mode_select = b.f(1);
  // frame_reference_mode, skip_mode: none in an intra frame; warped motion
  // off
  h.reduced_tx_set = b.f(1);
  // global motion: none in an intra frame
  // film_grain_params (a shown frame)
  if (s.film_grain) parse_film_grain(b, s, h.grain);
  h.seen = true;
}

// ------------------------------------------------------- frame state
struct Plane {
  std::vector<uint16_t> px;
  int stride = 0, w = 0, h = 0;  // w, h: the allocated area
  uint16_t* row(int y) { return px.data() + (size_t)y * stride; }
  uint16_t& at(int y, int x) { return px[(size_t)y * stride + x]; }
};

struct MiInfo {
  uint8_t size = 0, skip = 0, seg = 0, ymode = 0, uvmode = 0, tx = 0;
  int8_t delta_lf[4] = {0, 0, 0, 0};
  // an IntraBC block (the only inter block of an intra frame) and its
  // vector (row, column, in eighths of a luma sample)
  uint8_t is_inter = 0;
  int16_t mv[2] = {0, 0};
  // palette sizes (Y, UV) and the block's colours (Y, then U) in the
  // decoder's palettes
  uint8_t palette_size[2] = {0, 0};
  int32_t palette = -1;
};

const uint8_t kModeToAngle[13] = {0, 90, 180, 45, 135, 113, 157, 203, 67, 0, 0, 0, 0};
const uint8_t kIntraModeContext[13] = {0, 1, 2, 3, 4, 4, 4, 4, 3, 0, 1, 2, 0};
const uint8_t kModeToTxType[14] = {DCT_DCT,   ADST_DCT,  DCT_ADST, DCT_DCT,
                                   ADST_ADST, ADST_DCT,  DCT_ADST, DCT_ADST,
                                   ADST_DCT,  ADST_ADST, ADST_DCT, DCT_ADST,
                                   ADST_ADST, DCT_DCT};
// the specification's Wiener_Taps_Min/Max/K and Sgrproj_Xqd_Min/Max
// (libaom's WIENER_FILT_TAP*_MINV/MAXV/SUBEXP_K and SGRPROJ_PRJ_MIN*/MAX*,
// macros its code folds in); the references each tile starts from come
// from libaom (kWienerTapsMid, kSgrprojXqdMid)
const int kWienerTapsMin[3] = {-5, -23, -17};
const int kWienerTapsMax[3] = {10, 8, 46};
const int kWienerTapsK[3] = {1, 2, 3};
const int kSgrprojXqdMin[2] = {-96, -32};
const int kSgrprojXqdMax[2] = {31, 95};
constexpr int kSgrprojSubexpK = 4;

// a restoration unit's coefficients as read
struct LrUnit {
  uint8_t type = RESTORE_NONE;
  uint8_t set = 0;           // self-guided parameter set
  int8_t wiener[2][3] = {};  // vertical, horizontal taps 0-2
  int16_t xqd[2] = {};
};

const uint8_t kFilterIntraModeToDir[5] = {DC_PRED, V_PRED, H_PRED, D157_PRED, DC_PRED};
// libaom's TxSetType (the rows of kExtTxInv and kExtTxUsed), each set's
// number of types, and its index among the intra and the inter sets
enum { SET_DCTONLY, SET_DCT_IDTX, SET_DTT4_IDTX, SET_DTT4_IDTX_1DDCT, SET_DTT9_IDTX_1DDCT,
       SET_ALL16 };
const uint8_t kTxSetTypes[6] = {1, 2, 5, 7, 12, 16};
const int8_t kTxSetIndex[2][6] = {{0, -1, 2, 1, -1, -1}, {0, 3, -1, -1, 2, 1}};

enum { TX_CLASS_2D, TX_CLASS_HORIZ, TX_CLASS_VERT };
inline int tx_class(int t) {
  return (t == V_DCT || t == V_ADST || t == V_FLIPADST) ? TX_CLASS_VERT
         : (t == H_DCT || t == H_ADST || t == H_FLIPADST) ? TX_CLASS_HORIZ
                                                           : TX_CLASS_2D;
}

const uint16_t* scan_for(int tx, int type) {
  int a = adjusted_tx(tx);
  int cls = type == IDTX ? TX_CLASS_2D : tx_class(type);
  int w = 1 << kTxWLog2[a], h = 1 << kTxHLog2[a];
#define S(W, H)                                                        \
  if (w == W && h == H)                                                \
    return cls == TX_CLASS_VERT    ? kScan_mrow_##W##x##H            \
           : cls == TX_CLASS_HORIZ ? kScan_mcol_##W##x##H            \
                                   : kScan_default_##W##x##H;
  S(4, 4) S(8, 8) S(16, 16) S(32, 32) S(4, 8) S(8, 4) S(8, 16) S(16, 8)
  S(16, 32) S(32, 16) S(4, 16) S(16, 4) S(8, 32) S(32, 8)
#undef S
  bad("transform size");
}

// offset of each quantizer matrix in a level's 3344 entries (64-point
// sides use the 32-point matrix)
int qm_offset(int a) {
  static const int off[TX_SIZES_ALL] = {0,    16,   80,   336, -1,   1360, 1392,
                                        1424, 1552, 1680, 2192, -1,  -1,   2704,
                                        2768, 2832, 3088, -1,   -1};
  return off[a];
}

class Decoder {
 public:
  const SequenceHeader& s;
  const FrameHeader& h;
  Plane planes[3];
  int num_planes;
  std::vector<MiInfo> mi;
  std::vector<int8_t> cdef_idx;  // per 64x64 unit
  int cdef_cols = 0;
  // per plane, per 4x4 unit of the plane: transform size for the loop
  // filter
  std::vector<uint8_t> lf_tx[3];
  int lf_stride[3] = {0, 0, 0};
  // contexts
  std::vector<uint8_t> above_level[3], above_dc[3], left_level[3], left_dc[3];
  Cdfs frame_cdf;
  Cdfs cdf;
  SymbolDecoder sd;
  int mi_row_start = 0, mi_row_end = 0, mi_col_start = 0, mi_col_end = 0;
  int current_q = 0;
  int delta_lf[4] = {0, 0, 0, 0};
  bool read_deltas = false;
  // BlockDecoded, per plane, indices offset by 1
  uint8_t decoded[3][35][35];

  // the block being decoded
  int mi_row = 0, mi_col = 0, mi_size = 0, bw4 = 1, bh4 = 1;
  bool has_chroma = false, avail_u = false, avail_l = false;
  bool avail_u_chroma = false, avail_l_chroma = false;
  int skip = 0, segment_id = 0, lossless = 0;
  int ymode = 0, uvmode = 0, angle_y = 0, angle_uv = 0;
  int use_filter_intra = 0, filter_intra_mode = 0;
  int cfl_alpha_u = 0, cfl_alpha_v = 0;
  int tx_size = 0;
  int max_luma_w = 0, max_luma_h = 0;
  std::vector<uint8_t> tx_types;  // per 4x4 luma unit of the frame
  // per 4x4 luma unit within the frame: the luma transform size (an
  // IntraBC block's variable tree, else the block's size)
  std::vector<uint8_t> inter_tx;
  int block_partition = PARTITION_NONE;  // the partition the block came from
  // screen content: the block's palette sizes (Y, UV) and colours (Y, U,
  // V), its colour index maps (Y, UV) and their widths; every palette
  // block's Y and U colours (the neighbours' cache); an IntraBC block's
  // vector (row, column)
  int use_intrabc = 0;
  int palette_size[2] = {0, 0};
  uint16_t palette_colors[3][8] = {};
  uint8_t color_map[2][64 * 64];
  int color_map_w[2] = {0, 0};
  std::vector<uint16_t> palettes;
  int mv[2] = {0, 0};
  // blocks with a Y palette, with a UV palette, and IntraBC blocks
  int palette_blocks[2] = {0, 0}, intrabc_blocks = 0;
  int32_t quant[1024];
  int32_t dequant[64 * 64];
  // loop restoration: each plane's units (rows x cols), the references of
  // the tile being read, and which unit types were read (bit per RESTORE_*)
  std::vector<LrUnit> lr_units[3];
  int lr_rows[3] = {0, 0, 0}, lr_cols[3] = {0, 0, 0};
  int ref_wiener[3][2][3], ref_xqd[3][2];
  int lr_read_types[3] = {0, 0, 0};

  Decoder(const SequenceHeader& seq, const FrameHeader& fh) : s(seq), h(fh) {
    num_planes = s.mono ? 1 : 3;
    int sb = s.sb128 ? 128 : 64;
    int aw = (h.mi_cols * 4 + sb - 1) / sb * sb + 64;
    int ah = (h.mi_rows * 4 + sb - 1) / sb * sb + 64;
    for (int p = 0; p < num_planes; p++) {
      int sx = p ? s.ssx : 0, sy = p ? s.ssy : 0;
      planes[p].w = aw >> sx;
      planes[p].h = ah >> sy;
      planes[p].stride = planes[p].w;
      planes[p].px.assign((size_t)planes[p].w * planes[p].h, 0);
      lf_stride[p] = planes[p].w >> 2;
      lf_tx[p].assign((size_t)lf_stride[p] * (planes[p].h >> 2), 0);
      above_level[p].assign(planes[p].w >> 2, 0);
      above_dc[p].assign(planes[p].w >> 2, 0);
      left_level[p].assign(planes[p].h >> 2, 0);
      left_dc[p].assign(planes[p].h >> 2, 0);
    }
    mi.assign((size_t)h.mi_rows * h.mi_cols, MiInfo());
    cdef_cols = (h.mi_cols + 15) >> 4;
    cdef_idx.assign((size_t)cdef_cols * ((h.mi_rows + 15) >> 4), -1);
    tx_types.assign((size_t)(aw >> 2) * (ah >> 2), DCT_DCT);
    inter_tx.assign((size_t)h.mi_rows * h.mi_cols, TX_4X4);
    default_cdfs(&frame_cdf, h.base_q_idx);
    for (int p = 0; p < num_planes; p++) {
      if (h.lr_type[p] == RESTORE_NONE) continue;
      int sx = p ? s.ssx : 0, sy = p ? s.ssy : 0, size = h.lr_unit_size[p];
      lr_rows[p] = lr_count_units(size, (h.height + sy) >> sy);
      lr_cols[p] = lr_count_units(size, (h.width + sx) >> sx);
      lr_units[p].assign((size_t)lr_rows[p] * lr_cols[p], LrUnit());
    }
  }
  static int lr_count_units(int size, int n) { return std::max((n + (size >> 1)) / size, 1); }

  MiInfo& at(int r, int c) { return mi[(size_t)r * h.mi_cols + c]; }
  bool inside(int r, int c) const {
    return c >= mi_col_start && c < mi_col_end && r >= mi_row_start && r < mi_row_end;
  }
  int qindex(bool ignore_delta, int seg) const {
    if (h.seg_enabled && h.feature_enabled[seg][0]) {
      int data = h.feature_data[seg][0];
      int q = h.base_q_idx + data;
      if (!ignore_delta && h.delta_q_present) q = current_q + data;
      return clip3(0, 255, q);
    }
    if (!ignore_delta && h.delta_q_present) return current_q;
    return h.base_q_idx;
  }
  int plane_block(int bsize, int plane) const {
    if (!plane) return bsize;
    int wl = std::max(0, kBw4Log2[bsize] - s.ssx);
    int hl = std::max(0, kBh4Log2[bsize] - s.ssy);
    return block_of(wl, hl);
  }
  int uv_tx(int bsize) const {
    int pb = plane_block(bsize, 1);
    if (pb == BLOCK_INVALID) bad("block size for the chroma subsampling");
    return adjusted_tx(max_tx_rect(pb));
  }

  // ---------------------------------------------------------- tiles
  void decode_tile_group(const uint8_t* d, size_t n, Bits& b, int* next_tile) {
    int num_tiles = h.tile_cols * h.tile_rows;
    int tg_start = 0, tg_end = num_tiles - 1;
    if (num_tiles > 1 && b.f(1)) {
      int bits = h.tile_cols_log2 + h.tile_rows_log2;
      tg_start = b.f(bits);
      tg_end = b.f(bits);
    }
    b.byte_align();
    if (tg_start != *next_tile || tg_end < tg_start || tg_end >= num_tiles)
      bad("tile group (tiles out of order)");
    size_t at = b.pos >> 3;
    for (int t = tg_start; t <= tg_end; t++) {
      size_t size;
      if (t == tg_end) {
        if (at > n) bad("tile group (ends early)");
        size = n - at;
      } else {
        if (at + h.tile_size_bytes > n) bad("tile size (ends early)");
        size = 0;
        for (int i = 0; i < h.tile_size_bytes; i++) size |= (size_t)d[at + i] << (8 * i);
        size += 1;
        at += h.tile_size_bytes;
        if (size > n - at) bad("tile size (past the tile group)");
      }
      decode_tile(t / h.tile_cols, t % h.tile_cols, d + at, size);
      at += size;
    }
    *next_tile = tg_end + 1;
  }

  void decode_tile(int tile_row, int tile_col, const uint8_t* d, size_t n) {
    mi_row_start = h.mi_row_starts[tile_row];
    mi_row_end = h.mi_row_starts[tile_row + 1];
    mi_col_start = h.mi_col_starts[tile_col];
    mi_col_end = h.mi_col_starts[tile_col + 1];
    current_q = h.base_q_idx;
    cdf = frame_cdf;
    sd.init(d, n, !h.disable_cdf_update);
    for (int p = 0; p < num_planes; p++) {
      std::fill(above_level[p].begin(), above_level[p].end(), 0);
      std::fill(above_dc[p].begin(), above_dc[p].end(), 0);
    }
    for (int i = 0; i < 4; i++) delta_lf[i] = 0;
    for (int p = 0; p < num_planes; p++)
      for (int pass = 0; pass < 2; pass++) {
        ref_xqd[p][pass] = kSgrprojXqdMid[pass];
        for (int i = 0; i < 3; i++) ref_wiener[p][pass][i] = kWienerTapsMid[i];
      }
    int sb_size = s.sb128 ? BLOCK_128X128 : BLOCK_64X64;
    int sb4 = s.sb128 ? 32 : 16;
    for (int r = mi_row_start; r < mi_row_end; r += sb4) {
      for (int p = 0; p < num_planes; p++) {
        std::fill(left_level[p].begin(), left_level[p].end(), 0);
        std::fill(left_dc[p].begin(), left_dc[p].end(), 0);
      }
      for (int c = mi_col_start; c < mi_col_end; c += sb4) {
        read_deltas = h.delta_q_present;
        clear_block_decoded(r, c, sb4);
        read_lr(r, c, sb4);
        decode_partition(r, c, sb_size);
      }
    }
  }

  // the restoration units whose top-left lies in the superblock at (r, c)
  void read_lr(int r, int c, int sb4) {
    for (int p = 0; p < num_planes; p++) {
      if (h.lr_type[p] == RESTORE_NONE) continue;
      int sx = p ? s.ssx : 0, sy = p ? s.ssy : 0, size = h.lr_unit_size[p];
      int row0 = (r * (4 >> sy) + size - 1) / size;
      int row1 = std::min(lr_rows[p], ((r + sb4) * (4 >> sy) + size - 1) / size);
      int col0 = (c * (4 >> sx) + size - 1) / size;
      int col1 = std::min(lr_cols[p], ((c + sb4) * (4 >> sx) + size - 1) / size);
      for (int ur = row0; ur < row1; ur++)
        for (int uc = col0; uc < col1; uc++)
          read_lr_unit(p, lr_units[p][(size_t)ur * lr_cols[p] + uc]);
    }
  }
  void read_lr_unit(int p, LrUnit& u) {
    int type;
    if (h.lr_type[p] == RESTORE_WIENER)
      type = sd.symbol(cdf.wiener_restore, 2) ? RESTORE_WIENER : RESTORE_NONE;
    else if (h.lr_type[p] == RESTORE_SGRPROJ)
      type = sd.symbol(cdf.sgrproj_restore, 2) ? RESTORE_SGRPROJ : RESTORE_NONE;
    else
      type = sd.symbol(cdf.switchable_restore, 3);
    u.type = (uint8_t)type;
    lr_read_types[p] |= 1 << type;
    if (type == RESTORE_WIENER) {
      for (int pass = 0; pass < 2; pass++)
        for (int j = 0; j < 3; j++) {
          int v = 0;
          if (j || !p)
            v = sd.subexp_ref(kWienerTapsMin[j], kWienerTapsMax[j] + 1, kWienerTapsK[j],
                              ref_wiener[p][pass][j]);
          u.wiener[pass][j] = (int8_t)v;
          ref_wiener[p][pass][j] = v;
        }
    } else if (type == RESTORE_SGRPROJ) {
      u.set = (uint8_t)sd.literal(4);
      const int32_t* prm = kSgrParams[u.set];
      for (int i = 0; i < 2; i++) {
        int v = 0;
        if (prm[i])
          v = sd.subexp_ref(kSgrprojXqdMin[i], kSgrprojXqdMax[i] + 1, kSgrprojSubexpK,
                            ref_xqd[p][i]);
        else if (i == 1)
          v = clip3(kSgrprojXqdMin[1], kSgrprojXqdMax[1], 128 - ref_xqd[p][0]);
        u.xqd[i] = (int16_t)v;
        ref_xqd[p][i] = v;
      }
    }
  }

  void clear_block_decoded(int r, int c, int sb4) {
    for (int p = 0; p < num_planes; p++) {
      int sx = p ? s.ssx : 0, sy = p ? s.ssy : 0;
      int sbw4 = (mi_col_end - c) >> sx, sbh4 = (mi_row_end - r) >> sy;
      for (int y = -1; y <= (sb4 >> sy); y++)
        for (int x = -1; x <= (sb4 >> sx); x++) {
          uint8_t v = 0;
          if (y < 0 && x < sbw4)
            v = 1;
          else if (x < 0 && y < sbh4)
            v = 1;
          decoded[p][y + 1][x + 1] = v;
        }
      decoded[p][(sb4 >> sy) + 1][0] = 0;
    }
  }

  // ---------------------------------------------------------- partitions
  void decode_partition(int r, int c, int bsize) {
    if (r >= h.mi_rows || c >= h.mi_cols) return;
    bool au = inside(r - 1, c), al = inside(r, c - 1);
    int num4 = 1 << kBw4Log2[bsize];
    int half = num4 >> 1, quarter = half >> 1;
    bool has_rows = (r + half) < h.mi_rows, has_cols = (c + half) < h.mi_cols;
    int partition;
    if (bsize < BLOCK_8X8) {
      partition = PARTITION_NONE;
    } else {
      int bsl = kBw4Log2[bsize];  // 1 (8x8) .. 5 (128x128)
      int above = au && kBw4Log2[at(r - 1, c).size] < bsl;
      int left = al && kBh4Log2[at(r, c - 1).size] < bsl;
      int ctx = left * 2 + above;
      uint16_t* pc = cdf.partition[(bsl - 1) * 4 + ctx];
      int nsyms = bsl == 1 ? 4 : bsl == 5 ? 8 : 10;
      auto prob = [&](int k) {  // probability of symbol k (of 32768)
        return (k ? pc[k - 1] : 32768) - pc[k];
      };
      if (has_rows && has_cols) {
        partition = sd.symbol(pc, nsyms);
      } else if (has_cols) {
        // split_or_horz
        int psum = prob(PARTITION_VERT) + prob(PARTITION_SPLIT) +
                   prob(PARTITION_HORZ_A) + prob(PARTITION_VERT_A) +
                   prob(PARTITION_VERT_B);
        if (bsize != BLOCK_128X128) psum += prob(PARTITION_VERT_4);
        partition = sd.symbol_fixed((uint16_t)psum) ? PARTITION_SPLIT : PARTITION_HORZ;
      } else if (has_rows) {
        int psum = prob(PARTITION_HORZ) + prob(PARTITION_SPLIT) +
                   prob(PARTITION_HORZ_A) + prob(PARTITION_HORZ_B) +
                   prob(PARTITION_VERT_A);
        if (bsize != BLOCK_128X128) psum += prob(PARTITION_HORZ_4);
        partition = sd.symbol_fixed((uint16_t)psum) ? PARTITION_SPLIT : PARTITION_VERT;
      } else {
        partition = PARTITION_SPLIT;
      }
    }
    int wl = kBw4Log2[bsize], hl = kBh4Log2[bsize];
    int horz = block_of(wl, hl - 1), vert = block_of(wl - 1, hl);
    int split = block_of(wl - 1, hl - 1);
    block_partition = partition;
    switch (partition) {
      case PARTITION_NONE:
        decode_block(r, c, bsize);
        break;
      case PARTITION_HORZ:
        decode_block(r, c, horz);
        if (has_rows) decode_block(r + half, c, horz);
        break;
      case PARTITION_VERT:
        decode_block(r, c, vert);
        if (has_cols) decode_block(r, c + half, vert);
        break;
      case PARTITION_SPLIT:
        decode_partition(r, c, split);
        decode_partition(r, c + half, split);
        decode_partition(r + half, c, split);
        decode_partition(r + half, c + half, split);
        break;
      case PARTITION_HORZ_A:
        decode_block(r, c, split);
        decode_block(r, c + half, split);
        decode_block(r + half, c, horz);
        break;
      case PARTITION_HORZ_B:
        decode_block(r, c, horz);
        decode_block(r + half, c, split);
        decode_block(r + half, c + half, split);
        break;
      case PARTITION_VERT_A:
        decode_block(r, c, split);
        decode_block(r + half, c, split);
        decode_block(r, c + half, vert);
        break;
      case PARTITION_VERT_B:
        decode_block(r, c, vert);
        decode_block(r, c + half, split);
        decode_block(r + half, c + half, split);
        break;
      case PARTITION_HORZ_4: {
        int b4 = block_of(wl, hl - 2);
        for (int i = 0; i < 4; i++) {
          if (i > 0 && r + quarter * i >= h.mi_rows) break;
          decode_block(r + quarter * i, c, b4);
        }
        break;
      }
      case PARTITION_VERT_4: {
        int b4 = block_of(wl - 2, hl);
        for (int i = 0; i < 4; i++) {
          if (i > 0 && c + quarter * i >= h.mi_cols) break;
          decode_block(r, c + quarter * i, b4);
        }
        break;
      }
    }
  }

  // ---------------------------------------------------------- blocks
  void decode_block(int r, int c, int bsize) {
    if (bsize == BLOCK_INVALID) bad("partition");
    mi_row = r;
    mi_col = c;
    mi_size = bsize;
    bw4 = 1 << kBw4Log2[bsize];
    bh4 = 1 << kBh4Log2[bsize];
    if (bh4 == 1 && s.ssy && (mi_row & 1) == 0)
      has_chroma = false;
    else if (bw4 == 1 && s.ssx && (mi_col & 1) == 0)
      has_chroma = false;
    else
      has_chroma = num_planes > 1;
    avail_u = inside(r - 1, c);
    avail_l = inside(r, c - 1);
    avail_u_chroma = avail_u;
    avail_l_chroma = avail_l;
    if (has_chroma) {
      if (s.ssy && bh4 == 1) avail_u_chroma = inside(r - 2, c);
      if (s.ssx && bw4 == 1) avail_l_chroma = inside(r, c - 2);
    } else {
      avail_u_chroma = avail_l_chroma = false;
    }
    if (has_chroma && plane_block(bsize, 1) == BLOCK_INVALID)
      bad("block size for the chroma subsampling");
    mode_info();
    palette_tokens();
    read_block_tx_size();
    if (skip) reset_block_context();
    int pal = -1;
    if (palette_size[0] || palette_size[1]) {
      pal = (int)(palettes.size() / 16);
      palettes.insert(palettes.end(), palette_colors[0], palette_colors[0] + 16);
    }
    palette_blocks[0] += palette_size[0] > 0;
    palette_blocks[1] += palette_size[1] > 0;
    intrabc_blocks += use_intrabc;
    int rows = std::min(bh4, h.mi_rows - r), cols = std::min(bw4, h.mi_cols - c);
    for (int y = 0; y < rows; y++)
      for (int x = 0; x < cols; x++) {
        MiInfo& m = at(r + y, c + x);
        m.size = (uint8_t)bsize;
        m.skip = (uint8_t)skip;
        m.seg = (uint8_t)segment_id;
        m.ymode = (uint8_t)ymode;
        m.uvmode = (uint8_t)uvmode;
        m.tx = (uint8_t)tx_size;
        for (int i = 0; i < 4; i++) m.delta_lf[i] = (int8_t)delta_lf[i];
        m.is_inter = (uint8_t)use_intrabc;
        m.mv[0] = (int16_t)mv[0];
        m.mv[1] = (int16_t)mv[1];
        m.palette_size[0] = (uint8_t)palette_size[0];
        m.palette_size[1] = (uint8_t)palette_size[1];
        m.palette = pal;
      }
    if (use_intrabc) predict_intrabc();
    residual();
  }

  void mode_info() {
    skip = 0;
    if (h.seg_id_pre_skip) intra_segment_id();
    read_skip();
    if (!h.seg_id_pre_skip) intra_segment_id();
    read_cdef();
    read_delta_qindex();
    read_delta_lf();
    read_deltas = false;
    use_filter_intra = 0;
    palette_size[0] = palette_size[1] = 0;
    mv[0] = mv[1] = 0;
    use_intrabc = h.allow_intrabc ? sd.symbol(cdf.intrabc, 2) : 0;
    if (use_intrabc) {
      ymode = uvmode = DC_PRED;
      angle_y = angle_uv = 0;
      cfl_alpha_u = cfl_alpha_v = 0;
      intrabc_info();
      return;
    }
    int above = kIntraModeContext[avail_u ? at(mi_row - 1, mi_col).ymode : DC_PRED];
    int left = kIntraModeContext[avail_l ? at(mi_row, mi_col - 1).ymode : DC_PRED];
    ymode = sd.symbol(cdf.kf_y[above][left], 13);
    angle_y = 0;
    if (mi_size >= BLOCK_8X8 && ymode >= V_PRED && ymode <= D67_PRED)
      angle_y = sd.symbol(cdf.angle_delta[ymode - V_PRED], 7) - 3;
    uvmode = DC_PRED;
    angle_uv = 0;
    cfl_alpha_u = cfl_alpha_v = 0;
    if (has_chroma) {
      int pb = plane_block(mi_size, 1);
      bool cfl_allowed;
      if (lossless && pb == BLOCK_4X4)
        cfl_allowed = true;
      else
        cfl_allowed = !lossless && std::max(bw4, bh4) <= 8;
      if (cfl_allowed)
        uvmode = sd.symbol(cdf.uv_mode[1][ymode], 14);
      else
        uvmode = sd.symbol(cdf.uv_mode[0][ymode], 13);
      if (uvmode == UV_CFL_PRED) read_cfl_alphas();
      if (mi_size >= BLOCK_8X8 && uvmode >= V_PRED && uvmode <= D67_PRED)
        angle_uv = sd.symbol(cdf.angle_delta[uvmode - V_PRED], 7) - 3;
    }
    // BLOCK_4X16 and BLOCK_16X4 come after BLOCK_8X8
    if (h.screen_content && mi_size >= BLOCK_8X8 && bw4 <= 16 && bh4 <= 16)
      palette_mode_info();
    if (s.filter_intra && ymode == DC_PRED && !palette_size[0] && std::max(bw4, bh4) <= 8) {
      use_filter_intra = sd.symbol(cdf.filter_intra[mi_size], 2);
      if (use_filter_intra) filter_intra_mode = sd.symbol(cdf.filter_intra_mode, 5);
    }
  }

  void intra_segment_id() {
    if (!h.seg_enabled) {
      segment_id = 0;
    } else {
      int prev_ul = -1, prev_u = -1, prev_l = -1;
      if (avail_u && avail_l) prev_ul = at(mi_row - 1, mi_col - 1).seg;
      if (avail_u) prev_u = at(mi_row - 1, mi_col).seg;
      if (avail_l) prev_l = at(mi_row, mi_col - 1).seg;
      int ctx;
      if (prev_ul < 0)
        ctx = 0;
      else if (prev_ul == prev_u && prev_ul == prev_l)
        ctx = 2;
      else if (prev_ul == prev_u || prev_ul == prev_l || prev_u == prev_l)
        ctx = 1;
      else
        ctx = 0;
      int pred;
      if (prev_u == -1)
        pred = prev_l == -1 ? 0 : prev_l;
      else if (prev_l == -1)
        pred = prev_u;
      else
        pred = prev_ul == prev_u ? prev_u : prev_l;
      if (skip) {
        segment_id = pred;
      } else {
        int v = sd.symbol(cdf.seg_spatial[ctx], 8);
        int mx = h.last_active_seg_id + 1;
        segment_id = neg_deinterleave(v, pred, mx);
        if (segment_id < 0 || segment_id > h.last_active_seg_id)
          bad("segment id");
      }
    }
    lossless = h.lossless[segment_id];
  }
  static int neg_deinterleave(int diff, int ref, int max) {
    if (!ref) return diff;
    if (ref >= max - 1) return max - diff - 1;
    if (2 * ref < max) {
      if (diff <= 2 * ref) {
        if (diff & 1)
          return ref + ((diff + 1) >> 1);
        else
          return ref - (diff >> 1);
      }
      return diff;
    } else {
      if (diff <= 2 * (max - ref - 1)) {
        if (diff & 1)
          return ref + ((diff + 1) >> 1);
        else
          return ref - (diff >> 1);
      }
      return max - (diff + 1);
    }
  }

  void read_skip() {
    if (h.seg_id_pre_skip && h.seg_enabled && h.feature_enabled[segment_id][6]) {
      skip = 1;
      return;
    }
    int ctx = (avail_u ? at(mi_row - 1, mi_col).skip : 0) +
              (avail_l ? at(mi_row, mi_col - 1).skip : 0);
    skip = sd.symbol(cdf.skip[ctx], 2);
  }

  void read_cdef() {
    if (skip || h.coded_lossless || h.allow_intrabc || !s.cdef) return;
    int r = mi_row & ~15, c = mi_col & ~15;
    int8_t& idx = cdef_idx[(size_t)(r >> 4) * cdef_cols + (c >> 4)];
    if (idx == -1) {
      idx = (int8_t)sd.literal(h.cdef_bits);
      for (int y = r; y < r + bh4; y += 16)
        for (int x = c; x < c + bw4; x += 16)
          if (y < h.mi_rows && x < h.mi_cols)
            cdef_idx[(size_t)(y >> 4) * cdef_cols + (x >> 4)] = idx;
    }
  }

  void read_delta_qindex() {
    int sb_size = s.sb128 ? BLOCK_128X128 : BLOCK_64X64;
    if (mi_size == sb_size && skip) return;
    if (!read_deltas) return;
    int abs_v = sd.symbol(cdf.delta_q, 4);
    if (abs_v == 3) {
      int rem = sd.literal(3) + 1;
      abs_v = sd.literal(rem) + (1 << rem) + 1;
    }
    if (abs_v) {
      int sign = sd.literal(1);
      int reduced = sign ? -abs_v : abs_v;
      current_q = clip3(1, 255, current_q + (reduced << h.delta_q_res));
    }
  }

  void read_delta_lf() {
    int sb_size = s.sb128 ? BLOCK_128X128 : BLOCK_64X64;
    if (mi_size == sb_size && skip) return;
    if (!read_deltas || !h.delta_lf_present) return;
    int count = 1;
    if (h.delta_lf_multi) count = num_planes > 1 ? 4 : 2;
    for (int i = 0; i < count; i++) {
      uint16_t* c = h.delta_lf_multi ? cdf.delta_lf_multi[i] : cdf.delta_lf;
      int abs_v = sd.symbol(c, 4);
      if (abs_v == 3) {
        int n = sd.literal(3) + 1;
        abs_v = sd.literal(n) + (1 << n) + 1;
      }
      if (abs_v) {
        int sign = sd.literal(1);
        int reduced = sign ? -abs_v : abs_v;
        delta_lf[i] = clip3(-63, 63, delta_lf[i] + (reduced << h.delta_lf_res));
      }
    }
  }

  void read_cfl_alphas() {
    int signs = sd.symbol(cdf.cfl_sign, 8);
    int sign_u = (signs + 1) / 3, sign_v = (signs + 1) % 3;
    if (sign_u) {
      int v = sd.symbol(cdf.cfl_alpha[(sign_u - 1) * 3 + sign_v], 16) + 1;
      cfl_alpha_u = sign_u == 1 ? -v : v;
    }
    if (sign_v) {
      int v = sd.symbol(cdf.cfl_alpha[(sign_v - 1) * 3 + sign_u], 16) + 1;
      cfl_alpha_v = sign_v == 1 ? -v : v;
    }
  }

  // ---------------------------------------------------------- palettes
  // the specification's Palette_Color_Hash_Multipliers and
  // Palette_Color_Context (get_palette_color_context)
  static constexpr int kPaletteHashMultipliers[3] = {1, 2, 2};
  static constexpr int kPaletteColorContext[9] = {-1, -1, 0, -1, -1, 4, 3, 2, 1};

  void palette_mode_info() {
    int bsize_ctx = kBw4Log2[mi_size] + kBh4Log2[mi_size] - 2;
    if (ymode == DC_PRED) {
      int ctx = (avail_u && at(mi_row - 1, mi_col).palette_size[0]) +
                (avail_l && at(mi_row, mi_col - 1).palette_size[0]);
      if (sd.symbol(cdf.palette_y_mode[bsize_ctx][ctx], 2)) {
        palette_size[0] = sd.symbol(cdf.palette_y_size[bsize_ctx], 7) + 2;
        read_palette_colors(0);
      }
    }
    if (has_chroma && uvmode == DC_PRED &&
        sd.symbol(cdf.palette_uv_mode[palette_size[0] > 0], 2)) {
      palette_size[1] = sd.symbol(cdf.palette_uv_size[bsize_ctx], 7) + 2;
      read_palette_colors(1);
      // V: delta-coded with wrap-around, or literal
      int n = palette_size[1], bd = s.bit_depth, max_val = 1 << bd;
      uint16_t* v = palette_colors[2];
      if (sd.bit()) {
        int bits = bd - 4 + sd.literal(2);
        v[0] = (uint16_t)sd.literal(bd);
        for (int i = 1; i < n; i++) {
          int delta = sd.literal(bits);
          if (delta && sd.bit()) delta = -delta;
          int val = v[i - 1] + delta;
          if (val < 0) val += max_val;
          if (val >= max_val) val -= max_val;
          v[i] = (uint16_t)clip3(0, max_val - 1, val);
        }
      } else {
        for (int i = 0; i < n; i++) v[i] = (uint16_t)sd.literal(bd);
      }
    }
  }

  // the Y (plane 0) or U (plane 1) palette: colours taken from the
  // neighbours' cache, then one literal and ascending deltas (at least 1
  // for Y), all in ascending order (libaom's read_palette_colors_y/uv)
  void read_palette_colors(int plane) {
    int n = palette_size[plane], bd = s.bit_depth;
    uint16_t cache[16];
    int n_cache = palette_cache(plane, cache);
    uint16_t* c = palette_colors[plane];
    int idx = 0;
    for (int i = 0; i < n_cache && idx < n; i++)
      if (sd.bit()) c[idx++] = cache[i];
    if (idx < n) {
      c[idx++] = (uint16_t)sd.literal(bd);
      if (idx < n) {
        int bits = bd - 3 + sd.literal(2);
        int range = (1 << bd) - c[idx - 1] - (plane == 0);
        for (; idx < n; idx++) {
          int delta = sd.literal(bits) + (plane == 0);
          c[idx] = (uint16_t)std::min(c[idx - 1] + delta, (1 << bd) - 1);
          range -= c[idx] - c[idx - 1];
          bits = std::min(bits, tile_log2(1, range));  // CeilLog2(range)
        }
      }
      std::sort(c, c + n);
    }
  }

  // the above (in the same 64-row superblock row only) and left
  // neighbours' colours of the plane, merged in ascending order without
  // repeats (libaom's av1_get_palette_cache)
  int palette_cache(int plane, uint16_t* cache) {
    const MiInfo* above = avail_u && (mi_row & 15) ? &at(mi_row - 1, mi_col) : nullptr;
    const MiInfo* left = avail_l ? &at(mi_row, mi_col - 1) : nullptr;
    int an = above ? above->palette_size[plane] : 0, ln = left ? left->palette_size[plane] : 0;
    const uint16_t* ac = an ? &palettes[(size_t)above->palette * 16 + plane * 8] : nullptr;
    const uint16_t* lc = ln ? &palettes[(size_t)left->palette * 16 + plane * 8] : nullptr;
    int n = 0;
    auto add = [&](uint16_t v) {
      if (n == 0 || v != cache[n - 1]) cache[n++] = v;
    };
    while (an > 0 && ln > 0) {
      if (*lc < *ac) {
        add(*lc++);
        ln--;
      } else {
        if (*lc == *ac) {
          lc++;
          ln--;
        }
        add(*ac++);
        an--;
      }
    }
    while (an-- > 0) add(*ac++);
    while (ln-- > 0) add(*lc++);
    return n;
  }

  void palette_tokens() {
    int bw = bw4 * 4, bh = bh4 * 4;
    int on_w = std::min(bw, (h.mi_cols - mi_col) * 4);
    int on_h = std::min(bh, (h.mi_rows - mi_row) * 4);
    if (palette_size[0]) read_color_map(0, bw, bh, on_w, on_h);
    if (palette_size[1]) {
      int w = bw >> s.ssx, hh = bh >> s.ssy, ow = on_w >> s.ssx, oh = on_h >> s.ssy;
      if (w < 4) {  // a 4-wide block's chroma spans its left neighbour's
        w += 2;
        ow += 2;
      }
      if (hh < 4) {
        hh += 2;
        oh += 2;
      }
      read_color_map(1, w, hh, ow, oh);
    }
  }

  // the colour indices of the on-screen w x h part in wavefront order,
  // then the last column and row copied past the frame's edge
  void read_color_map(int k, int w, int hh, int on_w, int on_h) {
    uint8_t* m = color_map[k];
    int n = palette_size[k];
    color_map_w[k] = w;
    m[0] = (uint8_t)sd.quniform(n);
    for (int i = 1; i < on_h + on_w - 1; i++)
      for (int j = std::min(i, on_w - 1); j >= std::max(0, i - on_h + 1); j--) {
        uint8_t order[8];
        int ctx = palette_color_context(m, w, i - j, j, n, order);
        uint16_t* c = k ? cdf.palette_uv_color[n - 2][ctx] : cdf.palette_y_color[n - 2][ctx];
        m[(i - j) * w + j] = order[sd.symbol(c, n)];
      }
    for (int i = 0; i < on_h; i++)
      for (int j = on_w; j < w; j++) m[i * w + j] = m[i * w + on_w - 1];
    for (int i = on_h; i < hh; i++) memcpy(m + i * w, m + (on_h - 1) * w, w);
  }

  // libaom's av1_get_palette_color_index_context: the colours ranked by
  // the left, above-left and above neighbours' scores, and the context
  // of the scores
  static int palette_color_context(const uint8_t* m, int stride, int r, int c, int n,
                                   uint8_t* order) {
    int nb[3] = {c > 0 ? m[r * stride + c - 1] : -1,
                 c > 0 && r > 0 ? m[(r - 1) * stride + c - 1] : -1,
                 r > 0 ? m[(r - 1) * stride + c] : -1};
    static const int weights[3] = {2, 1, 2};
    int scores[8] = {0};
    for (int i = 0; i < 3; i++)
      if (nb[i] >= 0) scores[nb[i]] += weights[i];
    for (int i = 0; i < 8; i++) order[i] = (uint8_t)i;
    for (int i = 0; i < 3; i++) {
      int best = scores[i], best_idx = i;
      for (int j = i + 1; j < n; j++)
        if (scores[j] > best) {
          best = scores[j];
          best_idx = j;
        }
      if (best_idx != i) {
        uint8_t best_order = order[best_idx];
        for (int k = best_idx; k > i; k--) {
          scores[k] = scores[k - 1];
          order[k] = order[k - 1];
        }
        scores[i] = best;
        order[i] = best_order;
      }
    }
    int hash = 0;
    for (int i = 0; i < 3; i++) hash += scores[i] * kPaletteHashMultipliers[i];
    return kPaletteColorContext[hash];
  }

  // ---------------------------------------------------------- intra block copy
  struct DvCandidate {
    int row, col, weight;
  };
  DvCandidate dv_stack[8];
  int dv_count = 0;

  // libaom's add_ref_mv_candidate for the one reference of an intra
  // frame: only IntraBC neighbours carry a vector
  void add_dv_candidate(const MiInfo& m, int weight) {
    if (!m.is_inter) return;
    for (int i = 0; i < dv_count; i++)
      if (dv_stack[i].row == m.mv[0] && dv_stack[i].col == m.mv[1]) {
        dv_stack[i].weight += weight;
        return;
      }
    if (dv_count < 8) dv_stack[dv_count++] = {m.mv[0], m.mv[1], weight};
  }
  // libaom's scan_row_mbmi (a row of neighbours above)
  void scan_row(int row_offset, int max_row_offset, int* processed) {
    int end_mi = std::min({bw4, h.mi_cols - mi_col, 16});
    int col_offset = 0;
    if (std::abs(row_offset) > 1) col_offset = (mi_col & 1) && bw4 < 2 ? 0 : 1;
    for (int i = 0; i < end_mi;) {
      const MiInfo& m = at(mi_row + row_offset, mi_col + col_offset + i);
      int n4w = 1 << kBw4Log2[m.size];
      int len = std::min(bw4, n4w);
      if (bw4 >= 16)
        len = std::max(4, len);
      else if (std::abs(row_offset) > 1)
        len = std::max(len, 2);
      int weight = 2;
      if (bw4 >= 2 && bw4 <= n4w) {
        int inc = std::min(-max_row_offset + row_offset + 1, 1 << kBh4Log2[m.size]);
        weight = std::max(weight, inc);
        *processed = inc - row_offset - 1;
      }
      add_dv_candidate(m, len * weight);
      i += len;
    }
  }
  // libaom's scan_col_mbmi (a column of neighbours to the left)
  void scan_col(int col_offset, int max_col_offset, int* processed) {
    int end_mi = std::min({bh4, h.mi_rows - mi_row, 16});
    int row_offset = 0;
    if (std::abs(col_offset) > 1) row_offset = (mi_row & 1) && bh4 < 2 ? 0 : 1;
    for (int i = 0; i < end_mi;) {
      const MiInfo& m = at(mi_row + row_offset + i, mi_col + col_offset);
      int n4h = 1 << kBh4Log2[m.size];
      int len = std::min(bh4, n4h);
      if (bh4 >= 16)
        len = std::max(4, len);
      else if (std::abs(col_offset) > 1)
        len = std::max(len, 2);
      int weight = 2;
      if (bh4 >= 2 && bh4 <= n4h) {
        int inc = std::min(-max_col_offset + col_offset + 1, 1 << kBw4Log2[m.size]);
        weight = std::max(weight, inc);
        *processed = inc - col_offset - 1;
      }
      add_dv_candidate(m, len * weight);
      i += len;
    }
  }
  // libaom's has_top_right
  bool has_top_right() const {
    int bs = std::max(bw4, bh4);
    int sb4 = s.sb128 ? 32 : 16;
    if (bs > 16) return false;
    int mask_row = mi_row & (sb4 - 1), mask_col = mi_col & (sb4 - 1);
    bool has_tr = !((mask_row & bs) && (mask_col & bs));
    while (bs < sb4) {
      if (!(mask_col & bs)) break;
      if ((mask_col & (2 * bs)) && (mask_row & (2 * bs))) {
        has_tr = false;
        break;
      }
      bs <<= 1;
    }
    // the blocks of a vertical partition but the last have a top right,
    // those of a horizontal one but the first have none
    if (bw4 < bh4 && ((mi_col + bw4) & (bh4 - 1))) has_tr = true;
    if (bw4 > bh4 && (mi_row & (bw4 - 1))) has_tr = false;
    if (block_partition == PARTITION_VERT_A && bw4 == bh4 && (mask_row & bs)) has_tr = false;
    return has_tr;
  }
  // libaom's setup_ref_mv_list for the intra frame's one reference: the
  // spatial candidates and their weights, the nearest ranked first; no
  // temporal candidates, and no extension (no neighbour refers to an
  // inter frame)
  void find_dv_stack() {
    dv_count = 0;
    int row_adj = bh4 < 2 && (mi_row & 1), col_adj = bw4 < 2 && (mi_col & 1);
    int max_row_offset = 0, max_col_offset = 0, processed_rows = 0, processed_cols = 0;
    if (avail_u) {
      max_row_offset = (bh4 < 2 ? -4 : -6) + row_adj;
      max_row_offset = clip3(mi_row_start - mi_row, mi_row_end - mi_row - 1, max_row_offset);
    }
    if (avail_l) {
      max_col_offset = (bw4 < 2 ? -4 : -6) + col_adj;
      max_col_offset = clip3(mi_col_start - mi_col, mi_col_end - mi_col - 1, max_col_offset);
    }
    if (std::abs(max_row_offset) >= 1) scan_row(-1, max_row_offset, &processed_rows);
    if (std::abs(max_col_offset) >= 1) scan_col(-1, max_col_offset, &processed_cols);
    if (has_top_right() && inside(mi_row - 1, mi_col + bw4))
      add_dv_candidate(at(mi_row - 1, mi_col + bw4), 4);
    int nearest = dv_count;
    for (int i = 0; i < nearest; i++) dv_stack[i].weight += 640;  // REF_CAT_LEVEL
    if (inside(mi_row - 1, mi_col - 1)) add_dv_candidate(at(mi_row - 1, mi_col - 1), 4);
    for (int idx = 2; idx <= 3; idx++) {
      int row_offset = -(idx << 1) + 1 + row_adj, col_offset = -(idx << 1) + 1 + col_adj;
      int ar = std::abs(row_offset), ac = std::abs(col_offset);
      if (ar <= std::abs(max_row_offset) && ar > processed_rows)
        scan_row(row_offset, max_row_offset, &processed_rows);
      if (ac <= std::abs(max_col_offset) && ac > processed_cols)
        scan_col(col_offset, max_col_offset, &processed_cols);
    }
    // the nearest, then the rest, by weight (libaom's bubble sorts)
    for (int part = 0; part < 2; part++) {
      int lo = part ? nearest : 0;
      for (int len = part ? dv_count : nearest; len > lo;) {
        int last = lo;
        for (int i = lo + 1; i < len; i++)
          if (dv_stack[i - 1].weight < dv_stack[i].weight) {
            std::swap(dv_stack[i - 1], dv_stack[i]);
            last = i;
          }
        len = last;
      }
    }
    // clamp_mv_ref: within the block's size and 16 samples of the frame
    int bw = bw4 * 4, bh = bh4 * 4;
    for (int i = 0; i < dv_count; i++) {
      dv_stack[i].col = clip3(-mi_col * 32 - bw * 8 - 128,
                              (h.mi_cols - bw4 - mi_col) * 32 + bw * 8 + 128, dv_stack[i].col);
      dv_stack[i].row = clip3(-mi_row * 32 - bh * 8 - 128,
                              (h.mi_rows - bh4 - mi_row) * 32 + bh * 8 + 128, dv_stack[i].row);
    }
  }

  int read_dv_component(Cdfs::DvComponent& c) {
    int sign = sd.symbol(c.sign, 2);
    int cls = sd.symbol(c.classes, 11);
    int d = 0, mag = 0;
    if (cls == 0) {
      d = sd.symbol(c.class0, 2);
    } else {
      for (int i = 0; i < cls; i++) d |= sd.symbol(c.bits[i], 2) << i;
      mag = 2 << (cls + 2);
    }
    mag += ((d << 3) | 7) + 1;  // whole samples: no fraction, no high precision
    return sign ? -mag : mag;
  }

  // libaom's read_intrabc_info: the reference vector (nearest, near, or
  // the default one superblock up or left), the vector read against it,
  // and its check
  void intrabc_info() {
    find_dv_stack();
    int ref[2] = {0, 0};
    for (int k = 0; k < 2 && k < dv_count; k++) {
      // lower_mv_precision without high precision: odd values toward 0
      int v[2] = {dv_stack[k].row, dv_stack[k].col};
      for (int& x : v)
        if (x & 1) x += x > 0 ? -1 : 1;
      if (v[0] || v[1]) {
        ref[0] = v[0];
        ref[1] = v[1];
        break;
      }
    }
    if (!ref[0] && !ref[1]) {
      int sb4 = s.sb128 ? 32 : 16;
      if (mi_row - sb4 < mi_row_start) {
        ref[1] = -(4 * sb4 + 256) * 8;  // INTRABC_DELAY_PIXELS
      } else {
        ref[0] = -(4 * sb4) * 8;
      }
    }
    bool valid = !(ref[0] & 7) && !(ref[1] & 7);
    for (int& x : ref) x = (x >> 3) * 8;
    int joint = sd.symbol(cdf.dv.joints, 4);
    mv[0] = ref[0] + (joint == 2 || joint == 3 ? read_dv_component(cdf.dv.comps[0]) : 0);
    mv[1] = ref[1] + (joint == 1 || joint == 3 ? read_dv_component(cdf.dv.comps[1]) : 0);
    for (int& x : mv) x = (x >> 3) * 8;
    if (!valid || !dv_valid()) bad("intra block copy vector");
  }

  // libaom's is_mv_valid and av1_is_dv_valid: the source lies in the tile,
  // in superblocks decoded at least 256 samples before, above a wavefront
  bool dv_valid() const {
    const int lim = 1 << 14;
    if (mv[0] <= -lim || mv[0] >= lim || mv[1] <= -lim || mv[1] >= lim) return false;
    if ((mv[0] & 7) || (mv[1] & 7)) return false;
    int src_top = mi_row * 32 + mv[0], tile_top = mi_row_start * 32;
    int src_left = mi_col * 32 + mv[1], tile_left = mi_col_start * 32;
    int src_bottom = (mi_row + bh4) * 32 + mv[0], src_right = (mi_col + bw4) * 32 + mv[1];
    if (src_top < tile_top || src_left < tile_left) return false;
    if (src_bottom > mi_row_end * 32 || src_right > mi_col_end * 32) return false;
    if (has_chroma) {  // a sub-8x8 block's chroma starts 4 samples before
      if (bw4 < 2 && s.ssx && src_left < tile_left + 32) return false;
      if (bh4 < 2 && s.ssy && src_top < tile_top + 32) return false;
    }
    int sb_log2 = s.sb128 ? 5 : 4, sb_size = 4 << sb_log2;
    int active_sb_row = mi_row >> sb_log2, active_sb64_col = (mi_col * 4) >> 6;
    int src_sb_row = ((src_bottom >> 3) - 1) / sb_size;
    int src_sb64_col = ((src_right >> 3) - 1) >> 6;
    int sb64_per_row = ((mi_col_end - mi_col_start - 1) >> 4) + 1;
    int active_sb64 = active_sb_row * sb64_per_row + active_sb64_col;
    int src_sb64 = src_sb_row * sb64_per_row + src_sb64_col;
    const int delay = 4;  // INTRABC_DELAY_SB64
    if (src_sb64 >= active_sb64 - delay) return false;
    int wf_offset = (1 + delay + (sb_size > 64)) * (active_sb_row - src_sb_row);
    if (src_sb_row > active_sb_row || src_sb64_col >= active_sb64_col - delay + wf_offset)
      return false;
    return true;
  }

  // the block copied from the frame before its loop filters: whole
  // samples in luma, chroma at half samples where subsampled (libaom's
  // bilinear intrabc convolutions); a 4-sample side's subsampled chroma
  // covers its left or upper neighbour's too
  void predict_intrabc() {
    static thread_local uint16_t pred[128 * 128];
    for (int p = 0; p < 1 + (has_chroma ? 2 : 0); p++) {
      int sx = p ? s.ssx : 0, sy = p ? s.ssy : 0;
      int pb = plane_block(mi_size, p);
      int w = 4 << kBw4Log2[pb], hh = 4 << kBh4Log2[pb];
      int x = ((mi_col - (bw4 == 1 && sx)) * 4) >> sx, y = ((mi_row - (bh4 == 1 && sy)) * 4) >> sy;
      int pos_x = (x << 4) + mv[1] * (2 >> sx), pos_y = (y << 4) + mv[0] * (2 >> sy);
      int x0 = pos_x >> 4, y0 = pos_y >> 4;
      bool fx = pos_x & 15, fy = pos_y & 15;
      Plane& P = planes[p];
      for (int i = 0; i < hh; i++) {
        const uint16_t* a = P.row(y0 + i) + x0;
        const uint16_t* b = fy ? P.row(y0 + i + 1) + x0 : a;
        uint16_t* o = pred + i * w;
        for (int j = 0; j < w; j++) {
          if (fx && fy)
            o[j] = (uint16_t)((a[j] + a[j + 1] + b[j] + b[j + 1] + 2) >> 2);
          else if (fx)
            o[j] = (uint16_t)((a[j] + a[j + 1] + 1) >> 1);
          else
            o[j] = (uint16_t)((a[j] + b[j] + 1) >> 1);
        }
      }
      for (int i = 0; i < hh; i++) memcpy(P.row(y + i) + x, pred + i * w, 2 * (size_t)w);
    }
  }

  // an IntraBC block that is not skipped reads its variable transform
  // tree, each transform block of the largest size split up to twice;
  // every other block one size (the tree's sizes in inter_tx either way)
  void read_block_tx_size() {
    if (use_intrabc && h.tx_mode_select && mi_size > BLOCK_4X4 && !skip && !lossless) {
      int max_tx = max_tx_rect(mi_size);
      int w4 = 1 << (kTxWLog2[max_tx] - 2), h4 = 1 << (kTxHLog2[max_tx] - 2);
      for (int r = 0; r < bh4; r += h4)
        for (int c = 0; c < bw4; c += w4) read_var_tx_size(mi_row + r, mi_col + c, max_tx, 0);
      return;
    }
    read_tx_size();
    set_inter_tx(mi_row, mi_col, bw4, bh4, tx_size);
  }
  void set_inter_tx(int r, int c, int w4, int h4, int txs) {
    for (int y = r; y < std::min(r + h4, h.mi_rows); y++)
      for (int x = c; x < std::min(c + w4, h.mi_cols); x++)
        inter_tx[(size_t)y * h.mi_cols + x] = (uint8_t)txs;
  }
  // libaom's read_tx_size_vartx (a split into 4x4 sets the whole block)
  void read_var_tx_size(int r, int c, int txs, int depth) {
    if (r >= h.mi_rows || c >= h.mi_cols) return;
    int w4 = 1 << (kTxWLog2[txs] - 2), h4 = 1 << (kTxHLog2[txs] - 2);
    int split = 0;
    if (txs != TX_4X4 && depth < 2)
      split = sd.symbol(cdf.txfm_split[txfm_split_ctx(r, c, txs)], 2);
    int sub = kSplitTx[txs];
    if (split && sub != TX_4X4) {
      int sw = 1 << (kTxWLog2[sub] - 2), sh = 1 << (kTxHLog2[sub] - 2);
      for (int y = 0; y < h4; y += sh)
        for (int x = 0; x < w4; x += sw) read_var_tx_size(r + y, c + x, sub, depth + 1);
      return;
    }
    tx_size = split ? TX_4X4 : txs;
    set_inter_tx(r, c, w4, h4, tx_size);
  }
  // the transform widths above and heights left of (r, c) against txs'
  // (a skipped IntraBC neighbour's block size, 64 off the tile), and the
  // block's largest square size (libaom's txfm_partition_context)
  int txfm_split_ctx(int r, int c, int txs) {
    auto size_at = [&](int y, int x) { return (int)inter_tx[(size_t)y * h.mi_cols + x]; };
    int above_w = 64, left_h = 64;
    if (r > mi_row || avail_u) {
      const MiInfo& a = at(r - 1, c);
      above_w = r == mi_row && a.skip && a.is_inter ? 4 << kBw4Log2[a.size]
                                                    : 1 << kTxWLog2[size_at(r - 1, c)];
    }
    if (c > mi_col || avail_l) {
      const MiInfo& l = at(r, c - 1);
      left_h = c == mi_col && l.skip && l.is_inter ? 4 << kBh4Log2[l.size]
                                                   : 1 << kTxHLog2[size_at(r, c - 1)];
    }
    int above = above_w < (1 << kTxWLog2[txs]), left = left_h < (1 << kTxHLog2[txs]);
    int l2 = std::min(std::max(kBw4Log2[mi_size], kBh4Log2[mi_size]) + 2, 6);
    int max_sq = tx_of(l2, l2);
    int cat = (tx_sqr_up(txs) != max_sq && max_sq > TX_8X8) + (TX_64X64 - max_sq) * 2;
    return cat * 3 + above + left;
  }

  void read_tx_size() {
    if (lossless) {
      tx_size = TX_4X4;
      return;
    }
    int max_rect = max_tx_rect(mi_size);
    tx_size = max_rect;
    if (mi_size > BLOCK_4X4 && h.tx_mode_select && !(use_intrabc && skip)) {
      int depth_max = 0, t = max_rect;
      while (depth_max < 2 && t != TX_4X4) {
        depth_max++;
        t = kSplitTx[t];
      }
      int cat = -1;
      t = max_rect;
      while (t != TX_4X4) {
        cat++;
        t = kSplitTx[t];
      }
      int max_w = 1 << kTxWLog2[max_rect], max_h = 1 << kTxHLog2[max_rect];
      // an IntraBC neighbour counts its block size (libaom's
      // get_tx_size_context)
      int above_w = 0, left_h = 0;
      if (avail_u) {
        const MiInfo& m = at(mi_row - 1, mi_col);
        above_w = m.is_inter ? 4 << kBw4Log2[m.size] : 1 << kTxWLog2[m.tx];
      }
      if (avail_l) {
        const MiInfo& m = at(mi_row, mi_col - 1);
        left_h = m.is_inter ? 4 << kBh4Log2[m.size] : 1 << kTxHLog2[m.tx];
      }
      int ctx = (above_w >= max_w) + (left_h >= max_h);
      int depth = sd.symbol(cdf.tx_size[cat][ctx], depth_max + 1);
      for (int i = 0; i < depth; i++) tx_size = kSplitTx[tx_size];
    }
  }

  void reset_block_context() {
    for (int p = 0; p < (has_chroma ? 3 : 1); p++) {
      int sx = p ? s.ssx : 0, sy = p ? s.ssy : 0;
      for (int i = mi_col >> sx; i < ((mi_col + bw4 - 1) >> sx) + 1; i++)
        above_level[p][i] = above_dc[p][i] = 0;
      for (int i = mi_row >> sy; i < ((mi_row + bh4 - 1) >> sy) + 1; i++)
        left_level[p][i] = left_dc[p][i] = 0;
    }
  }

  // ---------------------------------------------------------- residual
  int plane_tx(int plane) const {
    if (lossless) return TX_4X4;
    return plane ? uv_tx(mi_size) : tx_size;
  }

  // each 64x64 chunk of the block, its planes in turn (an IntraBC block's
  // luma by its transform tree)
  void residual() {
    int width_chunks = std::max(1, bw4 >> 4), height_chunks = std::max(1, bh4 >> 4);
    for (int cy = 0; cy < height_chunks; cy++)
      for (int cx = 0; cx < width_chunks; cx++) {
        for (int p = 0; p < 1 + (has_chroma ? 2 : 0); p++) {
          if (use_intrabc && !lossless && p == 0) {
            int max_tx = max_tx_rect(mi_size);
            int w4 = 1 << (kTxWLog2[max_tx] - 2), h4 = 1 << (kTxHLog2[max_tx] - 2);
            for (int y = 0; y < std::min(bh4, 16); y += h4)
              for (int x = 0; x < std::min(bw4, 16); x += w4)
                transform_tree(mi_row + (cy << 4) + y, mi_col + (cx << 4) + x, max_tx);
            continue;
          }
          int txs = plane_tx(p);
          int step_x = (1 << kTxWLog2[txs]) >> 2, step_y = (1 << kTxHLog2[txs]) >> 2;
          int pb = plane_block(mi_size, p);
          int n4w = 1 << kBw4Log2[pb], n4h = 1 << kBh4Log2[pb];
          int sx = p ? s.ssx : 0, sy = p ? s.ssy : 0;
          int base_x = (mi_col >> sx) * 4, base_y = (mi_row >> sy) * 4;
          for (int y = 0; y < std::min(n4h, 16 >> sy); y += step_y)
            for (int x = 0; x < std::min(n4w, 16 >> sx); x += step_x)
              transform_block(p, base_x, base_y, txs, x + ((cx << 4) >> sx),
                              y + ((cy << 4) >> sy));
        }
      }
  }

  void transform_tree(int r, int c, int txs) {
    if (r >= h.mi_rows || c >= h.mi_cols) return;
    if (inter_tx[(size_t)r * h.mi_cols + c] == txs) {
      transform_block(0, mi_col * 4, mi_row * 4, txs, c - mi_col, r - mi_row);
      return;
    }
    int sub = kSplitTx[txs];
    int w4 = 1 << (kTxWLog2[txs] - 2), h4 = 1 << (kTxHLog2[txs] - 2);
    int sw = 1 << (kTxWLog2[sub] - 2), sh = 1 << (kTxHLog2[sub] - 2);
    for (int y = 0; y < h4; y += sh)
      for (int x = 0; x < w4; x += sw) transform_tree(r + y, c + x, sub);
  }

  void transform_block(int plane, int base_x, int base_y, int txs, int x, int y) {
    int start_x = base_x + 4 * x, start_y = base_y + 4 * y;
    int sx = plane ? s.ssx : 0, sy = plane ? s.ssy : 0;
    int row = (start_y << sy) >> 2, col = (start_x << sx) >> 2;
    int sb_mask = s.sb128 ? 31 : 15;
    int sub_row = row & sb_mask, sub_col = col & sb_mask;
    int step_x = (1 << kTxWLog2[txs]) >> 2, step_y = (1 << kTxHLog2[txs]) >> 2;
    int max_x = (h.mi_cols * 4) >> sx, max_y = (h.mi_rows * 4) >> sy;
    if (start_x >= max_x || start_y >= max_y) return;
    int dr = (sub_row >> sy), dc = (sub_col >> sx);
    if (!use_intrabc) {
      if (palette_size[plane > 0]) {
        predict_palette(plane, start_x, start_y, x, y, txs);
      } else {
        bool is_cfl = plane > 0 && uvmode == UV_CFL_PRED;
        int mode = plane == 0 ? ymode : is_cfl ? DC_PRED : uvmode;
        bool have_left = (plane == 0 ? avail_l : avail_l_chroma) || x > 0;
        bool have_above = (plane == 0 ? avail_u : avail_u_chroma) || y > 0;
        bool have_ar = decoded[plane][dr - 1 + 1][dc + step_x + 1];
        bool have_bl = decoded[plane][dr + step_y + 1][dc - 1 + 1];
        predict_intra(plane, start_x, start_y, have_left, have_above, have_ar, have_bl, mode,
                      kTxWLog2[txs], kTxHLog2[txs]);
        if (is_cfl) predict_cfl(plane, start_x, start_y, txs);
      }
      if (plane == 0) {
        max_luma_w = start_x + step_x * 4;
        max_luma_h = start_y + step_y * 4;
      }
    }
    if (!skip) {
      int eob = coeffs(plane, start_x, start_y, txs);
      if (eob > 0) reconstruct(plane, start_x, start_y, txs);
    }
    for (int i = 0; i < step_y; i++)
      for (int j = 0; j < step_x; j++) {
        int ly = (row >> sy) + i, lx = (col >> sx) + j;
        if (ly < planes[plane].h / 4 && lx < lf_stride[plane])
          lf_tx[plane][(size_t)ly * lf_stride[plane] + lx] = (uint8_t)txs;
        if (dr + i + 1 < 35 && dc + j + 1 < 35) decoded[plane][dr + i + 1][dc + j + 1] = 1;
      }
  }

  // the colours of the block's index map at the transform block (x, y:
  // its offset in 4-sample units)
  void predict_palette(int plane, int start_x, int start_y, int x, int y, int txs) {
    const uint16_t* pal = palette_colors[plane];
    const uint8_t* m = color_map[plane > 0];
    int stride = color_map_w[plane > 0];
    for (int i = 0; i < (1 << kTxHLog2[txs]); i++) {
      const uint8_t* row = m + (size_t)(y * 4 + i) * stride + x * 4;
      uint16_t* dst = planes[plane].row(start_y + i) + start_x;
      for (int j = 0; j < (1 << kTxWLog2[txs]); j++) dst[j] = pal[row[j]];
    }
  }

  // ---------------------------------------------------------- coefficients
  int plane_tx_type;

  int compute_tx_type(int plane, int txs, int x4, int y4) {
    if (lossless || tx_sqr_up(txs) > TX_32X32) return DCT_DCT;
    int stride = planes[0].w >> 2;
    if (plane == 0) return tx_types[(size_t)y4 * stride + x4];
    // chroma: the co-located luma type in an IntraBC block, else the type
    // of the mode; DCT_DCT where that type is not in the set of txs
    int t = kModeToTxType[uvmode];
    if (use_intrabc) {
      int sx = s.ssx, sy = s.ssy;
      t = tx_types[(size_t)std::max(mi_row, y4 << sy) * stride + std::max(mi_col, x4 << sx)];
    }
    return kExtTxUsed[tx_set(txs)][t] ? t : DCT_DCT;
  }
  // libaom's av1_get_ext_tx_set_type
  int tx_set(int txs) const {
    bool inter = use_intrabc;
    if (tx_sqr_up(txs) > TX_32X32) return SET_DCTONLY;
    if (tx_sqr_up(txs) == TX_32X32) return inter ? SET_DCT_IDTX : SET_DCTONLY;
    if (h.reduced_tx_set) return inter ? SET_DCT_IDTX : SET_DTT4_IDTX;
    if (tx_sqr(txs) == TX_16X16) return inter ? SET_DTT9_IDTX_1DDCT : SET_DTT4_IDTX;
    return inter ? SET_ALL16 : SET_DTT4_IDTX_1DDCT;
  }

  void read_tx_type(int txs, int x4, int y4) {
    int set = tx_set(txs);
    int type = DCT_DCT;
    int q = h.seg_enabled ? qindex(true, segment_id) : h.base_q_idx;
    if (set != SET_DCTONLY && q > 0) {
      int sq = tx_sqr(txs), eset = kTxSetIndex[use_intrabc][set], n = kTxSetTypes[set];
      if (use_intrabc) {
        type = kExtTxInv[set][sd.symbol(cdf.inter_ext_tx[eset][sq], n)];
      } else {
        int dir = use_filter_intra ? kFilterIntraModeToDir[filter_intra_mode] : ymode;
        type = kExtTxInv[set][sd.symbol(cdf.intra_ext_tx[eset][sq][dir], n)];
      }
    }
    int w4 = 1 << (kTxWLog2[txs] - 2), h4 = 1 << (kTxHLog2[txs] - 2);
    int stride = planes[0].w >> 2;
    for (int j = 0; j < h4; j++)
      for (int i = 0; i < w4; i++) tx_types[(size_t)(y4 + j) * stride + x4 + i] = (uint8_t)type;
  }

  int coeffs(int plane, int start_x, int start_y, int txs) {
    int x4 = start_x >> 2, y4 = start_y >> 2;
    int w4 = 1 << (kTxWLog2[txs] - 2), h4 = 1 << (kTxHLog2[txs] - 2);
    int ptype = plane > 0;
    int a_txs = adjusted_tx(txs);
    int txs_ctx = (tx_sqr(txs) + tx_sqr_up(txs) + 1) >> 1;
    int sx = plane ? s.ssx : 0, sy = plane ? s.ssy : 0;
    // contexts of the neighbours (libaom's get_txb_ctx)
    uint8_t* al = &above_level[plane][x4];
    uint8_t* ad = &above_dc[plane][x4];
    uint8_t* ll = &left_level[plane][y4];
    uint8_t* ld = &left_dc[plane][y4];
    int dc_sum = 0;
    for (int k = 0; k < w4; k++) dc_sum += ad[k] == 1 ? -1 : ad[k] == 2 ? 1 : 0;
    for (int k = 0; k < h4; k++) dc_sum += ld[k] == 1 ? -1 : ld[k] == 2 ? 1 : 0;
    int dc_ctx = dc_sum < 0 ? 1 : dc_sum > 0 ? 2 : 0;
    int skip_ctx;
    int pb = plane_block(mi_size, plane);
    if (plane == 0) {
      int bw = 1 << (kBw4Log2[pb] + 2), bh = 1 << (kBh4Log2[pb] + 2);
      if (bw == (1 << kTxWLog2[txs]) && bh == (1 << kTxHLog2[txs])) {
        skip_ctx = 0;
      } else {
        static const uint8_t ctxs[5][5] = {{1, 2, 2, 2, 3}, {2, 4, 4, 4, 5},
                                           {2, 4, 4, 4, 5}, {2, 4, 4, 4, 5},
                                           {3, 5, 5, 5, 6}};
        int top = 0, left = 0;
        for (int k = 0; k < w4; k++) top = std::max(top, (int)al[k]);
        for (int k = 0; k < h4; k++) left = std::max(left, (int)ll[k]);
        skip_ctx = ctxs[std::min(top, 4)][std::min(left, 4)];
      }
    } else {
      int above = 0, left = 0;
      for (int k = 0; k < w4; k++) above |= al[k] | ad[k];
      for (int k = 0; k < h4; k++) left |= ll[k] | ld[k];
      int ctx_base = (above != 0) + (left != 0);
      int blk_pels = kBw4Log2[pb] + kBh4Log2[pb];
      int tx_pels = kTxWLog2[txs] + kTxHLog2[txs] - 4;
      skip_ctx = ctx_base + (blk_pels > tx_pels ? 10 : 7);
    }
    int all_zero = sd.symbol(cdf.txb_skip[txs_ctx][skip_ctx], 2);
    int eob = 0, cul_level = 0, dc_category = 0;
    if (all_zero) {
      if (plane == 0) {
        int stride = planes[0].w >> 2;
        for (int j = 0; j < h4; j++)
          for (int i = 0; i < w4; i++) tx_types[(size_t)(y4 + j) * stride + x4 + i] = DCT_DCT;
      }
    } else {
      if (plane == 0) read_tx_type(txs, x4, y4);
      plane_tx_type = compute_tx_type(plane, txs, x4, y4);
      int cls = tx_class(plane_tx_type);
      const uint16_t* scan = scan_for(txs, plane_tx_type);
      int bwl = kTxWLog2[a_txs], bhl = kTxHLog2[a_txs];
      int tw = 1 << bwl, th = 1 << bhl;
      int eob_multisize = std::min<int>(kTxWLog2[txs], 5) + std::min<int>(kTxHLog2[txs], 5) - 4;
      int ctx = cls == TX_CLASS_2D ? 0 : 1;
      int eob_pt;
      switch (eob_multisize) {
        case 0: eob_pt = sd.symbol(cdf.eob16[ptype][ctx], 5); break;
        case 1: eob_pt = sd.symbol(cdf.eob32[ptype][ctx], 6); break;
        case 2: eob_pt = sd.symbol(cdf.eob64[ptype][ctx], 7); break;
        case 3: eob_pt = sd.symbol(cdf.eob128[ptype][ctx], 8); break;
        case 4: eob_pt = sd.symbol(cdf.eob256[ptype][ctx], 9); break;
        case 5: eob_pt = sd.symbol(cdf.eob512[ptype][ctx], 10); break;
        default: eob_pt = sd.symbol(cdf.eob1024[ptype][ctx], 11); break;
      }
      eob_pt += 1;
      static const int group_start[12] = {0, 1, 2, 3, 5, 9, 17, 33, 65, 129, 257, 513};
      static const int offset_bits[12] = {0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9};
      int extra = 0;
      int ob = offset_bits[eob_pt];
      if (ob > 0) {
        if (sd.symbol(cdf.eob_extra[txs_ctx][ptype][eob_pt - 3], 2)) extra += 1 << (ob - 1);
        for (int i = 1; i < ob; i++)
          if (sd.bit()) extra += 1 << (ob - 1 - i);
      }
      eob = group_start[eob_pt] + extra;
      // levels, padded: levels[(row) * stride + col]
      const int ls = tw + 4;
      uint8_t levels[(32 + 4) * (32 + 4)];
      memset(levels, 0, sizeof(levels));
      auto lv = [&](int r, int c) -> uint8_t& { return levels[r * ls + c]; };
      for (int c = eob - 1; c >= 0; c--) {
        int pos = scan[c];
        int r = pos >> bwl, cc = pos & (tw - 1);
        int level;
        if (c == eob - 1) {
          int cctx = c == 0 ? 0 : c <= (th * tw) / 8 ? 1 : c <= (th * tw) / 4 ? 2 : 3;
          level = sd.symbol(cdf.base_eob[txs_ctx][ptype][cctx], 3) + 1;
        } else {
          int mag = 0;
          if (cls == TX_CLASS_2D) {
            mag = std::min<int>(lv(r, cc + 1), 3) + std::min<int>(lv(r + 1, cc), 3) +
                  std::min<int>(lv(r + 1, cc + 1), 3) + std::min<int>(lv(r, cc + 2), 3) +
                  std::min<int>(lv(r + 2, cc), 3);
          } else if (cls == TX_CLASS_VERT) {
            mag = std::min<int>(lv(r, cc + 1), 3) + std::min<int>(lv(r + 1, cc), 3) +
                  std::min<int>(lv(r + 2, cc), 3) + std::min<int>(lv(r + 3, cc), 3) +
                  std::min<int>(lv(r + 4, cc), 3);
          } else {
            mag = std::min<int>(lv(r, cc + 1), 3) + std::min<int>(lv(r + 1, cc), 3) +
                  std::min<int>(lv(r, cc + 2), 3) + std::min<int>(lv(r, cc + 3), 3) +
                  std::min<int>(lv(r, cc + 4), 3);
          }
          int cctx = std::min((mag + 1) >> 1, 4);
          if (cls == TX_CLASS_2D) {
            if (c == 0) {
              cctx = 0;
            } else if (kTxWLog2[txs] < kTxHLog2[txs] && r < 2) {
              cctx += 11;
            } else if (kTxWLog2[txs] > kTxHLog2[txs] && cc < 2) {
              cctx += 16;
            } else if (r + cc < 2) {
              cctx += 1;
            } else if (r + cc < 4) {
              cctx += 6;
            } else {
              cctx += 21;
            }
          } else {
            int idx = cls == TX_CLASS_VERT ? r : cc;
            cctx += idx == 0 ? 26 : idx == 1 ? 31 : 36;
          }
          level = sd.symbol(cdf.base[txs_ctx][ptype][cctx], 4);
        }
        if (level > 2) {
          int mag = 0, bctx;
          mag = lv(r, cc + 1) + lv(r + 1, cc);
          if (cls == TX_CLASS_2D)
            mag += lv(r + 1, cc + 1);
          else if (cls == TX_CLASS_HORIZ)
            mag += lv(r, cc + 2);
          else
            mag += lv(r + 2, cc);
          mag = std::min((mag + 1) >> 1, 6);
          if (c == eob - 1) {
            // libaom's get_br_ctx_eob: no neighbour is coded yet
            if (c == 0)
              bctx = 0;
            else if ((cls == TX_CLASS_2D && r < 2 && cc < 2) ||
                     (cls == TX_CLASS_HORIZ && cc == 0) || (cls == TX_CLASS_VERT && r == 0))
              bctx = 7;
            else
              bctx = 14;
          } else if (pos == 0) {
            bctx = mag;
          } else if ((cls == TX_CLASS_2D && r < 2 && cc < 2) ||
                     (cls == TX_CLASS_HORIZ && cc == 0) || (cls == TX_CLASS_VERT && r == 0)) {
            bctx = mag + 7;
          } else {
            bctx = mag + 14;
          }
          for (int idx = 0; idx < 12; idx += 3) {
            int k = sd.symbol(cdf.br[std::min(txs_ctx, (int)TX_32X32)][ptype][bctx], 4);
            level += k;
            if (k < 3) break;
          }
        }
        lv(r, cc) = (uint8_t)level;
      }
      // signs, Golomb, dequantisation
      int seg_q = qindex(false, segment_id);
      int bd_idx = s.bit_depth == 8 ? 0 : s.bit_depth == 10 ? 1 : 2;
      int dc_delta = plane == 0 ? h.dq_y_dc : plane == 1 ? h.dq_u_dc : h.dq_v_dc;
      int ac_delta = plane == 0 ? 0 : plane == 1 ? h.dq_u_ac : h.dq_v_ac;
      int dc_q = kDcQ[bd_idx][clip3(0, 255, seg_q + dc_delta)];
      int ac_q = kAcQ[bd_idx][clip3(0, 255, seg_q + ac_delta)];
      int qm_level = h.seg_qm_level[plane][segment_id];
      const uint8_t* qm = nullptr;
      if (qm_level < 15 && !lossless && plane_tx_type < IDTX)
        qm = kIqm[qm_level][plane > 0] + qm_offset(a_txs);
      int pels = (1 << kTxWLog2[txs]) * (1 << kTxHLog2[txs]);
      int dq_shift = (pels > 256) + (pels > 1024);
      int64_t max_v = ((int64_t)1 << (7 + s.bit_depth)) - 1, min_v = -((int64_t)1 << (7 + s.bit_depth));
      memset(dequant, 0, sizeof(int32_t) * tw * th);
      int dc_val = 0;
      for (int c = 0; c < eob; c++) {
        int pos = scan[c];
        int r = pos >> bwl, cc = pos & (tw - 1);
        int level = lv(r, cc);
        if (!level) continue;
        int sign;
        if (c == 0)
          sign = sd.symbol(cdf.dc_sign[ptype][dc_ctx], 2);
        else
          sign = sd.bit();
        if (level >= 15) level += sd.golomb();
        if (c == 0) dc_val = sign ? -level : level;
        level &= 0xFFFFF;
        cul_level += level;
        int dqv = pos == 0 ? dc_q : ac_q;
        if (qm) dqv = (qm[cc * th + r] * dqv + 16) >> 5;
        int64_t dq = ((int64_t)level * dqv) & 0xFFFFFF;
        dq >>= dq_shift;
        if (sign) dq = -dq;
        dequant[pos] = (int32_t)clip3(min_v, max_v, dq);
      }
      cul_level = std::min(63, cul_level);
      dc_category = dc_val < 0 ? 1 : dc_val > 0 ? 2 : 0;
    }
    // libaom's av1_set_entropy_contexts: units past the frame's edge read 0
    int max_x4 = ((h.mi_cols * 4) >> sx) >> 2, max_y4 = ((h.mi_rows * 4) >> sy) >> 2;
    int blocks_w = std::min(w4, std::max(0, max_x4 - x4));
    int blocks_h = std::min(h4, std::max(0, max_y4 - y4));
    for (int i = 0; i < w4; i++) {
      al[i] = (uint8_t)(i < blocks_w ? cul_level : 0);
      ad[i] = (uint8_t)(i < blocks_w ? dc_category : 0);
    }
    for (int i = 0; i < h4; i++) {
      ll[i] = (uint8_t)(i < blocks_h ? cul_level : 0);
      ld[i] = (uint8_t)(i < blocks_h ? dc_category : 0);
    }
    return eob;
  }

  // ---------------------------------------------------------- prediction
  int pixel_max() const { return (1 << s.bit_depth) - 1; }

  bool is_smooth_at(int row, int col, int plane) {
    const MiInfo& m = at(row, col);
    int mode = plane == 0 ? m.ymode : m.uvmode;
    return mode == SMOOTH_PRED || mode == SMOOTH_V_PRED || mode == SMOOTH_H_PRED;
  }
  int filter_type(int plane) {
    bool above_smooth = false, left_smooth = false;
    if (plane == 0 ? avail_u : avail_u_chroma) {
      int r = mi_row - 1, c = mi_col;
      if (plane > 0) {
        if (s.ssx && !(mi_col & 1)) c++;
        if (s.ssy && (mi_row & 1)) r--;
      }
      above_smooth = is_smooth_at(r, c, plane);
    }
    if (plane == 0 ? avail_l : avail_l_chroma) {
      int r = mi_row, c = mi_col - 1;
      if (plane > 0) {
        if (s.ssx && (mi_col & 1)) c--;
        if (s.ssy && !(mi_row & 1)) r++;
      }
      left_smooth = is_smooth_at(r, c, plane);
    }
    return above_smooth || left_smooth;
  }
  static int edge_strength(int w, int h, int type, int delta) {
    int d = std::abs(delta), blk = w + h, st = 0;
    if (type == 0) {
      if (blk <= 8) {
        if (d >= 56) st = 1;
      } else if (blk <= 12) {
        if (d >= 40) st = 1;
      } else if (blk <= 16) {
        if (d >= 40) st = 1;
      } else if (blk <= 24) {
        if (d >= 8) st = 1;
        if (d >= 16) st = 2;
        if (d >= 32) st = 3;
      } else if (blk <= 32) {
        if (d >= 1) st = 1;
        if (d >= 4) st = 2;
        if (d >= 32) st = 3;
      } else {
        if (d >= 1) st = 3;
      }
    } else {
      if (blk <= 8) {
        if (d >= 40) st = 1;
        if (d >= 64) st = 2;
      } else if (blk <= 16) {
        if (d >= 20) st = 1;
        if (d >= 48) st = 2;
      } else if (blk <= 24) {
        if (d >= 4) st = 3;
      } else {
        if (d >= 1) st = 3;
      }
    }
    return st;
  }
  static bool use_upsample(int w, int h, int type, int delta) {
    int d = std::abs(delta), blk = w + h;
    if (d <= 0 || d >= 40) return false;
    return type ? blk <= 8 : blk <= 16;
  }
  // filters buf[0 .. sz-2] (buf[-1], the corner, is read, not written)
  static void edge_filter(int* buf, int sz, int strength) {
    if (!strength) return;
    static const int kernel[3][5] = {{0, 4, 8, 4, 0}, {0, 5, 6, 5, 0}, {2, 4, 4, 4, 2}};
    int edge[160];
    for (int i = 0; i < sz; i++) edge[i] = buf[i - 1];
    for (int i = 1; i < sz; i++) {
      int sum = 0;
      for (int j = 0; j < 5; j++) {
        int k = clip3(0, sz - 1, i - 2 + j);
        sum += kernel[strength - 1][j] * edge[k];
      }
      buf[i - 1] = (sum + 8) >> 4;
    }
  }
  void edge_upsample(int* buf, int num_px) {
    int dup[80];
    dup[0] = buf[-1];
    for (int i = -1; i < num_px; i++) dup[i + 2] = buf[i];
    dup[num_px + 2] = buf[num_px - 1];
    buf[-2] = dup[0];
    int mx = pixel_max();
    for (int i = 0; i < num_px; i++) {
      int sum = -dup[i] + 9 * dup[i + 1] + 9 * dup[i + 2] - dup[i + 3];
      sum = clip3(0, mx, round2(sum, 4));
      buf[2 * i - 1] = sum;
      buf[2 * i] = dup[i + 2];
    }
  }

  void predict_intra(int plane, int x, int y, bool have_left, bool have_above,
                     bool have_ar, bool have_bl, int mode, int log2w, int log2h) {
    Plane& P = planes[plane];
    int w = 1 << log2w, hh = 1 << log2h;
    int sx = plane ? s.ssx : 0, sy = plane ? s.ssy : 0;
    int max_x = ((h.mi_cols * 4) >> sx) - 1, max_y = ((h.mi_rows * 4) >> sy) - 1;
    int base = 1 << (s.bit_depth - 1);
    int above_buf[288], left_buf[288];
    int* above = above_buf + 16;
    int* left = left_buf + 16;
    int n = w + hh;
    if (!have_above && have_left) {
      for (int i = 0; i < n; i++) above[i] = P.at(y, x - 1);
    } else if (!have_above && !have_left) {
      for (int i = 0; i < n; i++) above[i] = base - 1;
    } else {
      int limit = std::min(max_x, x + (have_ar ? 2 * w : w) - 1);
      const uint16_t* row = P.row(y - 1);
      for (int i = 0; i < n; i++) above[i] = row[std::min(limit, x + i)];
    }
    if (!have_left && have_above) {
      for (int i = 0; i < n; i++) left[i] = P.at(y - 1, x);
    } else if (!have_left && !have_above) {
      for (int i = 0; i < n; i++) left[i] = base + 1;
    } else {
      int limit = std::min(max_y, y + (have_bl ? 2 * hh : hh) - 1);
      for (int i = 0; i < n; i++) left[i] = P.at(std::min(limit, y + i), x - 1);
    }
    int corner;
    if (have_above && have_left)
      corner = P.at(y - 1, x - 1);
    else if (have_above)
      corner = P.at(y - 1, x);
    else if (have_left)
      corner = P.at(y, x - 1);
    else
      corner = base;
    above[-1] = left[-1] = corner;
    int mx = pixel_max();
    auto out = [&](int i, int j) -> uint16_t& { return P.at(y + i, x + j); };

    if (plane == 0 && use_filter_intra) {
      int w4 = w >> 2, h2 = hh >> 1;
      for (int i2 = 0; i2 < h2; i2++)
        for (int j4 = 0; j4 < w4; j4++) {
          int p[7];
          for (int i = 0; i < 7; i++) {
            if (i < 5) {
              if (i2 == 0)
                p[i] = above[(j4 << 2) + i - 1];
              else if (j4 == 0 && i == 0)
                p[i] = left[(i2 << 1) - 1];
              else
                p[i] = out((i2 << 1) - 1, (j4 << 2) + i - 1);
            } else {
              if (j4 == 0)
                p[i] = left[(i2 << 1) + i - 5];
              else
                p[i] = out((i2 << 1) + i - 5, (j4 << 2) - 1);
            }
          }
          for (int i = 0; i < 8; i++) {
            int pr = 0;
            for (int j = 0; j < 7; j++) pr += kFilterIntraTaps[filter_intra_mode][i][j] * p[j];
            out((i2 << 1) + (i >> 2), (j4 << 2) + (i & 3)) =
                (uint16_t)clip3(0, mx, round2signed(pr, 4));
          }
        }
      return;
    }
    if (mode >= V_PRED && mode <= D67_PRED) {
      int angle_delta = plane == 0 ? angle_y : angle_uv;
      int p_angle = kModeToAngle[mode] + angle_delta * 3;
      int up_above = 0, up_left = 0;
      if (s.intra_edge) {
        int ftype = filter_type(plane);
        if (p_angle != 90 && p_angle != 180) {
          if (p_angle > 90 && p_angle < 180 && (w + hh) >= 24) {
            int v = round2(left[0] * 5 + above[-1] * 6 + above[0] * 5, 4);
            left[-1] = above[-1] = v;
          }
          if (have_above) {
            int st = edge_strength(w, hh, ftype, p_angle - 90);
            int num_px = std::min(w, max_x - x + 1) + (p_angle < 90 ? hh : 0) + 1;
            edge_filter(above, num_px, st);
          }
          if (have_left) {
            int st = edge_strength(w, hh, ftype, p_angle - 180);
            int num_px = std::min(hh, max_y - y + 1) + (p_angle > 180 ? w : 0) + 1;
            edge_filter(left, num_px, st);
          }
        }
        up_above = use_upsample(w, hh, ftype, p_angle - 90);
        if (up_above) edge_upsample(above, w + (p_angle < 90 ? hh : 0));
        up_left = use_upsample(w, hh, ftype, p_angle - 180);
        if (up_left) edge_upsample(left, hh + (p_angle > 180 ? w : 0));
      }
      int dx = 0, dy = 0;
      if (p_angle < 90)
        dx = kDrIntraDerivative[p_angle];
      else if (p_angle > 90 && p_angle < 180)
        dx = kDrIntraDerivative[180 - p_angle];
      if (p_angle > 90 && p_angle < 180)
        dy = kDrIntraDerivative[p_angle - 90];
      else if (p_angle > 180)
        dy = kDrIntraDerivative[270 - p_angle];
      for (int i = 0; i < hh; i++)
        for (int j = 0; j < w; j++) {
          int pred;
          if (p_angle < 90) {
            int idx = (i + 1) * dx;
            int b = (idx >> (6 - up_above)) + (j << up_above);
            int shift = ((idx << up_above) >> 1) & 0x1F;
            int max_base = (w + hh - 1) << up_above;
            if (b < max_base)
              pred = round2(above[b] * (32 - shift) + above[b + 1] * shift, 5);
            else
              pred = above[max_base];
          } else if (p_angle > 90 && p_angle < 180) {
            int idx = (j << 6) - (i + 1) * dx;
            int b = idx >> (6 - up_above);
            if (b >= -(1 << up_above)) {
              int shift = ((idx * (1 << up_above)) >> 1) & 0x1F;
              pred = round2(above[b] * (32 - shift) + above[b + 1] * shift, 5);
            } else {
              idx = (i << 6) - (j + 1) * dy;
              b = idx >> (6 - up_left);
              int shift = ((idx * (1 << up_left)) >> 1) & 0x1F;
              pred = round2(left[b] * (32 - shift) + left[b + 1] * shift, 5);
            }
          } else if (p_angle > 180) {
            int idx = (j + 1) * dy;
            int b = (idx >> (6 - up_left)) + (i << up_left);
            int shift = ((idx << up_left) >> 1) & 0x1F;
            int max_base = (w + hh - 1) << up_left;
            if (b < max_base)
              pred = round2(left[b] * (32 - shift) + left[b + 1] * shift, 5);
            else
              pred = left[max_base];
          } else if (p_angle == 90) {
            pred = above[j];
          } else {
            pred = left[i];
          }
          out(i, j) = (uint16_t)pred;
        }
      return;
    }
    if (mode == SMOOTH_PRED || mode == SMOOTH_V_PRED || mode == SMOOTH_H_PRED) {
      const uint8_t* wx = kSmWeights + w - 4;
      const uint8_t* wy = kSmWeights + hh - 4;
      for (int i = 0; i < hh; i++)
        for (int j = 0; j < w; j++) {
          int pred;
          if (mode == SMOOTH_PRED)
            pred = round2(wy[i] * above[j] + (256 - wy[i]) * left[hh - 1] + wx[j] * left[i] +
                              (256 - wx[j]) * above[w - 1],
                          9);
          else if (mode == SMOOTH_V_PRED)
            pred = round2(wy[i] * above[j] + (256 - wy[i]) * left[hh - 1], 8);
          else
            pred = round2(wx[j] * left[i] + (256 - wx[j]) * above[w - 1], 8);
          out(i, j) = (uint16_t)pred;
        }
      return;
    }
    if (mode == DC_PRED) {
      int avg;
      if (have_above && have_left) {
        int sum = 0;
        for (int k = 0; k < w; k++) sum += above[k];
        for (int k = 0; k < hh; k++) sum += left[k];
        avg = (sum + ((w + hh) >> 1)) / (w + hh);
      } else if (have_left) {
        int sum = 0;
        for (int k = 0; k < hh; k++) sum += left[k];
        avg = (sum + (hh >> 1)) >> log2h;
      } else if (have_above) {
        int sum = 0;
        for (int k = 0; k < w; k++) sum += above[k];
        avg = (sum + (w >> 1)) >> log2w;
      } else {
        avg = base;
      }
      for (int i = 0; i < hh; i++)
        for (int j = 0; j < w; j++) out(i, j) = (uint16_t)avg;
      return;
    }
    // PAETH
    for (int i = 0; i < hh; i++)
      for (int j = 0; j < w; j++) {
        int b = above[j] + left[i] - corner;
        int p_left = std::abs(b - left[i]), p_top = std::abs(b - above[j]),
            p_tl = std::abs(b - corner);
        int pred;
        if (p_left <= p_top && p_left <= p_tl)
          pred = left[i];
        else if (p_top <= p_tl)
          pred = above[j];
        else
          pred = corner;
        out(i, j) = (uint16_t)pred;
      }
  }

  void predict_cfl(int plane, int start_x, int start_y, int txs) {
    int w = 1 << kTxWLog2[txs], hh = 1 << kTxHLog2[txs];
    int sx = s.ssx, sy = s.ssy;
    int alpha = plane == 1 ? cfl_alpha_u : cfl_alpha_v;
    static thread_local int L[64 * 64];  // decodes run on several threads
    int64_t avg = 0;
    Plane& Y = planes[0];
    for (int i = 0; i < hh; i++) {
      int ly = std::min((start_y + i) << sy, max_luma_h - (1 << sy));
      for (int j = 0; j < w; j++) {
        int lx = std::min((start_x + j) << sx, max_luma_w - (1 << sx));
        int t = 0;
        for (int dy = 0; dy <= sy; dy++)
          for (int dx = 0; dx <= sx; dx++) t += Y.at(ly + dy, lx + dx);
        int v = t << (3 - sx - sy);
        L[i * w + j] = v;
        avg += v;
      }
    }
    int a = round2(avg, kTxWLog2[txs] + kTxHLog2[txs]);
    Plane& P = planes[plane];
    int mx = pixel_max();
    for (int i = 0; i < hh; i++)
      for (int j = 0; j < w; j++) {
        int dc = P.at(start_y + i, start_x + j);
        int scaled = round2signed((int64_t)alpha * (L[i * w + j] - a), 6);
        P.at(start_y + i, start_x + j) = (uint16_t)clip3(0, mx, dc + scaled);
      }
  }

  // ---------------------------------------------------------- reconstruction
  void reconstruct(int plane, int x, int y, int txs);
};

// ------------------------------------------------------- inverse transforms
// libaom's av1_inv_txfm1d.c flow graphs (cos_bit 12), each sum clamped to
// the stage range as libaom clamps it.
inline int32_t clamp_bits(int64_t v, int bits) {
  int64_t hi = ((int64_t)1 << (bits - 1)) - 1, lo = -((int64_t)1 << (bits - 1));
  return (int32_t)(v < lo ? lo : v > hi ? hi : v);
}
inline int32_t half_btf(int32_t w0, int32_t in0, int32_t w1, int32_t in1) {
  int64_t r = (int64_t)w0 * in0 + (int64_t)w1 * in1;
  return (int32_t)((r + 2048) >> 12);
}
inline int brev(int bits, int v) {
  int r = 0;
  for (int i = 0; i < bits; i++) r |= ((v >> i) & 1) << (bits - 1 - i);
  return r;
}
inline int32_t C(int i) { return kCospi[i]; }

// the odd half (M = n / 2 entries) of an n-point inverse DCT, in place
void idct_odd(int32_t* o, int n, int rng) {
  int m = n / 2;
  int kb = floor_log2((uint32_t)(m / 2));
  for (int k = 0; k < m / 2; k++) {
    int sidx = (64 / n) * (1 + 4 * brev(kb, k));
    int lo = k, hi = m - 1 - k;
    int32_t a = o[lo], b = o[hi];
    o[lo] = half_btf(C(64 - sidx), a, -C(sidx), b);
    o[hi] = half_btf(C(sidx), a, C(64 - sidx), b);
  }
  for (int g = 2; g <= m / 2; g *= 2) {
    for (int k = 0; k < m / g; k++) {
      int base = k * g;
      for (int i = 0; i < g / 2; i++) {
        int lo = base + i, hi = base + g - 1 - i;
        int32_t a = o[lo], b = o[hi];
        if (!(k & 1)) {
          o[lo] = clamp_bits((int64_t)a + b, rng);
          o[hi] = clamp_bits((int64_t)a - b, rng);
        } else {
          o[lo] = clamp_bits((int64_t)b - a, rng);
          o[hi] = clamp_bits((int64_t)a + b, rng);
        }
      }
    }
    int nb = std::max(1, m / (4 * g));
    int a0 = (64 / m) * g, step = 256 * g / m;
    for (int bi = 0; bi < nb; bi++) {
      int ang = a0 + step * brev(floor_log2((uint32_t)nb), bi);
      int j0 = bi * 2 * g;
      for (int j = j0 + g / 2; j < j0 + 3 * g / 2 && j < m / 2; j++) {
        int lo = j, hi = m - 1 - j;
        int32_t a = o[lo], b = o[hi];
        if (j < j0 + g) {
          o[lo] = half_btf(-C(ang), a, C(64 - ang), b);
          o[hi] = half_btf(C(64 - ang), a, C(ang), b);
        } else {
          o[lo] = half_btf(-C(64 - ang), a, -C(ang), b);
          o[hi] = half_btf(-C(ang), a, C(64 - ang), b);
        }
      }
    }
  }
}

// an n-point inverse DCT of x (bit-reversed order), in place
void idct_core(int32_t* x, int n, int rng) {
  if (n == 2) {
    int32_t a = x[0], b = x[1];
    x[0] = half_btf(C(32), a, C(32), b);
    x[1] = half_btf(C(32), a, -C(32), b);
    return;
  }
  idct_core(x, n / 2, rng);
  idct_odd(x + n / 2, n, rng);
  for (int i = 0; i < n / 2; i++) {
    int32_t a = x[i], b = x[n - 1 - i];
    x[i] = clamp_bits((int64_t)a + b, rng);
    x[n - 1 - i] = clamp_bits((int64_t)a - b, rng);
  }
}

void idct(const int32_t* in, int32_t* out, int n, int rng) {
  int bits = floor_log2((uint32_t)n);
  for (int i = 0; i < n; i++) out[i] = in[brev(bits, i)];
  idct_core(out, n, rng);
}

void iadst4(const int32_t* in, int32_t* out) {
  const int32_t* sinpi = kSinpi;
  int32_t x0 = in[0], x1 = in[1], x2 = in[2], x3 = in[3];
  if (!(x0 | x1 | x2 | x3)) {
    out[0] = out[1] = out[2] = out[3] = 0;
    return;
  }
  int64_t s0 = (int64_t)sinpi[1] * x0, s1 = (int64_t)sinpi[2] * x0;
  int64_t s2 = (int64_t)sinpi[3] * x1, s3 = (int64_t)sinpi[4] * x2;
  int64_t s4 = (int64_t)sinpi[1] * x2, s5 = (int64_t)sinpi[2] * x3;
  int64_t s6 = (int64_t)sinpi[4] * x3;
  int32_t s7 = (x0 - x2) + x3;
  s0 = s0 + s3;
  s1 = s1 - s4;
  s3 = s2;
  s2 = (int64_t)sinpi[3] * s7;
  s0 = s0 + s5;
  s1 = s1 - s6;
  int64_t y0 = s0 + s3, y1 = s1 + s3, y2 = s2, y3 = s0 + s1;
  y3 = y3 - s3;
  out[0] = (int32_t)((y0 + 2048) >> 12);
  out[1] = (int32_t)((y1 + 2048) >> 12);
  out[2] = (int32_t)((y2 + 2048) >> 12);
  out[3] = (int32_t)((y3 + 2048) >> 12);
}

// libaom's av1_iadst8 and av1_iadst16
void iadst(const int32_t* in, int32_t* out, int n, int rng) {
  int32_t x[16];
  for (int k = 0; k < n / 2; k++) {
    x[2 * k] = in[n - 1 - 2 * k];
    x[2 * k + 1] = in[2 * k];
  }
  for (int k = 0; k < n / 2; k++) {
    int a = 32 / n + (128 / n) * k;
    int32_t p = x[2 * k], q = x[2 * k + 1];
    x[2 * k] = half_btf(C(a), p, C(64 - a), q);
    x[2 * k + 1] = half_btf(C(64 - a), p, -C(a), q);
  }
  for (int span = n / 2; span >= 2; span /= 2) {
    for (int b0 = 0; b0 < n; b0 += 2 * span)
      for (int i = 0; i < span; i++) {
        int32_t p = x[b0 + i], q = x[b0 + i + span];
        x[b0 + i] = clamp_bits((int64_t)p + q, rng);
        x[b0 + i + span] = clamp_bits((int64_t)p - q, rng);
      }
    int pairs = span / 2;
    for (int b0 = 0; b0 < n; b0 += 2 * span)
      for (int j = 0; j < pairs; j++) {
        int lo = b0 + span + 2 * j, hi = lo + 1;
        int32_t p = x[lo], q = x[hi];
        if (span == 2 || j < (pairs + 1) / 2) {
          int a = 64 / span + (256 / span) * j;
          x[lo] = half_btf(C(a), p, C(64 - a), q);
          x[hi] = half_btf(C(64 - a), p, -C(a), q);
        } else {
          int a = 64 - (64 / span + (256 / span) * (j - pairs / 2));
          x[lo] = half_btf(-C(a), p, C(64 - a), q);
          x[hi] = half_btf(C(64 - a), p, C(a), q);
        }
      }
  }
  if (n == 8) {
    static const int idx[8] = {0, 4, 6, 2, 3, 7, 5, 1};
    for (int i = 0; i < 8; i++) out[i] = (i & 1) ? -x[idx[i]] : x[idx[i]];
  } else {
    static const int idx[16] = {0, 8, 12, 4, 6, 14, 10, 2, 3, 11, 15, 7, 5, 13, 9, 1};
    for (int i = 0; i < 16; i++) out[i] = (i & 1) ? -x[idx[i]] : x[idx[i]];
  }
}

void iidentity(const int32_t* in, int32_t* out, int n) {
  for (int i = 0; i < n; i++) {
    if (n == 4)
      out[i] = (int32_t)(((int64_t)5793 * in[i] + 2048) >> 12);
    else if (n == 8)
      out[i] = (int32_t)((int64_t)in[i] * 2);
    else if (n == 16)
      out[i] = (int32_t)(((int64_t)5793 * 2 * in[i] + 2048) >> 12);
    else
      out[i] = (int32_t)((int64_t)in[i] * 4);
  }
}

enum { T_DCT, T_ADST, T_FLIPADST, T_IDTX };
// (column type, row type) of each transform type, flips included
const uint8_t kVtx[16] = {T_DCT,      T_ADST,     T_DCT,  T_ADST,   T_FLIPADST, T_DCT,
                          T_FLIPADST, T_ADST,     T_FLIPADST, T_IDTX, T_DCT,  T_IDTX,
                          T_ADST,     T_IDTX,     T_FLIPADST, T_IDTX};
const uint8_t kHtx[16] = {T_DCT,  T_DCT,      T_ADST, T_ADST, T_DCT,      T_FLIPADST,
                          T_FLIPADST, T_FLIPADST, T_ADST, T_IDTX, T_IDTX,     T_DCT,
                          T_IDTX, T_ADST,     T_IDTX, T_FLIPADST};
const int8_t kRowShift[TX_SIZES_ALL] = {0, 1, 2, 2, 2, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2};

void tx1d(int type, const int32_t* in, int32_t* out, int n, int rng) {
  if (type == T_DCT)
    idct(in, out, n, rng);
  else if (type == T_IDTX)
    iidentity(in, out, n);
  else if (n == 4)
    iadst4(in, out);
  else
    iadst(in, out, n, rng);
}

// the inverse transform of coefficients (row-major, the top-left
// min(w, 32) x min(h, 32)) added to dst; libaom's inv_txfm2d_add_c
void inverse_transform_add(const int32_t* coef, int txs, int type, int bd, uint16_t* dst,
                           int stride) {
  int log2w = kTxWLog2[txs], log2h = kTxHLog2[txs];
  int w = 1 << log2w, hh = 1 << log2h;
  int cw = std::min(w, 32), ch = std::min(hh, 32);
  bool rect = std::abs(log2w - log2h) == 1;
  int row_rng = bd + 8, col_rng = std::max(bd + 6, 16);
  int rshift = kRowShift[txs];
  int vt = kVtx[type], ht = kHtx[type];
  bool ud_flip = vt == T_FLIPADST, lr_flip = ht == T_FLIPADST;
  static thread_local int32_t buf[64 * 64];  // decodes run on several threads
  int32_t tin[64], tout[64];
  for (int r = 0; r < hh; r++) {
    int32_t* brow = buf + r * w;
    if (r >= ch) {
      memset(brow, 0, sizeof(int32_t) * w);
      continue;
    }
    for (int c = 0; c < w; c++) {
      int64_t v = c < cw ? coef[r * cw + c] : 0;
      if (rect) v = (v * 2896 + 2048) >> 12;
      tin[c] = clamp_bits(v, row_rng);
    }
    tx1d(ht, tin, brow, w, row_rng);
    if (rshift)
      for (int c = 0; c < w; c++)
        brow[c] = (int32_t)(((int64_t)brow[c] + (1 << (rshift - 1))) >> rshift);
  }
  int mx = (1 << bd) - 1;
  for (int c = 0; c < w; c++) {
    int sc = lr_flip ? w - 1 - c : c;
    for (int r = 0; r < hh; r++) tin[r] = clamp_bits(buf[r * w + sc], col_rng);
    tx1d(vt, tin, tout, hh, col_rng);
    for (int r = 0; r < hh; r++) {
      int v = (int)(((int64_t)tout[ud_flip ? hh - 1 - r : r] + 8) >> 4);
      uint16_t& p = dst[(size_t)r * stride + c];
      p = (uint16_t)clip3(0, mx, (int)p + v);
    }
  }
}

void iwht_add(const int32_t* coef, int bd, uint16_t* dst, int stride) {
  int32_t tmp[16];
  for (int i = 0; i < 4; i++) {  // rows
    int32_t a = coef[i * 4 + 0] >> 2, c = coef[i * 4 + 1] >> 2, d = coef[i * 4 + 2] >> 2,
            b = coef[i * 4 + 3] >> 2;
    a += c;
    d -= b;
    int32_t e = (a - d) >> 1;
    b = e - b;
    c = e - c;
    a -= b;
    d += c;
    tmp[i * 4 + 0] = a;
    tmp[i * 4 + 1] = b;
    tmp[i * 4 + 2] = c;
    tmp[i * 4 + 3] = d;
  }
  int mx = (1 << bd) - 1;
  for (int i = 0; i < 4; i++) {  // columns
    int32_t a = tmp[0 * 4 + i], c = tmp[1 * 4 + i], d = tmp[2 * 4 + i], b = tmp[3 * 4 + i];
    a += c;
    d -= b;
    int32_t e = (a - d) >> 1;
    b = e - b;
    c = e - c;
    a -= b;
    d += c;
    int32_t v[4] = {a, b, c, d};
    for (int r = 0; r < 4; r++) {
      uint16_t& p = dst[(size_t)r * stride + i];
      p = (uint16_t)clip3(0, mx, (int)p + v[r]);
    }
  }
}

void Decoder::reconstruct(int plane, int x, int y, int txs) {
  Plane& P = planes[plane];
  if (lossless)
    iwht_add(dequant, s.bit_depth, &P.at(y, x), P.stride);
  else
    inverse_transform_add(dequant, txs, plane_tx_type, s.bit_depth, &P.at(y, x), P.stride);
}

// ------------------------------------------------------- loop filter
struct LoopFilter {
  Decoder& d;
  const FrameHeader& h;
  int bd;
  explicit LoopFilter(Decoder& dec) : d(dec), h(dec.h), bd(dec.s.bit_depth) {}

  int level(const MiInfo& m, int plane, int pass) {
    int idx = plane == 0 ? pass : plane + 1;
    int base = h.lf_level[idx];
    int lvl = base;
    if (h.delta_lf_present) {
      int dl = h.delta_lf_multi ? m.delta_lf[idx] : m.delta_lf[0];
      lvl = clip3(0, 63, dl + base);
    }
    int feature = 1 + idx;
    if (h.seg_enabled && h.feature_enabled[m.seg][feature])
      lvl = clip3(0, 63, lvl + h.feature_data[m.seg][feature]);
    if (h.lf_delta_enabled) {
      int shift = lvl >> 5;
      lvl = clip3(0, 63, lvl + h.lf_ref_deltas[0] * (1 << shift));
    }
    return lvl;
  }

  // one sample position across the edge at (x, y) of plane p, in
  // direction (dx, dy) (1, 0: a vertical edge)
  void sample(Plane& P, int x, int y, int limit, int blimit, int thresh, int dx, int dy,
              int size, int plane) {
    auto px = [&](int k) -> uint16_t& {  // k >= 0: q_k, k < 0: p_(-k-1)
      return P.at(y + dy * k, x + dx * k);
    };
    int shift = bd - 8;
    int q0 = px(0), q1 = px(1), p0 = px(-1), p1 = px(-2);
    int lim = limit << shift, blim = blimit << shift, thr = thresh << shift;
    bool hev = std::abs(p1 - p0) > thr || std::abs(q1 - q0) > thr;
    bool mask = std::abs(p1 - p0) <= lim && std::abs(q1 - q0) <= lim &&
                std::abs(p0 - q0) * 2 + std::abs(p1 - q1) / 2 <= blim;
    int q2 = 0, p2 = 0, q3 = 0, p3 = 0;
    if (size >= 6) {
      q2 = px(2);
      p2 = px(-3);
      mask = mask && std::abs(p2 - p1) <= lim && std::abs(q2 - q1) <= lim;
    }
    if (size >= 8) {
      q3 = px(3);
      p3 = px(-4);
      mask = mask && std::abs(p3 - p2) <= lim && std::abs(q3 - q2) <= lim;
    }
    if (!mask) return;
    int one = 1 << shift;
    bool flat = false, flat2 = false;
    if (size == 6) {
      flat = std::abs(p1 - p0) <= one && std::abs(q1 - q0) <= one &&
             std::abs(p2 - p0) <= one && std::abs(q2 - q0) <= one;
    } else if (size >= 8) {
      flat = std::abs(p1 - p0) <= one && std::abs(q1 - q0) <= one &&
             std::abs(p2 - p0) <= one && std::abs(q2 - q0) <= one &&
             std::abs(p3 - p0) <= one && std::abs(q3 - q0) <= one;
    }
    if (size == 16) {
      int q4 = px(4), q5 = px(5), q6 = px(6), p4 = px(-5), p5 = px(-6), p6 = px(-7);
      flat2 = std::abs(p6 - p0) <= one && std::abs(q6 - q0) <= one &&
              std::abs(p5 - p0) <= one && std::abs(q5 - q0) <= one &&
              std::abs(p4 - p0) <= one && std::abs(q4 - q0) <= one;
    }
    if (size == 4 || !flat) {
      // narrow filter
      int half = 0x80 << shift;
      int fmin = -(1 << (bd - 1)), fmax = (1 << (bd - 1)) - 1;
      int ps1 = p1 - half, ps0 = p0 - half, qs0 = q0 - half, qs1 = q1 - half;
      int f = hev ? clip3(fmin, fmax, ps1 - qs1) : 0;
      f = clip3(fmin, fmax, f + 3 * (qs0 - ps0));
      int f1 = clip3(fmin, fmax, f + 4) >> 3;
      int f2 = clip3(fmin, fmax, f + 3) >> 3;
      px(0) = (uint16_t)(clip3(fmin, fmax, qs0 - f1) + half);
      px(-1) = (uint16_t)(clip3(fmin, fmax, ps0 + f2) + half);
      if (!hev) {
        f = round2(f1, 1);
        px(1) = (uint16_t)(clip3(fmin, fmax, qs1 - f) + half);
        px(-2) = (uint16_t)(clip3(fmin, fmax, ps1 + f) + half);
      }
    } else if (size == 8 || size == 6 || !flat2) {
      wide(px, 3, plane);
    } else {
      wide(px, 4, plane);
    }
  }
  template <class F>
  void wide(F& px, int log2size, int plane) {
    int n = log2size == 4 ? 6 : plane == 0 ? 3 : 2;
    int n2 = (log2size == 3 && plane == 0) ? 0 : 1;
    int F0[16], out[16];
    for (int k = -(n + 1); k <= n; k++) F0[k + 8] = px(k);
    for (int i = -n; i < n; i++) {
      int t = 0;
      for (int j = -n; j <= n; j++) {
        int p = clip3(-(n + 1), n, i + j);
        int tap = std::abs(j) <= n2 ? 2 : 1;
        t += F0[p + 8] * tap;
      }
      out[i + 8] = round2(t, log2size);
    }
    for (int i = -n; i < n; i++) px(i) = (uint16_t)out[i + 8];
  }

  void run() {
    if (!h.lf_level[0] && !h.lf_level[1]) return;
    for (int plane = 0; plane < d.num_planes; plane++) {
      if (plane == 1 && !h.lf_level[2]) continue;
      if (plane == 2 && !h.lf_level[3]) continue;
      int sx = plane ? d.s.ssx : 0, sy = plane ? d.s.ssy : 0;
      int pw4 = (h.mi_cols * 4 >> sx) >> 2, ph4 = (h.mi_rows * 4 >> sy) >> 2;
      for (int pass = 0; pass < 2; pass++) {
        int dx = pass == 0, dy = pass == 1;
        for (int yp = 0; yp < ph4; yp++)
          for (int xp = 0; xp < pw4; xp++) {
            int x = (xp << sx) * 4, y = (yp << sy) * 4;
            if (x >= h.width || y >= h.height) continue;
            if (pass == 0 && x == 0) continue;
            if (pass == 1 && y == 0) continue;
            int row = (yp << sy) | sy, col = (xp << sx) | sx;
            row = std::min(row, h.mi_rows - 1);
            col = std::min(col, h.mi_cols - 1);
            const MiInfo& m = d.at(row, col);
            int txs = d.lf_tx[plane][(size_t)yp * d.lf_stride[plane] + xp];
            int pyp = yp - dy, pxp = xp - dx;
            int ptxs = d.lf_tx[plane][(size_t)pyp * d.lf_stride[plane] + pxp];
            int tsz = pass == 0 ? 1 << kTxWLog2[txs] : 1 << kTxHLog2[txs];
            int coord = pass == 0 ? xp * 4 : yp * 4;
            if (coord % tsz) continue;  // not a transform edge
            int ptsz = pass == 0 ? 1 << kTxWLog2[ptxs] : 1 << kTxHLog2[ptxs];
            int base_size = std::min(tsz, ptsz);
            int size = plane == 0 ? std::min(16, base_size) : std::min(8, base_size);
            if (plane && size == 8) size = 6;
            int lvl = level(m, plane, pass);
            if (!lvl) {
              int prow = pass == 1 ? row - (1 << sy) : row;
              int pcol = pass == 0 ? col - (1 << sx) : col;
              lvl = level(d.at(prow, pcol), plane, pass);
            }
            if (!lvl) continue;
            int sharp = h.lf_sharpness;
            int limit = lvl >> ((sharp > 0) + (sharp > 4));
            if (sharp > 0 && limit > 9 - sharp) limit = 9 - sharp;
            if (limit < 1) limit = 1;
            int blimit = 2 * (lvl + 2) + limit, thresh = lvl >> 4;
            Plane& P = d.planes[plane];
            for (int i = 0; i < 4; i++)
              sample(P, xp * 4 + dy * i, yp * 4 + dx * i, limit, blimit, thresh, dx, dy, size,
                     plane);
          }
      }
    }
  }
};

// ------------------------------------------------------- CDEF
struct Cdef {
  Decoder& d;
  const FrameHeader& h;
  explicit Cdef(Decoder& dec) : d(dec), h(dec.h) {}
  static constexpr int kLarge = 30000;

  static int find_dir(const int* img, int stride, int* var, int shift) {
    int cost[8] = {0};
    int partial[8][15] = {{0}};
    static const int div_table[9] = {0, 840, 420, 280, 210, 168, 140, 120, 105};
    for (int i = 0; i < 8; i++)
      for (int j = 0; j < 8; j++) {
        int x = (img[i * stride + j] >> shift) - 128;
        partial[0][i + j] += x;
        partial[1][i + j / 2] += x;
        partial[2][i] += x;
        partial[3][3 + i - j / 2] += x;
        partial[4][7 + i - j] += x;
        partial[5][3 - i / 2 + j] += x;
        partial[6][j] += x;
        partial[7][i / 2 + j] += x;
      }
    for (int i = 0; i < 8; i++) {
      cost[2] += partial[2][i] * partial[2][i];
      cost[6] += partial[6][i] * partial[6][i];
    }
    cost[2] *= div_table[8];
    cost[6] *= div_table[8];
    for (int i = 0; i < 7; i++) {
      cost[0] += (partial[0][i] * partial[0][i] + partial[0][14 - i] * partial[0][14 - i]) *
                 div_table[i + 1];
      cost[4] += (partial[4][i] * partial[4][i] + partial[4][14 - i] * partial[4][14 - i]) *
                 div_table[i + 1];
    }
    cost[0] += partial[0][7] * partial[0][7] * div_table[8];
    cost[4] += partial[4][7] * partial[4][7] * div_table[8];
    for (int i = 1; i < 8; i += 2) {
      for (int j = 0; j < 5; j++) cost[i] += partial[i][3 + j] * partial[i][3 + j];
      cost[i] *= div_table[8];
      for (int j = 0; j < 3; j++)
        cost[i] += (partial[i][j] * partial[i][j] + partial[i][10 - j] * partial[i][10 - j]) *
                   div_table[2 * j + 2];
    }
    int best_dir = 0, best_cost = 0;
    for (int i = 0; i < 8; i++)
      if (cost[i] > best_cost) {
        best_cost = cost[i];
        best_dir = i;
      }
    *var = (best_cost - cost[(best_dir + 4) & 7]) >> 10;
    return best_dir;
  }
  static int constrain(int diff, int threshold, int damping) {
    if (!threshold) return 0;
    int shift = std::max(0, damping - floor_log2((uint32_t)threshold));
    int mag = std::min(std::abs(diff), std::max(0, threshold - (std::abs(diff) >> shift)));
    return diff < 0 ? -mag : mag;
  }

  void run() {
    if (!d.s.cdef || h.coded_lossless || h.allow_intrabc) return;
    int bd = d.s.bit_depth, coeff_shift = bd - 8;
    // the deblocked frame, padded by 3 with kLarge past the frame
    std::vector<int> src[3];
    int sw[3], sh[3];
    const int pad = 3;
    for (int p = 0; p < d.num_planes; p++) {
      int sx = p ? d.s.ssx : 0, sy = p ? d.s.ssy : 0;
      int fw = (h.mi_cols * 4) >> sx, fh = (h.mi_rows * 4) >> sy;
      sw[p] = fw + 2 * pad;
      sh[p] = fh + 2 * pad;
      src[p].assign((size_t)sw[p] * sh[p], kLarge);
      for (int y = 0; y < fh; y++)
        for (int x = 0; x < fw; x++)
          src[p][(size_t)(y + pad) * sw[p] + x + pad] = d.planes[p].at(y, x);
    }
    static const int dirs[8][2][2] = {  // (dy, dx) of the two taps
        {{-1, 1}, {-2, 2}}, {{0, 1}, {-1, 2}}, {{0, 1}, {0, 2}}, {{0, 1}, {1, 2}},
        {{1, 1}, {2, 2}},   {{1, 0}, {2, 1}},  {{1, 0}, {2, 0}}, {{1, 0}, {2, -1}}};
    static const int conv422[8] = {7, 0, 2, 4, 5, 6, 6, 6};
    static const int conv440[8] = {1, 2, 2, 2, 3, 4, 6, 0};
    for (int fbr = 0; fbr < (h.mi_rows + 15) >> 4; fbr++)
      for (int fbc = 0; fbc < d.cdef_cols; fbc++) {
        int idx = d.cdef_idx[(size_t)fbr * d.cdef_cols + fbc];
        if (idx == -1) continue;
        for (int r = fbr * 16; r < std::min(fbr * 16 + 16, h.mi_rows); r += 2)
          for (int c = fbc * 16; c < std::min(fbc * 16 + 16, h.mi_cols); c += 2) {
            if (d.at(r, c).skip && d.at(r + 1, c).skip && d.at(r, c + 1).skip &&
                d.at(r + 1, c + 1).skip)
              continue;
            int var = 0;
            const int* y8 = &src[0][(size_t)(r * 4 + pad) * sw[0] + c * 4 + pad];
            int ydir = find_dir(y8, sw[0], &var, coeff_shift);
            for (int p = 0; p < d.num_planes; p++) {
              int sx = p ? d.s.ssx : 0, sy = p ? d.s.ssy : 0;
              int pri, sec, damping, dir;
              if (p == 0) {
                pri = h.cdef_y_pri[idx] << coeff_shift;
                sec = h.cdef_y_sec[idx] << coeff_shift;
                dir = pri ? ydir : 0;
                int vs = (var >> 6) ? std::min(floor_log2((uint32_t)(var >> 6)), 12) : 0;
                pri = var ? (pri * (4 + vs) + 8) >> 4 : 0;
                damping = h.cdef_damping + coeff_shift;
              } else {
                pri = h.cdef_uv_pri[idx] << coeff_shift;
                sec = h.cdef_uv_sec[idx] << coeff_shift;
                dir = ydir;
                if (sx != sy) dir = sx ? conv422[dir] : conv440[dir];
                dir = pri ? dir : 0;
                damping = h.cdef_damping - 1 + coeff_shift;
              }
              if (!pri && !sec) continue;
              filter_block(p, (r * 4) >> sy, (c * 4) >> sx, 8 >> sy, 8 >> sx, src[p], sw[p],
                           pad, pri, sec, dir, damping, coeff_shift, dirs);
            }
          }
      }
  }

  void filter_block(int p, int y0, int x0, int bh, int bw, const std::vector<int>& src,
                    int stride, int pad, int pri, int sec, int dir, int damping,
                    int coeff_shift, const int (*dirs)[2][2]) {
    static const int pri_taps[2][2] = {{4, 2}, {3, 3}};
    static const int sec_taps[2] = {2, 1};
    const int* pt = pri_taps[(pri >> coeff_shift) & 1];
    bool clip = pri && sec;
    Plane& P = d.planes[p];
    for (int i = 0; i < bh; i++)
      for (int j = 0; j < bw; j++) {
        const int* in = &src[(size_t)(y0 + i + pad) * stride + x0 + j + pad];
        int x = in[0];
        int sum = 0, mx = x, mn = x;
        for (int k = 0; k < 2; k++) {
          if (pri) {
            int off = dirs[dir][k][0] * stride + dirs[dir][k][1];
            int p0 = in[off], p1 = in[-off];
            sum += pt[k] * constrain(p0 - x, pri, damping);
            sum += pt[k] * constrain(p1 - x, pri, damping);
            if (clip) {
              if (p0 != kLarge) mx = std::max(p0, mx);
              if (p1 != kLarge) mx = std::max(p1, mx);
              mn = std::min(p0, mn);
              mn = std::min(p1, mn);
            }
          }
          if (sec) {
            int d1 = (dir + 2) & 7, d2 = (dir + 6) & 7;
            int off1 = dirs[d1][k][0] * stride + dirs[d1][k][1];
            int off2 = dirs[d2][k][0] * stride + dirs[d2][k][1];
            int s0 = in[off1], s1 = in[-off1], s2 = in[off2], s3 = in[-off2];
            if (clip) {
              if (s0 != kLarge) mx = std::max(s0, mx);
              if (s1 != kLarge) mx = std::max(s1, mx);
              if (s2 != kLarge) mx = std::max(s2, mx);
              if (s3 != kLarge) mx = std::max(s3, mx);
              mn = std::min(std::min(s0, s1), mn);
              mn = std::min(std::min(s2, s3), mn);
            }
            sum += sec_taps[k] * constrain(s0 - x, sec, damping);
            sum += sec_taps[k] * constrain(s1 - x, sec, damping);
            sum += sec_taps[k] * constrain(s2 - x, sec, damping);
            sum += sec_taps[k] * constrain(s3 - x, sec, damping);
          }
        }
        int y = x + ((8 + sum - (sum < 0)) >> 4);
        if (clip) y = clip3(mn, mx, y);
        P.at(y0 + i, x0 + j) = (uint16_t)y;
      }
  }
};

// ------------------------------------------------------- loop restoration
// libaom's av1_loop_restoration_filter_frame: each plane in stripes of 64
// rows (of the plane's 64 >> ssy) offset 8 (8 >> ssy) up, each stripe's
// units filtered with the Wiener filter or the self-guided filter. A
// stripe reads the CDEF'd frame; the rows above and below it come from the
// deblocked frame before CDEF (two rows, the farther one repeated), except
// at the frame's top and bottom, where the CDEF'd edge row is repeated.
struct LoopRestoration {
  Decoder& d;
  const std::vector<uint16_t>* deblocked;  // per plane, the planes' layout
  int bd;
  LoopRestoration(Decoder& dec, const std::vector<uint16_t>* db)
      : d(dec), deblocked(db), bd(dec.s.bit_depth) {}

  void run() {
    for (int p = 0; p < d.num_planes; p++)
      if (d.h.lr_type[p] != RESTORE_NONE) plane(p);
  }

  void plane(int p) {
    Plane& P = d.planes[p];
    int sx = p ? d.s.ssx : 0, sy = p ? d.s.ssy : 0;
    int W = (d.h.width + sx) >> sx, H = (d.h.height + sy) >> sy;
    int size = d.h.lr_unit_size[p], stripe_h = 64 >> sy, off = 8 >> sy;
    std::vector<uint16_t> out(P.px);
    std::vector<int32_t> src;
    const int pw = W + 6;
    for (int k = 0;; k++) {
      int ys = k * stripe_h - off, ye = ys + stripe_h - 1;  // the stripe's rows
      int y0 = std::max(0, ys), y1 = std::min(H, ye + 1);
      if (y0 >= H) break;
      int rows = y1 - y0;
      // the stripe's source, 3 samples around
      src.assign((size_t)pw * (rows + 6), 0);
      for (int i = -3; i < rows + 3; i++) {
        int y = clip3(0, H - 1, y0 + i);
        const uint16_t* row;
        if (y < ys)
          row = deblocked[p].data() + (size_t)std::max(ys - 2, y) * P.stride;
        else if (y > ye)
          row = deblocked[p].data() + (size_t)std::min(ye + 2, y) * P.stride;
        else
          row = P.row(y);
        int32_t* dst = &src[(size_t)(i + 3) * pw];
        for (int x = -3; x < W + 3; x++) dst[x + 3] = row[clip3(0, W - 1, x)];
      }
      int unit_row = std::min(d.lr_rows[p] - 1, (y0 + off) / size);
      for (int uc = 0; uc < d.lr_cols[p]; uc++) {
        const LrUnit& u = d.lr_units[p][(size_t)unit_row * d.lr_cols[p] + uc];
        int x0 = uc * size, x1 = uc == d.lr_cols[p] - 1 ? W : x0 + size;
        const int32_t* at = &src[(size_t)3 * pw + 3 + x0];
        uint16_t* dst = &out[(size_t)y0 * P.stride + x0];
        if (u.type == RESTORE_WIENER)
          wiener(u, at, pw, x1 - x0, rows, dst, P.stride);
        else if (u.type == RESTORE_SGRPROJ)
          self_guided(u, at, pw, x1 - x0, rows, y0 & 1, dst, P.stride);
      }
    }
    P.px.swap(out);
  }

  // libaom's av1_wiener_convolve_add_src: 7 taps (the centre +128), rows
  // then columns, the rounding between them by bit depth
  void wiener(const LrUnit& u, const int32_t* src, int ss, int w, int h, uint16_t* dst,
              int ds) {
    int r0 = bd == 12 ? 5 : 3, r1 = bd == 12 ? 9 : 11;
    int taps[2][7];
    for (int pass = 0; pass < 2; pass++) {
      const int8_t* c = u.wiener[pass];
      int* t = taps[pass];
      t[0] = t[6] = c[0];
      t[1] = t[5] = c[1];
      t[2] = t[4] = c[2];
      t[3] = -2 * (c[0] + c[1] + c[2]);
    }
    const int limit = (1 << (bd + 8 - r0)) - 1, maxv = (1 << bd) - 1;
    std::vector<int32_t> tmp((size_t)(h + 6) * w);
    for (int i = 0; i < h + 6; i++) {
      const int32_t* row = src + (std::ptrdiff_t)(i - 3) * ss;
      for (int j = 0; j < w; j++) {
        int sum = (row[j] << 7) + (1 << (bd + 6));
        for (int t = 0; t < 7; t++) sum += taps[1][t] * row[j + t - 3];
        tmp[(size_t)i * w + j] = clip3(0, limit, (sum + (1 << (r0 - 1))) >> r0);
      }
    }
    for (int i = 0; i < h; i++)
      for (int j = 0; j < w; j++) {
        const int32_t* col = &tmp[(size_t)i * w + j];
        int sum = (col[3 * w] << 7) - (1 << (bd + r1 - 1));
        for (int t = 0; t < 7; t++) sum += taps[0][t] * col[t * w];
        dst[(size_t)i * ds + j] = (uint16_t)clip3(0, maxv, (sum + (1 << (r1 - 1))) >> r1);
      }
  }

  // libaom's av1_apply_selfguided_restoration: the box filter at radius 2
  // (its A and B on every other row; odd: whether the first row is odd)
  // and at radius 1, projected with xqd
  void self_guided(const LrUnit& u, const int32_t* src, int ss, int w, int h, int odd,
                   uint16_t* dst, int ds) {
    const int32_t* prm = kSgrParams[u.set];
    std::vector<int32_t> flt[2];
    for (int pass = 0; pass < 2; pass++)
      if (prm[pass]) box_filter(pass, prm[pass], (uint32_t)prm[2 + pass], src, ss, w, h, odd,
                                flt[pass]);
    int xq0, xq1;
    if (!prm[0]) {
      xq0 = 0;
      xq1 = 128 - u.xqd[1];
    } else if (!prm[1]) {
      xq0 = u.xqd[0];
      xq1 = 0;
    } else {
      xq0 = u.xqd[0];
      xq1 = 128 - u.xqd[0] - u.xqd[1];
    }
    const int maxv = (1 << bd) - 1;
    for (int i = 0; i < h; i++)
      for (int j = 0; j < w; j++) {
        size_t k = (size_t)i * w + j;
        int32_t uu = src[(std::ptrdiff_t)i * ss + j] << 4;
        int32_t v = uu << 7;
        if (prm[0]) v += xq0 * (flt[0][k] - uu);
        if (prm[1]) v += xq1 * (flt[1][k] - uu);
        int16_t o = (int16_t)((v + (1 << 10)) >> 11);
        dst[(size_t)i * ds + j] = (uint16_t)clip3<int>(0, maxv, o);
      }
  }

  void box_filter(int pass, int r, uint32_t scale, const int32_t* src, int ss, int w, int h,
                  int odd, std::vector<int32_t>& flt) {
    const int aw = w + 2;
    std::vector<int32_t> A((size_t)aw * (h + 2)), B((size_t)aw * (h + 2));
    const uint32_t n = (2 * r + 1) * (2 * r + 1), one_by_n = (uint32_t)kOneByX[n - 1];
    for (int i = -1; i < h + 1; i++) {
      // radius 2 keeps the rows of the other parity than the first row's
      if (pass == 0 && ((i + odd) & 1) == 0) continue;
      for (int j = -1; j < w + 1; j++) {
        uint32_t sum = 0, sq = 0;
        for (int dy = -r; dy <= r; dy++)
          for (int dx = -r; dx <= r; dx++) {
            uint32_t c = (uint32_t)src[(std::ptrdiff_t)(i + dy) * ss + j + dx];
            sum += c;
            sq += c * c;
          }
        uint32_t a = (sq + ((1u << (2 * (bd - 8))) >> 1)) >> (2 * (bd - 8));
        uint32_t b = (sum + ((1u << (bd - 8)) >> 1)) >> (bd - 8);
        uint32_t pp = a * n < b * b ? 0 : a * n - b * b;
        uint32_t z = (pp * scale + (1u << 19)) >> 20;
        int32_t av = kXByXplus1[std::min<uint32_t>(z, 255)];
        size_t k = (size_t)(i + 1) * aw + j + 1;
        A[k] = av;
        B[k] = (int32_t)(((uint32_t)(256 - av) * sum * one_by_n + (1u << 11)) >> 12);
      }
    }
    flt.assign((size_t)w * h, 0);
    for (int i = 0; i < h; i++)
      for (int j = 0; j < w; j++) {
        auto at = [&](const std::vector<int32_t>& v, int di, int dj) {
          return v[(size_t)(i + 1 + di) * aw + j + 1 + dj];
        };
        int32_t a, b;
        int nb;
        if (pass == 1) {
          a = (at(A, 0, 0) + at(A, 0, -1) + at(A, 0, 1) + at(A, -1, 0) + at(A, 1, 0)) * 4 +
              (at(A, -1, -1) + at(A, -1, 1) + at(A, 1, -1) + at(A, 1, 1)) * 3;
          b = (at(B, 0, 0) + at(B, 0, -1) + at(B, 0, 1) + at(B, -1, 0) + at(B, 1, 0)) * 4 +
              (at(B, -1, -1) + at(B, -1, 1) + at(B, 1, -1) + at(B, 1, 1)) * 3;
          nb = 5;
        } else if (((i + odd) & 1) == 0) {  // between two kept rows
          a = (at(A, -1, 0) + at(A, 1, 0)) * 6 +
              (at(A, -1, -1) + at(A, 1, -1) + at(A, -1, 1) + at(A, 1, 1)) * 5;
          b = (at(B, -1, 0) + at(B, 1, 0)) * 6 +
              (at(B, -1, -1) + at(B, 1, -1) + at(B, -1, 1) + at(B, 1, 1)) * 5;
          nb = 5;
        } else {
          a = at(A, 0, 0) * 6 + (at(A, 0, -1) + at(A, 0, 1)) * 5;
          b = at(B, 0, 0) * 6 + (at(B, 0, -1) + at(B, 0, 1)) * 5;
          nb = 4;
        }
        int32_t v = a * src[(std::ptrdiff_t)i * ss + j] + b;
        int sh = 8 + nb - 4;
        flt[(size_t)i * w + j] = (v + (1 << (sh - 1))) >> sh;
      }
  }
};

// ------------------------------------------------------- film grain
// libaom's av1_add_film_grain on the output picture (the specification's
// film grain synthesis): the grain templates from the Gaussian sequence
// and the auto-regressive filter, 32x32 luma blocks at random offsets per
// 32-row stripe, blended over 2 samples (1 subsampled) where overlap_flag
// is set, scaled by the piecewise-linear lookup of each sample (chroma's
// of the luma average and itself) and clipped to the full or restricted
// range.
struct FilmGrainSynthesis {
  Decoder& d;
  const FilmGrain& g;
  int bd, gmin, gmax;
  uint16_t rnd = 0;
  explicit FilmGrainSynthesis(Decoder& dec)
      : d(dec), g(dec.h.grain), bd(dec.s.bit_depth) {
    gmin = -(128 << (bd - 8));
    gmax = (128 << (bd - 8)) - 1;
  }

  int random(int bits) {
    int bit = (rnd ^ (rnd >> 1) ^ (rnd >> 3) ^ (rnd >> 12)) & 1;
    rnd = (uint16_t)((rnd >> 1) | (bit << 15));
    return (rnd >> (16 - bits)) & ((1 << bits) - 1);
  }
  void seed_stripe(int luma_num) {
    rnd = (uint16_t)g.seed;
    rnd ^= (uint16_t)(((luma_num * 37 + 178) & 255) << 8);
    rnd ^= (uint16_t)((luma_num * 173 + 105) & 255);
  }
  static int round2s(int x, int n) { return n ? (x + (1 << (n - 1))) >> n : x; }

  // the 82x73 luma template, or the chroma ones (44 wide and 38 high where
  // subsampled)
  void templates(std::vector<int>* t, int cw, int ch) {
    int sx = d.s.ssx, sy = d.s.ssy;
    int shift = 12 - bd + g.grain_scale_shift;
    t[0].assign(82 * 73, 0);
    rnd = (uint16_t)g.seed;
    if (g.num_y)
      for (int i = 0; i < 82 * 73; i++) t[0][i] = round2s(kGaussianSequence[random(11)], shift);
    int lag = g.ar_lag, ar = g.ar_shift;
    if (g.num_y)
      for (int y = 3; y < 73; y++)
        for (int x = 3; x < 82 - 3; x++) {
          int sum = 0, pos = 0;
          for (int dy = -lag; dy <= 0; dy++)
            for (int dx = -lag; dx <= lag; dx++) {
              if (!dy && !dx) break;
              sum += t[0][(y + dy) * 82 + x + dx] * g.ar_y[pos++];
            }
          int& v = t[0][y * 82 + x];
          v = clip3(gmin, gmax, v + round2s(sum, ar));
        }
    if (d.num_planes == 1) return;
    bool on[2] = {g.num_cb || g.scaling_from_luma, g.num_cr || g.scaling_from_luma};
    for (int c = 0; c < 2; c++) {
      t[1 + c].assign((size_t)cw * ch, 0);
      if (!on[c]) continue;
      seed_stripe(c ? 11 : 7);
      for (int i = 0; i < cw * ch; i++) t[1 + c][i] = round2s(kGaussianSequence[random(11)], shift);
    }
    for (int y = 3; y < ch; y++)
      for (int x = 3; x < cw - 3; x++) {
        int sum[2] = {0, 0}, pos = 0;
        for (int dy = -lag; dy <= 0; dy++)
          for (int dx = -lag; dx <= lag; dx++) {
            if (!dy && !dx) {
              if (g.num_y) {
                int luma = 0, lx = ((x - 3) << sx) + 3, ly = ((y - 3) << sy) + 3;
                for (int i = 0; i <= sy; i++)
                  for (int j = 0; j <= sx; j++) luma += t[0][(ly + i) * 82 + lx + j];
                luma = round2s(luma, sx + sy);
                sum[0] += luma * g.ar_cb[pos];
                sum[1] += luma * g.ar_cr[pos];
              }
              break;
            }
            sum[0] += g.ar_cb[pos] * t[1][(y + dy) * cw + x + dx];
            sum[1] += g.ar_cr[pos] * t[2][(y + dy) * cw + x + dx];
            pos++;
          }
        for (int c = 0; c < 2; c++)
          if (on[c]) {
            int& v = t[1 + c][y * cw + x];
            v = clip3(gmin, gmax, v + round2s(sum[c], ar));
          }
      }
  }

  static void scaling_lut(const int (*pts)[2], int n, int* lut) {
    std::fill(lut, lut + 256, 0);
    if (!n) return;
    for (int i = 0; i < pts[0][0]; i++) lut[i] = pts[0][1];
    for (int i = 0; i < n - 1; i++) {
      int dy = pts[i + 1][1] - pts[i][1], dx = pts[i + 1][0] - pts[i][0];
      int64_t delta = (int64_t)dy * ((65536 + (dx >> 1)) / dx);
      for (int x = 0; x < dx; x++) lut[pts[i][0] + x] = pts[i][1] + (int)((x * delta + 32768) >> 16);
    }
    for (int i = pts[n - 1][0]; i < 256; i++) lut[i] = pts[n - 1][1];
  }
  int scale(const int* lut, int index) const {
    int shift = bd - 8, x = index >> shift;
    if (!shift || x == 255) return lut[x];
    return lut[x] + (((lut[x + 1] - lut[x]) * (index & ((1 << shift) - 1)) + (1 << (shift - 1))) >>
                     shift);
  }

  void run() {
    const int W = d.h.width, H = d.h.height, sx = d.s.ssx, sy = d.s.ssy;
    const int np = d.num_planes;
    const int cw = sx ? 44 : 82, ch = sy ? 38 : 73;
    std::vector<int> tmpl[3];
    templates(tmpl, cw, ch);
    // each plane's noise: the specification's noise stripes, blended
    std::vector<int> noise[3];
    int pw[3], ph[3];
    for (int p = 0; p < np; p++) {
      int psx = p ? sx : 0, psy = p ? sy : 0;
      pw[p] = (W + psx) >> psx;
      ph[p] = (H + psy) >> psy;
    }
    const int stripes = ((H + 1) / 2 + 15) / 16;
    std::vector<int> stripe[3];
    int sw[3], sh[3];
    for (int p = 0; p < np; p++) {
      int psx = p ? sx : 0, psy = p ? sy : 0;
      sw[p] = pw[p] + 34;
      sh[p] = 34 >> psy;
      stripe[p].assign((size_t)stripes * sh[p] * sw[p], 0);
    }
    for (int n = 0; n < stripes; n++) {
      seed_stripe(n);
      for (int x = 0; x < (W + 1) / 2; x += 16) {
        int r = random(8), ox = r >> 4, oy = r & 15;
        for (int p = 0; p < np; p++) {
          int psx = p ? sx : 0, psy = p ? sy : 0, tw = p ? cw : 82;
          int px0 = psx ? 6 + ox : 9 + ox * 2, py0 = psy ? 6 + oy : 9 + oy * 2;
          int* st = &stripe[p][(size_t)n * sh[p] * sw[p]];
          int base = x * 2 >> psx;
          for (int i = 0; i < (34 >> psy); i++)
            for (int j = 0; j < (34 >> psx); j++) {
              int v = tmpl[p][(py0 + i) * tw + px0 + j];
              int& old = st[(size_t)i * sw[p] + base + j];
              if (g.overlap && x > 0) {
                if (!psx && j < 2)
                  v = clip3(gmin, gmax, round2s(j ? old * 17 + v * 27 : old * 27 + v * 17, 5));
                else if (psx && j == 0)
                  v = clip3(gmin, gmax, round2s(old * 23 + v * 22, 5));
              }
              old = v;
            }
        }
      }
    }
    for (int p = 0; p < np; p++) {
      int psy = p ? sy : 0;
      noise[p].assign((size_t)pw[p] * ph[p], 0);
      for (int y = 0; y < ph[p]; y++) {
        int n = y >> (5 - psy), i = y - (n << (5 - psy));
        const int* st = &stripe[p][((size_t)n * sh[p] + i) * sw[p]];
        const int* prev = n ? &stripe[p][((size_t)(n - 1) * sh[p] + i + (32 >> psy)) * sw[p]]
                            : nullptr;
        for (int x = 0; x < pw[p]; x++) {
          int v = st[x];
          if (g.overlap && n > 0) {
            if (!psy && i < 2)
              v = clip3(gmin, gmax, round2s(i ? prev[x] * 17 + v * 27 : prev[x] * 27 + v * 17, 5));
            else if (psy && i == 0)
              v = clip3(gmin, gmax, round2s(prev[x] * 23 + v * 22, 5));
          }
          noise[p][(size_t)y * pw[p] + x] = v;
        }
      }
    }
    // scaling
    int lut[3][256];
    scaling_lut(g.y_points, g.num_y, lut[0]);
    if (g.scaling_from_luma) {
      std::copy(lut[0], lut[0] + 256, lut[1]);
      std::copy(lut[0], lut[0] + 256, lut[2]);
    } else {
      scaling_lut(g.cb_points, g.num_cb, lut[1]);
      scaling_lut(g.cr_points, g.num_cr, lut[2]);
    }
    int lo = 0, max_luma = (256 << (bd - 8)) - 1, max_chroma = max_luma;
    if (g.restricted) {
      lo = 16 << (bd - 8);
      max_luma = 235 << (bd - 8);
      max_chroma = d.s.mc == 0 ? max_luma : 240 << (bd - 8);
    }
    const int round = 1 << (g.scaling_shift - 1), top = (256 << (bd - 8)) - 1;
    Plane& Y = d.planes[0];
    if (np > 1) {
      int mult[2] = {g.cb_mult - 128, g.cr_mult - 128};
      int luma_mult[2] = {g.cb_luma_mult - 128, g.cr_luma_mult - 128};
      int offset[2] = {(g.cb_offset - 256) << (bd - 8), (g.cr_offset - 256) << (bd - 8)};
      if (g.scaling_from_luma)
        for (int c = 0; c < 2; c++) {
          mult[c] = 0;
          luma_mult[c] = 64;
          offset[c] = 0;
        }
      for (int c = 0; c < 2; c++) {
        if (!(c ? g.num_cr : g.num_cb) && !g.scaling_from_luma) continue;
        Plane& C = d.planes[1 + c];
        for (int y = 0; y < ph[1]; y++)
          for (int x = 0; x < pw[1]; x++) {
            const uint16_t* lrow = Y.row(y << sy);
            int lx = x << sx;
            int avg = sx ? (lrow[lx] + lrow[std::min(lx + 1, W - 1)] + 1) >> 1 : lrow[lx];
            int orig = C.at(y, x);
            int merged = clip3(0, top, ((avg * luma_mult[c] + mult[c] * orig) >> 6) + offset[c]);
            int nz = noise[1 + c][(size_t)y * pw[1] + x];
            C.at(y, x) = (uint16_t)clip3(
                lo, max_chroma, orig + ((scale(lut[1 + c], merged) * nz + round) >> g.scaling_shift));
          }
      }
    }
    if (g.num_y)
      for (int y = 0; y < H; y++)
        for (int x = 0; x < W; x++) {
          int orig = Y.at(y, x), nz = noise[0][(size_t)y * W + x];
          Y.at(y, x) = (uint16_t)clip3(
              lo, max_luma, orig + ((scale(lut[0], orig) * nz + round) >> g.scaling_shift));
        }
  }
};

// ------------------------------------------------------- OBUs
struct Picture {
  SequenceHeader seq;
  FrameHeader fh;
  Decoder* dec = nullptr;
  ~Picture() { delete dec; }
};

void decode_obus(const uint8_t* data, size_t n, Picture& pic) {
  size_t at = 0;
  int next_tile = 0;
  bool done = false;
  while (at < n && !done) {
    uint8_t hdr = data[at++];
    if (hdr & 0x80) bad("OBU header (forbidden bit)");
    int type = (hdr >> 3) & 15, ext = (hdr >> 2) & 1, has_size = (hdr >> 1) & 1;
    int temporal_id = 0, spatial_id = 0;
    if (ext) {
      if (at >= n) bad("OBU header (ends early)");
      temporal_id = data[at] >> 5;
      spatial_id = (data[at] >> 3) & 3;
      at++;
    }
    size_t size = has_size ? (size_t)leb128(data, n, &at) : n - at;
    if (size > n - at) bad("OBU (past the end of the data)");
    const uint8_t* obu = data + at;
    at += size;
    if (type != 1 && type != 2 && ext && pic.seq.seen && pic.seq.op_idc) {
      int in_t = (pic.seq.op_idc >> temporal_id) & 1;
      int in_s = (pic.seq.op_idc >> (spatial_id + 8)) & 1;
      if (!in_t || !in_s) continue;
    }
    if (type == 1) {
      Bits b(obu, size);
      parse_sequence_header(b, pic.seq);
    } else if (type == 3 || type == 6) {
      if (!pic.seq.seen) bad("frame header before a sequence header");
      if (pic.fh.seen) {
        if (type == 3) continue;  // a redundant copy
        bad("second frame");
      }
      Bits b(obu, size);
      parse_frame_header(b, pic.seq, pic.fh, temporal_id, spatial_id);
      if (pic.fh.width > 65536 || pic.fh.height > 65536) bad("frame size");
      pic.dec = new Decoder(pic.seq, pic.fh);
      if (type == 6) {
        b.byte_align();
        pic.dec->decode_tile_group(obu, size, b, &next_tile);
      }
    } else if (type == 4) {
      if (!pic.dec) bad("tile group before a frame header");
      Bits b(obu, size);
      pic.dec->decode_tile_group(obu, size, b, &next_tile);
    } else if (type == 8) {
      refuse("tile list OBU (large-scale tile decoding)");
    }
    if (pic.dec && next_tile == pic.fh.tile_cols * pic.fh.tile_rows) done = true;
  }
  if (!pic.dec) bad("data (no frame)");
  if (!done) bad("data (ends before the frame's last tile)");
  Decoder& dec = *pic.dec;
  LoopFilter(dec).run();
  bool lr = false;
  for (int p = 0; p < dec.num_planes; p++) lr = lr || pic.fh.lr_type[p] != RESTORE_NONE;
  std::vector<uint16_t> deblocked[3];
  if (lr)
    for (int p = 0; p < dec.num_planes; p++) deblocked[p] = dec.planes[p].px;
  Cdef(dec).run();
  if (lr) LoopRestoration(dec, deblocked).run();
  if (pic.fh.grain.apply) FilmGrainSynthesis(dec).run();
}

// ------------------------------------------------------- YUV -> RGB
// What OpenCV 5's AVIF reader gives for an 8-bit colour image: a
// monochrome image's Y plane (cut to 8 bits by convertTo, rounding half to
// even); otherwise libavif 1.4's avifImageYUVToRGB into 8-bit BGR with its
// default (automatic) chroma upsampling: libyuv's fixed-point conversion,
// after the planes are cut to 8 bits (Convert16To8Plane), for the matrices
// and ranges libyuv has constants for (BT.601 and unspecified, BT.709,
// BT.2020 NCL, chroma-derived NCL of their primaries; bilinear 4:2:0 and
// linear 4:2:2 upsampling), and libavif's own float conversion otherwise
// (identity, FCC, SMPTE 240M, YCgCo, chroma-derived NCL of other
// primaries, matrix coefficients 15; 9-3-3-1 bilinear 4:2:0 and
// duplicated 4:2:2 chroma).

// libyuv's YuvConstants (ub, ug, vg, vr, yg, yb) for full (J) and limited
// range, read from libyuv's kYuv*Constants
struct LibyuvConstants {
  int ub, ug, vg, vr, yg, yb;
};
const LibyuvConstants kJpeg = {113, 22, 46, 90, 16320, 32};
const LibyuvConstants kI601 = {128, 25, 52, 102, 18997, -1160};
const LibyuvConstants kF709 = {119, 12, 30, 101, 16320, 32};
const LibyuvConstants kH709 = {128, 14, 34, 115, 18997, -1160};
const LibyuvConstants kV2020 = {120, 11, 37, 94, 16320, 32};
const LibyuvConstants k2020 = {128, 12, 42, 107, 19003, -1160};

inline uint8_t clamp255(int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); }

// libyuv's YuvPixel (x86 form)
inline void yuv_pixel(int y, int u, int v, const LibyuvConstants& k, uint8_t* rgb) {
  uint32_t y32 = (uint32_t)y * 0x0101;
  int32_t y1 = (int32_t)(((uint32_t)(y32 * (uint32_t)k.yg)) >> 16) + k.yb;
  int ui = (int8_t)(uint8_t)(u - 0x80), vi = (int8_t)(uint8_t)(v - 0x80);
  rgb[2] = clamp255((y1 + ui * k.ub) >> 6);
  rgb[1] = clamp255((y1 - (ui * k.ug + vi * k.vg)) >> 6);
  rgb[0] = clamp255((y1 + vi * k.vr) >> 6);
}

// libyuv's ScaleRowUp2_Linear_Any and ScaleRowUp2_Bilinear_Any: a chroma
// row (or two, s then t) upsampled to width
void up2_linear(const uint8_t* s, uint8_t* d, int width) {
  d[0] = s[0];
  int work = (width - 1) & ~1;
  for (int x = 0; x < work / 2; x++) {
    d[2 * x + 1] = (uint8_t)((s[x] * 3 + s[x + 1] + 2) >> 2);
    d[2 * x + 2] = (uint8_t)((s[x] + s[x + 1] * 3 + 2) >> 2);
  }
  d[width - 1] = s[(width - 1) / 2];
}
void up2_bilinear(const uint8_t* s, const uint8_t* t, uint8_t* d, uint8_t* e, int width) {
  d[0] = (uint8_t)((3 * s[0] + t[0] + 2) >> 2);
  e[0] = (uint8_t)((s[0] + 3 * t[0] + 2) >> 2);
  int work = (width - 1) & ~1;
  for (int x = 0; x < work / 2; x++) {
    d[2 * x + 1] = (uint8_t)((s[x] * 9 + s[x + 1] * 3 + t[x] * 3 + t[x + 1] + 8) >> 4);
    d[2 * x + 2] = (uint8_t)((s[x] * 3 + s[x + 1] * 9 + t[x] + t[x + 1] * 3 + 8) >> 4);
    e[2 * x + 1] = (uint8_t)((s[x] * 3 + s[x + 1] + t[x] * 9 + t[x + 1] * 3 + 8) >> 4);
    e[2 * x + 2] = (uint8_t)((s[x] + s[x + 1] * 3 + t[x] * 3 + t[x + 1] * 9 + 8) >> 4);
  }
  int l = (width - 1) / 2;
  d[width - 1] = (uint8_t)((3 * s[l] + t[l] + 2) >> 2);
  e[width - 1] = (uint8_t)((s[l] + 3 * t[l] + 2) >> 2);
}

struct YuvImage {
  const uint16_t* p[3];
  int w, h, depth, ssx, ssy, cp, mc, full;
  int cw() const { return (w + ssx) >> ssx; }
  int ch() const { return (h + ssy) >> ssy; }
};

void libyuv_to_rgb(const YuvImage& im, const LibyuvConstants& k, uint8_t* rgb) {
  int w = im.w, h = im.h, cw = im.cw(), ch = im.ch(), shift = im.depth - 8;
  // Convert16To8Plane for 10 and 12 bits: (v * (1 << (24 - depth))) >> 16
  std::vector<uint8_t> y8((size_t)w * h), u8((size_t)cw * ch), v8((size_t)cw * ch);
  for (size_t i = 0; i < y8.size(); i++) y8[i] = clamp255(im.p[0][i] >> shift);
  for (size_t i = 0; i < u8.size(); i++) {
    u8[i] = clamp255(im.p[1][i] >> shift);
    v8[i] = clamp255(im.p[2][i] >> shift);
  }
  std::vector<uint8_t> ur[2], vr[2];
  for (int i = 0; i < 2; i++) {
    ur[i].resize(w);
    vr[i].resize(w);
  }
  auto row_out = [&](int y, const uint8_t* u, const uint8_t* v) {
    const uint8_t* yr = &y8[(size_t)y * w];
    uint8_t* o = rgb + (size_t)y * w * 3;
    for (int x = 0; x < w; x++) yuv_pixel(yr[x], u[x], v[x], k, o + 3 * x);
  };
  if (!im.ssx) {  // 4:4:4
    for (int y = 0; y < h; y++) row_out(y, &u8[(size_t)y * cw], &v8[(size_t)y * cw]);
  } else if (!im.ssy) {  // 4:2:2, linear
    for (int y = 0; y < h; y++) {
      up2_linear(&u8[(size_t)y * cw], ur[0].data(), w);
      up2_linear(&v8[(size_t)y * cw], vr[0].data(), w);
      row_out(y, ur[0].data(), vr[0].data());
    }
  } else {  // 4:2:0, bilinear (I420ToARGBMatrixBilinear)
    const uint8_t* su = u8.data();
    const uint8_t* sv = v8.data();
    up2_bilinear(su, su, ur[0].data(), ur[1].data(), w);
    up2_bilinear(sv, sv, vr[0].data(), vr[1].data(), w);
    row_out(0, ur[0].data(), vr[0].data());
    int y = 1;
    for (int r = 0; r < h - 2; r += 2) {
      up2_bilinear(su, su + cw, ur[0].data(), ur[1].data(), w);
      up2_bilinear(sv, sv + cw, vr[0].data(), vr[1].data(), w);
      row_out(y++, ur[0].data(), vr[0].data());
      row_out(y++, ur[1].data(), vr[1].data());
      su += cw;
      sv += cw;
    }
    if (!(h & 1)) {
      up2_bilinear(su, su, ur[0].data(), ur[1].data(), w);
      up2_bilinear(sv, sv, vr[0].data(), vr[1].data(), w);
      row_out(y, ur[0].data(), vr[0].data());
    }
  }
}

// libavif's colour primaries (rX, rY, gX, gY, bX, bY, wX, wY) by their
// CICP code; any code the table lacks reads as BT.709's
const float kPrimaries[][9] = {
    {1, 0.64f, 0.33f, 0.3f, 0.6f, 0.15f, 0.06f, 0.3127f, 0.329f},
    {4, 0.67f, 0.33f, 0.21f, 0.71f, 0.14f, 0.08f, 0.310f, 0.316f},
    {5, 0.64f, 0.33f, 0.29f, 0.60f, 0.15f, 0.06f, 0.3127f, 0.3290f},
    {6, 0.630f, 0.340f, 0.310f, 0.595f, 0.155f, 0.070f, 0.3127f, 0.3290f},
    {7, 0.630f, 0.340f, 0.310f, 0.595f, 0.155f, 0.070f, 0.3127f, 0.3290f},
    {8, 0.681f, 0.319f, 0.243f, 0.692f, 0.145f, 0.049f, 0.310f, 0.316f},
    {9, 0.708f, 0.292f, 0.170f, 0.797f, 0.131f, 0.046f, 0.3127f, 0.3290f},
    {10, 1.0f, 0.0f, 0.0f, 1.0f, 0.0f, 0.0f, 0.3333f, 0.3333f},
    {11, 0.680f, 0.320f, 0.265f, 0.690f, 0.150f, 0.060f, 0.314f, 0.351f},
    {12, 0.680f, 0.320f, 0.265f, 0.690f, 0.150f, 0.060f, 0.3127f, 0.3290f},
    {22, 0.630f, 0.340f, 0.295f, 0.605f, 0.155f, 0.077f, 0.3127f, 0.3290f},
};

// Kr and Kb of chroma-derived NCL (H.273 E.2.2) from primaries cp, in
// float32 as libavif's avifColorPrimariesComputeYCoeffs computes them
void chroma_derived_coeffs(int cp, float& kr, float& kb) {
  const float* p = kPrimaries[0] + 1;
  for (const auto& row : kPrimaries)
    if ((int)row[0] == cp) p = row + 1;
  float rX = p[0], rY = p[1], gX = p[2], gY = p[3], bX = p[4], bY = p[5], wX = p[6], wY = p[7];
  float rZ = 1.0f - (rX + rY), gZ = 1.0f - (gX + gY), bZ = 1.0f - (bX + bY);
  float wZ = 1.0f - (wX + wY);
  float den = wY * (rX * (gY * bZ - bY * gZ) + gX * (bY * rZ - rY * bZ) + bX * (rY * gZ - gY * rZ));
  kr = (rY * (wX * (gY * bZ - bY * gZ) + wY * (bX * gZ - gX * bZ) + wZ * (gX * bY - bX * gY))) / den;
  kb = (bY * (wX * (rY * gZ - gY * rZ) + wY * (gX * rZ - rX * gZ) + wZ * (rX * gY - gX * rY))) / den;
}

// libavif's avifImageYUVAnyToRGBAnySlow (and its fast paths, the same
// arithmetic without upsampling), in float32: Kr and Kb of the matrix
// (BT.601's for a code its table lacks, such as 15), or of the primaries
// for chroma-derived NCL
void builtin_to_rgb(const YuvImage& im, uint8_t* rgb) {
  int maxc = (1 << im.depth) - 1;
  bool identity = im.mc == 0;
  float kr = 0.299f, kb = 0.114f;
  if (im.mc == 1) {
    kr = 0.2126f;
    kb = 0.0722f;
  } else if (im.mc == 4) {
    kr = 0.30f;
    kb = 0.11f;
  } else if (im.mc == 7) {
    kr = 0.212f;
    kb = 0.087f;
  } else if (im.mc == 9) {
    kr = 0.2627f;
    kb = 0.0593f;
  } else if (im.mc == 12) {
    chroma_derived_coeffs(im.cp, kr, kb);
  }
  float kg = 1.0f - kr - kb;
  float bias_y, bias_uv, range_y, range_uv;
  if (im.full) {
    bias_y = 0.0f;
    bias_uv = (float)(1 << (im.depth - 1));
    range_y = range_uv = (float)maxc;
  } else {
    bias_y = (float)(16 << (im.depth - 8));
    bias_uv = (float)(1 << (im.depth - 1));
    range_y = (float)(219 << (im.depth - 8));
    range_uv = (float)(224 << (im.depth - 8));
  }
  std::vector<float> ty(maxc + 1), tuv(maxc + 1);
  for (int c = 0; c <= maxc; c++) {
    ty[c] = ((float)c - bias_y) / range_y;
    tuv[c] = identity ? ty[c] : ((float)c - bias_uv) / range_uv;
  }
  int w = im.w, h = im.h, cw = im.cw();
  bool bilinear = im.ssx || im.ssy;
  for (int j = 0; j < h; j++) {
    int uj = j >> im.ssy;
    for (int i = 0; i < w; i++) {
      int ui = i >> im.ssx;
      float Y = ty[std::min<int>(im.p[0][(size_t)j * w + i], maxc)];
      float cb, cr;
      auto at = [&](int p, int dr, int dc) {
        return std::min<int>(im.p[p][(size_t)(uj + dr) * cw + ui + dc], maxc);
      };
      if (!bilinear) {
        cb = tuv[at(1, 0, 0)];
        cr = tuv[at(2, 0, 0)];
      } else {
        int adj_c, adj_r;
        if (i == 0 || (i == w - 1 && (i % 2) != 0))
          adj_c = 0;
        else
          adj_c = (i % 2) != 0 ? 1 : -1;
        if (j == 0 || (j == h - 1 && (j % 2) != 0) || !im.ssy)
          adj_r = 0;
        else
          adj_r = (j % 2) != 0 ? 1 : -1;
        float f[2];
        for (int p = 1; p <= 2; p++)
          f[p - 1] = tuv[at(p, 0, 0)] * (9.0f / 16.0f) + tuv[at(p, 0, adj_c)] * (3.0f / 16.0f) +
                     tuv[at(p, adj_r, 0)] * (3.0f / 16.0f) +
                     tuv[at(p, adj_r, adj_c)] * (1.0f / 16.0f);
        cb = f[0];
        cr = f[1];
      }
      float R, G, B;
      if (identity) {
        G = Y;
        B = cb;
        R = cr;
      } else if (im.mc == 8) {  // YCgCo
        float t = Y - cb;
        G = Y + cb;
        B = t - cr;
        R = t + cr;
      } else {
        R = Y + (2 * (1 - kr)) * cr;
        B = Y + (2 * (1 - kb)) * cb;
        G = Y - ((2 * ((kr * (1 - kr) * cr) + (kb * (1 - kb) * cb))) / kg);
      }
      float c3[3] = {R, G, B};
      uint8_t* o = rgb + ((size_t)j * w + i) * 3;
      for (int c = 0; c < 3; c++) {
        float v = c3[c] < 0.0f ? 0.0f : c3[c] > 1.0f ? 1.0f : c3[c];
        o[c] = (uint8_t)(0.5f + v * 255.0f);
      }
    }
  }
}

void yuv_to_rgb(const YuvImage& im, bool mono, uint8_t* rgb) {
  size_t n = (size_t)im.w * im.h;
  if (mono) {
    int s = im.depth - 8;
    for (size_t i = 0; i < n; i++) {
      int v = im.p[0][i];
      if (s) v = (v + (1 << (s - 1)) - 1 + ((v >> s) & 1)) >> s;  // half to even
      uint8_t b = clamp255(v);
      rgb[3 * i] = rgb[3 * i + 1] = rgb[3 * i + 2] = b;
    }
    return;
  }
  const LibyuvConstants* k = nullptr;
  int mc = im.mc;
  if (mc == 12) {  // chroma-derived NCL: libyuv's constants by primaries
    if (im.cp == 1 || im.cp == 2)
      mc = 1;
    else if (im.cp == 5 || im.cp == 6)
      mc = 6;
    else if (im.cp == 9)
      mc = 9;
  }
  switch (mc) {
    case 1: k = im.full ? &kF709 : &kH709; break;
    case 2: case 5: case 6: k = im.full ? &kJpeg : &kI601; break;
    case 9: k = im.full ? &kV2020 : &k2020; break;
    case 0:
      if (im.ssx || im.ssy) refuse("identity matrix of subsampled chroma");
      break;
    case 8:
      if (!im.full) refuse("YCgCo of limited range");
      break;
    case 4: case 7: case 12: case 15: break;
    default:
      refuse("matrix coefficients " + std::to_string(im.mc) + " (not converted to RGB)");
  }
  if (k)
    libyuv_to_rgb(im, *k, rgb);
  else if (im.mc == 0 && im.depth == 8 && !im.ssx && im.full) {
    for (size_t i = 0; i < n; i++) {  // avifImageIdentity8ToRGB8ColorFullRange
      rgb[3 * i] = (uint8_t)im.p[2][i];
      rgb[3 * i + 1] = (uint8_t)im.p[0][i];
      rgb[3 * i + 2] = (uint8_t)im.p[1][i];
    }
  } else {
    builtin_to_rgb(im, rgb);
  }
}

// ------------------------------------------------------- ispe scaling
// libavif's avifImageScale, which libavif runs on a decoded image whose
// ispe is not its frame's size: each plane (chroma at its subsampled size)
// through libyuv's ScalePlane (8 bits) or ScalePlane_12 (10 and 12) with
// kFilterBox.  libyuv reduces the filter by the two sizes
// (ScaleFilterReduce) and picks a routine by their ratio: 1/2 (2x2 box),
// 1/4 (4x4 box), 3/4 and 3/8 (their box rows), a general box below 1/2,
// 2x up (9-3-3-1 bilinear, or linear across), bilinear up or down, a
// vertical-only filter where the width is kept, or point sampling.  The
// 8-bit rows are those libyuv runs on an x86-64 CPU with SSSE3: bilinear
// columns in 7-bit fractions, and the 3/4 and 3/8 rows averaging their
// source rows before the horizontal filter over each whole 24 (3/4) or 6
// (3/8) outputs of a row, in libyuv's C arithmetic for the rest of it.
enum Filter { kNone, kLinear, kBilinear, kBox };

Filter filter_reduce(int sw, int sh, int dw, int dh, Filter f) {
  if (f == kBox && (dw * 2 >= sw || dh * 2 >= sh)) f = kBilinear;
  if (f == kBilinear) {
    if (sh == 1 || dh == sh || dh * 3 == sh) f = kLinear;
    if (sw == 1) f = kNone;
  }
  if (f == kLinear && (sw == 1 || dw == sw || dw * 3 == sw)) f = kNone;
  return f;
}

int fixed_div(int num, int div) { return (int)(((int64_t)num << 16) / div); }
int fixed_div1(int num, int div) { return (int)((((int64_t)num << 16) - 0x00010001) / (div - 1)); }
int center_start(int dx, int s) { return dx < 0 ? -((-dx >> 1) + s) : (dx >> 1) + s; }

// libyuv's ScaleSlope: the first source position and the step, 16.16
void scale_slope(int sw, int sh, int dw, int dh, Filter f, int& x, int& y, int& dx, int& dy) {
  x = y = dx = dy = 0;
  if (dw == 1 && sw >= 32768) dw = sw;
  if (dh == 1 && sh >= 32768) dh = sh;
  if (f == kBox) {
    dx = fixed_div(sw, dw);
    dy = fixed_div(sh, dh);
  } else if (f == kBilinear || f == kLinear) {
    if (dw <= sw) {
      dx = fixed_div(sw, dw);
      x = center_start(dx, -32768);
    } else if (sw > 1 && dw > 1) {
      dx = fixed_div1(sw, dw);
    }
    if (f == kLinear) {
      dy = fixed_div(sh, dh);
      y = dy >> 1;
    } else if (dh <= sh) {
      dy = fixed_div(sh, dh);
      y = center_start(dy, -32768);
    } else if (sh > 1 && dh > 1) {
      dy = fixed_div1(sh, dh);
    }
  } else {
    dx = fixed_div(sw, dw);
    dy = fixed_div(sh, dh);
    x = center_start(dx, 0);
    y = center_start(dy, 0);
  }
}

inline int avg2(int a, int b) { return (a + b + 1) >> 1; }

// One plane of T (uint8_t for 8 bits, uint16_t above) scaled from sw x sh
// at src to dw x dh at dst, rows packed.
template <typename T>
struct PlaneScaler {
  static constexpr bool k8 = sizeof(T) == 1;
  const T* src;
  int sw, sh;
  T* dst;
  int dw, dh;

  // InterpolateRow: row s and the one `stride` after it, weighted f / 256
  static void interpolate(T* d, const T* s, ptrdiff_t stride, int n, int f) {
    const T* t = s + stride;
    if (f == 0) {
      memcpy(d, s, sizeof(T) * (size_t)n);
    } else if (f == 128) {
      for (int i = 0; i < n; i++) d[i] = (T)avg2(s[i], t[i]);
    } else {
      for (int i = 0; i < n; i++) d[i] = (T)((s[i] * (256 - f) + t[i] * f + 128) >> 8);
    }
  }

  // ScaleFilterCols (ScaleFilterCols_SSSE3's 7-bit blend at 8 bits,
  // ScaleFilterCols_16_C's 16-bit one above); ScaleCols without filtering
  void cols(T* d, const T* s, int n, int x, int dx, bool filter) const {
    for (int j = 0; j < n; j++, x += dx) {
      int xi = x >> 16, a = s[xi];
      if (!filter) {
        d[j] = (T)a;
        continue;
      }
      int b = s[std::min(xi + 1, sw - 1)];
      if (k8) {
        int f = (x >> 9) & 127;
        d[j] = (T)((a * (128 - f) + b * f + 64) >> 7);
      } else {
        d[j] = (T)(a + (int)(((int64_t)(x & 65535) * (b - a) + 0x8000) >> 16));
      }
    }
  }

  const T* row(int r) const { return src + (size_t)r * sw; }
  T* out(int r) const { return dst + (size_t)r * dw; }

  // ScalePlaneVertical: the width kept
  void vertical(Filter f) {
    int y = 0, dy = 0;
    if (dh <= sh) {
      dy = fixed_div(sh, dh);
      y = center_start(dy, -32768);
    } else if (sh > 1 && dh > 1) {
      dy = fixed_div1(sh, dh);
    }
    int max_y = sh > 1 ? ((sh - 1) << 16) - 1 : 0;
    for (int j = 0; j < dh; j++, y += dy) {
      if (y > max_y) y = max_y;
      interpolate(out(j), row(y >> 16), sw, dw, f ? (y >> 8) & 255 : 0);
    }
  }

  // The 1/2, 1/4, 3/4 and 3/8 routines below are reached with a filter
  // (kFilterBox reduces to bilinear at 1/2 and 3/4, stays a box at 1/4
  // and 3/8), so only their box rows are written.
  void down2() {
    for (int j = 0; j < dh; j++) {
      const T* s = row(2 * j);
      const T* t = s + sw;
      T* d = out(j);
      for (int i = 0; i < dw; i++)
        d[i] = (T)((s[2 * i] + s[2 * i + 1] + t[2 * i] + t[2 * i + 1] + 2) >> 2);
    }
  }

  void down4() {
    for (int j = 0; j < dh; j++) {
      const T* s = row(4 * j);
      T* d = out(j);
      for (int i = 0; i < dw; i++) {
        int sum = 0;
        for (int r = 0; r < 4; r++)
          for (int c = 0; c < 4; c++) sum += s[(size_t)r * sw + 4 * i + c];
        d[i] = (T)((sum + 8) >> 4);
      }
    }
  }

  // ScaleRowDown34_0_Box (first: rows weighted 3:1) and _1_Box (1:1) of
  // row s and the one `stride` after it
  static void row34(const T* s, ptrdiff_t stride, T* d, int n, bool first) {
    const T* t = s + stride;
    int head = k8 ? n - n % 24 : 0;
    for (int x = 0; x < n; x += 3, s += 4, t += 4, d += 3) {
      if (x < head) {  // SSSE3: pavgb of the rows, then across
        int v[4];
        for (int k = 0; k < 4; k++) v[k] = first ? avg2(s[k], avg2(s[k], t[k])) : avg2(s[k], t[k]);
        d[0] = (T)((v[0] * 3 + v[1] + 2) >> 2);
        d[1] = (T)avg2(v[1], v[2]);
        d[2] = (T)((v[2] + v[3] * 3 + 2) >> 2);
      } else {  // C: across, then the rows
        int a[3] = {(s[0] * 3 + s[1] + 2) >> 2, avg2(s[1], s[2]), (s[2] + s[3] * 3 + 2) >> 2};
        int b[3] = {(t[0] * 3 + t[1] + 2) >> 2, avg2(t[1], t[2]), (t[2] + t[3] * 3 + 2) >> 2};
        for (int k = 0; k < 3; k++) d[k] = (T)(first ? (a[k] * 3 + b[k] + 2) >> 2 : avg2(a[k], b[k]));
      }
    }
  }

  void down34() {
    const T* s = src;
    int j = 0;
    for (; j < dh - 2; j += 3) {
      row34(s, sw, out(j), dw, true);
      s += sw;
      row34(s, sw, out(j + 1), dw, false);
      s += sw;
      row34(s + sw, -sw, out(j + 2), dw, true);
      s += 2 * sw;
    }
    if (dh % 3 == 2) {
      row34(s, sw, out(j), dw, true);
      row34(s + sw, 0, out(j + 1), dw, false);
    } else if (dh % 3 == 1) {
      row34(s, 0, out(j), dw, true);
    }
  }

  // ScaleRowDown38_3_Box (three rows) and _2_Box (two) from row s
  static void row38(const T* s, ptrdiff_t stride, T* d, int n, int rows) {
    int head = k8 && rows == 2 ? n - n % 6 : 0;
    for (int x = 0; x < n; x += 3, s += 8, d += 3) {
      for (int k = 0; k < 3; k++) {
        int c0 = 3 * k, w = k < 2 ? 3 : 2;
        uint32_t sum = 0;
        if (x < head) {  // SSSE3: pavgb of the two rows, then across
          for (int c = 0; c < w; c++) sum += avg2(s[c0 + c], s[c0 + c + stride]);
          d[k] = (T)((sum * (uint32_t)(65536 / w)) >> 16);
        } else {
          for (int r = 0; r < rows; r++)
            for (int c = 0; c < w; c++) sum += s[c0 + c + r * stride];
          d[k] = (T)((sum * (uint32_t)(65536 / (w * rows))) >> 16);
        }
      }
    }
  }

  void down38() {
    const T* s = src;
    int j = 0;
    for (; j < dh - 2; j += 3) {
      row38(s, sw, out(j), dw, 3);
      s += 3 * sw;
      row38(s, sw, out(j + 1), dw, 3);
      s += 3 * sw;
      row38(s, sw, out(j + 2), dw, 2);
      s += 2 * sw;
    }
    if (dh % 3 == 2) {
      row38(s, sw, out(j), dw, 3);
      row38(s + 3 * sw, 0, out(j + 1), dw, 3);
    } else if (dh % 3 == 1) {
      row38(s, 0, out(j), dw, 3);
    }
  }

  // ScalePlaneBox: each output the mean of its box of sources, through
  // 16-bit (8-bit samples) or 32-bit row sums and a 16.16 reciprocal
  void box() {
    using Acc = typename std::conditional<k8, uint16_t, uint32_t>::type;
    int x, y, dx, dy;
    scale_slope(sw, sh, dw, dh, kBox, x, y, dx, dy);
    int max_y = sh << 16;
    std::vector<Acc> sums(sw);
    for (int j = 0; j < dh; j++) {
      int iy = y >> 16;
      y = std::min(y + dy, max_y);
      int bh = std::max((y >> 16) - iy, 1);
      std::fill(sums.begin(), sums.end(), (Acc)0);
      for (int k = 0; k < bh; k++) {
        const T* s = row(iy + k);
        for (int i = 0; i < sw; i++) sums[i] = (Acc)(sums[i] + s[i]);
      }
      T* d = out(j);
      int minw = dx >> 16, xx = x;
      if (dx & 0xffff) {  // ScaleAddCols2: boxes of minw or minw + 1
        int scale[2] = {65536 / (std::max(minw, 1) * bh), 65536 / (std::max(minw + 1, 1) * bh)};
        for (int i = 0; i < dw; i++) {
          int ix = xx >> 16;
          xx += dx;
          int bw = std::max((xx >> 16) - ix, 1);
          uint32_t sum = 0;
          for (int c = 0; c < bw; c++) sum += sums[ix + c];
          d[i] = (T)((sum * (uint32_t)scale[bw - minw]) >> 16);
        }
      } else {  // ScaleAddCols1 (and ScaleAddCols0 at a step of 1)
        int bw = std::max(minw, 1), scale = 65536 / (bw * bh), ix = xx >> 16;
        for (int i = 0; i < dw; i++, ix += bw) {
          uint32_t sum = 0;
          for (int c = 0; c < bw; c++) sum += sums[ix + c];
          d[i] = (T)((sum * (uint32_t)scale) >> 16);
        }
      }
    }
  }

  // ScalePlaneUp2_Linear (across only) and ScalePlaneUp2_Bilinear
  void up2_linear() {
    int dy = dh == 1 ? 0 : fixed_div(sh - 1, dh - 1), y = dh == 1 ? ((sh - 1) / 2) << 16 : 32767;
    for (int j = 0; j < dh; j++, y += dy) up2_row(row(y >> 16), row(y >> 16), out(j), nullptr, dw);
  }
  void up2_bilinear() {
    up2_row(row(0), row(0), out(0), nullptr, dw);
    for (int r = 0; r < sh - 1; r++) up2_row(row(r), row(r + 1), out(2 * r + 1), out(2 * r + 2), dw);
    if (!(dh & 1)) up2_row(row(sh - 1), row(sh - 1), out(dh - 1), nullptr, dw);
  }
  // ScaleRowUp2_Linear_Any (t == s, no e) and ScaleRowUp2_Bilinear_Any:
  // row s (and t below it) to d (and e)
  static void up2_row(const T* s, const T* t, T* d, T* e, int width) {
    int work = (width - 1) & ~1, l = (width - 1) / 2;
    if (!e) {
      d[0] = s[0];
      for (int x = 0; x < work / 2; x++) {
        d[2 * x + 1] = (T)((s[x] * 3 + s[x + 1] + 2) >> 2);
        d[2 * x + 2] = (T)((s[x] + s[x + 1] * 3 + 2) >> 2);
      }
      d[width - 1] = s[l];
      return;
    }
    d[0] = (T)((3 * s[0] + t[0] + 2) >> 2);
    e[0] = (T)((s[0] + 3 * t[0] + 2) >> 2);
    for (int x = 0; x < work / 2; x++) {
      d[2 * x + 1] = (T)((s[x] * 9 + s[x + 1] * 3 + t[x] * 3 + t[x + 1] + 8) >> 4);
      d[2 * x + 2] = (T)((s[x] * 3 + s[x + 1] * 9 + t[x] + t[x + 1] * 3 + 8) >> 4);
      e[2 * x + 1] = (T)((s[x] * 3 + s[x + 1] + t[x] * 9 + t[x + 1] * 3 + 8) >> 4);
      e[2 * x + 2] = (T)((s[x] + s[x + 1] * 3 + t[x] * 3 + t[x + 1] * 9 + 8) >> 4);
    }
    d[width - 1] = (T)((3 * s[l] + t[l] + 2) >> 2);
    e[width - 1] = (T)((s[l] + 3 * t[l] + 2) >> 2);
  }

  // ScalePlaneBilinearUp: two filtered rows of the source kept, the
  // output rows interpolated between them
  void bilinear_up(Filter f) {
    int x, y, dx, dy;
    scale_slope(sw, sh, dw, dh, f, x, y, dx, dy);
    int max_y = (sh - 1) << 16;
    if (y > max_y) y = max_y;
    int yi = y >> 16, lasty = yi;
    const T* s = row(yi);
    std::vector<T> rows(2 * (size_t)dw);
    T* rowptr = rows.data();
    ptrdiff_t rowstride = dw;
    cols(rowptr, s, dw, x, dx, true);
    if (sh > 1) s += sw;
    cols(rowptr + rowstride, s, dw, x, dx, true);
    if (sh > 2) s += sw;
    for (int j = 0; j < dh; j++, y += dy) {
      yi = y >> 16;
      if (yi != lasty) {
        if (y > max_y) {
          y = max_y;
          yi = y >> 16;
          s = row(yi);
        }
        if (yi != lasty) {
          cols(rowptr, s, dw, x, dx, true);
          rowptr += rowstride;
          rowstride = -rowstride;
          lasty = yi;
          if (y + 65536 < max_y) s += sw;
        }
      }
      if (f == kLinear)
        interpolate(out(j), rowptr, 0, dw, 0);
      else
        interpolate(out(j), rowptr, rowstride, dw, (y >> 8) & 255);
    }
  }

  // ScalePlaneBilinearDown: each output row from two source rows blended,
  // then filtered across
  void bilinear_down(Filter f) {
    int x, y, dx, dy;
    scale_slope(sw, sh, dw, dh, f, x, y, dx, dy);
    int max_y = (sh - 1) << 16;
    std::vector<T> tmp(sw);
    if (y > max_y) y = max_y;
    for (int j = 0; j < dh; j++) {
      const T* s = row(y >> 16);
      if (f == kLinear) {
        cols(out(j), s, dw, x, dx, true);
      } else {
        interpolate(tmp.data(), s, sw, sw, (y >> 8) & 255);
        cols(out(j), tmp.data(), dw, x, dx, true);
      }
      y = std::min(y + dy, max_y);
    }
  }

  void simple() {
    int x, y, dx, dy;
    scale_slope(sw, sh, dw, dh, kNone, x, y, dx, dy);
    for (int j = 0; j < dh; j++, y += dy) cols(out(j), row(y >> 16), dw, x, dx, false);
  }

  // ScalePlane's (and ScalePlane_12's) choice of routine
  void run() {
    Filter f = filter_reduce(sw, sh, dw, dh, kBox);
    if (dw == sw && dh == sh) {
      memcpy(dst, src, sizeof(T) * (size_t)sw * sh);
    } else if (dw == sw && f != kBox) {
      vertical(f);
    } else if (4 * dw == 3 * sw && 4 * dh == 3 * sh) {
      down34();
    } else if (2 * dw == sw && 2 * dh == sh) {
      down2();
    } else if (8 * dw == 3 * sw && 8 * dh == 3 * sh) {
      down38();
    } else if (4 * dw == sw && 4 * dh == sh) {
      down4();
    } else if (f == kBox && dh * 2 < sh) {
      box();
    } else if ((dw + 1) / 2 == sw && f == kLinear) {
      up2_linear();
    } else if ((dw + 1) / 2 == sw && (dh + 1) / 2 == sh && (f == kBilinear || f == kBox)) {
      up2_bilinear();
    } else if (f != kNone && dh > sh) {
      bilinear_up(f);
    } else if (f != kNone) {
      bilinear_down(f);
    } else {
      simple();
    }
  }
};

int report(const Error& e, char* err, int errlen) {
  if (err && errlen > 0) snprintf(err, (size_t)errlen, "%s", e.msg.c_str());
  return e.code;
}

}  // namespace

extern "C" {

// Decode the OBUs of one AV1 still image into a picture (*handle, freed by
// thc_av1_release); meta (25): width, height, bit depth, monochrome,
// subsampling x, y, colour primaries, transfer, matrix, full range; per
// plane the loop restoration type (0 none, 1 Wiener, 2 self-guided, 3
// switchable), its unit size, and the unit types read (bit 1 << type);
// whether film grain was applied; allow_screen_content_tools,
// allow_intrabc, and the count of blocks with a Y palette, with a UV
// palette, and of IntraBC blocks.
int thc_av1_decode(const uint8_t* data, int64_t n, void** handle, int32_t* meta, char* err,
                   int errlen) {
  Picture* pic = new Picture();
  try {
    decode_obus(data, (size_t)n, *pic);
    const SequenceHeader& s = pic->seq;
    const FrameHeader& fh = pic->fh;
    const Decoder& d = *pic->dec;
    int32_t m[25] = {fh.width, fh.height, s.bit_depth, s.mono, s.ssx, s.ssy, s.cp, s.tc,
                     s.mc, s.full_range};
    for (int p = 0; p < 3; p++) {
      m[10 + p] = fh.lr_type[p];
      m[13 + p] = fh.lr_unit_size[p];
      m[16 + p] = d.lr_read_types[p];
    }
    m[19] = fh.grain.apply;
    m[20] = fh.screen_content;
    m[21] = fh.allow_intrabc;
    m[22] = d.palette_blocks[0];
    m[23] = d.palette_blocks[1];
    m[24] = d.intrabc_blocks;
    memcpy(meta, m, sizeof(m));
    *handle = pic;
    return 0;
  } catch (const Error& e) {
    delete pic;
    return report(e, err, errlen);
  } catch (const std::exception& e) {
    delete pic;
    return report(Error{kErrFormat, e.what()}, err, errlen);
  }
}

// Copy the picture's planes, cropped to its size, into y (height x width)
// and u, v (the subsampled size; not written for a monochrome picture).
void thc_av1_planes(void* handle, uint16_t* y, uint16_t* u, uint16_t* v) {
  Picture* pic = (Picture*)handle;
  Decoder& d = *pic->dec;
  uint16_t* out[3] = {y, u, v};
  for (int p = 0; p < d.num_planes; p++) {
    int sx = p ? pic->seq.ssx : 0, sy = p ? pic->seq.ssy : 0;
    int w = (pic->fh.width + sx) >> sx, h = (pic->fh.height + sy) >> sy;
    for (int r = 0; r < h; r++) memcpy(out[p] + (size_t)r * w, d.planes[p].row(r), 2 * (size_t)w);
  }
}

void thc_av1_release(void* handle) { delete (Picture*)handle; }

// (height, width, 3) RGB uint8 of planes y, u, v (uint16, the sizes
// thc_av1_planes writes) as OpenCV reads an AVIF image of them: p holds
// width, height, depth, monochrome, subsampling x, y, colour primaries,
// matrix coefficients, full range.
int thc_avif_to_rgb(const uint16_t* y, const uint16_t* u, const uint16_t* v, const int32_t* p,
                    uint8_t* rgb, char* err, int errlen) {
  try {
    YuvImage im{{y, u, v}, p[0], p[1], p[2], p[4], p[5], p[6], p[7], p[8]};
    yuv_to_rgb(im, p[3] != 0, rgb);
    return 0;
  } catch (const Error& e) {
    return report(e, err, errlen);
  } catch (const std::exception& e) {
    return report(Error{kErrFormat, e.what()}, err, errlen);
  }
}


// Plane src (sh x sw samples of `depth` bits) scaled to dst (dh x dw) as
// libavif's avifImageScale scales each plane of a decoded image to its
// ispe's size.
void thc_avif_scale_plane(const uint16_t* src, int sw, int sh, uint16_t* dst, int dw, int dh,
                          int depth) {
  if (depth > 8) {
    PlaneScaler<uint16_t>{src, sw, sh, dst, dw, dh}.run();
    return;
  }
  std::vector<uint8_t> s8((size_t)sw * sh), d8((size_t)dw * dh);
  for (size_t i = 0; i < s8.size(); i++) s8[i] = (uint8_t)src[i];
  PlaneScaler<uint8_t>{s8.data(), sw, sh, d8.data(), dw, dh}.run();
  for (size_t i = 0; i < d8.size(); i++) dst[i] = d8[i];
}

}  // extern "C"

// K4: the forward feature gather, a weighted gather of rows, in two forms.
//
// Replaces the Pallas gathers of the JAX package's tools (TPU):
// profile_gather_ab.py::pallas_gather and ::_sp_call (bilinear gather + lerp
// of four tap rows), probe_block_gather.py::block_gather and
// probe_block_gather2.py::make_block_gather (one weighted / unweighted row),
// probe_dma_gather.py::gather_a/b/c and probe_dma_gather2.py::attempt (row
// gathers by DMA).  All compute one function, the adjoint of K3:
//   out[v, n, :] = sum_t w[v, n, t] * src[v, ids[v, n] + off[t], :]
// with T = 1 or 4 taps; for the bilinear fetch off = (0, dx, dy, dy + dx)
// and w = ((1-wx)(1-wy), wx(1-wy), (1-wx)wy, wx wy).
//
// The id form (thp_feature_gather) reads each row's base id and T weights;
// a negative id gives a zero row and reads nothing (the masked points of
// profile_gather_ab.py).  The sampling form (thp_feature_sample) reads each
// row's image coordinate uv and forms the base texel and the four bilinear
// weights in registers, with the float32 operations of the port's
// ops/sampling.py::_sample_taps and _bilinear_w4 in their order, rounded
// one at a time (no contraction): its taps are those of the plain sampler
// bit for bit, every base texel lies in the map by construction, and the
// sampler needs no id check, no prelude of elementwise passes and no host
// sync.  One kernel body serves both forms, so on the same taps they give
// the same bits.
//
// What bounds it: device memory.  At the serve pixel shape (V = 3, one
// 32,768-point chunk, C = 384, 512x512 maps) it writes 151 MB and reads four
// 1.5 KB tap rows per (view, point), 604 MB in all, of which the chunk's
// neighbouring points share almost everything (a few thousand distinct tap
// rows): the reads come from the caches, the writes go to memory.  The
// design:
// - one warp owns one (view, point) row at a time; every lane issues all its
//   16-byte tap loads (4 taps x up to QW float4 words) before the first FMA,
//   sums them in registers and writes its words of the output row once;
// - each block walks a contiguous span of 48 rows (6 per warp), its warps
//   on neighbouring rows together, so points that share texels run on one
//   SM at one time and find their tap rows in its L1; at most 85 registers
//   a thread keep 3 blocks (24 warps) on an SM.  Measured on the H100
//   against one row per warp and against a persistent grid of long spans,
//   at both serve shapes (PERF.md);
// - a warp loads the next row's uv (or id and weights) while the current
//   row's taps are in flight, so that chain costs one trip, not two;
// - the output leaves through streaming stores (st.global.cs), which do not
//   evict the hot tap rows from L2.
// No shared memory: nothing is reused within a block beyond what L1 holds.
//
// The bfloat16 form of the sampling form (thp_feature_sample_bf16) reads a
// bf16 map and writes bf16 rows: half the bytes each way, so its bound is
// half the float32 form's.  It forms the same taps and float32 weights,
// widens each tap word (8 channels in 16 bytes) to float32, sums in the
// float32 form's order and narrows once (round to nearest even): its rows
// are the float32 form's on the widened map, cast, bit for bit.  It keeps
// float32 weights where the JAX package's bf16 sampler rounds them to bf16
// and lerps in bf16: more exact, and the reason the bit-equal oracle
// exists.  It has a kernel of its own (feature_sample_bf16_kernel, below).
// What bounds it at the main path's size (a 512-ray chunk's cull survivors,
// about 26,000 points, so ~79,000 rows of 384 channels a launch): the rows
// it writes and the tap rows it reads from L1/L2 (consecutive survivors
// lie along a ray, and the next ray's samples reuse most of its taps).  A
// bf16 row at C = 384 is 48 words, so the float32 form's row-a-warp walk
// left lanes 16-31 one word and a warp half the float32 form's bytes in
// flight, and at C = 192 (24 words) 8 lanes idle.  The design: a warp
// carries two rows at C = 384, four at C = 192 (one row in chunks above
// C = 768), each lane three words of one row, so that every lane holds 12
// tap words in flight, as the float32 form's lanes do, and resolves one
// row's taps; 2 blocks an SM (at 3 the 12 words spill); spans of at most 3
// groups a warp, shorter when the launch would not fill the card.  Longer
// spans and 4 words a lane measured slower on the H100.
//
// The int8 form of the sampling form (thp_feature_sample_int8) reads the
// int8 map of the int8 pixel-map mode (a per-channel quantised map) and
// writes bf16 rows, scaled back by the per-channel float32 scale: the JAX
// package's int8 arithmetic, which the port's plain twin
// (kernels/gather.py::feature_sample_int8_plain) repeats.  The taps come
// from the same float32 operations; then the fractions wx, wy are rounded
// to bf16, the int8 taps widened to bf16 (exact), and the lerp
//   top = p00 (1 - wx) + p01 wx,  bot = p10 (1 - wx) + p11 wx,
//   out = (top (1 - wy) + bot wy) * bf16(scale)
// is evaluated one bf16 operation at a time, each correctly rounded (round
// to nearest even), no contraction, as the CPUs of PyTorch and XLA
// evaluate a bf16 operation.  Its rows are the twin's bit for bit.  At
// C = 384 a tap row is 384 bytes: a quarter of the float32 form's bytes in,
// half of them out.  A null scale is a scale of 1: the unscaled lerp.  It
// has a kernel of its own (feature_sample_int8_kernel, below): the shared
// float32 body ran one row a warp with a quarter of the lanes idle at
// C = 384 and rounded each of ten float32 operations a channel to bf16 by
// a conversion (PERF.md).
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;  // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int QW = 3;         // words per lane per chunk: C = 384 in one
constexpr int SPAN = 6 * WARPS;  // rows per block: 6 per warp
constexpr int MIN_BLOCKS = 3;    // per SM: at most 85 registers a thread

// Where a row's taps and weights come from.
struct IdTaps {  // the id form: ids (rows,) int32, w (rows, T)
  const int* ids;
  const float* w;
  struct Raw {
    int id;
    float w[4];
  };
  template <int T>
  __device__ Raw load(long long row) const {
    Raw r;
    r.id = ids[row];
#pragma unroll
    for (int t = 0; t < 4; ++t) r.w[t] = t < T ? w[row * T + t] : 0.f;
    return r;
  }
  __device__ int resolve(const Raw& r, float* wt) const {
#pragma unroll
    for (int t = 0; t < 4; ++t) wt[t] = r.w[t];
    return r.id;
  }
};

struct UvTaps {  // the sampling form: uv (rows, 2) image pixels
  const float* uv;
  float sx, sy;   // float32(wf / w_img), float32(hf / h_img)
  int hf, wf;
  using Raw = float2;
  template <int T>
  __device__ Raw load(long long row) const {
    return make_float2(uv[2 * row], uv[2 * row + 1]);
  }
  // _sample_taps: scale, clamp to [0, size - 1], floor, the base texel
  // clamped to size - 2, the fractions against it
  __device__ int base(const Raw& r, float& wx, float& wy) const {
    const float cx = fminf(fmaxf(__fmul_rn(r.x, sx), 0.f),
                           static_cast<float>(wf - 1));
    const float cy = fminf(fmaxf(__fmul_rn(r.y, sy), 0.f),
                           static_cast<float>(hf - 1));
    int x0 = static_cast<int>(floorf(cx));
    int y0 = static_cast<int>(floorf(cy));
    if (wf > 1) x0 = min(x0, wf - 2);
    if (hf > 1) y0 = min(y0, hf - 2);
    wx = __fsub_rn(cx, static_cast<float>(x0));
    wy = __fsub_rn(cy, static_cast<float>(y0));
    return y0 * wf + x0;
  }
  // + _bilinear_w4: the four tap weights
  __device__ int resolve(const Raw& r, float* wt) const {
    float wx, wy;
    const int id = base(r, wx, wy);
    const float ux = __fsub_rn(1.f, wx), uy = __fsub_rn(1.f, wy);
    wt[0] = __fmul_rn(ux, uy);
    wt[1] = __fmul_rn(wx, uy);
    wt[2] = __fmul_rn(ux, wy);
    wt[3] = __fmul_rn(wx, wy);
    return id;
  }
};

// the t-th of four tap offsets
__device__ __forceinline__ int offs_at(const int4& off, int t) {
  return t == 0 ? off.x : t == 1 ? off.y : t == 2 ? off.z : off.w;
}

// One output row: all tap loads of a chunk first, then the sums in tap
// order (acc = w0 x0, then fma(w_t, x_t, acc)), then streaming stores.
template <int T, bool VEC>
__device__ void gather_row(const float* sv, int id, const float* wt,
                           const int* offs, float* o, int c, int lane) {
  using W = ThpWord<VEC>;
  using V = typename W::T;
  const int nw = VEC ? c / 4 : c;
  V* ov = reinterpret_cast<V*>(o);
  if (id < 0) {  // a masked point: a zero row, nothing read
    for (int q = lane; q < nw; q += 32) __stcs(ov + q, W::zero());
    return;
  }
  const V* tap[T];
#pragma unroll
  for (int t = 0; t < T; ++t)
    tap[t] = reinterpret_cast<const V*>(
        sv + static_cast<size_t>(id + offs[t]) * c);
  for (int q0 = lane; q0 < nw; q0 += 32 * QW) {
    V x[T][QW];
#pragma unroll
    for (int k = 0; k < QW; ++k) {
      const int q = q0 + 32 * k;
#pragma unroll
      for (int t = 0; t < T; ++t)
        if (q < nw) x[t][k] = __ldg(tap[t] + q);
    }
#pragma unroll
    for (int k = 0; k < QW; ++k) {
      const int q = q0 + 32 * k;
      if (q < nw) {
        V acc = W::zero();
#pragma unroll
        for (int t = 0; t < T; ++t) acc = W::fma(wt[t], x[t][k], acc);
        __stcs(ov + q, acc);
      }
    }
  }
}

template <int T, bool VEC, class Taps>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
feature_gather_kernel(const float* __restrict__ src, Taps taps,
                      float* __restrict__ out, long long rows, int n, int c,
                      int hw, int4 off) {
  const int lane = threadIdx.x & 31;
  const long long first = static_cast<long long>(blockIdx.x) * SPAN;
  const long long end = min(rows, first + SPAN);
  long long row = first + (threadIdx.x >> 5);
  if (row >= end) return;
  const int offs[4] = {off.x, off.y, off.z, off.w};
  typename Taps::Raw cur = taps.template load<T>(row);
  while (row < end) {
    const long long next = row + WARPS;
    // the next row's uv (or id and weights), in flight with this row's taps
    const typename Taps::Raw nxt =
        next < end ? taps.template load<T>(next) : cur;
    float wt[4];
    const int id = taps.resolve(cur, wt);
    const int v = static_cast<int>(row / n);
    gather_row<T, VEC>(src + static_cast<size_t>(v) * hw * c, id, wt, offs,
                       out + row * c, c, lane);
    cur = nxt;
    row = next;
  }
}

// One block per span of SPAN contiguous rows.
template <int T, bool VEC, class Taps>
int launch(const float* src, Taps taps, float* out, long long rows, int n,
           int c, int hw, int4 off, cudaStream_t stream) {
  const long long blocks = (rows + SPAN - 1) / SPAN;
  if (blocks > 0x7fffffffLL) return THP_ERR_BAD_SIZE;
  feature_gather_kernel<T, VEC, Taps>
      <<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(
          src, taps, out, rows, n, c, hw, off);
  return thp_launch_status();
}

template <int T, class Taps>
int dispatch(const float* src, Taps taps, float* out, int v, int n, int c,
             int hw, int4 off, cudaStream_t stream) {
  const long long rows = static_cast<long long>(v) * n;
  if (rows == 0) return 0;
  // float4 words need c a multiple of 4 and src and out aligned to 16
  // bytes (then every row is aligned); else the scalar path
  const bool vec = c % 4 == 0 && ((reinterpret_cast<uintptr_t>(src) |
                                   reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  return vec ? launch<T, true>(src, taps, out, rows, n, c, hw, off, stream)
             : launch<T, false>(src, taps, out, rows, n, c, hw, off, stream);
}

// The bfloat16 sampling form.  Words of 8 channels (VEC: 16 bytes of bf16)
// or single channels.  A warp carries a group of rpg consecutive rows (the
// most, a power of two up to 32, whose words fit in 32 * QWB), L = 32 / rpg
// lanes to a row: two rows at C = 384, four at C = 192, one row in chunks
// of 32 * QWB words above C = 768.  Lane l takes row l / L of the group and
// its words l % L + L q (q < QWB), so it resolves one row's taps and holds
// one row's weights, and the warp's stores cover whole stretches of
// consecutive rows.
constexpr int QWB = 3;        // bf16 words per lane at once, as QW
constexpr int GROUPS = 3;     // most groups a warp walks in one block
// <= 128 registers: the 12 tap words a lane holds and one row's taps fit
// unspilled (at 3 blocks an SM, 80 registers spill)
constexpr int MIN_BLOCKS_BF16 = 2;

template <bool VEC> struct Bf16Word;
template <> struct Bf16Word<true> {  // 8 channels in 16 bytes
  using T = uint4;
  static constexpr int CH = 8;
  // the float32 form's sum in its order on the widened taps, narrowed once
  static __device__ T lerp(const T* x, const float* wt) {
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      float f[8];
      thp_unpack8(x[t], f);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] = fmaf(wt[t], f[e], acc[e]);
    }
    return thp_pack8(acc);
  }
  static __device__ void store(T* p, const T& x) { __stcs(p, x); }
};
template <> struct Bf16Word<false> {  // one channel
  using T = unsigned short;
  static constexpr int CH = 1;
  static __device__ T lerp(const T* x, const float* wt) {
    float acc = 0.f;
#pragma unroll
    for (int t = 0; t < 4; ++t) acc = fmaf(wt[t], thp_bf16_to_f32(x[t]), acc);
    return thp_f32_to_bf16(acc);
  }
  static __device__ void store(T* p, T x) { *p = x; }
};

// rows a group: the most, a power of two up to 32, whose nw words each fit
// in 32 * QWB (one row of chunks when nw is more)
__host__ __device__ inline int rows_per_group(int nw) {
  int rpg = 1;
  while (rpg < 32 && 2 * rpg * nw <= 32 * QWB) rpg *= 2;
  return rpg;
}

// Each block walks a span of whole groups (at most GROUPS per warp), its
// warps on neighbouring groups together as the float32 form's on
// neighbouring rows; a lane loads its next group's uv while this group's
// taps are in flight.
template <bool VEC>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS_BF16)
feature_sample_bf16_kernel(const unsigned short* __restrict__ src,
                           UvTaps taps, unsigned short* __restrict__ out,
                           long long rows, int n, int c, int hw, int4 off,
                           int rpg, long long span) {
  using B = Bf16Word<VEC>;
  using W = typename B::T;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = c / B::CH;  // words a row
  const int ln = 32 / rpg;   // lanes a row
  const int r = lane / ln;   // this lane's row of each group
  const int c0 = lane - r * ln;
  const long long first = static_cast<long long>(blockIdx.x) * span;
  const long long end = min(rows, first + span);
  long long row = first + static_cast<long long>(warp) * rpg + r;
  const W* sw = reinterpret_cast<const W*>(src);
  W* ow = reinterpret_cast<W*>(out);
  UvTaps::Raw cur;
  if (row < end) cur = taps.load<4>(row);
  while (row - r < end) {
    const long long next = row + static_cast<long long>(WARPS) * rpg;
    const bool live = row < end;
    float wt[4];
    const int id = taps.resolve(cur, wt);
    const int v = live ? static_cast<int>(row / n) : 0;
    const W* base = sw + (static_cast<size_t>(v) * hw + id) * nw;
    const size_t o = static_cast<size_t>(row) * nw;
    // a row of more than ln * QWB words goes in chunks (rpg is then 1)
    for (int f0 = c0; f0 < nw; f0 += ln * QWB) {
      W x[QWB][4];
      // every tap load of the chunk in flight before the first sum
#pragma unroll
      for (int q = 0; q < QWB; ++q) {
        const int col = f0 + ln * q;
        if (live && col < nw) {
#pragma unroll
          for (int t = 0; t < 4; ++t)
            x[q][t] = __ldg(base + static_cast<size_t>(offs_at(off, t)) * nw +
                            col);
        }
      }
      // the next group's uv, in flight with this group's taps
      if (f0 + ln * QWB >= nw && next < end) cur = taps.load<4>(next);
#pragma unroll
      for (int q = 0; q < QWB; ++q) {
        const int col = f0 + ln * q;
        if (live && col < nw) B::store(ow + o + col, B::lerp(x[q], wt));
      }
    }
    row = next;
  }
}

// Spans of whole groups, as long as GROUPS groups a warp or as short as
// spreads the launch over every block the card holds at once.
template <bool VEC>
int launch_bf16(const unsigned short* src, UvTaps taps, unsigned short* out,
                long long rows, int n, int c, int hw, int4 off,
                cudaStream_t stream) {
  const int rpg = rows_per_group(VEC ? c / 8 : c);
  int resident = 0;
  const int e = thp_resident_blocks(
      reinterpret_cast<const void*>(feature_sample_bf16_kernel<VEC>), THREADS,
      0, &resident);
  if (e != 0) return e;
  const long long per_round = static_cast<long long>(WARPS) * rpg * resident;
  const long long want = (rows + per_round - 1) / per_round;
  const long long groups = want < GROUPS ? want : GROUPS;  // rows > 0
  const long long span = static_cast<long long>(WARPS) * rpg * groups;
  const long long blocks = (rows + span - 1) / span;
  if (blocks > 0x7fffffffLL) return THP_ERR_BAD_SIZE;
  feature_sample_bf16_kernel<VEC>
      <<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(
          src, taps, out, rows, n, c, hw, off, rpg, span);
  return thp_launch_status();
}

// The int8 sampling form.  Words of CH = 4 * NQ int8 channels (NQ 32-bit
// quads: 16 channels in 16 bytes, or 8 in 8), laid out as the bf16 form's
// words: a warp carries rpg rows (rows_per_group of the row's words), L =
// 32 / rpg lanes a row, each lane QWI words of one row: four rows at
// C = 384, eight at C = 192, so that a lane holds 12 tap words (192 bytes
// at C = 384, the float32 form's) in flight and every lane is busy.  The
// arithmetic is packed bf16: the int8 taps widened exactly to bf16 pairs
// (widen_int8x2), then the lerp and the scale in mul.rn / add.rn .bf16x2,
// never contracted: each the correctly rounded bf16 result, as the float32
// operation then one rounding that the JAX package's and the twin's CPUs
// evaluate (a float32 significand of 24 >= 2 * 8 + 2 bits makes that
// double rounding exact).  The bf16 lerp factors of a row and a lane's
// bf16 scales are formed once.  Measured on the H100 against two cheaper
// widenings in packed bf16 (a masked 0x4300 exponent less 128 or 256) and
// against 3 blocks an SM: all slower (PERF.md).
constexpr int QWI = 3;  // int8 words a lane at once
constexpr int MIN_BLOCKS_INT8 = 2;

__device__ __forceinline__ __nv_bfloat162 thp_as_bf162(unsigned u) {
  __nv_bfloat162 h;
  *reinterpret_cast<unsigned*>(&h) = u;
  return h;
}
__device__ __forceinline__ unsigned thp_as_u32(__nv_bfloat162 h) {
  return *reinterpret_cast<unsigned*>(&h);
}

// Channels 2h and 2h + 1 of a quad of int8 channels, sign bits flipped,
// as a bf16 pair (the lower channel in the lower half), exactly: each byte
// assembled into the float 2^23 + s + 128 by a byte permute, less 2^23 +
// 128 (exact); an integer of at most 8 significant bits, so the float's
// upper half is its bf16, and a permute packs the two
__device__ __forceinline__ __nv_bfloat162 widen_int8x2(unsigned flipped,
                                                       int h) {
  const float a = __int_as_float(static_cast<int>(
                      __byte_perm(flipped, 0x4B000000u, 0x7540 | (2 * h)))) -
                  8388736.f;
  const float b = __int_as_float(static_cast<int>(__byte_perm(
                      flipped, 0x4B000000u, 0x7540 | (2 * h + 1)))) -
                  8388736.f;
  return thp_as_bf162(
      __byte_perm(__float_as_uint(a), __float_as_uint(b), 0x7632));
}

template <int NQ> struct Int8Word;
template <> struct Int8Word<4> {  // 16 channels in 16 bytes
  using T = uint4;
  static __device__ unsigned quad(const T& x, int i) {
    return i == 0 ? x.x : i == 1 ? x.y : i == 2 ? x.z : x.w;
  }
};
template <> struct Int8Word<2> {  // 8 channels in 8 bytes
  using T = uint2;
  static __device__ unsigned quad(const T& x, int i) {
    return i == 0 ? x.x : x.y;
  }
};

template <int NQ>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS_INT8)
feature_sample_int8_kernel(const signed char* __restrict__ src, UvTaps taps,
                           unsigned short* __restrict__ out,
                           const float* __restrict__ scale, long long rows,
                           int n, int c, int hw, int4 off, int rpg,
                           long long span) {
  using I = Int8Word<NQ>;
  using W = typename I::T;
  constexpr int CH = 4 * NQ, PAIRS = CH / 2;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = c / CH;     // words a row
  const int ln = 32 / rpg;   // lanes a row
  const int r = lane / ln;   // this lane's row of each group
  const int c0 = lane - r * ln;
  const long long first = static_cast<long long>(blockIdx.x) * span;
  const long long end = min(rows, first + span);
  long long row = first + static_cast<long long>(warp) * rpg + r;
  const W* sw = reinterpret_cast<const W*>(src);
  uint4* ow = reinterpret_cast<uint4*>(out);
  // the lane's bf16 scales, for the words of one chunk (of every row when
  // the row is one chunk)
  const bool one_chunk = nw <= ln * QWI;
  unsigned s2[QWI][PAIRS];
  auto load_scales = [&](int f0) {
#pragma unroll
    for (int q = 0; q < QWI; ++q)
#pragma unroll
      for (int j = 0; j < PAIRS; ++j) {
        const int ch = (f0 + ln * q) * CH + 2 * j;  // pair j's channels
        s2[q][j] = scale && ch < c ? thp_as_u32(__floats2bfloat162_rn(
                                          __ldg(scale + ch),
                                          __ldg(scale + ch + 1)))
                                    : 0x3F803F80u;  // 1, 1
      }
  };
  if (one_chunk) load_scales(c0);
  UvTaps::Raw cur;
  if (row < end) cur = taps.load<4>(row);
  while (row - r < end) {
    const long long next = row + static_cast<long long>(WARPS) * rpg;
    const bool live = row < end;
    // the row's bf16 factors 1 - wx, wx, 1 - wy, wy (the fractions rounded
    // first, then 1 - each rounded), in both halves
    float wx, wy;
    const int id = taps.base(cur, wx, wy);
    const __nv_bfloat16 bx = __float2bfloat16_rn(wx);
    const __nv_bfloat16 by = __float2bfloat16_rn(wy);
    const __nv_bfloat162 wx2 = __bfloat162bfloat162(bx);
    const __nv_bfloat162 wy2 = __bfloat162bfloat162(by);
    const __nv_bfloat162 ux2 = __bfloat162bfloat162(
        __float2bfloat16_rn(__fsub_rn(1.f, __bfloat162float(bx))));
    const __nv_bfloat162 uy2 = __bfloat162bfloat162(
        __float2bfloat16_rn(__fsub_rn(1.f, __bfloat162float(by))));
    const int v = live ? static_cast<int>(row / n) : 0;
    const W* base = sw + (static_cast<size_t>(v) * hw + id) * nw;
    // a row of more than ln * QWI words goes in chunks (rpg is then 1)
    for (int f0 = c0; f0 < nw; f0 += ln * QWI) {
      if (!one_chunk) load_scales(f0);
      W x[QWI][4];
      // every tap load of the chunk in flight before the first sum
#pragma unroll
      for (int q = 0; q < QWI; ++q) {
        const int col = f0 + ln * q;
        if (live && col < nw) {
#pragma unroll
          for (int t = 0; t < 4; ++t)
            x[q][t] = __ldg(base + static_cast<size_t>(offs_at(off, t)) * nw +
                            col);
        }
      }
      // the next group's uv, in flight with this group's taps
      if (f0 + ln * QWI >= nw && next < end) cur = taps.load<4>(next);
#pragma unroll
      for (int q = 0; q < QWI; ++q) {
        const int col = f0 + ln * q;
        if (!live || col >= nw) continue;
        unsigned o[PAIRS];
#pragma unroll
        for (int i = 0; i < NQ; ++i) {
          unsigned fl[4];
#pragma unroll
          for (int t = 0; t < 4; ++t)
            fl[t] = I::quad(x[q][t], i) ^ 0x80808080u;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const __nv_bfloat162 p00 = widen_int8x2(fl[0], h);
            const __nv_bfloat162 p01 = widen_int8x2(fl[1], h);
            const __nv_bfloat162 p10 = widen_int8x2(fl[2], h);
            const __nv_bfloat162 p11 = widen_int8x2(fl[3], h);
            const __nv_bfloat162 top = __hadd2_rn(__hmul2_rn(p00, ux2),
                                                  __hmul2_rn(p01, wx2));
            const __nv_bfloat162 bot = __hadd2_rn(__hmul2_rn(p10, ux2),
                                                  __hmul2_rn(p11, wx2));
            __nv_bfloat162 val = __hadd2_rn(__hmul2_rn(top, uy2),
                                            __hmul2_rn(bot, wy2));
            if (scale) val = __hmul2_rn(val, thp_as_bf162(s2[q][2 * i + h]));
            o[2 * i + h] = thp_as_u32(val);
          }
        }
        const size_t ob = (static_cast<size_t>(row) * nw + col) * (CH / 8);
#pragma unroll
        for (int k = 0; k < CH / 8; ++k)
          __stcs(ow + ob + k, make_uint4(o[4 * k], o[4 * k + 1],
                                         o[4 * k + 2], o[4 * k + 3]));
      }
    }
    row = next;
  }
}

// One (row, channel) a thread, for widths the words do not fit: the same
// bf16 operations, each a float32 operation rounded once
__device__ __forceinline__ float thp_round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__global__ void __launch_bounds__(THREADS)
feature_sample_int8_scalar_kernel(const signed char* __restrict__ src,
                                  UvTaps taps,
                                  unsigned short* __restrict__ out,
                                  const float* __restrict__ scale,
                                  long long total, int n, int c, int hw,
                                  int4 off) {
  const long long e = static_cast<long long>(blockIdx.x) * THREADS +
                      threadIdx.x;
  if (e >= total) return;
  const long long row = e / c;
  const int ch = static_cast<int>(e - row * c);
  float wx, wy;
  const int id = taps.base(taps.load<4>(row), wx, wy);
  wx = thp_round_bf16(wx);
  wy = thp_round_bf16(wy);
  const float ux = thp_round_bf16(__fsub_rn(1.f, wx));
  const float uy = thp_round_bf16(__fsub_rn(1.f, wy));
  const signed char* p =
      src + (static_cast<size_t>(row / n) * hw + id) * c + ch;
  float tap[4];
#pragma unroll
  for (int t = 0; t < 4; ++t)
    tap[t] = static_cast<float>(__ldg(p + static_cast<size_t>(
                                              offs_at(off, t)) * c));
  const float top = thp_round_bf16(
      __fadd_rn(thp_round_bf16(__fmul_rn(tap[0], ux)),
                thp_round_bf16(__fmul_rn(tap[1], wx))));
  const float bot = thp_round_bf16(
      __fadd_rn(thp_round_bf16(__fmul_rn(tap[2], ux)),
                thp_round_bf16(__fmul_rn(tap[3], wx))));
  float val = thp_round_bf16(
      __fadd_rn(thp_round_bf16(__fmul_rn(top, uy)),
                thp_round_bf16(__fmul_rn(bot, wy))));
  if (scale) val = __fmul_rn(val, thp_round_bf16(__ldg(scale + ch)));
  out[e] = thp_f32_to_bf16(val);
}

// Spans of whole groups, as launch_bf16 sizes them
template <int NQ>
int launch_int8(const signed char* src, UvTaps taps, unsigned short* out,
                const float* scale, long long rows, int n, int c, int hw,
                int4 off, cudaStream_t stream) {
  const int rpg = rows_per_group(c / (4 * NQ));
  int resident = 0;
  const int e = thp_resident_blocks(
      reinterpret_cast<const void*>(feature_sample_int8_kernel<NQ>), THREADS,
      0, &resident);
  if (e != 0) return e;
  const long long per_round = static_cast<long long>(WARPS) * rpg * resident;
  const long long want = (rows + per_round - 1) / per_round;
  const long long groups = want < GROUPS ? want : GROUPS;  // rows > 0
  const long long span = static_cast<long long>(WARPS) * rpg * groups;
  const long long blocks = (rows + span - 1) / span;
  if (blocks > 0x7fffffffLL) return THP_ERR_BAD_SIZE;
  feature_sample_int8_kernel<NQ>
      <<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(
          src, taps, out, scale, rows, n, c, hw, off, rpg, span);
  return thp_launch_status();
}

}  // namespace

// The id form.  src (v, hw, c), w (v, n, t), out (v, n, c) float32; ids
// (v, n) int32; all contiguous.  t is 1 or 4 and off0..off3 are the tap
// offsets (those past t are ignored); every non-negative id must have all
// its taps id + off in [0, hw) (not checked here).
THP_EXPORT int thp_feature_gather(const float* src, const int* ids,
                                  const float* w, float* out, int v, int n,
                                  int c, int hw, int t, int off0, int off1,
                                  int off2, int off3, void* stream) {
  if (v < 1 || n < 0 || c < 1 || hw < 1 || (t != 1 && t != 4))
    return THP_ERR_BAD_SIZE;
  const int4 off = make_int4(off0, off1, off2, off3);
  const auto s = static_cast<cudaStream_t>(stream);
  const IdTaps taps{ids, w};
  return t == 4 ? dispatch<4>(src, taps, out, v, n, c, hw, off, s)
                : dispatch<1>(src, taps, out, v, n, c, hw, off, s);
}

// The sampling form.  src (v, hf, wf, c) NHWC, uv (v, n, 2) image pixels
// (x, y), out (v, n, c): float32, contiguous.  sx, sy:
// the float32 scales wf / w_img and hf / h_img.  Taps (0, dx, dy, dy + dx)
// with dx = 1 if wf > 1 else 0 and dy = wf if hf > 1 else 0; every tap lies
// in the map for any uv that is not NaN.
THP_EXPORT int thp_feature_sample(const float* src, const float* uv,
                                  float* out, int v, int n, int c, int hf,
                                  int wf, float sx, float sy, void* stream) {
  if (v < 1 || n < 0 || c < 1 || hf < 1 || wf < 1)
    return THP_ERR_BAD_SIZE;
  const int dx = wf > 1 ? 1 : 0, dy = hf > 1 ? wf : 0;
  const UvTaps taps{uv, sx, sy, hf, wf};
  return dispatch<4>(src, taps, out, v, n, c, hf * wf,
                     make_int4(0, dx, dy, dy + dx),
                     static_cast<cudaStream_t>(stream));
}

// The bfloat16 sampling form: src (v, hf, wf, c) and out (v, n, c) bf16
// (raw 16-bit words), uv (v, n, 2) float32; otherwise thp_feature_sample.
THP_EXPORT int thp_feature_sample_bf16(const void* src, const float* uv,
                                       void* out, int v, int n, int c, int hf,
                                       int wf, float sx, float sy,
                                       void* stream) {
  if (v < 1 || n < 0 || c < 1 || hf < 1 || wf < 1)
    return THP_ERR_BAD_SIZE;
  const long long rows = static_cast<long long>(v) * n;
  if (rows == 0) return 0;
  const int dx = wf > 1 ? 1 : 0, dy = hf > 1 ? wf : 0;
  const UvTaps taps{uv, sx, sy, hf, wf};
  const auto* s = static_cast<const unsigned short*>(src);
  auto* o = static_cast<unsigned short*>(out);
  const int4 off = make_int4(0, dx, dy, dy + dx);
  const auto st = static_cast<cudaStream_t>(stream);
  // 16-byte words need c a multiple of 8 and src and out aligned to 16
  // bytes (then every row is); else single channels
  const bool vec = c % 8 == 0 && ((reinterpret_cast<uintptr_t>(src) |
                                   reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  return vec ? launch_bf16<true>(s, taps, o, rows, n, c, hf * wf, off, st)
             : launch_bf16<false>(s, taps, o, rows, n, c, hf * wf, off, st);
}

// The int8 sampling form: src (v, hf, wf, c) int8, uv (v, n, 2) float32,
// scale (c,) float32 or null (a scale of 1), out (v, n, c) bf16 (raw
// 16-bit words); otherwise thp_feature_sample.
THP_EXPORT int thp_feature_sample_int8(const void* src, const float* uv,
                                       void* out, int v, int n, int c, int hf,
                                       int wf, float sx, float sy,
                                       const float* scale, void* stream) {
  if (v < 1 || n < 0 || c < 1 || hf < 1 || wf < 1)
    return THP_ERR_BAD_SIZE;
  const long long rows = static_cast<long long>(v) * n;
  if (rows == 0) return 0;
  const int dx = wf > 1 ? 1 : 0, dy = hf > 1 ? wf : 0;
  const UvTaps taps{uv, sx, sy, hf, wf};
  const auto* s = static_cast<const signed char*>(src);
  auto* o = static_cast<unsigned short*>(out);
  const int4 off = make_int4(0, dx, dy, dy + dx);
  const auto st = static_cast<cudaStream_t>(stream);
  // words of 16 (or 8) channels need c a multiple of it, src aligned to 16
  // (or 8) bytes and out to 16 (then every row is); else one channel a
  // thread
  const uintptr_t sa = reinterpret_cast<uintptr_t>(src);
  const bool out16 = (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  if (c % 16 == 0 && (sa & 15) == 0 && out16)
    return launch_int8<4>(s, taps, o, scale, rows, n, c, hf * wf, off, st);
  if (c % 8 == 0 && (sa & 7) == 0 && out16)
    return launch_int8<2>(s, taps, o, scale, rows, n, c, hf * wf, off, st);
  const long long total = rows * c;
  if ((total + THREADS - 1) / THREADS > 0x7fffffffLL) return THP_ERR_BAD_SIZE;
  feature_sample_int8_scalar_kernel<<<static_cast<unsigned>(
                                          (total + THREADS - 1) / THREADS),
                                      THREADS, 0, st>>>(
      s, taps, o, scale, total, n, c, hf * wf, off);
  return thp_launch_status();
}

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
// is evaluated one bf16 operation at a time: each computed in float32 and
// rounded to nearest even (__float2bfloat16_rn), no contraction, as the
// CPUs of PyTorch and XLA evaluate a bf16 operation.  Its rows are the
// twin's bit for bit.  At C = 384 a tap row is 384 bytes; a lane reads 8
// channels (8 bytes) of each tap and writes 8 bf16 channels (16 bytes), so
// it reads a quarter and writes half of the float32 form's bytes.  A null
// scale is a scale of 1: the unscaled lerp.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;  // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int QW = 3;         // words per lane per chunk: C = 384 in one
constexpr int QWI = 2;        // int8 words (8 channels) per lane: C = 384
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

// a float32 rounded to bf16 (nearest even), as a float32
__device__ __forceinline__ float thp_round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The int8 form's taps: UvTaps' base texel, and for weights the bf16 lerp
// factors (1 - wx, wx, 1 - wy, wy), each rounded to bf16
struct UvLerpTaps : UvTaps {
  __device__ int resolve(const Raw& r, float* wt) const {
    float wx, wy;
    const int id = base(r, wx, wy);
    wx = thp_round_bf16(wx);
    wy = thp_round_bf16(wy);
    wt[0] = thp_round_bf16(__fsub_rn(1.f, wx));
    wt[1] = wx;
    wt[2] = thp_round_bf16(__fsub_rn(1.f, wy));
    wt[3] = wy;
    return id;
  }
};

// One output row: all tap loads of a chunk first, then the sums in tap
// order (acc = w0 x0, then fma(w_t, x_t, acc)), then streaming stores.
template <int T, bool VEC>
__device__ void gather_row(const float* sv, int id, const float* wt,
                           const int* offs, float* o, int c, int lane,
                           const float*) {
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

// One channel of the int8 row: the four widened taps lerped in bf16, then
// scaled (wt = the bf16 factors 1 - wx, wx, 1 - wy, wy; s = bf16(scale))
__device__ __forceinline__ float lerp_int8(float p00, float p01, float p10,
                                           float p11, const float* wt,
                                           float s) {
  const float top = thp_round_bf16(__fadd_rn(
      thp_round_bf16(__fmul_rn(p00, wt[0])),
      thp_round_bf16(__fmul_rn(p01, wt[1]))));
  const float bot = thp_round_bf16(__fadd_rn(
      thp_round_bf16(__fmul_rn(p10, wt[0])),
      thp_round_bf16(__fmul_rn(p11, wt[1]))));
  const float v = thp_round_bf16(__fadd_rn(
      thp_round_bf16(__fmul_rn(top, wt[2])),
      thp_round_bf16(__fmul_rn(bot, wt[3]))));
  return __fmul_rn(v, s);  // rounded to bf16 at the store
}

__device__ __forceinline__ float channel_scale(const float* scale, int ch) {
  return scale ? thp_round_bf16(__ldg(scale + ch)) : 1.f;
}

// The same for two channels at once, in float2 lanes: each rounding is one
// packed conversion (cvt.rn.bf16x2.f32) for the pair.  Conversions run at a
// quarter of the float32 rate on Hopper and the lerp rounds ten times a
// channel, so pairing them halves the kernel's slowest instructions.
__device__ __forceinline__ float2 thp_round_bf16x2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return make_float2(__low2float(h), __high2float(h));
}

__device__ __forceinline__ float2 lerp_int8x2(const float2* p,
                                              const float* wt) {
  const float2 a = thp_round_bf16x2(__fmul_rn(p[0].x, wt[0]),
                                    __fmul_rn(p[0].y, wt[0]));
  const float2 b = thp_round_bf16x2(__fmul_rn(p[1].x, wt[1]),
                                    __fmul_rn(p[1].y, wt[1]));
  const float2 top = thp_round_bf16x2(__fadd_rn(a.x, b.x),
                                      __fadd_rn(a.y, b.y));
  const float2 c = thp_round_bf16x2(__fmul_rn(p[2].x, wt[0]),
                                    __fmul_rn(p[2].y, wt[0]));
  const float2 d = thp_round_bf16x2(__fmul_rn(p[3].x, wt[1]),
                                    __fmul_rn(p[3].y, wt[1]));
  const float2 bot = thp_round_bf16x2(__fadd_rn(c.x, d.x),
                                      __fadd_rn(c.y, d.y));
  const float2 e = thp_round_bf16x2(__fmul_rn(top.x, wt[2]),
                                    __fmul_rn(top.y, wt[2]));
  const float2 f = thp_round_bf16x2(__fmul_rn(bot.x, wt[3]),
                                    __fmul_rn(bot.y, wt[3]));
  return thp_round_bf16x2(__fadd_rn(e.x, f.x), __fadd_rn(e.y, f.y));
}

// Byte i of an int8 word as a float, the word's sign bits flipped first
// (each byte then holds s + 128): 2^23 + s + 128 assembled in the mantissa
// by one byte permute, less 2^23 + 128, both exact; full-rate instructions
// where a conversion (I2F) runs at a quarter rate.
__device__ __forceinline__ float int8_at(unsigned flipped, int i) {
  return __int_as_float(static_cast<int>(
             __byte_perm(flipped, 0x4B000000u, 0x7540 | i))) -
         8388736.f;
}

// The int8 row (T = 4, wt from UvLerpTaps): words of 8 channels, 8 bytes of
// each tap in and 16 bytes of bf16 out (VEC), or single channels.
template <int T, bool VEC>
__device__ void gather_row(const signed char* sv, int id, const float* wt,
                           const int* offs, unsigned short* o, int c,
                           int lane, const float* scale) {
  static_assert(T == 4, "the int8 form has four taps");
  const signed char* tap[4];
#pragma unroll
  for (int t = 0; t < 4; ++t)
    tap[t] = sv + static_cast<size_t>(id + offs[t]) * c;
  if (!VEC) {
    for (int q = lane; q < c; q += 32)
      o[q] = thp_f32_to_bf16(lerp_int8(
          __ldg(tap[0] + q), __ldg(tap[1] + q), __ldg(tap[2] + q),
          __ldg(tap[3] + q), wt, channel_scale(scale, q)));
    return;
  }
  const int nw = c / 8;
  uint4* ov = reinterpret_cast<uint4*>(o);
  for (int q0 = lane; q0 < nw; q0 += 32 * QWI) {
    uint2 x[4][QWI];
#pragma unroll
    for (int k = 0; k < QWI; ++k) {
      const int q = q0 + 32 * k;
#pragma unroll
      for (int t = 0; t < 4; ++t)
        if (q < nw)
          x[t][k] = __ldg(reinterpret_cast<const uint2*>(tap[t]) + q);
    }
#pragma unroll
    for (int k = 0; k < QWI; ++k) {
      const int q = q0 + 32 * k;
      if (q < nw) {
        unsigned w[4];  // channels 2j (low half) and 2j + 1 (high half)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float2 p[4];
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            const unsigned b4 = (j < 2 ? x[t][k].x : x[t][k].y) ^ 0x80808080u;
            p[t] = make_float2(int8_at(b4, 2 * (j & 1)),
                               int8_at(b4, 2 * (j & 1) + 1));
          }
          const float2 v = lerp_int8x2(p, wt);
          float2 sc = make_float2(1.f, 1.f);
          if (scale) {
            const float2 s2 =
                __ldg(reinterpret_cast<const float2*>(scale + 8 * q) + j);
            sc = thp_round_bf16x2(s2.x, s2.y);
          }
          const __nv_bfloat162 h =
              __floats2bfloat162_rn(__fmul_rn(v.x, sc.x), __fmul_rn(v.y, sc.y));
          w[j] = static_cast<unsigned>(__bfloat16_as_ushort(h.x)) |
                 static_cast<unsigned>(__bfloat16_as_ushort(h.y)) << 16;
        }
        __stcs(ov + q, make_uint4(w[0], w[1], w[2], w[3]));
      }
    }
  }
}

template <int T, bool VEC, class Taps, class E, class O>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
feature_gather_kernel(const E* __restrict__ src, Taps taps,
                      O* __restrict__ out, long long rows, int n, int c,
                      int hw, int4 off, const float* __restrict__ scale) {
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
                       out + row * c, c, lane, scale);
    cur = nxt;
    row = next;
  }
}

// One block per span of SPAN contiguous rows.
template <int T, bool VEC, class Taps, class E, class O>
int launch(const E* src, Taps taps, O* out, long long rows, int n, int c,
           int hw, int4 off, const float* scale, cudaStream_t stream) {
  const long long blocks = (rows + SPAN - 1) / SPAN;
  if (blocks > 0x7fffffffLL) return THP_ERR_BAD_SIZE;
  feature_gather_kernel<T, VEC, Taps, E, O>
      <<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(
          src, taps, out, rows, n, c, hw, off, scale);
  return thp_launch_status();
}

template <int T, class Taps, class E, class O>
int dispatch(const E* src, Taps taps, O* out, int v, int n, int c, int hw,
             int4 off, cudaStream_t stream, const float* scale = nullptr) {
  const long long rows = static_cast<long long>(v) * n;
  if (rows == 0) return 0;
  // words of 4 float32 or 8 narrower channels need c a multiple of the
  // word and src and out aligned to a word of each (then every row is
  // aligned); else the scalar path
  constexpr int CH = sizeof(E) == 4 ? 4 : 8;
  const bool vec =
      c % CH == 0 &&
      reinterpret_cast<uintptr_t>(src) % (CH * sizeof(E)) == 0 &&
      reinterpret_cast<uintptr_t>(out) % (CH * sizeof(O)) == 0 &&
      reinterpret_cast<uintptr_t>(scale) % 8 == 0;  // int8: float2 scales
  return vec ? launch<T, true>(src, taps, out, rows, n, c, hw, off, scale,
                               stream)
             : launch<T, false>(src, taps, out, rows, n, c, hw, off, scale,
                                stream);
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
  const int dx = wf > 1 ? 1 : 0, dy = hf > 1 ? wf : 0;
  UvLerpTaps taps;
  taps.uv = uv;
  taps.sx = sx;
  taps.sy = sy;
  taps.hf = hf;
  taps.wf = wf;
  return dispatch<4>(static_cast<const signed char*>(src), taps,
                     static_cast<unsigned short*>(out), v, n, c, hf * wf,
                     make_int4(0, dx, dy, dy + dx),
                     static_cast<cudaStream_t>(stream), scale);
}

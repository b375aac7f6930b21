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
// exists.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;  // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int QW = 3;         // words per lane per chunk: C = 384 in one
constexpr int QWB = 2;        // bf16 words (8 channels) per lane: C = 384
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
  // _sample_taps + _bilinear_w4: scale, clamp to [0, size - 1], floor, the
  // base texel clamped to size - 2, the fractions against it, the weights
  __device__ int resolve(const Raw& r, float* wt) const {
    const float cx = fminf(fmaxf(__fmul_rn(r.x, sx), 0.f),
                           static_cast<float>(wf - 1));
    const float cy = fminf(fmaxf(__fmul_rn(r.y, sy), 0.f),
                           static_cast<float>(hf - 1));
    int x0 = static_cast<int>(floorf(cx));
    int y0 = static_cast<int>(floorf(cy));
    if (wf > 1) x0 = min(x0, wf - 2);
    if (hf > 1) y0 = min(y0, hf - 2);
    const float wx = __fsub_rn(cx, static_cast<float>(x0));
    const float wy = __fsub_rn(cy, static_cast<float>(y0));
    const float ux = __fsub_rn(1.f, wx), uy = __fsub_rn(1.f, wy);
    wt[0] = __fmul_rn(ux, uy);
    wt[1] = __fmul_rn(wx, uy);
    wt[2] = __fmul_rn(ux, wy);
    wt[3] = __fmul_rn(wx, wy);
    return y0 * wf + x0;
  }
};

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

// The bfloat16 row: words of 8 channels (VEC) or single channels, widened
// to float32 and summed as gather_row sums, narrowed once at the store.
template <int T, bool VEC>
__device__ void gather_row(const unsigned short* sv, int id, const float* wt,
                           const int* offs, unsigned short* o, int c,
                           int lane) {
  if (!VEC) {
    for (int q = lane; q < c; q += 32) {
      float acc = 0.f;
      if (id >= 0) {
        float x[T];
#pragma unroll
        for (int t = 0; t < T; ++t)
          x[t] = thp_bf16_to_f32(
              __ldg(sv + static_cast<size_t>(id + offs[t]) * c + q));
#pragma unroll
        for (int t = 0; t < T; ++t) acc = fmaf(wt[t], x[t], acc);
      }
      o[q] = thp_f32_to_bf16(acc);
    }
    return;
  }
  const int nw = c / 8;
  uint4* ov = reinterpret_cast<uint4*>(o);
  if (id < 0) {  // a masked point: a zero row, nothing read
    for (int q = lane; q < nw; q += 32) __stcs(ov + q, make_uint4(0, 0, 0, 0));
    return;
  }
  const uint4* tap[T];
#pragma unroll
  for (int t = 0; t < T; ++t)
    tap[t] = reinterpret_cast<const uint4*>(
        sv + static_cast<size_t>(id + offs[t]) * c);
  for (int q0 = lane; q0 < nw; q0 += 32 * QWB) {
    uint4 x[T][QWB];
#pragma unroll
    for (int k = 0; k < QWB; ++k) {
      const int q = q0 + 32 * k;
#pragma unroll
      for (int t = 0; t < T; ++t)
        if (q < nw) x[t][k] = __ldg(tap[t] + q);
    }
#pragma unroll
    for (int k = 0; k < QWB; ++k) {
      const int q = q0 + 32 * k;
      if (q < nw) {
        float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int t = 0; t < T; ++t) {
          float f[8];
          thp_unpack8(x[t][k], f);
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[e] = fmaf(wt[t], f[e], acc[e]);
        }
        __stcs(ov + q, thp_pack8(acc));
      }
    }
  }
}

template <int T, bool VEC, class Taps, class E>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
feature_gather_kernel(const E* __restrict__ src, Taps taps,
                      E* __restrict__ out, long long rows, int n, int c,
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
template <int T, bool VEC, class Taps, class E>
int launch(const E* src, Taps taps, E* out, long long rows, int n,
           int c, int hw, int4 off, cudaStream_t stream) {
  const long long blocks = (rows + SPAN - 1) / SPAN;
  if (blocks > 0x7fffffffLL) return THP_ERR_BAD_SIZE;
  feature_gather_kernel<T, VEC, Taps, E>
      <<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(
          src, taps, out, rows, n, c, hw, off);
  return thp_launch_status();
}

template <int T, class Taps, class E>
int dispatch(const E* src, Taps taps, E* out, int v, int n, int c,
             int hw, int4 off, cudaStream_t stream) {
  const long long rows = static_cast<long long>(v) * n;
  if (rows == 0) return 0;
  // 16-byte words (4 float32 or 8 bf16 channels) need c a multiple of the
  // word and 16-byte aligned src and out (then every row is aligned); else
  // the scalar path
  const bool vec =
      c % (16 / static_cast<int>(sizeof(E))) == 0 &&
      ((reinterpret_cast<uintptr_t>(src) |
        reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  return vec ? launch<T, true>(src, taps, out, rows, n, c, hw, off, stream)
             : launch<T, false>(src, taps, out, rows, n, c, hw, off, stream);
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
  const int dx = wf > 1 ? 1 : 0, dy = hf > 1 ? wf : 0;
  const UvTaps taps{uv, sx, sy, hf, wf};
  return dispatch<4>(static_cast<const unsigned short*>(src), taps,
                     static_cast<unsigned short*>(out), v, n, c, hf * wf,
                     make_int4(0, dx, dy, dy + dx),
                     static_cast<cudaStream_t>(stream));
}

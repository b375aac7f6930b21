// K4: the forward feature gather, a weighted gather of rows.
//
// Replaces the Pallas gathers of the JAX package's tools (TPU):
// profile_gather_ab.py::pallas_gather and ::_sp_call (bilinear gather + lerp
// of four tap rows), probe_block_gather.py::block_gather and
// probe_block_gather2.py::make_block_gather (one weighted / unweighted row),
// probe_dma_gather.py::gather_a/b/c and probe_dma_gather2.py::attempt (row
// gathers by DMA).  All compute one function, the adjoint of K3:
//   out[v, n, :] = sum_t w[v, n, t] * src[v, ids[v, n] + off[t], :]
// with T = 1 or 4 taps; for the bilinear fetch off = (0, dx, dy, dy + dx)
// and w = ((1-wx)(1-wy), wx(1-wy), (1-wx)wy, wx wy).  A negative id gives a
// zero row and reads nothing (the masked points of profile_gather_ab.py).
//
// What bounds it: device memory.  At the serve pixel shape (V = 3, one
// 32,768-point chunk, C = 384, 512x512 maps) it writes 151 MB and reads four
// 1.5 KB tap rows per (view, point): 604 MB if no tap row were shared, far
// less where neighbouring points share texels (the L2 holds them).  The TPU
// kernels' quad tables, scalar prefetch and DMA orderings exist to feed
// Mosaic's vector unit; here one warp owns one (view, point) row: every lane
// loads 16-byte float4 words of the contiguous NHWC tap rows (C = 384 is
// 3 float4 per lane), sums them in registers and writes its words of the
// output row once, so each row is one coalesced read per tap and one
// coalesced write.  No shared memory: nothing is reused within a block.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;  // 8 warps, 8 (view, point) rows per block

template <int T, bool VEC>
__global__ void __launch_bounds__(THREADS)
feature_gather_kernel(const float* __restrict__ src,
                      const int* __restrict__ ids,
                      const float* __restrict__ w, float* __restrict__ out,
                      long long rows, int n, int c, int hw, int4 off) {
  const long long row =
      (static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const int v = static_cast<int>(row / n);
  const int id = ids[row];
  float* o = out + row * c;
  const int offs[4] = {off.x, off.y, off.z, off.w};

  if (id < 0) {  // a masked point: a zero row, nothing read
    if (VEC) {
      for (int q = lane; q < c / 4; q += 32)
        reinterpret_cast<float4*>(o)[q] = make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      for (int q = lane; q < c; q += 32) o[q] = 0.f;
    }
    return;
  }

  const float* sv = src + static_cast<size_t>(v) * hw * c;
  const float* tap[T];
  float wt[T];
#pragma unroll
  for (int t = 0; t < T; ++t) {
    // the wrapper has checked that every tap id lies in [0, hw)
    tap[t] = sv + static_cast<size_t>(id + offs[t]) * c;
    wt[t] = w[row * T + t];  // one address for the whole warp: a broadcast
  }

  if (VEC) {
    for (int q = lane; q < c / 4; q += 32) {
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int t = 0; t < T; ++t) {
        const float4 x = __ldg(reinterpret_cast<const float4*>(tap[t]) + q);
        acc.x = fmaf(wt[t], x.x, acc.x);
        acc.y = fmaf(wt[t], x.y, acc.y);
        acc.z = fmaf(wt[t], x.z, acc.z);
        acc.w = fmaf(wt[t], x.w, acc.w);
      }
      reinterpret_cast<float4*>(o)[q] = acc;
    }
  } else {
    for (int q = lane; q < c; q += 32) {
      float acc = 0.f;
#pragma unroll
      for (int t = 0; t < T; ++t) acc = fmaf(wt[t], __ldg(tap[t] + q), acc);
      o[q] = acc;
    }
  }
}

template <int T, bool VEC>
void launch(const float* src, const int* ids, const float* w, float* out,
            long long rows, int n, int c, int hw, int4 off,
            cudaStream_t stream) {
  const long long blocks = (rows * 32 + THREADS - 1) / THREADS;
  feature_gather_kernel<T, VEC><<<static_cast<unsigned>(blocks), THREADS, 0,
                                  stream>>>(src, ids, w, out, rows, n, c, hw,
                                            off);
}

}  // namespace

// src (v, hw, c), w (v, n, t), out (v, n, c) float32; ids (v, n) int32; all
// contiguous.  t is 1 or 4 and off0..off3 are the tap offsets (those past t
// are ignored); every non-negative id must have all its taps id + off in
// [0, hw) (not checked here).  float4 loads need c % 4 == 0 and 16-byte
// aligned src and out (then every row is aligned); else the scalar path.
THP_EXPORT int thp_feature_gather(const float* src, const int* ids,
                                  const float* w, float* out, int v, int n,
                                  int c, int hw, int t, int off0, int off1,
                                  int off2, int off3, void* stream) {
  if (v < 1 || n < 0 || c < 1 || hw < 1 || (t != 1 && t != 4))
    return THP_ERR_BAD_SIZE;
  const long long rows = static_cast<long long>(v) * n;
  if (rows == 0) return 0;
  if ((rows * 32 + THREADS - 1) / THREADS > 0x7fffffffLL)
    return THP_ERR_BAD_SIZE;
  const int4 off = make_int4(off0, off1, off2, off3);
  const auto s = static_cast<cudaStream_t>(stream);
  const bool vec =
      c % 4 == 0 && ((reinterpret_cast<uintptr_t>(src) |
                      reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  if (t == 4) {
    if (vec) launch<4, true>(src, ids, w, out, rows, n, c, hw, off, s);
    else launch<4, false>(src, ids, w, out, rows, n, c, hw, off, s);
  } else {
    if (vec) launch<1, true>(src, ids, w, out, rows, n, c, hw, off, s);
    else launch<1, false>(src, ids, w, out, rows, n, c, hw, off, s);
  }
  return thp_launch_status();
}

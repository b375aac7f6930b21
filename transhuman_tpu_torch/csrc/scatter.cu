// K3: the d_feat backward of the bilinear feature fetch.
//
// Replaces transhuman_tpu/experiments/streamscatter.py::dfeat_scatter_sorted
// (Pallas, TPU).  For every view v and point n with pre-clamped base texel
// id i = ids[v, n] and tap weights w4[v, n] = ((1-wx)(1-wy), wx(1-wy),
// (1-wx)wy, wx wy):
//   out[v, i + {0, dx, dy, dy+dx}, :] += w4[v, n, tap] * g[v, n, :]
// with dx = 1, dy = Wf on any map wider and taller than one texel.
// out (V, Hf*Wf, C) float32 must be zeroed by the caller.
//
// What bounds it: device memory.  At the train shapes (N = 153,600 points,
// C = 384, a 512x512 map, V = 3) the kernel reads 236 MB of cotangent rows
// per view and read-modify-writes part of a 403 MB map; ~1.9 GB over the
// three views, ~0.6 ms at 3.35 TB/s.  The TPU kernel's window / residual /
// while_loop machinery works around Mosaic's store alignment and has no job
// here.  Instead the caller sorts the ids (torch.sort, glue like the JAX
// package's argsort), so equal ids form runs: points that project into one
// texel (~7 per texel on a train batch, whose samples crowd along rays) are
// summed in registers and leave as ONE atomicAdd per run, tap and channel.
// Each block owns SEG consecutive sorted positions; their ids, source rows
// and weights are staged in shared memory; each thread owns CPT channels of
// a chunk of THREADS * CPT, so a warp reads 32 neighbouring floats of a
// cotangent row (coalesced) and its atomics hit 32 neighbouring floats of a
// map row.  A run that crosses a block boundary is flushed once by each
// block: atomics keep the sum right, only its order varies.
#include "common.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int CPT = 4;    // channels per thread per chunk (C <= 512 in one)
constexpr int SEG = 64;   // sorted positions per block

__global__ void __launch_bounds__(THREADS)
dfeat_scatter_kernel(const int* __restrict__ ids_sorted,
                     const int* __restrict__ order,
                     const float* __restrict__ g,
                     const float* __restrict__ w4, float* __restrict__ out,
                     int n, int c, int hw, int dx, int dy) {
  __shared__ int s_id[SEG];
  __shared__ int s_row[SEG];
  __shared__ float4 s_w[SEG];

  const int t = threadIdx.x;
  const int vv = blockIdx.y;
  const int p0 = blockIdx.x * SEG;
  const int rows = min(SEG, n - p0);
  const size_t vn = static_cast<size_t>(vv) * n;

  for (int j = t; j < rows; j += THREADS) {
    const int r = order[vn + p0 + j];
    s_id[j] = ids_sorted[vn + p0 + j];
    s_row[j] = r;
    s_w[j] = reinterpret_cast<const float4*>(w4)[vn + r];
  }
  __syncthreads();

  const float* gv = g + vn * c;
  float* ov = out + static_cast<size_t>(vv) * hw * c;
  const int off[4] = {0, dx, dy, dy + dx};

  for (int c0 = 0; c0 < c; c0 += THREADS * CPT) {
    float acc[4][CPT];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int q = 0; q < CPT; ++q) acc[a][q] = 0.f;

    // every thread walks the same positions, so the run test is uniform
    // across the block and the flush never diverges
    auto flush = [&](int id) {
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        // the wrapper has checked that every tap id lies in [0, hw)
        float* row = ov + static_cast<size_t>(id + off[a]) * c;
#pragma unroll
        for (int q = 0; q < CPT; ++q) {
          const int ch = c0 + t + q * THREADS;
          if (ch < c) atomicAdd(row + ch, acc[a][q]);
          acc[a][q] = 0.f;
        }
      }
    };

    int cur = s_id[0];
    for (int j = 0; j < rows; ++j) {
      const int id = s_id[j];
      if (id != cur) {
        flush(cur);
        cur = id;
      }
      const float4 w = s_w[j];
      const float* gr = gv + static_cast<size_t>(s_row[j]) * c;
#pragma unroll
      for (int q = 0; q < CPT; ++q) {
        const int ch = c0 + t + q * THREADS;
        const float x = ch < c ? gr[ch] : 0.f;
        acc[0][q] = fmaf(w.x, x, acc[0][q]);
        acc[1][q] = fmaf(w.y, x, acc[1][q]);
        acc[2][q] = fmaf(w.z, x, acc[2][q]);
        acc[3][q] = fmaf(w.w, x, acc[3][q]);
      }
    }
    flush(cur);
  }
}

}  // namespace

// ids_sorted (v, n) int32 base ids sorted ascending within each view, with
// every tap id ids + {0, dx, dy, dy + dx} in [0, hw) (not checked here);
// order (v, n) int32: the row of g / w4 that each sorted position came from;
// g (v, n, c), w4 (v, n, 4), out (v, hw, c) zeroed: float32, contiguous.
THP_EXPORT int thp_dfeat_scatter(const int* ids_sorted, const int* order,
                                 const float* g, const float* w4, float* out,
                                 int v, int n, int c, int hw, int dx, int dy,
                                 void* stream) {
  if (v < 1 || v > 65535 || n < 0 || c < 1 || hw < 1 || dx < 0 || dy < 0)
    return THP_ERR_BAD_SIZE;
  if (n == 0) return 0;
  const dim3 grid((n + SEG - 1) / SEG, v);
  dfeat_scatter_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      ids_sorted, order, g, w4, out, n, c, hw, dx, dy);
  return thp_launch_status();
}

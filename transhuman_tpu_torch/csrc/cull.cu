// K1: the SMPL-proximity cull, out[n] = min_j (|p_n - r_j|^2 - b_j).
//
// Replaces transhuman_tpu/experiments/cull.py::min_dist2_fused (Pallas, TPU),
// generalised by a per-reference bias: b = 0 is the shell cull (compare with
// cull_distance^2), b = r_v^2 the per-vertex radii cull and b = thresh2 the
// cluster prefilter, all with this one kernel.
//
// What bounds it: FP32 arithmetic.  A full 512x512 frame has 4.19 M sample
// points against 6,890 vertices, 2.9e10 pairs at ~8 FP32 operations each
// (3 sub, 1 mul, 2 fma, 1 sub, 1 min) = 2.3e11 operations; memory traffic is
// 12 B in and 4 B out per point.  The design keeps every operand on chip:
// one thread owns one point in registers and a running minimum; the block
// streams the references through shared memory in tiles of TILE_R (x, y, z,
// bias) float4s, which every thread of the block then reads as a broadcast.
// The difference form (p - r).(p - r) is used instead of the TPU kernel's
// expanded |p|^2 + |r|^2 - 2 p.r: it is as cheap without a matrix unit and
// does not cancel catastrophically near the threshold.
#include "common.cuh"

namespace {

constexpr int TILE_R = 1024;  // references per shared-memory tile (16 KB)
constexpr int THREADS = 128;  // points per block

__global__ void __launch_bounds__(THREADS)
min_excess2_kernel(const float* __restrict__ pts, const float* __restrict__ refs,
                   const float* __restrict__ bias2, float* __restrict__ out,
                   int n, int m) {
  __shared__ float4 tile[TILE_R];
  const int i = blockIdx.x * THREADS + threadIdx.x;
  float px = 0.f, py = 0.f, pz = 0.f;
  if (i < n) {
    px = pts[3 * i];
    py = pts[3 * i + 1];
    pz = pts[3 * i + 2];
  }
  float best = __int_as_float(0x7f800000);  // +inf
  for (int base = 0; base < m; base += TILE_R) {
    const int cnt = min(TILE_R, m - base);
    for (int j = threadIdx.x; j < cnt; j += THREADS) {
      const int r = base + j;
      tile[j] = make_float4(refs[3 * r], refs[3 * r + 1], refs[3 * r + 2],
                            bias2[r]);
    }
    __syncthreads();
#pragma unroll 8
    for (int j = 0; j < cnt; ++j) {
      const float4 r = tile[j];
      const float dx = px - r.x;
      const float dy = py - r.y;
      const float dz = pz - r.z;
      const float d2 = fmaf(dx, dx, fmaf(dy, dy, dz * dz));
      best = fminf(best, d2 - r.w);
    }
    __syncthreads();
  }
  if (i < n) out[i] = best;
}

}  // namespace

// pts (n, 3), refs (m, 3), bias2 (m,), out (n,): float32, contiguous, on the
// device of `stream`.
THP_EXPORT int thp_min_excess2(const float* pts, const float* refs,
                               const float* bias2, float* out, int n, int m,
                               void* stream) {
  if (n < 0 || m < 0) return THP_ERR_BAD_SIZE;
  if (n == 0) return 0;
  const int blocks = (n + THREADS - 1) / THREADS;
  min_excess2_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      pts, refs, bias2, out, n, m);
  return thp_launch_status();
}

THP_EXPORT const char* thp_error_string(int code) {
  switch (code) {
    case THP_ERR_BAD_K:
      return "k is outside the kernel's compiled range 1..8";
    case THP_ERR_BAD_FREQS:
      return "the kernel is compiled for n_freqs = 10 only";
    case THP_ERR_BAD_SIZE:
      return "an extent is negative or too large for the kernel";
    case THP_ERR_SMEM:
      return "the tile does not fit in shared memory";
    default:
      return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

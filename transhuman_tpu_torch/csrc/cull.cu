// K1: the SMPL-proximity cull, out[n] = min_j (|p_n - r_j|^2 - b_j).
//
// Replaces transhuman_tpu/experiments/cull.py::min_dist2_fused (Pallas, TPU),
// generalised by a per-reference bias: b = 0 is the shell cull (compare with
// cull_distance^2), b = r_v^2 the per-vertex radii cull and b = thresh2 the
// cluster prefilter, all with this one kernel.
//
// What bounds it: FP32 arithmetic.  A full 512x512 frame has 4.19 M sample
// points against 6,890 vertices, 2.9e10 pairs; memory traffic is 12 B in and
// 4 B out per point.  The least work per pair is the expanded form of the JAX
// reference (transhuman_tpu/ops/knn.py, and the Pallas kernel):
// |p|^2 + (|r|^2 - b) - 2 p.r, i.e. 3 FMAs and a min (7 FP32 operations)
// once |p|^2 is added after the min and each reference is stored as
// (-2x, -2y, -2z, |r|^2 - b), which the block computes while it loads the
// reference tile into shared memory.
// Precision: at |p|^2 ~ 1 the expanded form rounds ~3e-7 on d^2, ~1.5e-6 m
// at the 0.1 m threshold; the plain twin (ops/knn.py) rounds the same way.
// The reference clamps each pair's d^2 at 0 before subtracting the bias;
// folding |p|^2 out of the loop moves that clamp past the min, where it is
// dropped (with a bias the result may be negative).  The two differ by at
// most the same ~3e-7, and only within ~5e-4 m of a reference.
// Occupancy and ILP: a thread owns PTS = 4 points, so each broadcast float4
// feeds 4 independent min chains; the 16 warps of a block share the block's
// 128 points and split the reference axis among them (warp w takes tile
// entries w, w + 16, ...), so a 32,768-point chunk runs 4,096 warps, 31 per
// SM.  The 16 partial minima per point meet in shared memory: fminf is exact
// and order-free, so the split changes no bit.  No tensor cores: a 0.1 m
// threshold on d^2 ~ 0.01 at |p|^2 ~ 1 needs float32 accuracy, which TF32
// lacks.
#include "common.cuh"

namespace {

constexpr int WARPS = 16;              // reference splits per block
constexpr int THREADS = 32 * WARPS;
constexpr int PTS = 4;                 // points per thread
constexpr int BLOCK_PTS = 32 * PTS;    // points per block
constexpr int TILE_R = 2048;           // references per shared tile (32 KB)

__global__ void __launch_bounds__(THREADS, 2)
min_excess2_kernel(const float* __restrict__ pts, const float* __restrict__ refs,
                   const float* __restrict__ bias2, float* __restrict__ out,
                   int n, int m) {
  __shared__ float4 tile[TILE_R];
  __shared__ float part[WARPS][BLOCK_PTS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n0 = blockIdx.x * BLOCK_PTS;
  float px[PTS], py[PTS], pz[PTS], best[PTS];
#pragma unroll
  for (int p = 0; p < PTS; ++p) {
    const int i = n0 + lane + 32 * p;
    const bool in = i < n;
    px[p] = in ? pts[3 * i] : 0.f;
    py[p] = in ? pts[3 * i + 1] : 0.f;
    pz[p] = in ? pts[3 * i + 2] : 0.f;
    best[p] = __int_as_float(0x7f800000);  // +inf
  }
  for (int base = 0; base < m; base += TILE_R) {
    const int cnt = min(TILE_R, m - base);
    for (int j = threadIdx.x; j < cnt; j += THREADS) {
      const int r = base + j;
      const float x = refs[3 * r], y = refs[3 * r + 1], z = refs[3 * r + 2];
      tile[j] = make_float4(-2.f * x, -2.f * y, -2.f * z,
                            fmaf(x, x, fmaf(y, y, z * z)) - bias2[r]);
    }
    __syncthreads();
#pragma unroll 4
    for (int j = warp; j < cnt; j += WARPS) {
      const float4 r = tile[j];  // one address per warp: a broadcast
#pragma unroll
      for (int p = 0; p < PTS; ++p)
        best[p] = fminf(best[p],
                        fmaf(px[p], r.x, fmaf(py[p], r.y, fmaf(pz[p], r.z,
                                                               r.w))));
    }
    __syncthreads();
  }
#pragma unroll
  for (int p = 0; p < PTS; ++p) part[warp][lane + 32 * p] = best[p];
  __syncthreads();
  const int t = threadIdx.x;
  const int i = n0 + t;
  if (t < BLOCK_PTS && i < n) {
    float b = part[0][t];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) b = fminf(b, part[w][t]);
    const float x = pts[3 * i], y = pts[3 * i + 1], z = pts[3 * i + 2];
    out[i] = fmaf(x, x, fmaf(y, y, z * z)) + b;
  }
}

}  // namespace

// pts (n, 3), refs (m, 3), bias2 (m,), out (n,): float32, contiguous, on the
// device of `stream`.
THP_EXPORT int thp_min_excess2(const float* pts, const float* refs,
                               const float* bias2, float* out, int n, int m,
                               void* stream) {
  if (n < 0 || m < 0) return THP_ERR_BAD_SIZE;
  if (n == 0) return 0;
  const int blocks = (n + BLOCK_PTS - 1) / BLOCK_PTS;
  min_excess2_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      pts, refs, bias2, out, n, m);
  return thp_launch_status();
}

THP_EXPORT const char* thp_error_string(int code) {
  switch (code) {
    case THP_ERR_BAD_K:
      return "k is outside the kernel's range 1..8";
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

// K2: DPaRF binding of sample points to their K nearest cluster tokens.
//
// Replaces two Pallas kernels that compute the same math in two TPU layouts:
// transhuman_tpu/experiments/dparf.py::dparf_fused and
// transhuman_tpu/experiments/dparf2.py::dparf_fused2.  Per point p:
//   1. d^2 to every cluster centre;
//   2. the K nearest, ascending, ties to the lower centre index;
//   3. u_i = exp(-(d_i - d_0) / alpha), w_i = u_i / sum(u);
//   4. local_i = (p - c_i) . R_i and its code
//      PE_i = [local, sin(pi 2^f local), cos(pi 2^f local)] for f < NF,
//      pe = sum_i w_i PE_i  (63 values at NF = 10);
//   5. tok[v] = sum_i w_i tokens[v, idx_i, :]  for every view v.
// Outputs: tok (V, N, D), pe (N, 63), dist (N, K) (euclidean, ascending),
// and for the backward of step 5 the neighbour indices idx (N, K) int32 and
// their normalised weights w (N, K).
//
// What bounds it: the bytes written.  At V = 3, D = 192 a point writes
// 3 * 192 * 4 + 63 * 4 + K * 4 = 2.6 KB and reads 12 B; the arithmetic is
// ~3 k FP32 operations for the 300-centre scan plus 210 sincos.  The design
// writes those bytes once and coalesced, and keeps everything else on chip:
// the centres and rotations (C * 12 floats, 14 KB at C = 300) sit in shared
// memory; one thread per point scans them keeping the top K in registers by
// unrolled insertion (no (N, C) distance or weight matrix ever exists, unlike
// the TPU kernels' dense one-hot matmuls); the 63-wide code accumulates in
// registers and is staged through shared memory so the block's contiguous
// (rows, 63) slab leaves in coalesced stores; the token sum is then a 7-row
// gather per output element, spread over the whole block so that neighbouring
// threads read neighbouring floats of a token row (the 691 KB token table
// stays resident in the 50 MB L2).
#include "common.cuh"

namespace {

constexpr int NF = 10;                // frequency bands of the local code
constexpr int PE_DIM = 3 + 6 * NF;    // 63
constexpr int TILE = 128;             // points per block == threads per block
constexpr int MAX_SMEM = 232448;      // bytes a block may opt into on sm_90

template <int K>
__global__ void __launch_bounds__(TILE)
dparf_kernel(const float* __restrict__ pts, const float* __restrict__ centers,
             const float* __restrict__ rot, const float* __restrict__ tokens,
             float* __restrict__ tok, float* __restrict__ pe,
             float* __restrict__ dist, int* __restrict__ idx,
             float* __restrict__ wk, int n, int c, int v, int d,
             float alpha) {
  extern __shared__ float smem[];
  float* s_cr = smem;                    // (c, 12): centre xyz, rot row-major
  float* s_pe = s_cr + 12 * c;           // (TILE, PE_DIM)
  float* s_w = s_pe + TILE * PE_DIM;     // (TILE, K) normalised weights
  float* s_dist = s_w + TILE * K;        // (TILE, K)
  int* s_idx = reinterpret_cast<int*>(s_dist + TILE * K);  // (TILE, K)

  const int t = threadIdx.x;
  const int n0 = blockIdx.x * TILE;
  const int rows = min(TILE, n - n0);

  for (int j = t; j < c; j += TILE) {
    float* dst = s_cr + 12 * j;
    dst[0] = centers[3 * j];
    dst[1] = centers[3 * j + 1];
    dst[2] = centers[3 * j + 2];
#pragma unroll
    for (int q = 0; q < 9; ++q) dst[3 + q] = rot[9 * j + q];
  }
  __syncthreads();

  if (t < rows) {
    const int i = n0 + t;
    const float px = pts[3 * i], py = pts[3 * i + 1], pz = pts[3 * i + 2];

    // 1-2: scan the centres in index order; strict < keeps the lower index
    // first among equal distances (argmin semantics of the plain version).
    float bd[K];
    int bi[K];
#pragma unroll
    for (int q = 0; q < K; ++q) {
      bd[q] = __int_as_float(0x7f800000);
      bi[q] = 0;
    }
    for (int j = 0; j < c; ++j) {
      const float* cr = s_cr + 12 * j;
      const float dx = px - cr[0], dy = py - cr[1], dz = pz - cr[2];
      const float d2 = fmaf(dx, dx, fmaf(dy, dy, dz * dz));
      if (d2 < bd[K - 1]) {
        bool placed = false;
#pragma unroll
        for (int q = K - 1; q >= 1; --q) {
          if (!placed) {
            if (d2 < bd[q - 1]) {
              bd[q] = bd[q - 1];
              bi[q] = bi[q - 1];
            } else {
              bd[q] = d2;
              bi[q] = j;
              placed = true;
            }
          }
        }
        if (!placed) {
          bd[0] = d2;
          bi[0] = j;
        }
      }
    }

    // 3: softmax against the nearest distance (every u <= 1), normalised once
    float dk[K], u[K];
    float usum = 0.f;
#pragma unroll
    for (int q = 0; q < K; ++q) dk[q] = sqrtf(fmaxf(bd[q], 1e-12f));
#pragma unroll
    for (int q = 0; q < K; ++q) {
      u[q] = expf(-(dk[q] - dk[0]) / alpha);
      usum += u[q];
    }
    const float inv = 1.f / usum;

    // 4: the local code of every neighbour, weighted in registers
    float acc[PE_DIM];
#pragma unroll
    for (int q = 0; q < PE_DIM; ++q) acc[q] = 0.f;
#pragma unroll
    for (int q = 0; q < K; ++q) {
      const float* cr = s_cr + 12 * bi[q];
      const float rx = px - cr[0], ry = py - cr[1], rz = pz - cr[2];
      float l[3];
#pragma unroll
      for (int a = 0; a < 3; ++a)  // local_a = sum_b rel_b R[b][a]
        l[a] = rx * cr[3 + a] + ry * cr[6 + a] + rz * cr[9 + a];
#pragma unroll
      for (int a = 0; a < 3; ++a) acc[a] = fmaf(u[q], l[a], acc[a]);
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        // float(pi) * 2^f is exactly float(pi * 2^f): scaling by 2^f is exact
        const float fr = ldexpf(3.14159265358979323846f, f);
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          float s, co;
          sincosf(l[a] * fr, &s, &co);
          acc[3 + 6 * f + a] = fmaf(u[q], s, acc[3 + 6 * f + a]);
          acc[6 + 6 * f + a] = fmaf(u[q], co, acc[6 + 6 * f + a]);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < PE_DIM; ++q) s_pe[t * PE_DIM + q] = acc[q] * inv;
#pragma unroll
    for (int q = 0; q < K; ++q) {
      s_w[t * K + q] = u[q] * inv;
      s_idx[t * K + q] = bi[q];
      s_dist[t * K + q] = dk[q];
    }
  }
  __syncthreads();

  // the block's rows of pe and dist are contiguous: plain coalesced copies
  for (int j = t; j < rows * PE_DIM; j += TILE)
    pe[static_cast<size_t>(n0) * PE_DIM + j] = s_pe[j];
  for (int j = t; j < rows * K; j += TILE) {
    const size_t o = static_cast<size_t>(n0) * K + j;
    dist[o] = s_dist[j];
    idx[o] = s_idx[j];
    wk[o] = s_w[j];
  }

  // 5: one output float per thread and step; a warp covers 32 neighbouring
  // floats of one (view, point) row, so token reads and tok writes coalesce
  const int per_view = rows * d;
  for (int e = t; e < v * per_view; e += TILE) {
    const int vv = e / per_view;
    const int r = e - vv * per_view;
    const int p = r / d;
    const int dd = r - p * d;
    const float* tv = tokens + static_cast<size_t>(vv) * c * d + dd;
    float a = 0.f;
#pragma unroll
    for (int q = 0; q < K; ++q)
      a = fmaf(s_w[p * K + q],
               tv[static_cast<size_t>(s_idx[p * K + q]) * d], a);
    tok[(static_cast<size_t>(vv) * n + n0 + p) * d + dd] = a;
  }
}

template <int K>
int launch(const float* pts, const float* centers, const float* rot,
           const float* tokens, float* tok, float* pe, float* dist, int* idx,
           float* wk, int n, int c, int v, int d, float alpha,
           cudaStream_t stream) {
  const size_t smem = (12 * static_cast<size_t>(c) + TILE * (PE_DIM + 3 * K)) *
                      sizeof(float);
  if (smem > MAX_SMEM) return THP_ERR_SMEM;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        dparf_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int blocks = (n + TILE - 1) / TILE;
  dparf_kernel<K><<<blocks, TILE, smem, stream>>>(
      pts, centers, rot, tokens, tok, pe, dist, idx, wk, n, c, v, d, alpha);
  return thp_launch_status();
}

}  // namespace

// pts (n, 3), centers (c, 3), rot (c, 9) row-major 3x3, tokens (v, c, d);
// outputs tok (v, n, d), pe (n, 63), dist (n, k), idx (n, k) int32,
// w (n, k).  float32 unless stated, contiguous.
THP_EXPORT int thp_dparf(const float* pts, const float* centers,
                         const float* rot, const float* tokens, float* tok,
                         float* pe, float* dist, int* idx, float* w, int n,
                         int c, int v, int d, int k, int n_freqs, float alpha,
                         void* stream) {
  if (n_freqs != NF) return THP_ERR_BAD_FREQS;
  if (n < 0 || v < 1 || d < 1 || c < k || TILE * d > (1 << 30) / v)
    return THP_ERR_BAD_SIZE;
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define THP_DPARF_CASE(KK)                                                    \
  case KK:                                                                    \
    return launch<KK>(pts, centers, rot, tokens, tok, pe, dist, idx, w, n, c, \
                      v, d, alpha, s);
  switch (k) {
    THP_DPARF_CASE(1)
    THP_DPARF_CASE(2)
    THP_DPARF_CASE(3)
    THP_DPARF_CASE(4)
    THP_DPARF_CASE(5)
    THP_DPARF_CASE(6)
    THP_DPARF_CASE(7)
    THP_DPARF_CASE(8)
    default:
      return THP_ERR_BAD_K;
  }
#undef THP_DPARF_CASE
}

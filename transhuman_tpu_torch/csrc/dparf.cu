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
// 3 * 192 * 4 + 63 * 4 + K * 12 = 2.6 KB and reads 12 B; the arithmetic is
// ~2.4 k FP32 operations for the 300-centre scan, 210 sincos and ~8 k
// multiply-adds of the token sum.  So the stores must stream at full width
// with enough warps resident to hide the latency of the token reads, and the
// selection must not cost more than the stores.  What bounds this design
// short of that: the token sum reads K rows per row it writes (at K = 7,
// 528 MB for one 32,768-point chunk), served by L1 where neighbouring points
// share clusters and by L2 where they do not (points in random order); and
// each warp's point is one long dependent chain, of which 32 warps per SM
// hide only part.
// The design: one warp owns one point at a time, and persistent blocks of 8
// warps walk the points, so the centres and rotations (C * 13 floats,
// 15.6 KB at C = 300) are loaded into shared memory once per block, not per
// point.  No per-thread code accumulator exists, which keeps a thread at
// <= 64 registers: 4 blocks, 32 warps, per SM.
//   1-2. Lane l owns centres l, l + 32, ...; it writes their keys, d^2's bits
//        above the index (d^2, the same fmaf expression as the plain scan,
//        is +0 or more, so unsigned order is (d^2, index) order), into its
//        warp's row of shared memory and keeps its smallest.  K rounds of two
//        redux.sync minima find t, the K-th smallest of the 32 lane minima;
//        the K nearest are among the keys <= t (a larger key has those K
//        below it).  Those candidates, usually few more than K, are compacted
//        by ballot, and each one's rank among them is its rank among all
//        centres.  Ordering by (d^2, index) is the plain version's iterative
//        argmin, ties to the lowest index; K is a runtime count (one kernel
//        for K = 1..8).
//   3.   Lane q < K holds neighbour q; the weight sum adds the u in
//        neighbour order from shuffles and is inverted once.
//   4.   Lanes 0-29 take the 30 (axis, band) pairs, lanes 0-2 the linear
//        term too; each loops over the neighbours in order, recomputing its
//        local axis from shared memory, with precise sincosf on l * pi 2^f
//        (the argument reaches ~1e3 rad; __sinf or sincospif would compute
//        another function at the top band).  The 63 floats leave as one
//        contiguous row.
//   5.   The warp writes its point's V * D floats as float4 words, lane l
//        taking words l, l + 32, ... across the views with no integer
//        division; each word is the K token rows' words at the same column
//        (the 691 KB token table stays resident in the 50 MB L2), all K
//        loads in flight before the first fmaf, summed in neighbour order.
//        D % 4 != 0 or misaligned pointers take a scalar path.
// Every output keeps the arithmetic order of the one-thread-per-point kernel
// it replaced, so the two give the same bits on the same inputs.
// No tensor cores: the token sum has K non-zeros in C per row (a dense
// one-hot product would do C / K times the work), and TF32 would break the
// float32 parity.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int NF = 10;                // frequency bands of the local code
constexpr int PE_DIM = 3 + 6 * NF;    // 63
constexpr int MAX_K = 8;
constexpr int WARPS = 8;              // points in flight per block
constexpr int THREADS = 32 * WARPS;
constexpr int MIN_BLOCKS = 4;         // <= 64 registers: 32 warps per SM
constexpr int MAX_SMEM = 232448;      // bytes a block may opt into on sm_90
constexpr unsigned FULL = 0xffffffffu;

// centres as float4 (16 c), rotations (36 c, then 4 bytes of padding when c
// is odd), one row of (d^2, index) keys per warp (64 c); per warp the k
// selected keys and the neighbours and weights of its point
size_t smem_bytes(int c) {
  return (16 + 36 + 8 * WARPS) * static_cast<size_t>(c) + 4 * (c & 1) +
         WARPS * MAX_K * (8 + 4 + 4);
}

// Step 5 for one point: lane l writes words l, l + 32, ... of the point's
// (V, D) rows, each word the K token rows' words at its column (all K loads
// in flight before the first fmaf), summed in neighbour order.
template <bool VEC>
__device__ void token_sum(const float* __restrict__ tokens,
                          float* __restrict__ tok, const int* s_nb,
                          const float* s_w, int i, int n, int c, int v,
                          int d, int k, int lane) {
  if (VEC) {
    const int d4 = d >> 2;
    const float4* t4 = reinterpret_cast<const float4*>(tokens);
    float4* o4 = reinterpret_cast<float4*>(tok);
    int vv = 0, col = lane;
    while (vv < v && col >= d4) {
      col -= d4;
      ++vv;
    }
    while (vv < v) {
      const float4* tv = t4 + static_cast<size_t>(vv) * c * d4 + col;
      // all k loads in flight before the first multiply-add
      float4 x[MAX_K];
#pragma unroll
      for (int q = 0; q < MAX_K; ++q)
        if (q < k) x[q] = __ldg(tv + static_cast<size_t>(s_nb[q]) * d4);
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int q = 0; q < MAX_K; ++q) {
        if (q < k) {
          const float wq = s_w[q];
          acc.x = fmaf(wq, x[q].x, acc.x);
          acc.y = fmaf(wq, x[q].y, acc.y);
          acc.z = fmaf(wq, x[q].z, acc.z);
          acc.w = fmaf(wq, x[q].w, acc.w);
        }
      }
      o4[(static_cast<size_t>(vv) * n + i) * d4 + col] = acc;
      col += 32;
      while (vv < v && col >= d4) {
        col -= d4;
        ++vv;
      }
    }
  } else {
    int vv = 0, col = lane;
    while (vv < v && col >= d) {
      col -= d;
      ++vv;
    }
    while (vv < v) {
      const float* tv = tokens + static_cast<size_t>(vv) * c * d + col;
      float x[MAX_K];
#pragma unroll
      for (int q = 0; q < MAX_K; ++q)
        if (q < k) x[q] = __ldg(tv + static_cast<size_t>(s_nb[q]) * d);
      float acc = 0.f;
#pragma unroll
      for (int q = 0; q < MAX_K; ++q)
        if (q < k) acc = fmaf(s_w[q], x[q], acc);
      tok[(static_cast<size_t>(vv) * n + i) * d + col] = acc;
      col += 32;
      while (vv < v && col >= d) {
        col -= d;
        ++vv;
      }
    }
  }
}

// The bfloat16 token sum: words of 8 channels (VEC) or single channels,
// widened, summed in float32 in the float32 form's order, narrowed once.
template <bool VEC>
__device__ void token_sum(const unsigned short* __restrict__ tokens,
                          unsigned short* __restrict__ tok, const int* s_nb,
                          const float* s_w, int i, int n, int c, int v,
                          int d, int k, int lane) {
  const int per = VEC ? 8 : 1;  // channels per word
  const int dw = d / per;
  int vv = 0, col = lane;
  while (vv < v && col >= dw) {
    col -= dw;
    ++vv;
  }
  while (vv < v) {
    const size_t base = static_cast<size_t>(vv) * c * dw + col;
    const size_t o = (static_cast<size_t>(vv) * n + i) * dw + col;
    if (VEC) {
      const uint4* tv = reinterpret_cast<const uint4*>(tokens) + base;
      uint4 x[MAX_K];
#pragma unroll
      for (int q = 0; q < MAX_K; ++q)
        if (q < k) x[q] = __ldg(tv + static_cast<size_t>(s_nb[q]) * dw);
      float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int q = 0; q < MAX_K; ++q) {
        if (q < k) {
          const float wq = s_w[q];
          float f[8];
          thp_unpack8(x[q], f);
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[e] = fmaf(wq, f[e], acc[e]);
        }
      }
      reinterpret_cast<uint4*>(tok)[o] = thp_pack8(acc);
    } else {
      const unsigned short* tv = tokens + base;
      float x[MAX_K];
#pragma unroll
      for (int q = 0; q < MAX_K; ++q)
        if (q < k)
          x[q] = thp_bf16_to_f32(__ldg(tv + static_cast<size_t>(s_nb[q]) * d));
      float acc = 0.f;
#pragma unroll
      for (int q = 0; q < MAX_K; ++q)
        if (q < k) acc = fmaf(s_w[q], x[q], acc);
      tok[o] = thp_f32_to_bf16(acc);
    }
    col += 32;
    while (vv < v && col >= dw) {
      col -= dw;
      ++vv;
    }
  }
}

template <bool VEC, class E>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
dparf_kernel(const float* __restrict__ pts, const float* __restrict__ centers,
             const float* __restrict__ rot, const E* __restrict__ tokens,
             E* __restrict__ tok, float* __restrict__ pe,
             float* __restrict__ dist, int* __restrict__ idx,
             float* __restrict__ wk, int n, int c, int v, int d, int k,
             float alpha) {
  extern __shared__ float4 smem4[];
  float4* s_c = smem4;                                   // (c,) xyz, 0
  float* s_rot = reinterpret_cast<float*>(s_c + c);      // (c, 9) row-major
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // 9 c floats are 8-byte aligned when c is even; pad one float otherwise
  auto* s_keys = reinterpret_cast<unsigned long long*>(s_rot + 9 * c +
                                                       (c & 1));
  unsigned long long* s_key = s_keys + warp * c;         // this warp's (c,)
  unsigned long long* s_sel = s_keys + WARPS * c + warp * MAX_K;
  int* s_nb = reinterpret_cast<int*>(s_keys + WARPS * c + WARPS * MAX_K) +
              warp * MAX_K;
  float* s_w = reinterpret_cast<float*>(s_keys + WARPS * c + WARPS * MAX_K) +
               WARPS * MAX_K + warp * MAX_K;

  for (int j = threadIdx.x; j < c; j += THREADS)
    s_c[j] = make_float4(centers[3 * j], centers[3 * j + 1],
                         centers[3 * j + 2], 0.f);
  for (int j = threadIdx.x; j < 9 * c; j += THREADS) s_rot[j] = rot[j];
  __syncthreads();

  const float inf = __int_as_float(0x7f800000);
  // this lane's (axis, band) of the code; lanes 30 and 31 only shuffle
  const int ax = lane % 3, band = lane / 3;
  // float(pi) * 2^f is exactly float(pi * 2^f): scaling by 2^f is exact
  const float fr = ldexpf(3.14159265358979323846f, band);

  for (int i = blockIdx.x * WARPS + warp; i < n; i += gridDim.x * WARPS) {
    const float px = pts[3 * i], py = pts[3 * i + 1], pz = pts[3 * i + 2];

    // 1: the keys (d^2 bits << 32 | index) of this lane's centres: d^2 is
    // +0 or more, so unsigned order is (d^2, index) order
    unsigned long long kmin = ~0ull;
    for (int j = lane; j < c; j += 32) {
      const float4 cc = s_c[j];
      const float dx = px - cc.x, dy = py - cc.y, dz = pz - cc.z;
      const float d2 = fmaf(dx, dx, fmaf(dy, dy, dz * dz));
      const unsigned long long key =
          static_cast<unsigned long long>(__float_as_uint(d2)) << 32 |
          static_cast<unsigned>(j);
      s_key[j] = key;
      kmin = min(kmin, key);
    }
    // 2a: t = the k-th smallest of the 32 lane minima.  Those k keys are
    // <= t, so every key above t has k smaller ones: the k nearest are
    // among the keys <= t.
    unsigned long long t = 0;
    for (int q = 0; q < k; ++q) {
      const unsigned hi = __reduce_min_sync(FULL, static_cast<unsigned>(
                                                      kmin >> 32));
      const unsigned lo = __reduce_min_sync(
          FULL, static_cast<unsigned>(kmin >> 32) == hi
                    ? static_cast<unsigned>(kmin) : 0xffffffffu);
      t = static_cast<unsigned long long>(hi) << 32 | lo;
      if (kmin == t) kmin = ~0ull;  // keys are unique: one lane
    }
    // 2b: compact the candidates (keys <= t, at least k) to the front of
    // the row, in index order; a key moves only to a slot already read
    int ncand = 0;
    for (int base = 0; base < c; base += 32) {
      const int j = base + lane;
      const unsigned long long key = j < c ? s_key[j] : ~0ull;
      const unsigned m = __ballot_sync(FULL, key <= t);
      if (key <= t) s_key[ncand + __popc(m & ((1u << lane) - 1u))] = key;
      ncand += __popc(m);
    }
    __syncwarp();
    // 2c: a candidate's rank among the candidates is its rank among all
    // centres: the keys below it are all candidates
    for (int p = lane; p < ncand; p += 32) {
      const unsigned long long key = s_key[p];
      int rank = 0;
      for (int q = 0; q < ncand; ++q) rank += s_key[q] < key;
      if (rank < k) s_sel[rank] = key;
    }
    __syncwarp();
    float my_d2 = inf;
    int my_j = 0;
    if (lane < k) {
      const unsigned long long key = s_sel[lane];
      my_d2 = __uint_as_float(static_cast<unsigned>(key >> 32));
      my_j = static_cast<int>(key & 0xffffffffu);
    }

    // 3: softmax against the nearest distance (every u <= 1), summed in
    // neighbour order and normalised once
    const float dk = sqrtf(fmaxf(my_d2, 1e-12f));
    const float u = expf(-(dk - __shfl_sync(FULL, dk, 0)) / alpha);
    float usum = 0.f;
    float ub[MAX_K];  // the shuffles go out together, the sum stays in order
#pragma unroll
    for (int q = 0; q < MAX_K; ++q) ub[q] = __shfl_sync(FULL, u, q);
#pragma unroll
    for (int q = 0; q < MAX_K; ++q)
      if (q < k) usum += ub[q];
    const float inv = 1.f / usum;
    if (lane < k) {
      const size_t o = static_cast<size_t>(i) * k + lane;
      dist[o] = dk;
      idx[o] = my_j;
      wk[o] = u * inv;
      s_nb[lane] = my_j;
      s_w[lane] = u * inv;
    }

    // 4: the local code, one (axis, band) per lane, neighbours in order
    float acc_l = 0.f, acc_s = 0.f, acc_c = 0.f;
#pragma unroll
    for (int q = 0; q < MAX_K; ++q) {
      if (q >= k) break;
      const float uq = __shfl_sync(FULL, u, q);
      const int j = __shfl_sync(FULL, my_j, q);
      if (lane < 30) {
        const float4 cc = s_c[j];
        const float* r = s_rot + 9 * j;
        const float rx = px - cc.x, ry = py - cc.y, rz = pz - cc.z;
        // local_a = sum_b rel_b R[b][a]
        const float l = rx * r[ax] + ry * r[3 + ax] + rz * r[6 + ax];
        float s, co;
        sincosf(l * fr, &s, &co);
        acc_l = fmaf(uq, l, acc_l);
        acc_s = fmaf(uq, s, acc_s);
        acc_c = fmaf(uq, co, acc_c);
      }
    }
    float* pe_row = pe + static_cast<size_t>(i) * PE_DIM;
    if (lane < 3) pe_row[lane] = acc_l * inv;
    if (lane < 30) {
      pe_row[3 + 6 * band + ax] = acc_s * inv;
      pe_row[6 + 6 * band + ax] = acc_c * inv;
    }
    __syncwarp();  // s_nb and s_w are complete

    // 5: the token sum, word w = l, l + 32, ... of the point's (V, D) rows
    token_sum<VEC>(tokens, tok, s_nb, s_w, i, n, c, v, d, k, lane);
    __syncwarp();  // every lane has read s_nb and s_w before the next point
  }
}

template <bool VEC, class E>
int launch(const float* pts, const float* centers, const float* rot,
           const E* tokens, E* tok, float* pe, float* dist, int* idx,
           float* wk, int n, int c, int v, int d, int k, float alpha,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(c);
  if (smem > MAX_SMEM) return THP_ERR_SMEM;
  cudaError_t e = cudaSuccess;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(dparf_kernel<VEC, E>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  // persistent blocks: as many as fit on the card at once, or fewer; the
  // count is asked of the runtime once per device and size
  static thread_local int last_dev = -1, last_resident = 0;
  static thread_local size_t last_smem = 0;
  int dev = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(e);
  if (dev != last_dev || smem != last_smem) {
    int sms = 0, per_sm = 0;
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
        (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, dparf_kernel<VEC, E>, THREADS, smem)) != cudaSuccess)
      return static_cast<int>(e);
    last_dev = dev;
    last_smem = smem;
    last_resident = sms * per_sm > 0 ? sms * per_sm : 1;
  }
  const long long want = (static_cast<long long>(n) + WARPS - 1) / WARPS;
  const int blocks = static_cast<int>(want < last_resident ? want
                                                           : last_resident);
  dparf_kernel<VEC, E><<<blocks, THREADS, smem, stream>>>(
      pts, centers, rot, tokens, tok, pe, dist, idx, wk, n, c, v, d, k,
      alpha);
  return thp_launch_status();
}

template <class E>
int dparf_entry(const float* pts, const float* centers, const float* rot,
                const E* tokens, E* tok, float* pe, float* dist, int* idx,
                float* w, int n, int c, int v, int d, int k, int n_freqs,
                float alpha, void* stream) {
  if (n_freqs != NF) return THP_ERR_BAD_FREQS;
  if (k < 1 || k > MAX_K) return THP_ERR_BAD_K;
  if (n < 0 || v < 1 || d < 1 || c < k) return THP_ERR_BAD_SIZE;
  if (n == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  // 16-byte words: 4 float32 or 8 bf16 channels
  const bool vec = d % (16 / static_cast<int>(sizeof(E))) == 0 &&
                   ((reinterpret_cast<uintptr_t>(tokens) |
                     reinterpret_cast<uintptr_t>(tok)) & 15) == 0;
  return vec ? launch<true>(pts, centers, rot, tokens, tok, pe, dist, idx, w,
                            n, c, v, d, k, alpha, s)
             : launch<false>(pts, centers, rot, tokens, tok, pe, dist, idx,
                             w, n, c, v, d, k, alpha, s);
}

}  // namespace

// pts (n, 3), centers (c, 3), rot (c, 9) row-major 3x3, tokens (v, c, d);
// outputs tok (v, n, d), pe (n, 63), dist (n, k), idx (n, k) int32,
// w (n, k).  float32 unless stated, contiguous.  1 <= k <= min(8, c).
THP_EXPORT int thp_dparf(const float* pts, const float* centers,
                         const float* rot, const float* tokens, float* tok,
                         float* pe, float* dist, int* idx, float* w, int n,
                         int c, int v, int d, int k, int n_freqs, float alpha,
                         void* stream) {
  return dparf_entry(pts, centers, rot, tokens, tok, pe, dist, idx, w, n, c,
                     v, d, k, n_freqs, alpha, stream);
}

// As thp_dparf with tokens and tok bfloat16 (raw 16-bit words): the token
// sum is taken in float32 in thp_dparf's order and narrowed once, so tok is
// thp_dparf's tok on the widened tokens, cast; pe, dist, idx and w are its
// outputs bit for bit.
THP_EXPORT int thp_dparf_bf16(const float* pts, const float* centers,
                              const float* rot, const void* tokens, void* tok,
                              float* pe, float* dist, int* idx, float* w,
                              int n, int c, int v, int d, int k, int n_freqs,
                              float alpha, void* stream) {
  return dparf_entry(pts, centers, rot,
                     static_cast<const unsigned short*>(tokens),
                     static_cast<unsigned short*>(tok), pe, dist, idx, w, n,
                     c, v, d, k, n_freqs, alpha, stream);
}

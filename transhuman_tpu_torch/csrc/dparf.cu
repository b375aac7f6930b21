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
//
// The bfloat16 form (thp_dparf_bf16, the bf16 network's: every config of
// the repo serves in bf16) has a body of its own.  Its contract: tok is
// thp_dparf's tok on the widened tokens, cast once (round to nearest even),
// and pe, dist, idx and w are thp_dparf's bit for bit; so it keeps the same
// fmaf expression for d^2, (d^2, index) order with ties to the lowest
// index, and every sum of the softmax, the code and the tokens in neighbour
// order, and thp_dparf (above) keeps the one-warp-a-point body.
// What bounds it at the main path's size: the main path launches it once a
// 512-ray chunk on the chunk's cull survivors, about 26,000 points at the
// serve request (80% of the chunk's 32,768; PERF.md), so a launch holds
// many points a resident warp and the one-warp-a-point body pays, for each
// point in turn, a chain that leaves most of its lanes idle (K rounds of
// warp minima, a ballot compaction, a rank loop over few candidates, the
// code on 30 of 32 lanes, a third token round on 8).  The bound is the
// bytes written (1,488 B a point at D = 192); what holds this body short of
// it is the instruction rate and the latency of each phase between the
// block's barriers.  The design spreads every phase over the block:
//   - persistent blocks of 8 warps walk tiles of TP = 16 consecutive
//     points; each block copies the centres and rotations into shared
//     memory once (cp.async, every copy in flight at once; the copy is a
//     small share of a launch, measured by making it twice, so a bulk (TMA)
//     copy has little to win), and loads its next tile's points while it
//     works on this one;
//   - 1-2: TG = 16 lanes a point.  Each lane scans C / 16 centres for its
//     nearest, keeping each d^2 in shared memory (C <= 384); a bitonic
//     sort of the 16 lane minima across the lanes gives t, the k-th of
//     them, which bounds the k-th nearest; the keys <= t (some tens) are
//     listed in shared memory and each one's rank among them is its rank
//     among all centres.  A point with more candidates than its list holds
//     (many centres in one lane's share close to it) takes k rounds of the
//     group's least key instead;
//   - 3: lane q < k of the group takes neighbour q, the u summed in order
//     from shuffles, and forms the point's three local coordinates in that
//     neighbour's frame once for the code's 10 bands;
//   - 4-5: one pool of tasks over the block's threads: (point, axis, band)
//     for the code, (point, word) for the token sum over every view, so
//     that the code's arithmetic and the token sum's loads run side by
//     side.  A token task loads the k neighbours' 16-byte words of one
//     column (all k in flight) straight from L1/L2: the few rows a tile
//     reads stay in L1, and staging them in shared memory (tried) was
//     slower, the shared memory it took shrinking L1.  Output rows leave as
//     contiguous ranges of 16-byte words.
// 3 blocks (24 warps) an SM: at 4 the token task spills.  Other tile sizes
// (8, 32 points), one tile a block and tiles resized to even out the
// blocks' last round measured slower on the H100 at the survivor size.
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

template <bool VEC>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
dparf_kernel(const float* __restrict__ pts, const float* __restrict__ centers,
             const float* __restrict__ rot, const float* __restrict__ tokens,
             float* __restrict__ tok, float* __restrict__ pe,
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

template <bool VEC>
int launch(const float* pts, const float* centers, const float* rot,
           const float* tokens, float* tok, float* pe, float* dist, int* idx,
           float* wk, int n, int c, int v, int d, int k, float alpha,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(c);
  if (smem > MAX_SMEM) return THP_ERR_SMEM;
  const void* fn = reinterpret_cast<const void*>(dparf_kernel<VEC>);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  // persistent blocks: as many as fit on the card at once, or fewer
  int resident = 0;
  const int e = thp_resident_blocks(fn, THREADS, smem, &resident);
  if (e != 0) return e;
  const long long want = (static_cast<long long>(n) + WARPS - 1) / WARPS;
  const int blocks = static_cast<int>(want < resident ? want : resident);
  dparf_kernel<VEC><<<blocks, THREADS, smem, stream>>>(
      pts, centers, rot, tokens, tok, pe, dist, idx, wk, n, c, v, d, k,
      alpha);
  return thp_launch_status();
}

// ------------------------------------------------------------ bf16 form
// One tile of TP consecutive points at a time per block (persistent
// blocks); TG = BTHREADS / TP lanes of one warp select each point's
// neighbours, then the whole block spreads the code over the tile's
// (point, axis, band) triples and the token sum over its (point, word)
// pairs.
constexpr int BTHREADS = 256;         // threads a block
constexpr int TP = 16;                // points a tile
constexpr int TG = BTHREADS / TP;     // lanes a point in the selection
constexpr int CAND = 48;              // candidates a point lists
constexpr int D2_MAX = 384;           // most centres whose d^2 a tile keeps
constexpr int MIN_BLOCKS_BF16 = 3;    // <= 85 registers: 24 warps per SM

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// d^2 by the plain scan's fmaf expression, and the key (d^2 bits << 32 |
// j): d^2 is +0 or more, so unsigned order is (d^2, j) order
__device__ __forceinline__ float dist2(float px, float py, float pz,
                                       float4 cc) {
  const float dx = px - cc.x, dy = py - cc.y, dz = pz - cc.z;
  return fmaf(dx, dx, fmaf(dy, dy, dz * dz));
}
__device__ __forceinline__ unsigned long long dist_key(float d2, int j) {
  return static_cast<unsigned long long>(__float_as_uint(d2)) << 32 |
         static_cast<unsigned>(j);
}

// A token word: 8 bf16 channels in 16 bytes (VEC) or one channel, widened
// and added to float32 sums one neighbour at a time (thp_dparf's order),
// narrowed once.
template <bool VEC> struct TokWord;
template <> struct TokWord<true> {
  using T = uint4;
  static constexpr int CH = 8;
  static __device__ void add(float* acc, const T& x, float w) {
    float f[8];
    thp_unpack8(x, f);
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] = fmaf(w, f[e], acc[e]);
  }
  static __device__ T pack(const float* acc) { return thp_pack8(acc); }
};
template <> struct TokWord<false> {
  using T = unsigned short;
  static constexpr int CH = 1;
  static __device__ void add(float* acc, T x, float w) {
    acc[0] = fmaf(w, thp_bf16_to_f32(x), acc[0]);
  }
  static __device__ T pack(const float* acc) { return thp_f32_to_bf16(acc[0]); }
};

// shared memory of the bf16 kernel: centres as float4 (16 c), the tile's
// points (16 TP), candidate and selected keys (8 TP (CAND + MAX_K)),
// rotations (36 c), per point the candidate count, the neighbours, u, w,
// distances and 1 / sum(u) (4 TP (2 + 4 MAX_K)), the local coordinates in
// each neighbour's frame (12 TP MAX_K), and the tile's d^2 to every
// centre (4 TP c) when c <= D2_MAX
size_t bf16_smem_bytes(int c) {
  return (52 + (c <= D2_MAX ? 4 * TP : 0)) * static_cast<size_t>(c) +
         16 * TP + 8 * TP * (CAND + MAX_K) + 4 * TP * (2 + 4 * MAX_K) +
         12 * TP * MAX_K;
}

template <bool VEC>
__global__ void __launch_bounds__(BTHREADS, MIN_BLOCKS_BF16)
dparf_bf16_kernel(const float* __restrict__ pts,
                  const float* __restrict__ centers,
                  const float* __restrict__ rot,
                  const unsigned short* __restrict__ tokens,
                  unsigned short* __restrict__ tok, float* __restrict__ pe,
                  float* __restrict__ dist, int* __restrict__ idx,
                  float* __restrict__ wk, int n, int c, int v, int d, int k,
                  float alpha) {
  using Tok = TokWord<VEC>;
  using W = typename Tok::T;
  const int dw = VEC ? d / 8 : d;  // words of a token row
  extern __shared__ float4 smem4[];
  float4* s_c = smem4;                                      // (c,)
  float4* s_pt = s_c + c;                                   // (TP,)
  auto* s_cand = reinterpret_cast<unsigned long long*>(s_pt + TP);  // (TP, CAND)
  unsigned long long* s_sel = s_cand + TP * CAND;           // (TP, MAX_K)
  float* s_rot = reinterpret_cast<float*>(s_sel + TP * MAX_K);  // (c, 9)
  int* s_ncand = reinterpret_cast<int*>(s_rot + 9 * c);     // (TP,)
  int* s_nb = s_ncand + TP;                                 // (TP, MAX_K)
  float* s_u = reinterpret_cast<float*>(s_nb + TP * MAX_K); // (TP, MAX_K)
  float* s_w = s_u + TP * MAX_K;                            // (TP, MAX_K)
  float* s_dist = s_w + TP * MAX_K;                         // (TP, MAX_K)
  float* s_inv = s_dist + TP * MAX_K;                       // (TP,)
  float* s_l = s_inv + TP;                                  // (TP, MAX_K, 3)
  unsigned* s_d2 = reinterpret_cast<unsigned*>(s_l + TP * MAX_K * 3); // (TP, c)
  const bool keep_d2 = c <= D2_MAX;

  // the prologue: every copy of the centres and rotations in flight at once
  for (int j = threadIdx.x; j < c; j += BTHREADS) {
    cp_async4(&s_c[j].x, centers + 3 * j);
    cp_async4(&s_c[j].y, centers + 3 * j + 1);
    cp_async4(&s_c[j].z, centers + 3 * j + 2);
  }
  for (int j = threadIdx.x; j < 9 * c; j += BTHREADS)
    cp_async4(s_rot + j, rot + j);
  cp_async_wait_all();
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int p = threadIdx.x / TG, g = threadIdx.x % TG;  // selection roles
  const int base = lane & ~(TG - 1);                     // the group's lane 0
  const unsigned gmask = TG == 32 ? FULL : ((1u << TG) - 1) << base;
  const float inf = __int_as_float(0x7f800000);
  const int ntiles = (n + TP - 1) / TP;
  // this lane's point of its block's first tile, loaded ahead as every
  // next one is
  float4 nxt = make_float4(0.f, 0.f, 0.f, 0.f);
  const int step = static_cast<int>(gridDim.x) * TP;  // points a round
  if (static_cast<int>(blockIdx.x) * TP + p < n) {
    const int i = static_cast<int>(blockIdx.x) * TP + p;
    nxt = make_float4(pts[3 * i], pts[3 * i + 1], pts[3 * i + 2], 0.f);
  }
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int i0 = tile * TP, np = min(TP, n - i0);
    const bool live = p < np;
    const int i = i0 + p;

    // 1-2: the k nearest of point p, over TG lanes.  t = the k-th smallest
    // of the lanes' nearest keys bounds the k-th nearest: the k nearest
    // are among the keys <= t, listed in shared memory and ranked there
    // (a key's rank among them is its rank among all centres).
    const float px = nxt.x, py = nxt.y, pz = nxt.z;
    if (live && g == 0) {
      s_pt[p] = nxt;
      s_ncand[p] = 0;
    }
    // the next tile's point, in flight through this tile
    const int in = i + step;
    if (in < n)
      nxt = make_float4(pts[3 * in], pts[3 * in + 1], pts[3 * in + 2], 0.f);
    // this lane's nearest, the lowest index on ties; d^2's bits compare as
    // the keys do (inf and NaN after every distance)
    unsigned bmin = ~0u;
    int jmin = 0;
    unsigned* d2p = s_d2 + p * c;  // kept for the second pass
    if (live)
      for (int j = g; j < c; j += TG) {
        const unsigned b = __float_as_uint(dist2(px, py, pz, s_c[j]));
        if (keep_d2) d2p[j] = b;
        if (b < bmin) {
          bmin = b;
          jmin = j;
        }
      }
    unsigned long long key = bmin == ~0u ? ~0ull : dist_key(
        __uint_as_float(bmin), jmin);
    // bitonic sort of the group's minima, ascending over its lanes
#pragma unroll
    for (int size = 2; size <= TG; size <<= 1) {
#pragma unroll
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        const unsigned long long o = __shfl_xor_sync(FULL, key, stride);
        const bool lo = (g & stride) == 0, up = (g & size) == 0;
        key = lo == up ? min(key, o) : max(key, o);
      }
    }
    // every key <= t has d^2 <= t's; those of d^2 equal to t's and a
    // higher index are listed too, and ranked below the k nearest
    const unsigned t2 = static_cast<unsigned>(
        __shfl_sync(FULL, key, base + k - 1) >> 32);
    __syncwarp();
    unsigned long long* cand = s_cand + p * CAND;
    if (live)
      for (int j = g; j < c; j += TG) {
        const unsigned b = keep_d2
                               ? d2p[j]
                               : __float_as_uint(dist2(px, py, pz, s_c[j]));
        if (b <= t2) {
          const int slot = atomicAdd(s_ncand + p, 1);
          if (slot < CAND) cand[slot] = dist_key(__uint_as_float(b), j);
        }
      }
    __syncwarp();
    unsigned long long* sel = s_sel + p * MAX_K;
    const int nc = live ? s_ncand[p] : 0;
    if (nc <= CAND) {
      for (int r = g; r < nc; r += TG) {
        const unsigned long long kr = cand[r];
        int rank = 0;
        for (int q = 0; q < nc; ++q) rank += cand[q] < kr;
        if (rank < k) sel[rank] = kr;
      }
    } else {
      // more candidates than the list holds (one lane's share holds many
      // centres nearer than most lanes' nearest): k rounds of the group's
      // least key from lo up
      unsigned long long lo = 0;
      for (int q = 0; q < k; ++q) {
        unsigned long long m = ~0ull;
        for (int j = g; j < c; j += TG) {
          const unsigned long long kj = dist_key(dist2(px, py, pz, s_c[j]), j);
          if (kj >= lo && kj < m) m = kj;
        }
#pragma unroll
        for (int s = TG / 2; s > 0; s >>= 1)
          m = min(m, __shfl_xor_sync(gmask, m, s));
        if (g == 0) sel[q] = m;
        lo = m + 1;
      }
    }
    __syncwarp();

    // 3: softmax against the nearest distance (every u <= 1), summed in
    // neighbour order and normalised once; lane g holds neighbour g and
    // forms the point's local coordinates in its frame for the code
    float my_d2 = inf;
    int my_j = 0;
    if (live && g < k) {
      const unsigned long long kg = sel[g];
      my_d2 = __uint_as_float(static_cast<unsigned>(kg >> 32));
      my_j = static_cast<int>(kg & 0xffffffffu);
    }
    const float dk = sqrtf(fmaxf(my_d2, 1e-12f));
    const float u = expf(-(dk - __shfl_sync(FULL, dk, base)) / alpha);
    float usum = 0.f;
    float ub[MAX_K];  // the shuffles go out together, the sum stays in order
#pragma unroll
    for (int q = 0; q < MAX_K; ++q) ub[q] = __shfl_sync(FULL, u, base + q);
#pragma unroll
    for (int q = 0; q < MAX_K; ++q)
      if (q < k) usum += ub[q];
    const float inv = 1.f / usum;
    if (live && g < k) {
      const int o = p * MAX_K + g;
      s_nb[o] = my_j;
      s_u[o] = u;
      s_w[o] = u * inv;
      s_dist[o] = dk;
      const float4 cc = s_c[my_j];
      const float* r = s_rot + 9 * my_j;
      const float rx = px - cc.x, ry = py - cc.y, rz = pz - cc.z;
      // local_a = sum_b rel_b R[b][a], thp_dparf's expression
#pragma unroll
      for (int ax = 0; ax < 3; ++ax)
        s_l[3 * o + ax] = rx * r[ax] + ry * r[3 + ax] + rz * r[6 + ax];
    }
    if (live && g == 0) s_inv[p] = inv;
    __syncthreads();

    // dist, idx and w: the tile's rows are one contiguous range
    for (int f = threadIdx.x; f < np * k; f += BTHREADS) {
      const int pp = f / k, o = pp * MAX_K + f - pp * k;
      const size_t at = static_cast<size_t>(i0) * k + f;
      dist[at] = s_dist[o];
      idx[at] = s_nb[o];
      wk[at] = s_w[o];
    }
    // 4 and 5 from one pool of tasks, so that the code's arithmetic and
    // the token sum's loads run side by side: (point, axis, band) tasks of
    // the code, then (point, word) tasks of the token sum
    const int ncode = np * 30;
    for (int f = threadIdx.x; f < ncode + np * dw; f += BTHREADS) {
      if (f < ncode) {
        // 4: the local code, neighbours in order
        const int pp = f / 30, ab = f - 30 * pp;
        const int ax = ab % 3, band = ab / 3;
        // float(pi) * 2^f is exactly float(pi * 2^f): scaling by 2^f is
        // exact
        const float fr = ldexpf(3.14159265358979323846f, band);
        const float4 pt = s_pt[pp];
        float acc_l = 0.f, acc_s = 0.f, acc_c = 0.f;
#pragma unroll
        for (int q = 0; q < MAX_K; ++q) {
          if (q >= k) break;
          const float uq = s_u[pp * MAX_K + q];
          const float l = s_l[3 * (pp * MAX_K + q) + ax];
          float sn, co;
          sincosf(l * fr, &sn, &co);
          acc_l = fmaf(uq, l, acc_l);
          acc_s = fmaf(uq, sn, acc_s);
          acc_c = fmaf(uq, co, acc_c);
        }
        const float iv = s_inv[pp];
        float* pe_row = pe + static_cast<size_t>(i0 + pp) * PE_DIM;
        if (band == 0) pe_row[ax] = acc_l * iv;
        pe_row[3 + 6 * band + ax] = acc_s * iv;
        pe_row[6 + 6 * band + ax] = acc_c * iv;
        continue;
      }
      // 5: the token sum over every view: each word the k neighbours'
      // words at its column, all k loads in flight (L1 holds the few rows
      // a tile reads), summed in neighbour order; a view's rows of the
      // tile are one contiguous range
      const int ft = f - ncode, pp = ft / dw, col = ft - pp * dw;
      const int* nb = s_nb + pp * MAX_K;
      const float* w = s_w + pp * MAX_K;
      for (int vv = 0; vv < v; ++vv) {
        const W* tv = reinterpret_cast<const W*>(tokens) +
                      static_cast<size_t>(vv) * c * dw;
        W x[MAX_K];
#pragma unroll
        for (int q = 0; q < MAX_K; ++q)
          if (q < k) x[q] = __ldg(tv + nb[q] * dw + col);
        float acc[Tok::CH];
#pragma unroll
        for (int e = 0; e < Tok::CH; ++e) acc[e] = 0.f;
#pragma unroll
        for (int q = 0; q < MAX_K; ++q)
          if (q < k) Tok::add(acc, x[q], w[q]);
        reinterpret_cast<W*>(tok)[(static_cast<size_t>(vv) * n + i0) * dw +
                                  ft] = Tok::pack(acc);
      }
    }
    __syncthreads();  // s_nb, s_w, s_u are read before the next tile
  }
}

template <bool VEC>
int launch_bf16(const float* pts, const float* centers, const float* rot,
                const unsigned short* tokens, unsigned short* tok, float* pe,
                float* dist, int* idx, float* wk, int n, int c, int v, int d,
                int k, float alpha, cudaStream_t stream) {
  const size_t smem = bf16_smem_bytes(c);
  if (smem > MAX_SMEM) return THP_ERR_SMEM;
  const void* fn = reinterpret_cast<const void*>(dparf_bf16_kernel<VEC>);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  int resident = 0;
  const int e = thp_resident_blocks(fn, BTHREADS, smem, &resident);
  if (e != 0) return e;
  const int tiles = (n + TP - 1) / TP;
  dparf_bf16_kernel<VEC>
      <<<tiles < resident ? tiles : resident, BTHREADS, smem, stream>>>(
          pts, centers, rot, tokens, tok, pe, dist, idx, wk, n, c, v, d, k,
          alpha);
  return thp_launch_status();
}

// the arguments both forms refuse; 0 when they are good
int check_args(int n, int c, int v, int d, int k, int n_freqs) {
  if (n_freqs != NF) return THP_ERR_BAD_FREQS;
  if (k < 1 || k > MAX_K) return THP_ERR_BAD_K;
  if (n < 0 || v < 1 || d < 1 || c < k) return THP_ERR_BAD_SIZE;
  return 0;
}

// 16-byte words: 4 float32 or 8 bf16 channels of d, tokens and tok aligned
bool vec_words(int d, int per_word, const void* tokens, const void* tok) {
  return d % per_word == 0 && ((reinterpret_cast<uintptr_t>(tokens) |
                                reinterpret_cast<uintptr_t>(tok)) & 15) == 0;
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
  if (const int bad = check_args(n, c, v, d, k, n_freqs)) return bad;
  if (n == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  return vec_words(d, 4, tokens, tok)
             ? launch<true>(pts, centers, rot, tokens, tok, pe, dist, idx, w,
                            n, c, v, d, k, alpha, s)
             : launch<false>(pts, centers, rot, tokens, tok, pe, dist, idx,
                             w, n, c, v, d, k, alpha, s);
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
  if (const int bad = check_args(n, c, v, d, k, n_freqs)) return bad;
  if (n == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* t = static_cast<const unsigned short*>(tokens);
  auto* o = static_cast<unsigned short*>(tok);
  return vec_words(d, 8, tokens, tok)
             ? launch_bf16<true>(pts, centers, rot, t, o, pe, dist, idx, w,
                                 n, c, v, d, k, alpha, s)
             : launch_bf16<false>(pts, centers, rot, t, o, pe, dist, idx, w,
                                  n, c, v, d, k, alpha, s);
}

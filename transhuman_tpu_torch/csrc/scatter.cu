// K3: the d_feat backward of the bilinear feature fetch.
//
// Replaces transhuman_tpu/experiments/streamscatter.py::dfeat_scatter_sorted
// (Pallas, TPU).  For every view v and point n with pre-clamped base texel
// id i = ids[v, n] and tap weights w4[v, n] = ((1-wx)(1-wy), wx(1-wy),
// (1-wx)wy, wx wy):
//   out[v, i + {0, dx, dy, dy+dx}, :] += w4[v, n, tap] * g[v, n, :]
// with dx = 1, dy = Wf on any map wider and taller than one texel (and any
// dx, dy >= 0 in general: the TPU scatter probe's taps +0..+3 are dx = 1,
// dy = 2).  out (V, hw, C) holds 0 at every texel that no tap touches.
//
// What bounds it: device memory.  At the train pixel shape (N = 153,600
// points, C = 384, a 512x512 map, V = 3) it must read 708 MB of cotangent
// rows and write the 1.2 GB map: ~0.58 ms at 3.35 TB/s.  The TPU kernel's
// window / residual / while_loop machinery works around Mosaic's store
// alignment and has no job here.  The caller sorts the base ids of each
// view (torch.sort, stable: glue, like the JAX package's argsort), so equal
// ids form runs; a train batch holds ~30 points per touched texel and
// touches ~2.5% of the map's texels, a painting batch ~1.1 and ~7%.  No
// atomics: every sum is taken in a fixed order, so the map is the same
// bits on every call.  The caller zero-fills the map (the untouched rows,
// at the card's write rate, while the host reads the segment count), then:
// 1. segments: each run is cut into segments of at most SEG sorted
//    positions (a segment also starts wherever the position within its view
//    is a multiple of SEG).  One thread per position records where its
//    segment starts and, per (view, base id), the range of its segments
//    [first, last + 1) in a dense (V * hw) table, zeroed (empty) by the
//    caller.
// 2. segment sums: one block per tile of SEG sorted positions (a tile
//    holds whole segments) reads each cotangent row once, R rows in flight,
//    and writes each segment's four tap-weighted sums
//    S[s, a, :] = sum_n w4[n, a] g[n, :] to a compact table (~140 MB at the
//    pixel shape) where the segment ends.
// 3. touched rows: each touched texel t has one owner among the (segment,
//    tap) pairs that name it, which sums, for each tap a, the segments of
//    base id t - off[a] in order and writes the row.  Lookups hold for any
//    base id: where two offsets coincide (a map one texel wide or tall)
//    both taps land on t and both are summed.
// The touched rows are written twice (zeros, then sums): writers that
// wrote every row once, zeros included, measured slower on the H100 than
// the zero-fill plus this second write of ~3% of the rows.  Segments bound
// the work of one thread block or warp: the texel of a run of 60,000
// masked points sums ~940 segment rows, not 60,000 cotangent rows.
//
// The bfloat16 form (thp_dfeat_scatter_bf16) reads bf16 cotangent rows and
// writes a bf16 map: half the bytes of the float32 form's g and map (the
// pixel map is 604 MB, not 1.21 GB).  Stage 2 widens each channel to
// float32 and keeps the float32 segment sums; stage 3 sums them in the
// float32 form's order and narrows each texel once (round to nearest
// even): the map is the float32 form's on the widened rows, cast, bit for
// bit, and the same bits on every call.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;  // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int SEG = 64;       // sorted positions per tile and segment
constexpr int SUM_THREADS = 128;  // stage 2: channels over the block
constexpr int CPT = 3;        // channels per thread per chunk: C = 384 in one
constexpr int R = 4;          // cotangent rows in flight per step
constexpr int QW = 3;         // float4 words per lane at once in stage 3
constexpr int ITEMS = 16;     // (segment, tap) items per warp in stage 3

// one channel of a cotangent row, widened to float32
__device__ __forceinline__ float load_g(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_g(const unsigned short* p) {
  return thp_bf16_to_f32(__ldg(p));
}

// word q of the map: a float4 (4 channels) or one channel, narrowed once
// for a bf16 map
__device__ __forceinline__ void store_word(float* out, size_t q,
                                           const float4& a) {
  reinterpret_cast<float4*>(out)[q] = a;
}
__device__ __forceinline__ void store_word(float* out, size_t q, float a) {
  out[q] = a;
}
__device__ __forceinline__ void store_word(unsigned short* out, size_t q,
                                           const float4& a) {
  reinterpret_cast<uint2*>(out)[q] =
      make_uint2(thp_pack2(a.x, a.y), thp_pack2(a.z, a.w));
}
__device__ __forceinline__ void store_word(unsigned short* out, size_t q,
                                           float a) {
  out[q] = thp_f32_to_bf16(a);
}

__global__ void segments_kernel(const int* __restrict__ ids,
                                const int* __restrict__ seg_end,
                                int* __restrict__ seg_start,
                                int2* __restrict__ ranges, int v, int n,
                                int hw) {
  const long long total = static_cast<long long>(v) * n;
  const long long p = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (p >= total) return;
  const int vv = static_cast<int>(p / n);
  const int i = static_cast<int>(p - static_cast<long long>(vv) * n);
  const int id = ids[p];
  const bool run_start = i == 0 || ids[p - 1] != id;
  const bool run_end = i == n - 1 || ids[p + 1] != id;
  const int s = seg_end[p] - 1;  // seg_end: the inclusive count of starts
  if (run_start || i % SEG == 0) seg_start[s] = static_cast<int>(p);
  int2* r = ranges + static_cast<size_t>(vv) * hw + id;
  if (run_start) r->x = s;
  if (run_end) r->y = s + 1;
}

// Stage 2: one block per tile of SEG sorted positions of one view (every
// tile starts a segment, so no segment crosses a tile).  The tile's source
// rows, weights and segment numbers are staged in shared memory; each
// thread owns CPT channels of a chunk of SUM_THREADS * CPT (a warp reads 32
// neighbouring floats of a cotangent row), walks the tile's rows in order,
// R at a time with all their loads issued first, and writes a segment's
// four tap-weighted sums S[s, a, :] = sum_n w4[n, a] g[n, :] where the
// segment ends.  The walk is the same for every thread, so the flushes
// never diverge.
template <class G>
__global__ void __launch_bounds__(SUM_THREADS)
segment_sums_kernel(const int* __restrict__ seg_end,
                    const int* __restrict__ order,
                    const G* __restrict__ g,
                    const float* __restrict__ w4, float* __restrict__ sums,
                    int n, int c) {
  __shared__ int s_row[SEG];
  __shared__ int s_seg[SEG + 1];
  __shared__ float4 s_w[SEG];
  const int t = threadIdx.x;
  const size_t vn = static_cast<size_t>(blockIdx.y) * n;
  const int p0 = blockIdx.x * SEG;
  const int rows = min(SEG, n - p0);
  for (int j = t; j < rows; j += SUM_THREADS) {
    const int r = order[vn + p0 + j];
    s_row[j] = r;
    s_seg[j] = seg_end[vn + p0 + j] - 1;
    const float* wr = w4 + (vn + r) * 4;
    s_w[j] = make_float4(wr[0], wr[1], wr[2], wr[3]);
  }
  if (t == 0) s_seg[rows] = -1;  // the tile's last segment ends with it
  __syncthreads();
  const G* gv = g + vn * c;
  for (int c0 = 0; c0 < c; c0 += SUM_THREADS * CPT) {
    float acc[4][CPT];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int k = 0; k < CPT; ++k) acc[a][k] = 0.f;
    for (int j = 0; j < rows; j += R) {
      float x[R][CPT];
#pragma unroll
      for (int u = 0; u < R; ++u) {
        const G* row = gv + static_cast<size_t>(s_row[min(j + u, rows -
                                                          1)]) * c;
#pragma unroll
        for (int k = 0; k < CPT; ++k) {
          const int ch = c0 + t + k * SUM_THREADS;
          x[u][k] = j + u < rows && ch < c ? load_g(row + ch) : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < R; ++u) {
        if (j + u >= rows) break;  // uniform across the block
        const float4 w = s_w[j + u];
        const float wa[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int k = 0; k < CPT; ++k)
            acc[a][k] = fmaf(wa[a], x[u][k], acc[a][k]);
        const int sg = s_seg[j + u];
        if (s_seg[j + u + 1] != sg) {  // the segment ends here: flush
          float* out = sums + static_cast<size_t>(sg) * 4 * c;
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int k = 0; k < CPT; ++k) {
              const int ch = c0 + t + k * SUM_THREADS;
              if (ch < c) out[a * c + ch] = acc[a][k];
              acc[a][k] = 0.f;
            }
        }
      }
    }
  }
}

// Stage 3, after the map is zeroed.  A segment that starts its run, with
// tap a, names texel t = base id + off[a]; the first tap (in tap order) of
// t that any run reaches owns t, so every touched texel is written by
// exactly one owner.  A warp takes ITEMS (segment, tap) items, one per lane,
// finds its owners, then writes each owned texel with the whole warp: word
// q of t sums, for each tap b, word q of the segments of base id
// t - off[b] in order, the first segment row of every tap and all the
// lane's words loaded together (most touched texels have one segment per
// tap).
template <bool VEC, class O>
__global__ void __launch_bounds__(THREADS)
touched_rows_kernel(const int* __restrict__ ids_sorted,
                    const int* __restrict__ seg_start,
                    const int2* __restrict__ ranges,
                    const float* __restrict__ sums, O* __restrict__ out,
                    int n, int c, int hw, int nseg, int4 off) {
  using W = ThpWord<VEC>;
  using V = typename W::T;
  const int lane = threadIdx.x & 31;
  const int nw = VEC ? c / 4 : c;
  const int item = ((blockIdx.x * THREADS + threadIdx.x) >> 5) * ITEMS + lane;
  const int offs[4] = {off.x, off.y, off.z, off.w};
  // this lane's item: is it the owner of a texel, and which
  bool owner = false;
  int key = 0;
  int2 rg[4] = {};
  if (lane < ITEMS && item < 4 * nseg) {
    const int s = item >> 2, a = item & 3;
    const int p0 = seg_start[s];
    const int view = p0 / n * hw;  // the first key of the segment's view
    const int id = ids_sorted[p0];
    const int t = id + offs[a];    // the texel within its view
#pragma unroll
    for (int b = 0; b < 4; ++b)
      rg[b] = t >= offs[b] ? ranges[view + t - offs[b]] : make_int2(0, 0);
    owner = rg[a].x == s;  // s starts its run
#pragma unroll
    for (int b = 0; b < 3; ++b)
      if (b < a && rg[b].y > rg[b].x) owner = false;  // an earlier tap owns t
    key = view + t;
  }
  const V* sv = reinterpret_cast<const V*>(sums);
  unsigned owners = __ballot_sync(0xffffffffu, owner);
  while (owners) {
    const int src = __ffs(owners) - 1;
    owners &= owners - 1;
    const int k2 = __shfl_sync(0xffffffffu, key, src);
    int lo[4], hi[4];
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      lo[b] = __shfl_sync(0xffffffffu, rg[b].x, src);
      hi[b] = __shfl_sync(0xffffffffu, rg[b].y, src);
    }
    const size_t o = static_cast<size_t>(k2) * nw;
    for (int q0 = lane; q0 < nw; q0 += 32 * QW) {
      V x[4][QW];
#pragma unroll
      for (int b = 0; b < 4; ++b)
#pragma unroll
        for (int k = 0; k < QW; ++k) {
          const int q = q0 + 32 * k;
          if (lo[b] < hi[b] && q < nw)
            x[b][k] = sv[(static_cast<size_t>(lo[b]) * 4 + b) * nw + q];
        }
#pragma unroll
      for (int k = 0; k < QW; ++k) {
        const int q = q0 + 32 * k;
        if (q >= nw) break;
        V acc = W::zero();
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          if (lo[b] >= hi[b]) continue;
          acc = W::add(acc, x[b][k]);
          for (int s = lo[b] + 1; s < hi[b]; ++s)
            acc = W::add(acc, sv[(static_cast<size_t>(s) * 4 + b) * nw + q]);
        }
        store_word(out, o + q, acc);
      }
    }
  }
}

template <bool VEC, class G, class O>
int launch(const int* ids_sorted, const int* seg_end, const int* order,
           const G* g, const float* w4, int* seg_start, int2* ranges,
           float* sums, O* out, int v, int n, int c, int hw, int dx,
           int dy, int nseg, cudaStream_t stream) {
  const long long total = static_cast<long long>(v) * n;
  const int4 off = make_int4(0, dx, dy, dy + dx);
  segments_kernel<<<static_cast<unsigned>((total + THREADS - 1) / THREADS),
                    THREADS, 0, stream>>>(ids_sorted, seg_end, seg_start,
                                          ranges, v, n, hw);
  int e = thp_launch_status();
  if (e != 0) return e;
  segment_sums_kernel<G><<<dim3((n + SEG - 1) / SEG, v), SUM_THREADS, 0,
                        stream>>>(seg_end, order, g, w4, sums, n, c);
  if ((e = thp_launch_status()) != 0) return e;
  const long long warps = (4LL * nseg + ITEMS - 1) / ITEMS;
  touched_rows_kernel<VEC, O><<<static_cast<unsigned>(
                                 (warps + WARPS - 1) / WARPS),
                             THREADS, 0, stream>>>(
      ids_sorted, seg_start, ranges, sums, out, n, c, hw, nseg, off);
  return thp_launch_status();
}

template <class G, class O>
int dfeat_entry(const int* ids_sorted, const int* seg_end, const int* order,
                const G* g, const float* w4, int* seg_start, int* ranges,
                float* sums, O* out, int v, int n, int c, int hw, int dx,
                int dy, int nseg, int seg, void* stream) {
  if (seg != SEG || v < 1 || n < 1 || c < 1 || hw < 1 || dx < 0 || dy < 0 ||
      nseg < 1 || (reinterpret_cast<uintptr_t>(ranges) & 7) != 0)
    return THP_ERR_BAD_SIZE;
  const auto s = static_cast<cudaStream_t>(stream);
  auto* r2 = reinterpret_cast<int2*>(ranges);
  // stage 3 moves float4 words of sums (4 channels of the map) where it can
  const bool vec = c % 4 == 0 && ((reinterpret_cast<uintptr_t>(sums) |
                                   reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  return vec ? launch<true>(ids_sorted, seg_end, order, g, w4, seg_start, r2,
                            sums, out, v, n, c, hw, dx, dy, nseg, s)
             : launch<false>(ids_sorted, seg_end, order, g, w4, seg_start, r2,
                             sums, out, v, n, c, hw, dx, dy, nseg, s);
}

}  // namespace

// ids_sorted (v, n) int32 base ids sorted ascending within each view, with
// every tap id ids + {0, dx, dy, dy + dx} in [0, hw) (not checked here);
// seg_end (v * n) int32: the inclusive running count over the flattened
// positions of those that start a segment (position i of a view starts one
// where i % seg == 0 or its id differs from the one before), nseg its last
// value; order (v, n) int32: the row of g / w4 that each sorted position
// came from; g (v, n, c), w4 (v, n, 4) float32.  Scratch: seg_start
// (nseg) int32, ranges (v * hw, 2) int32 zeroed, sums
// (nseg, 4, c) float32.  out (v, hw, c) float32, zeroed: the touched rows
// are written.  All contiguous; seg must be SEG.
THP_EXPORT int thp_dfeat_scatter(const int* ids_sorted, const int* seg_end,
                                 const int* order, const float* g,
                                 const float* w4, int* seg_start, int* ranges,
                                 float* sums, float* out, int v, int n, int c,
                                 int hw, int dx, int dy, int nseg, int seg,
                                 void* stream) {
  return dfeat_entry(ids_sorted, seg_end, order, g, w4, seg_start, ranges,
                     sums, out, v, n, c, hw, dx, dy, nseg, seg, stream);
}

// As thp_dfeat_scatter with g and out bfloat16 (raw 16-bit words; sums
// stays float32): out is thp_dfeat_scatter's map on the widened g, cast.
THP_EXPORT int thp_dfeat_scatter_bf16(const int* ids_sorted,
                                      const int* seg_end, const int* order,
                                      const void* g, const float* w4,
                                      int* seg_start, int* ranges,
                                      float* sums, void* out, int v, int n,
                                      int c, int hw, int dx, int dy, int nseg,
                                      int seg, void* stream) {
  return dfeat_entry(ids_sorted, seg_end, order,
                     static_cast<const unsigned short*>(g), w4, seg_start,
                     ranges, sums, static_cast<unsigned short*>(out), v, n, c,
                     hw, dx, dy, nseg, seg, stream);
}

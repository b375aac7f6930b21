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
// The bfloat16 form (thp_dfeat_keys, thp_dfeat_runs_bf16 and
// thp_dfeat_texels_bf16; the design is noted above its kernels, below)
// reads bf16 cotangent rows and writes a bf16 map: half the bytes of the
// float32 form's g and map (the pixel map is 604 MB, not 1.21 GB).  It
// keeps the float32 form's segments and sums them, and each texel's
// segments, in the float32 form's order in float32, narrowing each texel
// once (round to nearest even): the map is the float32 form's on the
// widened rows, cast, bit for bit, and the same bits on every call.
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

// word q of the map: a float4 (4 channels) or one channel
__device__ __forceinline__ void store_word(float* out, size_t q,
                                           const float4& a) {
  reinterpret_cast<float4*>(out)[q] = a;
}
__device__ __forceinline__ void store_word(float* out, size_t q, float a) {
  out[q] = a;
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
__global__ void __launch_bounds__(SUM_THREADS)
segment_sums_kernel(const int* __restrict__ seg_end,
                    const int* __restrict__ order,
                    const float* __restrict__ g,
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
  const float* gv = g + vn * c;
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
        const float* row = gv + static_cast<size_t>(s_row[min(j + u, rows -
                                                          1)]) * c;
#pragma unroll
        for (int k = 0; k < CPT; ++k) {
          const int ch = c0 + t + k * SUM_THREADS;
          x[u][k] = j + u < rows && ch < c ? __ldg(row + ch) : 0.f;
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
template <bool VEC>
__global__ void __launch_bounds__(THREADS)
touched_rows_kernel(const int* __restrict__ ids_sorted,
                    const int* __restrict__ seg_start,
                    const int2* __restrict__ ranges,
                    const float* __restrict__ sums, float* __restrict__ out,
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

template <bool VEC>
int launch(const int* ids_sorted, const int* seg_end, const int* order,
           const float* g, const float* w4, int* seg_start, int2* ranges,
           float* sums, float* out, int v, int n, int c, int hw, int dx,
           int dy, int nseg, cudaStream_t stream) {
  const long long total = static_cast<long long>(v) * n;
  const int4 off = make_int4(0, dx, dy, dy + dx);
  segments_kernel<<<static_cast<unsigned>((total + THREADS - 1) / THREADS),
                    THREADS, 0, stream>>>(ids_sorted, seg_end, seg_start,
                                          ranges, v, n, hw);
  int e = thp_launch_status();
  if (e != 0) return e;
  segment_sums_kernel<<<dim3((n + SEG - 1) / SEG, v), SUM_THREADS, 0,
                        stream>>>(seg_end, order, g, w4, sums, n, c);
  if ((e = thp_launch_status()) != 0) return e;
  const long long warps = (4LL * nseg + ITEMS - 1) / ITEMS;
  touched_rows_kernel<VEC><<<static_cast<unsigned>(
                              (warps + WARPS - 1) / WARPS),
                          THREADS, 0, stream>>>(
      ids_sorted, seg_start, ranges, sums, out, n, c, hw, nseg, off);
  return thp_launch_status();
}

// ---------------------------------------------------------------------------
// The bfloat16 form: bf16 cotangent rows in, the bf16 map out, every texel
// the float32 form's float32 sum in the float32 form's order, narrowed once.
//
// Measured on the H100 (PERF.md), the float32 form's route with a bf16 map
// spent the pixel shape's 0.71 ms on a zero-fill of the 604 MB map
// (0.19 ms), its three kernels (0.35 ms: stage 2 read a bf16 row two bytes
// a lane), the sort (0.06 ms), a dozen small passes and a host wait for the
// segment count, which sized the sums; at the painting shape the host's
// work around them (0.52 ms a call) left the card idle half the time.  This
// form keeps the float32 form's segments (at most SEG sorted positions of
// one run, cut where the position within its view is a multiple of SEG)
// and sizes everything on the host:
// 0. keys: key = base id + view * hw, one sort of them all (glue, in the
//    wrapper), the ids' range read on the way for the wrapper's check;
// 1. runs: the positions [lo, hi) of each base id in a (v, hw) table, and
//    each sorted position's row and four weights, in sorted order;
// 2. long segments: a segment of at least SLOT positions is the only one
//    to start in its SLOT-aligned window of positions, so its four tap
//    sums S[a] = sum_n w4[n, a] g[n] (fmaf chains from 0, as the float32
//    form's) go to a float32 slot of their own, slot = start / SLOT:
//    v * ceil(n / SLOT) * 4 * c floats (354 MB at the pixel shape), no
//    count (SLOT = 4 measured no faster, at twice the bytes).  One block a
//    tile of SEG positions, a thread a 16-byte word of the row, streams
//    the rows of the tile's long segments;
// 3. texels: a group of warps, one a chunk of 32 words of a row, writes TW
//    texels of one view, every row once, zeros included, in 16-byte
//    streaming stores.  A touched texel sums, for each tap in order, the
//    segments of the tap's run in order: a long segment's slot, or a short
//    segment's chain over its (fewer than SLOT) cotangent rows, which its
//    neighbours share through L1/L2.  A warp walks the items of all its
//    group's touched texels as one list, 32 at a time, a lane resolving
//    one item's row and weight or slot, with RB items' loads in flight
//    across taps, segments and texels.  TW is small so that the warps over
//    the body, every texel touched, end with the others.
// The map's bytes and the cotangent rows' are then written and read once
// each from device memory, with the long segments' slots between.  Base ids
// outside [0, hw - 1 - dx - dy] (taps off the map) are never looked up, so
// no write leaves the map whatever the ids; the wrapper refuses such ids
// unless its caller made them in range by construction.
constexpr int SLOT = 8;     // a long segment has at least SLOT positions
constexpr int RB = 4;       // items in flight a lane in stage 3
constexpr int TW = 8;       // texels a warp in stage 3
constexpr int ROWS1 = 8;    // cotangent rows in flight a thread in stage 2
constexpr int T2 = 128;     // threads a block in stage 2, at most

// A word of a bf16 row: 8 channels in 16 bytes (VEC) or one channel
template <bool VEC> struct Bf16Row;
template <> struct Bf16Row<true> {
  using T = uint4;
  static constexpr int CH = 8;
  static __device__ void widen(const T& x, float* f) { thp_unpack8(x, f); }
  static __device__ T narrow(const float* f) { return thp_pack8(f); }
  static __device__ T zero() { return make_uint4(0u, 0u, 0u, 0u); }
  static __device__ void store(T* p, const T& x) { __stcs(p, x); }
};
template <> struct Bf16Row<false> {
  using T = unsigned short;
  static constexpr int CH = 1;
  static __device__ void widen(T x, float* f) { f[0] = thp_bf16_to_f32(x); }
  static __device__ T narrow(const float* f) { return thp_f32_to_bf16(f[0]); }
  static __device__ T zero() { return 0; }
  static __device__ void store(T* p, T x) { *p = x; }
};

// The sorted positions: keys (v * n), key = base id + view * hw, sorted
// (each view's n in its own n when every id lies in [0, hw)); order (v * n)
// int64, the row of g / w4 each came from; and, written by stage 1, each
// position's row (int32) and its four weights, in sorted order
struct Sorted {
  const int* keys;
  const long long* order;
  int* srow;
  float4* sw;
  int n;
};

// Stage 1, one thread a sorted position p (position i of view p / n): the
// run of each base id u, ranges[view * hw + u] = [lo, hi) (zeroed: empty),
// for the base ids whose taps lie in the map; p's row and weights.
__global__ void __launch_bounds__(THREADS)
dfeat_scatter_bf16_runs_kernel(Sorted sk, const float* __restrict__ w4,
                               int2* __restrict__ ranges, int v, int hw,
                               int top) {
  const long long p = static_cast<long long>(blockIdx.x) * THREADS +
                      threadIdx.x;
  const int n = sk.n;
  if (p >= static_cast<long long>(v) * n) return;
  const int r = static_cast<int>(__ldg(sk.order + p));
  sk.srow[p] = r;
  const float* wr = w4 + 4 * static_cast<size_t>(r);
  sk.sw[p] = make_float4(__ldg(wr), __ldg(wr + 1), __ldg(wr + 2),
                         __ldg(wr + 3));
  const int view = static_cast<int>(p / n);
  const int i = static_cast<int>(p - static_cast<long long>(view) * n);
  const int key = __ldg(sk.keys + p);
  const int u = key - view * hw;
  if (u < 0 || u > top) return;
  int2* rg = ranges + static_cast<size_t>(view) * hw + u;
  if (i == 0 || __ldg(sk.keys + p - 1) != key) rg->x = i;
  if (i == n - 1 || __ldg(sk.keys + p + 1) != key) rg->y = i + 1;
}

// Stage 2: block (k, view) sums the long segments of tile k of the view
// into their slots.  Warp 0 finds the tile's segments (a segment starts at
// the tile's first position and wherever the key changes) and lists the
// positions of its long ones in shared memory with their rows, weights and
// the slot each ends; then thread t walks them for word t (and t +
// blockDim, ...), ROWS1 rows in flight.
template <bool VEC>
__global__ void __launch_bounds__(T2)
dfeat_scatter_bf16_long_kernel(Sorted sk, const unsigned short* g,
                               float* slots, int c) {
  using B = Bf16Row<VEC>;
  __shared__ int s_row[SEG];
  __shared__ float4 s_w[SEG];
  __shared__ int s_slot[SEG];  // the slot a position ends, else -1
  __shared__ int s_cnt;
  const int view = blockIdx.y, n = sk.n;
  const int a = blockIdx.x * SEG, e = min(a + SEG, n);
  const size_t vn = static_cast<size_t>(view) * n;
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x, len = e - a;
    const int* kv = sk.keys + vn;
    bool st[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = lane + 32 * h;
      st[h] = i < len && (i == 0 || __ldg(kv + a + i - 1) !=
                                        __ldg(kv + a + i));
    }
    const unsigned long long starts =
        static_cast<unsigned long long>(__ballot_sync(0xffffffffu, st[0])) |
        static_cast<unsigned long long>(__ballot_sync(0xffffffffu, st[1]))
            << 32;
    int base = 0;  // long positions listed by the lower half
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = lane + 32 * h;
      const bool in = i < len;
      // the segment of position i: [s, f)
      const int s = in ? 63 - __clzll(starts & ((2ULL << i) - 1)) : 0;
      const unsigned long long after = i < 63 ? starts >> (i + 1) : 0;
      const int f = in ? (after ? i + __ffsll(after) : len) : 0;
      const bool keep = in && f - s >= SLOT;
      const unsigned kept = __ballot_sync(0xffffffffu, keep);
      if (keep) {
        const int j = base + __popc(kept & ((1u << lane) - 1));
        s_row[j] = sk.srow[vn + a + i];
        s_w[j] = sk.sw[vn + a + i];
        s_slot[j] = i == f - 1 ? (a + s) / SLOT : -1;
      }
      base += __popc(kept);
    }
    if (lane == 0) s_cnt = base;
  }
  __syncthreads();
  const int cnt = s_cnt;
  if (cnt == 0) return;
  const int nw = c / B::CH;
  const auto* gw = reinterpret_cast<const typename B::T*>(g);
  float* sv = slots + static_cast<size_t>(view) * ((n + SLOT - 1) / SLOT) *
                          4 * c;
  for (int q = threadIdx.x; q < nw; q += blockDim.x) {
    float acc[4][B::CH];
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int ch = 0; ch < B::CH; ++ch) acc[t][ch] = 0.f;
    for (int j0 = 0; j0 < cnt; j0 += ROWS1) {
      typename B::T x[ROWS1];
#pragma unroll
      for (int u = 0; u < ROWS1; ++u)
        if (j0 + u < cnt)
          x[u] = __ldg(gw + static_cast<size_t>(s_row[j0 + u]) * nw + q);
#pragma unroll
      for (int u = 0; u < ROWS1; ++u) {
        if (j0 + u >= cnt) break;
        float xf[B::CH];
        B::widen(x[u], xf);
        const float4 w = s_w[j0 + u];
        const float wa[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int t = 0; t < 4; ++t)
#pragma unroll
          for (int ch = 0; ch < B::CH; ++ch)
            acc[t][ch] = fmaf(wa[t], xf[ch], acc[t][ch]);
        const int slot = s_slot[j0 + u];
        if (slot >= 0) {  // the segment ends here
          float* out = sv + static_cast<size_t>(slot) * 4 * c + q * B::CH;
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            float* o = out + static_cast<size_t>(t) * c;
            if constexpr (VEC) {
              reinterpret_cast<float4*>(o)[0] =
                  make_float4(acc[t][0], acc[t][1], acc[t][2], acc[t][3]);
              reinterpret_cast<float4*>(o)[1] =
                  make_float4(acc[t][4], acc[t][5], acc[t][6], acc[t][7]);
            } else {
              o[0] = acc[t][0];
            }
#pragma unroll
            for (int ch = 0; ch < B::CH; ++ch) acc[t][ch] = 0.f;
          }
        }
      }
    }
  }
}

// Stage 3's items of a touched texel, in its sum's order: for each tap, the
// segments of the tap's run [lo, hi) (pieces cut at multiples of SEG): a
// long one is one item (its slot), a short one an item a position.  Only a
// run's first and last pieces can be short.
struct Items {
  int lo[4], hi[4], first[4], mids[4], total[4];  // items a tap: total
  __device__ void init(const int* l, const int* h) {
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      lo[b] = l[b];
      hi[b] = h[b];
      first[b] = mids[b] = total[b] = 0;
      if (l[b] >= h[b]) continue;
      const int f1 = min(h[b], (l[b] / SEG + 1) * SEG);  // first piece's end
      const int n1 = f1 - l[b];
      first[b] = n1 >= SLOT ? 1 : n1;
      if (f1 >= h[b]) {
        total[b] = first[b];
        continue;
      }
      const int last0 = (h[b] - 1) / SEG * SEG;  // last piece's start
      mids[b] = (last0 - f1) / SEG;
      const int nl = h[b] - last0;
      total[b] = first[b] + mids[b] + (nl >= SLOT ? 1 : nl);
    }
  }
  // item i of tap b: the position (>= 0) of a short segment's row and
  // whether it ends its segment, or the slot of a long one (pos < 0)
  __device__ void at(int b, int i, int& pos, int& slot, bool& end) const {
    pos = -1;
    slot = -1;
    end = true;
    int s, f;  // the piece of item i
    if (i < first[b]) {
      s = lo[b];
      f = min(hi[b], (lo[b] / SEG + 1) * SEG);
    } else if (i < first[b] + mids[b]) {
      s = (lo[b] / SEG + 1 + (i - first[b])) * SEG;
      f = s + SEG;
    } else {
      s = max(lo[b], (hi[b] - 1) / SEG * SEG);
      f = hi[b];
    }
    if (f - s >= SLOT) {
      slot = s / SLOT;
      return;
    }
    const int off = i < first[b] ? i : i - first[b] - mids[b];
    pos = s + off;
    end = pos == f - 1;
  }
};

// Stage 3's group of a block: wpg = min(chunks of 32 words in a row,
// WARPS) warps, gpb = WARPS / wpg groups a block of wpg * gpb warps
__host__ __device__ inline int texel_wpg(int nw) {
  return min((nw + 31) / 32, WARPS);
}

// Stage 3: group g of block (x, view) writes texels t0 + [0, TW) of the
// view, t0 = (x * gpb + g) * TW, warp k of the group words
// 32 (k + wpg i) + [0, 32) of each row (one warp a chunk, so that a
// texel's items are walked in one pass), lane l first reading the run of
// tap l % 4 of texel t0 + l / 4.  The untouched texels' rows are zeros;
// then the items of all the group's touched texels, one list in texel
// order, are walked together, so that one texel's loads overlap the next
// one's.
template <bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
dfeat_scatter_bf16_texels_kernel(Sorted sk, const unsigned short* g,
                                 const float* slots,
                                 const int2* __restrict__ ranges,
                                 unsigned short* out, int c, int hw,
                                 int4 off) {
  using B = Bf16Row<VEC>;
  static_assert(4 * TW == 32, "a lane a (texel, tap)");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int view = blockIdx.y, n = sk.n;
  const int nw = c / B::CH, wpg = texel_wpg(nw);
  const int group = warp / wpg, k0 = warp - group * wpg;
  const int t0 = (blockIdx.x * (WARPS / wpg) + group) * TW;
  if (t0 >= hw) return;
  const int tap_l = lane & 3, t = t0 + (lane >> 2);
  const int u = t - (tap_l == 0 ? off.x : tap_l == 1 ? off.y
                     : tap_l == 2 ? off.z : off.w);
  const int2 rg = t < hw && u >= 0 && u <= hw - 1 - off.w
                      ? __ldg(ranges + static_cast<size_t>(view) * hw + u)
                      : make_int2(0, 0);
  const unsigned any = __ballot_sync(0xffffffffu, rg.x < rg.y);
  const int count = min(TW, hw - t0);
  auto* ow = reinterpret_cast<typename B::T*>(out) +
             (static_cast<size_t>(view) * hw + t0) * nw;
  // the untouched texels' rows (this warp's words of them)
  for (int j = 0; j < count; ++j) {
    if ((any >> (4 * j)) & 15u) continue;
    for (int q = 32 * k0 + lane; q < nw; q += 32 * wpg)
      B::store(ow + static_cast<size_t>(j) * nw + q, B::zero());
  }
  if (any == 0) return;
  // the items of texel j (lane j < TW), and where each texel's end
  int lo[4], hi[4];
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    lo[b] = __shfl_sync(0xffffffffu, rg.x, 4 * (lane & (TW - 1)) + b);
    hi[b] = __shfl_sync(0xffffffffu, rg.y, 4 * (lane & (TW - 1)) + b);
  }
  int ends[TW];  // items up to texel j's end, over the group's texels
  {
    Items mine;
    mine.init(lo, hi);
    const int tot = lane < count ? mine.total[0] + mine.total[1] +
                                       mine.total[2] + mine.total[3]
                                 : 0;
    int inc = tot;
#pragma unroll
    for (int o = 1; o < TW; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, inc, o);
      if (lane >= o) inc += y;
    }
#pragma unroll
    for (int jj = 0; jj < TW; ++jj)
      ends[jj] = __shfl_sync(0xffffffffu, inc, jj);
  }
  const int total = ends[TW - 1];
  const auto* gw = reinterpret_cast<const typename B::T*>(g);
  const size_t vn = static_cast<size_t>(view) * n;
  const float* sv = slots + static_cast<size_t>(view) *
                                ((n + SLOT - 1) / SLOT) * 4 * c;
  for (int q = 32 * k0 + lane; q - lane < nw; q += 32 * wpg) {  // a word
    float acc[B::CH], seg[B::CH];
#pragma unroll
    for (int ch = 0; ch < B::CH; ++ch) acc[ch] = seg[ch] = 0.f;
    for (int i0 = 0; i0 < total; i0 += 32) {
      // lane l resolves item i0 + l: its texel, tap, and its row and
      // weight or its slot; the last item of a texel stores it
      const int i = i0 + lane;
      int jj = 0;
#pragma unroll
      for (int k = 0; k < TW; ++k) jj += ends[k] <= i;
      int l2[4], h2[4];  // the taps' runs of texel jj, from lane jj
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        l2[b] = __shfl_sync(0xffffffffu, lo[b], min(jj, TW - 1));
        h2[b] = __shfl_sync(0xffffffffu, hi[b], min(jj, TW - 1));
      }
      int pos = -1, slot = -1, r = 0, done = -1;
      bool end = true;
      float w = 0.f;
      int tap = 0;
      if (i < total) {
        int start = 0, last = 0;
#pragma unroll
        for (int k = 0; k < TW; ++k)
          if (k == jj) {
            start = k ? ends[k - 1] : 0;
            last = ends[k] - 1;
          }
        Items it;
        it.init(l2, h2);
        int li = i - start;
#pragma unroll
        for (int b = 0; b < 3; ++b)
          if (tap == b && li >= it.total[b]) {
            li -= it.total[b];
            tap = b + 1;
          }
#pragma unroll
        for (int b = 0; b < 4; ++b)
          if (tap == b) it.at(b, li, pos, slot, end);
        if (pos >= 0) {
          r = sk.srow[vn + pos];
          const float4 w4 = sk.sw[vn + pos];
          w = tap == 0 ? w4.x : tap == 1 ? w4.y : tap == 2 ? w4.z : w4.w;
        }
        if (i == last) done = jj;
      }
      const int cnt = min(32, total - i0);
      for (int u0 = 0; u0 < cnt; u0 += RB) {
        uint4 x0[RB], x1[RB];  // a row word, or a slot word's 8 floats
#pragma unroll
        for (int k = 0; k < RB; ++k) {
          const int src = min(u0 + k, cnt - 1);
          const int ip = __shfl_sync(0xffffffffu, pos, src);
          const int is = __shfl_sync(0xffffffffu, slot, src);
          const int ir = __shfl_sync(0xffffffffu, r, src);
          const int itap = __shfl_sync(0xffffffffu, tap, src);
          if (u0 + k < cnt && q < nw) {
            if (ip >= 0) {
              const typename B::T xr = __ldg(gw + static_cast<size_t>(ir) *
                                                      nw + q);
              if constexpr (VEC) x0[k] = xr;
              else x0[k].x = xr;
            } else {
              const float* p = sv + (static_cast<size_t>(is) * 4 + itap) *
                                        c + q * B::CH;
              if constexpr (VEC) {
                x0[k] = __ldg(reinterpret_cast<const uint4*>(p));
                x1[k] = __ldg(reinterpret_cast<const uint4*>(p) + 1);
              } else {
                x0[k].x = __float_as_uint(__ldg(p));
              }
            }
          }
        }
#pragma unroll
        for (int k = 0; k < RB; ++k) {
          if (u0 + k >= cnt) break;  // uniform across the warp
          const int ip = __shfl_sync(0xffffffffu, pos, u0 + k);
          const bool ie = __shfl_sync(0xffffffffu, end, u0 + k);
          const float iw = __shfl_sync(0xffffffffu, w, u0 + k);
          const int id = __shfl_sync(0xffffffffu, done, u0 + k);
          if (q >= nw) continue;
          if (ip >= 0) {  // a short segment's row: into its chain
            float f[B::CH];
            if constexpr (VEC) B::widen(x0[k], f);
            else B::widen(static_cast<unsigned short>(x0[k].x), f);
#pragma unroll
            for (int ch = 0; ch < B::CH; ++ch)
              seg[ch] = fmaf(iw, f[ch], seg[ch]);
            if (ie) {
#pragma unroll
              for (int ch = 0; ch < B::CH; ++ch) {
                acc[ch] = __fadd_rn(acc[ch], seg[ch]);
                seg[ch] = 0.f;
              }
            }
          } else if constexpr (VEC) {  // a long segment's slot
            const unsigned v[8] = {x0[k].x, x0[k].y, x0[k].z, x0[k].w,
                                   x1[k].x, x1[k].y, x1[k].z, x1[k].w};
#pragma unroll
            for (int ch = 0; ch < 8; ++ch)
              acc[ch] = __fadd_rn(acc[ch], __uint_as_float(v[ch]));
          } else {
            acc[0] = __fadd_rn(acc[0], __uint_as_float(x0[k].x));
          }
          if (id >= 0) {  // the texel's last item: its row, then the next
            B::store(ow + static_cast<size_t>(id) * nw + q, B::narrow(acc));
#pragma unroll
            for (int ch = 0; ch < B::CH; ++ch) acc[ch] = 0.f;
          }
        }
      }
    }
  }
}

// Stages 1 and 2 (scratch only)
template <bool VEC>
int launch_runs(Sorted sk, const unsigned short* g, const float* w4,
                float* slots, int2* ranges, int v, int c, int hw, int top,
                cudaStream_t stream) {
  const long long total = static_cast<long long>(v) * sk.n;
  int e = static_cast<int>(cudaMemsetAsync(
      ranges, 0, static_cast<size_t>(v) * hw * sizeof(int2), stream));
  if (e != 0) return e;
  dfeat_scatter_bf16_runs_kernel<<<static_cast<unsigned>(
                                       (total + THREADS - 1) / THREADS),
                                   THREADS, 0, stream>>>(sk, w4, ranges, v,
                                                         hw, top);
  if ((e = thp_launch_status()) != 0) return e;
  const int nw = c / Bf16Row<VEC>::CH;
  dfeat_scatter_bf16_long_kernel<VEC>
      <<<dim3((sk.n + SEG - 1) / SEG, v), min(T2, (nw + 31) / 32 * 32), 0,
         stream>>>(sk, g, slots, c);
  return thp_launch_status();
}

// Stage 0: keys[p] = ids[p] + (p / n) * hw, and the ids' min and max:
// partial (2 * RANGE_BLOCKS) int32, then lohi (2) int32
constexpr int RANGE_BLOCKS = 256;

__global__ void __launch_bounds__(THREADS)
dfeat_scatter_bf16_keys_kernel(const int* __restrict__ ids,
                               int* __restrict__ keys,
                               int* __restrict__ partial, long long total,
                               int n, int hw) {
  __shared__ int s_min[WARPS], s_max[WARPS];
  int lo = 0x7fffffff, hi = -0x7fffffff - 1;
  for (long long p = static_cast<long long>(blockIdx.x) * THREADS +
                     threadIdx.x;
       p < total; p += static_cast<long long>(gridDim.x) * THREADS) {
    const int id = __ldg(ids + p);
    lo = min(lo, id);
    hi = max(hi, id);
    keys[p] = id + static_cast<int>(p / n) * hw;
  }
  for (int o = 16; o > 0; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    s_min[warp] = lo;
    s_max[warp] = hi;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 1; i < WARPS; ++i) {
      lo = min(lo, s_min[i]);
      hi = max(hi, s_max[i]);
    }
    partial[2 * blockIdx.x] = lo;
    partial[2 * blockIdx.x + 1] = hi;
  }
}

__global__ void dfeat_scatter_bf16_range_kernel(
    const int* __restrict__ partial, int* __restrict__ lohi, int blocks) {
  int lo = 0x7fffffff, hi = -0x7fffffff - 1;
  for (int i = threadIdx.x; i < blocks; i += 32) {
    lo = min(lo, partial[2 * i]);
    hi = max(hi, partial[2 * i + 1]);
  }
  for (int o = 16; o > 0; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  if (threadIdx.x == 0) {
    lohi[0] = lo;
    lohi[1] = hi;
  }
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

// The bfloat16 form's stage 0: its sort keys and the ids' range.  ids
// (v * n) int32; keys (v * n) int32, written id + (p / n) * hw; scratch
// (2 * 256 + 2) int32 on the device; host (2) int32 in pinned memory or
// null: the ids' min and max, copied there behind the kernels on the
// stream (no host wait here).
THP_EXPORT int thp_dfeat_keys(const int* ids, int* keys, int* scratch,
                              int* host, int v, int n, int hw,
                              void* stream) {
  if (v < 1 || n < 1 || hw < 1) return THP_ERR_BAD_SIZE;
  const auto s = static_cast<cudaStream_t>(stream);
  dfeat_scatter_bf16_keys_kernel<<<RANGE_BLOCKS, THREADS, 0, s>>>(
      ids, keys, scratch, static_cast<long long>(v) * n, n, hw);
  int e = thp_launch_status();
  if (e != 0 || !host) return e;
  int* lohi = scratch + 2 * RANGE_BLOCKS;
  dfeat_scatter_bf16_range_kernel<<<1, 32, 0, s>>>(scratch, lohi,
                                                   RANGE_BLOCKS);
  if ((e = thp_launch_status()) != 0) return e;
  return static_cast<int>(cudaMemcpyAsync(host, lohi, 2 * sizeof(int),
                                          cudaMemcpyDeviceToHost, s));
}

// The bfloat16 form, stages 1 and 2, which write only their scratch.
// keys (v * n) int32: thp_dfeat_keys' keys, sorted; order (v * n) int64:
// the row of g and w4 each sorted key came from; g (v, n, c) bf16 (raw
// 16-bit words), w4 (v, n, 4) float32.  Scratch: slots (v * ceil(n /
// slot) * 4 * c) float32, ranges (v * hw * 2) int32, srow (v * n) int32,
// sw (v * n * 4) float32.  All contiguous; seg and slot must be SEG and
// SLOT.
THP_EXPORT int thp_dfeat_runs_bf16(const int* keys, const long long* order,
                                   const void* g, const float* w4,
                                   float* slots, int* ranges, int* srow,
                                   float* sw, int v, int n, int c, int hw,
                                   int dx, int dy, int seg, int slot,
                                   void* stream) {
  if (seg != SEG || slot != SLOT || v < 1 || v > 65535 || n < 1 || c < 1 ||
      hw < 1 || dx < 0 || dy < 0 ||
      ((reinterpret_cast<uintptr_t>(ranges) & 7) |
       (reinterpret_cast<uintptr_t>(sw) & 15)) != 0)
    return THP_ERR_BAD_SIZE;
  const Sorted sk{keys, order, srow, reinterpret_cast<float4*>(sw), n};
  const auto* gb = static_cast<const unsigned short*>(g);
  auto* r2 = reinterpret_cast<int2*>(ranges);
  const auto s = static_cast<cudaStream_t>(stream);
  const int top = hw - 1 - dx - dy;
  // 16-byte words need c a multiple of 8 and g aligned to 16 bytes (the
  // slots, 32 bytes a word, too)
  const bool vec = c % 8 == 0 && ((reinterpret_cast<uintptr_t>(g) |
                                   reinterpret_cast<uintptr_t>(slots)) &
                                  15) == 0;
  return vec ? launch_runs<true>(sk, gb, w4, slots, r2, v, c, hw, top, s)
             : launch_runs<false>(sk, gb, w4, slots, r2, v, c, hw, top, s);
}

// The bfloat16 form, stage 3, after thp_dfeat_runs_bf16 with the same
// arguments: out (v, hw, c) bf16, every row written, the float32 form's map
// on the widened g, narrowed once (round to nearest even).
THP_EXPORT int thp_dfeat_texels_bf16(const void* g, const float* slots,
                                     const int* ranges, const int* srow,
                                     const float* sw, void* out, int v, int n,
                                     int c, int hw, int dx, int dy, int slot,
                                     void* stream) {
  if (slot != SLOT || v < 1 || v > 65535 || n < 1 || c < 1 || hw < 1 ||
      dx < 0 || dy < 0 ||
      ((reinterpret_cast<uintptr_t>(ranges) & 7) |
       (reinterpret_cast<uintptr_t>(sw) & 15)) != 0)
    return THP_ERR_BAD_SIZE;
  const Sorted sk{nullptr, nullptr, const_cast<int*>(srow),
                  reinterpret_cast<float4*>(const_cast<float*>(sw)), n};
  const int4 off = make_int4(0, dx, dy, dy + dx);
  const auto* gb = static_cast<const unsigned short*>(g);
  auto* o = static_cast<unsigned short*>(out);
  const auto* r2 = reinterpret_cast<const int2*>(ranges);
  const auto s = static_cast<cudaStream_t>(stream);
  // as thp_dfeat_runs_bf16, and out aligned to 16 bytes
  const bool vec = c % 8 == 0 && ((reinterpret_cast<uintptr_t>(g) |
                                   reinterpret_cast<uintptr_t>(out) |
                                   reinterpret_cast<uintptr_t>(slots)) &
                                  15) == 0;
  const int wpg = texel_wpg(vec ? c / 8 : c), gpb = WARPS / wpg;
  const dim3 grid((hw + gpb * TW - 1) / (gpb * TW), v);
  const int threads = 32 * wpg * gpb;
  if (vec)
    dfeat_scatter_bf16_texels_kernel<true>
        <<<grid, threads, 0, s>>>(sk, gb, slots, r2, o, c, hw, off);
  else
    dfeat_scatter_bf16_texels_kernel<false>
        <<<grid, threads, 0, s>>>(sk, gb, slots, r2, o, c, hw, off);
  return thp_launch_status();
}

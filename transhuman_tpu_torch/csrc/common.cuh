// Shared helpers for the hand-written kernels of transhuman_tpu_torch.
//
// Every kernel is exported through a plain C entry point (no PyTorch headers)
// so that nvcc builds the whole library in seconds; Python binds the entries
// with ctypes (kernels/build.py).  Each entry returns 0 on success, a CUDA
// error code after a refused launch, or one of the THP_ERR_* codes below for
// arguments the kernel does not take.  thp_error_string() names any of them.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define THP_EXPORT extern "C" __attribute__((visibility("default")))

// Argument errors, kept clear of cudaError_t's range.
#define THP_ERR_BAD_K 10001        // k outside 1..8
#define THP_ERR_BAD_FREQS 10002    // n_freqs other than the compiled one
#define THP_ERR_BAD_SIZE 10003     // an extent is negative or too large
#define THP_ERR_SMEM 10004         // the tile does not fit in shared memory

static inline int thp_launch_status() {
  return static_cast<int>(cudaGetLastError());
}

// float4 words (VEC) or single floats, for kernels that move rows of
// float32 channels either way
template <bool VEC> struct ThpWord;
template <> struct ThpWord<true> {
  using T = float4;
  static __device__ T zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  static __device__ T fma(float w, const T& x, const T& a) {
    return make_float4(fmaf(w, x.x, a.x), fmaf(w, x.y, a.y),
                       fmaf(w, x.z, a.z), fmaf(w, x.w, a.w));
  }
  static __device__ T add(const T& a, const T& b) {
    return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
  }
};
template <> struct ThpWord<false> {
  using T = float;
  static __device__ T zero() { return 0.f; }
  static __device__ T fma(float w, T x, T a) { return fmaf(w, x, a); }
  static __device__ T add(T a, T b) { return a + b; }
};

// bfloat16 values travel as their raw 16 bits (unsigned short), eight to a
// 16-byte uint4 word, the lower channel in the lower half of each 32-bit
// lane.  Widening to float32 is exact; narrowing rounds to nearest even, as
// torch's .to(torch.bfloat16) does, so a kernel that sums in float32 in the
// order of its float32 form and narrows once gives that form's bits, cast.
__device__ __forceinline__ float thp_bf16_to_f32(unsigned short h) {
  return __uint_as_float(static_cast<unsigned>(h) << 16);
}
__device__ __forceinline__ unsigned short thp_f32_to_bf16(float f) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(f));
}
__device__ __forceinline__ void thp_unpack8(const uint4& w, float* f) {
  const unsigned u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(u[i] << 16);
    f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ unsigned thp_pack2(float lo, float hi) {
  return static_cast<unsigned>(thp_f32_to_bf16(lo)) |
         static_cast<unsigned>(thp_f32_to_bf16(hi)) << 16;
}
__device__ __forceinline__ uint4 thp_pack8(const float* f) {
  return make_uint4(thp_pack2(f[0], f[1]), thp_pack2(f[2], f[3]),
                    thp_pack2(f[4], f[5]), thp_pack2(f[6], f[7]));
}

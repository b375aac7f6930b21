// Shared helpers for the hand-written kernels of transhuman_tpu_torch.
//
// Every kernel is exported through a plain C entry point (no PyTorch headers)
// so that nvcc builds the whole library in seconds; Python binds the entries
// with ctypes (kernels/build.py).  Each entry returns 0 on success, a CUDA
// error code after a refused launch, or one of the THP_ERR_* codes below for
// arguments the kernel does not take.  thp_error_string() names any of them.
#pragma once

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

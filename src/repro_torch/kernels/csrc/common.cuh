// Shared helpers of the port's CUDA sources (each source is its own
// shared library, so the extern "C" definition below lands once per .so).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

// Element type codes passed from Python: 0 = float32, 1 = bfloat16.
enum DtypeCode { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int V> using Int = std::integral_constant<int, V>;

// Calls f(const T*) with T the element type named by `code`; false if the
// code is unknown.
template <typename F> inline bool with_dtype(int code, F&& f) {
  if (code == kF32) { f(static_cast<const float*>(nullptr)); return true; }
  if (code == kBF16) { f(static_cast<const __nv_bfloat16*>(nullptr)); return true; }
  return false;
}

template <typename P> using elem_t = std::remove_const_t<std::remove_pointer_t<P>>;

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Shared helpers of the port's CUDA kernels (sm_90a, plain C interface).
//
// Element types arrive as codes: 0 = float32, 1 = bfloat16
// (repro_torch/kernels/_build.py DTYPE_CODES).  Every kernel loads its
// inputs to float32, computes in float32 and rounds once on store
// (round to nearest even, as XLA's convert does).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace mz {

constexpr float kNegInf = -1e30f;   // the JAX package's NEG_INF mask value

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

}  // namespace mz

// Each library exports <name>_error_string(code) for the Python launcher.
#define MZ_ERROR_STRING(name)                                   \
  extern "C" const char* name##_error_string(int code) {        \
    return cudaGetErrorString(static_cast<cudaError_t>(code));  \
  }

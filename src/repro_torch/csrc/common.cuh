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

// Dynamic shared-memory opt-in, kept per device (attributes are per
// device; setting them on every launch costs host time).  `set` is the
// kernel's own table of the largest limit raised so far, held in its
// library's unnamed namespace: a static local of a template would be one
// object across two libraries, so the second would never set its own.
// `cluster` also allows non-portable cluster sizes when the limit is raised.
constexpr int kDevices = 16;

template <typename K>
inline cudaError_t opt_in(K kern, int (&set)[kDevices], int bytes, bool cluster = false) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  int unset = 0;                           // devices past the table: every call
  int& done = dev < kDevices ? set[dev] : unset;
  if (bytes > done) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e == cudaSuccess && cluster)
      e = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
    done = bytes;
  }
  return cudaSuccess;
}

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

// Shared helpers of the port's CUDA kernels (sm_90a, plain C interface).
//
// Element types arrive as codes (0 = float32, 1 = bfloat16, 2 =
// float16); their conversions and dispatch are in dtypes.cuh.
#pragma once

#include <cuda_runtime.h>

#include "dtypes.cuh"

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

}  // namespace mz

// Each library exports <name>_error_string(code) for the Python launcher.
#define MZ_ERROR_STRING(name)                                   \
  extern "C" const char* name##_error_string(int code) {        \
    return cudaGetErrorString(static_cast<cudaError_t>(code));  \
  }

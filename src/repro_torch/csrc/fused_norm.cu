// Fused RMSNorm and RMSNorm+residual for Hopper (sm_90a).
//
// Replaces the TPU kernels fused_rmsnorm_pallas and
// fused_rmsnorm_residual_pallas (src/repro/kernels/fused_norm/kernel.py):
//     y = rmsnorm(x) * (1 + scale)                 (fused_rmsnorm)
//     s = round(x + res); y = rmsnorm(s) * (1 + scale)
//                                                   (fused_rmsnorm_residual)
// The residual variant norms the sum AFTER rounding it to the I/O type,
// exactly as kernel.py:40-44 does, so it matches the unfused reference.
//
// What bounds it on the H100: bytes.  A row of d values is read once
// (twice with the residual) and written once (twice), about one FLOP per
// byte, far under the card's ridge point.  So each row makes exactly one
// pass over device memory, held in registers between the mean square and
// the scaled write:
//   d <= 2048: one warp per row (V values a lane, V <= 64), the mean
//     square reduced with warp shuffles; four rows a block;
//   2048 < d <= 8192: one 256-thread block per row (V <= 32 values a
//     thread), warp shuffles then the eight warps' sums through shared
//     memory.  A warp cannot hold a 4096-wide row in registers.
#include "common.cuh"

namespace {

constexpr int kRowsPerBlock = 4;
constexpr int kRowThreads = 256;   // threads of the one-row-a-block form
constexpr int kMaxD = 8192;

template <typename T, typename S, int V, bool RESIDUAL>
__global__ void __launch_bounds__(32 * kRowsPerBlock)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ res,
               const S* __restrict__ scale, T* __restrict__ sum_out,
               T* __restrict__ out, int n, int d, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= n) return;  // whole warp leaves together
  const size_t base = static_cast<size_t>(row) * d;
  float v[V];
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = lane + 32 * i;
    float a = 0.f;
    if (c < d) {
      a = mz::to_f(x[base + c]);
      if (RESIDUAL) {
        const T s = mz::from_f<T>(a + mz::to_f(res[base + c]));
        sum_out[base + c] = s;
        a = mz::to_f(s);
      }
    }
    v[i] = a;
    ss += a * a;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const float inv = rsqrtf(ss / static_cast<float>(d) + eps);
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = lane + 32 * i;
    if (c < d) out[base + c] = mz::from_f<T>(v[i] * inv * (1.f + mz::to_f(scale[c])));
  }
}

template <typename T, typename S, int V, bool RESIDUAL>
__global__ void __launch_bounds__(kRowThreads)
rmsnorm_row_kernel(const T* __restrict__ x, const T* __restrict__ res,
                   const S* __restrict__ scale, T* __restrict__ sum_out,
                   T* __restrict__ out, int d, float eps) {
  __shared__ float warp_ss[kRowThreads / 32];
  const int t = threadIdx.x;
  const size_t base = static_cast<size_t>(blockIdx.x) * d;
  float v[V];
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = t + kRowThreads * i;
    float a = 0.f;
    if (c < d) {
      a = mz::to_f(x[base + c]);
      if (RESIDUAL) {
        const T s = mz::from_f<T>(a + mz::to_f(res[base + c]));
        sum_out[base + c] = s;
        a = mz::to_f(s);
      }
    }
    v[i] = a;
    ss += a * a;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  if ((t & 31) == 0) warp_ss[t >> 5] = ss;
  __syncthreads();
  float tot = 0.f;
#pragma unroll
  for (int w = 0; w < kRowThreads / 32; ++w) tot += warp_ss[w];  // fixed order
  const float inv = rsqrtf(tot / static_cast<float>(d) + eps);
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = t + kRowThreads * i;
    if (c < d) out[base + c] = mz::from_f<T>(v[i] * inv * (1.f + mz::to_f(scale[c])));
  }
}

template <typename T, typename S, bool R>
cudaError_t launch(const void* x, const void* res, const void* scale,
                   void* sum_out, void* out, int n, int d, float eps,
                   cudaStream_t st) {
  const dim3 grid((n + kRowsPerBlock - 1) / kRowsPerBlock), block(32 * kRowsPerBlock);
  const T* xp = static_cast<const T*>(x);
  const T* rp = static_cast<const T*>(res);
  const S* sp = static_cast<const S*>(scale);
  T* so = static_cast<T*>(sum_out);
  T* op = static_cast<T*>(out);
  const int vpl = (d + 31) / 32;  // values a lane holds
  const int vpt = (d + kRowThreads - 1) / kRowThreads;  // ... a thread of a row block
#define MZ_NORM(VV) rmsnorm_kernel<T, S, VV, R><<<grid, block, 0, st>>>(xp, rp, sp, so, op, n, d, eps)
#define MZ_ROW(VV) rmsnorm_row_kernel<T, S, VV, R><<<n, kRowThreads, 0, st>>>(xp, rp, sp, so, op, d, eps)
  if (d < 1 || d > kMaxD) return cudaErrorInvalidValue;
  if (vpl <= 4) MZ_NORM(4);
  else if (vpl <= 8) MZ_NORM(8);
  else if (vpl <= 16) MZ_NORM(16);
  else if (vpl <= 24) MZ_NORM(24);
  else if (vpl <= 32) MZ_NORM(32);
  else if (vpl <= 64) MZ_NORM(64);
  else if (vpt <= 16) MZ_ROW(16);
  else if (vpt <= 24) MZ_ROW(24);
  else MZ_ROW(32);
#undef MZ_NORM
#undef MZ_ROW
  return cudaGetLastError();
}

template <bool R>
int dispatch(const void* x, const void* res, const void* scale, void* sum_out,
             void* out, int n, int d, float eps, int x_dtype, int scale_dtype,
             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (x_dtype == 0 && scale_dtype == 0)
    e = launch<float, float, R>(x, res, scale, sum_out, out, n, d, eps, st);
  else if (x_dtype == 0 && scale_dtype == 1)
    e = launch<float, __nv_bfloat16, R>(x, res, scale, sum_out, out, n, d, eps, st);
  else if (x_dtype == 1 && scale_dtype == 0)
    e = launch<__nv_bfloat16, float, R>(x, res, scale, sum_out, out, n, d, eps, st);
  else if (x_dtype == 1 && scale_dtype == 1)
    e = launch<__nv_bfloat16, __nv_bfloat16, R>(x, res, scale, sum_out, out, n, d, eps, st);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}

}  // namespace

// x, out: (n, d) contiguous; scale: (d,).  d <= 8192.
extern "C" int fused_rmsnorm(const void* x, const void* scale, void* out, int n,
                             int d, float eps, int x_dtype, int scale_dtype,
                             void* stream) {
  return dispatch<false>(x, nullptr, scale, nullptr, out, n, d, eps, x_dtype,
                         scale_dtype, stream);
}

// x, res, sum_out, out: (n, d) contiguous; scale: (d,).  d <= 8192.
extern "C" int fused_rmsnorm_residual(const void* x, const void* res,
                                      const void* scale, void* sum_out,
                                      void* out, int n, int d, float eps,
                                      int x_dtype, int scale_dtype, void* stream) {
  return dispatch<true>(x, res, scale, sum_out, out, n, d, eps, x_dtype,
                        scale_dtype, stream);
}

MZ_ERROR_STRING(fused_norm)

// Fused RMSNorm and RMSNorm+residual for Hopper (sm_90a).
//
// Replaces the TPU kernels fused_rmsnorm_pallas and
// fused_rmsnorm_residual_pallas (src/repro/kernels/fused_norm/kernel.py:51,
// :78):
//     y = rmsnorm(x) * (1 + scale)                 (fused_rmsnorm)
//     s = round(x + res); y = rmsnorm(s) * (1 + scale)
//                                                   (fused_rmsnorm_residual)
// The residual variant norms the sum AFTER rounding it to the I/O type,
// exactly as kernel.py:40-44 does, so it matches the unfused reference.
//
// What bounds it on the H100: bytes, and at the served shapes latency.  A
// row of d values is read once (twice with the residual) and written once
// (twice), about one FLOP per byte; a decode step's rows (N 4, d 576: 9 KB)
// move in a fraction of a microsecond, so the call's time is its launch
// and its chain of dependent device-memory round trips.  Each row makes one
// pass, held in registers between the mean square and the scaled write,
// with one round trip before the reduction:
//   * every load is a 16-byte vector (8 bf16 / fp16 or 4 float32 values a lane)
//     where d is a multiple of 8 (4) and the pointers are aligned; other
//     widths take scalar loads (the wrapper picks `vec`);
//   * `scale` does not depend on the row, so its loads are issued with
//     the row's, before the reduction, and both are in flight at once;
//   * d <= 1024: one warp a row, warp shuffles; one row a block below 1024
//     rows, so a decode step's rows spread over as many SMs;
//   * 1024 < d <= 8192: one 256-thread block a row, warp shuffles then the
//     eight warps' sums through shared memory, vectorised the same way;
//   * d > 8192 (any width, as the JAX kernels take): the same block a row,
//     looping over the row in tiles of its 256 threads' chunks, a
//     sum-of-squares pass and then a pass that re-reads the row for the
//     scaled write (rmsnorm_wide_kernel).
// The sum runs in one fixed order: each lane over its chunks (lane, lane +
// 32, ...; in a block, thread, thread + 256, ...) and their values in
// order, then the xor butterfly, then (row form) the warps in order.
// kernels/fused_norm/kernel.py:norm_layout mirrors the layout, and the CPU
// tests emulate the order.
#include "common.cuh"

// Every kernel names a minimum of one block an SM in its launch bounds:
// without it ptxas picked register counts that spilled (48-96 registers).
namespace {

constexpr int kRowThreads = 256;   // threads of the one-row-a-block form
constexpr int kWarpMaxD = 1024;    // widest row of the one-warp form
constexpr int kMaxD = 8192;        // widest row held in registers (wider: two passes)
constexpr int kWarpRowsBig = 4;    // rows a block of the warp form from 1024 rows

template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
};

// W values of T as they sit in device memory (kept packed in registers
// until they are used: 8 bf16 values take 4 registers), moved in aligned
// accesses of at most 16 bytes each
template <typename T, int W>
struct Chunk {
  static constexpr int N = W * sizeof(T) <= 16 ? W : 16 / static_cast<int>(sizeof(T));
  Vec<T, N> p[W / N];

  __device__ __forceinline__ void load(const T* __restrict__ src) {
#pragma unroll
    for (int i = 0; i < W / N; ++i) p[i] = reinterpret_cast<const Vec<T, N>*>(src)[i];
  }
  __device__ __forceinline__ void store(T* __restrict__ dst) const {
#pragma unroll
    for (int i = 0; i < W / N; ++i) reinterpret_cast<Vec<T, N>*>(dst)[i] = p[i];
  }
  __device__ __forceinline__ float get(int e) const { return mz::to_f(p[e / N].v[e % N]); }
  __device__ __forceinline__ void set(int e, float f) { p[e / N].v[e % N] = mz::from_f<T>(f); }
};

// One row's pass for the thread that holds chunks t, t + STEP, ... (CH of
// them, W values each, nc chunks in the row): every load issued before
// any is used (scale's with the row's), the residual sum rounded to T and
// stored, and this thread's part of the sum of squares, in the fixed
// order.  xs keeps the normed row, gs the scale, packed.
template <typename T, typename S, int W, int CH, int STEP, bool RESIDUAL>
__device__ __forceinline__ float row_load(const T* __restrict__ x,
                                          const T* __restrict__ res,
                                          const S* __restrict__ scale,
                                          T* __restrict__ sum_out, size_t base,
                                          int t, int nc, Chunk<T, W> (&xs)[CH],
                                          Chunk<S, W> (&gs)[CH]) {
  Chunk<T, W> rs[RESIDUAL ? CH : 1];
#pragma unroll
  for (int i = 0; i < CH; ++i) {
    const int c = t + STEP * i;
    if (c < nc) {
      gs[i].load(scale + c * W);
      xs[i].load(x + base + c * W);
      if constexpr (RESIDUAL) rs[i].load(res + base + c * W);
    }
  }
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < CH; ++i) {
    const int c = t + STEP * i;
    if (c < nc) {
      if constexpr (RESIDUAL) {
#pragma unroll
        for (int e = 0; e < W; ++e) xs[i].set(e, xs[i].get(e) + rs[i].get(e));
        xs[i].store(sum_out + base + c * W);
      }
#pragma unroll
      for (int e = 0; e < W; ++e) {
        const float a = xs[i].get(e);
        ss += a * a;
      }
    }
  }
  return ss;
}

template <typename T, typename S, int W, int CH, int STEP>
__device__ __forceinline__ void row_store(T* __restrict__ out, size_t base, int t,
                                          int nc, float inv, const Chunk<T, W> (&xs)[CH],
                                          const Chunk<S, W> (&gs)[CH]) {
#pragma unroll
  for (int i = 0; i < CH; ++i) {
    const int c = t + STEP * i;
    if (c < nc) {
      Chunk<T, W> y;
#pragma unroll
      for (int e = 0; e < W; ++e) y.set(e, xs[i].get(e) * inv * (1.f + gs[i].get(e)));
      y.store(out + base + c * W);
    }
  }
}

__device__ __forceinline__ float warp_sum(float ss) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  return ss;
}

template <typename T, typename S, int W, int CH, bool RESIDUAL>
__global__ void __launch_bounds__(32 * kWarpRowsBig, 1)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ res,
               const S* __restrict__ scale, T* __restrict__ sum_out,
               T* __restrict__ out, int n, int d, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= n) return;  // whole warp leaves together
  const size_t base = static_cast<size_t>(row) * d;
  const int nc = d / W;
  Chunk<T, W> xs[CH];
  Chunk<S, W> gs[CH];
  const float ss = warp_sum(row_load<T, S, W, CH, 32, RESIDUAL>(
      x, res, scale, sum_out, base, lane, nc, xs, gs));
  const float inv = rsqrtf(ss / static_cast<float>(d) + eps);
  row_store<T, S, W, CH, 32>(out, base, lane, nc, inv, xs, gs);
}

template <typename T, typename S, int W, int CH, bool RESIDUAL>
__global__ void __launch_bounds__(kRowThreads, 1)
rmsnorm_row_kernel(const T* __restrict__ x, const T* __restrict__ res,
                   const S* __restrict__ scale, T* __restrict__ sum_out,
                   T* __restrict__ out, int d, float eps) {
  __shared__ float warp_ss[kRowThreads / 32];
  const int t = threadIdx.x;
  const size_t base = static_cast<size_t>(blockIdx.x) * d;
  const int nc = d / W;
  Chunk<T, W> xs[CH];
  Chunk<S, W> gs[CH];
  const float ss = warp_sum(row_load<T, S, W, CH, kRowThreads, RESIDUAL>(
      x, res, scale, sum_out, base, t, nc, xs, gs));
  if ((t & 31) == 0) warp_ss[t >> 5] = ss;
  __syncthreads();
  float tot = 0.f;
#pragma unroll
  for (int w = 0; w < kRowThreads / 32; ++w) tot += warp_ss[w];  // fixed order
  const float inv = rsqrtf(tot / static_cast<float>(d) + eps);
  row_store<T, S, W, CH, kRowThreads>(out, base, t, nc, inv, xs, gs);
}

// d > kMaxD: one block a row, looping over it in tiles of kRowThreads
// chunks: a sum-of-squares pass (the residual sum rounded and stored on
// the way), then a second pass that re-reads the row (the stored sum) and
// writes the scaled values.  The sum keeps the row form's order: each
// thread over its chunks t, t + kRowThreads, ... and their values in
// order, the xor butterfly, the warps in order.
template <typename T, typename S, int W, bool RESIDUAL>
__global__ void __launch_bounds__(kRowThreads, 1)
rmsnorm_wide_kernel(const T* __restrict__ x, const T* __restrict__ res,
                    const S* __restrict__ scale, T* __restrict__ sum_out,
                    T* __restrict__ out, int d, float eps) {
  __shared__ float warp_ss[kRowThreads / 32];
  const int t = threadIdx.x;
  const size_t base = static_cast<size_t>(blockIdx.x) * d;
  const int nc = d / W;
  float ss = 0.f;
#pragma unroll 4
  for (int c = t; c < nc; c += kRowThreads) {
    Chunk<T, W> xs;
    xs.load(x + base + c * W);
    if constexpr (RESIDUAL) {
      Chunk<T, W> rs;
      rs.load(res + base + c * W);
#pragma unroll
      for (int e = 0; e < W; ++e) xs.set(e, xs.get(e) + rs.get(e));
      xs.store(sum_out + base + c * W);
    }
#pragma unroll
    for (int e = 0; e < W; ++e) {
      const float a = xs.get(e);
      ss += a * a;
    }
  }
  ss = warp_sum(ss);
  if ((t & 31) == 0) warp_ss[t >> 5] = ss;
  __syncthreads();
  float tot = 0.f;
#pragma unroll
  for (int w = 0; w < kRowThreads / 32; ++w) tot += warp_ss[w];  // fixed order
  const float inv = rsqrtf(tot / static_cast<float>(d) + eps);
  const T* src = RESIDUAL ? sum_out : x;   // this thread's own stores, re-read
#pragma unroll 4
  for (int c = t; c < nc; c += kRowThreads) {
    Chunk<T, W> xs, y;
    Chunk<S, W> gs;
    xs.load(src + base + c * W);
    gs.load(scale + c * W);
#pragma unroll
    for (int e = 0; e < W; ++e) y.set(e, xs.get(e) * inv * (1.f + gs.get(e)));
    y.store(out + base + c * W);
  }
}

template <typename T, typename S, int W, bool R>
cudaError_t launch_w(const void* x, const void* res, const void* scale,
                     void* sum_out, void* out, int n, int d, float eps,
                     cudaStream_t st) {
  if (d < 1 || d % W) return cudaErrorInvalidValue;
  const T* xp = static_cast<const T*>(x);
  const T* rp = static_cast<const T*>(res);
  const S* sp = static_cast<const S*>(scale);
  T* so = static_cast<T*>(sum_out);
  T* op = static_cast<T*>(out);
  const int nc = d / W;
  // values a thread holds, rounded up to 8, 16, 24 or 32 (a multiple of W)
#define MZ_PICK(VALS, K)                 \
  if ((VALS) <= 8) K(8 / W);             \
  else if ((VALS) <= 16) K(16 / W);      \
  else if ((VALS) <= 24) K(24 / W);      \
  else K(32 / W);
  if (d <= kWarpMaxD) {
    const int rows = n >= 1024 ? kWarpRowsBig : 1;
    const dim3 grid((n + rows - 1) / rows), block(32 * rows);
#define MZ_NORM(CH) rmsnorm_kernel<T, S, W, CH, R><<<grid, block, 0, st>>>(xp, rp, sp, so, op, n, d, eps)
    MZ_PICK((nc + 31) / 32 * W, MZ_NORM)
#undef MZ_NORM
  } else if (d > kMaxD) {
    rmsnorm_wide_kernel<T, S, W, R><<<n, kRowThreads, 0, st>>>(xp, rp, sp, so, op, d, eps);
  } else {
#define MZ_ROW(CH) rmsnorm_row_kernel<T, S, W, CH, R><<<n, kRowThreads, 0, st>>>(xp, rp, sp, so, op, d, eps)
    MZ_PICK((nc + kRowThreads - 1) / kRowThreads * W, MZ_ROW)
#undef MZ_ROW
  }
#undef MZ_PICK
  return cudaGetLastError();
}

template <typename T, typename S, bool R>
cudaError_t launch(const void* x, const void* res, const void* scale,
                   void* sum_out, void* out, int n, int d, int vec, float eps,
                   cudaStream_t st) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  if (vec == kVec) return launch_w<T, S, kVec, R>(x, res, scale, sum_out, out, n, d, eps, st);
  if (vec == 1) return launch_w<T, S, 1, R>(x, res, scale, sum_out, out, n, d, eps, st);
  return cudaErrorInvalidValue;
}

template <bool R>
int dispatch(const void* x, const void* res, const void* scale, void* sum_out,
             void* out, int n, int d, int vec, float eps, int x_dtype,
             int scale_dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e = mz::by_dtype(x_dtype, [&](auto xt) {
    return mz::by_dtype(scale_dtype, [&](auto gt) {
      return launch<decltype(xt), decltype(gt), R>(x, res, scale, sum_out, out, n, d,
                                                   vec, eps, st);
    });
  });
  return static_cast<int>(e);
}

}  // namespace

// x, out: (n, d) contiguous; scale: (d,).  vec: values a load,
// 16 / sizeof(x's type) (d a multiple of it, every pointer on a 16-byte
// boundary, scale on min(16, vec * its size)) or 1.
extern "C" int fused_rmsnorm(const void* x, const void* scale, void* out, int n,
                             int d, int vec, float eps, int x_dtype,
                             int scale_dtype, void* stream) {
  return dispatch<false>(x, nullptr, scale, nullptr, out, n, d, vec, eps, x_dtype,
                         scale_dtype, stream);
}

// x, res, sum_out, out: (n, d) contiguous; scale: (d,); vec as above.
extern "C" int fused_rmsnorm_residual(const void* x, const void* res,
                                      const void* scale, void* sum_out,
                                      void* out, int n, int d, int vec, float eps,
                                      int x_dtype, int scale_dtype, void* stream) {
  return dispatch<true>(x, res, scale, sum_out, out, n, d, vec, eps, x_dtype,
                        scale_dtype, stream);
}

MZ_ERROR_STRING(fused_norm)

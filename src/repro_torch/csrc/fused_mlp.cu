// Fused dense gated MLP for Hopper (sm_90a).
//
// Replaces the TPU kernel fused_mlp_pallas
// (src/repro/kernels/fused_mlp/kernel.py):
//     out = (silu(x @ wg) * (x @ wi)) @ wo        (swiglu)
//     out = gelu_tanh(x @ wi) @ wo                (no gate; wg never read)
// with float32 accumulation, and the (N, F) hidden activation never
// written to device memory.
//
// What bounds it on the H100: at decode width (N <= 8) bytes -- the three
// weight matrices (3*d*F values) are read for a handful of tokens; at
// prefill widths (N in the hundreds) operations.  The TPU kernel walked the
// ff axis in order inside one grid cell and carried the (bt, d) sum in
// VMEM.  Blocks on the card run in no order, so the ff axis is split
// across blocks instead, which gives the card enough blocks at every N:
//   pass 1, grid (ceil(N/16), ceil(F/FC)): a block takes 16 tokens and FC
//     hidden units, computes h = silu(x@wg[:,f])*(x@wi[:,f]) into shared
//     memory (float32) and multiplies it by wo[f, :] into a float32 partial
//     sum of all d outputs, written to a (F/FC, N, d) workspace;
//   pass 2 sums the partials in a fixed order and rounds once, so the
//     result does not depend on block timing.
// The hidden never leaves the SM; the partials are N*d floats per ff chunk.
// Products are plain float32 FMAs from shared-memory tiles; tensor cores
// (mma / wgmma) and TMA are later work.
#include "common.cuh"

namespace {

constexpr int kBT = 16;   // tokens a block
constexpr int kNT = 256;  // threads a block
constexpr int kBK = 32;   // d-chunk of the up projections

__device__ __forceinline__ float silu(float g) { return g / (1.f + expf(-g)); }

__device__ __forceinline__ float gelu_tanh(float x) {
  // jax.nn.gelu's default (approximate=True) form
  const float c = 0.7978845608028654f;  // sqrt(2/pi)
  return 0.5f * x * (1.f + tanhf(c * (x + 0.044715f * x * x * x)));
}

// FC hidden units a block; NC output columns a thread (d <= NC * kNT);
// KO rows of wo staged per step of the down projection.
template <typename T, int FC, int NC, bool SWIGLU>
__global__ void __launch_bounds__(kNT)
mlp_partial_kernel(const T* __restrict__ x, const T* __restrict__ wg,
                   const T* __restrict__ wi, const T* __restrict__ wo,
                   float* __restrict__ partial, int n, int d, int f) {
  constexpr int KO = NC <= 4 ? 8 : 4;
  constexpr int PA = kBT * FC / kNT;    // hidden values a thread computes
  constexpr int CPT = FC / 16;          // hidden columns a thread covers
  static_assert(PA == CPT, "16 rows x 16 column groups");
  constexpr int A_FLOATS = kBT * kBK + (SWIGLU ? 2 : 1) * kBK * FC;
  constexpr int B_FLOATS = KO * NC * kNT;
  constexpr int U_FLOATS = A_FLOATS > B_FLOATS ? A_FLOATS : B_FLOATS;
  __shared__ float hs[kBT * FC];        // hidden tile, float32
  __shared__ float u[U_FLOATS];         // up-projection tiles, then wo tiles
  float* xs = u;                        // [kBT][kBK]
  float* is = u + kBT * kBK;            // [kBK][FC]
  float* gs = is + kBK * FC;            // [kBK][FC] (swiglu)
  float* ws = u;                        // [KO][NC * kNT]

  const int t = threadIdx.x;
  const int t0 = blockIdx.x * kBT;
  const int f0 = blockIdx.y * FC;

  // -- pass 1a: h = act(x @ wg, x @ wi) for 16 tokens x FC hidden units --
  const int r = t / 16;      // token row of this thread
  const int cg = t % 16;     // column group: columns cg + 16*j
  float acc_i[CPT], acc_g[CPT];
#pragma unroll
  for (int j = 0; j < CPT; ++j) acc_i[j] = acc_g[j] = 0.f;
  for (int k0 = 0; k0 < d; k0 += kBK) {
    for (int e = t; e < kBT * kBK; e += kNT) {
      const int rr = e / kBK, kk = e % kBK;
      const int tok = t0 + rr, col = k0 + kk;
      xs[e] = (tok < n && col < d) ? mz::to_f(x[static_cast<size_t>(tok) * d + col]) : 0.f;
    }
    for (int e = t; e < kBK * FC; e += kNT) {
      const int kk = e / FC, c = e % FC;
      const int row = k0 + kk, ff = f0 + c;
      const bool ok = row < d && ff < f;
      const size_t off = static_cast<size_t>(row) * f + ff;
      is[e] = ok ? mz::to_f(wi[off]) : 0.f;
      if (SWIGLU) gs[e] = ok ? mz::to_f(wg[off]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      const float xv = xs[r * kBK + kk];
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        acc_i[j] += xv * is[kk * FC + cg + 16 * j];
        if (SWIGLU) acc_g[j] += xv * gs[kk * FC + cg + 16 * j];
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    const float h = SWIGLU ? silu(acc_g[j]) * acc_i[j] : gelu_tanh(acc_i[j]);
    hs[r * FC + cg + 16 * j] = h;
  }
  __syncthreads();

  // -- pass 1b: partial[y, tok, :] = h @ wo[f0:f0+FC, :] -------------------
  float acc[kBT][NC];
#pragma unroll
  for (int rr = 0; rr < kBT; ++rr)
#pragma unroll
    for (int i = 0; i < NC; ++i) acc[rr][i] = 0.f;
  for (int c0 = 0; c0 < FC; c0 += KO) {
    for (int e = t; e < KO * d; e += kNT) {
      const int kk = e / d, col = e % d;
      const int ff = f0 + c0 + kk;
      ws[kk * NC * kNT + col] = ff < f ? mz::to_f(wo[static_cast<size_t>(ff) * d + col]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KO; ++kk) {
      float w[NC];
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        const int col = t + kNT * i;
        w[i] = col < d ? ws[kk * NC * kNT + col] : 0.f;
      }
#pragma unroll
      for (int rr = 0; rr < kBT; ++rr) {
        const float hv = hs[rr * FC + c0 + kk];
#pragma unroll
        for (int i = 0; i < NC; ++i) acc[rr][i] += hv * w[i];
      }
    }
    __syncthreads();
  }
  float* dst = partial + static_cast<size_t>(blockIdx.y) * n * d;
#pragma unroll
  for (int rr = 0; rr < kBT; ++rr) {
    const int tok = t0 + rr;
    if (tok >= n) break;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int col = t + kNT * i;
      if (col < d) dst[static_cast<size_t>(tok) * d + col] = acc[rr][i];
    }
  }
}

template <typename T>
__global__ void mlp_reduce_kernel(const float* __restrict__ partial,
                                  T* __restrict__ out, int chunks, size_t nd) {
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= nd) return;
  float s = 0.f;
  for (int c = 0; c < chunks; ++c) s += partial[c * nd + idx];
  out[idx] = mz::from_f<T>(s);
}

template <typename T, int FC, int NC, bool SW>
cudaError_t launch(const void* x, const void* wg, const void* wi, const void* wo,
                   float* partial, void* out, int n, int d, int f, cudaStream_t st) {
  const int chunks = (f + FC - 1) / FC;
  const dim3 grid((n + kBT - 1) / kBT, chunks);
  mlp_partial_kernel<T, FC, NC, SW><<<grid, kNT, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(wg), static_cast<const T*>(wi),
      static_cast<const T*>(wo), partial, n, d, f);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const size_t nd = static_cast<size_t>(n) * d;
  mlp_reduce_kernel<T><<<static_cast<unsigned>((nd + 255) / 256), 256, 0, st>>>(
      partial, static_cast<T*>(out), chunks, nd);
  return cudaGetLastError();
}

template <typename T, int NC, bool SW>
cudaError_t by_width(const void* x, const void* wg, const void* wi, const void* wo,
                     float* partial, void* out, int n, int d, int f, int fc,
                     cudaStream_t st) {
  if (fc == 32) return launch<T, 32, NC, SW>(x, wg, wi, wo, partial, out, n, d, f, st);
  if (fc == 128) return launch<T, 128, NC, SW>(x, wg, wi, wo, partial, out, n, d, f, st);
  return cudaErrorInvalidValue;
}

template <typename T, bool SW>
cudaError_t by_d(const void* x, const void* wg, const void* wi, const void* wo,
                 float* partial, void* out, int n, int d, int f, int fc,
                 cudaStream_t st) {
  if (d <= 3 * kNT) return by_width<T, 3, SW>(x, wg, wi, wo, partial, out, n, d, f, fc, st);
  if (d <= 8 * kNT) return by_width<T, 8, SW>(x, wg, wi, wo, partial, out, n, d, f, fc, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// x: (n, d); wg, wi: (d, f); wo: (f, d); out: (n, d); all contiguous, one
// element type.  partial: float32 workspace of ceil(f/fc)*n*d values.
// fc (hidden units a block) is 32 or 128; d <= 2048.  wg may be null when
// swiglu is 0.
extern "C" int fused_mlp(const void* x, const void* wg, const void* wi,
                         const void* wo, void* partial, void* out, int n, int d,
                         int f, int fc, int swiglu, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(partial);
  cudaError_t e;
  if (dtype == 0)
    e = swiglu ? by_d<float, true>(x, wg, wi, wo, p, out, n, d, f, fc, st)
               : by_d<float, false>(x, wg, wi, wo, p, out, n, d, f, fc, st);
  else if (dtype == 1)
    e = swiglu ? by_d<__nv_bfloat16, true>(x, wg, wi, wo, p, out, n, d, f, fc, st)
               : by_d<__nv_bfloat16, false>(x, wg, wi, wo, p, out, n, d, f, fc, st);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}

MZ_ERROR_STRING(fused_mlp)

// Grouped gated-MLP tile kernels shared by fused_mlp.cu (one expert) and
// moe_mlp.cu (E experts), for Hopper (sm_90a).
//
//     out[e] = (silu(x[e] @ wg[e]) * (x[e] @ wi[e])) @ wo[e]     (swiglu)
//     out[e] = gelu_tanh(x[e] @ wi[e]) @ wo[e]                   (no gate)
//
// with float32 accumulation and the (n, F) hidden activation never in
// device memory.  x: (E, n, d); wg, wi: (E, d, F); wo: (E, F, d); out:
// (E, n, d), all contiguous in one element type.
//
// The TPU kernels walked the ff axis in order inside one grid cell and
// carried the (bt, d) sum in VMEM.  Blocks on the card run in no order,
// so the ff axis is split across blocks instead:
//   pass 1, grid (ceil(n/16), ceil(F/FC), E): a block takes 16 tokens of
//     one expert and FC hidden units, computes h = act(x@wg, x@wi) into
//     shared memory (float32) and multiplies it by wo[f0:f0+FC, :] into a
//     float32 partial sum of all d outputs, in column tiles of NC*256 (a
//     thread keeps 16 x NC sums in registers, so any d works without
//     spilling), written to an (E, F/FC, n, d) workspace;
//   pass 2 sums the partials in a fixed order and rounds once, so the
//     result does not depend on block timing.
// Each block reads its expert's weight columns once for its 16 tokens:
// the weights are read once per token block, not once per row, and
// neighbouring token blocks of one (chunk, expert) run next to each other
// (blockIdx.x varies fastest), so their second reads mostly hit L2.
// Products are plain float32 FMAs from shared-memory tiles; tensor cores
// (mma / wgmma) and TMA are later work.
#pragma once

#include "common.cuh"

namespace mz {

constexpr int kMlpBT = 16;   // tokens a block
constexpr int kMlpNT = 256;  // threads a block
constexpr int kMlpBK = 32;   // d-chunk of the up projections

__device__ __forceinline__ float silu(float g) { return g / (1.f + expf(-g)); }

__device__ __forceinline__ float gelu_tanh(float x) {
  // jax.nn.gelu's default (approximate=True) form
  const float c = 0.7978845608028654f;  // sqrt(2/pi)
  return 0.5f * x * (1.f + tanhf(c * (x + 0.044715f * x * x * x)));
}

// FC hidden units a block; NC output columns a thread in each column
// tile of NC * kMlpNT; KO rows of wo staged per step of the down
// projection.
template <typename T, int FC, int NC, bool SWIGLU>
__global__ void __launch_bounds__(kMlpNT)
mlp_partial_kernel(const T* __restrict__ x, const T* __restrict__ wg,
                   const T* __restrict__ wi, const T* __restrict__ wo,
                   float* __restrict__ partial, int n, int d, int f) {
  constexpr int kBT = kMlpBT, kNT = kMlpNT, kBK = kMlpBK;
  constexpr int KO = NC <= 4 ? 8 : 4;
  constexpr int W = NC * kNT;           // columns of one output tile
  constexpr int PA = kBT * FC / kNT;    // hidden values a thread computes
  constexpr int CPT = FC / 16;          // hidden columns a thread covers
  static_assert(PA == CPT, "16 rows x 16 column groups");
  constexpr int A_FLOATS = kBT * kBK + (SWIGLU ? 2 : 1) * kBK * FC;
  constexpr int B_FLOATS = KO * W;
  constexpr int U_FLOATS = A_FLOATS > B_FLOATS ? A_FLOATS : B_FLOATS;
  __shared__ float hs[kBT * FC];        // hidden tile, float32
  __shared__ float u[U_FLOATS];         // up-projection tiles, then wo tiles
  float* xs = u;                        // [kBT][kBK]
  float* is = u + kBT * kBK;            // [kBK][FC]
  float* gs = is + kBK * FC;            // [kBK][FC] (swiglu)
  float* ws = u;                        // [KO][W]

  const int t = threadIdx.x;
  const int t0 = blockIdx.x * kBT;
  const int f0 = blockIdx.y * FC;
  const size_t ex = blockIdx.z;         // expert
  x += ex * n * d;
  wi += ex * d * f;
  if (SWIGLU) wg += ex * d * f;
  wo += ex * f * d;

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
      xs[e] = (tok < n && col < d) ? to_f(x[static_cast<size_t>(tok) * d + col]) : 0.f;
    }
    for (int e = t; e < kBK * FC; e += kNT) {
      const int kk = e / FC, c = e % FC;
      const int row = k0 + kk, ff = f0 + c;
      const bool ok = row < d && ff < f;
      const size_t off = static_cast<size_t>(row) * f + ff;
      is[e] = ok ? to_f(wi[off]) : 0.f;
      if (SWIGLU) gs[e] = ok ? to_f(wg[off]) : 0.f;
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

  // -- pass 1b: partial[e, y, tok, :] = h @ wo[f0:f0+FC, :], tile by tile --
  float* dst = partial + (ex * gridDim.y + blockIdx.y) * static_cast<size_t>(n) * d;
  for (int cb = 0; cb < d; cb += W) {
    float acc[kBT][NC];
#pragma unroll
    for (int rr = 0; rr < kBT; ++rr)
#pragma unroll
      for (int i = 0; i < NC; ++i) acc[rr][i] = 0.f;
    for (int c0 = 0; c0 < FC; c0 += KO) {
      for (int e = t; e < KO * W; e += kNT) {
        const int kk = e / W, col = cb + e % W;
        const int ff = f0 + c0 + kk;
        ws[e] = (ff < f && col < d) ? to_f(wo[static_cast<size_t>(ff) * d + col]) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < KO; ++kk) {
        float w[NC];
#pragma unroll
        for (int i = 0; i < NC; ++i) w[i] = ws[kk * W + t + kNT * i];
#pragma unroll
        for (int rr = 0; rr < kBT; ++rr) {
          const float hv = hs[rr * FC + c0 + kk];
#pragma unroll
          for (int i = 0; i < NC; ++i) acc[rr][i] += hv * w[i];
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int rr = 0; rr < kBT; ++rr) {
      const int tok = t0 + rr;
      if (tok >= n) break;
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        const int col = cb + t + kNT * i;
        if (col < d) dst[static_cast<size_t>(tok) * d + col] = acc[rr][i];
      }
    }
  }
}

// out[e, i] = sum over the chunks of partial[e, chunk, i], in chunk order.
template <typename T>
__global__ void mlp_reduce_kernel(const float* __restrict__ partial,
                                  T* __restrict__ out, int chunks, size_t nd,
                                  size_t total) {
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const size_t e = idx / nd, i = idx % nd;
  const float* p = partial + e * chunks * nd + i;
  float s = 0.f;
  for (int c = 0; c < chunks; ++c) s += p[c * nd];
  out[idx] = from_f<T>(s);
}

template <typename T, int FC, int NC, bool SW>
cudaError_t mlp_launch(const void* x, const void* wg, const void* wi,
                       const void* wo, float* partial, void* out, int experts,
                       int n, int d, int f, cudaStream_t st) {
  const int chunks = (f + FC - 1) / FC;
  const dim3 grid((n + kMlpBT - 1) / kMlpBT, chunks, experts);
  mlp_partial_kernel<T, FC, NC, SW><<<grid, kMlpNT, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(wg), static_cast<const T*>(wi),
      static_cast<const T*>(wo), partial, n, d, f);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const size_t nd = static_cast<size_t>(n) * d;
  const size_t total = nd * experts;
  mlp_reduce_kernel<T><<<static_cast<unsigned>((total + 255) / 256), 256, 0, st>>>(
      partial, static_cast<T*>(out), chunks, nd, total);
  return cudaGetLastError();
}

template <typename T, int NC, bool SW>
cudaError_t mlp_by_chunk(const void* x, const void* wg, const void* wi,
                         const void* wo, float* partial, void* out, int experts,
                         int n, int d, int f, int fc, cudaStream_t st) {
  if (fc == 32) return mlp_launch<T, 32, NC, SW>(x, wg, wi, wo, partial, out, experts, n, d, f, st);
  if (fc == 128) return mlp_launch<T, 128, NC, SW>(x, wg, wi, wo, partial, out, experts, n, d, f, st);
  return cudaErrorInvalidValue;
}

// Column tiles of 3 x 256 for narrow models (smollm's 576 in one tile),
// 8 x 256 otherwise (2048 a tile; d 4096 takes two, d 5120 three).
template <typename T, bool SW>
cudaError_t mlp_by_d(const void* x, const void* wg, const void* wi,
                     const void* wo, float* partial, void* out, int experts,
                     int n, int d, int f, int fc, cudaStream_t st) {
  if (d <= 3 * kMlpNT)
    return mlp_by_chunk<T, 3, SW>(x, wg, wi, wo, partial, out, experts, n, d, f, fc, st);
  return mlp_by_chunk<T, 8, SW>(x, wg, wi, wo, partial, out, experts, n, d, f, fc, st);
}

// The entry both libraries export: dtype 0 = float32, 1 = bfloat16.
inline int mlp_entry(const void* x, const void* wg, const void* wi,
                     const void* wo, void* partial, void* out, int experts,
                     int n, int d, int f, int fc, int swiglu, int dtype,
                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(partial);
  if (experts < 1 || n < 1 || d < 1 || f < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e;
  if (dtype == 0)
    e = swiglu ? mlp_by_d<float, true>(x, wg, wi, wo, p, out, experts, n, d, f, fc, st)
               : mlp_by_d<float, false>(x, wg, wi, wo, p, out, experts, n, d, f, fc, st);
  else if (dtype == 1)
    e = swiglu ? mlp_by_d<__nv_bfloat16, true>(x, wg, wi, wo, p, out, experts, n, d, f, fc, st)
               : mlp_by_d<__nv_bfloat16, false>(x, wg, wi, wo, p, out, experts, n, d, f, fc, st);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}

}  // namespace mz

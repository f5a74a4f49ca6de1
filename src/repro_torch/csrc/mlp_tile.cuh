// Grouped gated-MLP tile kernels shared by fused_mlp.cu (one expert) and
// moe_mlp.cu (E experts), for Hopper (sm_90a).
//
//     out[e] = (silu(x[e] @ wg[e]) * (x[e] @ wi[e])) @ wo[e]     (swiglu)
//     out[e] = gelu_tanh(x[e] @ wi[e]) @ wo[e]                   (no gate)
//
// with float32 accumulation, the output rounded once to x's type and the
// (n, F) hidden activation never in device memory.  x: (E, n, d); wg, wi:
// (E, d, F); wo: (E, F, d); out: (E, n, d), all contiguous in one element
// type.  The TPU kernels (src/repro/kernels/fused_mlp/kernel.py:31-72,
// moe_mlp/kernel.py:26-51) walk the ff axis in order inside one grid cell
// and carry the (bt, d) sum in VMEM.
//
// What bounds it on the H100: bytes.  At decode every weight byte is read
// for a handful of tokens (mixtral, 8 experts of d 4096, F 14336: 2.82 GB,
// 0.84 ms at 3.35 TB/s); at mixtral's 256-token prefill (capacity 80) the
// same bytes still outweigh the 225 GFLOP at the bf16 tensor peak
// (0.23 ms).  So each weight byte must be read once, by tiles that keep
// enough bytes in flight, and the products must not be the limit.
//
// bfloat16 and float16 route: the cluster tile (mlp_cluster_kernel,
// templated on the 16-bit type T: its mma.sync and its tensor maps' element
// type are T's, the rest is type-blind).  A thread-block
// cluster of CL blocks (8, or 16 where d > 1024) owns one item -- one token
// tile of one expert -- and walks its ff chunks (CL * 64 hidden units
// each) in order, the Hopper form of the TPU grid's sequential ff axis:
//   up:   block r computes h = act(x @ wg, x @ wi) for its 64 hidden units
//         of the chunk, from weight columns only it reads, and stores h in
//         its shared memory, rounded once to T;
//   then a cluster barrier;
//   down: block r reads every block's h slice through distributed shared
//         memory and multiplies it by its own d/CL columns of wo[chunk, :],
//         adding into a float32 (d/CL x tokens) sum it keeps in registers
//         across the whole walk.
// Each weight byte is read from device memory by exactly one block, h
// never reaches device memory, and the sum runs in one fixed order, so
// the result is deterministic (no atomics).  The products are tensor-core
// mma.sync.m16n8k16 (bf16 or fp16 in, float32 sums) with the weights as the M
// side (64 hidden units or 16 output columns a tile) and the tokens as N
// (8 to 128), so a decode step pads tokens to 8, not 16 or 64:
// h^T = W^T x^T, out^T = wo^T h^T; operands come from shared memory by
// ldmatrix (.trans for the weights' row-major (k, m) tiles).  One thread
// feeds a ring of 3-8 stages of dynamic shared memory by TMA (3-D tensor
// maps, boxes of 64 columns with the 128-byte swizzle, zeros past every
// edge), completing on mbarriers: ~100-200 KB in flight a block.
//
// How many clusters run: items = E x token tiles.  A card holds only so
// many clusters of 16 at once (7 on the H100 measured: one GPC has fewer
// than 16 free SMs), so the launch takes no more clusters than the CUDA
// occupancy query allows.  Cluster k takes whole items k, k + clusters,
// ... and writes their rows; the items left over are cut into chunk
// ranges dealt to the clusters, each writing a float32 (rows, d) partial
// that mlp_fixup_kernel sums in part order.  At mixtral's 8 experts on 7
// clusters, each cluster walks one expert and a seventh of the eighth:
// one wave, not two, for 7 * C * d float32 partials (11 MB at C 96).
// Where items are fewer than 8 (fused_mlp's one expert) they are cut the
// same way over up to 8 clusters.
//
// The old design's faults, one by one: scalar float32 FMAs become tensor-
// core products; scalar 2-byte loads become TMA boxes in a deep ring; the
// (E, F/128, n, d) float32 partial workspace and its reduce pass are gone
// (a partial remains only for the leftover parts); decode pads tokens to
// 8, not 16.
//
// The rounding this route adds: the plain version keeps h in float32; here
// h is rounded once to T before the down projection, as the tensor cores
// take it (held to the bf16 tolerance of 2.5e-2 by
// tests/test_torch_mlp_tile.py and chip_smoke.py).  The route needs d and
// F to be multiples of 8 (16-byte rows); the wrappers check that, and the
// tile plan (kernels/_mlp_plan.py) picks CL, the token tile and the
// cluster count.
//
// Wide d: a block's output columns set its register tile (MW m16 tiles a
// warp, at most 3), so past kTcMaxCols = 6144 columns the output columns
// are cut into groups, one launch a group over the same plan.  Each group
// walks the ff axis again and recomputes h (wi and wg are read once more a
// group: a stated cost); every output column's float32 sum still runs in
// one fixed order, so the result is the ungrouped one's, bit for bit, and
// the same from launch to launch.
//
// float32 route: the FMA tile of the first port (mlp_partial_kernel +
// mlp_reduce_kernel), kept for float32 inputs (the end-to-end float32
// checks): the ff axis split across blocks into float32 partials, 16
// tokens a block, the output columns in tiles of NC * 256, summed in a
// fixed order by a second pass.
#pragma once

#include <cooperative_groups.h>
#include <cuda.h>
#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace mz {

// ---- float32 route: the FMA tile -------------------------------------

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

// ---- bfloat16 route: the cluster tile ----------------------------------

constexpr int kTcThreads = 256;   // 8 warps a block
constexpr int kTcHB = 64;         // hidden units a block a chunk
constexpr int kTcBox = 64;        // columns of one TMA box: 128 bytes
constexpr int kTcPad = 8;         // bf16 values of row padding of h
constexpr int kTcMaxStages = 8;   // ring stages at most
constexpr int kTcSmemMax = 232192;   // 227 KB less the static barriers
constexpr int kTcMaxCols = 6144;  // output columns a launch (the register tile's)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of the 16-byte chunk `c` (of 8) of row `r` in a box of
// 128-byte rows written by TMA with the 128-byte swizzle
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return static_cast<uint32_t>(r * 128 + ((c ^ (r & 7)) << 4));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile("{\n .reg .pred p;\n"
                 " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 " selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
}

// one TMA box of a 3-D map (columns, rows, expert) into shared memory
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int c, int r, int e, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(r),
         "r"(e), "r"(smem_u32(bar)) : "memory");
}

// A fragment of m16n8k16 from a (k, m) tile: four 8x8 matrices,
// transposed as they load
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// B fragment of m16n8k16 from an (n, k) tile
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(addr));
}

// The geometry of one launch, computed on the host; mirrored by
// kernels/_mlp_plan.py, which picks cl, nt and the cluster count.
//
// The work is `items` = E x token tiles, each a walk over `chunks` ff
// chunks.  `clusters` clusters run at once (no more than the card holds
// together): cluster k takes the whole items k, k + clusters, ...
// (`rounds` of them) and writes their output; the `leftover` items that
// remain are cut into `parts` chunk ranges each, dealt to the clusters in
// turn, and each part writes a float32 (min(nt, n), d) partial that
// mlp_fixup_kernel sums in part order.  Every cluster walks about the
// same number of chunks, and where the card holds one cluster an item
// nothing is left over and nothing is written but the output.
struct TcPlan {
  int cl, nt, mw, tiles;                // cluster size, token tile, m16
                                        // tiles a warp (down), token tiles
  int chunks, clusters, rounds, leftover, parts;
  int groups, gcols;                    // column groups of d, columns a group
  int col0, gend;                       // this launch's group: [col0, gend)
  int cpb;                              // output columns a block (x 64)
  int bk;                               // d rows of one up-projection step
  int stage_bytes, stages, smem;        // ring stage, stages, dynamic bytes
};

inline int tc_plan(int experts, int n, int d, int f, int cl, int nt,
                   int clusters, bool sw, TcPlan* p) {
  if ((cl != 8 && cl != 16) || nt < 8 || nt % 8 || d % 8 || f % 8 || clusters < 1)
    return 1;
  p->cl = cl;
  p->nt = nt;
  p->bk = nt <= 32 ? 128 : 64;          // deeper steps where x's tile is small
  p->tiles = (n + nt - 1) / nt;
  // d's output columns in groups of at most kTcMaxCols, one launch each
  p->groups = (d + kTcMaxCols - 1) / kTcMaxCols;
  p->gcols = p->groups == 1 ? d
                            : ((d + p->groups - 1) / p->groups + kTcBox - 1) / kTcBox * kTcBox;
  p->col0 = 0;
  p->gend = p->gcols < d ? p->gcols : d;
  p->cpb = ((p->gcols + cl - 1) / cl + kTcBox - 1) / kTcBox * kTcBox;
  p->mw = (p->cpb / 16 + 7) / 8;
  p->chunks = (f + cl * kTcHB - 1) / (cl * kTcHB);
  const int items = experts * p->tiles;
  p->clusters = clusters;
  p->rounds = items / clusters;
  p->leftover = items - p->rounds * clusters;
  p->parts = p->leftover ? (clusters < p->chunks ? clusters : p->chunks) : 0;
  const int up = (p->bk / kTcBox) * nt * 128 + (sw ? 2 : 1) * p->bk * 128;
  const int down = (p->cpb / kTcBox) * kTcHB * 128;
  p->stage_bytes = ((up > down ? up : down) + 1023) / 1024 * 1024;
  // as many stages as shared memory holds (1024 bytes for the swizzle's
  // alignment), at most kTcMaxStages
  const int hbytes = 3 * nt * (kTcHB + kTcPad) * 2 + 4096;
  p->stages = (kTcSmemMax - 1024 - hbytes) / p->stage_bytes;
  if (p->stages > kTcMaxStages) p->stages = kTcMaxStages;
  p->smem = 1024 + p->stages * p->stage_bytes + hbytes;
  return p->stages >= 3 ? 0 : 1;
}

// One run of chunks [c0, c0 + nch) of one item; part < 0: a whole item.
struct TcSeg {
  int item, c0, nch, part;
};

// the s-th segment of cluster k
__device__ __forceinline__ TcSeg tc_seg(const TcPlan& p, int k, int s) {
  if (s < p.rounds) return {k + s * p.clusters, 0, p.chunks, -1};
  const int g = k + (s - p.rounds) * p.clusters;   // leftover part
  const int q = g % p.parts;
  const int b = q * p.chunks / p.parts, e = (q + 1) * p.chunks / p.parts;
  return {p.rounds * p.clusters + g / p.parts, b, e - b, g};
}

__device__ __forceinline__ int tc_nseg(const TcPlan& p, int k) {
  const int lp = p.leftover * p.parts;
  return p.rounds + (k < lp ? (lp - k + p.clusters - 1) / p.clusters : 0);
}

// Cluster k = blockIdx.x / CL walks its segments (tc_seg) in order; for
// each chunk of a segment this block (cluster rank r) computes hidden
// units [chunk * CL * 64 + r * 64, +64) and, over the chunk, output
// columns [r * cpb, (r + 1) * cpb) of the segment's token tile.  NT tokens a tile; MW m16 tiles a warp
// in the down projection (cpb <= MW * 128).  Thread 0 feeds the ring by
// TMA (3-D maps of x (d, n, E), wg / wi (F, d, E) and wo (d, F, E), boxes
// of 64 columns, 128-byte swizzle, zeros past every edge).
template <typename T, int NT, int MW, bool SW>
__global__ void __launch_bounds__(kTcThreads, 1)
mlp_cluster_kernel(const __grid_constant__ CUtensorMap tm_x,
                   const __grid_constant__ CUtensorMap tm_g,
                   const __grid_constant__ CUtensorMap tm_i,
                   const __grid_constant__ CUtensorMap tm_o,
                   T* __restrict__ out, float* __restrict__ partial,
                   int n, int d, int f, TcPlan p) {
  using bf = T;
  constexpr int HB = kTcHB, HS = HB + kTcPad;
  constexpr int NTL = NT / 8;             // n8 tiles of the token tile
  // up phase: warp = (m16 tile of the 64 hidden units, half); the half
  // splits the token tiles, or each step's d rows where there is one
  constexpr bool KSPLIT = NTL == 1;
  constexpr int NH = KSPLIT ? 1 : (NTL + 1) / 2;
  constexpr int UNROLL = NTL >= 8 ? 1 : 4;   // wide tiles: registers for sums
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t full[kTcMaxStages];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  bf* hbuf = reinterpret_cast<bf*>(ring + p.stages * p.stage_bytes);  // [2][NT][HS]
  bf* hloc = hbuf + 2 * NT * HS;          // [NT][HS]: one peer's slice
  float* kred = reinterpret_cast<float*>(hloc + NT * HS);   // [4][32][8]: the
                                          // second half's sums (KSPLIT)

  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int cl = p.cl, bk = p.bk;
  const int rank = static_cast<int>(cluster.block_rank());
  const int k = blockIdx.x / cl;          // this cluster
  const int fc = cl * HB;
  const int ks = (d + bk - 1) / bk;       // up steps a chunk
  const int spc = ks + cl;                // steps a chunk: up, then one per peer
  const int nseg = tc_nseg(p, k);
  int total = 0;
  for (int s = 0; s < nseg; ++s) total += tc_seg(p, k, s).nch * spc;
  const int c0 = p.col0 + rank * p.cpb;   // first output column of this block
  const int mtiles = p.cpb / 16;
  const int xbytes = (bk / kTcBox) * NT * 128;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) mbar_init(&full[s]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // thread 0: the TMA boxes of step i into its ring stage
  auto load = [&](int i) {
    unsigned char* st = ring + (i % p.stages) * p.stage_bytes;
    uint64_t* bar = &full[i % p.stages];
    int rem = i, s = 0;
    TcSeg sg = tc_seg(p, k, 0);
    while (rem >= sg.nch * spc) {
      rem -= sg.nch * spc;
      sg = tc_seg(p, k, ++s);
    }
    const int chunk = sg.c0 + rem / spc, j = rem % spc;
    const int ex = sg.item / p.tiles, tile0 = sg.item % p.tiles * NT;
    if (j < ks) {                         // x[tile, k0:k0+bk], w[k0:k0+bk, hidden]
      const int k0 = j * bk, fb = chunk * fc + rank * HB;
      mbar_expect(bar, xbytes + (SW ? 2 : 1) * bk * 128);
      for (int b = 0; b < bk / kTcBox; ++b)
        tma_load(st + b * NT * 128, &tm_x, k0 + b * kTcBox, tile0, ex, bar);
      tma_load(st + xbytes, &tm_i, fb, k0, ex, bar);
      if (SW) tma_load(st + xbytes + bk * 128, &tm_g, fb, k0, ex, bar);
    } else {                              // wo[peer's 64 hidden rows, my columns]
      const int fb = chunk * fc + ((rank + j - ks) % cl) * HB;
      mbar_expect(bar, (p.cpb / kTcBox) * HB * 128);
      for (int b = 0; b < p.cpb / kTcBox; ++b)
        tma_load(st + b * HB * 128, &tm_o, c0 + b * kTcBox, fb, ex, bar);
    }
  };

  float acc[MW][NTL][4];                  // out^T sum: this block's columns
  float ai[NH][4], ag[NH][4];             // h^T of one chunk: up and gate
  const int mu = warp & 3, half = warp >> 2;
  // ldmatrix lanes: x4.trans A from (k, m) tiles, x2 B from (n, k) tiles
  const int a_k = ((lane >> 4) << 3) + (lane & 7), a_c = (lane >> 3) & 1;
  const int b_n = lane & 7, b_c = (lane >> 3) & 1;

  if (tid == 0)
    for (int i = 0; i < p.stages - 1 && i < total; ++i) load(i);
  int i = 0;
  for (int sgi = 0; sgi < nseg; ++sgi) {
    const TcSeg sg = tc_seg(p, k, sgi);
#pragma unroll
    for (int m = 0; m < MW; ++m)
#pragma unroll
      for (int t = 0; t < NTL; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][t][e] = 0.f;
    for (int ci = 0; ci < sg.nch * spc; ++ci, ++i) {
      const int s = i % p.stages;
      mbar_wait(&full[s], (i / p.stages) & 1);
      __syncthreads();                      // every thread is done with step i-1
      if (tid == 0 && i + p.stages - 1 < total) {
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        load(i + p.stages - 1);             // into step i-1's stage
      }
      const unsigned char* st = ring + s * p.stage_bytes;
      const int lc = i / spc, j = i % spc;
      bf* hb = hbuf + (lc & 1) * NT * HS;
      if (j < ks) {
        if (j == 0) {
#pragma unroll
          for (int t = 0; t < NH; ++t)
#pragma unroll
            for (int e = 0; e < 4; ++e) ai[t][e] = ag[t][e] = 0.f;
        }
        const uint32_t xs = smem_u32(st), is = xs + xbytes, gs = is + bk * 128;
        const int k_lo = KSPLIT ? half * (bk / 2) : 0, k_hi = KSPLIT ? k_lo + bk / 2 : bk;
#pragma unroll UNROLL
        for (int kk = k_lo; kk < k_hi; kk += 16) {
          uint32_t a_i[4], a_g[4];
          const uint32_t wa = swz(kk + a_k, mu * 2 + a_c);
          ldsm_x4_t(a_i, is + wa);
          if (SW) ldsm_x4_t(a_g, gs + wa);
          const int xb = kk / kTcBox, xc = (kk % kTcBox) / 8 + b_c;
#pragma unroll
          for (int t = 0; t < NH; ++t) {
            const int nt = KSPLIT ? 0 : half * NH + t;
            if (nt < NTL) {
              uint32_t b[2];
              ldsm_x2(b, xs + xb * NT * 128 + swz(nt * 8 + b_n, xc));
              mma16<T>(ai[t], a_i, b[0], b[1]);
              if (SW) mma16<T>(ag[t], a_g, b[0], b[1]);
            }
          }
        }
        if (j == ks - 1) {                  // h = act(...), rounded once to T
          if (KSPLIT) {                     // the halves' sums, in a fixed order
            if (half == 1)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                kred[(mu * 32 + lane) * 8 + e] = ai[0][e];
                kred[(mu * 32 + lane) * 8 + 4 + e] = ag[0][e];
              }
            __syncthreads();
            if (half == 0)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                ai[0][e] += kred[(mu * 32 + lane) * 8 + e];
                ag[0][e] += kred[(mu * 32 + lane) * 8 + 4 + e];
              }
          }
#pragma unroll
          for (int t = 0; t < NH; ++t) {
            const int nt = KSPLIT ? (half == 0 ? 0 : NTL) : half * NH + t;
            if (nt < NTL) {
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int row = mu * 16 + (lane >> 2) + ((e >> 1) << 3);
                const int tok = nt * 8 + 2 * (lane & 3) + (e & 1);
                const float h = SW ? silu(ag[t][e]) * ai[t][e] : gelu_tanh(ai[t][e]);
                hb[tok * HS + row] = from_f<T>(h);
              }
            }
          }
          cluster.sync();                   // every slice of the chunk is ready
        }
      } else {
        // the peer's h slice, through distributed shared memory
        const bf* remote = cluster.map_shared_rank(hb, (rank + j - ks) % cl);
        for (int v = tid; v < NT * (HB / 8); v += kTcThreads) {
          const int r = v / (HB / 8), cc = v % (HB / 8) * 8;
          *reinterpret_cast<uint4*>(hloc + r * HS + cc) =
              *reinterpret_cast<const uint4*>(remote + r * HS + cc);
        }
        __syncthreads();
        const uint32_t ws = smem_u32(st), hl = smem_u32(hloc);
#pragma unroll
        for (int kk = 0; kk < HB; kk += 16) {
          uint32_t a[MW][4];
#pragma unroll
          for (int m = 0; m < MW; ++m) {
            const int mt = warp + 8 * m;    // columns mt*16.. of box mt/4
            if (mt < mtiles)
              ldsm_x4_t(a[m], ws + (mt >> 2) * HB * 128 + swz(kk + a_k, (mt & 3) * 2 + a_c));
          }
#pragma unroll
          for (int nt = 0; nt < NTL; ++nt) {
            uint32_t b[2];
            ldsm_x2(b, hl + ((nt * 8 + b_n) * HS + kk + b_c * 8) * 2);
#pragma unroll
            for (int m = 0; m < MW; ++m)
              if (warp + 8 * m < mtiles) mma16<T>(acc[m][nt], a[m], b[0], b[1]);
          }
        }
      }
    }
    // the segment's output: the item's rows, or this part's float32 partial
    const int ex = sg.item / p.tiles, tile0 = sg.item % p.tiles * NT;
    const int ncols = min(p.cpb, p.gend - c0);   // none past the group
#pragma unroll
    for (int m = 0; m < MW; ++m) {
      const int mt = warp + 8 * m;
      if (mt >= mtiles) continue;
#pragma unroll
      for (int nt = 0; nt < NTL; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = mt * 16 + (lane >> 2) + ((e >> 1) << 3);
          const int row = nt * 8 + 2 * (lane & 3) + (e & 1);
          if (col >= ncols || tile0 + row >= n) continue;
          if (sg.part < 0)
            out[(static_cast<size_t>(ex) * n + tile0 + row) * d + c0 + col] =
                from_f<T>(acc[m][nt][e]);
          else
            partial[(static_cast<size_t>(sg.part) * min(NT, n) + row) * d + c0 + col] =
                acc[m][nt][e];
        }
    }
  }
  cluster.sync();                         // no block leaves while peers read it
}

// The leftover items' rows in this launch's column group: the sum of
// their parts' float32 partials, in part order, rounded once.
template <typename T>
__global__ void mlp_fixup_kernel(const float* __restrict__ partial,
                                 T* __restrict__ out, int n, int d, TcPlan p) {
  const int rows = min(p.nt, n);         // rows of a partial
  const int gw = p.gend - p.col0;        // columns of the group
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<size_t>(p.leftover) * rows * gw) return;
  const int col = p.col0 + static_cast<int>(idx % gw);
  const int row = static_cast<int>(idx / gw % rows);
  const int l = static_cast<int>(idx / gw / rows);
  const int item = p.rounds * p.clusters + l;
  const int tok = item % p.tiles * p.nt + row;
  if (tok >= n) return;
  float s = 0.f;
  for (int q = 0; q < p.parts; ++q)
    s += partial[(static_cast<size_t>(l * p.parts + q) * rows + row) * d + col];
  out[(static_cast<size_t>(item / p.tiles) * n + tok) * d + col] = from_f<T>(s);
}

// cuTensorMapEncodeTiled from the driver, found once through the runtime
// (no link against libcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &q) !=
            cudaSuccess || q != cudaDriverEntryPointSuccess)
      ptr = nullptr;
    return reinterpret_cast<EncodeTiled>(ptr);
  }();
  return fn;
}

// a 16-bit (cols, rows, experts) map of T, boxes of 64 columns x box_rows
// rows
template <typename T>
inline bool tc_map(CUtensorMap* m, const void* base, int cols, int rows,
                   int experts, int box_rows) {
  EncodeTiled enc = encode_tiled();
  if (!enc) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(experts)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(cols) * 2,
                                 static_cast<cuuint64_t>(cols) * rows * 2};
  const cuuint32_t box[3] = {kTcBox, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t one[3] = {1, 1, 1};
  const CUtensorMapDataType type = std::is_same<T, __half>::value
                                       ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  return enc(m, type, 3, const_cast<void*>(base), dims,
             strides, box, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Largest dynamic shared memory set so far on each kernel instantiation,
// by device (opt_in in common.cuh).  Unnamed namespace: fused_mlp and
// moe_mlp each hold their own copy of the kernels and set their own
// attributes.
namespace {
template <typename T, int NT, int MW, bool SW>
int tc_smem_set[kDevices] = {};
}  // namespace

// one launch for each column group of d (p.groups), in order; the float32
// partial of the leftover items is reused from group to group
template <typename T, int NT, int MW, bool SW>
cudaError_t mlp_cluster_launch(const void* x, const void* wg, const void* wi,
                               const void* wo, float* partial, void* out,
                               int experts, int n, int d, int f,
                               const TcPlan& p, cudaStream_t st,
                               int* max_clusters) {
  auto kern = mlp_cluster_kernel<T, NT, MW, SW>;
  // the attributes are set once an instantiation (largest ring so far),
  // with the cluster-size one beside the shared-memory limit
  cudaError_t e = opt_in(kern, tc_smem_set<T, NT, MW, SW>, p.smem, /*cluster=*/true);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.cl * p.clusters);
  cfg.blockDim = dim3(kTcThreads);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (max_clusters) return cudaOccupancyMaxActiveClusters(max_clusters, kern, &cfg);
  CUtensorMap tx, tg, ti, to;
  if (!tc_map<T>(&tx, x, d, n, experts, NT) || !tc_map<T>(&ti, wi, f, d, experts, p.bk) ||
      !tc_map<T>(&tg, SW ? wg : wi, f, d, experts, p.bk) ||
      !tc_map<T>(&to, wo, d, f, experts, kTcHB))
    return cudaErrorInvalidValue;
  TcPlan pg = p;
  for (int g = 0; g < p.groups; ++g) {
    pg.col0 = g * p.gcols;
    pg.gend = pg.col0 + p.gcols < d ? pg.col0 + p.gcols : d;
    e = cudaLaunchKernelEx(&cfg, kern, tx, tg, ti, to, static_cast<T*>(out), partial, n, d,
                           f, pg);
    if (e != cudaSuccess) return e;
    if (p.leftover == 0) continue;
    const size_t total =
        static_cast<size_t>(p.leftover) * (p.nt < n ? p.nt : n) * (pg.gend - pg.col0);
    mlp_fixup_kernel<T><<<static_cast<unsigned>((total + 255) / 256), 256, 0, st>>>(
        partial, static_cast<T*>(out), n, d, pg);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

// token tiles: 8-128 with one m16 tile a warp, up to 96 with two, up to 64
// with three (the float32 sums of both projections stay in registers)
template <typename T, bool SW>
cudaError_t mlp_cluster_by_shape(const void* x, const void* wg, const void* wi,
                                 const void* wo, float* partial, void* out,
                                 int experts, int n, int d, int f,
                                 const TcPlan& p, cudaStream_t st,
                                 int* max_clusters = nullptr) {
#define MZ_TC(NT_, MW_)                                                      \
  if (p.nt == NT_ && p.mw == MW_)                                            \
    return mlp_cluster_launch<T, NT_, MW_, SW>(x, wg, wi, wo, partial, out,  \
                                            experts, n, d, f, p, st,         \
                                            max_clusters);
  MZ_TC(8, 1) MZ_TC(16, 1) MZ_TC(32, 1) MZ_TC(64, 1) MZ_TC(96, 1) MZ_TC(128, 1)
  MZ_TC(8, 2) MZ_TC(16, 2) MZ_TC(32, 2) MZ_TC(64, 2) MZ_TC(96, 2)
  MZ_TC(8, 3) MZ_TC(16, 3) MZ_TC(32, 3) MZ_TC(64, 3)
#undef MZ_TC
  return cudaErrorInvalidValue;
}

// The entry both libraries export.  dtype 0 = float32 takes the FMA tile
// with ff chunks of fc; dtype 1 = bfloat16 and 2 = float16 take the cluster
// tile with the plan's cluster size cl, token tile nt and cluster count,
// one launch a column group of d.  partial: float32 workspace, E *
// ceil(F/fc) * n * d values for float32, leftover * parts * min(nt, n) * d
// for the cluster tile (none when nothing is left over).
inline int mlp_entry(const void* x, const void* wg, const void* wi,
                     const void* wo, void* partial, void* out, int experts,
                     int n, int d, int f, int fc, int swiglu, int dtype, int cl,
                     int nt, int clusters, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(partial);
  if (experts < 1 || n < 1 || d < 1 || f < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e;
  if (dtype == 0) {
    e = swiglu ? mlp_by_d<float, true>(x, wg, wi, wo, w, out, experts, n, d, f, fc, st)
               : mlp_by_d<float, false>(x, wg, wi, wo, w, out, experts, n, d, f, fc, st);
  } else {
    TcPlan p;
    if (tc_plan(experts, n, d, f, cl, nt, clusters, swiglu != 0, &p) != 0 ||
        (p.leftover > 0 && !w))
      return static_cast<int>(cudaErrorInvalidValue);
    e = by_dtype16(dtype, [&](auto t) {
      using T = decltype(t);
      return swiglu
          ? mlp_cluster_by_shape<T, true>(x, wg, wi, wo, w, out, experts, n, d, f, p, st)
          : mlp_cluster_by_shape<T, false>(x, wg, wi, wo, w, out, experts, n, d, f, p, st);
    });
  }
  return static_cast<int>(e);
}

// How many clusters of the cluster tile's kernel for these shapes (cl
// blocks of nt tokens) fit on the card at once
// (cudaOccupancyMaxActiveClusters, asked of the bfloat16 instantiation: the
// float16 one has the same block, ring and shared memory); minus the CUDA
// error code where the query fails or the route refuses the shapes.
inline int mlp_max_clusters(int experts, int n, int d, int f, int swiglu,
                            int cl, int nt) {
  TcPlan p;
  if (tc_plan(experts, n, d, f, cl, nt, 1, swiglu != 0, &p) != 0)
    return -static_cast<int>(cudaErrorInvalidValue);
  int count = -1;
  cudaError_t e = swiglu
      ? mlp_cluster_by_shape<__nv_bfloat16, true>(nullptr, nullptr, nullptr, nullptr,
                                                  nullptr, nullptr, experts, n, d, f, p, 0,
                                                  &count)
      : mlp_cluster_by_shape<__nv_bfloat16, false>(nullptr, nullptr, nullptr, nullptr,
                                                   nullptr, nullptr, experts, n, d, f, p, 0,
                                                   &count);
  return e == cudaSuccess ? count : -static_cast<int>(e);
}

}  // namespace mz

// RG-LRU diagonal linear recurrence for Hopper (sm_90a).
//
// Replaces the TPU kernel rglru_scan_pallas
// (src/repro/kernels/rglru_scan/kernel.py:39):
//     h_t = a_t * h_{t-1} + b_t     elementwise over the channel axis,
// from h0, in float32; a and b float32, bfloat16 or float16, h in a's type
// (h0 float32 or a's type).  The Pallas kernel walks time blocks in order
// and keeps h in VMEM scratch between them.
//
// What bounds it on the H100: bytes.  a and b are read once and h written
// once: 12 bytes an element in float32, 6 with bfloat16 inputs, for two
// FLOPs.  The recurrence is serial in time, and at recurrentgemma's
// prefill (B 1, W 2560) one thread a (batch, channel) is only 2560
// threads: 10 blocks on a 132-SM card, each a chain of S dependent
// steps.  So time is split, and the carries are chained afterwards:
//   * A block owns a tile of 32 channels (a warp row is one 128-byte line
//     in float32) and, each round, a span of 8 * chunk time steps; warp k
//     takes the k-th chunk.  Each warp stages its chunk's a and b in
//     shared memory with 16-byte cp.async (plain loads where the strides
//     or widths do not allow it): they are read from device memory once.
//   * Pass 1: each warp walks its chunk from h = 0, giving the chunk's
//     summary (A = prod a, H = its last local h).
//   * The blocks of a thread-block cluster (1-8, kernels/_scan_plan.py)
//     take consecutive spans.  Each warp writes its summary into the
//     shared memory of every block of the cluster (distributed shared
//     memory); after one cluster barrier every thread chains the
//     cluster's summaries, in (rank, warp) order, from the round's carry:
//     carry = A * carry + H.  That gives its own warp's carry-in and (past
//     the last) the next round's carry, the same bits in every block.  One
//     launch, no global workspace.  The barrier that frees the summaries
//     again is split: a block arrives once it has read them and waits
//     only after pass 2.
//   * Pass 2: each warp re-runs its chunk from shared memory with its
//     carry-in, writing h.
// Every step, and every link of a chain, is a product and a sum rounded
// apart (__fmul_rn, __fadd_rn), as the plain version computes them:
// inside a chunk the arithmetic is the sequential recurrence's own; only
// the carry at chunk boundaries is reassociated.  The order is fixed by
// the plan, so two launches give the same bits.
//
// Decode (S = 1) takes rglru_step_kernel: one thread a vector of 4
// float32 or 8 bfloat16 channels (16-byte loads) where W and the pointers
// allow, else one channel.
#include <cstdint>

#include <cooperative_groups.h>

#include "common.cuh"
#include "warp_ops.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace mz::warp;

constexpr int kLanes = 32;        // channels a block
constexpr int kWarps = 8;         // warps a block, a chunk of time each
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxChunk = 32;     // time steps a warp a round, at most
constexpr int kStepThreads = 256;
// what the entry point reports it launched (kernels/rglru_scan/kernel.py:KERNELS)
constexpr int kRanStep = 1;        // rglru_step_kernel
constexpr int kRanScan = 2;        // rglru_scan_kernel

__host__ __device__ constexpr int smem_bytes(int chunk, int cs, int elem_bytes) {
  // a and b of the round's tile; every warp's (A, H) of the cluster
  return 2 * kWarps * chunk * kLanes * elem_bytes + 2 * 4 * cs * kWarps * kLanes;
}

__device__ __forceinline__ float step(float a, float h, float b) {
  return __fadd_rn(__fmul_rn(a, h), b);
}

// The two halves of a cluster barrier: arrive (release: this thread's
// earlier shared-memory writes and reads are ordered before it) and wait
// (acquire).  Split, so a block can work between its arrive and its wait.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// grid: one block a (cluster rank, channel tile); blockIdx.x = tile *
// cluster + rank, the tiles batch-major.  T: a, b and h; H: h0.  (A
// minimum of four blocks an SM in the launch bounds: without it ptxas
// took 141 registers, one block an SM, and the grid ran in three waves.)
template <typename T, typename H>
__global__ void __launch_bounds__(kThreads, 4)
rglru_scan_kernel(const T* __restrict__ a, const T* __restrict__ b,
                  const H* __restrict__ h0, T* __restrict__ out, int S, int W,
                  int chunk, long long a_sb, long long a_ss, long long b_sb,
                  long long b_ss, long long h0_sb, int vec) {
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tiles_w = (W + kLanes - 1) / kLanes;
  const int tile = blockIdx.x / cs;
  const int bi = tile / tiles_w, w0 = (tile % tiles_w) * kLanes;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int span = kWarps * chunk;                 // time steps a block a round
  extern __shared__ __align__(16) unsigned char smem[];
  T* as = reinterpret_cast<T*>(smem);              // [span][kLanes]
  T* bs = as + span * kLanes;
  // every warp's (A, H) of the cluster: [cs * kWarps][kLanes] each
  float* sA = reinterpret_cast<float*>(bs + span * kLanes);
  float* sH = sA + cs * kWarps * kLanes;

  const int w = w0 + lane;
  const bool live = w < W;
  const T* ab = a + bi * a_sb + w0;
  const T* bb = b + bi * b_sb + w0;
  T* ob = out + static_cast<long long>(bi) * S * W + w0;
  float carry = live ? mz::to_f(h0[bi * h0_sb + w]) : 0.f;
  const int rounds = (S + cs * span - 1) / (cs * span);
  // this warp's rows of the tile: it alone stages and reads them
  T* ar = as + warp * chunk * kLanes;
  T* br = bs + warp * chunk * kLanes;

  for (int r = 0; r < rounds; ++r) {
    const int tw = (r * cs + rank) * span + warp * chunk;   // this warp's first step
    // stage a and b of steps tw .. tw + chunk - 1 (zeros past S and W)
    if (vec) {
      constexpr int EPC = 16 / sizeof(T);          // elements a 16-byte copy
      constexpr int CPR = kLanes / EPC;            // copies a row
      for (int e = lane; e < chunk * CPR; e += 32) {
        const int row = e / CPR, c = (e % CPR) * EPC, t = tw + row;
        const bool ok = t < S && w0 + c < W;
        cp_async16(smem_addr(ar + row * kLanes + c), ok ? ab + t * a_ss + c : a, ok);
        cp_async16(smem_addr(br + row * kLanes + c), ok ? bb + t * b_ss + c : b, ok);
      }
      cp_commit();
      cp_wait<0>();
    } else {
      for (int e = lane; e < chunk * kLanes; e += 32) {
        const int row = e / kLanes, c = e % kLanes, t = tw + row;
        const bool ok = t < S && w0 + c < W;
        ar[e] = ok ? ab[t * a_ss + c] : mz::from_f<T>(0.f);
        br[e] = ok ? bb[t * b_ss + c] : mz::from_f<T>(0.f);
      }
    }
    __syncwarp();

    // pass 1: this warp's chunk from h = 0
    float A = 1.f, Hl = 0.f;
#pragma unroll 8
    for (int i = 0; i < chunk; ++i) {
      const float av = mz::to_f(ar[i * kLanes + lane]);
      A = __fmul_rn(A, av);
      Hl = step(av, Hl, mz::to_f(br[i * kLanes + lane]));
    }
    // publish (A, H) to every block of the cluster, itself included, in
    // slot rank * kWarps + warp (remote stores through distributed shared
    // memory; the barrier's release / acquire makes them visible)
    const int me = rank * kWarps + warp;
    for (int q = 0; q < cs; ++q) {
      cluster.map_shared_rank(sA, q)[me * kLanes + lane] = A;
      cluster.map_shared_rank(sH, q)[me * kLanes + lane] = Hl;
    }
    cluster_arrive();
    cluster_wait();                                // every warp's summary is in

    // chain the cluster's warp summaries in order from the round's carry:
    // this warp's carry-in, and past the last the next round's carry
    float c = carry, mine = carry;
    for (int j0 = 0; j0 < cs * kWarps; j0 += kWarps) {   // a block's worth at a time:
      float pa[kWarps], ph[kWarps];                      // its loads first, then the links
#pragma unroll
      for (int u = 0; u < kWarps; ++u) {
        pa[u] = sA[(j0 + u) * kLanes + lane];
        ph[u] = sH[(j0 + u) * kLanes + lane];
      }
#pragma unroll
      for (int u = 0; u < kWarps; ++u) {
        if (j0 + u == me) mine = c;
        c = step(pa[u], c, ph[u]);
      }
    }
    carry = c;
    // done with the summaries; the wait below (after pass 2) lets the
    // peers write the next round's, and the block leave
    cluster_arrive();

    // pass 2: the chunk again, from the true carry
    float h = mine;
#pragma unroll 8
    for (int i = 0; i < chunk; ++i) {
      h = step(mz::to_f(ar[i * kLanes + lane]), h, mz::to_f(br[i * kLanes + lane]));
      if (live && tw + i < S) ob[static_cast<long long>(tw + i) * W + lane] = mz::from_f<T>(h);
    }
    __syncwarp();                                  // the next round restages this warp's rows
    cluster_wait();
  }
}

// V values of U at p as float32, in aligned accesses of at most 16 bytes
template <typename U, int V>
__device__ __forceinline__ void load_vec(const U* __restrict__ p, float (&f)[V]) {
  constexpr int N = V * sizeof(U) <= 16 ? V : 16 / static_cast<int>(sizeof(U));
  struct alignas(sizeof(U) * N) Piece { U v[N]; };
#pragma unroll
  for (int i = 0; i < V / N; ++i) {
    const Piece pc = reinterpret_cast<const Piece*>(p)[i];
#pragma unroll
    for (int j = 0; j < N; ++j) f[i * N + j] = mz::to_f(pc.v[j]);
  }
}

// S = 1: h = a * h0 + b, V channels a thread; grid: `cb` blocks a batch
// row, batch-major
template <typename T, typename H, int V>
__global__ void __launch_bounds__(kStepThreads)
rglru_step_kernel(const T* __restrict__ a, const T* __restrict__ b,
                  const H* __restrict__ h0, T* __restrict__ out, int W, int cb,
                  long long a_sb, long long b_sb, long long h0_sb) {
  const int bi = blockIdx.x / cb;
  const int w = ((blockIdx.x % cb) * kStepThreads + threadIdx.x) * V;
  if (w >= W) return;
  float av[V], bv[V], hv[V];
  load_vec<T, V>(a + bi * a_sb + w, av);
  load_vec<T, V>(b + bi * b_sb + w, bv);
  load_vec<H, V>(h0 + bi * h0_sb + w, hv);
  constexpr int N = V * sizeof(T) <= 16 ? V : 16 / static_cast<int>(sizeof(T));
  struct alignas(sizeof(T) * N) Piece { T v[N]; };
  Piece* op = reinterpret_cast<Piece*>(out + static_cast<long long>(bi) * W + w);
#pragma unroll
  for (int i = 0; i < V / N; ++i) {
    Piece pc;
#pragma unroll
    for (int j = 0; j < N; ++j) pc.v[j] = mz::from_f<T>(step(av[i * N + j], hv[i * N + j], bv[i * N + j]));
    op[i] = pc;
  }
}

template <typename T, typename H>
int scan_smem_set[mz::kDevices] = {};

cudaLaunchConfig_t scan_config(int blocks, int cs, int smem, cudaStream_t st,
                               cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T, typename H>
cudaError_t launch(const void* a, const void* b, const void* h0, void* out, int B,
                   int S, int W, long long a_sb, long long a_ss, long long b_sb,
                   long long b_ss, long long h0_sb, int cs, int chunk,
                   cudaStream_t st, int* max_clusters, int* ran) {
  const T* ap = static_cast<const T*>(a);
  const T* bp = static_cast<const T*>(b);
  const H* hp = static_cast<const H*>(h0);
  T* op = static_cast<T*>(out);
  if (S == 1 && !max_clusters) {
    constexpr int V = 16 / sizeof(T);
    const bool vec = W % V == 0 && a_sb % V == 0 && b_sb % V == 0 && h0_sb % V == 0 &&
                     aligned16(a) && aligned16(b) && aligned16(h0) && aligned16(out);
    const int cb = ((vec ? W / V : W) + kStepThreads - 1) / kStepThreads;
    if (static_cast<long long>(cb) * B > 0x7fffffffLL) return cudaErrorInvalidValue;
    if (vec)
      rglru_step_kernel<T, H, V><<<cb * B, kStepThreads, 0, st>>>(ap, bp, hp, op, W, cb,
                                                                  a_sb, b_sb, h0_sb);
    else
      rglru_step_kernel<T, H, 1><<<cb * B, kStepThreads, 0, st>>>(ap, bp, hp, op, W, cb,
                                                                  a_sb, b_sb, h0_sb);
    const cudaError_t le = cudaGetLastError();
    if (le == cudaSuccess && ran) *ran = kRanStep;
    return le;
  }
  if (chunk < 1 || chunk > kMaxChunk || (cs != 1 && cs != 2 && cs != 4 && cs != 8))
    return cudaErrorInvalidValue;
  const long long blocks = static_cast<long long>(B) * ((W + kLanes - 1) / kLanes) * cs;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int smem = smem_bytes(chunk, cs, sizeof(T));
  auto kern = rglru_scan_kernel<T, H>;
  cudaError_t e = mz::opt_in(kern, scan_smem_set<T, H>, smem);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = scan_config(static_cast<int>(blocks), cs, smem, st, attr);
  if (max_clusters) return cudaOccupancyMaxActiveClusters(max_clusters, kern, &cfg);
  constexpr int EPC = 16 / sizeof(T);
  const int vec = W % EPC == 0 && a_sb % EPC == 0 && a_ss % EPC == 0 && b_sb % EPC == 0 &&
                  b_ss % EPC == 0 && aligned16(a) && aligned16(b);
  e = cudaLaunchKernelEx(&cfg, kern, ap, bp, hp, op, S, W, chunk, a_sb, a_ss, b_sb, b_ss,
                         h0_sb, vec);
  if (e != cudaSuccess) return e;
  e = cudaGetLastError();
  if (e == cudaSuccess && ran) *ran = kRanScan;
  return e;
}

// dtype: a, b and out (0 float32, 1 bfloat16, 2 float16); h0_dtype: h0
// (float32 or a's type)
cudaError_t dispatch(const void* a, const void* b, const void* h0, void* out, int B,
                     int S, int W, long long a_sb, long long a_ss, long long b_sb,
                     long long b_ss, long long h0_sb, int cs, int chunk, int dtype,
                     int h0_dtype, cudaStream_t st, int* max_clusters, int* ran) {
  if (B < 1 || S < 1 || W < 1) return cudaErrorInvalidValue;
  return mz::by_dtype(dtype, [&](auto at) {
    using T = decltype(at);
    // h0 in float32 or in a's type
    if (h0_dtype != 0 && h0_dtype != dtype) return cudaErrorInvalidValue;
    if (h0_dtype == 0 || dtype == 0)
      return launch<T, float>(a, b, h0, out, B, S, W, a_sb, a_ss, b_sb, b_ss, h0_sb, cs,
                              chunk, st, max_clusters, ran);
    return launch<T, T>(a, b, h0, out, B, S, W, a_sb, a_ss, b_sb, b_ss, h0_sb, cs, chunk,
                        st, max_clusters, ran);
  });
}

}  // namespace

// a, b: (B, S, W) with unit channel stride and the given batch and time
// strides; h0: (B, W), batch stride h0_sb; out: (B, S, W) contiguous in
// a's type.  cs (blocks a cluster) and chunk (time steps a warp a round)
// are kernels/_scan_plan.py's; S = 1 ignores them.  *ran names the kernel
// launched (kRanStep, kRanScan) and is left alone where nothing launched.
extern "C" int rglru_scan(const void* a, const void* b, const void* h0, void* out,
                          int B, int S, int W, long long a_sb, long long a_ss,
                          long long b_sb, long long b_ss, long long h0_sb, int cs,
                          int chunk, int dtype, int h0_dtype, void* stream, int* ran) {
  return static_cast<int>(dispatch(a, b, h0, out, B, S, W, a_sb, a_ss, b_sb, b_ss,
                                   h0_sb, cs, chunk, dtype, h0_dtype,
                                   static_cast<cudaStream_t>(stream), nullptr, ran));
}

// Clusters of cs blocks (chunk steps a warp) that the card holds at once
// (cudaOccupancyMaxActiveClusters); minus the CUDA error code where the
// query fails.
extern "C" int rglru_scan_max_clusters(int cs, int chunk, int dtype, int h0_dtype) {
  int count = -1;
  const cudaError_t e = dispatch(nullptr, nullptr, nullptr, nullptr, 1, 2, kLanes, 0, 0,
                                 0, 0, 0, cs, chunk, dtype, h0_dtype, nullptr, &count,
                                 nullptr);
  return e == cudaSuccess ? count : -static_cast<int>(e);
}

MZ_ERROR_STRING(rglru_scan)

// Causal GQA flash attention (prefill) for Hopper (sm_90a).
//
// Replaces the TPU kernel flash_attention_bhsd
// (src/repro/kernels/flash_attention/kernel.py:80): softmax(q k^T /
// sqrt(hd)) v with causal, optional sliding-window (kpos > qpos - window)
// and kpos < Sk masking, an online max and sum in float32 and a float32
// accumulator; query head h reads kv head h / (H / Hkv); rows with no valid
// key come out as 0.  q, k and v are read in the model layout (B, S,
// heads, hd) through their strides, so no transpose runs before it.
//
// What bounds it on the H100: operations.  The (Sq, Sk) scores must stay
// off device memory, and the work (4 * hd FLOPs a (q, k) pair inside the
// mask) grows faster than the bytes (q, k, v, o once each): mixtral-8x7b's
// 4352-token prefill is 154 GFLOP against 36 MB.  At smollm-135m's prefill
// buckets (S <= 512) the whole call is a few microseconds, so what counts
// there is the latency of the longest walk over the keys.
//
// bfloat16 and float16 route: flash_tc_kernel, an FA2-style tile on tensor
// cores (mma.sync.m16n8k16, bf16 or fp16 in, float32 sums).  A block serves one query
// head and 16 query positions a warp (4 or 8 warps).  Each warp loads its
// Q fragments once (ldmatrix) and keeps them in registers.  K/V tiles of 64 keys stream through a 3-stage ring of
// shared memory, filled with 16-byte cp.async (zero fill past Sk), the
// next tiles in flight while the current one is computed.  S = Q K^T runs
// on the tensor cores; the scale is folded into an exp2; the mask is
// applied only on tiles that cut the diagonal, the window edge or Sk
// (tile_class; interior tiles skip it, and tiles with no valid pair are
// never loaded: kv_range).  The online max and sum stay in registers with
// quad shuffles along each row; P is rounded to bf16 in registers and fed
// straight back as the A operand of P V, with V through ldmatrix.trans and
// O a float32 sum in registers.  The epilogue normalises by 1 / max(l,
// 1e-30) and stores through shared memory as 16-byte writes.  The heaviest
// causal query tiles are launched first (blockIdx.y runs from the last
// tile down).  No atomics and no split of a row across blocks, so the
// output is bit-identical from launch to launch.  The tile plan (the
// warps a block) is computed by kernels/_attn_plan.py and passed in;
// tile_class and kv_range are mirrored there for the CPU tests.
//
// The rounding this route adds: P is rounded to T before P V, as the
// port's einsum attention does (models/common.py: softmax(...).to(q.dtype)
// before the bf16 P V einsum); the plain version keeps P in float32.
// Inputs must start on 16-byte boundaries with strides that are multiples
// of 8 elements (the wrapper copies them where not).  Head dims 32-256
// (the wrapper zero-pads any other up to 256 to the next); from hd 160 Q
// is re-read from shared memory each key tile instead of held in
// registers, and at hd 256 the ring has 2 stages (3 would not fit a block
// of 8 warps: tc_stages).
//
// float32 route: the first port's FMA kernel (flash_fwd_kernel), kept for
// the float32 end-to-end checks: a block takes one (batch, head) pair and
// 64 queries and walks KV tiles of 32 keys in shared memory, float32 FMAs.
//
// hd > 256, every type: flash_wide_kernel splits the output columns into
// blocks of 256 (a grid dimension).  Each block recomputes the full-hd
// scores in one fixed order, so all of a row's blocks hold the same max
// and sum, and accumulates only its own columns of P V in float32 (P is
// not rounded).  A simple kernel that is right: one key at a time a warp,
// every K row read again by each column block and each query row (from
// L2); its cost against the byte bound is in PERF.md.
#include <cmath>
#include <cstdint>

#include "common.cuh"
#include "warp_ops.cuh"

namespace {

struct Strides {
  long long b, s, h;  // element strides of batch, sequence, head (hd: 1)
};

using mz::kDevices;   // shared-memory opt-in tables, per device (mz::opt_in)
using namespace mz::warp;

// ---------------------------------------------------------------------------
// float32: the FMA kernel of the first port
// ---------------------------------------------------------------------------

constexpr int kBQ = 64;       // queries a block
constexpr int kBK = 32;       // keys a tile
constexpr int kThreads = 128; // two threads a query row

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1)  // without the 1, hd 80 spilled
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int H, int Hkv,
                 int Sq, int Sk, Strides qs, Strides ks, Strides vs, int causal,
                 int window, float scale) {
  // padded strides keep the rows (and the two halves of a V row) that one
  // warp reads at a time on distinct shared-memory banks
  constexpr int QST = HD + 1;
  constexpr int KST = HD + 1;
  constexpr int VST = HD + 1;   // V row: [first half][pad][second half]
  constexpr int PST = kBK + 1;
  constexpr int HALF = HD / 2;
  constexpr int KPT = kBK / 2;  // keys a thread scores per tile
  extern __shared__ float smem[];
  float* Qs = smem;                 // [kBQ][QST]
  float* Ks = Qs + kBQ * QST;       // [kBK][KST]
  float* Vs = Ks + kBK * KST;       // [kBK][VST]
  float* Ps = Vs + kBK * VST;       // [kBQ][PST]

  const int t = threadIdx.x;
  const int r = t >> 1;             // query row within the tile
  const int hh = t & 1;             // which half of keys / of hd
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int q0 = blockIdx.x * kBQ;
  const int qpos = q0 + r;

  const T* qb = q + b * qs.b + h * qs.h;
  for (int e = t; e < kBQ * HD; e += kThreads) {
    const int rr = e / HD, c = e % HD;
    const int p = q0 + rr;
    Qs[rr * QST + c] = p < Sq ? mz::to_f(qb[p * qs.s + c]) : 0.f;
  }
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;

  float m = mz::kNegInf, l = 0.f;
  float acc[HALF];
#pragma unroll
  for (int i = 0; i < HALF; ++i) acc[i] = 0.f;

  int n_tiles = (Sk + kBK - 1) / kBK;
  if (causal) {
    const int last = (q0 + kBQ - 1) / kBK + 1;  // tiles holding kpos <= q0+kBQ-1
    n_tiles = n_tiles < last ? n_tiles : last;
  }
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * kBK;
    if (window > 0 && k0 + kBK - 1 <= q0 - window) continue;  // block-uniform
    __syncthreads();  // previous tile's K/V/P reads are done
    for (int e = t; e < kBK * HD; e += kThreads) {
      const int j = e / HD, c = e % HD;
      const int p = k0 + j;
      Ks[j * KST + c] = p < Sk ? mz::to_f(kb[p * ks.s + c]) : 0.f;
      Vs[j * VST + c + (c >= HALF)] = p < Sk ? mz::to_f(vb[p * vs.s + c]) : 0.f;
    }
    __syncthreads();

    float s[KPT];
#pragma unroll
    for (int j = 0; j < KPT; ++j) s[j] = 0.f;
#pragma unroll 8
    for (int c = 0; c < HD; ++c) {
      const float qv = Qs[r * QST + c];
#pragma unroll
      for (int j = 0; j < KPT; ++j) s[j] += qv * Ks[(hh * KPT + j) * KST + c];
    }
    float mt = mz::kNegInf;
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      const int kpos = k0 + hh * KPT + j;
      bool ok = kpos < Sk;
      if (causal) ok = ok && kpos <= qpos;
      if (window > 0) ok = ok && kpos > qpos - window;
      s[j] = ok ? s[j] * scale : mz::kNegInf;
      mt = fmaxf(mt, s[j]);
    }
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
    const float m_new = fmaxf(m, mt);
    float ls = 0.f;
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      const float p = s[j] <= mz::kNegInf / 2 ? 0.f : expf(s[j] - m_new);
      Ps[r * PST + hh * KPT + j] = p;
      ls += p;
    }
    ls += __shfl_xor_sync(0xffffffffu, ls, 1);
    const float corr = expf(m - m_new);
    l = l * corr + ls;
    m = m_new;
    __syncwarp();  // the row's partner thread wrote half of Ps[r]
#pragma unroll
    for (int i = 0; i < HALF; ++i) acc[i] *= corr;
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      const float p = Ps[r * PST + j];
#pragma unroll
      for (int i = 0; i < HALF; ++i) acc[i] += p * Vs[j * VST + hh * (HALF + 1) + i];
    }
  }
  if (qpos < Sq) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    T* ob = o + ((static_cast<size_t>(b) * Sq + qpos) * H + h) * HD + hh * HALF;
#pragma unroll
    for (int i = 0; i < HALF; ++i) ob[i] = mz::from_f<T>(acc[i] * inv);
  }
}

template <typename T, int HD>
int fma_smem_set[kDevices] = {};

template <typename T, int HD>
cudaError_t launch_fma(const void* q, const void* k, const void* v, void* o,
                       int B, int H, int Hkv, int Sq, int Sk, Strides qs,
                       Strides ks, Strides vs, int causal, int window,
                       float scale, cudaStream_t st) {
  const int smem = static_cast<int>(
      sizeof(float) * (kBQ * (HD + 1) + 2 * kBK * (HD + 1) + kBQ * (kBK + 1)));
  auto kern = flash_fwd_kernel<T, HD>;
  cudaError_t e = mz::opt_in(kern, fma_smem_set<T, HD>, smem);  // above 48 KB (hd >= 80)
  if (e != cudaSuccess) return e;
  const dim3 grid((Sq + kBQ - 1) / kBQ, B * H);
  kern<<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), H, Hkv, Sq, Sk, qs, ks, vs, causal, window, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16 and float16: the tensor-core tile
// ---------------------------------------------------------------------------

constexpr int kTcBK = 64;        // keys a K/V tile
constexpr int kTcStages = 3;     // K/V ring stages where they fit
constexpr int kTcMaxWarps = 8;   // warps a block at most
constexpr int kSmemMax = 232448; // dynamic shared memory a block can opt in to
constexpr float kLog2e = 1.4426950408889634f;

// Classification of a (query tile, key tile) pair, mirrored by
// kernels/_attn_plan.py:tile_class.  Rows >= sq are padding and ignored.
//   0: no (q, k) pair of the tile is valid (the tile is skipped)
//   1: every pair is valid (no mask applied)
//   2: an edge tile: some pair is masked (causal diagonal, window edge or
//      keys past sk), so the mask is applied element by element
__device__ __forceinline__ int tile_class(int q0, int bq, int k0, int bk, int sq,
                                          int sk, int causal, int window) {
  const int q_hi = (q0 + bq < sq ? q0 + bq : sq) - 1;
  const int k_hi = (k0 + bk < sk ? k0 + bk : sk) - 1;
  if (q_hi < q0 || k_hi < k0) return 0;
  // the keys valid for some row of [q0, q_hi] form [q0 - window + 1, q_hi]
  if (causal && k0 > q_hi) return 0;
  if (window > 0 && k_hi <= q0 - window) return 0;
  const bool full = k0 + bk <= sk && (!causal || k0 + bk - 1 <= q0) &&
                    (window <= 0 || k0 > q_hi - window);
  return full ? 1 : 2;
}

// The key tiles [first, last] a query tile walks (last < first: none);
// every tile outside holds no valid pair.  Mirrored by
// kernels/_attn_plan.py:kv_range.
__device__ __forceinline__ void kv_range(int q0, int bq, int sq, int sk, int causal,
                                         int window, int bk, int& first, int& last) {
  const int q_hi = (q0 + bq < sq ? q0 + bq : sq) - 1;
  int k_hi = sk - 1;
  if (causal && q_hi < k_hi) k_hi = q_hi;
  const int k_lo = window > 0 && q0 - window + 1 > 0 ? q0 - window + 1 : 0;
  first = k_lo / bk;
  last = (q_hi < q0 || k_hi < k_lo) ? first - 1 : k_hi / bk;
}

__host__ __device__ constexpr int tc_smem_bytes(int hd, int warps, int stages) {
  return (warps * 16 + stages * 2 * kTcBK) * (hd + 8) * 2;
}

// 3 ring stages where a block of the most warps fits, else 2 (hd 256);
// mirrored by kernels/_attn_plan.py:tc_stages, which passes the count
__host__ __device__ constexpr int tc_stages(int hd) {
  return tc_smem_bytes(hd, kTcMaxWarps, kTcStages) <= kSmemMax ? kTcStages : 2;
}

// grid: x = (b, head), y = query tile, the last (heaviest under a causal
// mask) first; block: one warp for each 16 query positions
template <typename T, int HD>
__global__ void __launch_bounds__(32 * kTcMaxWarps, 1)
flash_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, T* __restrict__ o, int H, int Hkv,
                int Sq, int Sk, Strides qs, Strides ks, Strides vs, int causal,
                int window, float sl2) {
  constexpr int ST = HD + 8;    // shared row stride: ldmatrix rows on distinct banks
  constexpr int CPR = HD / 8;   // 16-byte chunks a row
  constexpr int KSTEPS = HD / 16;
  constexpr int NT = HD / 8;    // 8-wide n tiles of O
  constexpr int SN = kTcBK / 8; // 8-wide n tiles of S
  constexpr int STAGES = tc_stages(HD);
  // Q fragments stay in registers up to hd 128; wider, the accumulator
  // needs them, and Q is read from shared memory (ldmatrix) each key tile
  constexpr bool kQRegs = HD <= 128;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nw = blockDim.x >> 5;
  T* Qs = reinterpret_cast<T*>(smem_raw);   // [nw * 16][ST]; O in the epilogue
  T* Ks = Qs + nw * 16 * ST;                    // [stages][kTcBK][ST]
  T* Vs = Ks + STAGES * kTcBK * ST;             // [stages][kTcBK][ST]

  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int h = blockIdx.x % H, b = blockIdx.x / H;
  const int hk = h / (H / Hkv);
  const int bq = 16 * nw;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * bq;
  const int wq0 = q0 + w * 16;             // this warp's first position

  // stage Q: rows w*16 .. w*16+15 of Qs are warp w's
  for (int e = tid; e < nw * 16 * CPR; e += blockDim.x) {
    const int r = e / CPR, ch = e % CPR, pos = q0 + r;
    const bool ok = pos < Sq;
    const T* src = ok ? q + b * qs.b + pos * qs.s + h * qs.h + ch * 8 : q;
    cp_async16(smem_addr(Qs + r * ST + ch * 8), src, ok);
  }
  int first, last;
  kv_range(q0, bq, Sq, Sk, causal, window, kTcBK, first, last);
  const int n_tiles = last - first + 1;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;
  auto load_kv = [&](int tile, int stage) {
    const int k0 = tile * kTcBK;
    T* kd = Ks + stage * kTcBK * ST;
    T* vd = Vs + stage * kTcBK * ST;
    for (int e = tid; e < kTcBK * CPR; e += blockDim.x) {
      const int j = e / CPR, ch = e % CPR, pos = k0 + j;
      const bool ok = pos < Sk;
      cp_async16(smem_addr(kd + j * ST + ch * 8), ok ? kb + pos * ks.s + ch * 8 : k, ok);
      cp_async16(smem_addr(vd + j * ST + ch * 8), ok ? vb + pos * vs.s + ch * 8 : v, ok);
    }
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {      // Q rides in the first group
    if (s < n_tiles) load_kv(first + s, s);
    cp_commit();
  }

  const int r4 = lane >> 2, c4 = (lane & 3) * 2;   // this lane's row and column pair
  // ldmatrix row addresses: Q as the A operand (x4: rows 0-7 / 8-15, k lo /
  // hi); K as B (x4: two n tiles of keys, k lo / hi); V as B, transposed
  // (x4: keys lo / hi, two n tiles of hd)
  const uint32_t q_addr = smem_addr(
      Qs + (w * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * ST + (lane >> 4) * 8);
  const int k_off = ((lane & 7) + (lane >> 4) * 8) * ST + ((lane >> 3) & 1) * 8;
  const int v_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * ST + (lane >> 4) * 8;

  uint32_t qf[kQRegs ? KSTEPS : 1][4];
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;   // running max of rows r4, r4 + 8 (raw scores)
  float l0 = 0.f, l1 = 0.f;               // this lane's part of the running sums

  for (int it = 0; it < n_tiles; ++it) {
    cp_wait<STAGES - 2>();
    __syncthreads();   // tile `it` is in; every warp is done with tile it - 1
    if constexpr (kQRegs) {
      if (it == 0) {
#pragma unroll
        for (int kk = 0; kk < KSTEPS; ++kk) ldsm_x4(qf[kk], q_addr + kk * 32);
      }
    }
    {
      const int nx = it + STAGES - 1;      // into the stage tile it - 1 used
      if (nx < n_tiles) load_kv(first + nx, nx % STAGES);
      cp_commit();
    }
    const int k0 = (first + it) * kTcBK;
    const int cls = tile_class(wq0, 16, k0, kTcBK, Sq, Sk, causal, window);
    if (cls == 0) continue;   // warp-uniform: none of this warp's pairs is valid
    const int stage = it % STAGES;
    const uint32_t kbase = smem_addr(Ks + stage * kTcBK * ST + k_off);
    const uint32_t vbase = smem_addr(Vs + stage * kTcBK * ST + v_off);

    float s[SN][4];
#pragma unroll
    for (int j = 0; j < SN; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      uint32_t qa[4];
      if constexpr (kQRegs) {
        qa[0] = qf[kk][0]; qa[1] = qf[kk][1]; qa[2] = qf[kk][2]; qa[3] = qf[kk][3];
      } else {
        ldsm_x4(qa, q_addr + kk * 32);
      }
#pragma unroll
      for (int jp = 0; jp < SN / 2; ++jp) {
        uint32_t bb[4];
        ldsm_x4(bb, kbase + (jp * 16 * ST + kk * 16) * 2);
        mz::mma16<T>(s[2 * jp], qa, bb[0], bb[1]);
        mz::mma16<T>(s[2 * jp + 1], qa, bb[2], bb[3]);
      }
    }
    if (cls == 2) {
#pragma unroll
      for (int j = 0; j < SN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qp = wq0 + r4 + (e >> 1) * 8;
          const int kp = k0 + j * 8 + c4 + (e & 1);
          bool ok = kp < Sk;
          if (causal) ok = ok && kp <= qp;
          if (window > 0) ok = ok && kp > qp - window;
          if (!ok) s[j][e] = -INFINITY;
        }
    }
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < SN; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    // a row with no valid key so far keeps max -inf: use 0 so that
    // exp2(-inf - 0) = 0 instead of NaN
    const float ms0 = mx0 == -INFINITY ? 0.f : mx0 * sl2;
    const float ms1 = mx1 == -INFINITY ? 0.f : mx1 * sl2;
    const float cr0 = exp2f(m0 * sl2 - ms0), cr1 = exp2f(m1 * sl2 - ms1);
    m0 = mx0;
    m1 = mx1;
    l0 *= cr0;
    l1 *= cr1;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      acc[n][0] *= cr0;
      acc[n][1] *= cr0;
      acc[n][2] *= cr1;
      acc[n][3] *= cr1;
    }
    // P in registers, rounded to bf16, as the A operand of P V: k step kk
    // takes n tiles 2kk (keys 0-7) and 2kk + 1 (keys 8-15)
    uint32_t pa[SN / 2][4];
#pragma unroll
    for (int j = 0; j < SN; ++j) {
      const float p0 = exp2f(fmaf(s[j][0], sl2, -ms0));
      const float p1 = exp2f(fmaf(s[j][1], sl2, -ms0));
      const float p2 = exp2f(fmaf(s[j][2], sl2, -ms1));
      const float p3 = exp2f(fmaf(s[j][3], sl2, -ms1));
      l0 += p0 + p1;
      l1 += p2 + p3;
      pa[j >> 1][(j & 1) * 2] = mz::pack2<T>(p0, p1);
      pa[j >> 1][(j & 1) * 2 + 1] = mz::pack2<T>(p2, p3);
    }
#pragma unroll
    for (int kk = 0; kk < SN / 2; ++kk) {
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bb[4];
        ldsm_x4_t(bb, vbase + (kk * 16 * ST + np * 16) * 2);
        mz::mma16<T>(acc[2 * np], pa[kk], bb[0], bb[1]);
        mz::mma16<T>(acc[2 * np + 1], pa[kk], bb[2], bb[3]);
      }
    }
  }
  cp_wait<0>();
  __syncthreads();   // Q copies of a block with no key tile have landed; every
                     // warp is done reading Q (its rows become its O below)

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const float i0 = 1.f / fmaxf(l0, 1e-30f), i1 = 1.f / fmaxf(l1, 1e-30f);
  T* Os = Qs + w * 16 * ST;   // this warp's own Q rows, read above
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    *reinterpret_cast<uint32_t*>(Os + r4 * ST + n * 8 + c4) =
        mz::pack2<T>(acc[n][0] * i0, acc[n][1] * i0);
    *reinterpret_cast<uint32_t*>(Os + (r4 + 8) * ST + n * 8 + c4) =
        mz::pack2<T>(acc[n][2] * i1, acc[n][3] * i1);
  }
  __syncwarp();
  for (int e = lane; e < 16 * CPR; e += 32) {
    const int r = e / CPR, ch = e % CPR, pos = wq0 + r;
    if (pos < Sq)
      *reinterpret_cast<uint4*>(o + ((static_cast<size_t>(b) * Sq + pos) * H + h) * HD + ch * 8) =
          *reinterpret_cast<const uint4*>(Os + r * ST + ch * 8);
  }
}

template <typename T, int HD>
int tc_smem_set[kDevices] = {};

template <typename T, int HD>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o, int B,
                      int H, int Hkv, int Sq, int Sk, Strides qs, Strides ks,
                      Strides vs, int causal, int window, float scale, int warps,
                      int stages, cudaStream_t st) {
  constexpr int STAGES = tc_stages(HD);
  if (warps < 1 || warps > kTcMaxWarps || stages != STAGES) return cudaErrorInvalidValue;
  const long long n_q = (Sq + 16LL * warps - 1) / (16LL * warps);
  const long long n_x = static_cast<long long>(B) * H;
  if (n_q > 65535 || n_x > 0x7fffffffLL) return cudaErrorInvalidValue;
  auto kern = flash_tc_kernel<T, HD>;
  // the limit is raised once to the largest block (8 warps) of this head dim
  cudaError_t e = mz::opt_in(kern, tc_smem_set<T, HD>, tc_smem_bytes(HD, kTcMaxWarps, STAGES));
  if (e != cudaSuccess) return e;
  const dim3 grid(static_cast<unsigned>(n_x), static_cast<unsigned>(n_q));
  kern<<<grid, 32 * warps, tc_smem_bytes(HD, warps, STAGES), st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), H, Hkv, Sq, Sk, qs, ks, vs, causal, window, scale * kLog2e);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// hd > 256, any element type: the column-split kernel
// ---------------------------------------------------------------------------

constexpr int kWideRows = 8;     // query rows a block, one a warp
constexpr int kWideCols = 256;   // output columns a block: 8 a lane
constexpr int kWideThreads = 32 * kWideRows;

// grid: x = (b, head), y = a run of 8 query rows, z = a block of 256
// output columns.  Each warp walks its row's valid keys one at a time:
// the full-hd score q . k (its lanes over hd, the xor butterfly: the same
// order in every column block, so every block computes the same m and l)
// and the online softmax in float32, accumulating only its 256 columns of
// P V (8 a lane).  q, scaled by log2(e) / sqrt(hd), sits in shared memory.
template <typename T>
__global__ void __launch_bounds__(kWideThreads, 1)
flash_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ o, int H, int Hkv,
                  int Sq, int Sk, int hd, Strides qs, Strides ks, Strides vs,
                  int causal, int window, float sl2) {
  extern __shared__ float q_s[];              // [kWideRows][hd]
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int h = blockIdx.x % H, b = blockIdx.x / H;
  const int hk = h / (H / Hkv);
  const int q0 = blockIdx.y * kWideRows;
  const int col0 = blockIdx.z * kWideCols;
  for (int e = tid; e < kWideRows * hd; e += kWideThreads) {
    const int r = e / hd, c = e % hd, pos = q0 + r;
    q_s[e] = pos < Sq ? mz::to_f(q[b * qs.b + pos * qs.s + h * qs.h + c]) * sl2 : 0.f;
  }
  __syncthreads();
  const int qpos = q0 + w;
  if (qpos >= Sq) return;
  const float* qr = q_s + w * hd;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;
  int k_hi = Sk - 1;
  if (causal && qpos < k_hi) k_hi = qpos;
  const int k_lo = window > 0 && qpos - window + 1 > 0 ? qpos - window + 1 : 0;
  constexpr int CPL = kWideCols / 32;         // columns a lane
  float acc[CPL];
#pragma unroll
  for (int j = 0; j < CPL; ++j) acc[j] = 0.f;
  float m = -INFINITY, l = 0.f;
  for (int kp = k_lo; kp <= k_hi; ++kp) {
    const T* kr = kb + static_cast<long long>(kp) * ks.s;
    float part = 0.f;
    for (int c = lane; c < hd; c += 32) part = fmaf(qr[c], mz::to_f(kr[c]), part);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
    const float mn = fmaxf(m, part);
    const float corr = exp2f(m - mn), p = exp2f(part - mn);
    m = mn;
    l = l * corr + p;
    const T* vr = vb + static_cast<long long>(kp) * vs.s;
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const int c = col0 + lane + 32 * j;
      const float vv = c < hd ? mz::to_f(vr[c]) : 0.f;
      acc[j] = fmaf(p, vv, acc[j] * corr);
    }
  }
  const float inv = 1.f / fmaxf(l, 1e-30f);
  T* orow = o + ((static_cast<size_t>(b) * Sq + qpos) * H + h) * hd;
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    const int c = col0 + lane + 32 * j;
    if (c < hd) orow[c] = mz::from_f<T>(acc[j] * inv);
  }
}

template <typename T>
int wide_smem_set[kDevices] = {};

template <typename T>
cudaError_t launch_wide(const void* q, const void* k, const void* v, void* o, int B,
                        int H, int Hkv, int Sq, int Sk, int hd, Strides qs, Strides ks,
                        Strides vs, int causal, int window, float scale, int cblocks,
                        cudaStream_t st) {
  const int smem = kWideRows * hd * static_cast<int>(sizeof(float));
  const long long n_q = (Sq + kWideRows - 1) / kWideRows;
  const long long n_x = static_cast<long long>(B) * H;
  if (cblocks != (hd + kWideCols - 1) / kWideCols || n_q > 65535 || n_x > 0x7fffffffLL ||
      cblocks > 65535 || smem > kSmemMax)
    return cudaErrorInvalidValue;
  auto kern = flash_wide_kernel<T>;
  cudaError_t e = mz::opt_in(kern, wide_smem_set<T>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(static_cast<unsigned>(n_x), static_cast<unsigned>(n_q), cblocks);
  kern<<<grid, kWideThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), H, Hkv, Sq, Sk, hd, qs, ks, vs, causal, window, scale * kLog2e);
  return cudaGetLastError();
}

bool tc_aligned(const void* p, Strides s) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s.b % 8 == 0 && s.s % 8 == 0 &&
         s.h % 8 == 0;
}

}  // namespace

// q: (B, Sq, H, hd), k/v: (B, Sk, Hkv, hd), each with unit hd stride and
// the element strides given; o: (B, Sq, H, hd) contiguous.  scale: 1 /
// sqrt(the unpadded hd); window <= 0 means none.  dtype 0 float32, 1
// bfloat16, 2 float16.  hd in {32, 64, 80, 96, 128, 160, 192, 256} (the
// wrapper zero-pads others up to 256): bfloat16 and float16 take the
// tensor-core tile with the warps a block and ring stages of
// kernels/_attn_plan.py, their inputs on 16-byte boundaries with strides in
// multiples of 8; float32 the FMA kernel.  hd > 256, any type: the
// column-split kernel, `cblocks` = ceil(hd / 256) blocks of output columns
// (a grid dimension); `warps` and `stages` are ignored there.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, int B, int H, int Hkv, int Sq, int Sk,
                               int hd, long long q_sb, long long q_ss,
                               long long q_sh, long long k_sb, long long k_ss,
                               long long k_sh, long long v_sb, long long v_ss,
                               long long v_sh, int causal, int window,
                               float scale, int warps, int stages, int cblocks,
                               int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh};
  if (hd > 256)
    return static_cast<int>(mz::by_dtype(dtype, [&](auto t) {
      return launch_wide<decltype(t)>(q, k, v, o, B, H, Hkv, Sq, Sk, hd, qs, ks, vs,
                                      causal, window, scale, cblocks, st);
    }));
  cudaError_t e = cudaErrorInvalidValue;
  if (dtype == 0) {
#define MZ_FMA(HD) launch_fma<float, HD>(q, k, v, o, B, H, Hkv, Sq, Sk, qs, ks, vs, causal, window, scale, st)
    switch (hd) {
      case 32: e = MZ_FMA(32); break;
      case 64: e = MZ_FMA(64); break;
      case 80: e = MZ_FMA(80); break;
      case 96: e = MZ_FMA(96); break;
      case 128: e = MZ_FMA(128); break;
      case 160: e = MZ_FMA(160); break;
      case 192: e = MZ_FMA(192); break;
      case 256: e = MZ_FMA(256); break;
      default: break;
    }
#undef MZ_FMA
    return static_cast<int>(e);
  }
  if (!tc_aligned(q, qs) || !tc_aligned(k, ks) || !tc_aligned(v, vs) ||
      reinterpret_cast<uintptr_t>(o) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  e = mz::by_dtype16(dtype, [&](auto t) {
    using T = decltype(t);
#define MZ_TC(HD) launch_tc<T, HD>(q, k, v, o, B, H, Hkv, Sq, Sk, qs, ks, vs, causal, window, scale, warps, stages, st)
    switch (hd) {
      case 32: return MZ_TC(32);
      case 64: return MZ_TC(64);
      case 80: return MZ_TC(80);
      case 96: return MZ_TC(96);
      case 128: return MZ_TC(128);
      case 160: return MZ_TC(160);
      case 192: return MZ_TC(192);
      case 256: return MZ_TC(256);
      default: return cudaErrorInvalidValue;
    }
#undef MZ_TC
  });
  return static_cast<int>(e);
}

MZ_ERROR_STRING(flash_attention)

// Causal GQA flash attention (prefill) for Hopper (sm_90a).
//
// Replaces the TPU kernel flash_attention_bhsd
// (src/repro/kernels/flash_attention/kernel.py): softmax(q k^T / sqrt(hd))
// v with causal, optional sliding-window and kpos < Sk masking by -1e30,
// an online max and sum in float32 and a float32 accumulator; query head h
// reads kv head h / (H / Hkv); rows with no valid key come out as 0.
//
// What bounds it on the H100: at the serving path's prefill lengths
// (Sq = Sk <= 512, hd 64) it is small either way; the (Sq, Sk) score matrix
// is what must stay off device memory, and the work (4*Sq*Sk*hd/2 FLOPs
// causal) grows faster than the bytes (q, k, v, o once each).  A block
// takes one (batch, head) pair and 64 queries and walks the KV tiles of 32
// keys in order, so scores, probabilities, max and sum live in shared
// memory and registers only.  KV tiles wholly past the causal diagonal are
// never loaded; tiles wholly outside the window are skipped.  The kernel
// reads q, k and v in the model layout (B, S, heads, hd) through their
// strides, so no transpose runs before it.  Products are float32 FMAs from
// shared memory; tensor cores are later work.
#include "common.cuh"

namespace {

constexpr int kBQ = 64;       // queries a block
constexpr int kBK = 32;       // keys a tile
constexpr int kThreads = 128; // two threads a query row

struct Strides {
  long long b, s, h;  // element strides of batch, sequence, head (hd: 1)
};

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
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
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B,
                   int H, int Hkv, int Sq, int Sk, Strides qs, Strides ks,
                   Strides vs, int causal, int window, float scale,
                   cudaStream_t st) {
  const size_t smem =
      sizeof(float) * (kBQ * (HD + 1) + 2 * kBK * (HD + 1) + kBQ * (kBK + 1));
  auto kern = flash_fwd_kernel<T, HD>;
  static bool opted_in = false;  // above 48 KB needs the opt-in (hd 128)
  if (!opted_in) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    opted_in = true;
  }
  const dim3 grid((Sq + kBQ - 1) / kBQ, B * H);
  kern<<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), H, Hkv, Sq, Sk, qs, ks, vs, causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t by_hd(int hd, const void* q, const void* k, const void* v, void* o,
                  int B, int H, int Hkv, int Sq, int Sk, Strides qs, Strides ks,
                  Strides vs, int causal, int window, float scale, cudaStream_t st) {
  if (hd == 32) return launch<T, 32>(q, k, v, o, B, H, Hkv, Sq, Sk, qs, ks, vs, causal, window, scale, st);
  if (hd == 64) return launch<T, 64>(q, k, v, o, B, H, Hkv, Sq, Sk, qs, ks, vs, causal, window, scale, st);
  if (hd == 128) return launch<T, 128>(q, k, v, o, B, H, Hkv, Sq, Sk, qs, ks, vs, causal, window, scale, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// q: (B, Sq, H, hd), k/v: (B, Sk, Hkv, hd), each with unit hd stride and
// the element strides given; o: (B, Sq, H, hd) contiguous.  hd in
// {32, 64, 128}; window <= 0 means none.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, int B, int H, int Hkv, int Sq, int Sk,
                               int hd, long long q_sb, long long q_ss,
                               long long q_sh, long long k_sb, long long k_ss,
                               long long k_sh, long long v_sb, long long v_ss,
                               long long v_sh, int causal, int window,
                               float scale, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh};
  cudaError_t e;
  if (dtype == 0)
    e = by_hd<float>(hd, q, k, v, o, B, H, Hkv, Sq, Sk, qs, ks, vs, causal, window, scale, st);
  else if (dtype == 1)
    e = by_hd<__nv_bfloat16>(hd, q, k, v, o, B, H, Hkv, Sq, Sk, qs, ks, vs, causal, window, scale, st);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}

MZ_ERROR_STRING(flash_attention)

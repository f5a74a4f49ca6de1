// Paged single-token decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel paged_decode_attention_hp
// (src/repro/kernels/flash_attention/kernel.py): one query token a slot
// attends to its K/V through a page table,
//     out[b, h] = softmax(q[b, h] . K[b, :len] / sqrt(hd)) @ V[b, :len]
// where position j of slot b lives at page tables[b, j / ps], offset
// j % ps, and len = lengths[b] counts the current token, whose k/v are
// already in the pool.
//
// What bounds it on the H100: bytes -- each live K/V row is read once and
// every row costs 4*hd FLOPs per query head, a few FLOPs a byte.  The
// design:
//   * one block per (slot, kv head); it serves the `group` query heads
//     that share the kv head, so each K/V row is read once for the group
//     (the TPU grid ran one cell per query head and re-read the pages);
//   * the block walks the slot's live positions in tiles of 32 rows: the
//     loop stands in for the TPU grid's sequential page axis, and the
//     online-softmax state (m, l) sits in shared memory and the output
//     accumulator in registers;
//   * positions at or past len are never loaded: pages past
//     ceil(len / ps) and the null page 0 are never read, and the tail of
//     the last page is masked;
//   * the block reads its own table row (no scalar prefetch on the card);
//   * the pool is read in its stored (P, ps, Hkv, hd) layout, one layer's
//     slice of the (L, P, ps, Hkv, hd) pool, through strides: no copy,
//     no transpose.
// Float32 FMAs throughout; tensor cores are later work.
#include "common.cuh"

namespace {

constexpr int kNT = 128;       // threads a block
constexpr int kTP = 32;        // positions a tile (one per lane in the softmax)
constexpr int kMaxGroup = 16;  // query heads a kv head serves, at most

template <typename T, int HD>
__global__ void __launch_bounds__(kNT)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                    const T* __restrict__ vp, const int* __restrict__ tables,
                    const int* __restrict__ lengths, T* __restrict__ out,
                    int h, int hkv, int ps, int npp, long long q_sb,
                    long long q_sh, long long k_sp, long long k_so,
                    long long k_sh, long long v_sp, long long v_so,
                    long long v_sh, float scale) {
  static_assert(kTP == 32, "the softmax gives each lane one position");
  constexpr int KS = HD + 1;                 // padded K row: no bank conflicts
  constexpr int MAXO = kMaxGroup * HD / kNT; // outputs a thread, at most
  __shared__ float q_s[kMaxGroup * HD];
  __shared__ float k_s[kTP * KS];
  __shared__ float v_s[kTP * HD];
  __shared__ float p_s[kMaxGroup * kTP];     // scores, then probabilities
  __shared__ float m_s[kMaxGroup], l_s[kMaxGroup], corr_s[kMaxGroup];

  const int b = blockIdx.x, g = blockIdx.y, t = threadIdx.x;
  const int group = h / hkv;
  const int len = lengths[b];
  const int* trow = tables + static_cast<size_t>(b) * npp;
  const int nout = group * HD;               // this block's outputs

  for (int e = t; e < nout; e += kNT) {
    const int qi = e / HD, dd = e % HD;
    q_s[e] = mz::to_f(q[b * q_sb + (g * group + qi) * q_sh + dd]) * scale;
  }
  if (t < group) {
    m_s[t] = mz::kNegInf;
    l_s[t] = 0.f;
  }
  float acc[MAXO];
#pragma unroll
  for (int i = 0; i < MAXO; ++i) acc[i] = 0.f;
  __syncthreads();

  for (int j0 = 0; j0 < len; j0 += kTP) {
    // stage K and V rows j0 .. j0+31; rows past len stay zero, unread
    for (int e = t; e < kTP * HD; e += kNT) {
      const int j = e / HD, dd = e % HD, pos = j0 + j;
      float kv = 0.f, vv = 0.f;
      if (pos < len) {
        const long long page = trow[pos / ps], off = pos % ps;
        kv = mz::to_f(kp[page * k_sp + off * k_so + g * k_sh + dd]);
        vv = mz::to_f(vp[page * v_sp + off * v_so + g * v_sh + dd]);
      }
      k_s[j * KS + dd] = kv;
      v_s[j * HD + dd] = vv;
    }
    __syncthreads();
    for (int e = t; e < group * kTP; e += kNT) {
      const int qi = e / kTP, j = e % kTP;
      float s = mz::kNegInf;
      if (j0 + j < len) {
        s = 0.f;
#pragma unroll 16
        for (int dd = 0; dd < HD; ++dd) s += q_s[qi * HD + dd] * k_s[j * KS + dd];
      }
      p_s[e] = s;
    }
    __syncthreads();
    // online softmax, one warp per query head, one lane per position
    const int warp = t >> 5, lane = t & 31;
    for (int qi = warp; qi < group; qi += kNT / 32) {
      const float s = p_s[qi * kTP + lane];
      float mx = s;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[qi];
      const float m_new = fmaxf(m_old, mx);
      const float p = s <= mz::kNegInf / 2 ? 0.f : expf(s - m_new);
      float sum = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      p_s[qi * kTP + lane] = p;
      __syncwarp();
      if (lane == 0) {
        const float c = expf(m_old - m_new);
        corr_s[qi] = c;
        l_s[qi] = l_s[qi] * c + sum;
        m_s[qi] = m_new;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < MAXO; ++i) {
      const int o = t + kNT * i;
      if (o < nout) {
        const int qi = o / HD, dd = o % HD;
        float a = acc[i] * corr_s[qi];
#pragma unroll 8
        for (int j = 0; j < kTP; ++j) a += p_s[qi * kTP + j] * v_s[j * HD + dd];
        acc[i] = a;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < MAXO; ++i) {
    const int o = t + kNT * i;
    if (o < nout) {
      const int qi = o / HD, dd = o % HD;
      const size_t dst = (static_cast<size_t>(b) * h + g * group + qi) * HD + dd;
      out[dst] = mz::from_f<T>(acc[i] / fmaxf(l_s[qi], 1e-30f));
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const int* tables, const int* lengths, void* out, int b,
                   int h, int hkv, int hd, int ps, int npp, long long q_sb,
                   long long q_sh, long long k_sp, long long k_so,
                   long long k_sh, long long v_sp, long long v_so,
                   long long v_sh, float scale, cudaStream_t st) {
  const dim3 grid(b, hkv);
  const T* qp = static_cast<const T*>(q);
  const T* kpp = static_cast<const T*>(kp);
  const T* vpp = static_cast<const T*>(vp);
  T* op = static_cast<T*>(out);
#define MZ_PD(HDV) paged_decode_kernel<T, HDV><<<grid, kNT, 0, st>>>(          \
      qp, kpp, vpp, tables, lengths, op, h, hkv, ps, npp, q_sb, q_sh, k_sp, \
      k_so, k_sh, v_sp, v_so, v_sh, scale)
  if (hd == 32) MZ_PD(32);
  else if (hd == 64) MZ_PD(64);
  else if (hd == 128) MZ_PD(128);
  else return cudaErrorInvalidValue;
#undef MZ_PD
  return cudaGetLastError();
}

}  // namespace

// q: (b, h, hd) with strides q_sb, q_sh (unit stride on hd); k/v pools:
// one layer's (P, ps, hkv, hd) with strides (page, offset, head) and unit
// stride on hd; tables: (b, npp) int32 contiguous; lengths: (b,) int32;
// out: (b, h, hd) contiguous.  h % hkv == 0, h / hkv <= 16, hd in
// {32, 64, 128}.
extern "C" int paged_decode(const void* q, const void* kp, const void* vp,
                            const void* tables, const void* lengths, void* out,
                            int b, int h, int hkv, int hd, int ps, int npp,
                            long long q_sb, long long q_sh, long long k_sp,
                            long long k_so, long long k_sh, long long v_sp,
                            long long v_so, long long v_sh, float scale,
                            int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b < 1 || hkv < 1 || h % hkv || h / hkv > kMaxGroup || ps < 1 || npp < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int* tp = static_cast<const int*>(tables);
  const int* lp = static_cast<const int*>(lengths);
  cudaError_t e;
  if (dtype == 0)
    e = launch<float>(q, kp, vp, tp, lp, out, b, h, hkv, hd, ps, npp, q_sb,
                      q_sh, k_sp, k_so, k_sh, v_sp, v_so, v_sh, scale, st);
  else if (dtype == 1)
    e = launch<__nv_bfloat16>(q, kp, vp, tp, lp, out, b, h, hkv, hd, ps, npp,
                              q_sb, q_sh, k_sp, k_so, k_sh, v_sp, v_so, v_sh,
                              scale, st);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}

MZ_ERROR_STRING(paged_decode)

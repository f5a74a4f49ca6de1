// RWKV6 ("Finch") WKV recurrence for Hopper (sm_90a).
//
// Replaces the TPU kernel wkv6_pallas (src/repro/kernels/wkv6/kernel.py:73).
// Per (batch, head), with key index i < D and value index j < Dv:
//     o_t[j]  = sum_i r_t[i] * (S[i,j] + u[i] * k_t[i] * v_t[j])
//     S[i,j] <- w_t[i] * S[i,j] + k_t[i] * v_t[j],   w_t = exp(logw_t)
// from s0.  Inputs float32, bfloat16 or float16; the math, the state and s_final
// float32; o in the input type (as wkv6_pallas returns it in r's dtype).
// Unlike the Pallas kernel it also returns the final state: the model
// carries it from prefill into decode and from step to step.
//
// What bounds it on the H100: neither bytes nor FLOPs at rwkv6-3b's shapes
// (40 heads of 64) -- the dependence in time does.
//
// S = 1 (decode), wkv6_step_kernel: one block a (batch, head); thread j
// loads column j of the state into registers (all loads in flight) and
// writes s_final's column once.
//
// S > 1, the TPU kernel's closed form over chunks of C = 32 steps, with
// the (D, Dv) state carried from chunk to chunk.  With L the cumulative log
// decay from a chunk's start and Lp_t = L_{t-1} (both <= 0, as logw <= 0):
//   o_t = rq_t S_c + sum_{s <= t} A[t,s] v_s,  rq_t = r_t * exp(Lp_t),
//   A[t,s] = sum_i r_t[i] k_s[i] exp(Lp_t[i] - L_s[i])  (s < t),
//   A[t,t] = sum_i r_t[i] u[i] k_t[i],
//   S_{c+1} = dec * S_c + U,  dec = exp(L_last),
//   U = sum_s (k_s * exp(L_last - L_s)) v_s.
// Only the last line is serial, and it is elementwise.  Three kernels,
// launched by one C call, through a float32 workspace:
//   1. wkv6_prep_kernel, one block a (batch, head, chunk), all chunks at
//      once: rq, dec, A, U and the outputs from inside the chunk, oi = A v.
//   2. wkv6_state_kernel, one thread a state element: the chain S_c over
//      the ceil(S / C) chunks (one FMA a chunk, the loads of eight chunks
//      in flight at once), keeping each S_c, and s_final.
//   3. wkv6_out_kernel, one block a (batch, head, chunk): o = oi + rq S_c.
// The matrix products run from shared memory in register tiles (4 x 4 for
// U, 2 x 4 for oi and o).
// Overflow safety without the (C, C, D) pairwise tensor: the chunk is cut
// into two sub-chunks of 16, and every cumulative sum is kept inside its
// sub-chunk (L_loc, with totals T0, T1), so no exponent is a difference of
// two long sums (decays are kept in base 2 for exp2f).  Inside a sub-chunk
// A is the pairwise form, its 16 x 16 x D decays exp(L_loc[t-1] - L_loc[s])
// taken as running products of w = exp(logw) <= 1 down the rows t > s (no
// exponential a pair).  Across the sub-chunks the decays
// are factored about the earlier sub-chunk's end boundary b = 15: the
// query side gets r_t * exp(Lp_t - L_b) and the key side k_s * exp(L_b -
// L_s), both exponents <= 0.  Nothing overflows; the plain version clips
// exponents at -60, which differs only below e^-60.  Float32 FMA
// throughout (TF32 would not hold 1e-4).  Inputs are read in the model
// layout (B, S, H, D) through their strides.
#include <cstdint>

#include "common.cuh"
#include "warp_ops.cuh"

namespace {

using namespace mz::warp;

constexpr int kStepThreads = 128;   // Dv <= 128
constexpr int kThreads = 256;       // the S > 1 kernels
constexpr int kC = 32;              // chunk length
constexpr int kSub = 16;            // sub-chunk length (two a chunk)
constexpr float kLog2e = 1.4426950408889634f;   // log decays in base 2 (exp2f)

struct Strides {
  long long b, s, h;  // element strides of batch, time, head (D: 1)
};

// ---- S = 1 ---------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kStepThreads)
wkv6_step_kernel(const T* __restrict__ r, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ logw,
                 const float* __restrict__ u, const float* __restrict__ s0,
                 T* __restrict__ o, float* __restrict__ s_out, int H, int Dv,
                 Strides rs, Strides ks, Strides vs, Strides ws,
                 long long u_sb, long long u_sh, long long s0_sb,
                 long long s0_sh) {
  __shared__ __align__(16) float sr[D], sk[D], sw[D], su[D];
  const int bh = blockIdx.x, b = bh / H, h = bh % H, j = threadIdx.x;
  const float* sp = s0 + b * s0_sb + h * s0_sh + j;
  float st[D];                       // column j of the state
#pragma unroll
  for (int i = 0; i < D; ++i) st[i] = sp[i * Dv];
  for (int i = j; i < D; i += blockDim.x) {
    sr[i] = mz::to_f(r[b * rs.b + h * rs.h + i]);
    sk[i] = mz::to_f(k[b * ks.b + h * ks.h + i]);
    sw[i] = expf(mz::to_f(logw[b * ws.b + h * ws.h + i]));
    su[i] = u[b * u_sb + h * u_sh + i];
  }
  const float vj = mz::to_f(v[b * vs.b + h * vs.h + j]);
  __syncthreads();
  float acc[4] = {0.f, 0.f, 0.f, 0.f}, ruk[4] = {0.f, 0.f, 0.f, 0.f};
  float* so = s_out + static_cast<long long>(bh) * D * Dv + j;
#pragma unroll
  for (int i = 0; i < D; i += 4) {
    const float4 r4 = *reinterpret_cast<const float4*>(sr + i);
    const float4 k4 = *reinterpret_cast<const float4*>(sk + i);
    const float4 w4 = *reinterpret_cast<const float4*>(sw + i);
    const float4 u4 = *reinterpret_cast<const float4*>(su + i);
    const float rv[4] = {r4.x, r4.y, r4.z, r4.w}, kv[4] = {k4.x, k4.y, k4.z, k4.w};
    const float wv[4] = {w4.x, w4.y, w4.z, w4.w}, uv[4] = {u4.x, u4.y, u4.z, u4.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      acc[q] = fmaf(rv[q], st[i + q], acc[q]);
      ruk[q] = fmaf(rv[q] * uv[q], kv[q], ruk[q]);
      so[(i + q) * Dv] = fmaf(wv[q], st[i + q], kv[q] * vj);
    }
  }
  o[static_cast<long long>(bh) * Dv + j] = mz::from_f<T>(
      (acc[0] + acc[1]) + (acc[2] + acc[3]) + ((ruk[0] + ruk[1]) + (ruk[2] + ruk[3])) * vj);
}

// ---- S > 1 ---------------------------------------------------------------

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  return fmaf(a.x, b.x, fmaf(a.y, b.y, fmaf(a.z, b.z, fmaf(a.w, b.w, acc))));
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// workspace of a (batch, head, chunk), float32: rq [C][D], U [D][Dv],
// dec [D], oi [C][Dv], st [D][Dv] (the state at the chunk's start)
struct ChunkWs {
  long long rq, u, dec, oi, st, size;
  __host__ __device__ ChunkWs(int D, int Dv)
      : rq(0), u(static_cast<long long>(kC) * D), dec(u + static_cast<long long>(D) * Dv),
        oi(dec + D), st(oi + static_cast<long long>(kC) * Dv),
        size(st + static_cast<long long>(D) * Dv) {}
};

// shared memory of the prep kernel: r, k, L_loc, w, kend [C][D + 4];
// query and key factors [kSub][D + 4]; v [C][Dv + 4]; A [C][C + 1]; u;
// the sub-chunk totals
__host__ __device__ constexpr int prep_smem_floats(int D, int Dv) {
  return (5 * kC + 2 * kSub) * (D + 4) + kC * (Dv + 4) + kC * (kC + 1) + D + 2 * D;
}

// shared memory of the output kernel: rq [C][D + 4], st [D][Dv + 4]
__host__ __device__ constexpr int out_smem_floats(int D, int Dv) {
  return kC * (D + 4) + D * (Dv + 4);
}

// Pass 1, one block a (batch, head, chunk): everything that does not
// depend on the state -- rq, dec, A, the chunk's own state update
// U = kend^T v and its outputs from inside the chunk, oi = A v.
template <typename T>
__global__ void __launch_bounds__(kThreads)
wkv6_prep_kernel(const T* __restrict__ r, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ logw,
                 const float* __restrict__ u, float* __restrict__ wsp, int H,
                 int S, int D, int Dv, Strides rs, Strides ks, Strides vs,
                 Strides ws, long long u_sb, long long u_sh) {
  extern __shared__ __align__(16) float sm[];
  const int DP = D + 4, VP = Dv + 4, AP = kC + 1;
  float* r_s = sm;                     // [C][DP]
  float* k_s = r_s + kC * DP;          // [C][DP]
  float* L_s = k_s + kC * DP;          // [C][DP]: log2 decay, summed inside the sub-chunk
  float* w_s = L_s + kC * DP;          // [C][DP]: the decay w = 2^(log2 decay)
  float* ke_s = w_s + kC * DP;         // [C][DP]: k * exp(L_last - L)
  float* rf_s = ke_s + kC * DP;        // [kSub][DP]: query factors, rows 16..31
  float* kb_s = rf_s + kSub * DP;      // [kSub][DP]: key factors, rows 0..15
  float* v_s = kb_s + kSub * DP;       // [C][VP]
  float* a_s = v_s + kC * VP;          // [C][AP]
  float* u_s = a_s + kC * AP;          // [D]
  float* tot_s = u_s + D;              // [2][D]: T0, T1

  const int tid = threadIdx.x;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int c = blockIdx.y, t0 = c * kC;
  const ChunkWs cw(D, Dv);
  float* wp = wsp + (static_cast<long long>(bh) * gridDim.y + c) * cw.size;

  // thread (sub, i) loads 16 rows of channel i and sums its log decay
  const int sub = tid / D, ci = tid % D;
  if (sub < 2) {
    const T* rb = r + b * rs.b + h * rs.h + ci;
    const T* kb = k + b * ks.b + h * ks.h + ci;
    const T* wb = logw + b * ws.b + h * ws.h + ci;
    float rr[kSub], kk[kSub], ww[kSub];
#pragma unroll
    for (int n = 0; n < kSub; ++n) {
      const long long t = t0 + sub * kSub + n;
      const bool ok = t < S;
      rr[n] = ok ? mz::to_f(rb[t * rs.s]) : 0.f;
      kk[n] = ok ? mz::to_f(kb[t * ks.s]) : 0.f;
      ww[n] = ok ? mz::to_f(wb[t * ws.s]) * kLog2e : 0.f;
    }
    float run = 0.f;
#pragma unroll
    for (int n = 0; n < kSub; ++n) {
      const int row = sub * kSub + n;
      run += ww[n];
      r_s[row * DP + ci] = rr[n];
      k_s[row * DP + ci] = kk[n];
      L_s[row * DP + ci] = run;
      w_s[row * DP + ci] = exp2f(ww[n]);
    }
    tot_s[sub * D + ci] = run;
  }
  for (int i = tid; i < D; i += kThreads) u_s[i] = u[b * u_sb + h * u_sh + i];
  {
    const T* vb = v + b * vs.b + h * vs.h;
    constexpr int NV = kC * 128 / kThreads;   // values a thread, at most
    float vr[NV];
#pragma unroll
    for (int n = 0; n < NV; ++n) {
      const int e = tid + kThreads * n, t = e / Dv, j = e % Dv;
      vr[n] = e < kC * Dv && t0 + t < S
                  ? mz::to_f(vb[static_cast<long long>(t0 + t) * vs.s + j]) : 0.f;
    }
#pragma unroll
    for (int n = 0; n < NV; ++n) {
      const int e = tid + kThreads * n;
      if (e < kC * Dv) v_s[(e / Dv) * VP + e % Dv] = vr[n];
    }
  }
  __syncthreads();

  // rq and the decays of the state; the factors about the boundary b = 15;
  // thread (sub, i) walks its 16 rows of channel i
  float* rq_g = wp + cw.rq;
  if (sub < 2) {
    const float T0 = tot_s[ci], T1 = tot_s[D + ci];
    float lp = 0.f;                      // L_loc of the row before
#pragma unroll 4
    for (int n = 0; n < kSub; ++n) {
      const int t = sub * kSub + n;
      const float l = L_s[t * DP + ci], rv = r_s[t * DP + ci], kv = k_s[t * DP + ci];
      rq_g[t * D + ci] = rv * exp2f(sub ? lp + T0 : lp);
      ke_s[t * DP + ci] = kv * exp2f(sub ? T1 - l : (T0 - l) + T1);
      if (sub) rf_s[n * DP + ci] = rv * exp2f(lp);
      else kb_s[n * DP + ci] = kv * exp2f(T0 - l);
      lp = l;
    }
    if (sub == 0) wp[cw.dec + ci] = exp2f(T0 + T1);
  }
  for (int e = tid; e < kC * kC; e += kThreads)    // A's upper triangle
    if (e % kC > e / kC) a_s[(e / kC) * AP + e % kC] = 0.f;
  // A inside each sub-chunk, the pairwise form: thread (sub, s, i mod 8)
  // carries E = k_s * w_{s+1} ... w_{t-1} down the rows t > s (every
  // factor <= 1: nothing overflows), sums r_t E over its channels, and the
  // 8 lanes of one (sub, s) add their sums (xor butterfly); the diagonal
  // takes the bonus u
  {
    constexpr int IG = kThreads / (2 * kSub);   // channel groups
    const int ig = tid % IG, s = (tid / IG) % kSub, q = tid / (IG * kSub);
    const int row0 = q * kSub;
    float part[kSub], diag = 0.f;
#pragma unroll
    for (int tt = 0; tt < kSub; ++tt) part[tt] = 0.f;
    for (int i = ig; i < D; i += IG) {
      const float kv = k_s[(row0 + s) * DP + i];
      diag = fmaf(r_s[(row0 + s) * DP + i] * u_s[i], kv, diag);
      float e = kv;
#pragma unroll
      for (int tt = 1; tt < kSub; ++tt) {
        if (tt > s) {
          part[tt] = fmaf(r_s[(row0 + tt) * DP + i], e, part[tt]);
          e *= w_s[(row0 + tt) * DP + i];
        }
      }
    }
#pragma unroll
    for (int o = 1; o < IG; o <<= 1) {
      diag += __shfl_xor_sync(0xffffffffu, diag, o);
#pragma unroll
      for (int tt = 1; tt < kSub; ++tt) part[tt] += __shfl_xor_sync(0xffffffffu, part[tt], o);
    }
    if (ig == 0) {
      a_s[(row0 + s) * AP + row0 + s] = diag;
#pragma unroll
      for (int tt = 1; tt < kSub; ++tt)
        if (tt > s) a_s[(row0 + tt) * AP + row0 + s] = part[tt];
    }
  }
  __syncthreads();
  // A of sub-chunk 1's rows against sub-chunk 0's keys: one (t, s) a
  // thread; and U = kend^T v, a 4 x 4 tile a thread
  {
    const int tt = tid / kSub, s = tid % kSub;
    float a0 = 0.f, a1 = 0.f;
    for (int i = 0; i < D; i += 8) {
      a0 = dot4(ld4(rf_s + tt * DP + i), ld4(kb_s + s * DP + i), a0);
      a1 = dot4(ld4(rf_s + tt * DP + i + 4), ld4(kb_s + s * DP + i + 4), a1);
    }
    a_s[(kSub + tt) * AP + s] = a0 + a1;
  }
  float* u_g = wp + cw.u;
  for (int e = tid; e < (D / 4) * (Dv / 4); e += kThreads) {
    const int ib = (e / (Dv / 4)) * 4, jb = (e % (Dv / 4)) * 4;
    float x[4][4] = {};
#pragma unroll 4
    for (int s = 0; s < kC; ++s) {
      const float4 kv = ld4(ke_s + s * DP + ib), vv = ld4(v_s + s * VP + jb);
      const float ka[4] = {kv.x, kv.y, kv.z, kv.w}, va[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q) x[p][q] = fmaf(ka[p], va[q], x[p][q]);
    }
#pragma unroll
    for (int p = 0; p < 4; ++p)
      *reinterpret_cast<float4*>(u_g + (ib + p) * Dv + jb) =
          make_float4(x[p][0], x[p][1], x[p][2], x[p][3]);
  }
  __syncthreads();
  // oi = A v, rows t and t + 16 by four value columns a thread
  float* oi_g = wp + cw.oi;
  for (int e = tid; e < kSub * (Dv / 4); e += kThreads) {
    const int t = e / (Dv / 4), jb = (e % (Dv / 4)) * 4;
    float x0[4] = {}, x1[4] = {};
    for (int s = 0; s <= t + kSub; ++s) {
      const float a0 = a_s[t * AP + s], a1 = a_s[(t + kSub) * AP + s];
      const float4 vv = ld4(v_s + s * VP + jb);
      const float va[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        x0[q] = fmaf(a0, va[q], x0[q]);
        x1[q] = fmaf(a1, va[q], x1[q]);
      }
    }
    *reinterpret_cast<float4*>(oi_g + t * Dv + jb) = make_float4(x0[0], x0[1], x0[2], x0[3]);
    *reinterpret_cast<float4*>(oi_g + (t + kSub) * Dv + jb) =
        make_float4(x1[0], x1[1], x1[2], x1[3]);
  }
}

// Pass 2, the chain: one thread an element (i, j) of one (batch, head)'s
// state, S_{c+1} = dec_c[i] * S_c + U_c[i, j] over the chunks, S_c kept
// for pass 3; the loads of a batch of chunks are in flight before its FMAs
template <int NB>
__global__ void __launch_bounds__(kThreads)
wkv6_state_kernel(const float* __restrict__ wsr, float* __restrict__ wsw,
                  const float* __restrict__ s0, float* __restrict__ s_out,
                  int BH, int H, int D, int Dv, int nc, long long s0_sb,
                  long long s0_sh) {
  const long long e = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const int DD = D * Dv;
  if (e >= static_cast<long long>(BH) * DD) return;
  const int bh = static_cast<int>(e / DD), ij = static_cast<int>(e % DD), i = ij / Dv;
  const int b = bh / H, h = bh % H;
  const ChunkWs cw(D, Dv);
  const long long base = static_cast<long long>(bh) * nc * cw.size;
  float s = s0[b * s0_sb + h * s0_sh + ij];
  for (int c0 = 0; c0 < nc; c0 += NB) {
    float dk[NB], uk[NB];
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      const long long at = base + (c0 + n) * cw.size;
      dk[n] = c0 + n < nc ? wsr[at + cw.dec + i] : 0.f;
      uk[n] = c0 + n < nc ? wsr[at + cw.u + ij] : 0.f;
    }
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      if (c0 + n < nc) {
        wsw[base + (c0 + n) * cw.size + cw.st + ij] = s;
        s = fmaf(dk[n], s, uk[n]);
      }
    }
  }
  s_out[static_cast<long long>(bh) * DD + ij] = s;
}

// Pass 3, one block a (batch, head, chunk): o = oi + rq S_c, rows t and
// t + 16 by four value columns a thread
template <typename T>
__global__ void __launch_bounds__(kThreads)
wkv6_out_kernel(const float* __restrict__ wsp, T* __restrict__ o, int H, int S,
                int D, int Dv) {
  extern __shared__ __align__(16) float sm[];
  const int DP = D + 4, VP = Dv + 4;
  float* rq_s = sm;                    // [C][DP]
  float* st_s = rq_s + kC * DP;        // [D][VP]
  const int tid = threadIdx.x;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int c = blockIdx.y, t0 = c * kC;
  const ChunkWs cw(D, Dv);
  const float* wp = wsp + (static_cast<long long>(bh) * gridDim.y + c) * cw.size;
  for (int e = tid; e < kC * D / 4; e += kThreads) {
    const int t = e / (D / 4), q4 = (e % (D / 4)) * 4;
    cp_async16(smem_addr(rq_s + t * DP + q4), wp + cw.rq + t * D + q4, true);
  }
  for (int e = tid; e < D * Dv / 4; e += kThreads) {
    const int i = e / (Dv / 4), q4 = (e % (Dv / 4)) * 4;
    cp_async16(smem_addr(st_s + i * VP + q4), wp + cw.st + i * Dv + q4, true);
  }
  cp_commit();
  cp_wait<0>();
  __syncthreads();
  T* ob = o + (static_cast<long long>(b) * S * H + h) * Dv;
  for (int e = tid; e < kSub * (Dv / 4); e += kThreads) {
    const int t = e / (Dv / 4), jb = (e % (Dv / 4)) * 4;
    const float4 i0 = ld4(wp + cw.oi + t * Dv + jb), i1 = ld4(wp + cw.oi + (t + kSub) * Dv + jb);
    float x0[4] = {i0.x, i0.y, i0.z, i0.w}, x1[4] = {i1.x, i1.y, i1.z, i1.w};
    for (int i = 0; i < D; i += 4) {
      const float4 r0 = ld4(rq_s + t * DP + i), r1 = ld4(rq_s + (t + kSub) * DP + i);
      const float ra0[4] = {r0.x, r0.y, r0.z, r0.w}, ra1[4] = {r1.x, r1.y, r1.z, r1.w};
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const float4 sv = ld4(st_s + (i + p) * VP + jb);
        const float sa[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          x0[q] = fmaf(ra0[p], sa[q], x0[q]);
          x1[q] = fmaf(ra1[p], sa[q], x1[q]);
        }
      }
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int gt = t0 + t + half * kSub;
      if (gt >= S) continue;
      T* op = ob + static_cast<long long>(gt) * H * Dv + jb;
#pragma unroll
      for (int q = 0; q < 4; ++q) op[q] = mz::from_f<T>(half ? x1[q] : x0[q]);
    }
  }
}

// shared-memory opt-in, per device (mz::opt_in), one table a kernel
template <typename T>
int prep_smem_set[mz::kDevices] = {};
template <typename T>
int out_smem_set[mz::kDevices] = {};

template <typename T>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const void* logw, const void* u, const void* s0, void* o,
                   void* s_out, void* wsp, int B, int S, int H, int D, int Dv,
                   Strides rs, Strides ks, Strides vs, Strides ws,
                   long long u_sb, long long u_sh, long long s0_sb,
                   long long s0_sh, cudaStream_t st) {
  const T* rp = static_cast<const T*>(r);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* wp = static_cast<const T*>(logw);
  const float* up = static_cast<const float*>(u);
  const float* sp = static_cast<const float*>(s0);
  T* op = static_cast<T*>(o);
  float* sop = static_cast<float*>(s_out);
  float* wkp = static_cast<float*>(wsp);
  if (S == 1) {
#define MZ_STEP(DD) wkv6_step_kernel<T, DD><<<B * H, Dv, 0, st>>>(           \
      rp, kp, vp, wp, up, sp, op, sop, H, Dv, rs, ks, vs, ws, u_sb, u_sh,   \
      s0_sb, s0_sh)
    switch (D) {
      case 16: MZ_STEP(16); break;
      case 32: MZ_STEP(32); break;
      case 48: MZ_STEP(48); break;
      case 64: MZ_STEP(64); break;
      case 80: MZ_STEP(80); break;
      case 96: MZ_STEP(96); break;
      case 112: MZ_STEP(112); break;
      case 128: MZ_STEP(128); break;
      default: return cudaErrorInvalidValue;
    }
#undef MZ_STEP
    return cudaGetLastError();
  }
  const int nc = (S + kC - 1) / kC;
  const int prep = prep_smem_floats(D, Dv) * static_cast<int>(sizeof(float));
  const int outb = out_smem_floats(D, Dv) * static_cast<int>(sizeof(float));
  cudaError_t e = mz::opt_in(wkv6_prep_kernel<T>, prep_smem_set<T>, prep);
  if (e == cudaSuccess) e = mz::opt_in(wkv6_out_kernel<T>, out_smem_set<T>, outb);
  if (e != cudaSuccess) return e;
  wkv6_prep_kernel<T><<<dim3(B * H, nc), kThreads, prep, st>>>(
      rp, kp, vp, wp, up, wkp, H, S, D, Dv, rs, ks, vs, ws, u_sb, u_sh);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long long n = static_cast<long long>(B) * H * D * Dv;
  wkv6_state_kernel<8><<<static_cast<unsigned>((n + kThreads - 1) / kThreads), kThreads, 0, st>>>(
      wkp, wkp, sp, sop, B * H, H, D, Dv, nc, s0_sb, s0_sh);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  wkv6_out_kernel<T><<<dim3(B * H, nc), kThreads, outb, st>>>(wkp, op, H, S, D, Dv);
  return cudaGetLastError();
}

}  // namespace

// r, k, logw: (B, S, H, D) and v: (B, S, H, Dv), one dtype (float32,
// bfloat16 or float16), unit stride on the last dim and the given batch, time and
// head strides; u: float32, element (b, h, i) at b*u_sb + h*u_sh + i; s0:
// float32 (B, H, D, Dv) with contiguous (D, Dv) blocks at b*s0_sb +
// h*s0_sh.  o: (B, S, H, Dv) contiguous in the input dtype; s_out: float32
// (B, H, D, Dv) contiguous; ws: float32, B * H * ceil(S / 32) *
// ChunkWs(D, Dv).size (none for S = 1), 16-byte aligned.  D and Dv multiples of 16 up to 128.
extern "C" int wkv6(const void* r, const void* k, const void* v,
                    const void* logw, const void* u, const void* s0, void* o,
                    void* s_out, void* ws, int B, int S, int H, int D, int Dv,
                    long long r_sb, long long r_ss, long long r_sh,
                    long long k_sb, long long k_ss, long long k_sh,
                    long long v_sb, long long v_ss, long long v_sh,
                    long long w_sb, long long w_ss, long long w_sh,
                    long long u_sb, long long u_sh, long long s0_sb,
                    long long s0_sh, int dtype, void* stream) {
  if (B < 1 || S < 1 || H < 1 || D < 16 || D > 128 || D % 16 || Dv < 16 ||
      Dv > 128 || Dv % 16 || (S > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides rs{r_sb, r_ss, r_sh}, ks{k_sb, k_ss, k_sh};
  const Strides vs{v_sb, v_ss, v_sh}, wst{w_sb, w_ss, w_sh};
  const cudaError_t e = mz::by_dtype(dtype, [&](auto t) {
    return launch<decltype(t)>(r, k, v, logw, u, s0, o, s_out, ws, B, S, H, D, Dv, rs,
                               ks, vs, wst, u_sb, u_sh, s0_sb, s0_sh, st);
  });
  return static_cast<int>(e);
}

MZ_ERROR_STRING(wkv6)

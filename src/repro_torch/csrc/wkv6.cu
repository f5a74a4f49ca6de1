// RWKV6 ("Finch") WKV recurrence for Hopper (sm_90a).
//
// Replaces the TPU kernel wkv6_pallas (src/repro/kernels/wkv6/kernel.py).
// Per (batch, head), with key index i and value index j:
//     o_t[j]  = sum_i r_t[i] * (S[i,j] + u[i] * k_t[i] * v_t[j])
//     S[i,j] <- w_t[i] * S[i,j] + k_t[i] * v_t[j],   w_t = exp(logw_t)
// from s0, float32 throughout.  Unlike the Pallas kernel it also returns
// the final state: the model carries it from prefill into decode and from
// one decode step to the next.  The TPU kernel evaluates each chunk in
// closed form on the MXU (pairwise decays exp(Lp[t] - L[s]) clipped to
// [-60, 0]); this kernel runs the recurrence itself, step by step, which is
// exact in float32 and needs no padding: the state after the last real
// step is the final state.
//
// What bounds it on the H100: at the serving shapes (D = Dv = 64, BH = B *
// 40 heads) neither bytes nor FLOPs (4*S*D^2 a head) come near the card's
// limits; the serial dependence in time is what costs.  One block takes
// one (batch, head); thread j owns column j of the 64 x 64 state and keeps
// it in registers for the whole sequence, so the state touches device
// memory twice (s0 in, s_final out).  Each iteration stages kT time steps
// of r, k, v and w (decays exponentiated once, at staging) in shared
// memory with coalesced row loads, then every thread walks them reading
// rows as float4 broadcasts.  The output sum uses four partial sums to
// break the FMA chain.  Inputs are read in the model layout (B, S, H, D)
// through their strides, so no transpose runs before the kernel.
#include "common.cuh"

namespace {

constexpr int kT = 16;  // time steps staged a iteration

struct Strides {
  long long b, s, h;  // element strides of batch, time, head (D: 1)
};

template <int D>
__global__ void __launch_bounds__(D)
wkv6_kernel(const float* __restrict__ r, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ logw,
            const float* __restrict__ u, const float* __restrict__ s0,
            float* __restrict__ o, float* __restrict__ s_out, int H, int S,
            Strides rs, Strides ks, Strides vs, Strides ws, long long u_sb,
            long long u_sh, long long s0_sb, long long s0_sh) {
  __shared__ __align__(16) float sr[kT][D];
  __shared__ __align__(16) float sk[kT][D];
  __shared__ __align__(16) float sw[kT][D];
  __shared__ float sv[kT][D];
  __shared__ __align__(16) float su[D];

  const int j = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;

  float st[D];  // st[i] = S[i, j]
  const float* s0p = s0 + b * s0_sb + h * s0_sh;
#pragma unroll
  for (int i = 0; i < D; ++i) st[i] = s0p[i * D + j];
  su[j] = u[b * u_sb + h * u_sh + j];

  const long long r0 = b * rs.b + h * rs.h + j, k0 = b * ks.b + h * ks.h + j;
  const long long v0 = b * vs.b + h * vs.h + j, w0 = b * ws.b + h * ws.h + j;
  float* op = o + (static_cast<long long>(b) * S * H + h) * D + j;

  for (int t0 = 0; t0 < S; t0 += kT) {
    const int n = min(kT, S - t0);
    __syncthreads();  // the previous rows are consumed
#pragma unroll
    for (int tt = 0; tt < kT; ++tt) {
      if (tt < n) {
        const long long t = t0 + tt;
        sr[tt][j] = r[r0 + t * rs.s];
        sk[tt][j] = k[k0 + t * ks.s];
        sv[tt][j] = v[v0 + t * vs.s];
        sw[tt][j] = expf(logw[w0 + t * ws.s]);
      }
    }
    __syncthreads();
    for (int tt = 0; tt < n; ++tt) {
      const float4* r4 = reinterpret_cast<const float4*>(sr[tt]);
      const float4* k4 = reinterpret_cast<const float4*>(sk[tt]);
      const float4* w4 = reinterpret_cast<const float4*>(sw[tt]);
      const float4* u4 = reinterpret_cast<const float4*>(su);
      const float vj = sv[tt][j];
      float acc0 = 0.f, acc1 = 0.f, acc2 = 0.f, acc3 = 0.f, ruk = 0.f;
#pragma unroll
      for (int q = 0; q < D / 4; ++q) {
        const float4 rq = r4[q], kq = k4[q], wq = w4[q], uq = u4[q];
        const int i = 4 * q;
        acc0 = fmaf(rq.x, st[i], acc0);
        acc1 = fmaf(rq.y, st[i + 1], acc1);
        acc2 = fmaf(rq.z, st[i + 2], acc2);
        acc3 = fmaf(rq.w, st[i + 3], acc3);
        ruk = fmaf(rq.x * uq.x, kq.x, ruk);
        ruk = fmaf(rq.y * uq.y, kq.y, ruk);
        ruk = fmaf(rq.z * uq.z, kq.z, ruk);
        ruk = fmaf(rq.w * uq.w, kq.w, ruk);
        st[i] = fmaf(wq.x, st[i], kq.x * vj);
        st[i + 1] = fmaf(wq.y, st[i + 1], kq.y * vj);
        st[i + 2] = fmaf(wq.z, st[i + 2], kq.z * vj);
        st[i + 3] = fmaf(wq.w, st[i + 3], kq.w * vj);
      }
      op[static_cast<long long>(t0 + tt) * H * D] =
          (acc0 + acc1) + (acc2 + acc3) + ruk * vj;
    }
  }

  float* sp = s_out + static_cast<long long>(bh) * D * D + j;
#pragma unroll
  for (int i = 0; i < D; ++i) sp[i * D] = st[i];
}

}  // namespace

// r, k, v, logw: (B, S, H, D) float32 with unit stride on D and the given
// batch, time and head strides; u: element (b, h, i) at b*u_sb + h*u_sh +
// i; s0: (B, H, D, D) with contiguous (D, D) blocks at b*s0_sb + h*s0_sh.
// o: (B, S, H, D) and s_out: (B, H, D, D), both contiguous.  D in
// {16, 32, 64}.
extern "C" int wkv6(const void* r, const void* k, const void* v,
                    const void* logw, const void* u, const void* s0, void* o,
                    void* s_out, int B, int S, int H, int D, long long r_sb,
                    long long r_ss, long long r_sh, long long k_sb,
                    long long k_ss, long long k_sh, long long v_sb,
                    long long v_ss, long long v_sh, long long w_sb,
                    long long w_ss, long long w_sh, long long u_sb,
                    long long u_sh, long long s0_sb, long long s0_sh,
                    void* stream) {
  if (B < 1 || S < 1 || H < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides rs{r_sb, r_ss, r_sh}, ks{k_sb, k_ss, k_sh};
  const Strides vs{v_sb, v_ss, v_sh}, ws{w_sb, w_ss, w_sh};
  const dim3 grid(B * H);
  const float* rp = static_cast<const float*>(r);
  const float* kp = static_cast<const float*>(k);
  const float* vp = static_cast<const float*>(v);
  const float* wp = static_cast<const float*>(logw);
  const float* up = static_cast<const float*>(u);
  const float* sp = static_cast<const float*>(s0);
  float* opp = static_cast<float*>(o);
  float* sop = static_cast<float*>(s_out);
#define MZ_WKV(DD)                                                          \
  wkv6_kernel<DD><<<grid, DD, 0, st>>>(rp, kp, vp, wp, up, sp, opp, sop, H, \
                                       S, rs, ks, vs, ws, u_sb, u_sh,       \
                                       s0_sb, s0_sh)
  if (D == 16) MZ_WKV(16);
  else if (D == 32) MZ_WKV(32);
  else if (D == 64) MZ_WKV(64);
  else return static_cast<int>(cudaErrorInvalidValue);
#undef MZ_WKV
  return static_cast<int>(cudaGetLastError());
}

MZ_ERROR_STRING(wkv6)

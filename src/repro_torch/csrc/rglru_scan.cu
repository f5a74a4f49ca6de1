// RG-LRU diagonal linear recurrence for Hopper (sm_90a).
//
// Replaces the TPU kernel rglru_scan_pallas
// (src/repro/kernels/rglru_scan/kernel.py):
//     h_t = a_t * h_{t-1} + b_t     elementwise over the channel axis,
// from h0, float32 in and out.  The Pallas kernel walks time blocks in
// order and keeps h in VMEM scratch between them; here the whole time
// loop runs inside one thread, so no block ever waits on another.
//
// What bounds it on the H100: bytes.  a and b are read once and h written
// once (two FLOPs a 12 bytes).  One thread owns one (batch, channel) lane
// and keeps the running h in a register; neighbouring threads take
// neighbouring channels, so every load and store of a warp is one
// coalesced 128-byte line.  The recurrence is serial in time, so a thread
// first issues the loads of kStep steps at once (independent loads in
// flight instead of one latency a step) and then runs the kStep updates
// from registers.  At the serving path's widths (W = 2560) a prefill has
// only B * W threads, too few to hide latency any other way.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // channels a block
constexpr int kStep = 8;       // time steps whose loads go out together

__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  const float* __restrict__ h0, float* __restrict__ out, int S,
                  int W, long long a_sb, long long a_ss, long long b_sb,
                  long long b_ss, long long h0_sb) {
  const int w = blockIdx.x * kThreads + threadIdx.x;
  if (w >= W) return;
  const int bi = blockIdx.y;
  const float* ap = a + bi * a_sb + w;
  const float* bp = b + bi * b_sb + w;
  float* op = out + static_cast<long long>(bi) * S * W + w;
  float h = h0[bi * h0_sb + w];
  for (int t0 = 0; t0 < S; t0 += kStep) {
    float av[kStep], bv[kStep];
#pragma unroll
    for (int u = 0; u < kStep; ++u) {
      const int t = t0 + u;
      av[u] = t < S ? ap[t * a_ss] : 0.f;
      bv[u] = t < S ? bp[t * b_ss] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kStep; ++u) {
      const int t = t0 + u;
      if (t < S) {
        // product and sum rounded apart, as the plain version computes them
        h = __fadd_rn(__fmul_rn(av[u], h), bv[u]);
        op[static_cast<long long>(t) * W] = h;
      }
    }
  }
}

}  // namespace

// a, b: (B, S, W) float32 with unit channel stride and the given batch and
// time strides; h0: (B, W) float32, batch stride h0_sb; out: (B, S, W)
// float32 contiguous.
extern "C" int rglru_scan(const void* a, const void* b, const void* h0,
                          void* out, int B, int S, int W, long long a_sb,
                          long long a_ss, long long b_sb, long long b_ss,
                          long long h0_sb, void* stream) {
  if (B < 1 || S < 1 || W < 1 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((W + kThreads - 1) / kThreads, B), block(kThreads);
  rglru_scan_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(h0), static_cast<float*>(out), S, W, a_sb,
      a_ss, b_sb, b_ss, h0_sb);
  return static_cast<int>(cudaGetLastError());
}

MZ_ERROR_STRING(rglru_scan)

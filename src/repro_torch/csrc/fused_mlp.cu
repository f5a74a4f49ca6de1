// Fused dense gated MLP for Hopper (sm_90a).
//
// Replaces the TPU kernel fused_mlp_pallas
// (src/repro/kernels/fused_mlp/kernel.py:75):
//     out = (silu(x @ wg) * (x @ wi)) @ wo        (swiglu)
//     out = gelu_tanh(x @ wi) @ wo                (no gate; wg never read)
// with float32 accumulation, and the (N, F) hidden activation never
// written to device memory.
//
// What bounds it on the H100: at decode widths (N <= 8) bytes -- the three
// weight matrices (3*d*F values: 5.3 MB at smollm-135m's d 576, F 1536;
// 352 MB at d 4096, F 14336) are read for a handful of tokens; at prefill
// widths (N in the hundreds) still bytes at smollm's width, operations
// only from a few thousand tokens on.
//
// bfloat16 takes the cluster tile of mlp_tile.cuh with one expert: a
// cluster of 8 blocks (16 where d > 1024) walks a token tile of up to 128
// rows over its ff chunks in order, each weight byte read by one block, h
// rounded once to bf16 in shared memory, the float32 sum in registers;
// tensor-core mma.sync products fed by TMA rings.  One expert gives too
// few clusters to fill the card, so its chunks are cut into ranges over up
// to 8 clusters (no more than the card holds at once), each writing one
// float32 partial of its token tile that mlp_fixup_kernel sums in range
// order (at most 8 * n * d floats at smollm's widths: 27.6 KB at decode).
// float32 keeps the first port's FMA tile (float32 partials per ff chunk,
// a second pass, output columns in tiles so any d runs without spilling).
#include "mlp_tile.cuh"

// x: (n, d); wg, wi: (d, f); wo: (f, d); out: (n, d); all contiguous, one
// element type.  float32 (dtype 0): fc (32 or 128) hidden units a block,
// partial of ceil(f/fc)*n*d floats.  bfloat16 (dtype 1) and float16 (2): cluster size cl,
// token tile nt and cluster count from the tile plan
// (kernels/_mlp_plan.py), partial of leftover*parts*min(nt,n)*d floats.
// wg may be null when swiglu is 0.
extern "C" int fused_mlp(const void* x, const void* wg, const void* wi,
                         const void* wo, void* partial, void* out, int n, int d,
                         int f, int fc, int swiglu, int dtype, int cl, int nt,
                         int clusters, void* stream) {
  return mz::mlp_entry(x, wg, wi, wo, partial, out, 1, n, d, f, fc, swiglu,
                       dtype, cl, nt, clusters, stream);
}

MZ_ERROR_STRING(fused_mlp)

// Clusters of the bfloat16 launch that fit on the card at once (minus a
// CUDA error code when the query fails); cl and nt from the tile plan.
extern "C" int fused_mlp_max_clusters(int e, int n, int d, int f, int swiglu,
                                      int cl, int nt) {
  return mz::mlp_max_clusters(e, n, d, f, swiglu, cl, nt);
}

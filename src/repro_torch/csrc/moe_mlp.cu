// Grouped expert MLP over capacity buffers for Hopper (sm_90a).
//
// Replaces the TPU kernel moe_mlp_pallas
// (src/repro/kernels/moe_mlp/kernel.py:54), the MoE hot path:
//     out[e] = (silu(x[e] @ wg[e]) * (x[e] @ wi[e])) @ wo[e]   (swiglu)
//     out[e] = gelu_tanh(x[e] @ wi[e]) @ wo[e]                 (no gate)
// for x (E, C, d) capacity buffers, float32 accumulation, the output
// rounded once to x's type, and the (E, C, F) hidden never in device
// memory.
//
// What bounds it on the H100: bytes.  At mixtral decode (E 8, C 8, d 4096,
// F 14336, bf16) every expert's three weight matrices must be read once,
// 2.82 GB, 0.84 ms at 3.35 TB/s; at a 256-token prefill (C 80) the same
// bytes still outweigh the 225 GFLOP at the bf16 tensor peak (0.23 ms).
//
// bfloat16 takes the cluster tile of mlp_tile.cuh: a cluster of 16 blocks
// an (expert, token tile), one token tile of up to 96 capacity rows, each
// weight byte read from device memory by exactly one block, h (rounded
// once to bf16 for the tensor cores) kept in shared memory and the float32
// sum in registers across the ff walk, products on tensor cores
// (mma.sync m16n8k16, the weights as M, capacity rows as N), weights fed
// by TMA into a deep ring.  The H100 holds 7 clusters of 16 at once, not
// the 8 that mixtral's experts ask for, so each of 7 clusters walks one
// expert and a seventh of the eighth, whose 7 float32 partials a fix-up
// pass sums (7 * C * d floats: 0.9 MB at C 8, 11 MB at C 96; the first
// port's partials were E * F/128 * C * d floats, 1.41 GB at C 96).
// float32 keeps the first port's FMA tile (float32 partials per ff chunk
// of 128, summed in a fixed order by a second pass).
#include "mlp_tile.cuh"

// x: (e, n, d); wg, wi: (e, d, f); wo: (e, f, d); out: (e, n, d); all
// contiguous, one element type.  float32 (dtype 0): fc (32 or 128) hidden
// units a block, partial of e*ceil(f/fc)*n*d floats.  bfloat16 (dtype 1) and float16 (2):
// cluster size cl, token tile nt and cluster count from the tile plan
// (kernels/_mlp_plan.py), partial of leftover*parts*min(nt,n)*d floats
// (none when no item is left over).  wg may be null when swiglu is 0.
extern "C" int moe_mlp(const void* x, const void* wg, const void* wi,
                       const void* wo, void* partial, void* out, int e, int n,
                       int d, int f, int fc, int swiglu, int dtype, int cl,
                       int nt, int clusters, void* stream) {
  return mz::mlp_entry(x, wg, wi, wo, partial, out, e, n, d, f, fc, swiglu,
                       dtype, cl, nt, clusters, stream);
}

MZ_ERROR_STRING(moe_mlp)

// Clusters of the bfloat16 launch that fit on the card at once (minus a
// CUDA error code when the query fails); cl and nt from the tile plan.
extern "C" int moe_mlp_max_clusters(int e, int n, int d, int f, int swiglu,
                                    int cl, int nt) {
  return mz::mlp_max_clusters(e, n, d, f, swiglu, cl, nt);
}

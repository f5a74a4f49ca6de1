// Grouped expert MLP over capacity buffers for Hopper (sm_90a).
//
// Replaces the TPU kernel moe_mlp_pallas
// (src/repro/kernels/moe_mlp/kernel.py), the MoE hot path:
//     out[e] = (silu(x[e] @ wg[e]) * (x[e] @ wi[e])) @ wo[e]   (swiglu)
//     out[e] = gelu_tanh(x[e] @ wi[e]) @ wo[e]                 (no gate)
// for x (E, C, d) capacity buffers, float32 accumulation, the output
// rounded once to x's type, and the (E, C, F) hidden never in device
// memory.
//
// What bounds it on the H100: bytes.  At mixtral decode (E 8, C 8, d 4096,
// F 14336, bf16) the kernel must read every expert's three weight matrices
// once, 2.82 GB, 0.84 ms at 3.35 TB/s; at a 256-token prefill (C 80) the
// same bytes still outweigh the 225 GFLOP at the bf16 tensor peak.  The
// design is fused_mlp's (mlp_tile.cuh) with the expert as the grid's z
// index: grid (token blocks, ff chunks, experts), each block reading its
// expert's weight columns once for 16 capacity rows, float32 partials of
// all d outputs per ff chunk, summed in a fixed order by a second pass.
// The partial workspace is E * F/128 * C * d floats, 14.7 MB per capacity
// slot at mixtral's shapes: 117 MB at decode (C 8), but 1.17 GB at a
// 256-token prefill (C 80) and 1.41 GB at a 300-token one (C 96), written
// and read back once, as much traffic as the 2.82 GB of expert weights,
// and allocated on every call (later work: reduce over the ff chunks
// inside a block, or split F into fewer chunks).  The products are
// float32 FMAs, not tensor cores: at prefill the kernel is far from the
// bound (later work: mma/wgmma with TMA-fed weight tiles).
#include "mlp_tile.cuh"

// x: (e, n, d); wg, wi: (e, d, f); wo: (e, f, d); out: (e, n, d); all
// contiguous, one element type.  partial: float32 workspace of
// e*ceil(f/fc)*n*d values.  fc is 32 or 128.  wg may be null when swiglu
// is 0.
extern "C" int moe_mlp(const void* x, const void* wg, const void* wi,
                       const void* wo, void* partial, void* out, int e, int n,
                       int d, int f, int fc, int swiglu, int dtype,
                       void* stream) {
  return mz::mlp_entry(x, wg, wi, wo, partial, out, e, n, d, f, fc, swiglu,
                       dtype, stream);
}

MZ_ERROR_STRING(moe_mlp)

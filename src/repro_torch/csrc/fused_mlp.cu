// Fused dense gated MLP for Hopper (sm_90a).
//
// Replaces the TPU kernel fused_mlp_pallas
// (src/repro/kernels/fused_mlp/kernel.py):
//     out = (silu(x @ wg) * (x @ wi)) @ wo        (swiglu)
//     out = gelu_tanh(x @ wi) @ wo                (no gate; wg never read)
// with float32 accumulation, and the (N, F) hidden activation never
// written to device memory.
//
// What bounds it on the H100: at decode width (N <= 8) bytes -- the three
// weight matrices (3*d*F values) are read for a handful of tokens; at
// prefill widths (N in the hundreds) operations.  The kernels are those
// of mlp_tile.cuh with one expert: the ff axis split across blocks into
// float32 partials, summed in a fixed order by a second pass, and the
// output columns walked in tiles so that any d_model runs without
// spilling registers.
#include "mlp_tile.cuh"

// x: (n, d); wg, wi: (d, f); wo: (f, d); out: (n, d); all contiguous, one
// element type.  partial: float32 workspace of ceil(f/fc)*n*d values.
// fc (hidden units a block) is 32 or 128.  wg may be null when swiglu is 0.
extern "C" int fused_mlp(const void* x, const void* wg, const void* wi,
                         const void* wo, void* partial, void* out, int n, int d,
                         int f, int fc, int swiglu, int dtype, void* stream) {
  return mz::mlp_entry(x, wg, wi, wo, partial, out, 1, n, d, f, fc, swiglu,
                       dtype, stream);
}

MZ_ERROR_STRING(fused_mlp)

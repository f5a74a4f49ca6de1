"""Launch wrapper of the CUDA fused dense gated-MLP kernel
(`csrc/fused_mlp.cu`), the port of `fused_mlp_pallas`.

Takes x (N, d), wg/wi (d, F), wo (F, d) on one CUDA device, one dtype
(float32, bfloat16 or float16); inputs that are not contiguous (16-bit types: not on
16-byte boundaries) are copied.  The tile plan (`kernels/_mlp_plan.py`)
picks the route: bfloat16 and float16 run the cluster tile (any d, its
output columns in groups of up to 6144; d and F
not multiples of 8 are zero-padded to the next, `padded_call`; inputs
on 16-byte boundaries), cutting F into chunk ranges
over up to 8 clusters (no more than the card holds at once) with a
float32 partial per range; float32 runs the FMA tile (any d) with its
(F/fc, N, d) float32 partial.  Launches on PyTorch's current stream.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build as B
from repro_torch.kernels._mlp_plan import launch_plan, padded_call, tile_widths

MLP = B.Launcher("fused_mlp", "fused_mlp", [
    B.VOID_P, B.VOID_P, B.VOID_P, B.VOID_P, B.VOID_P, B.VOID_P, B.INT,
    B.INT, B.INT, B.INT, B.INT, B.INT, B.INT, B.INT, B.INT, B.VOID_P])


def fused_mlp_cuda(x: torch.Tensor, wg: torch.Tensor | None, wi: torch.Tensor,
                   wo: torch.Tensor, *, swiglu: bool = True) -> torch.Tensor:
    ws = [x, wi, wo] + ([wg] if swiglu else [])
    B.require_cuda("fused_mlp", *ws)
    if x.dim() != 2 or x.shape[1] == 0:
        raise ValueError(f"fused_mlp: x must be (N, d) with d > 0, got "
                         f"{tuple(x.shape)}")
    n, d = x.shape
    f = wi.shape[-1]
    shapes = [(d, f), (f, d)] + ([(d, f)] if swiglu else [])
    for t, want in zip(ws[1:], shapes):
        if tuple(t.shape) != want:
            raise ValueError(f"fused_mlp: weight of shape {tuple(t.shape)}, "
                             f"want {want}")
    B.dtype_code(x, "fused_mlp")
    if n == 0:
        return torch.empty_like(x)
    d_to, f_to = tile_widths(d, f) if x.dtype in B.HALF_TYPES else (d, f)
    return padded_call(lambda *a: launch(*a, swiglu=swiglu), x,
                       wg if swiglu else None, wi, wo, d_to, f_to)


def launch(x: torch.Tensor, wg: torch.Tensor | None, wi: torch.Tensor,
           wo: torch.Tensor, *, swiglu: bool = True) -> torch.Tensor:
    """One call at widths the route takes (16-bit types: d and F multiples
    of 8); inputs that are not contiguous (16-bit types: not on 16-byte
    boundaries) are copied."""
    x, wi, wo, *g = B.tile_inputs("fused_mlp", x, [x, wi, wo] + ([wg] if swiglu else []))
    wg = g[0] if swiglu else None
    n, d = x.shape
    f = wi.shape[-1]
    out = torch.empty_like(x)
    plan = launch_plan("fused_mlp", 1, n, d, f, str(x.dtype).removeprefix("torch."),
                       swiglu)
    partial = torch.empty(plan.workspace_bytes // 4, dtype=torch.float32,
                          device=x.device) if plan.workspace_bytes else None
    MLP(x.data_ptr(), wg.data_ptr() if swiglu else None, wi.data_ptr(),
        wo.data_ptr(), None if partial is None else partial.data_ptr(),
        out.data_ptr(), n, d, f, plan.fc, int(swiglu), B.DTYPE_CODES[x.dtype],
        plan.cl, plan.nt, plan.clusters, B.stream(x))
    return out

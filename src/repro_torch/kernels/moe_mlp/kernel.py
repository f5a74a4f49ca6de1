"""Launch wrapper of the CUDA grouped expert-MLP kernel
(`csrc/moe_mlp.cu`), the port of `moe_mlp_pallas`.

Takes x (E, C, d), wg/wi (E, d, F), wo (E, F, d) on one CUDA device, one
dtype (float32, bfloat16 or float16); inputs that are not contiguous (bfloat16:
not on 16-byte boundaries) are copied.  The tile plan
(`kernels/_mlp_plan.py`) picks the route: bfloat16 and float16 run the
cluster tile
(d and F not multiples of 8 zero-padded to the next, `padded_call`), one cluster an
(expert, token tile) where the card holds them all at once and nothing
beside the output is allocated; otherwise the items left over are cut
into chunk ranges with a float32 partial each (at mixtral's shapes on a
card that holds 7 clusters of 16: 7 * C * d floats); float32 runs the
FMA tile with its (E, F/fc, C, d) float32 partial.  Launches on
PyTorch's current stream.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build as B
from repro_torch.kernels._mlp_plan import launch_plan, padded_call, tile_widths

MOE = B.Launcher("moe_mlp", "moe_mlp", [
    B.VOID_P, B.VOID_P, B.VOID_P, B.VOID_P, B.VOID_P, B.VOID_P, B.INT,
    B.INT, B.INT, B.INT, B.INT, B.INT, B.INT, B.INT, B.INT, B.INT, B.VOID_P])


def moe_mlp_cuda(x: torch.Tensor, wg: torch.Tensor | None, wi: torch.Tensor,
                 wo: torch.Tensor, *, swiglu: bool = True) -> torch.Tensor:
    ws = [x, wi, wo] + ([wg] if swiglu else [])
    B.require_cuda("moe_mlp", *ws)
    if x.dim() != 3 or 0 in x.shape[::2]:
        raise ValueError(f"moe_mlp: x must be (E, C, d) with E, d > 0, got "
                         f"{tuple(x.shape)}")
    e, c, d = x.shape
    f = wi.shape[-1]
    shapes = [(e, d, f), (e, f, d)] + ([(e, d, f)] if swiglu else [])
    for t, want in zip(ws[1:], shapes):
        if tuple(t.shape) != want:
            raise ValueError(f"moe_mlp: weight of shape {tuple(t.shape)}, "
                             f"want {want}")
    B.dtype_code(x, "moe_mlp")
    if c == 0:
        return torch.empty_like(x)
    d_to, f_to = tile_widths(d, f) if x.dtype in B.HALF_TYPES else (d, f)
    return padded_call(lambda *a: launch(*a, swiglu=swiglu), x,
                       wg if swiglu else None, wi, wo, d_to, f_to)


def launch(x: torch.Tensor, wg: torch.Tensor | None, wi: torch.Tensor,
           wo: torch.Tensor, *, swiglu: bool = True) -> torch.Tensor:
    """One call at widths the route takes (16-bit types: d and F multiples
    of 8); inputs that are not contiguous (16-bit types: not on 16-byte
    boundaries) are copied."""
    x, wi, wo, *g = B.tile_inputs("moe_mlp", x, [x, wi, wo] + ([wg] if swiglu else []))
    wg = g[0] if swiglu else None
    e, c, d = x.shape
    f = wi.shape[-1]
    out = torch.empty_like(x)
    plan = launch_plan("moe_mlp", e, c, d, f, str(x.dtype).removeprefix("torch."),
                       swiglu)
    partial = torch.empty(plan.workspace_bytes // 4, dtype=torch.float32,
                          device=x.device) if plan.workspace_bytes else None
    MOE(x.data_ptr(), wg.data_ptr() if swiglu else None, wi.data_ptr(),
        wo.data_ptr(), None if partial is None else partial.data_ptr(),
        out.data_ptr(), e, c, d, f, plan.fc, int(swiglu), B.DTYPE_CODES[x.dtype],
        plan.cl, plan.nt, plan.clusters, B.stream(x))
    return out

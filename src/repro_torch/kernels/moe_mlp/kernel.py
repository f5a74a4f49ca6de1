"""Launch wrapper of the CUDA grouped expert-MLP kernel
(`csrc/moe_mlp.cu`), the port of `moe_mlp_pallas`.

Takes x (E, C, d), wg/wi (E, d, F), wo (E, F, d) on one CUDA device, one
dtype (float32 or bfloat16), contiguous.  Allocates the output and the
float32 partial-sum workspace (E * F/128 * C * d values) and launches on
PyTorch's current stream.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build as B

FF_CHUNK = 128       # hidden units a block (csrc/mlp_tile.cuh)

MOE = B.Launcher("moe_mlp", "moe_mlp", [
    B.VOID_P, B.VOID_P, B.VOID_P, B.VOID_P, B.VOID_P, B.VOID_P, B.INT,
    B.INT, B.INT, B.INT, B.INT, B.INT, B.INT, B.VOID_P])


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
    for t in ws:
        if t.dtype != x.dtype or not t.is_contiguous():
            raise ValueError("moe_mlp: inputs must share x's dtype and be "
                             "contiguous")
    if -(-f // FF_CHUNK) > 65535 or e > 65535:
        raise ValueError("moe_mlp: grid limits exceeded")
    code = B.dtype_code(x, "moe_mlp")
    out = torch.empty_like(x)
    if c == 0:
        return out
    partial = torch.empty((e, -(-f // FF_CHUNK), c, d), dtype=torch.float32,
                          device=x.device)
    MOE(x.data_ptr(), wg.data_ptr() if swiglu else None, wi.data_ptr(),
        wo.data_ptr(), partial.data_ptr(), out.data_ptr(), e, c, d, f,
        FF_CHUNK, int(swiglu), code, B.stream(x))
    return out

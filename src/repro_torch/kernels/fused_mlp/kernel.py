"""Launch wrapper of the CUDA fused dense gated-MLP kernel
(`csrc/fused_mlp.cu`), the port of `fused_mlp_pallas`.

Takes x (N, d), wg/wi (d, F), wo (F, d) on one CUDA device, one dtype
(float32 or bfloat16), contiguous, any d (the kernel walks the output
columns in tiles).  Allocates the output and the float32 partial-sum
workspace and launches on PyTorch's current stream.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build as B

MLP = B.Launcher("fused_mlp", "fused_mlp", [
    B.VOID_P, B.VOID_P, B.VOID_P, B.VOID_P, B.VOID_P, B.VOID_P, B.INT,
    B.INT, B.INT, B.INT, B.INT, B.INT, B.VOID_P])


def ff_chunk(n: int) -> int:
    """Hidden units a block takes: narrow chunks at decode widths so the
    weight reads spread over enough blocks, wide ones for prefill."""
    return 32 if n <= 64 else 128


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
    for t in ws:
        if t.dtype != x.dtype or not t.is_contiguous():
            raise ValueError("fused_mlp: inputs must share x's dtype and be "
                             "contiguous")
    code = B.dtype_code(x, "fused_mlp")
    out = torch.empty_like(x)
    if n == 0:
        return out
    fc = ff_chunk(n)
    partial = torch.empty((-(-f // fc), n, d), dtype=torch.float32,
                          device=x.device)
    MLP(x.data_ptr(), wg.data_ptr() if swiglu else None, wi.data_ptr(),
        wo.data_ptr(), partial.data_ptr(), out.data_ptr(), n, d, f, fc,
        int(swiglu), code, B.stream(x))
    return out

"""Plain PyTorch versions of the fused RMSNorm(+residual) kernels: the
CPU path of `ops` and the oracle the CUDA kernel is held against."""
from __future__ import annotations

import torch


def fused_rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor, *,
                      eps: float = 1e-6) -> torch.Tensor:
    """rmsnorm(x) * (1 + scale), computed in float32, cast to x's dtype."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def fused_rmsnorm_residual_ref(x: torch.Tensor, res: torch.Tensor,
                               scale: torch.Tensor, *, eps: float = 1e-6):
    """(x + res, rmsnorm(x + res) * (1 + scale)); the sum is taken in the
    model dtype and normed after rounding, like the unfused model path."""
    s = x + res
    return s, fused_rmsnorm_ref(s, scale, eps=eps)

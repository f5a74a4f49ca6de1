"""Plain PyTorch version of the fused dense gated-MLP kernel: the CPU
path of `ops` and the oracle the CUDA kernel is held against."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def fused_mlp_ref(x: torch.Tensor, wg: torch.Tensor | None, wi: torch.Tensor,
                  wo: torch.Tensor, *, swiglu: bool = True) -> torch.Tensor:
    """(silu(x @ wg) * (x @ wi)) @ wo, or gelu_tanh(x @ wi) @ wo without
    the gate; everything in float32, cast to x's dtype at the end."""
    xf = x.float()
    h = xf @ wi.float()
    if swiglu:
        h = F.silu(xf @ wg.float()) * h
    else:
        h = F.gelu(h, approximate="tanh")
    return (h @ wo.float()).to(x.dtype)

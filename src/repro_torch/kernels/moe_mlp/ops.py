"""Public grouped expert-MLP op: x (E, C, d) capacity buffers, wg/wi
(E, d, F), wo (E, F, d) -> (E, C, d).

A CPU tensor takes the plain PyTorch version (`ref`); a CUDA tensor
launches the CUDA kernel, which raises on anything it does not take.
"""
from __future__ import annotations

import torch

from . import kernel, ref


def moe_mlp(x: torch.Tensor, wg: torch.Tensor | None, wi: torch.Tensor,
            wo: torch.Tensor, *, swiglu: bool = True) -> torch.Tensor:
    """wg is only read when swiglu=True; pass None for GELU experts."""
    if x.device.type == "cpu":
        return ref.moe_mlp_ref(x, wg, wi, wo, swiglu=swiglu)
    return kernel.moe_mlp_cuda(x, wg, wi, wo, swiglu=swiglu)

"""Public fused dense gated-MLP op in the model layout: x is (..., d),
flattened to one token axis for the kernel.

A CPU tensor takes the plain PyTorch version (`ref`); a CUDA tensor
launches the CUDA kernel, which raises on anything it does not take.
Under autograd the kernel's forward takes the plain version's gradients
(`_grad.run`).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _grad

from . import kernel, ref


def _mlp_on_card(x, wg, wi, wo, *, swiglu):
    d = x.shape[-1]
    return kernel.fused_mlp_cuda(x.reshape(-1, d), wg, wi, wo,
                                 swiglu=swiglu).reshape(x.shape)


def fused_mlp(x: torch.Tensor, wg: torch.Tensor | None, wi: torch.Tensor,
              wo: torch.Tensor, *, swiglu: bool = True) -> torch.Tensor:
    """wg is only read when swiglu=True; pass None for plain GELU MLPs."""
    if x.device.type == "cpu":
        return ref.fused_mlp_ref(x, wg, wi, wo, swiglu=swiglu)
    return _grad.run(_mlp_on_card, ref.fused_mlp_ref, x, wg, wi, wo, swiglu=swiglu)

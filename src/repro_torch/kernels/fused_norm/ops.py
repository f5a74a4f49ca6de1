"""Public fused RMSNorm(+residual) ops in the model layout: x (and res)
are (..., d), flattened to one token axis for the kernel.

A CPU tensor takes the plain PyTorch version (`ref`); a CUDA tensor
launches the CUDA kernel, which raises on anything it does not take.
Under autograd the kernel's forward takes the plain version's gradients
(`_grad.run`); both outputs of the residual form carry them.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _grad

from . import kernel, ref


def _rmsnorm_on_card(x, scale, *, eps):
    d = x.shape[-1]
    return kernel.fused_rmsnorm_cuda(
        x.reshape(-1, d), scale, eps=eps).reshape(x.shape)


def _rmsnorm_residual_on_card(x, res, scale, *, eps):
    d = x.shape[-1]
    s, out = kernel.fused_rmsnorm_residual_cuda(
        x.reshape(-1, d), res.reshape(-1, d), scale, eps=eps)
    return s.reshape(x.shape), out.reshape(x.shape)


def fused_rmsnorm(x: torch.Tensor, scale: torch.Tensor, *,
                  eps: float = 1e-6) -> torch.Tensor:
    if x.device.type == "cpu":
        return ref.fused_rmsnorm_ref(x, scale, eps=eps)
    return _grad.run(_rmsnorm_on_card, ref.fused_rmsnorm_ref, x, scale, eps=eps)


def fused_rmsnorm_residual(x: torch.Tensor, res: torch.Tensor,
                           scale: torch.Tensor, *, eps: float = 1e-6):
    if x.device.type == "cpu":
        return ref.fused_rmsnorm_residual_ref(x, res, scale, eps=eps)
    return _grad.run(_rmsnorm_residual_on_card, ref.fused_rmsnorm_residual_ref,
                     x, res, scale, eps=eps)

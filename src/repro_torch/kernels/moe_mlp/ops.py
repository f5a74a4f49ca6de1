"""Public grouped expert-MLP op: x (E, C, d) capacity buffers, wg/wi
(E, d, F), wo (E, F, d) -> (E, C, d).

A CPU tensor takes the plain PyTorch version (`ref`); a CUDA tensor
launches the CUDA kernel, which raises on anything it does not take.
Under autograd the kernel's forward takes the plain version's gradients
(`_grad.run`).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _grad

from . import kernel, ref


def moe_mlp(x: torch.Tensor, wg: torch.Tensor | None, wi: torch.Tensor,
            wo: torch.Tensor, *, swiglu: bool = True) -> torch.Tensor:
    """wg is only read when swiglu=True; pass None for GELU experts."""
    if x.device.type == "cpu":
        return ref.moe_mlp_ref(x, wg, wi, wo, swiglu=swiglu)
    return _grad.run(kernel.moe_mlp_cuda, ref.moe_mlp_ref, x, wg, wi, wo,
                     swiglu=swiglu)

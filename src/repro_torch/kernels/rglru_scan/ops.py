"""Public RG-LRU scan op, the signature of the JAX op: a, b (B, S, W),
h0 (B, W) -> h (B, S, W) with h_t = a_t * h_{t-1} + b_t.

A CPU tensor takes the plain PyTorch version (`ref`); a CUDA tensor
launches the CUDA kernel, which raises on anything it does not take.
Under autograd the kernel's forward takes the plain version's gradients
(`_grad.run`); h0 may or may not require one.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _grad

from . import kernel, ref


def rglru_scan(a: torch.Tensor, b: torch.Tensor,
               h0: torch.Tensor) -> torch.Tensor:
    if a.device.type == "cpu":
        return ref.rglru_scan_ref(a, b, h0)
    return _grad.run(kernel.rglru_scan_cuda, ref.rglru_scan_ref, a, b, h0)

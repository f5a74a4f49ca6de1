"""Public WKV6 ops.  `wkv6` keeps the JAX op's signature and layout (r/k/
logw (BH, S, D), v (BH, S, Dv), u (BH, 1, D), s0 (BH, D, Dv));
`wkv6_bshd` takes the model layout (B, S, H, D) that `rwkv6.time_mix`
produces, u (H, D) and s0 (B, H, D, Dv), with no transpose.  Inputs
float32 or bfloat16; both return (o in the input dtype, s_final in
float32): the model carries the final state into the next call.

A CPU tensor takes the plain PyTorch version (`ref`); a CUDA tensor
launches the CUDA kernel, which raises on anything it does not take.
`chunk` sets the plain version's chunk length; the kernel picks its own
(64 for D <= 64, else 32; `csrc/wkv6.cu`).

Under autograd the kernel's forward takes the plain version's gradients
(`_grad.run`, the plain version at `chunk`); a loss that drops s_final
passes no gradient for it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _grad

from . import kernel, ref


def _bshd_on_card(r, k, v, logw, u, s0, *, chunk):
    return kernel.wkv6_cuda(r, k, v, logw, u, s0)


def _bh_on_card(r, k, v, logw, u, s0, *, chunk):
    o, s = kernel.wkv6_cuda(r[:, :, None], k[:, :, None], v[:, :, None],
                            logw[:, :, None], u, s0[:, None])
    return o[:, :, 0], s[:, 0]


def wkv6_bshd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              logw: torch.Tensor, u: torch.Tensor, s0: torch.Tensor, *,
              chunk: int = 64):
    if r.device.type == "cpu":
        return ref.wkv6_bshd_ref(r, k, v, logw, u, s0, chunk=chunk)
    return _grad.run(_bshd_on_card, ref.wkv6_bshd_ref, r, k, v, logw, u, s0,
                     chunk=chunk)


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         logw: torch.Tensor, u: torch.Tensor, s0: torch.Tensor, *,
         chunk: int = 64):
    if r.device.type == "cpu":
        return ref.wkv6_ref(r, k, v, logw, u, s0, chunk=chunk)
    return _grad.run(_bh_on_card, ref.wkv6_ref, r, k, v, logw, u, s0, chunk=chunk)

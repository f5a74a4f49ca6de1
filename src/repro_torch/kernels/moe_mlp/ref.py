"""Plain PyTorch version of the grouped expert-MLP kernel (the JAX
`moe_mlp_ref`): the CPU path of `ops` and the oracle the CUDA kernel is
held against."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def moe_mlp_ref(x: torch.Tensor, wg: torch.Tensor | None, wi: torch.Tensor,
                wo: torch.Tensor, *, swiglu: bool = True) -> torch.Tensor:
    """Per expert e: (silu(x[e] @ wg[e]) * (x[e] @ wi[e])) @ wo[e], or
    gelu_tanh(x[e] @ wi[e]) @ wo[e] without the gate; x (E, C, d), wg/wi
    (E, d, F), wo (E, F, d); float32 throughout, cast to x's dtype."""
    xf = x.float()
    h = torch.bmm(xf, wi.float())
    if swiglu:
        h = F.silu(torch.bmm(xf, wg.float())) * h
    else:
        h = F.gelu(h, approximate="tanh")
    return torch.bmm(h, wo.float()).to(x.dtype)

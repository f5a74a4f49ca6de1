"""Token sampling: greedy / temperature / top-k / top-p.

Greedy is argmax (first maximal index, as `jnp.argmax`).  The sampled
forms draw from a caller-owned `torch.Generator`; they cannot give the
draws `jax.random` gives, so parity with the JAX package there is
distributional only.
"""
from __future__ import annotations

import torch


def sample(logits: torch.Tensor, generator: torch.Generator | None = None, *,
           temperature: float = 0.0, top_k: int = 0,
           top_p: float = 1.0) -> torch.Tensor:
    """logits: (B, V) -> (B,) int64."""
    if temperature <= 0.0:
        return logits.argmax(dim=-1)
    lf = logits.float() / temperature
    if top_k > 0:
        kth = torch.topk(lf, top_k, dim=-1).values[..., -1:]
        lf = lf.masked_fill(lf < kth, -1e30)
    if top_p < 1.0:
        sorted_l = torch.sort(lf, dim=-1, descending=True).values
        csum = torch.softmax(sorted_l, dim=-1).cumsum(dim=-1)
        cutoff_idx = (csum < top_p).sum(dim=-1, keepdim=True)
        cutoff = torch.gather(sorted_l, -1, cutoff_idx)
        lf = lf.masked_fill(lf < cutoff, -1e30)
    probs = torch.softmax(lf, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]

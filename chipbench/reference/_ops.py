"""Plain float32 building blocks of the references (torch only; nothing of
the program), and the float8 control's matmul.

`Mm` is how a reference multiplies activations by weights: `matmul` in
float32, with TF32 off (the caller sets it), or `fp8_matmul`, the
control: both sides rounded to float8 e4m3 with a scale a row of x and
a column of w (amax / 448), the product in float32.  The control takes
every product with a weight in float8 (the projections, the experts,
the router and the head); the embedding, the norms and the attention's
scores, softmax and weighted sum stay in float32.
"""
from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0
Mm = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x.float() @ w.float()


def _fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    s = t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12) / E4M3_MAX
    return (t / s).to(torch.float8_e4m3fn).float() * s


def fp8_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return _fp8(x.float(), -1) @ _fp8(w.float(), 0)


def rmsnorm(x: torch.Tensor, gain_offset: torch.Tensor, eps: float) -> torch.Tensor:
    """x / rms(x) * (1 + gain_offset): the weights store a gain as its
    offset from 1."""
    x = x.float()
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (1.0 + gain_offset.float())


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate-half RoPE over the last axis of x (S, H, r) at positions pos
    (S,): pair i is (x[i], x[i + r/2]), angle pos * theta^(-2i/r)."""
    r = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, r, 2, dtype=torch.float32, device=x.device) / r)
    ang = pos.float()[:, None] * inv[None]
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    a, b = x[..., :r // 2], x[..., r // 2:]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], -1)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              window: int | None = None, block: int = 512) -> torch.Tensor:
    """Causal softmax attention, float32: q (S, H, dq), k (S, H, dq),
    v (S, H, dv) -> (S, H, dv); with `window`, query i sees keys
    i - window < j <= i.  Queries go in blocks of `block` rows."""
    s = q.shape[0]
    scale = 1.0 / math.sqrt(q.shape[-1])
    kpos = torch.arange(s, device=q.device)
    out = []
    for q0 in range(0, s, block):
        qb = q[q0:q0 + block]
        qpos = torch.arange(q0, q0 + qb.shape[0], device=q.device)[:, None]
        mask = kpos[None] <= qpos
        if window is not None:
            mask &= kpos[None] > qpos - window
        sc = torch.einsum("qhd,khd->hqk", qb, k) * scale
        p = torch.softmax(sc.masked_fill(~mask[None], float("-inf")), -1)
        out.append(torch.einsum("hqk,khd->qhd", p, v))
    return torch.cat(out)


def swiglu(x: torch.Tensor, w_gate, w_in, w_out, mm: Mm) -> torch.Tensor:
    return mm(F.silu(mm(x, w_gate)) * mm(x, w_in), w_out)


def logit_gaps(ref: torch.Tensor, served: torch.Tensor, other: torch.Tensor | None = None):
    """Per position, how far below the reference's best logit lies the
    served token's (or, with `other` logits, the token `other` puts
    first): ref (n, V) float32, served (n,) long."""
    pick = served if other is None else other.argmax(-1)
    return ref.max(-1).values - ref.gather(-1, pick[:, None])[:, 0]

"""Plain PyTorch version of the flash attention kernel: the CPU path of
`ops` and the oracle the CUDA kernel is held against.

Model layout, as `ops.flash_attention` takes it: q (B, Sq, H, hd),
k/v (B, Sk, Hkv, hd) with H % Hkv == 0; query head h reads kv head
h // (H // Hkv).  The JAX package's `flash_attention_ref` computes the
same function in its (B*H, S, hd) kernel layout.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True,
                        window: int | None = None) -> torch.Tensor:
    b, sq, h, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    group = h // hkv
    kf = k.float().repeat_interleave(group, dim=2)
    vf = v.float().repeat_interleave(group, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) / math.sqrt(hd)
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    # a row with no valid key (window, or Sq > Sk) has p uniform over -1e30
    # scores; the kernel returns 0 there, and so does this version
    p = torch.where(mask.any(-1, keepdim=True), p, torch.zeros_like(p))
    return torch.einsum("bhqk,bkhd->bqhd", p, vf).to(q.dtype)

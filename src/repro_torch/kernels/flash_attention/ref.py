"""Plain PyTorch versions of the attention kernels: the CPU path of
`ops` and the oracles the CUDA kernels are held against.

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
                        causal: bool = True, window: int | None = None,
                        scale: float | None = None) -> torch.Tensor:
    """`scale` multiplies the scores (default 1 / sqrt(hd))."""
    b, sq, h, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    group = h // hkv
    kf = k.float().repeat_interleave(group, dim=2)
    vf = v.float().repeat_interleave(group, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf)
    s = s / math.sqrt(hd) if scale is None else s * scale
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


def paged_decode_attention_ref(q: torch.Tensor, k_pages: torch.Tensor,
                               v_pages: torch.Tensor, tables: torch.Tensor,
                               lengths: torch.Tensor) -> torch.Tensor:
    """Gather the page table into a dense cache view, then mask and
    softmax like dense decode (the JAX `paged_decode_attention_ref`).
    q (B, 1, H, hd); k/v pages (P, ps, Hkv, hd); tables (B, npp) int;
    lengths (B,) int, including the current token."""
    b, _, h, hd = q.shape
    npp = tables.shape[1]
    ps, hkv = k_pages.shape[1], k_pages.shape[2]
    tl = tables.long()

    def dense(pages):                      # (B, npp*ps, H, hd) float32
        g = pages[tl].reshape(b, npp * ps, hkv, hd).float()
        return g.repeat_interleave(h // hkv, dim=2)

    s = torch.einsum("bqhd,bchd->bhqc", q.float(), dense(k_pages)) \
        / math.sqrt(hd)
    kpos = torch.arange(npp * ps, device=q.device)[None, :]
    mask = kpos < lengths.long()[:, None]
    s = s.masked_fill(~mask[:, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqc,bchd->bqhd", p, dense(v_pages)).to(q.dtype)


def paged_decode_attention_int8_ref(q: torch.Tensor, k_pages: torch.Tensor,
                                    v_pages: torch.Tensor, k_scales: torch.Tensor,
                                    v_scales: torch.Tensor, tables: torch.Tensor,
                                    lengths: torch.Tensor, k_new: torch.Tensor,
                                    v_new: torch.Tensor) -> torch.Tensor:
    """The int8 pool's decode attention, as the JAX engine's quantized
    gather route computes it at float32: the pages gathered and
    dequantized to float32 (code * its page's scale), the current token's
    k/v (position lengths - 1, not yet in the pool) written over its
    slot unquantized, then float32 attention over positions < lengths.
    q (B, 1, H, hd); int8 pools (P, ps, Hkv, hd); scales (P, 1, Hkv, 1);
    k_new / v_new (B, Hkv, hd) -> (B, 1, H, hd) in q's dtype."""
    b, _, h, hd = q.shape
    npp = tables.shape[1]
    ps, hkv = k_pages.shape[1], k_pages.shape[2]
    tl = tables.long()
    last = lengths.long() - 1
    rows = torch.arange(b, device=q.device)

    def dense(pages, scales, new):         # (B, npp*ps, H, hd) float32
        g = (pages[tl].float() * scales[tl]).reshape(b, npp * ps, hkv, hd)
        g[rows, last] = new.float()
        return g.repeat_interleave(h // hkv, dim=2)

    s = torch.einsum("bqhd,bchd->bhqc", q.float(), dense(k_pages, k_scales, k_new)) \
        / math.sqrt(hd)
    kpos = torch.arange(npp * ps, device=q.device)[None, :]
    mask = kpos < lengths.long()[:, None]
    s = s.masked_fill(~mask[:, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqc,bchd->bqhd", p,
                        dense(v_pages, v_scales, v_new)).to(q.dtype)

"""Shared building blocks of the port (from `repro.models.common`):
RMSNorm with the fused dispatch, seeded weight draws, GELU, the dense
MLP, RoPE and the attention dispatch.  Params are nested dicts of
tensors, as on the JAX side.
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.fused_mlp import ops as mops
from repro_torch.kernels.fused_norm import ops as nops

from .config import ModelConfig

Params = Any   # nested dict of tensors

NEG_INF = -1e30


# --- norms ------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def init_norm(cfg: ModelConfig) -> Params:
    """RMSNorm parameters: a zero scale (the norm multiplies by 1 + scale)."""
    _require_rmsnorm(cfg)
    return {"scale": torch.zeros((cfg.d_model,), dtype=cfg.tparam_dtype)}


def _require_rmsnorm(cfg: ModelConfig) -> None:
    if cfg.norm != "rmsnorm":
        raise NotImplementedError(f"norm={cfg.norm} is not ported yet")


def apply_norm(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    _require_rmsnorm(cfg)
    if cfg.norm_impl == "fused":
        return nops.fused_rmsnorm(x, p["scale"], eps=cfg.norm_eps)
    return rmsnorm(x, p["scale"], cfg.norm_eps)


def apply_norm_residual(cfg: ModelConfig, p: Params, res: torch.Tensor,
                        delta: torch.Tensor):
    """(res + delta, norm(res + delta)); one CUDA kernel with
    cfg.norm_impl == "fused", else the plain two-op reference."""
    _require_rmsnorm(cfg)
    if cfg.norm_impl == "fused":
        return nops.fused_rmsnorm_residual(res, delta, p["scale"],
                                           eps=cfg.norm_eps)
    s = res + delta
    return s, apply_norm(cfg, p, s)


# --- activations, init ------------------------------------------------------

def gelu(x: torch.Tensor) -> torch.Tensor:
    """GELU in the tanh approximation, `jax.nn.gelu`'s default."""
    return F.gelu(x, approximate="tanh")


def normal(gen: torch.Generator, shape, scale: float, dtype) -> torch.Tensor:
    """scale * N(0, 1) of `shape`, drawn from `gen` in float32 on the CPU,
    cast to `dtype`."""
    return (torch.randn(shape, generator=gen, dtype=torch.float32)
            * scale).to(dtype)


def dense(gen: torch.Generator, shape, dtype, scale: float | None = None):
    """A weight of `shape` with the JAX `dense_init` scale: 1/sqrt(fan-in)
    unless `scale` is given."""
    s = scale if scale is not None else 1.0 / math.sqrt(shape[0])
    return normal(gen, shape, s, dtype)


# --- dense MLP --------------------------------------------------------------

def mlp_block(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU / GELU MLP.  cfg.mlp_impl == "fused" runs the whole block as
    one CUDA kernel; "dense" is plain PyTorch in the model dtype."""
    dt = cfg.tdtype
    if cfg.mlp_impl == "fused":
        wg = p["w_gate"].to(dt) if cfg.swiglu else None
        return mops.fused_mlp(x, wg, p["w_in"].to(dt), p["w_out"].to(dt),
                              swiglu=cfg.swiglu)
    h = x @ p["w_in"].to(dt)
    if cfg.swiglu:
        h = F.silu(x @ p["w_gate"].to(dt)) * h
    else:
        h = gelu(h)
    return h @ p["w_out"].to(dt)


# --- RoPE -------------------------------------------------------------------

def rope_freqs(hd: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=device) / hd))


def rope_tables(positions: torch.Tensor, hd: int, theta: float):
    """(cos, sin) of the rotation angles, each (B, S, 1, hd/2) float32,
    for positions (B, S); computed once and shared by every layer."""
    freqs = rope_freqs(hd, theta, positions.device)          # (hd/2,)
    ang = positions[..., None].float() * freqs               # (B, S, hd/2)
    return torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]


def apply_rope(x: torch.Tensor, rope) -> torch.Tensor:
    """x: (B, S, H, hd); rope: `rope_tables` of its positions.  Rotates
    all hd dims."""
    cos, sin = rope
    hd = x.shape[-1]
    x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)


# --- attention --------------------------------------------------------------

def repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, S, Hkv, hd) -> (B, S, Hkv * n_rep, hd), kv head j serving query
    heads j*n_rep .. (j+1)*n_rep - 1."""
    if n_rep == 1:
        return k
    return k.repeat_interleave(n_rep, dim=2)


def attn_einsum(q, k, v, *, causal: bool, window: int | None,
                q_offset: int = 0) -> torch.Tensor:
    """Plain attention. q: (B,Sq,H,hd), k/v: (B,Sk,Hkv,hd)."""
    n_rep = q.shape[2] // k.shape[2]
    k, v = repeat_kv(k, n_rep), repeat_kv(v, n_rep)
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    sq, sk = q.shape[1], k.shape[1]
    qpos = torch.arange(sq, device=q.device)[:, None] + q_offset
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    logits = logits.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def attention(cfg: ModelConfig, q, k, v, *, causal: bool = True,
              q_offset: int = 0, decode: bool = False) -> torch.Tensor:
    """Dispatch on cfg.attn_impl and shape, as the JAX package does.  The
    local (banded sliding-window) form runs as the einsum form with the
    window mask, which computes the same function with the full (Sq, Sk)
    scores; the chunked form is not ported yet."""
    impl = cfg.attn_impl
    s = q.shape[1]
    if impl == "auto":
        if decode or s == 1:
            impl = "einsum"
        elif cfg.window is not None and s > cfg.window:
            impl = "local"
        elif s > 4096:
            impl = "chunked"
        else:
            impl = "einsum"
    if impl == "flash":
        return fops.flash_attention(q, k, v, causal=causal, window=cfg.window)
    if impl == "chunked":
        raise NotImplementedError(f"attn_impl={impl} is not ported yet")
    return attn_einsum(q, k, v, causal=causal, window=cfg.window,
                       q_offset=q_offset)

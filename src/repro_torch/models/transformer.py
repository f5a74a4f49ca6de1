"""Dense decoder-only transformer of the port (from
`repro.models.transformer`): plain GQA attention with or without QKV
bias, RMSNorm, RoPE, SwiGLU/GELU MLP, tied or separate embeddings.

Params keep the JAX tree and layout: each segment's layer weights are
stacked on a leading axis under `segments[i]["kind_dense"]`, and the
layers run in a Python loop where JAX used `lax.scan`.  MoE, MLA,
sliding-window and M-RoPE variants raise NotImplementedError.

Caches are updated in place (the JAX functions return fresh arrays):
`decode_step` writes the new token's k/v into the cache tensors it is
given and returns the same tensors, which saves a copy of the cache per
step.
"""
from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.bridge import tree_to

from .common import (apply_norm, apply_norm_residual, apply_rope, attention,
                     mlp_block, normal, rope_tables)
from .config import ModelConfig

Params = Any


def check_supported(cfg: ModelConfig) -> None:
    """Raise for the variants this slice of the port does not serve."""
    missing = [name for name, on in (
        ("family " + cfg.family, cfg.family != "transformer"),
        ("MoE", cfg.use_moe), ("MLA", cfg.use_mla),
        ("sliding-window attention", cfg.window is not None),
        ("M-RoPE", cfg.mrope_sections is not None), ("MTP", cfg.mtp),
        ("norm " + cfg.norm, cfg.norm != "rmsnorm")) if on]
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} not ported yet")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, gen: torch.Generator,
                device: torch.device | str = "cpu") -> Params:
    """Weights of the same shapes and scales as the JAX `init_params`,
    drawn from `gen` (on the CPU, so a seed gives the same weights on
    every machine) and moved to `device`."""
    check_supported(cfg)
    pd = cfg.tparam_dtype
    d, qd, kvd, f, L = cfg.d_model, cfg.q_dim, cfg.kv_dim, cfg.d_ff, cfg.n_layers
    out_scale = 0.02 / math.sqrt(2 * cfg.n_layers)

    def dense(shape, scale=None):       # per-layer shape, stacked on L
        s = scale if scale is not None else 1.0 / math.sqrt(shape[0])
        return normal(gen, (L, *shape), s, pd)

    attn = {"wq": dense((d, qd)), "wk": dense((d, kvd)),
            "wv": dense((d, kvd)), "wo": dense((qd, d), out_scale)}
    if cfg.qkv_bias:
        attn.update(bq=torch.zeros((L, qd), dtype=pd),
                    bk=torch.zeros((L, kvd), dtype=pd),
                    bv=torch.zeros((L, kvd), dtype=pd))
    mlp = {"w_in": dense((d, f)), "w_out": dense((f, d), out_scale)}
    if cfg.swiglu:
        mlp["w_gate"] = dense((d, f))
    layers = {"norm1": {"scale": torch.zeros((L, d), dtype=pd)},
              "attn": attn,
              "norm2": {"scale": torch.zeros((L, d), dtype=pd)},
              "mlp": mlp}
    params = {"embed": normal(gen, (cfg.vocab, d), 0.02, pd),
              "final_norm": {"scale": torch.zeros((d,), dtype=pd)},
              "segments": [{"kind_dense": layers}]}
    if not cfg.tie_embeddings:
        params["head"] = normal(gen, (d, cfg.vocab), 0.02, pd)
    return tree_to(params, device)


def _segment_params(seg: Params) -> Params:
    kind, sp = next(iter(seg.items()))
    if kind != "kind_dense":
        raise NotImplementedError(f"segment {kind} is not ported yet")
    return sp


def _layers(sp: Params, n: int | None = None) -> list[Params]:
    """Per-layer parameter trees (views) out of the stacked segment tree,
    one `unbind` per leaf."""
    n = sp["norm1"]["scale"].shape[0] if n is None else n
    per: list[Params] = [{} for _ in range(n)]
    for k, v in sp.items():
        subs = _layers(v, n) if isinstance(v, dict) else v.unbind(0)
        for i in range(n):
            per[i][k] = subs[i]
    return per


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _qkv(cfg: ModelConfig, p: Params, x: torch.Tensor):
    bsz, s, _ = x.shape
    dt = cfg.tdtype
    q = x @ p["wq"].to(dt)
    k = x @ p["wk"].to(dt)
    v = x @ p["wv"].to(dt)
    if cfg.qkv_bias:
        q, k, v = q + p["bq"].to(dt), k + p["bk"].to(dt), v + p["bv"].to(dt)
    return (q.reshape(bsz, s, cfg.n_heads, cfg.hd),
            k.reshape(bsz, s, cfg.kv_heads, cfg.hd),
            v.reshape(bsz, s, cfg.kv_heads, cfg.hd))


def attn_block(cfg: ModelConfig, p: Params, x: torch.Tensor, rope):
    """Full-sequence (prefill) attention: (out, (k, v)), k/v in cache
    layout (B, S, Hkv, hd).  rope: `rope_tables` of the positions."""
    bsz, s, _ = x.shape
    q, k, v = _qkv(cfg, p, x)
    q, k = apply_rope(q, rope), apply_rope(k, rope)
    o = attention(cfg, q, k, v, causal=True)
    return o.reshape(bsz, s, cfg.q_dim) @ p["wo"].to(cfg.tdtype), (k, v)


def layer_fwd(cfg: ModelConfig, p: Params, x: torch.Tensor, rope):
    a, kv = attn_block(cfg, p["attn"], apply_norm(cfg, p["norm1"], x), rope)
    # fused norm_impl runs the attn-residual add + norm2 as one kernel
    x, h = apply_norm_residual(cfg, p["norm2"], x, a)
    return x + mlp_block(cfg, p["mlp"], h), kv


# ---------------------------------------------------------------------------
# Forward (prefill)
# ---------------------------------------------------------------------------

def embed_tokens(cfg: ModelConfig, params: Params, tokens: torch.Tensor):
    return params["embed"].to(cfg.tdtype)[tokens]


def unembed(cfg: ModelConfig, params: Params, x: torch.Tensor):
    if cfg.tie_embeddings:
        return x @ params["embed"].to(cfg.tdtype).T
    return x @ params["head"].to(cfg.tdtype)


def hidden(cfg: ModelConfig, params: Params, tokens: torch.Tensor, *,
           collect_kv: bool = False):
    """Final-normed hidden states (B, S, d) and, with collect_kv, one
    ((L, B, S, Hkv, hd) k, v) pair per segment."""
    check_supported(cfg)
    x = embed_tokens(cfg, params, tokens)
    bsz, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None].expand(bsz, s)
    rope = rope_tables(positions, cfg.hd, cfg.rope_theta)
    kvs = []
    for seg in params["segments"]:
        sp = _segment_params(seg)
        ks, vs = [], []
        for lp in _layers(sp):
            x, (k, v) = layer_fwd(cfg, lp, x, rope)
            if collect_kv:
                ks.append(k)
                vs.append(v)
        kvs.append((torch.stack(ks), torch.stack(vs)) if collect_kv else None)
    return apply_norm(cfg, params["final_norm"], x), kvs


def forward(cfg: ModelConfig, params: Params, tokens: torch.Tensor, *,
            collect_kv: bool = False):
    """Logits (B, S, V); with collect_kv, (logits, hidden, kvs) as the JAX
    `forward(collect_kv=True)` returns."""
    x, kvs = hidden(cfg, params, tokens, collect_kv=collect_kv)
    logits = unembed(cfg, params, x)
    if collect_kv:
        return logits, x, kvs
    return logits


# ---------------------------------------------------------------------------
# KV cache + decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device: torch.device | str = "cpu", dtype=None) -> Params:
    check_supported(cfg)
    dt = dtype or cfg.tdtype
    shape = (cfg.n_layers, batch, max_len, cfg.kv_heads, cfg.hd)
    return {"segments": [{"k": torch.zeros(shape, dtype=dt, device=device),
                          "v": torch.zeros(shape, dtype=dt, device=device)}],
            "index": torch.zeros((), dtype=torch.int32, device=device)}


def init_paged_cache(cfg: ModelConfig, num_pages: int, page_size: int, *,
                     device: torch.device | str = "cpu", dtype=None) -> list:
    """Per-segment KV page pools (L, num_pages, page_size, Hkv, hd); page
    0 is the null page every unused page-table entry points at."""
    check_supported(cfg)
    dt = dtype or cfg.tdtype
    shape = (cfg.n_layers, num_pages, page_size, cfg.kv_heads, cfg.hd)
    return [{"k": torch.zeros(shape, dtype=dt, device=device),
             "v": torch.zeros(shape, dtype=dt, device=device)}]


def prefill(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
            max_len: int):
    """Run the prompt, fill a dense cache: (last-token logits, cache)."""
    x, kvs = hidden(cfg, params, tokens, collect_kv=True)
    bsz, s = tokens.shape
    cache = init_cache(cfg, bsz, max_len, device=tokens.device)
    for (k, v), seg in zip(kvs, cache["segments"]):
        seg["k"][:, :, :s] = k.to(seg["k"].dtype)
        seg["v"][:, :, :s] = v.to(seg["v"].dtype)
    cache["index"] = torch.tensor(s, dtype=torch.int32, device=tokens.device)
    return unembed(cfg, params, x[:, -1:]), cache


def _decode_attn(cfg: ModelConfig, p: Params, x: torch.Tensor,
                 K: torch.Tensor, V: torch.Tensor, index: torch.Tensor,
                 rope, mask: torch.Tensor):
    """One-token attention against the cache; writes the token's k/v into
    K/V (B, C, Hkv, hd) in place at slot index[b].  x: (B, 1, d); rope:
    `rope_tables` of the positions index; mask (B, C): cache slot j is
    attended iff j <= index[b]."""
    bsz = x.shape[0]
    dt = cfg.tdtype
    q, k, v = _qkv(cfg, p, x)
    q, k = apply_rope(q, rope), apply_rope(k, rope)
    rows = torch.arange(bsz, device=x.device)
    K[rows, index] = k[:, 0].to(K.dtype)
    V[rows, index] = v[:, 0].to(V.dtype)
    n_rep = cfg.n_heads // cfg.kv_heads
    Kr = K.to(dt).repeat_interleave(n_rep, dim=2) if n_rep > 1 else K.to(dt)
    Vr = V.to(dt).repeat_interleave(n_rep, dim=2) if n_rep > 1 else V.to(dt)
    scores = torch.einsum("bqhd,bchd->bhqc", q, Kr).float() / math.sqrt(cfg.hd)
    scores = scores.masked_fill(~mask[:, None, None, :], -1e30)
    probs = torch.softmax(scores, dim=-1).to(dt)
    o = torch.einsum("bhqc,bchd->bqhd", probs, Vr)
    return o.reshape(bsz, 1, cfg.q_dim) @ p["wo"].to(dt)


def decode_step(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                cache: Params):
    """One decode step. tokens: (B, 1) int.  cache["index"] is a scalar
    (uniform lengths) or a (B,) vector (per-slot lengths).  Returns
    (logits (B, 1, V), cache) with the cache advanced in place and
    index + 1."""
    check_supported(cfg)
    raw = torch.as_tensor(cache["index"], device=tokens.device)
    index = raw.expand(tokens.shape[0]) if raw.dim() == 0 else raw
    index = index.long()
    rope = rope_tables(index[:, None], cfg.hd, cfg.rope_theta)
    x = embed_tokens(cfg, params, tokens)
    for seg, seg_cache in zip(params["segments"], cache["segments"]):
        sp = _segment_params(seg)
        ks, vs = seg_cache["k"].unbind(0), seg_cache["v"].unbind(0)
        mask = torch.arange(ks[0].shape[1], device=x.device)[None, :] \
            <= index[:, None]
        for lp, K, V in zip(_layers(sp), ks, vs):
            a = _decode_attn(cfg, lp["attn"], apply_norm(cfg, lp["norm1"], x),
                             K, V, index, rope, mask)
            x, h = apply_norm_residual(cfg, lp["norm2"], x, a)
            x = x + mlp_block(cfg, lp["mlp"], h)
    x = apply_norm(cfg, params["final_norm"], x)
    return unembed(cfg, params, x), {"segments": cache["segments"],
                                     "index": raw + 1}

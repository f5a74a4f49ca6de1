"""Plain float32 reference of the Llama / Mistral family as the
configuration file states it (published keys): grouped-query attention
with rotate-half RoPE, over a sliding window where `sliding_window` is
set (query i sees keys i - window < j <= i), RMSNorm, SwiGLU MLPs and an
untied head.  Query head j * n_rep + r reads key-value head j.  Weights
are read by the serving engine's paths (`chipbench/layouts/
transformer.py`); a norm's gain is stored as its offset from 1.
"""
from __future__ import annotations

import torch

from ._ops import Mm, attention, matmul, rmsnorm, rope, swiglu


def _attn(cfg: dict, p: dict, i: int, x: torch.Tensor, pos: torch.Tensor, mm: Mm):
    s = x.shape[0]
    h, hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg["hidden_size"] // h
    theta = cfg["rope_theta"]
    q = rope(mm(x, p["wq"][i]).reshape(s, h, hd), pos, theta)
    k = rope(mm(x, p["wk"][i]).reshape(s, hkv, hd), pos, theta)
    v = mm(x, p["wv"][i]).reshape(s, hkv, hd)
    k, v = (t.repeat_interleave(h // hkv, dim=1) for t in (k, v))
    o = attention(q, k, v, window=cfg.get("sliding_window"))
    return mm(o.reshape(s, h * hd), p["wo"][i])


def logits(cfg: dict, w: dict, tokens: torch.Tensor, n_prompt: int, *,
           mm: Mm = matmul) -> torch.Tensor:
    """Float32 logits (S - n_prompt + 1, V) at positions n_prompt - 1 ..
    S - 1 of `tokens` (S,), the predictions of the served tokens."""
    eps = cfg["rms_norm_eps"]
    pos = torch.arange(tokens.shape[0], device=tokens.device)
    x = w["embed"][tokens].float()
    for seg in w["segments"]:
        (_, p), = seg.items()
        for i in range(p["norm1"]["scale"].shape[0]):
            x = x + _attn(cfg, p["attn"], i, rmsnorm(x, p["norm1"]["scale"][i], eps), pos, mm)
            h = rmsnorm(x, p["norm2"]["scale"][i], eps)
            m = p["mlp"]
            x = x + swiglu(h, m["w_gate"][i], m["w_in"][i], m["w_out"][i], mm)
    x = rmsnorm(x[n_prompt - 1:], w["final_norm"]["scale"], eps)
    return mm(x, w["head"])

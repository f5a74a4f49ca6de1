"""`repro_torch`'s transformer: the program's model config of a
configuration file (`model_config`, from its published keys), and the
weights as the serving engine takes them (`leaves`: each leaf's path,
shape and the standard deviation it is drawn with).  `harness/weights.py`
draws them; the reference reads them by the same paths.

Layout (the engine's): {"embed": (V, d), "final_norm": {"scale": (d,)},
"head": (d, V), "segments": [{"kind_dense" | "kind_moe": layers}]}, each
segment's layers stacked on a leading axis.  RMSNorm gains are stored as
offsets from 1 (the layer multiplies by 1 + scale).

Scales (the benchmark's choice; random weights stand in for trained
ones): the embedding N(0, 1); a matrix N(0, 1 / fan_in), fan_in its
input width (an expert's d or f, not the expert count); the query
projection (wq, MLA's wuq) twice that, so the scores spread with a
standard deviation of about 2 and each head attends sharply to a few
positions, far ones included; the attention output wo at 1 / fan_in;
the MLP's and the experts' output projections at half; the norms' gains
1 + N(0, 0.1^2); the router N(0, 1 / d).  Every sublayer then adds a
tenth to a fifth of the residual's size, so every layer moves the
logits.
"""
from __future__ import annotations

import math

NORM_STD = 0.1
Q_GAIN = 2.0
OUT_GAIN = 0.5


def _mat(fan_in: int, gain: float = 1.0) -> float:
    return gain / math.sqrt(fan_in)


def _mlp(prefix: tuple, n: int, d: int, f: int) -> list:
    return [(prefix + ("w_in",), (n, d, f), _mat(d)),
            (prefix + ("w_gate",), (n, d, f), _mat(d)),
            (prefix + ("w_out",), (n, f, d), _mat(f, OUT_GAIN))]


def _layers(cfg, seg: tuple, kind: str, n: int) -> list:
    d, h, hd = cfg.d_model, cfg.n_heads, cfg.hd
    out = [(seg + ("norm1", "scale"), (n, d), NORM_STD),
           (seg + ("norm2", "scale"), (n, d), NORM_STD)]
    a = seg + ("attn",)
    if cfg.use_mla:
        qr, kvr, rd = cfg.mla_q_rank, cfg.mla_kv_rank, cfg.mla_rope_dim
        out += [(a + ("wdq",), (n, d, qr), _mat(d)),
                (a + ("q_norm", "scale"), (n, qr), NORM_STD),
                (a + ("wuq",), (n, qr, h * (hd + rd)), _mat(qr, Q_GAIN)),
                (a + ("wdkv",), (n, d, kvr + rd), _mat(d)),
                (a + ("kv_norm", "scale"), (n, kvr), NORM_STD),
                (a + ("wuk",), (n, kvr, h * hd), _mat(kvr)),
                (a + ("wuv",), (n, kvr, h * hd), _mat(kvr)),
                (a + ("wo",), (n, h * hd, d), _mat(h * hd))]
    else:
        kv = cfg.kv_heads * hd
        out += [(a + ("wq",), (n, d, h * hd), _mat(d, Q_GAIN)),
                (a + ("wk",), (n, d, kv), _mat(d)),
                (a + ("wv",), (n, d, kv), _mat(d)),
                (a + ("wo",), (n, h * hd, d), _mat(h * hd))]
    if kind == "moe":
        e, f = cfg.n_experts, cfg.routed_ff
        m = seg + ("moe",)
        out += [(m + ("router",), (n, d, e), _mat(d)),
                (m + ("experts_in",), (n, e, d, f), _mat(d)),
                (m + ("experts_gate",), (n, e, d, f), _mat(d)),
                (m + ("experts_out",), (n, e, f, d), _mat(f, OUT_GAIN))]
        if cfg.n_shared_experts:
            out += _mlp(m + ("shared",), n, d, f * cfg.n_shared_experts)
    else:
        out += _mlp(seg + ("mlp",), n, d, cfg.d_ff)
    return out


def model_config(cfg: dict):
    """The `ModelConfig` of a Llama / Mistral configuration file: its
    published keys (SwiGLU MLPs, no attention bias, grouped-query
    attention over a sliding window where `sliding_window` is set), the
    weights stored in `torch_dtype`."""
    from repro_torch.models.config import ModelConfig

    if cfg["hidden_act"] != "silu" or cfg.get("attention_bias"):
        raise ValueError("the transformer layout covers SwiGLU MLPs without attention bias")
    dtype = cfg["torch_dtype"]
    mc = ModelConfig(
        name=cfg["name"], family="transformer", n_layers=cfg["num_hidden_layers"],
        d_model=cfg["hidden_size"], n_heads=cfg["num_attention_heads"],
        kv_heads=cfg["num_key_value_heads"],
        head_dim=cfg["hidden_size"] // cfg["num_attention_heads"],
        d_ff=cfg["intermediate_size"], vocab=cfg["vocab_size"], swiglu=True,
        window=cfg.get("sliding_window"), rope_theta=float(cfg["rope_theta"]),
        norm_eps=cfg["rms_norm_eps"], tie_embeddings=cfg["tie_word_embeddings"],
        dtype=dtype, param_dtype=dtype)
    mc.validate()
    return mc


def leaves(cfg) -> list[tuple[tuple, tuple, float]]:
    """[(path, shape, std)] of every leaf, for a `repro_torch` transformer
    config (`ModelConfig`) with SwiGLU MLPs, no QKV bias, untied
    embeddings and no MTP head."""
    if cfg.qkv_bias or not cfg.swiglu or cfg.tie_embeddings or cfg.mtp:
        raise ValueError("the layout covers SwiGLU, bias-free, untied models "
                         "without an MTP head")
    d, v = cfg.d_model, cfg.vocab
    out = [(("embed",), (v, d), 1.0), (("final_norm", "scale"), (d,), NORM_STD),
           (("head",), (d, v), _mat(d))]
    first = cfg.first_dense_layers if cfg.use_moe else cfg.n_layers
    kinds = [("dense", first)] + ([("moe", cfg.n_layers - first)] if cfg.use_moe else [])
    for i, (kind, n) in enumerate(k for k in kinds if k[1] > 0):
        out += _layers(cfg, ("segments", i, f"kind_{kind}"), kind, n)
    return out

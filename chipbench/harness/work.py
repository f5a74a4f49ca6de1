"""Frozen work counts: the operations and bytes a kernel call needs, the
model FLOPs of a token, and the H100's data-sheet peaks.

Peaks: one NVIDIA H100 SXM (data sheet, dense, at its 700 W limit):
989 TFLOP/s in bf16 on the tensor cores and 3.35 TB/s of HBM3.  A
roofline time is the larger of FLOPs over the first and bytes over the
second; each input byte is read once and each output byte written once.
"""
from __future__ import annotations

PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def roofline_s(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_BF16_FLOPS, nbytes / HBM_BYTES_PER_S)


def fused_mlp(n: int, d: int, f: int, itemsize: int) -> tuple[float, float]:
    """(FLOPs, bytes) of one gated MLP over n rows: three products of
    2 n d f; the three weights once, x read and the output written."""
    return 6.0 * n * d * f, float(itemsize * (3 * d * f + 2 * n * d))


def moe_mlp(rows, d: int, f: int, itemsize: int) -> tuple[float, float]:
    """(FLOPs, bytes) of one grouped expert MLP whose experts hold
    `rows[e]` non-empty capacity rows: the rows' products, and the weights
    only of experts that hold a row."""
    r = sum(rows)
    used = sum(1 for x in rows if x > 0)
    return 6.0 * r * d * f, float(itemsize * (3 * used * d * f + 2 * r * d))


def matmul_params(cfg: dict) -> float:
    """Parameters a token multiplies by in one forward pass (published
    keys): attention projections, MLP or router + k routed experts + the
    shared ones, and the head."""
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    if cfg.get("kv_lora_rank"):
        qr, kvr = cfg["q_lora_rank"], cfg["kv_lora_rank"]
        nope, rd, vd = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
        attn = d * qr + qr * h * (nope + rd) + d * (kvr + rd) + kvr * h * (nope + vd) + h * vd * d
    else:
        hd = d // h
        attn = d * h * hd + 2 * d * cfg["num_key_value_heads"] * hd + h * hd * d
    dense = 3 * d * cfg["intermediate_size"]
    n = cfg["num_hidden_layers"]
    if cfg.get("n_routed_experts"):
        k, e, f = cfg["num_experts_per_tok"], cfg["n_routed_experts"], cfg["moe_intermediate_size"]
        first = cfg["first_k_dense_replace"]
        moe = d * e + (k + cfg["n_shared_experts"]) * 3 * d * f
        ffn = first * dense + (n - first) * moe
    else:
        ffn = n * dense
    return float(n * attn + ffn + d * cfg["vocab_size"])


def attention_flops_per_key(cfg: dict) -> float:
    """FLOPs of one query against one key over every layer: the scores and
    the weighted values, 2 H (d_qk + d_v) a layer."""
    h = cfg["num_attention_heads"]
    if cfg.get("kv_lora_rank"):
        dqk = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
        dv = cfg["v_head_dim"]
    else:
        dqk = dv = cfg["hidden_size"] // h
    return 2.0 * h * (dqk + dv) * cfg["num_hidden_layers"]


def _keys(position: int, window) -> int:
    return position + 1 if window is None else min(position + 1, window)


def model_flops(cfg: dict, prefills, positions) -> float:
    """Model FLOPs of prefills (prompt lengths) and decode steps (the
    position each read): 2 x matmul parameters a token, plus attention
    over the keys each token sees (causal within a prompt, capped at the
    sliding window)."""
    window = cfg.get("sliding_window")
    per_key = attention_flops_per_key(cfg)
    per_tok = 2.0 * matmul_params(cfg)
    keys = 0
    for s in prefills:
        if window is None or s <= window:
            keys += s * (s + 1) // 2
        else:
            keys += window * (window + 1) // 2 + (s - window) * window
    keys += sum(_keys(p, window) for p in positions)
    return per_tok * (sum(prefills) + len(positions)) + per_key * keys

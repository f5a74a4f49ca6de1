"""Whisper-style encoder-decoder of the port (from `repro.models.whisper`,
arXiv:2212.04356).

The conv frame frontend is a stub, as in the JAX package: callers pass
frame embeddings (B, T, d).  The backbone is whole: a bidirectional
encoder over the frames plus sinusoidal positions, a causal decoder with
learned positions (`dec_pos`, 8192 rows) and cross-attention over the
encoder output, LayerNorm and GELU, the unembedding tied to `embed`.

Params keep the JAX tree: `enc_layers` and `dec_layers` are lists of
per-layer dicts.  The cache is {"layers": [{"k", "v", "ck", "cv"}],
"index"}: per decoder layer the self-attention KV (B, max_len, H, hd)
and the cross-attention KV of the encoder window (B, enc_len, H, hd),
the batch on axis 0 of every leaf; "index" is a scalar or a per-slot
(B,) vector.  No hand-written kernel serves this family (the JAX
package's policy has no hook for it): everything is plain PyTorch.

Under a mesh (`parallel.sharding.use_mesh`) each rank holds its blocks
of the weights and runs tensor parallelism over "model"
(`sharding.tp_plan`): every attention (the encoder's, the decoder's self
and cross attention) on the rank's whole heads (wq / wk / wv and the
q / v biases column-parallel, `wo` row-parallel, then one all_reduce
before the output bias), the MLP on its f columns (`b_in` sliced, `w_out`
row-parallel, one all_reduce before `b_out`); the cross K and V are
computed from the replicated encoder output at the rank's heads; the
tied embedding is vocab-parallel where the vocab divides (whisper-base's
51,865 does not: replicated).  The cache holds the rank's heads.  A rank
may hold its weights in other blocks than its TP blocks
(`use_mesh(hold=)`): each layer gathers them while it runs
(`sharding.compute_tree`).
"""
from __future__ import annotations

import functools
import math
from typing import Any

import torch

from repro_torch.bridge import tree_to
from repro_torch.parallel import sharding

from .common import (attention, copy_if, cross_entropy, gelu, layernorm, maybe_remat,
                     normal, reduce_if, tp_plan, vocab_embed, vocab_in, vocab_logits)
from .config import ModelConfig

Params = Any

MAX_POS = 8192          # rows of the decoder's learned position table


def _head_dims(cfg: ModelConfig) -> tuple[int, int]:
    return cfg.n_heads, cfg.d_model // cfg.n_heads


# --- init -------------------------------------------------------------------

def _ln(cfg: ModelConfig, dev) -> Params:
    pd = cfg.tparam_dtype
    return {"scale": torch.ones((cfg.d_model,), dtype=pd, device=dev),
            "bias": torch.zeros((cfg.d_model,), dtype=pd, device=dev)}


def _init_attn(cfg: ModelConfig, gen: torch.Generator, cut, at: str) -> Params:
    d, pd, dev = cfg.d_model, cfg.tparam_dtype, gen.device
    sc = 0.02 / math.sqrt(2 * (cfg.n_layers + cfg.n_enc_layers))
    w = 1.0 / math.sqrt(d)
    return {"wq": cut(at + "wq", normal(gen, (d, d), w, pd)),
            "wk": cut(at + "wk", normal(gen, (d, d), w, pd)),
            "wv": cut(at + "wv", normal(gen, (d, d), w, pd)),
            "wo": cut(at + "wo", normal(gen, (d, d), sc, pd)),
            "bq": cut(at + "bq", torch.zeros((d,), dtype=pd, device=dev)),
            "bv": cut(at + "bv", torch.zeros((d,), dtype=pd, device=dev)),
            "bo": torch.zeros((d,), dtype=pd, device=dev)}


def _init_mlp(cfg: ModelConfig, gen: torch.Generator, cut, at: str) -> Params:
    d, f, pd, dev = cfg.d_model, cfg.d_ff, cfg.tparam_dtype, gen.device
    sc = 0.02 / math.sqrt(2 * (cfg.n_layers + cfg.n_enc_layers))
    return {"w_in": cut(at + "w_in", normal(gen, (d, f), 1.0 / math.sqrt(d), pd)),
            "b_in": torch.zeros((f,), dtype=pd, device=dev),
            "w_out": cut(at + "w_out", normal(gen, (f, d), sc, pd)),
            "b_out": torch.zeros((d,), dtype=pd, device=dev)}


def init_params(cfg: ModelConfig, gen: torch.Generator,
                device: torch.device | str = "cpu", *, mesh=None,
                hold: str = "tp") -> Params:
    """Weights of the JAX `init_params` tree, shapes and scales, drawn
    from `gen` on its own device and moved to `device`.  `mesh`: keep this
    rank's blocks only (`sharding.shard_params`' blocks of the whole draw
    under `hold`, bit for bit), each cut from its leaf as it is drawn."""
    pd, dev = cfg.tparam_dtype, gen.device
    cut = sharding.block_cutter(mesh, cfg, hold)

    enc = [{"ln1": _ln(cfg, dev), "attn": _init_attn(cfg, gen, cut, f"enc_layers/{i}/attn/"),
            "ln2": _ln(cfg, dev), "mlp": _init_mlp(cfg, gen, cut, f"enc_layers/{i}/mlp/")}
           for i in range(cfg.n_enc_layers)]
    dec = [{"ln1": _ln(cfg, dev),
            "self_attn": _init_attn(cfg, gen, cut, f"dec_layers/{i}/self_attn/"),
            "ln2": _ln(cfg, dev),
            "cross_attn": _init_attn(cfg, gen, cut, f"dec_layers/{i}/cross_attn/"),
            "ln3": _ln(cfg, dev), "mlp": _init_mlp(cfg, gen, cut, f"dec_layers/{i}/mlp/")}
           for i in range(cfg.n_layers)]
    params = {"embed": cut("embed", normal(gen, (cfg.vocab, cfg.d_model), 0.02, pd)),
              "dec_pos": normal(gen, (MAX_POS, cfg.d_model), 0.02, pd),
              "enc_ln": _ln(cfg, dev), "dec_ln": _ln(cfg, dev),
              "enc_layers": enc, "dec_layers": dec}
    return tree_to(params, device)


# --- blocks -----------------------------------------------------------------

def _sinusoid(s: int, d: int, dtype, device) -> torch.Tensor:
    pos = torch.arange(s, device=device, dtype=torch.float32)[:, None]
    i = torch.arange(d // 2, device=device, dtype=torch.float32)[None, :]
    ang = pos / torch.pow(torch.tensor(10000.0, device=device), 2 * i / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], -1).to(dtype)


def _ln_apply(x: torch.Tensor, p: Params) -> torch.Tensor:
    """LayerNorm at the JAX model's eps (1e-5, not cfg.norm_eps)."""
    return layernorm(x, p["scale"], p["bias"])


def _into_heads(cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """x entering the head shards (`copy_if` where the heads shard)."""
    plan = tp_plan(cfg)
    return copy_if(x, plan, plan is not None and plan.attn)


def _q(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    """q (B, S, heads, hd) at the rank's heads (all without a mesh)."""
    dt = cfg.tdtype
    hd = _head_dims(cfg)[1]
    x = _into_heads(cfg, x)
    return (x @ p["wq"].to(dt) + p["bq"].to(dt)).reshape(x.shape[0], x.shape[1], -1, hd)


def _kv(cfg: ModelConfig, p: Params, x: torch.Tensor):
    """k, v (B, S, heads, hd) of x (k has no bias, as in whisper)."""
    dt = cfg.tdtype
    hd = _head_dims(cfg)[1]
    b, s = x.shape[:2]
    x = _into_heads(cfg, x)
    k = (x @ p["wk"].to(dt)).reshape(b, s, -1, hd)
    v = (x @ p["wv"].to(dt) + p["bv"].to(dt)).reshape(b, s, -1, hd)
    return k, v


def _out(cfg: ModelConfig, p: Params, o: torch.Tensor) -> torch.Tensor:
    """o through `wo` (summed over "model" where the heads are sharded),
    then the output bias."""
    dt = cfg.tdtype
    plan = tp_plan(cfg)
    y = o.reshape(o.shape[0], o.shape[1], -1) @ p["wo"].to(dt)
    return reduce_if(y, plan, plan is not None and plan.attn) + p["bo"].to(dt)


def _mha(cfg: ModelConfig, p: Params, xq: torch.Tensor, xkv: torch.Tensor, *,
         causal: bool):
    """Multi-head attention of xq over xkv: (out, (k, v))."""
    k, v = _kv(cfg, p, xkv)
    o = attention(cfg, _q(cfg, p, xq), k, v, causal=causal)
    return _out(cfg, p, o), (k, v)


def _mlp(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    """GELU MLP; under a mesh on the rank's f columns (`b_in` sliced),
    summed before `b_out`."""
    dt = cfg.tdtype
    plan = tp_plan(cfg)
    sh = plan is not None and plan.mlp
    f0, fl = sharding.local_range(plan, cfg.d_ff, sh)
    x = copy_if(x, plan, sh)
    h = gelu(x @ p["w_in"].to(dt) + copy_if(p["b_in"], plan, sh)[f0:f0 + fl].to(dt))
    return reduce_if(h @ p["w_out"].to(dt), plan, sh) + p["b_out"].to(dt)


def _enc_attn(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    """An encoder layer's attention with its residual (the part the JAX
    encoder recomputes under remat)."""
    hn = _ln_apply(x, p["ln1"])
    return x + _mha(cfg, p["attn"], hn, hn, causal=False)[0]


def _embedding(cfg: ModelConfig, params: Params) -> torch.Tensor:
    """The tied embedding at this rank's TP block, gathered once a call
    where the rank holds another block (`sharding.compute_tree`), so the
    lookup's and the unembedding's gradients sum before it goes back."""
    return sharding.compute_tree(cfg, params["embed"], "embed")


def _embed(cfg: ModelConfig, emb: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return vocab_embed(emb.to(cfg.tdtype), tokens, tp_plan(cfg))


def _unembed(cfg: ModelConfig, emb: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    plan = tp_plan(cfg)
    return vocab_logits(vocab_in(x, plan) @ emb.to(cfg.tdtype).T, plan)


def encode(cfg: ModelConfig, params: Params, frames: torch.Tensor) -> torch.Tensor:
    """frames (B, T, d) -> the normed encoder output (B, T, d)."""
    dt = cfg.tdtype
    x = frames.to(dt) + _sinusoid(frames.shape[1], cfg.d_model, dt,
                                  frames.device)[None]
    attn = maybe_remat(functools.partial(_enc_attn, cfg), cfg)
    for i, p in enumerate(params["enc_layers"]):
        p = sharding.compute_tree(cfg, p, f"enc_layers/{i}")
        x = attn(p, x)
        x = x + _mlp(cfg, p["mlp"], _ln_apply(x, p["ln2"]))
    return _ln_apply(x, params["enc_ln"])


def decode_train(cfg: ModelConfig, params: Params, enc_out: torch.Tensor,
                 tokens: torch.Tensor):
    """The decoder over a whole token sequence: (logits (B, S, V), one
    ((k, v) self, (k, v) cross) pair a layer)."""
    dt = cfg.tdtype
    s = tokens.shape[1]
    emb = _embedding(cfg, params)
    x = _embed(cfg, emb, tokens) + params["dec_pos"][:s].to(dt)[None]
    kvs = []
    for i, p in enumerate(params["dec_layers"]):
        p = sharding.compute_tree(cfg, p, f"dec_layers/{i}")
        hn = _ln_apply(x, p["ln1"])
        a, self_kv = _mha(cfg, p["self_attn"], hn, hn, causal=True)
        x = x + a
        c, cross_kv = _mha(cfg, p["cross_attn"], _ln_apply(x, p["ln2"]), enc_out,
                           causal=False)
        x = x + c
        x = x + _mlp(cfg, p["mlp"], _ln_apply(x, p["ln3"]))
        kvs.append((self_kv, cross_kv))
    x = _ln_apply(x, params["dec_ln"])
    return _unembed(cfg, emb, x), kvs


def forward(cfg: ModelConfig, params: Params, frames: torch.Tensor,
            tokens: torch.Tensor) -> torch.Tensor:
    return decode_train(cfg, params, encode(cfg, params, frames), tokens)[0]


def loss_fn(cfg: ModelConfig, params: Params, batch: dict) -> torch.Tensor:
    """Cross-entropy of the decoder over batch {"embeds": frames,
    "tokens", "labels"}."""
    logits = forward(cfg, params, batch["embeds"], batch["tokens"])
    return cross_entropy(logits, batch["labels"])


# --- cache + decode -----------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, enc_len: int, *,
               device: torch.device | str = "cpu") -> Params:
    """Zero self KV (B, max_len, H, hd) and cross KV (B, enc_len, H, hd)
    for every decoder layer (under a mesh the rank's heads), and a scalar
    index."""
    h, hd = _head_dims(cfg)
    plan = tp_plan(cfg)
    h = sharding.local_range(plan, h, plan is not None and plan.attn)[1]
    dt = cfg.tdtype

    def z(n):
        return torch.zeros((batch, n, h, hd), dtype=dt, device=device)

    layers = [{"k": z(max_len), "v": z(max_len), "ck": z(enc_len), "cv": z(enc_len)}
              for _ in range(cfg.n_layers)]
    return {"layers": layers,
            "index": torch.zeros((), dtype=torch.int32, device=device)}


def prefill(cfg: ModelConfig, params: Params, frames: torch.Tensor,
            tokens: torch.Tensor, max_len: int):
    """Encode the frames, run the decoder prompt and fill the self and
    cross caches: (last-token logits (B, 1, V), cache)."""
    enc = encode(cfg, params, frames)
    logits, kvs = decode_train(cfg, params, enc, tokens)
    b, s = tokens.shape
    cache = init_cache(cfg, b, max_len, enc.shape[1], device=tokens.device)
    for ((k, v), (ck, cv)), lc in zip(kvs, cache["layers"]):
        lc["k"][:, :s] = k.to(lc["k"].dtype)
        lc["v"][:, :s] = v.to(lc["v"].dtype)
        lc["ck"].copy_(ck)
        lc["cv"].copy_(cv)
    cache["index"] = torch.tensor(s, dtype=torch.int32, device=tokens.device)
    return logits[:, -1:], cache


def _softmax_attend(q: torch.Tensor, K: torch.Tensor, V: torch.Tensor,
                    mask: torch.Tensor | None, dt) -> torch.Tensor:
    """One query (B, 1, H, hd) over K/V (B, C, H, hd); mask (B, C)."""
    sc = torch.einsum("bqhd,bchd->bhqc", q, K.to(dt)).float() / math.sqrt(q.shape[-1])
    if mask is not None:
        sc = sc.masked_fill(~mask[:, None, None, :], -1e30)
    pr = torch.softmax(sc, dim=-1).to(dt)
    return torch.einsum("bhqc,bchd->bqhd", pr, V.to(dt))


def decode_step(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                cache: Params):
    """One decoder token against the self cache and the cross KV: tokens
    (B, 1); cache["index"] a scalar or a per-slot (B,) vector.  The
    token's self k/v are written in place at index[b]; returns (logits
    (B, 1, V), cache) with index + 1."""
    dt = cfg.tdtype
    raw = torch.as_tensor(cache["index"], device=tokens.device)
    b = tokens.shape[0]
    index = (raw.expand(b) if raw.dim() == 0 else raw).long()
    rows = torch.arange(b, device=tokens.device)
    emb = _embedding(cfg, params)
    x = _embed(cfg, emb, tokens) + params["dec_pos"][index].to(dt)[:, None]
    for i, (p, lc) in enumerate(zip(params["dec_layers"], cache["layers"])):
        p = sharding.compute_tree(cfg, p, f"dec_layers/{i}")
        hn = _ln_apply(x, p["ln1"])
        q, (k, v) = _q(cfg, p["self_attn"], hn), _kv(cfg, p["self_attn"], hn)
        K, V = lc["k"], lc["v"]
        K[rows, index] = k[:, 0].to(K.dtype)
        V[rows, index] = v[:, 0].to(V.dtype)
        mask = torch.arange(K.shape[1], device=K.device)[None] <= index[:, None]
        x = x + _out(cfg, p["self_attn"], _softmax_attend(q, K, V, mask, dt))
        q = _q(cfg, p["cross_attn"], _ln_apply(x, p["ln2"]))
        x = x + _out(cfg, p["cross_attn"],
                     _softmax_attend(q, lc["ck"], lc["cv"], None, dt))
        x = x + _mlp(cfg, p["mlp"], _ln_apply(x, p["ln3"]))
    x = _ln_apply(x, params["dec_ln"])
    return _unembed(cfg, emb, x), {"layers": cache["layers"], "index": raw + 1}

"""RecurrentGemma-style hybrid (Griffin) of the port (from
`repro.models.rglru`): RG-LRU recurrent blocks with a cyclic
[rec, rec, local-attn] pattern.

Temporal mixing per layer is either
  * a recurrent block: two linear branches to `lru_width`; branch 1 goes
    through a short causal depthwise conv, then the RG-LRU diagonal
    recurrence h_t = a_t*h_{t-1} + sqrt(1-a_t^2)*(i_t*x_t) with
    a_t = exp(-c * softplus(L) * r_t); branch 2 is a GELU gate;
  * or sliding-window MQA attention, decoding through a ring-buffer KV
    cache of min(max_len, window) positions.

The recurrence is the `rglru_scan` op from h0 (zeros at prefill, the
cached h at decode): the CUDA kernel on the card, the plain sequential
loop on the CPU.  The JAX model runs an associative scan with h0 folded
into b_0; the function is the same.

Params keep the JAX tree (a heterogeneous layer list: "rec" or "attn"
beside "norm1", "norm2" and "mlp"; `lam` float32).  The cache is
{"layers": [{"h", "conv"} or {"k", "v"}], "index"} with the batch on
axis 0 of every leaf; `decode_step` writes the new token's k/v into the
ring tensors it is given (in place) and returns them.

Under a mesh (`parallel.sharding.use_mesh`) each rank holds its blocks
of the weights and runs tensor parallelism over "model"
(`sharding.tp_plan`): a recurrent block's `w_x` and `w_gate` give the
rank's lru channels, the depthwise conv runs on them (`conv_w`,
`conv_b`, `lam` sliced), the gates' `wa` and `wx_in` read the whole
conv output (one all_gather) and give the rank's channels, `rglru_scan`
runs at w / tp channels and `w_out` is row-parallel (one all_reduce);
the attention layers run on whole heads where they split (else
replicated), the MLP column- then row-parallel (one all_reduce), the
tied embedding vocab-parallel.  The cache holds the rank's channels of
`h` and the conv window and its KV heads of the ring.  A rank may hold
its weights in other blocks than its TP blocks (`use_mesh(hold=)`): each
layer gathers them while it runs (`sharding.compute_tree`).
"""
from __future__ import annotations

import functools
import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.bridge import tree_to
from repro_torch.kernels.rglru_scan import ops as sops
from repro_torch.parallel import sharding

from .common import (NEG_INF, apply_norm, apply_rope, attention, cross_entropy, dense,
                     copy_if, gather_if, gelu, init_norm, maybe_remat, normal, reduce_if,
                     rope_tables, tp_plan, vocab_embed, vocab_in, vocab_logits)
from .config import ModelConfig

Params = Any
RGLRU_C = 8.0


def is_attn_layer(cfg: ModelConfig, i: int) -> bool:
    return (i % cfg.attn_every) == cfg.attn_every - 1


def _width(cfg: ModelConfig) -> int:
    return cfg.lru_width or cfg.d_model


# --- init -------------------------------------------------------------------

def _init_rec(cfg: ModelConfig, gen: torch.Generator, cut) -> Params:
    d, w, pd = cfg.d_model, _width(cfg), cfg.tparam_dtype
    return {"w_x": cut("rec/w_x", dense(gen, (d, w), pd)),
            "w_gate": cut("rec/w_gate", dense(gen, (d, w), pd)),
            "conv_w": normal(gen, (cfg.conv_width, w), 0.1, pd),
            "conv_b": torch.zeros((w,), dtype=pd),
            "wa": cut("rec/wa", dense(gen, (w, w), pd)),
            "wx_in": cut("rec/wx_in", dense(gen, (w, w), pd)),
            "lam": torch.rand((w,), generator=gen, device=gen.device) * 0.5 + 0.4,
            "w_out": cut("rec/w_out",
                         dense(gen, (w, d), pd, 0.02 / math.sqrt(2 * cfg.n_layers)))}


def _init_attn(cfg: ModelConfig, gen: torch.Generator, cut) -> Params:
    d, qd, kvd, pd = cfg.d_model, cfg.q_dim, cfg.kv_dim, cfg.tparam_dtype
    return {"wq": cut("attn/wq", dense(gen, (d, qd), pd)),
            "wk": cut("attn/wk", dense(gen, (d, kvd), pd)),
            "wv": cut("attn/wv", dense(gen, (d, kvd), pd)),
            "wo": cut("attn/wo", dense(gen, (qd, d), pd, 0.02 / math.sqrt(2 * cfg.n_layers)))}


def _init_mlp(cfg: ModelConfig, gen: torch.Generator, cut) -> Params:
    d, f, pd = cfg.d_model, cfg.d_ff, cfg.tparam_dtype
    return {"w_in": cut("mlp/w_in", dense(gen, (d, f), pd)),
            "w_gate": cut("mlp/w_gate", dense(gen, (d, f), pd)),
            "w_out": cut("mlp/w_out",
                         dense(gen, (f, d), pd, 0.02 / math.sqrt(2 * cfg.n_layers)))}


def init_params(cfg: ModelConfig, gen: torch.Generator,
                device: torch.device | str = "cpu", *, mesh=None,
                hold: str = "tp") -> Params:
    """Weights of the JAX `init_params` tree, shapes, scales and dtypes,
    drawn from `gen` on its own device and moved to `device`.  Embeddings are
    tied (the unembed is x @ embed.T).  `mesh`: keep this rank's blocks
    only (`sharding.shard_params`' blocks of the whole draw under `hold`,
    bit for bit), each cut from its leaf as it is drawn."""
    block = sharding.block_cutter(mesh, cfg, hold)
    layers = []
    for i in range(cfg.n_layers):
        def cut(path, t, at=f"layers/{i}/"):
            return block(at + path, t)
        p = {"norm1": init_norm(cfg), "norm2": init_norm(cfg),
             "mlp": _init_mlp(cfg, gen, cut)}
        if is_attn_layer(cfg, i):
            p["attn"] = _init_attn(cfg, gen, cut)
        else:
            p["rec"] = _init_rec(cfg, gen, cut)
        layers.append(p)
    params = {"embed": block("embed", normal(gen, (cfg.vocab, cfg.d_model), 0.02,
                                             cfg.tparam_dtype)),
              "final_norm": init_norm(cfg), "layers": layers}
    return tree_to(params, device)


# --- RG-LRU block -----------------------------------------------------------

def _rglru_coeffs(cfg: ModelConfig, p: Params, x: torch.Tensor, plan=None,
                  c0: int = 0):
    """x: (B, S, w) after the conv (under a mesh the rank's channels from
    c0, gathered whole for the gates' products).  Returns float32 (a, b)
    with h_t = a_t h_{t-1} + b_t."""
    dt = cfg.tdtype
    sh = plan is not None and plan.rec
    # gathered whole, then into the gates' column shards (`copy_if`)
    xf = copy_if(gather_if(x, plan, sh), plan, sh)
    r = torch.sigmoid((xf @ p["wa"].to(dt)).float())
    i = torch.sigmoid((xf @ p["wx_in"].to(dt)).float())
    log_a = -RGLRU_C * F.softplus(copy_if(p["lam"], plan, sh)[c0:c0 + x.shape[-1]]) * r
    a = torch.exp(log_a)
    gated = i * x.float()
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) * gated
    return a, b


def causal_conv(cfg: ModelConfig, p: Params, x: torch.Tensor,
                state: torch.Tensor | None = None, c0: int = 0, plan=None):
    """Short depthwise causal conv. x (B, S, w) (the channels from c0 of
    `conv_w` / `conv_b`, which enter through `copy_if` under `plan`'s
    sharded recurrence); state (B, cw-1, w): the last cw-1 inputs before
    x.  Returns (out, new state)."""
    cw = cfg.conv_width
    w = x.shape[2]
    sh = plan is not None and plan.rec
    cwt = copy_if(p["conv_w"], plan, sh)[:, c0:c0 + w]
    cb = copy_if(p["conv_b"], plan, sh)[c0:c0 + w]
    pad = state.to(x.dtype) if state is not None else \
        x.new_zeros((x.shape[0], cw - 1, w))
    xp = torch.cat([pad, x], dim=1)
    s = x.shape[1]
    out = xp[:, 0:s] * cwt[0].to(x.dtype)
    for i in range(1, cw):
        out = out + xp[:, i:i + s] * cwt[i].to(x.dtype)
    new_state = xp[:, -(cw - 1):] if cw > 1 else pad
    return out + cb.to(x.dtype), new_state


def rec_block(cfg: ModelConfig, p: Params, x: torch.Tensor,
              state: Params | None = None):
    """state: {"h": (B, w) float32, "conv": (B, cw-1, w)}, or None at
    prefill (h0 = 0); under a mesh the rank's channels, and the output
    summed over "model"."""
    dt = cfg.tdtype
    plan = tp_plan(cfg)
    sh = plan is not None and plan.rec
    x = copy_if(x, plan, sh)
    u = x @ p["w_x"].to(dt)
    g = gelu(x @ p["w_gate"].to(dt))
    c0 = sharding.local_range(plan, _width(cfg), sh)[0]
    u, conv_state = causal_conv(cfg, p, u, None if state is None else state["conv"], c0,
                                plan)
    a, b = _rglru_coeffs(cfg, p, u, plan, c0)
    h0 = torch.zeros_like(a[:, 0]) if state is None else state["h"]
    h = sops.rglru_scan(a, b, h0)
    y = (h.to(dt) * g) @ p["w_out"].to(dt)
    return reduce_if(y, plan, sh), {"h": h[:, -1], "conv": conv_state}


# --- attention and MLP ------------------------------------------------------

def _qkv(cfg: ModelConfig, p: Params, x: torch.Tensor):
    """q, k, v (B, S, heads, hd) at the rank's heads (all without a mesh;
    x enters the head shards through `copy_if`)."""
    bsz, s, _ = x.shape
    dt = cfg.tdtype
    plan = tp_plan(cfg)
    x = copy_if(x, plan, plan is not None and plan.attn)
    return ((x @ p["wq"].to(dt)).reshape(bsz, s, -1, cfg.hd),
            (x @ p["wk"].to(dt)).reshape(bsz, s, -1, cfg.hd),
            (x @ p["wv"].to(dt)).reshape(bsz, s, -1, cfg.hd))


def _attn_out(cfg: ModelConfig, p: Params, o: torch.Tensor) -> torch.Tensor:
    """o (B, S, heads, hd) through `wo`, summed over "model" where the
    attention runs on head shards."""
    plan = tp_plan(cfg)
    y = o.reshape(o.shape[0], o.shape[1], -1) @ p["wo"].to(cfg.tdtype)
    return reduce_if(y, plan, plan is not None and plan.attn)


def attn_full(cfg: ModelConfig, p: Params, x: torch.Tensor, rope):
    """Prefill attention: causal within the window.  Returns (out, (k, v))
    with k/v (B, S, Hkv, hd)."""
    q, k, v = _qkv(cfg, p, x)
    q, k = apply_rope(q, rope), apply_rope(k, rope)
    o = attention(cfg, q, k, v, causal=True)
    return _attn_out(cfg, p, o), (k, v)


def mlp(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    """GeGLU MLP; under a mesh on the rank's f columns, summed."""
    dt = cfg.tdtype
    plan = tp_plan(cfg)
    x = copy_if(x, plan, plan is not None and plan.mlp)
    h = gelu(x @ p["w_gate"].to(dt)) * (x @ p["w_in"].to(dt))
    return reduce_if(h @ p["w_out"].to(dt), plan, plan is not None and plan.mlp)


# --- forward / decode -------------------------------------------------------

def _embedding(cfg: ModelConfig, params: Params) -> torch.Tensor:
    """The tied embedding at this rank's TP block, gathered once a call
    where the rank holds another block (`sharding.compute_tree`), so the
    lookup's and the unembedding's gradients sum before it goes back."""
    return sharding.compute_tree(cfg, params["embed"], "embed")


def _embed(cfg: ModelConfig, emb: torch.Tensor, tokens: torch.Tensor):
    """Embedding (`_embedding`) times sqrt(d_model), the scale rounded to
    the model dtype first (as JAX's weakly typed scalar is)."""
    x = vocab_embed(emb.to(cfg.tdtype), tokens, tp_plan(cfg))
    return x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype,
                            device=x.device)


def unembed(cfg: ModelConfig, emb: torch.Tensor, x: torch.Tensor):
    plan = tp_plan(cfg)
    return vocab_logits(vocab_in(x, plan) @ emb.to(cfg.tdtype).T, plan)


def _layer(cfg: ModelConfig, i: int, p: Params, x: torch.Tensor, rope):
    """Layer i over a whole sequence: (x out, its state), from this rank's
    held leaves, gathered to their TP blocks first
    (`sharding.compute_tree`; inside the remat body the backward gathers
    again)."""
    p = sharding.compute_tree(cfg, p, f"layers/{i}")
    hn = apply_norm(cfg, p["norm1"], x)
    if is_attn_layer(cfg, i):
        a, st = attn_full(cfg, p["attn"], hn, rope)
    else:
        a, st = rec_block(cfg, p["rec"], hn)
    x = x + a
    return x + mlp(cfg, p["mlp"], apply_norm(cfg, p["norm2"], x)), st


def hidden(cfg: ModelConfig, params: Params, tokens: torch.Tensor, emb: torch.Tensor):
    """Final-normed hidden states (B, S, d) and the per-layer states: a
    (k, v) pair for attention layers, {"h", "conv"} for recurrent ones;
    `emb`: `_embedding`."""
    x = _embed(cfg, emb, tokens)
    bsz, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None].expand(bsz, s)
    rope = rope_tables(positions, cfg.hd, cfg.rope_theta)
    states = []
    for i, p in enumerate(params["layers"]):
        x, st = maybe_remat(functools.partial(_layer, cfg, i), cfg)(p, x, rope)
        states.append(st)
    return apply_norm(cfg, params["final_norm"], x), states


def forward(cfg: ModelConfig, params: Params, tokens: torch.Tensor, *,
            collect_state: bool = False):
    emb = _embedding(cfg, params)
    x, states = hidden(cfg, params, tokens, emb)
    logits = unembed(cfg, emb, x)
    if collect_state:
        return logits, states
    return logits


def loss_fn(cfg: ModelConfig, params: Params, batch: dict) -> torch.Tensor:
    return cross_entropy(forward(cfg, params, batch["tokens"]), batch["labels"])


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device: torch.device | str = "cpu") -> Params:
    """Recurrent layers: h (B, w) float32 and the conv window (B, cw-1, w);
    attention layers: a ring of clen = min(max_len, window) k/v slots.
    Under a mesh the rank's channels and KV heads."""
    plan = tp_plan(cfg)
    w = sharding.local_range(plan, _width(cfg), plan is not None and plan.rec)[1]
    hkv = sharding.local_range(plan, cfg.kv_heads, plan is not None and plan.attn)[1]
    clen = min(max_len, cfg.window or max_len)
    dt = cfg.tdtype

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    layers = []
    for i in range(cfg.n_layers):
        if is_attn_layer(cfg, i):
            shape = (batch, clen, hkv, cfg.hd)
            layers.append({"k": zeros(shape, dt), "v": zeros(shape, dt)})
        else:
            layers.append({"h": zeros((batch, w), torch.float32),
                           "conv": zeros((batch, cfg.conv_width - 1, w), dt)})
    return {"layers": layers, "index": zeros((), torch.int32)}


def _decode_attn(cfg: ModelConfig, p: Params, x: torch.Tensor, lc: Params,
                 index: torch.Tensor, rope):
    """One cached-attention step for x (B, 1, d) at per-slot positions
    index (B,): writes the token's k/v at ring slot index % clen in place
    and attends the positions the ring still holds inside the window."""
    bsz = x.shape[0]
    dt = cfg.tdtype
    q, k, v = _qkv(cfg, p, x)
    q, k = apply_rope(q, rope), apply_rope(k, rope)
    K, V = lc["k"], lc["v"]
    clen = K.shape[1]
    rows = torch.arange(bsz, device=x.device)
    slot = index % clen
    K[rows, slot] = k[:, 0].to(K.dtype)
    V[rows, slot] = v[:, 0].to(V.dtype)
    n_rep = q.shape[2] // K.shape[2]
    Kr = K.to(dt).repeat_interleave(n_rep, dim=2) if n_rep > 1 else K.to(dt)
    Vr = V.to(dt).repeat_interleave(n_rep, dim=2) if n_rep > 1 else V.to(dt)
    sc = torch.einsum("bqhd,bchd->bhqc", q, Kr).float() / math.sqrt(cfg.hd)
    pos1 = index[:, None]
    j = torch.arange(clen, device=x.device)[None]
    kpos = pos1 - torch.remainder(pos1 - j, clen)        # (B, clen)
    mask = (kpos >= 0) & (kpos <= pos1)
    if cfg.window:
        mask &= kpos > pos1 - cfg.window
    sc = sc.masked_fill(~mask[:, None, None, :], NEG_INF)
    pr = torch.softmax(sc, dim=-1).to(dt)
    o = torch.einsum("bhqc,bchd->bqhd", pr, Vr)
    return _attn_out(cfg, p, o), {"k": K, "v": V}


def decode_step(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                cache: Params):
    """tokens (B, 1).  cache["index"] is a scalar or a per-slot (B,)
    vector.  Returns (logits (B, 1, V), cache with index + 1)."""
    raw = torch.as_tensor(cache["index"], device=tokens.device)
    index = (raw.expand(tokens.shape[0]) if raw.dim() == 0 else raw).long()
    rope = rope_tables(index[:, None], cfg.hd, cfg.rope_theta)
    emb = _embedding(cfg, params)
    x = _embed(cfg, emb, tokens)
    new_layers = []
    for i, (p, lc) in enumerate(zip(params["layers"], cache["layers"])):
        p = sharding.compute_tree(cfg, p, f"layers/{i}")
        hn = apply_norm(cfg, p["norm1"], x)
        if is_attn_layer(cfg, i):
            a, nc = _decode_attn(cfg, p["attn"], hn, lc, index, rope)
        else:
            a, nc = rec_block(cfg, p["rec"], hn, state=lc)
        x = x + a
        x = x + mlp(cfg, p["mlp"], apply_norm(cfg, p["norm2"], x))
        new_layers.append(nc)
    x = apply_norm(cfg, params["final_norm"], x)
    return unembed(cfg, emb, x), {"layers": new_layers, "index": raw + 1}


def prefill(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
            max_len: int):
    """Run the prompt and fill a fresh cache: (last-token logits (B, 1, V),
    cache).  Attention layers keep the last clen positions, placed so
    position p sits at ring slot p % clen.  Only the last position is
    unembedded."""
    s = tokens.shape[1]
    emb = _embedding(cfg, params)
    x, states = hidden(cfg, params, tokens, emb)
    cache = init_cache(cfg, tokens.shape[0], max_len, device=tokens.device)
    clen = min(max_len, cfg.window or max_len)
    take = min(s, clen)
    for i, st in enumerate(states):
        if not is_attn_layer(cfg, i):
            cache["layers"][i] = st
            continue
        for name, src in zip(("k", "v"), st):        # (B, S, Hkv, hd)
            last = src[:, s - take:s]
            dst = cache["layers"][i][name]
            if take < clen:
                dst[:, :take] = last.to(dst.dtype)
            else:
                dst.copy_(torch.roll(last, shifts=s % clen, dims=1))
    cache["index"] = torch.tensor(s, dtype=torch.int32, device=tokens.device)
    return unembed(cfg, emb, x[:, -1:]), cache

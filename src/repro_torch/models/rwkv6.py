"""RWKV6 "Finch" of the port (from `repro.models.rwkv6`): attention-free,
with a data-dependent per-channel decay.

Time mixing, per head (key index i, value index j):
    o_t[j] = sum_i r_t[i] * (S_{t-1}[i,j] + u[i] * k_t[i] * v_t[j])
    S_t[i,j] = w_t[i] * S_{t-1}[i,j] + k_t[i] * v_t[j]
with w_t = exp(-exp(w0 + lora_w(x~_t))), token-shift interpolation on
the inputs and a per-head groupnorm + SiLU gate on the output.  The
recurrence is the `wkv6` op for every sequence length, prefill and
decode alike: the CUDA kernel on the card, on the CPU the plain version
(sequential for one token, chunked otherwise, as the JAX model switches).

Params keep the JAX tree, names and dtypes (`w0`, `u` float32); layers
are a list.  The state is {"layers": [{"shift_att", "wkv", "shift_ffn"}],
"index"}, with the batch on axis 0 of every leaf.

Under a mesh (`parallel.sharding.use_mesh`) each rank holds its blocks
of the weights (`init_params(mesh=)` or `sharding.shard_params`) and
runs tensor parallelism over "model" (`sharding.tp_plan`): the time mix
on its whole heads (r, k, v, g column-parallel, the LoRA decay on its
channels' columns of `wb`, `w0` / `u` / `gn_scale` sliced to its
channels and heads, `wkv6` at H / tp heads, `wo` row-parallel then one
all_reduce), the channel mix's key on its f columns and value
row-parallel (one all_reduce) and its receptance on its d columns,
gathered whole (one all_gather) before the gate; the embedding and head
vocab-parallel.  A layer's collectives: two all_reduces and one
all_gather.  The state holds the rank's heads of `wkv`; the token shifts
stay whole (the residual stream is replicated).  Where the heads do not
split whole over "model" but the head dim does (`TPPlan.keys`), every
rank runs every head of the time mix and the WKV recurrence on its block
of each head's key dim (the state split as JAX's `cache_shardings`
splits it), the output summed over "model".  A rank may hold its
weights in other blocks than its TP blocks (`use_mesh(hold=)`): each
layer gathers them while it runs (`sharding.compute_tree`).
"""
from __future__ import annotations

import functools
import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.bridge import tree_to
from repro_torch.kernels.wkv6 import ops as wops
from repro_torch.parallel import sharding

from .common import (copy_if, cross_entropy, dense, gather_if, maybe_remat, normal,
                     reduce_if, rmsnorm, tp_plan, vocab_embed, vocab_in, vocab_logits)
from .config import ModelConfig

Params = Any


def n_heads(cfg: ModelConfig) -> int:
    return cfg.d_model // cfg.hd


# --- init -------------------------------------------------------------------

def _init_layer(cfg: ModelConfig, gen: torch.Generator, cut, at: str) -> Params:
    """One layer's leaves, each drawn whole and passed through
    `cut(at + path, leaf)` (a mesh rank keeps its block)."""
    d, f, r = cfg.d_model, cfg.d_ff, cfg.wkv_lora
    pd = cfg.tparam_dtype
    out_scale = 0.02 / math.sqrt(2 * cfg.n_layers)
    h = n_heads(cfg)

    def full(val):
        return torch.full((d,), val, dtype=pd)

    att = {"mu_r": full(0.5), "mu_k": full(0.5), "mu_v": full(0.5),
           "mu_g": full(0.5), "mu_w": full(0.5),
           "wr": cut(at + "att/wr", dense(gen, (d, d), pd)),
           "wk": cut(at + "att/wk", dense(gen, (d, d), pd)),
           "wv": cut(at + "att/wv", dense(gen, (d, d), pd)),
           "wg": cut(at + "att/wg", dense(gen, (d, d), pd)),
           "wo": cut(at + "att/wo", dense(gen, (d, d), pd, out_scale)),
           "w0": torch.rand((d,), generator=gen, device=gen.device) * 2.0 - 1.0,
           "wa": dense(gen, (d, r), pd), "wb": dense(gen, (r, d), pd, 0.01),
           "u": normal(gen, (h, cfg.hd), 0.1, torch.float32),
           "gn_scale": torch.ones((h, cfg.hd), dtype=pd)}
    ffn = {"mu_k": full(0.5), "mu_r": full(0.5),
           "wk": cut(at + "ffn/wk", dense(gen, (d, f), pd)),
           "wv": cut(at + "ffn/wv", dense(gen, (f, d), pd, out_scale)),
           "wr": cut(at + "ffn/wr", dense(gen, (d, d), pd))}
    return {"ln1": torch.zeros((d,), dtype=pd), "ln2": torch.zeros((d,), dtype=pd),
            "att": att, "ffn": ffn}


def init_params(cfg: ModelConfig, gen: torch.Generator,
                device: torch.device | str = "cpu", *, mesh=None,
                hold: str = "tp") -> Params:
    """Weights of the JAX `init_params` tree, shapes, scales and dtypes,
    drawn from `gen` on its own device and moved to `device`.  `mesh`:
    keep this rank's blocks only (`sharding.shard_params`' blocks of the
    whole draw under `hold`, bit for bit), each cut from its leaf as it
    is drawn."""
    pd = cfg.tparam_dtype
    cut = sharding.block_cutter(mesh, cfg, hold)
    layers = [_init_layer(cfg, gen, cut, f"layers/{i}/") for i in range(cfg.n_layers)]
    params = {"embed": cut("embed", normal(gen, (cfg.vocab, cfg.d_model), 0.02, pd)),
              "final_norm": torch.zeros((cfg.d_model,), dtype=pd),
              "head": cut("head", normal(gen, (cfg.d_model, cfg.vocab), 0.02, pd)),
              "layers": layers}
    return tree_to(params, device)


# --- blocks -----------------------------------------------------------------

def _shift(x: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """Token shift: the previous position's value. prev: (B, 1, d)."""
    return torch.cat([prev.to(x.dtype), x[:, :-1]], dim=1)


def _groupnorm(o: torch.Tensor, scale: torch.Tensor, eps: float = 64e-5):
    """Per-head norm over the last axis, population variance (as
    `jnp.var`)."""
    mu = o.mean(-1, keepdim=True)
    var = o.var(-1, keepdim=True, unbiased=False)
    return (o - mu) * torch.rsqrt(var + eps) * scale[None, None]


def time_mix(cfg: ModelConfig, p: Params, x: torch.Tensor,
             shift_prev: torch.Tensor, s0: torch.Tensor):
    """x: (B, S, d).  Returns (out, (last_x, s_final)); under a mesh the
    rank's heads run (`s0` holds them) and `out` is summed over "model",
    or, where the heads do not split whole (`TPPlan.keys`), every head
    runs on the rank's block of its key dim (`s0` (B, H, hd / tp, hd))
    and the WKV output is summed over "model"."""
    dt = cfg.tdtype
    hd = cfg.hd
    b, s, d = x.shape
    plan = tp_plan(cfg)
    sh = plan is not None and plan.attn
    keys = plan is not None and plan.keys
    c0, dl = sharding.local_range(plan, d, sh)         # this rank's channels
    h0, h = c0 // hd, dl // hd                         # and heads
    xx = _shift(x, shift_prev)

    def mix(mu):
        return x + (xx - x) * mu.to(dt)

    # each mixed input enters the head shards (`copy_if`), past the
    # replicated mixing weights; so does the decay's low-rank hidden
    xr, xk, xv, xg = (copy_if(mix(p[m]), plan, sh) for m in ("mu_r", "mu_k", "mu_v", "mu_g"))
    xw = mix(p["mu_w"])
    r = (xr @ p["wr"].to(dt)).reshape(b, s, h, hd).float()
    k = (xk @ p["wk"].to(dt)).reshape(b, s, h, hd).float()
    v = (xv @ p["wv"].to(dt)).reshape(b, s, h, hd).float()
    g = F.silu(xg @ p["wg"].to(dt))
    # data-dependent decay (the Finch mechanism), its log as the JAX
    # model takes it: log(max(w, 1e-12)) of the float32 w
    dw = copy_if(torch.tanh(xw @ p["wa"].to(dt)), plan, sh) \
        @ copy_if(p["wb"], plan, sh)[:, c0:c0 + dl].to(dt)
    w = torch.exp(-torch.exp(copy_if(p["w0"], plan, sh)[c0:c0 + dl] + dw.float()))
    logw = torch.log(torch.clamp(w, min=1e-12)).reshape(b, s, h, hd)
    u = copy_if(p["u"], plan, sh)[h0:h0 + h]
    if keys:
        # the rank's block of each head's key dim: o sums over it
        kb = hd // plan.tp
        k0 = plan.mesh.coord("model") * kb
        r, k, logw, u = (copy_if(t, plan, True)[..., k0:k0 + kb] for t in (r, k, logw, u))
        v = copy_if(v, plan, True)
    o, s_fin = wops.wkv6_bshd(r, k, v, logw, u, s0, chunk=cfg.wkv_chunk)
    o = reduce_if(o, plan, keys)
    o = _groupnorm(o.to(dt), copy_if(p["gn_scale"], plan, sh)[h0:h0 + h].to(dt))
    o = (o.reshape(b, s, dl) * g) @ p["wo"].to(dt)
    return reduce_if(o, plan, sh), (x[:, -1:], s_fin)


def channel_mix(cfg: ModelConfig, p: Params, x: torch.Tensor,
                shift_prev: torch.Tensor):
    """Under a mesh: the key on the rank's f columns, the value
    row-parallel and summed, the receptance on its d columns gathered."""
    dt = cfg.tdtype
    plan = tp_plan(cfg)
    xx = _shift(x, shift_prev)
    xk = copy_if(x + (xx - x) * p["mu_k"].to(dt), plan, plan is not None and plan.mlp)
    xr = copy_if(x + (xx - x) * p["mu_r"].to(dt), plan, plan is not None and plan.gate)
    kk = torch.square(torch.relu(xk @ p["wk"].to(dt)))
    val = reduce_if(kk @ p["wv"].to(dt), plan, plan is not None and plan.mlp)
    rec = gather_if(torch.sigmoid(xr @ p["wr"].to(dt)), plan, plan is not None and plan.gate)
    return rec * val, x[:, -1:]


def _layer(cfg: ModelConfig, p: Params, x: torch.Tensor, st: Params):
    a, (sh_att, s_fin) = time_mix(
        cfg, p["att"], rmsnorm(x, p["ln1"], cfg.norm_eps),
        st["shift_att"], st["wkv"])
    x = x + a
    c, sh_ffn = channel_mix(cfg, p["ffn"], rmsnorm(x, p["ln2"], cfg.norm_eps),
                            st["shift_ffn"])
    return x + c, {"shift_att": sh_att, "wkv": s_fin, "shift_ffn": sh_ffn}


# --- state, forward, serving entry points ----------------------------------

def init_state(cfg: ModelConfig, batch: int, *,
               device: torch.device | str = "cpu") -> Params:
    """Zero state; under a mesh `wkv` holds the rank's heads, or every
    head's block of its key dim (`TPPlan.keys`)."""
    hd = cfg.hd
    plan = tp_plan(cfg)
    h = sharding.local_range(plan, n_heads(cfg), plan is not None and plan.attn)[1]
    kd = hd // plan.tp if plan is not None and plan.keys else hd

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    layers = [{"shift_att": zeros((batch, 1, cfg.d_model), cfg.tdtype),
               "wkv": zeros((batch, h, kd, hd), torch.float32),
               "shift_ffn": zeros((batch, 1, cfg.d_model), cfg.tdtype)}
              for _ in range(cfg.n_layers)]
    return {"layers": layers, "index": zeros((), torch.int32)}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device: torch.device | str = "cpu") -> Params:
    """The recurrent state; its size does not depend on max_len."""
    return init_state(cfg, batch, device=device)


def _held_layer(cfg: ModelConfig, i: int, p: Params, x: torch.Tensor, st: Params):
    """`_layer` i from this rank's held leaves, gathered to their TP blocks
    first (`sharding.compute_tree`; inside the remat body the backward
    gathers again)."""
    return _layer(cfg, sharding.compute_tree(cfg, p, f"layers/{i}"), x, st)


def hidden(cfg: ModelConfig, params: Params, tokens: torch.Tensor, *,
           state: Params | None = None):
    """Final-normed hidden states (B, S, d) and the advanced state."""
    emb = sharding.compute_tree(cfg, params["embed"], "embed")
    x = vocab_embed(emb.to(cfg.tdtype), tokens, tp_plan(cfg))
    st = state or init_state(cfg, tokens.shape[0], device=tokens.device)
    new_layers = []
    for i, (p, ls) in enumerate(zip(params["layers"], st["layers"])):
        x, ns = maybe_remat(functools.partial(_held_layer, cfg, i), cfg)(p, x, ls)
        new_layers.append(ns)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return x, {"layers": new_layers, "index": st["index"] + tokens.shape[1]}


def unembed(cfg: ModelConfig, params: Params, x: torch.Tensor):
    plan = tp_plan(cfg)
    head = sharding.compute_tree(cfg, params["head"], "head")
    return vocab_logits(vocab_in(x, plan) @ head.to(cfg.tdtype), plan)


def forward(cfg: ModelConfig, params: Params, tokens: torch.Tensor, *,
            state: Params | None = None, collect_state: bool = False):
    x, new_state = hidden(cfg, params, tokens, state=state)
    logits = unembed(cfg, params, x)
    if collect_state:
        return logits, new_state
    return logits


def loss_fn(cfg: ModelConfig, params: Params, batch: dict) -> torch.Tensor:
    return cross_entropy(forward(cfg, params, batch["tokens"]), batch["labels"])


def _held_state(cfg: ModelConfig, state: Params, back: bool) -> Params:
    """`state`'s `wkv` leaves moved from their held blocks to the time
    mix's (`back`: the other way round) under a held layout
    (`use_mesh(hold=)` "jax" / "fsdp": JAX's `cache_shardings` holds
    `wkv` on its key dim where the time mix holds whole heads);
    `state` itself where the two agree."""
    layouts = sharding.state_layouts(cfg, state["layers"][0]["wkv"].shape[0],
                                     {"wkv": (n_heads(cfg), cfg.hd, cfg.hd)})
    if layouts is None:
        return state
    return dict(state, layers=[sharding.move_state(ls, layouts, back)
                               for ls in state["layers"]])


def prefill(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
            max_len: int = 0):
    """(last-token logits (B, 1, V), state).  Only the last position is
    unembedded: the others' logits are never read."""
    x, state = hidden(cfg, params, tokens)
    return unembed(cfg, params, x[:, -1:]), _held_state(cfg, state, back=True)


def decode_step(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                cache: Params):
    """One token per row: (logits (B, 1, V), advanced state).  The cache
    tensors are not written; the state returned is new, held as the
    cache was (`_held_state`)."""
    x, state = hidden(cfg, params, tokens, state=_held_state(cfg, cache, back=False))
    return unembed(cfg, params, x), _held_state(cfg, state, back=True)

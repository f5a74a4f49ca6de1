"""Decoder-only transformer of the port (from `repro.models.transformer`):
GQA attention with or without QKV bias, RMSNorm or LayerNorm, RoPE or
Qwen2-VL's M-RoPE, SwiGLU/GELU MLP, tied or separate embeddings, a
vision-stub `embeds` prefix, sliding-window attention over a ring KV
cache, DeepSeek-V3's MLA (latent KV cache, absorbed one-token decode) and
capacity-routed top-k MoE layers (shared experts and leading dense
layers included).

Params keep the JAX tree and layout: each segment's layer weights are
stacked on a leading axis under `segments[i]["kind_dense"]` or
`["kind_moe"]`, and the layers run in a Python loop where JAX used
`lax.scan`, each under `maybe_remat`.  An MTP config also builds the JAX
`mtp` subtree (projection, norm, one dense layer); only `loss_fn` reads
it.  MoE dispatches by capacity over all tokens, by token group
(`moe_groups`) or, under a mesh, by explicit all-to-all
(`moe_shard_map`), as the JAX variants do.

Under a mesh (`parallel.sharding.use_mesh`, which the serving engine
enters) each rank holds its blocks of the weights (drawn by
`init_params(mesh=)` or cut by `sharding.shard_params`) and runs tensor
parallelism over the mesh's "model" axis (`sharding.tp_plan`):
attention on its whole heads (head counts are read off the local
weights) with a row-parallel `wo`, the MLP column- then row-parallel,
MoE by experts (EP) or on f, the embedding vocab-parallel; each sharded
part ends in one `all_reduce` (the unembedding in an `all_gather` of the
vocab shards) and, under autograd, starts at a `copy_to` of what enters
it.  Training, and a serving state whose slots split over "data", split
the batch's rows over "data" (`use_mesh(data_split=True)`): the capacity
route then runs over the rows gathered from every data rank (in the
serving step's lane order where it gives `lanes`).  A serving state
whose one slot's cache length splits over "data" decodes under
`use_mesh(seq_split=True)`: each rank attends over its block of the
cache and the partial softmaxes combine exactly over "data".  A cache
whose length splits over "model" (MLA's latent, as JAX's
`cache_shardings` places it; a GQA cache whose KV heads do not split,
with `cache_seq_shard`) decodes under `use_mesh(seq_split="model")` by
the same combine over "model".  A rank may
hold its weights in other blocks than the TP blocks (`use_mesh(hold=)`:
JAX's table, or FSDP's blocks over the DP axes too): each layer, the
embedding and the head then gather their TP blocks as they run
(`sharding.compute_tree`).  With no mesh nothing changes.

Caches are updated in place (the JAX functions return fresh arrays):
`decode_step` writes the new token's k/v into the cache tensors it is
given and returns the same tensors, which saves a copy of the cache per
step; `paged_decode_step` writes into the page pools and attends from
them directly.
"""
from __future__ import annotations

import functools
import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.bridge import tree_map, tree_to
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.moe_mlp import ops as moe_ops
from repro_torch.parallel import collectives as coll
from repro_torch.parallel import sharding

from .common import (apply_norm, apply_norm_residual, apply_rope, attention, copy_if,
                     cross_entropy, cross_entropy_sum, gelu, global_count, init_norm,
                     maybe_remat, mlp_block, mrope_tables, normal, rmsnorm, rope_tables,
                     tp_plan, vocab_embed, vocab_in, vocab_logits)
from .config import ModelConfig

Params = Any


def check_supported(cfg: ModelConfig) -> None:
    """Raise for a config this module does not run (another family)."""
    if cfg.family != "transformer":
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family} is not a transformer")


_plan = tp_plan


def _attn_sum(cfg: ModelConfig, a: torch.Tensor) -> torch.Tensor:
    """The attention output summed over the "model" axis where the
    attention runs on head shards under the current mesh (its
    row-parallel `wo` gives partial sums); else a."""
    plan = _plan(cfg)
    return coll.all_reduce(a, plan.mesh) if plan is not None and plan.attn else a


def layer_segments(cfg: ModelConfig) -> list[tuple[str, int]]:
    """[(layer_kind, count)]: contiguous runs of identical structure."""
    if cfg.use_moe and cfg.first_dense_layers:
        return [("dense", cfg.first_dense_layers),
                ("moe", cfg.n_layers - cfg.first_dense_layers)]
    if cfg.use_moe:
        return [("moe", cfg.n_layers)]
    return [("dense", cfg.n_layers)]


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _whole(path: str, shape):
    """Keep a leaf whole: (its shape, the identity)."""
    return tuple(shape), lambda t: t


def _init_layers(cfg: ModelConfig, gen: torch.Generator, kind: str,
                 count: int, keep=_whole, at: str = "") -> Params:
    """`count` stacked layers of `kind`.  `keep(path, shape)`: (the shape
    kept of one layer's leaf at `at + path`, the function cutting it out
    of the layer's draw)."""
    pd = cfg.tparam_dtype
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    out_scale = 0.02 / math.sqrt(2 * cfg.n_layers)
    dev = gen.device

    def dense(path, shape, scale=None):
        """`count` layers of `shape`, each drawn in float32 and cast on its
        own, so no more than one float32 layer is held at a time (a
        mixtral expert tensor is 1.9 GB a layer in float32, deepseek-v3's
        15 GB); a float32 model's whole layers are drawn in place."""
        # the JAX dense_init's fan-in is the first axis, E for an expert
        # tensor (E, d, f)
        s = scale if scale is not None else 1.0 / math.sqrt(shape[0])
        local, cut = keep(at + path, shape)
        out = torch.empty((count, *local), dtype=pd, device=dev)
        for i in range(count):
            if pd == torch.float32 and local == tuple(shape):   # the same draw, into place
                torch.randn(shape, generator=gen, out=out[i]).mul_(s)
            else:
                out[i] = cut(normal(gen, shape, s, pd))
        return out

    def zeros(path, n):
        return torch.zeros((count, *keep(at + path, (n,))[0]), dtype=pd, device=dev)

    def mlp(path, f):
        p = {"w_in": dense(path + "/w_in", (d, f)),
             "w_out": dense(path + "/w_out", (f, d), out_scale)}
        if cfg.swiglu:
            p["w_gate"] = dense(path + "/w_gate", (d, f))
        return p

    if cfg.use_mla:
        rd, qr, kvr, hd = cfg.mla_rope_dim, cfg.mla_q_rank, cfg.mla_kv_rank, cfg.hd
        attn = {"wdq": dense("attn/wdq", (d, qr)), "q_norm": {"scale": zeros("attn/q_norm/scale", qr)},
                "wuq": dense("attn/wuq", (qr, cfg.n_heads * (hd + rd))),
                "wdkv": dense("attn/wdkv", (d, kvr + rd)),
                "kv_norm": {"scale": zeros("attn/kv_norm/scale", kvr)},
                "wuk": dense("attn/wuk", (kvr, cfg.n_heads * hd)),
                "wuv": dense("attn/wuv", (kvr, cfg.n_heads * hd)),
                "wo": dense("attn/wo", (qd, d), out_scale)}
    else:
        attn = {"wq": dense("attn/wq", (d, qd)), "wk": dense("attn/wk", (d, kvd)),
                "wv": dense("attn/wv", (d, kvd)), "wo": dense("attn/wo", (qd, d), out_scale)}
    if cfg.qkv_bias and not cfg.use_mla:
        attn.update(bq=zeros("attn/bq", qd), bk=zeros("attn/bk", kvd),
                    bv=zeros("attn/bv", kvd))
    layers = {"norm1": init_norm(cfg, (count,), dev), "attn": attn,
              "norm2": init_norm(cfg, (count,), dev)}
    if kind == "moe":
        e, f = cfg.n_experts, cfg.routed_ff
        moe = {"router": dense("moe/router", (d, e)),
               "experts_in": dense("moe/experts_in", (e, d, f)),
               "experts_out": dense("moe/experts_out", (e, f, d), out_scale)}
        if cfg.swiglu:
            moe["experts_gate"] = dense("moe/experts_gate", (e, d, f))
        if cfg.n_shared_experts:
            moe["shared"] = mlp("moe/shared", f * cfg.n_shared_experts)
        layers["moe"] = moe
    else:
        layers["mlp"] = mlp("mlp", cfg.d_ff)
    return layers


def init_params(cfg: ModelConfig, gen: torch.Generator,
                device: torch.device | str = "cpu", *, mesh=None,
                hold: str = "tp") -> Params:
    """Weights of the same tree, shapes and scales as the JAX
    `init_params` (the `mtp` subtree included), drawn from `gen` on its
    own device (a CPU generator gives the same weights on every machine)
    and moved to `device`.  `mesh`: keep this rank's blocks only
    (`sharding.shard_params`' blocks of the whole draw, bit for bit),
    each cut from a layer's leaf as it is drawn, so a rank holds its
    shards and one layer's leaf at most.  `hold`: the blocks a rank holds
    (`sharding.HOLDS`; "fsdp" is FSDP's), which the layers gather to their
    TP blocks while they run."""
    check_supported(cfg)
    pd = cfg.tparam_dtype

    def keep(path, shape):
        return _whole(path, shape) if mesh is None else \
            sharding.leaf_block(mesh, cfg, path, shape, hold=hold)

    def draw(path, shape, scale):
        return keep(path, shape)[1](normal(gen, shape, scale, pd))

    segments = [{f"kind_{kind}": _init_layers(cfg, gen, kind, count, keep,
                                              f"segments/{i}/kind_{kind}/")}
                for i, (kind, count) in enumerate(layer_segments(cfg))]
    params = {"embed": draw("embed", (cfg.vocab, cfg.d_model), 0.02),
              "final_norm": init_norm(cfg, (), gen.device),
              "segments": segments}
    if not cfg.tie_embeddings:
        params["head"] = draw("head", (cfg.d_model, cfg.vocab), 0.02)
    if cfg.mtp:
        layer = _init_layers(cfg, gen, "dense", 1, keep, "mtp/layer/")
        params["mtp"] = {
            "proj": draw("mtp/proj", (2 * cfg.d_model, cfg.d_model),
                         1.0 / math.sqrt(2 * cfg.d_model)),
            "norm": init_norm(cfg, (), gen.device),
            "layer": tree_map(lambda t: t[0], layer)}
    return tree_to(params, device)


def _segment(seg: Params) -> tuple[str, Params]:
    """("dense" | "moe", the segment's stacked layer tree)."""
    name, sp = next(iter(seg.items()))
    kind = name.removeprefix("kind_")
    if kind not in ("dense", "moe"):
        raise NotImplementedError(f"segment {name} is not ported yet")
    return kind, sp


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
    # local heads: a rank's shards hold whole heads
    return (q.reshape(bsz, s, -1, cfg.hd), k.reshape(bsz, s, -1, cfg.hd),
            v.reshape(bsz, s, -1, cfg.hd))


def rope_for(cfg: ModelConfig, positions: torch.Tensor,
             mrope_positions: torch.Tensor | None = None):
    """The rotation tables every layer shares for token positions (B, S):
    RoPE over hd, over MLA's rope slice of `mla_rope_dim`, or M-RoPE of
    three position streams (B, S) each, `mrope_positions` (3, B, S) where
    given and else the 1-D positions on all three, as the JAX
    `_rope_qk`."""
    if cfg.use_mla:
        return rope_tables(positions, cfg.mla_rope_dim, cfg.rope_theta)
    if cfg.mrope_sections is not None:
        mp = mrope_positions if mrope_positions is not None \
            else positions[None].expand(3, *positions.shape)
        return mrope_tables(mp, cfg.hd, cfg.rope_theta, cfg.mrope_sections)
    return rope_tables(positions, cfg.hd, cfg.rope_theta)


def _roped_qkv(cfg: ModelConfig, p: Params, x: torch.Tensor, rope):
    q, k, v = _qkv(cfg, p, x)
    return apply_rope(q, rope), apply_rope(k, rope), v


def _mla_q(cfg: ModelConfig, p: Params, x: torch.Tensor, rope):
    """MLA queries (B, S, H, hd) without and (B, S, H, rd) with rotation,
    through the normed q latent; `rmsnorm` is the plain RMSNorm, as the
    JAX `rmsnorm_latent` is."""
    bsz, s, _ = x.shape
    dt, hd = cfg.tdtype, cfg.hd
    plan = _plan(cfg)
    cq = rmsnorm(x @ p["wdq"].to(dt), p["q_norm"]["scale"], cfg.norm_eps)
    cq = copy_if(cq, plan, plan is not None and plan.attn)   # enters the head shards
    q = (cq @ p["wuq"].to(dt)).reshape(bsz, s, -1, hd + cfg.mla_rope_dim)
    return q[..., :hd], apply_rope(q[..., hd:], rope)


def _mla_latent(cfg: ModelConfig, p: Params, x: torch.Tensor, rope):
    """The latent cache entry (B, S, kv_rank + rd): the normed KV latent
    and the rotated shared rope key."""
    kvr = cfg.mla_kv_rank
    ckv_full = x @ p["wdkv"].to(cfg.tdtype)
    ckv = rmsnorm(ckv_full[..., :kvr], p["kv_norm"]["scale"], cfg.norm_eps)
    k_rope = apply_rope(ckv_full[:, :, None, kvr:], rope)[:, :, 0]
    return torch.cat([ckv, k_rope], -1)


def _mla_attn_block(cfg: ModelConfig, p: Params, x: torch.Tensor, rope):
    """MLA prefill: keys and values up-projected from the latent, the
    rope key shared by every head; q and k of width hd + rd, v of hd.
    Returns (out, {"latent": (B, S, kv_rank + rd)})."""
    bsz, s, _ = x.shape
    dt, hd, kvr = cfg.tdtype, cfg.hd, cfg.mla_kv_rank
    q_nope, q_rope = _mla_q(cfg, p, x, rope)
    h = q_nope.shape[2]
    lat = _mla_latent(cfg, p, x, rope)
    plan = _plan(cfg)
    latf = copy_if(lat, plan, plan is not None and plan.attn)  # enters the head shards
    ckv = latf[..., :kvr]
    k_nope = (ckv @ p["wuk"].to(dt)).reshape(bsz, s, h, hd)
    v = (ckv @ p["wuv"].to(dt)).reshape(bsz, s, h, hd)
    k_rope = latf[:, :, None, kvr:].expand(bsz, s, h, cfg.mla_rope_dim)
    o = attention(cfg, torch.cat([q_nope, q_rope], -1),
                  torch.cat([k_nope, k_rope], -1), v, causal=True)
    return o.reshape(bsz, s, -1) @ p["wo"].to(dt), {"latent": lat}


def attn_block(cfg: ModelConfig, p: Params, x: torch.Tensor, rope):
    """Full-sequence (prefill) attention: (out, the cache entries), k/v
    {"k", "v"} in cache layout (B, S, Hkv, hd), MLA {"latent"}.  rope:
    `rope_for` the positions.  Under a mesh, out is this rank's partial
    sum (the caller reduces it), and x enters the head shards through
    `copy_if` (MLA: its q latent and KV latent do, past the replicated
    down-projections)."""
    if cfg.use_mla:
        return _mla_attn_block(cfg, p, x, rope)
    bsz, s, _ = x.shape
    plan = _plan(cfg)
    q, k, v = _roped_qkv(cfg, p, copy_if(x, plan, plan is not None and plan.attn), rope)
    o = attention(cfg, q, k, v, causal=True)
    return o.reshape(bsz, s, -1) @ p["wo"].to(cfg.tdtype), {"k": k, "v": v}


def capacity(cfg: ModelConfig, n: int) -> int:
    """Slots each expert's buffer holds for n tokens: ceil(n k / E *
    capacity_factor), at least 8 and at most n, rounded up to 8."""
    cap = int(math.ceil(n * cfg.top_k / cfg.n_experts * cfg.capacity_factor))
    cap = max(8, min(cap, n))
    return (cap + 7) // 8 * 8


def route(cfg: ModelConfig, p: Params, xf: torch.Tensor):
    """Top-k routing of flat tokens xf (..., d): (weights (..., k)
    renormalised and cast to the model dtype, expert ids (..., k)).  The
    router runs in float32 (the JAX product promotes x); `torch.topk`
    gives the k experts in descending order, as `jax.lax.top_k` does."""
    probs = torch.softmax(xf.float() @ p["router"].float(), dim=-1)
    w, idx = torch.topk(probs, cfg.top_k, dim=-1)
    w = w / w.sum(-1, keepdim=True).clamp_min(1e-9)
    return w.to(cfg.tdtype), idx


def expert_mlp(cfg: ModelConfig, p: Params, buf: torch.Tensor) -> torch.Tensor:
    """The experts over their (E, cap, d) capacity buffers.
    cfg.mlp_impl == "fused" runs them as the grouped `moe_mlp` kernel
    (float32 accumulation); "dense" is batched products in the model
    dtype, as the JAX einsums."""
    dt = cfg.tdtype
    wi, wo = p["experts_in"].to(dt), p["experts_out"].to(dt)
    wg = p["experts_gate"].to(dt) if cfg.swiglu else None
    if cfg.mlp_impl == "fused":
        return moe_ops.moe_mlp(buf, wg, wi, wo, swiglu=cfg.swiglu)
    h = torch.bmm(buf, wi)
    h = F.silu(torch.bmm(buf, wg)) * h if cfg.swiglu else gelu(h)
    return torch.bmm(h, wo)


def _slots(cfg: ModelConfig, flat_idx: torch.Tensor, cap: int):
    """(slot, keep) of each (token, choice) along the last axis of
    flat_idx (..., n*k): the next free slot of its expert's buffer in
    flat order, clamped to the last slot and dropped past `cap`."""
    pos = F.one_hot(flat_idx, cfg.n_experts).cumsum(-2) - 1
    slot = pos.gather(-1, flat_idx[..., None])[..., 0]
    keep = slot < cap
    return torch.where(keep, slot, cap - 1), keep


def _local_experts(cfg: ModelConfig, p: Params, plan) -> int:
    """The first expert this rank holds: EP's shard start, else 0."""
    if plan is None or plan.moe != "ep":
        return 0
    return plan.mesh.coord("model") * p["experts_in"].shape[0]


def _combine(cfg: ModelConfig, p: Params, x: torch.Tensor, y: torch.Tensor,
             plan) -> torch.Tensor:
    """The routed output y (B, S, d), summed over "model" where the
    experts are sharded, plus the shared experts (a TP MLP of their own)."""
    if plan is not None and plan.moe:
        y = coll.all_reduce(y, plan.mesh)
    if cfg.n_shared_experts:
        mesh = plan.mesh if plan is not None and plan.shared else None
        y = y + mlp_block(cfg, p["shared"], x, mesh=mesh)
    return y


def _dp_size(plan) -> int:
    """The DP ranks the batch's rows are split over (1: the whole batch)."""
    return 1 if plan is None or plan.dp is None else sharding.axis_size(plan.mesh, plan.dp)


def _global_tokens(x: torch.Tensor, plan) -> torch.Tensor:
    """Every DP rank's rows of x (the global batch) where the rows are
    split: the capacity route numbers slots over all tokens, as GSPMD's
    global view does; in a serving step's lane order where the plan has
    lanes (`sharding.row_lanes`).  Each rank's downstream keeps its own
    rows, so the gather's backward sums over the ranks (reduce-scatter)."""
    if _dp_size(plan) == 1:
        return x
    g = coll.all_gather(x, plan.mesh, plan.dp, dim=0, backward="reduce_scatter")
    return g if plan.lanes is None else g.index_select(0, plan.lanes[0])


def _own_rows(y: torch.Tensor, plan, rows: int) -> torch.Tensor:
    """This DP rank's `rows` rows of a global-batch y (`_global_tokens`)."""
    if _dp_size(plan) == 1:
        return y
    if plan.lanes is not None:
        return y.index_select(0, plan.lanes[1])
    return y.narrow(0, plan.mesh.axis_rank(plan.dp) * rows, rows)


def _moe_inputs(plan, xf: torch.Tensor, w: torch.Tensor):
    """The tokens and routing weights entering sharded experts (`copy_if`:
    each rank combines only its experts' or its f columns' share, so
    their gradients are partial sums over "model")."""
    sh = plan is not None and bool(plan.moe)
    return copy_if(xf, plan, sh), copy_if(w, plan, sh)


def moe_block(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    """Capacity-based top-k MoE (Switch-style dense dispatch), the JAX
    `moe_block`: each (token, choice) in flat (token, k) order takes the
    next slot of its expert's buffer; past `capacity` it is dropped
    (clamped to the last slot and added as zeros).  `moe_shard_map` under
    a mesh takes `moe_block_shard_map`, `moe_groups` (when it divides
    the tokens) `moe_block_grouped`.

    Under a mesh with EP each rank runs its own experts over their rows of
    the buffer (`moe_mlp` at E / tp) and combines only the choices routed
    to them; with TP on f every expert runs on the rank's f columns; the
    partial outputs are summed by one all_reduce.  With the batch's rows
    split over DP ranks, the route runs over the global batch
    (`_global_tokens`) and each rank keeps its rows; a serving step's
    rows (`lanes`) are gathered in the step's lane order and run as one
    whole batch, by whichever dispatch the config takes."""
    plan = _plan(cfg)
    if plan is not None and plan.lanes is not None:
        xg = _global_tokens(x, plan)
        with sharding.use_mesh(plan.mesh):
            y = moe_block(cfg, p, xg)
        return _own_rows(y, plan, x.shape[0])
    if cfg.moe_shard_map and plan is not None:
        return moe_block_shard_map(cfg, p, x)
    if cfg.moe_groups > 0 and (x.shape[0] * x.shape[1] * _dp_size(plan)) \
            % cfg.moe_groups == 0:
        return moe_block_grouped(cfg, p, x)
    y = _moe_capacity(cfg, p, _global_tokens(x, plan), plan)
    return _combine(cfg, p, x, _own_rows(y, plan, x.shape[0]), plan)


def _moe_capacity(cfg: ModelConfig, p: Params, x: torch.Tensor, plan) -> torch.Tensor:
    """`moe_block`'s routed output (B, S, d) over x's tokens, before the
    sum over "model" and the shared experts."""
    bsz, s, d = x.shape
    n, k, e = bsz * s, cfg.top_k, cfg.n_experts
    dt = cfg.tdtype
    xf = x.reshape(n, d)
    w, idx = route(cfg, p, xf)
    xf, w = _moe_inputs(plan, xf, w)
    cap = capacity(cfg, n)
    flat_idx = idx.reshape(-1)                               # (n*k,)
    slot, keep = _slots(cfg, flat_idx, cap)
    vals = torch.where(keep[:, None], xf.repeat_interleave(k, dim=0), 0).to(dt)
    buf = torch.zeros((e, cap, d), dtype=dt, device=x.device)
    # each kept (expert, slot) receives exactly one value and the drops add
    # zeros, so the accumulation is exact in any order (the JAX .at[].add)
    buf.index_put_((flat_idx, slot), vals, accumulate=True)
    e0 = _local_experts(cfg, p, plan)
    el = p["experts_in"].shape[0]
    out = expert_mlp(cfg, p, buf[e0:e0 + el])
    mine = keep & (flat_idx >= e0) & (flat_idx < e0 + el)
    gathered = torch.where(mine[:, None], out[(flat_idx - e0).clamp(0, el - 1), slot], 0)
    y = (gathered.reshape(n, k, d) * w[..., None]).sum(1).to(dt)
    return y.reshape(bsz, s, d)


def moe_block_grouped(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    """The JAX `moe_block_grouped`: two-hop expert dispatch.  The n tokens
    split into `moe_groups` groups of m; each group fills its own
    capacity buffers (max(8, min(ceil(m k / E cf), m)) rounded up to 8
    slots an expert), the (G, E, cap, d) buffers are regrouped expert
    major, (E, G cap, d), the experts run once over all groups
    (`expert_mlp`: the `moe_mlp` kernel), and each group gathers its
    outputs back.  Under a mesh the experts shard as in `moe_block`.
    With the batch's rows split over D DP ranks, a rank's rows are G / D
    whole groups where D divides G (the groups are shard-local), else
    the groups run over the global batch (`_global_tokens`)."""
    plan = _plan(cfg)
    g, dsz = cfg.moe_groups, _dp_size(plan)
    n = x.shape[0] * x.shape[1] * dsz
    if g <= 0 or n % g:
        raise ValueError(f"moe_groups {g} does not divide {n} tokens")
    if g % dsz == 0:
        y = _moe_grouped(cfg, p, x, g // dsz, plan)
    else:
        y = _own_rows(_moe_grouped(cfg, p, _global_tokens(x, plan), g, plan), plan,
                      x.shape[0])
    return _combine(cfg, p, x, y, plan)


def _moe_grouped(cfg: ModelConfig, p: Params, x: torch.Tensor, g: int,
                 plan) -> torch.Tensor:
    """`moe_block_grouped`'s routed output (B, S, d) over x's tokens in
    `g` groups."""
    bsz, s, d = x.shape
    m = bsz * s // g
    k, e = cfg.top_k, cfg.n_experts
    dt = cfg.tdtype
    xf = x.reshape(g, m, d)
    w, idx = route(cfg, p, xf)                               # (g, m, k)
    xf, w = _moe_inputs(plan, xf, w)
    cap = int(math.ceil(m * k / e * cfg.capacity_factor))
    cap = max(8, min(cap, m))
    cap = (cap + 7) // 8 * 8
    flat_idx = idx.reshape(g, m * k)
    slot, keep = _slots(cfg, flat_idx, cap)
    vals = torch.where(keep[..., None], xf.repeat_interleave(k, dim=1), 0).to(dt)
    gix = torch.arange(g, device=x.device)[:, None].expand(g, m * k)
    buf = torch.zeros((g, e, cap, d), dtype=dt, device=x.device)
    buf.index_put_((gix, flat_idx, slot), vals, accumulate=True)
    e0 = _local_experts(cfg, p, plan)
    el = p["experts_in"].shape[0]
    bufe = buf[:, e0:e0 + el].transpose(0, 1).reshape(el, g * cap, d)
    outg = expert_mlp(cfg, p, bufe).reshape(el, g, cap, d).transpose(0, 1)
    mine = keep & (flat_idx >= e0) & (flat_idx < e0 + el)
    gathered = torch.where(mine[..., None],
                           outg[gix, (flat_idx - e0).clamp(0, el - 1), slot], 0)
    y = (gathered.reshape(g, m, k, d) * w[..., None]).sum(2).to(dt)
    return y.reshape(bsz, s, d)


EP_AXES = ("data", "model")
TOKEN_AXES = ("pod", "data", "model")


def moe_block_shard_map(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    """The JAX `moe_block_shard_map`: explicit expert parallelism.  The n
    tokens split over every axis of ("pod", "data", "model") the mesh has
    (n_tot ranks, nl = n / n_tot each); each rank routes its own and
    fills local capacity buffers (E, cap_l, d), cap_l = max(1, ceil(nl k
    / E cf)) (no floor of 8, no rounding); one all_to_all over ("data",
    "model") inside each pod ships each expert's rows to the rank that
    owns it (E / n_ep experts a rank, n_ep = data x model; the experts
    are replicated over "pod"), the local experts run over every pod
    rank's rows (`moe_mlp`), the inverse all_to_all brings the outputs
    home, each rank combines its tokens and the token stream is gathered
    back.  Falls back to `moe_block` where E % n_ep or n % n_tot, as JAX
    does.

    The experts are held sharded over "model" alone (EP, the param
    rules): rank (d, m) holds expert blocks m D .. m D + D - 1 of E / n_ep
    each and runs block m D + d, so the all_to_all sends block m D + d to
    the rank at (d, m), a fixed permutation of the JAX owner order that
    changes no value.

    With the batch's rows split over the DP axes ("pod", "data"; training,
    the multi-pod dry run), a rank's tokens are its model index's share
    of its own rows (the same global split: rank (p, d, m) holds global
    tokens ((p D + d) M + m) nl ..), and the stream is gathered over
    "model" alone.  Under autograd x and the router enter through
    `copy_to` over the axes the tokens split over, and where the rows are
    whole the held experts over the DP axes too (each data rank runs its
    own block of them)."""
    plan = _plan(cfg)
    mesh = plan.mesh
    names = tuple(mesh.axis_names)
    ep_axes = tuple(a for a in EP_AXES if a in names)
    all_axes = tuple(a for a in TOKEN_AXES if a in names)
    n_ep, n_tot = sharding.axis_size(mesh, ep_axes), sharding.axis_size(mesh, all_axes)
    msz = sharding.axis_size(mesh, "model")
    bsz, s, d = x.shape
    split = _dp_size(plan) > 1
    if split and _dp_size(plan) * msz != n_tot:
        raise NotImplementedError(f"moe_shard_map with the rows split over {plan.dp} "
                                  f"of a {dict(mesh.shape)} mesh")
    tok_axes = "model" if split else all_axes
    rep_axes = tuple(a for a in all_axes if a != "model")   # the held experts' copies
    n = bsz * s * _dp_size(plan)
    k, e = cfg.top_k, cfg.n_experts
    if e % n_ep or n % n_tot:
        return moe_block(cfg.replace(moe_shard_map=False), p, x)
    dt = cfg.tdtype
    el, nl = e // n_ep, n // n_tot
    cap_l = max(1, int(math.ceil(nl * k / e * cfg.capacity_factor)))
    me = mesh.axis_rank(tok_axes)
    xl = coll.copy_to(x, mesh, tok_axes).reshape(-1, d)[me * nl:(me + 1) * nl]
    w, idx = route(cfg, {"router": coll.copy_to(p["router"], mesh, tok_axes)}, xl)
    flat_idx = idx.reshape(-1)
    slot, keep = _slots(cfg, flat_idx, cap_l)
    buf = torch.zeros((e, cap_l, d), dtype=dt, device=x.device)
    buf.index_put_((flat_idx, slot),
                   torch.where(keep[:, None], xl.repeat_interleave(k, dim=0), 0).to(dt),
                   accumulate=True)
    # block b of el experts runs on the rank at (d, m) with b = m D + d
    dsz = sharding.axis_size(mesh, "data")
    owner_block = [(r % msz) * dsz + r // msz for r in range(n_ep)]
    order = torch.as_tensor(owner_block, device=x.device)
    recv = coll.all_to_all(buf.reshape(n_ep, el, cap_l, d)[order].reshape(e, cap_l, d),
                           mesh, ep_axes)
    # (n_ep sources, el, cap_l, d) -> this rank's experts over every source
    buf2 = recv.reshape(n_ep, el, cap_l, d).transpose(0, 1).reshape(el, n_ep * cap_l, d)
    held = mesh.coord("data") * el     # within the experts of the model shard
    pe = {key: (p[key] if split or not rep_axes
                else coll.copy_to(p[key], mesh, rep_axes))[held:held + el]
          for key in ("experts_in", "experts_out", "experts_gate") if key in p}
    oute = expert_mlp(cfg, pe, buf2)
    back = coll.all_to_all(
        oute.reshape(el, n_ep, cap_l, d).transpose(0, 1).reshape(e, cap_l, d),
        mesh, ep_axes)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(n_ep, device=x.device)
    back = back.reshape(n_ep, el, cap_l, d)[inv].reshape(e, cap_l, d)
    gathered = torch.where(keep[:, None], back[flat_idx, slot], 0)
    yl = (gathered.reshape(nl, k, d) * w[..., None]).sum(1).to(dt)
    y = coll.all_gather(yl, mesh, tok_axes, dim=0).reshape(bsz, s, d)
    if cfg.n_shared_experts:
        smesh = mesh if plan.shared else None
        y = y + mlp_block(cfg, p["shared"], x, mesh=smesh)
    return y


def _ffn(cfg: ModelConfig, kind: str, p: Params, h: torch.Tensor):
    if kind == "moe":
        return moe_block(cfg, p["moe"], h)
    plan = _plan(cfg)
    return mlp_block(cfg, p["mlp"], h,
                     mesh=plan.mesh if plan is not None and plan.mlp else None)


def _held_layer(cfg: ModelConfig, kind: str, at: str, p: Params, x: torch.Tensor, rope):
    """`layer_fwd` of one layer of the segment at `at` from this rank's
    held views `p`, gathered to its TP blocks first (`compute_tree`).
    Inside the remat body: the backward gathers again, and autograd keeps
    no gathered weight past its layer."""
    return layer_fwd(cfg, kind, sharding.compute_tree(cfg, p, at, layer=True), x, rope)


def layer_fwd(cfg: ModelConfig, kind: str, p: Params, x: torch.Tensor, rope):
    a, kv = attn_block(cfg, p["attn"], apply_norm(cfg, p["norm1"], x), rope)
    a = _attn_sum(cfg, a)
    # fused norm_impl runs the attn-residual add + norm2 as one kernel
    x, h = apply_norm_residual(cfg, p["norm2"], x, a)
    return x + _ffn(cfg, kind, p, h), kv


# ---------------------------------------------------------------------------
# Forward (prefill)
# ---------------------------------------------------------------------------

def embed_tokens(cfg: ModelConfig, params: Params, tokens: torch.Tensor):
    """Token embeddings; vocab-parallel under a mesh (`vocab_embed`)."""
    emb = sharding.compute_tree(cfg, params["embed"], "embed")
    return vocab_embed(emb.to(cfg.tdtype), tokens, _plan(cfg))


def unembed(cfg: ModelConfig, params: Params, x: torch.Tensor):
    """Logits (..., V); under a mesh with the vocab sharded, each rank's
    columns (rows of a tied embedding) and one all_gather of them."""
    plan = _plan(cfg)
    x = vocab_in(x, plan)
    if cfg.tie_embeddings:
        logits = x @ sharding.compute_tree(cfg, params["embed"], "embed").to(cfg.tdtype).T
    else:
        logits = x @ sharding.compute_tree(cfg, params["head"], "head").to(cfg.tdtype)
    return vocab_logits(logits, plan)


def hidden(cfg: ModelConfig, params: Params, tokens: torch.Tensor | None,
           *, collect_kv: bool = False, embeds: torch.Tensor | None = None,
           positions: torch.Tensor | None = None,
           mrope_positions: torch.Tensor | None = None):
    """Final-normed hidden states (B, S, d) and, with collect_kv, one dict
    a segment of the layers' cache entries stacked on a leading L axis
    ({"k", "v"} (L, B, S, Hkv, hd), MLA {"latent"} (L, B, S, kv_rank +
    rd)).  `embeds` (B, P, d), a modality-stub prefix, goes before the
    token embeddings, or replaces them when `tokens` is None; `positions`
    (B, S) default to 0 .. S-1 and `mrope_positions` (3, B, S) to those on
    every stream."""
    check_supported(cfg)
    if tokens is None:
        x = embeds.to(cfg.tdtype)
    else:
        x = embed_tokens(cfg, params, tokens)
        if embeds is not None:
            x = torch.cat([embeds.to(cfg.tdtype), x], 1)
    bsz, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)[None].expand(bsz, s)
    rope = rope_for(cfg, positions, mrope_positions)
    kvs = []
    for i, seg in enumerate(params["segments"]):
        kind, sp = _segment(seg)
        body = maybe_remat(functools.partial(_held_layer, cfg, kind,
                                             f"segments/{i}/kind_{kind}"), cfg)
        entries = []
        for lp in _layers(sp):
            x, kv = body(lp, x, rope)
            if collect_kv:
                entries.append(kv)
        kvs.append({key: torch.stack([e[key] for e in entries])
                    for key in entries[0]} if collect_kv else None)
    return apply_norm(cfg, params["final_norm"], x), kvs


def forward(cfg: ModelConfig, params: Params, tokens: torch.Tensor | None = None,
            *, embeds: torch.Tensor | None = None,
            positions: torch.Tensor | None = None,
            mrope_positions: torch.Tensor | None = None,
            collect_kv: bool = False, return_hidden: bool = False):
    """Logits (B, S, V); with collect_kv, (logits, hidden, kvs) as the JAX
    `forward(collect_kv=True)` returns, and with return_hidden alone
    (None, hidden, kvs), no unembedding.  `embeds`, `positions` and
    `mrope_positions` as `hidden` takes them."""
    x, kvs = hidden(cfg, params, tokens, collect_kv=collect_kv, embeds=embeds,
                    positions=positions, mrope_positions=mrope_positions)
    if return_hidden and not collect_kv:
        return None, x, kvs
    logits = unembed(cfg, params, x)
    if collect_kv:
        return logits, x, kvs
    return logits


def chunked_cross_entropy(cfg: ModelConfig, params: Params,
                          hidden_states: torch.Tensor, labels: torch.Tensor,
                          chunk: int = 512) -> torch.Tensor:
    """The `fused_ce` loss: the unembedding and cross-entropy over
    sequence chunks of `chunk` positions (the tail padded with ignored
    labels), so only (B, chunk, V) float32 logits are formed at a time;
    the same mean as `cross_entropy` over the whole (B, S, V)."""
    s = hidden_states.shape[1]
    pad = (-s) % chunk
    if pad:
        hidden_states = F.pad(hidden_states, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=-1)
    num = den = 0.0
    for c0 in range(0, s + pad, chunk):
        total, count = cross_entropy_sum(
            unembed(cfg, params, hidden_states[:, c0:c0 + chunk]),
            labels[:, c0:c0 + chunk])
        num, den = num + total, den + count
    return num / global_count(den).clamp(min=1.0)


def loss_fn(cfg: ModelConfig, params: Params, batch: dict) -> torch.Tensor:
    """Mean next-token cross-entropy of batch {"tokens", "labels"[,
    "embeds"]} (labels -1 ignored; an `embeds` prefix carries none);
    `fused_ce` takes it in sequence chunks; an MTP config adds 0.3 times
    the loss of its one-layer head predicting the token after next."""
    tokens, labels = batch["tokens"], batch["labels"]
    embeds = batch.get("embeds")
    _, h, _ = forward(cfg, params, tokens, embeds=embeds, return_hidden=True)
    if cfg.fused_ce and not cfg.mtp:
        if embeds is not None:
            h = h[:, embeds.shape[1]:]
        return chunked_cross_entropy(cfg, params, h, labels)
    logits = unembed(cfg, params, h)
    if embeds is not None:      # prefix positions carry no labels
        logits = logits[:, embeds.shape[1]:]
    loss = cross_entropy(logits, labels)
    if cfg.mtp:
        mp = sharding.compute_tree(cfg, params["mtp"], "mtp")
        emb_next = embed_tokens(cfg, params, F.pad(tokens[:, 1:], (0, 1)))
        hh = torch.cat([h, emb_next], -1) @ mp["proj"].to(cfg.tdtype)
        bsz, s, _ = hh.shape
        pos = torch.arange(s, device=hh.device)[None].expand(bsz, s)
        hh, _ = layer_fwd(cfg, "dense", mp["layer"], hh, rope_for(cfg, pos))
        hh = apply_norm(cfg, mp["norm"], hh)
        mtp_labels = F.pad(labels[:, 1:], (0, 1), value=-1)
        loss = loss + 0.3 * cross_entropy(unembed(cfg, params, hh), mtp_labels)
    return loss


# ---------------------------------------------------------------------------
# KV cache + decode
# ---------------------------------------------------------------------------

def cache_len(cfg: ModelConfig, max_len: int) -> int:
    """Ring length: a sliding-window model only ever needs `window` slots."""
    return min(max_len, cfg.window) if cfg.window else max_len


def entry_shapes(cfg: ModelConfig, count: int, rows: int, cols: int,
                 kv_heads: int | None = None) -> dict:
    """Cache leaf shapes of one segment over a (rows, cols) rectangle:
    {"k", "v"} (count, rows, cols, Hkv, hd), Hkv `kv_heads` (a rank's
    local heads) or the config's, or MLA's {"latent"} (count, rows, cols,
    kv_rank + rope_dim)."""
    if cfg.use_mla:
        return {"latent": (count, rows, cols, cfg.mla_kv_rank + cfg.mla_rope_dim)}
    kv = (count, rows, cols, kv_heads or cfg.kv_heads, cfg.hd)
    return {"k": kv, "v": kv}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device: torch.device | str = "cpu", dtype=None,
               kv_heads: int | None = None) -> Params:
    """Zero dense KV rectangles per segment (`entry_shapes` over (B, C),
    C the ring length, at `kv_heads`) and a scalar index."""
    check_supported(cfg)
    dt = dtype or cfg.tdtype
    clen = cache_len(cfg, max_len)
    segs = [{key: torch.zeros(shape, dtype=dt, device=device)
             for key, shape in entry_shapes(cfg, count, batch, clen, kv_heads).items()}
            for _, count in layer_segments(cfg)]
    return {"segments": segs,
            "index": torch.zeros((), dtype=torch.int32, device=device)}


def init_paged_cache(cfg: ModelConfig, num_pages: int, page_size: int, *,
                     device: torch.device | str = "cpu", dtype=None) -> list:
    """Per-segment KV page pools (`entry_shapes` over (num_pages,
    page_size)); page 0 is the null page every unused page-table entry
    points at."""
    check_supported(cfg)
    dt = dtype or cfg.tdtype
    return [{key: torch.zeros(shape, dtype=dt, device=device)
             for key, shape in entry_shapes(cfg, count, num_pages, page_size).items()}
            for _, count in layer_segments(cfg)]


def prefill(cfg: ModelConfig, params: Params, tokens: torch.Tensor | None,
            max_len: int, *, embeds: torch.Tensor | None = None):
    """Run the prompt (after an `embeds` prefix, if any), fill a dense
    cache (`init_cache`'s layout, at this rank's KV heads under a mesh):
    (last-token logits, cache).  A prompt longer than a sliding-window
    ring keeps its last `clen` positions, rolled so that position p sits
    in slot p % clen."""
    x, kvs = hidden(cfg, params, tokens, collect_kv=True, embeds=embeds)
    bsz, s = x.shape[:2]
    kv = kvs[0].get("k")                    # (L, B, S, Hkv, hd): the local heads
    cache = init_cache(cfg, bsz, max_len, device=x.device,
                       kv_heads=None if kv is None else kv.shape[3])
    clen = cache_len(cfg, max_len)
    take = min(s, clen)
    for seg_kv, seg in zip(kvs, cache["segments"]):
        for key, src in seg_kv.items():
            last = src[:, :, s - take:]
            if cfg.window and take == clen:
                last = torch.roll(last, shifts=s % clen, dims=2)
            seg[key][:, :, :take] = last.to(seg[key].dtype)
    cache["index"] = torch.tensor(s, dtype=torch.int32, device=x.device)
    return unembed(cfg, params, x[:, -1:]), cache


def _ring_slot(cfg: ModelConfig, index: torch.Tensor, clen: int):
    return torch.remainder(index, clen) if cfg.window else index


def _cache_positions(cfg: ModelConfig, index: torch.Tensor, clen: int):
    """Absolute position held by each cache slot (ring-aware), -1 where
    none; index (B,) -> (B, clen).  Python-style `%` (torch.remainder)
    on the negative differences, as JAX's `%`."""
    j = torch.arange(clen, device=index.device)[None, :]
    idx = index[:, None]
    if cfg.window:
        p = idx - torch.remainder(idx - j, clen)
        return torch.where(p >= 0, p, -1)
    return torch.where(j <= idx, j, -1)


def _decode_mask(cfg: ModelConfig, index: torch.Tensor, clen: int):
    """(B, clen): cache slot j is attended by the token at `index`."""
    kpos = _cache_positions(cfg, index, clen)
    mask = (kpos >= 0) & (kpos <= index[:, None])
    if cfg.window:
        mask &= kpos > index[:, None] - cfg.window
    return mask


def _seq_block(cfg: ModelConfig, clen: int):
    """Under a dense cache whose length is split over ranks (the DP axes,
    SP, or "model": `sharding.seq_axes`): (mesh, axes, this rank's first
    position, the whole length) of its block of `clen` positions; else
    None."""
    plan = _plan(cfg)
    if plan is None or plan.sp is None:
        return None
    n = sharding.axis_size(plan.mesh, plan.sp)
    return plan.mesh, plan.sp, plan.mesh.axis_rank(plan.sp) * clen, clen * n


def _block_slot(slot: torch.Tensor, off: int, clen: int) -> torch.Tensor:
    """A whole-cache slot (B,) as this rank's block of `clen` from `off`
    holds it: the local slot, or `clen` (dropped by `_write_slot`) where
    another rank's block owns the position."""
    return torch.where((slot >= off) & (slot < off + clen), slot - off, clen)


def _attend_blocks(scores: torch.Tensor, mask: torch.Tensor, values, dt, sp):
    """softmax(scores) over the last axis, masked to `mask`, through
    `values` (weights in dt -> their values, the same leading dims) when
    each rank of the split (`_seq_block`) holds a block of the keys: the
    rank's partial softmax (its max, its sum of exp and its weighted
    values) is combined exactly over the split's axes in float32 (one
    all_max, one all_reduce of the sums and values packed together).  A
    rank whose block holds no valid key adds nothing: its weights are 0
    and its max scales to 0."""
    mesh, axes = sp[0], sp[1]
    scores = scores.masked_fill(~mask, -1e30)
    m = scores.amax(-1, keepdim=True)
    p = torch.exp(scores - m).masked_fill(~mask, 0.0)
    scale = torch.exp(m - coll.all_max(m.clone(), mesh, axes))
    o = values(p.to(dt)).float() * scale
    ol = coll.all_reduce(torch.cat([o, p.sum(-1, keepdim=True) * scale], -1), mesh, axes)
    return (ol[..., :-1] / ol[..., -1:]).to(dt)


def _write_slot(cache: torch.Tensor, new: torch.Tensor, slot: torch.Tensor):
    """cache (B, C, ...)[b, slot[b]] <- new (B, 1, ...)[b, 0], in place.  A
    slot past the cache is dropped, as the JAX scatter drops it (an empty
    slot of a full-width step may sit at index C): its row writes back
    what it holds."""
    rows = torch.arange(cache.shape[0], device=cache.device)
    c = cache.shape[1]
    at = slot.clamp(max=c - 1)
    ok = (slot < c).view(-1, *([1] * (new.dim() - 2)))
    cache[rows, at] = torch.where(ok, new[:, 0].to(cache.dtype), cache[rows, at])


def _decode_attn(cfg: ModelConfig, p: Params, x: torch.Tensor,
                 K: torch.Tensor, V: torch.Tensor, slot: torch.Tensor,
                 rope, mask: torch.Tensor, sp=None):
    """One-token attention against the cache; writes the token's k/v into
    K/V (B, C, Hkv, hd) in place at cache slot slot[b].  x: (B, 1, d);
    rope: `rope_tables` of the token positions; mask (B, C): `_decode_mask`.
    `cfg.gqa_einsum` contracts each group of n_rep query heads against its
    own KV head (the JAX grouped branch), so K and V are read once and
    never repeated; else K and V are repeated to the query heads.  `sp`
    (`_seq_block`): K/V are this rank's block of the cache length, the
    softmax combined over the SP ranks (`_attend_blocks`)."""
    bsz = x.shape[0]
    dt = cfg.tdtype
    q, k, v = _roped_qkv(cfg, p, x, rope)
    _write_slot(K, k, slot)
    _write_slot(V, v, slot)
    h, hkv = q.shape[2], K.shape[2]
    n_rep = h // hkv
    if cfg.gqa_einsum and n_rep > 1:
        qg = q.reshape(bsz, 1, hkv, n_rep, cfg.hd)
        scores = torch.einsum("bqkgd,bckd->bkgqc", qg, K.to(dt)).float() / math.sqrt(cfg.hd)
        if sp is not None:
            o = _attend_blocks(scores, mask[:, None, None, None, :],
                               lambda w: torch.einsum("bkgqc,bckd->bkgqd", w, V.to(dt)), dt, sp)
            o = o.permute(0, 3, 1, 2, 4).reshape(bsz, 1, h, cfg.hd)
            return o.reshape(bsz, 1, -1) @ p["wo"].to(dt)
        scores = scores.masked_fill(~mask[:, None, None, None, :], -1e30)
        probs = torch.softmax(scores, dim=-1).to(dt)
        o = torch.einsum("bkgqc,bckd->bqkgd", probs, V.to(dt)).reshape(bsz, 1, h, cfg.hd)
        return o.reshape(bsz, 1, -1) @ p["wo"].to(dt)
    Kr = K.to(dt).repeat_interleave(n_rep, dim=2) if n_rep > 1 else K.to(dt)
    Vr = V.to(dt).repeat_interleave(n_rep, dim=2) if n_rep > 1 else V.to(dt)
    scores = torch.einsum("bqhd,bchd->bhqc", q, Kr).float() / math.sqrt(cfg.hd)
    if sp is not None:
        o = _attend_blocks(scores, mask[:, None, None, :],
                           lambda w: torch.einsum("bhqc,bchd->bhqd", w, Vr), dt, sp)
        return o.transpose(1, 2).reshape(bsz, 1, -1) @ p["wo"].to(dt)
    scores = scores.masked_fill(~mask[:, None, None, :], -1e30)
    probs = torch.softmax(scores, dim=-1).to(dt)
    o = torch.einsum("bhqc,bchd->bqhd", probs, Vr)
    return o.reshape(bsz, 1, -1) @ p["wo"].to(dt)


def _mla_decode_attn(cfg: ModelConfig, p: Params, x: torch.Tensor,
                     L: torch.Tensor, slot: torch.Tensor, rope,
                     mask: torch.Tensor, sp=None):
    """MLA's absorbed one-token attention against the latent cache L (B,
    C, kv_rank + rd), written in place at slot[b]: the query is absorbed
    through W_uk into the latent space (scores q_nope^T W_uk c_kv plus
    the rope part), and the latent output is up-projected through W_uv
    afterwards, so no per-head key or value is ever formed.  `sp` as
    `_decode_attn` takes it (L: this rank's block of the latents).  Where
    the length is split over "model" and the heads are too, a rank's
    heads and its latent block cover different things: the small
    absorbed queries (B, 1, H, kv_rank + rd) are gathered over "model",
    every head is scored against the local block, the partial softmaxes
    are combined over "model", and the rank keeps its own heads' latent
    outputs for the W_uv up-projection (the latent is never gathered)."""
    bsz = x.shape[0]
    dt, hd, kvr = cfg.tdtype, cfg.hd, cfg.mla_kv_rank
    q_nope, q_rope = _mla_q(cfg, p, x, rope)
    h = q_nope.shape[2]
    _write_slot(L, _mla_latent(cfg, p, x, rope), slot)
    lat, lat_rope = L[..., :kvr].to(dt), L[..., kvr:].to(dt)
    q_abs = torch.einsum("bqhd,khd->bqhk", q_nope, p["wuk"].to(dt).reshape(kvr, h, hd))
    plan = _plan(cfg)
    heads = sp is not None and "model" in sp[1] and plan.attn
    if heads:
        q_abs = coll.all_gather(q_abs, plan.mesh, "model", dim=2)
        q_rope = coll.all_gather(q_rope, plan.mesh, "model", dim=2)
    s_n = torch.einsum("bqhk,bck->bhqc", q_abs, lat)
    s_r = torch.einsum("bqhd,bcd->bhqc", q_rope, lat_rope)
    scores = (s_n + s_r).float() / math.sqrt(hd + cfg.mla_rope_dim)
    if sp is not None:
        o_lat = _attend_blocks(scores, mask[:, None, None, :],
                               lambda w: torch.einsum("bhqc,bck->bhqk", w, lat), dt,
                               sp).transpose(1, 2)
        if heads:
            o_lat = o_lat.narrow(2, plan.mesh.coord("model") * h, h)
    else:
        scores = scores.masked_fill(~mask[:, None, None, :], -1e30)
        probs = torch.softmax(scores, dim=-1).to(dt)
        o_lat = torch.einsum("bhqc,bck->bqhk", probs, lat)
    o = torch.einsum("bqhk,khd->bqhd", o_lat, p["wuv"].to(dt).reshape(kvr, h, hd))
    return o.reshape(bsz, 1, -1) @ p["wo"].to(dt)


def _decode_layers(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                   index: torch.Tensor, caches: list, layer_attn):
    """The decode layer loop that the dense, the paged and the window
    steps share.  tokens (B, S); index (B,) long, the positions before a
    one-token step, or (B, S), the tokens' positions; caches: per
    segment, a dict of tensors stacked by layer ({"k", "v"} or MLA's
    {"latent"}, and the int8 pool's scales).  layer_attn(p, h, lc, rope) writes the tokens' k/v
    into one layer's cache lc (the dict's per-layer views) and returns
    the attention output (B, S, d) (under a mesh this rank's partial sum,
    reduced here).  Returns the (B, S, V) logits."""
    rope = rope_for(cfg, index[:, None] if index.dim() == 1 else index)
    x = embed_tokens(cfg, params, tokens)
    for i, (seg, seg_cache) in enumerate(zip(params["segments"], caches)):
        kind, sp = _segment(seg)
        keys = list(seg_cache)
        per_layer = zip(*(seg_cache[k].unbind(0) for k in keys))
        for lp, views in zip(_layers(sp), per_layer):
            lp = sharding.compute_tree(cfg, lp, f"segments/{i}/kind_{kind}", layer=True)
            a = layer_attn(lp["attn"], apply_norm(cfg, lp["norm1"], x),
                           dict(zip(keys, views)), rope)
            a = _attn_sum(cfg, a)
            x, h = apply_norm_residual(cfg, lp["norm2"], x, a)
            x = x + _ffn(cfg, kind, lp, h)
    x = apply_norm(cfg, params["final_norm"], x)
    return unembed(cfg, params, x)


def decode_step(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                cache: Params):
    """One decode step. tokens: (B, 1) int.  cache["index"] is a scalar
    (uniform lengths) or a (B,) vector (per-slot lengths).  Returns
    (logits (B, 1, V), cache) with the cache advanced in place and
    index + 1.  A sliding-window model writes ring slot index % C and
    attends to the last `window` positions.  Under a split length
    (`use_mesh(seq_split=True)` over "data", `seq_split="model"` over
    "model") the cache holds this rank's block of the length: the masks
    are the whole cache's cut to the block, the new k/v is written only by
    the rank whose block holds its (ring) slot, and the softmax is
    combined over the ranks of the split."""
    check_supported(cfg)
    raw = torch.as_tensor(cache["index"], device=tokens.device)
    index = raw.expand(tokens.shape[0]) if raw.dim() == 0 else raw
    index = index.long()
    # every segment's ring: {"k", "v"} or {"latent"} (L, B, C, ...)
    clen = next(iter(cache["segments"][0].values())).shape[2]
    sp = _seq_block(cfg, clen)
    whole = clen if sp is None else sp[3]
    slot = _ring_slot(cfg, index, whole)
    mask = _decode_mask(cfg, index, whole)
    if sp is not None:
        mask = mask[:, sp[2]:sp[2] + clen]
        slot = _block_slot(slot, sp[2], clen)

    def attn(p, h, lc, rope):
        if cfg.use_mla:
            return _mla_decode_attn(cfg, p, h, lc["latent"], slot, rope, mask, sp)
        return _decode_attn(cfg, p, h, lc["k"], lc["v"], slot, rope, mask, sp)

    logits = _decode_layers(cfg, params, tokens, index, cache["segments"], attn)
    return logits, {"segments": cache["segments"], "index": raw + 1}


def window_supported(cfg: ModelConfig) -> bool:
    """Configs `decode_window` handles: plain linear-cache attention."""
    return cfg.family == "transformer" and not cfg.use_mla and not cfg.window


def _window_attn(cfg: ModelConfig, p: Params, x: torch.Tensor, K: torch.Tensor,
                 V: torch.Tensor, pos: torch.Tensor, rope, sp=None):
    """W-token cached attention (the spec-decode verify): x (B, W, d) at
    positions pos (B, W); position p writes cache slot p of K/V (B, C,
    Hkv, hd) in place and attends causally to every slot <= p.  Einsum
    attention, as in the JAX package (no Pallas kernel there).  `sp`
    (`_seq_block`): K/V are this rank's block of the cache length; a
    position is written by the rank whose block holds it, and the
    softmax is combined over the SP ranks."""
    bsz, w = x.shape[:2]
    dt = cfg.tdtype
    q, k, v = _roped_qkv(cfg, p, x, rope)
    rows = torch.arange(bsz, device=x.device)[:, None]
    off = 0 if sp is None else sp[2]
    if sp is None:
        K[rows, pos] = k.to(K.dtype)
        V[rows, pos] = v.to(V.dtype)
    else:
        at = pos - off
        ok = (at >= 0) & (at < K.shape[1])
        r = rows.expand_as(pos)[ok]
        K[r, at[ok]] = k[ok].to(K.dtype)
        V[r, at[ok]] = v[ok].to(V.dtype)
    n_rep = q.shape[2] // K.shape[2]
    Kr = K.to(dt).repeat_interleave(n_rep, dim=2) if n_rep > 1 else K.to(dt)
    Vr = V.to(dt).repeat_interleave(n_rep, dim=2) if n_rep > 1 else V.to(dt)
    scores = torch.einsum("bqhd,bchd->bhqc", q, Kr).float() / math.sqrt(cfg.hd)
    mask = off + torch.arange(K.shape[1], device=x.device)[None, None, :] <= pos[:, :, None]
    if sp is not None:
        o = _attend_blocks(scores, mask[:, None],
                           lambda wt: torch.einsum("bhqc,bchd->bhqd", wt, Vr), dt, sp)
        return o.transpose(1, 2).reshape(bsz, w, -1) @ p["wo"].to(dt)
    scores = scores.masked_fill(~mask[:, None], -1e30)
    probs = torch.softmax(scores, dim=-1).to(dt)
    o = torch.einsum("bhqc,bchd->bqhd", probs, Vr)
    return o.reshape(bsz, w, -1) @ p["wo"].to(dt)


def decode_window(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                  cache: Params):
    """Verify W speculated tokens in one cached forward.  tokens (B, W)
    at positions index .. index + W - 1, which must lie inside the cache
    (the spec-decode engine keeps W positions of headroom); their k/v are
    written into the cache in place, and the logits of every window
    position come back, (B, W, V), with the cache's index + W.  Norms and
    MLP take the same dispatch as `decode_step` (at B * W rows).  The
    caller rewinds by resetting the index: slots past it are masked out
    of every later attention.  Under SP the cache is this rank's block of
    the length, as `decode_step` takes it."""
    if not window_supported(cfg):
        raise NotImplementedError(
            f"decode_window: plain-attention transformer only (family="
            f"{cfg.family}, mla={cfg.use_mla}, window={cfg.window})")
    check_supported(cfg)
    raw = torch.as_tensor(cache["index"], device=tokens.device)
    bsz, w = tokens.shape
    index = (raw.expand(bsz) if raw.dim() == 0 else raw).long()
    pos = index[:, None] + torch.arange(w, device=tokens.device)[None]
    sp = _seq_block(cfg, cache["segments"][0]["k"].shape[2])

    def attn(p, h, lc, rope):
        return _window_attn(cfg, p, h, lc["k"], lc["v"], pos, rope, sp)

    logits = _decode_layers(cfg, params, tokens, pos, cache["segments"], attn)
    return logits, {"segments": cache["segments"], "index": raw + w}


def paged_decode_step(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                      segments: list, tables: torch.Tensor,
                      index: torch.Tensor) -> torch.Tensor:
    """One decode step straight from the page pools (in place): in each
    layer the token's k/v go to page tables[b, index[b] // ps], offset
    index[b] % ps, and `paged_decode_attention` attends over the
    index + 1 live positions through the table.  tokens (n, 1); tables
    (n, npp) int32; index (n,) int (positions before the step).  Returns
    the (n, 1, V) logits.  Plain (no ring) attention only, as paged
    serving is (`paged.paged_supported`); MLA latents have no pool route
    (the JAX paged kernel attends over k/v pages), and flash prefill
    refuses MLA before a decode can start."""
    check_supported(cfg)
    if cfg.use_mla:
        raise NotImplementedError("paged_decode_step: MLA latents decode "
                                  "by the gather route")
    n = tokens.shape[0]
    index = index.long()
    ps = segments[0]["k"].shape[2]
    rows = torch.arange(n, device=tokens.device)
    pages = tables.long()[rows, index // ps]
    offs = index % ps
    lengths = (index + 1).to(torch.int32)

    def attn(p, h, lc, rope):
        q, k, v = _roped_qkv(cfg, p, h, rope)
        Kp, Vp = lc["k"], lc["v"]
        # padding lanes of a compacted step repeat a real slot: they
        # write identical k/v to the same pool position, so the
        # duplicate writes are benign, and the kernel runs after them
        Kp[pages, offs] = k[:, 0].to(Kp.dtype)
        Vp[pages, offs] = v[:, 0].to(Vp.dtype)
        o = fops.paged_decode_attention(q, Kp, Vp, tables, lengths)
        return o.reshape(n, 1, -1) @ p["wo"].to(cfg.tdtype)

    return _decode_layers(cfg, params, tokens, index, segments, attn)

"""Shared building blocks of the port (from `repro.models.common`):
RMSNorm with the fused dispatch, LayerNorm, seeded weight draws, GELU,
the dense MLP, RoPE and M-RoPE tables, the attention dispatch, the
training loss and activation recomputation.  Params are nested dicts of
tensors, as on the JAX side.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Callable

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as ckpt

from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.fused_mlp import ops as mops
from repro_torch.kernels.fused_norm import ops as nops
from repro_torch.parallel import collectives as coll

from .config import ModelConfig

Params = Any   # nested dict of tensors

NEG_INF = -1e30


# --- norms ------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5):
    """LayerNorm in float32 (population variance), scale and bias
    promoted to float32 by the product, cast back to x's dtype."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(x.dtype)


def init_norm(cfg: ModelConfig, lead: tuple = (),
              device: torch.device | str = "cpu") -> Params:
    """Norm parameters of shape (*lead, d): RMSNorm a zero scale (it
    multiplies by 1 + scale), LayerNorm a unit scale and a zero bias."""
    shape = (*lead, cfg.d_model)
    pd = cfg.tparam_dtype
    if cfg.norm == "layernorm":
        return {"scale": torch.ones(shape, dtype=pd, device=device),
                "bias": torch.zeros(shape, dtype=pd, device=device)}
    return {"scale": torch.zeros(shape, dtype=pd, device=device)}


def apply_norm(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    """LayerNorm (plain torch: no kernel computes it), else RMSNorm, one
    CUDA kernel with cfg.norm_impl == "fused"."""
    if cfg.norm == "layernorm":
        return layernorm(x, p["scale"], p["bias"], cfg.norm_eps)
    if cfg.norm_impl == "fused":
        return nops.fused_rmsnorm(x, p["scale"], eps=cfg.norm_eps)
    return rmsnorm(x, p["scale"], cfg.norm_eps)


def apply_norm_residual(cfg: ModelConfig, p: Params, res: torch.Tensor,
                        delta: torch.Tensor):
    """(res + delta, norm(res + delta)); one CUDA kernel with
    cfg.norm_impl == "fused" on an RMSNorm model, else the plain two-op
    reference."""
    if cfg.norm_impl == "fused" and cfg.norm != "layernorm":
        return nops.fused_rmsnorm_residual(res, delta, p["scale"],
                                           eps=cfg.norm_eps)
    s = res + delta
    return s, apply_norm(cfg, p, s)


# --- activations, init ------------------------------------------------------

def gelu(x: torch.Tensor) -> torch.Tensor:
    """GELU in the tanh approximation, `jax.nn.gelu`'s default."""
    return F.gelu(x, approximate="tanh")


def normal(gen: torch.Generator, shape, scale: float, dtype) -> torch.Tensor:
    """scale * N(0, 1) of `shape`, drawn from `gen` in float32 on the
    generator's device, cast to `dtype`."""
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device)
    return x.mul_(scale).to(dtype)


def dense(gen: torch.Generator, shape, dtype, scale: float | None = None):
    """A weight of `shape` with the JAX `dense_init` scale: 1/sqrt(fan-in)
    unless `scale` is given."""
    s = scale if scale is not None else 1.0 / math.sqrt(shape[0])
    return normal(gen, shape, s, dtype)


# --- dense MLP --------------------------------------------------------------

def mlp_block(cfg: ModelConfig, p: Params, x: torch.Tensor, *,
              mesh=None) -> torch.Tensor:
    """SwiGLU / GELU MLP.  cfg.mlp_impl == "fused" runs the whole block as
    one CUDA kernel; "dense" is plain PyTorch in the model dtype.
    `mesh`: the weights are this rank's shards over the mesh's "model"
    axis, w_in / w_gate by columns and w_out by rows (the kernel runs at
    F / tp), and the partial outputs are summed by one all_reduce (under
    autograd x enters through `copy_to`)."""
    dt = cfg.tdtype
    if mesh is not None:
        x = coll.copy_to(x, mesh)
    if cfg.mlp_impl == "fused":
        wg = p["w_gate"].to(dt) if cfg.swiglu else None
        y = mops.fused_mlp(x, wg, p["w_in"].to(dt), p["w_out"].to(dt),
                           swiglu=cfg.swiglu)
    else:
        h = x @ p["w_in"].to(dt)
        if cfg.swiglu:
            h = F.silu(x @ p["w_gate"].to(dt)) * h
        else:
            h = gelu(h)
        y = h @ p["w_out"].to(dt)
    return y if mesh is None else coll.all_reduce(y, mesh)


# --- tensor parallelism shared by the families -------------------------------

def tp_plan(cfg: ModelConfig):
    """The tensor-parallel plan under the current mesh, None without one."""
    from repro_torch.parallel import sharding
    mesh = sharding.current_mesh()
    return None if mesh is None else sharding.tp_plan(cfg, mesh)


def copy_if(x: torch.Tensor, plan, sharded: bool) -> torch.Tensor:
    """x entering a part that runs sharded over "model" (`coll.copy_to`:
    x itself, its gradient summed over the ranks under autograd); a
    replicated leaf a rank slices its block of goes through it before the
    slice, so its gradient is whole on every rank."""
    return coll.copy_to(x, plan.mesh) if plan is not None and sharded else x


def reduce_if(y: torch.Tensor, plan, sharded: bool) -> torch.Tensor:
    """y summed over "model" where a part ran sharded (its row-parallel
    product gave partial sums); else y."""
    return coll.all_reduce(y, plan.mesh) if plan is not None and sharded else y


def vocab_embed(emb: torch.Tensor, tokens: torch.Tensor, plan) -> torch.Tensor:
    """emb[tokens]; under a plan with the vocab sharded, each rank looks
    the tokens up in its rows (zeros elsewhere) and one all_reduce sums
    them (exact: every row but one adds zeros)."""
    if plan is None or not plan.vocab:
        return emb[tokens]
    rows = emb.shape[0]
    local = tokens - plan.mesh.coord("model") * rows
    ok = (local >= 0) & (local < rows)
    x = emb[local.clamp(0, rows - 1)].masked_fill(~ok[..., None], 0)
    return coll.all_reduce(x, plan.mesh)


def gather_if(x: torch.Tensor, plan, sharded: bool) -> torch.Tensor:
    """The ranks' column blocks of x gathered along its last dim, in rank
    order, where a part ran sharded on its columns; else x."""
    return coll.all_gather(x, plan.mesh, "model", dim=-1) \
        if plan is not None and sharded else x


def vocab_in(x: torch.Tensor, plan) -> torch.Tensor:
    """The hidden states entering the unembedding (`copy_if` where the
    vocab is sharded)."""
    return copy_if(x, plan, plan is not None and plan.vocab)


def vocab_logits(logits: torch.Tensor, plan) -> torch.Tensor:
    """A rank's vocab columns of the logits gathered into whole rows where
    the vocab is sharded; else the logits."""
    return gather_if(logits, plan, plan is not None and plan.vocab)


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


def mrope_tables(positions3: torch.Tensor, hd: int, theta: float,
                 sections: tuple[int, int, int]):
    """Qwen2-VL M-RoPE as `rope_tables`: positions3 (3, B, S) temporal /
    height / width ids; frequency slot i takes its angle from the stream
    of its section (`sections` slots each, summing to hd/2), so
    `apply_rope` applies it unchanged."""
    freqs = rope_freqs(hd, theta, positions3.device)         # (hd/2,)
    pos = torch.cat([positions3[i, :, :, None].expand(-1, -1, n)
                     for i, n in enumerate(sections)], -1)  # (B, S, hd/2)
    ang = pos.float() * freqs
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
    """Plain attention. q: (B,Sq,H,hd), k/v: (B,Sk,Hkv,hd).  Mixed dtypes
    (a float32 or dequantized cache beside a bfloat16 q) are promoted as
    `jnp.einsum` promotes them; the probabilities are rounded to q's own
    dtype first, as the JAX version does."""
    n_rep = q.shape[2] // k.shape[2]
    k, v = repeat_kv(k, n_rep), repeat_kv(v, n_rep)
    q_dtype = q.dtype
    dt = torch.promote_types(q.dtype, torch.promote_types(k.dtype, v.dtype))
    q, k, v = q.to(dt), k.to(dt), v.to(dt)
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
    probs = torch.softmax(logits, dim=-1).to(q_dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(dt), v)


def attn_chunked(q, k, v, *, causal: bool, window: int | None,
                 chunk: int = 1024, q_offset: int = 0) -> torch.Tensor:
    """Memory-efficient attention (the JAX `attn_chunked`): a loop over KV
    chunks of `chunk` keys with a running max and sum, so the (Sq, Sk)
    scores are never held whole.  q: (B,Sq,H,hd), k/v: (B,Sk,Hkv,hd)."""
    b, sq, h, hd = q.shape
    vd = v.shape[-1]
    sk = k.shape[1]
    n_rep = h // k.shape[2]
    scale = 1.0 / math.sqrt(hd)
    qpos = torch.arange(sq, device=q.device)[:, None] + q_offset
    m = torch.full((b, h, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, sq, vd), dtype=torch.float32, device=q.device)
    for c0 in range(0, sk, chunk):
        ki = repeat_kv(k[:, c0:c0 + chunk], n_rep)
        vi = repeat_kv(v[:, c0:c0 + chunk], n_rep)
        s = torch.einsum("bqhd,bkhd->bhqk", q, ki).float() * scale
        kpos = torch.arange(c0, c0 + ki.shape[1], device=q.device)[None, :]
        msk = torch.ones((sq, ki.shape[1]), dtype=torch.bool, device=q.device)
        if causal:
            msk &= kpos <= qpos
        if window is not None:
            msk &= kpos > qpos - window
        s = s.masked_fill(~msk, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        # fully masked chunks keep p exactly 0 (not exp(-inf - -inf) = 1)
        p = torch.where(s <= NEG_INF / 2, torch.zeros_like(s),
                        torch.exp(s - m_new[..., None]))
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p.to(q.dtype), vi).float()
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.transpose(1, 2).to(q.dtype)


def attn_local(q, k, v, *, window: int, q_offset: int = 0) -> torch.Tensor:
    """Banded causal attention for sliding-window prefill (the JAX
    `attn_local`): queries in chunks of `window`, each against its own
    chunk and the previous one, so the scores are (S, 2 * window), never
    (S, S).  Like the JAX form it is causal by construction and ignores
    `q_offset`."""
    b, s, h, hd = q.shape
    w = window
    pad = (-s) % w
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
    sp = q.shape[1]
    nq = sp // w
    hkv, vd = k.shape[2], v.shape[-1]
    kc = k.reshape(b, nq, w, hkv, hd)
    vc = v.reshape(b, nq, w, hkv, vd)
    # the previous chunk (zeros before chunk 0)
    kprev = torch.cat([torch.zeros_like(kc[:, :1]), kc[:, :-1]], 1)
    vprev = torch.cat([torch.zeros_like(vc[:, :1]), vc[:, :-1]], 1)
    n_rep = h // hkv
    kcat = repeat_kv(torch.cat([kprev, kc], 2).reshape(b * nq, 2 * w, hkv, hd), n_rep)
    vcat = repeat_kv(torch.cat([vprev, vc], 2).reshape(b * nq, 2 * w, hkv, vd), n_rep)
    qf = q.reshape(b * nq, w, h, hd)
    sco = torch.einsum("bqhd,bkhd->bhqk", qf, kcat).float() / math.sqrt(hd)
    qpos = torch.arange(w, device=q.device)[:, None] + w     # position within 2w
    kpos = torch.arange(2 * w, device=q.device)[None, :]
    mask = ((kpos <= qpos) & (kpos > qpos - w)).expand(b * nq, w, 2 * w).clone()
    chunk0 = (torch.arange(b * nq, device=q.device) % nq) == 0
    mask &= ~(chunk0[:, None, None] & (kpos[None] < w))
    sco = sco.masked_fill(~mask[:, None], NEG_INF)
    probs = torch.softmax(sco, -1).to(q.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, vcat).reshape(b, sp, h, vd)
    return out[:, :s]


def attention(cfg: ModelConfig, q, k, v, *, causal: bool = True,
              q_offset: int = 0, decode: bool = False) -> torch.Tensor:
    """Dispatch on cfg.attn_impl and shape, as the JAX package does."""
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
    if impl == "local":
        return attn_local(q, k, v, window=cfg.window, q_offset=q_offset)
    if impl == "chunked":
        return attn_chunked(q, k, v, causal=causal, window=cfg.window,
                            chunk=cfg.attn_chunk, q_offset=q_offset)
    return attn_einsum(q, k, v, causal=causal, window=cfg.window,
                       q_offset=q_offset)


# --- one-token attention over a cache length split over ranks ------------------

def seq_block(cfg: ModelConfig, clen: int, leaf: str | None = None):
    """Under a dense cache whose length is split over ranks (the DP axes,
    SP, or "model": `sharding.length_split`): (mesh, axes, this rank's
    first position, the whole length) of its block of `clen` positions
    of the cache leaf `leaf` (None: the decoder's one cache); else
    None."""
    from repro_torch.parallel import sharding
    plan = tp_plan(cfg)
    axes = sharding.length_split(leaf) if plan is not None else None
    if axes is None:
        return None
    n = sharding.axis_size(plan.mesh, axes)
    return plan.mesh, axes, plan.mesh.axis_rank(axes) * clen, clen * n


def block_slot(slot: torch.Tensor, off: int, clen: int) -> torch.Tensor:
    """A whole-cache slot (B,) as this rank's block of `clen` from `off`
    holds it: the local slot, or `clen` (dropped by `write_slot`) where
    another rank's block owns the position."""
    return torch.where((slot >= off) & (slot < off + clen), slot - off, clen)


def attend_blocks(scores: torch.Tensor, mask: torch.Tensor | None, values, dt, sp):
    """softmax(scores) over the last axis, masked to `mask` (None: every
    key), through `values` (weights in dt -> their values, the same
    leading dims) when each rank of the split (`seq_block`) holds a block
    of the keys: the rank's partial softmax (its max, its sum of exp and
    its weighted values) is combined exactly over the split's axes in
    float32 (one all_max, one all_reduce of the sums and values packed
    together).  A rank whose block holds no valid key adds nothing: its
    weights are 0 and its max scales to 0."""
    mesh, axes = sp[0], sp[1]
    if mask is not None:
        scores = scores.masked_fill(~mask, NEG_INF)
    m = scores.amax(-1, keepdim=True)
    p = torch.exp(scores - m)
    if mask is not None:
        p = p.masked_fill(~mask, 0.0)
    scale = torch.exp(m - coll.all_max(m.clone(), mesh, axes))
    o = values(p.to(dt)).float() * scale
    ol = coll.all_reduce(torch.cat([o, p.sum(-1, keepdim=True) * scale], -1), mesh, axes)
    return (ol[..., :-1] / ol[..., -1:]).to(dt)


def write_slot(cache: torch.Tensor, new: torch.Tensor, slot: torch.Tensor):
    """cache (B, C, ...)[b, slot[b]] <- new (B, 1, ...)[b, 0], in place.  A
    slot past the cache is dropped, as the JAX scatter drops it (an empty
    slot of a full-width step may sit at index C, and `block_slot` sends
    another rank's position there): its row writes back what it holds."""
    rows = torch.arange(cache.shape[0], device=cache.device)
    c = cache.shape[1]
    at = slot.clamp(max=c - 1)
    ok = (slot < c).view(-1, *([1] * (new.dim() - 2)))
    cache[rows, at] = torch.where(ok, new[:, 0].to(cache.dtype), cache[rows, at])


# --- training: recomputation and the loss -------------------------------------

def _save_dots(ctx, op, *args, **kwargs):
    """Keep the outputs of the 2-D products, recompute everything else:
    `checkpoint_dots_with_no_batch_dims` (an (B, S, d) @ (d, f) product
    runs as one `mm`; attention's batched products are recomputed)."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def maybe_remat(fn: Callable, cfg: ModelConfig) -> Callable:
    """`fn` under activation recomputation as cfg.remat asks: "full"
    saves only its inputs and recomputes the rest in the backward,
    "dots" also keeps the 2-D products' outputs, "none" is `fn` itself.
    The numbers do not change, only what is kept for the backward."""
    if cfg.remat == "full":
        return functools.partial(ckpt.checkpoint, fn, use_reentrant=False)
    if cfg.remat == "dots":
        return functools.partial(
            ckpt.checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(ckpt.create_selective_checkpoint_contexts,
                                         _save_dots))
    return fn


def cross_entropy_sum(logits: torch.Tensor, labels: torch.Tensor,
                      ignore_id: int = -1) -> tuple[torch.Tensor, torch.Tensor]:
    """(the summed cross-entropy, the count) over the positions whose
    label is not `ignore_id`; logits (B, S, V) taken in float32."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    ll = lf.gather(-1, labels.clamp(min=0).long()[..., None])[..., 0]
    valid = (labels != ignore_id).float()
    return ((lse - ll) * valid).sum(), valid.sum()


def global_count(count: torch.Tensor) -> torch.Tensor:
    """A count of labelled positions summed over the DP ranks where the
    batch's rows are split (`use_mesh(data_split=True)`), else itself:
    each rank's loss is then its share of the global mean (its sum over
    the global count), and the shares sum to the global loss."""
    from repro_torch.parallel import sharding
    dp = sharding.split_axes()
    return count if dp is None else coll.all_reduce(count.clone(), sharding.current_mesh(), dp)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  ignore_id: int = -1) -> torch.Tensor:
    """Mean cross-entropy over the positions whose label is not
    `ignore_id`; logits (B, S, V) taken in float32.  With the batch's
    rows split over DP ranks, this rank's share (`global_count`)."""
    total, count = cross_entropy_sum(logits, labels, ignore_id)
    return total / global_count(count).clamp(min=1.0)

"""Optimizers of the port (from `repro.training.optimizer`): AdamW,
Adafactor, global-norm clipping and the learning-rate schedules, on
nested dicts of tensors.

The state trees are the JAX package's, leaf for leaf: AdamW {"mu",
"nu", "step"}, Adafactor {"v", "step"} (per parameter {"vr", "vc"} when
its last two axes are factored, else {"v"}), `step` a 0-d int32, so a
checkpoint of either package restores into the other.  Arithmetic is in
float32 whatever the parameter dtype; each new parameter is cast back to
its own dtype.  Weight decay applies to every leaf with two or more
axes, as in JAX: the stacked per-layer norm scales (L, d) included.

On a mesh (`mesh=` with `specs=`, the parameters' specs by '/'-joined
path, as `sharding.param_spec_map` gives them) each rank
holds its blocks of the parameters, gradients and state (the state by
`sharding.optimizer_shardings`), and every reduction is over the whole
leaf, as JAX's global arrays give: the global norm sums each leaf's
squares over the axes its spec shards (a replicated leaf counted once),
Adafactor's row and column means and its update's RMS are taken over
whole dims, and whether a leaf is factored is decided on its whole
shape.  AdamW is elementwise and reads no spec.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.bridge import tree_leaves, tree_map, tree_unflatten, tree_unzip
from repro_torch.parallel import collectives as coll
from repro_torch.parallel import sharding

Params = Any


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"           # adamw | adafactor
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"      # cosine | linear | constant
    moment_dtype: str = "float32" # float32 | bfloat16 (memory saver)


def lr_at(cfg: OptimizerConfig, step) -> torch.Tensor:
    """The learning rate at `step` (a number or a 0-d tensor), a 0-d
    float32 tensor on step's device: linear warm-up over warmup_steps,
    then cosine, linear or no decay to total_steps."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp((step + 1) / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    if cfg.schedule == "cosine":
        decay = 0.5 * (1.0 + torch.cos(math.pi * frac))
    elif cfg.schedule == "linear":
        decay = 1.0 - frac
    else:
        decay = torch.ones_like(frac)
    return cfg.lr * warm * decay


def global_norm(tree, mesh=None, specs=None) -> torch.Tensor:
    """sqrt of the sum of squares over every leaf, in float32; on a mesh
    each leaf's sum over the axes its spec (`specs`, by path) shards,
    one all_reduce for each set of axes."""
    sums = [x.float().square().sum() for x in tree_leaves(tree)]
    if mesh is None:
        return torch.sqrt(torch.stack(sums).sum())
    by_axes: dict = {}
    for sq, spec in zip(sums, sharding.leaf_specs(tree, specs)):
        by_axes.setdefault(sharding.spec_axes(spec), []).append(sq)
    total = [coll.all_reduce(torch.stack(v), mesh, axes).sum() if axes
             else torch.stack(v).sum() for axes, v in by_axes.items()]
    return torch.sqrt(torch.stack(total).sum())


def clip_scale(grads, max_norm: float, mesh=None, specs=None):
    """(the factor that scales the gradients to a global norm of at most
    max_norm, their norm)."""
    norm = global_norm(grads, mesh, specs)
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0), norm


def clip_by_global_norm(grads, max_norm: float, mesh=None, specs=None):
    """(the float32 gradients scaled to a global norm of at most
    max_norm, their norm before scaling)."""
    scale, norm = clip_scale(grads, max_norm, mesh, specs)
    return tree_map(lambda g: g.float() * scale, grads), norm


def _f32(g: torch.Tensor, scale) -> torch.Tensor:
    """A gradient in float32, times the clip `scale` where given (the same
    bits as scaling the whole tree first, one leaf alive at a time)."""
    return g.float() if scale is None else g.float() * scale


def _step0(params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=tree_leaves(params)[0].device)


# --- AdamW ------------------------------------------------------------------

def adamw_init(cfg: OptimizerConfig, params: Params) -> Params:
    dt = torch.bfloat16 if cfg.moment_dtype == "bfloat16" else torch.float32

    def zeros(p):
        return torch.zeros(p.shape, dtype=dt, device=p.device)

    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "step": _step0(params)}


def adamw_update(cfg: OptimizerConfig, grads, state, params, scale=None):
    step = state["step"] + 1
    lr = lr_at(cfg, step)
    t = step.float()
    c1 = 1.0 - cfg.b1 ** t
    c2 = 1.0 - cfg.b2 ** t

    def upd(p, g, mu, nu):
        g = _f32(g, scale)
        mu_n = cfg.b1 * mu.float() + (1 - cfg.b1) * g
        nu_n = cfg.b2 * nu.float() + (1 - cfg.b2) * g * g
        delta = (mu_n / c1) / (torch.sqrt(nu_n / c2) + cfg.eps)
        if p.dim() >= 2:   # decoupled weight decay on matrices only
            delta = delta + cfg.weight_decay * p.float()
        p_n = p.float() - lr * delta
        return p_n.to(p.dtype), mu_n.to(mu.dtype), nu_n.to(nu.dtype)

    out = tree_map(upd, params, grads, state["mu"], state["nu"])
    new_params, new_mu, new_nu = tree_unzip(params, out, 3)
    return new_params, {"mu": new_mu, "nu": new_nu, "step": step}


# --- Adafactor (factored second moment; no first moment) ---------------------

def _factored(shape) -> bool:
    return len(shape) >= 2 and shape[-1] >= 2 and shape[-2] >= 2


def _spec_tree(params, mesh, specs):
    """`params`' structure holding each leaf's spec (None off a mesh)."""
    if mesh is None:
        return tree_map(lambda p: None, params)
    return tree_unflatten(params, sharding.leaf_specs(params, specs))


def _whole(p, spec, mesh) -> tuple:
    """A leaf's whole shape (its own without a mesh)."""
    return tuple(p.shape) if mesh is None else sharding.global_shape(p.shape, spec, mesh)


def _mean(x: torch.Tensor, dims, spec, mesh, whole, keepdim: bool = False):
    """x's mean over `dims` of the whole leaf: the local sum, summed over
    the axes `spec` gives those dims (spec and `whole` index x's dims),
    over the whole count."""
    dims = tuple(d % x.dim() for d in dims)
    total = x.sum(dims, keepdim=keepdim)
    if mesh is not None:
        axes = sharding.spec_axes(tuple(spec[d] for d in dims))
        if axes:
            total = coll.all_reduce(total, mesh, axes)
    n = 1
    for d in dims:
        n *= whole[d]
    return total / n


def adafactor_init(cfg: OptimizerConfig, params: Params, mesh=None, specs=None) -> Params:

    def mk(p, spec):
        def zeros(shape):
            return torch.zeros(shape, dtype=torch.float32, device=p.device)
        if _factored(_whole(p, spec, mesh)):
            return {"vr": zeros(p.shape[:-1]),
                    "vc": zeros(p.shape[:-2] + p.shape[-1:])}
        return {"v": zeros(p.shape)}
    return {"v": tree_map(mk, params, _spec_tree(params, mesh, specs)),
            "step": _step0(params)}


def adafactor_update(cfg: OptimizerConfig, grads, state, params, mesh=None, specs=None,
                     scale=None):
    step = state["step"] + 1
    lr = lr_at(cfg, step)
    beta2 = 1.0 - (step.float() + 1.0) ** -0.8

    def upd(p, g, v, spec):
        whole = _whole(p, spec, mesh)
        g = _f32(g, scale)
        g2 = g * g + 1e-30
        if _factored(whole):
            vr = beta2 * v["vr"] + (1 - beta2) * _mean(g2, (-1,), spec, mesh, whole)
            vc = beta2 * v["vc"] + (1 - beta2) * _mean(g2, (-2,), spec, mesh, whole)
            # vr's last dim is the leaf's dim -2
            vr_mean = _mean(vr, (-1,), spec and spec[:-1], mesh, whole[:-1], keepdim=True)
            denom = (vr / torch.clamp(vr_mean, min=1e-30))[..., None] * vc[..., None, :]
            update = g * torch.rsqrt(denom + 1e-30)
            v_n = {"vr": vr, "vc": vc}
        else:
            vv = beta2 * v["v"] + (1 - beta2) * g2
            update = g * torch.rsqrt(vv + 1e-30)
            v_n = {"v": vv}
        # update clipping (RMS <= 1) as in the paper
        rms = torch.sqrt(_mean(update * update, tuple(range(update.dim())), spec, mesh,
                               whole) + 1e-30)
        update = update / torch.clamp(rms, min=1.0)
        if p.dim() >= 2:
            update = update + cfg.weight_decay * p.float()
        return (p.float() - lr * update).to(p.dtype), v_n

    out = tree_map(upd, params, grads, state["v"], _spec_tree(params, mesh, specs))
    new_params, new_v = tree_unzip(params, out, 2)
    return new_params, {"v": new_v, "step": step}


# --- facade ------------------------------------------------------------------

def init_opt(cfg: OptimizerConfig, params: Params, mesh=None, specs=None) -> Params:
    """A fresh state for `params` (on a mesh the rank's blocks, `specs`
    their specs by path)."""
    return adafactor_init(cfg, params, mesh, specs) if cfg.name == "adafactor" \
        else adamw_init(cfg, params)


@torch.no_grad()
def apply_opt(cfg: OptimizerConfig, grads, state, params, mesh=None, specs=None):
    """(new params, new state, the gradients' global norm before
    clipping); the inputs are not written.  On a mesh (`specs`: the
    parameters' specs by path) every reduction is over the whole leaf.
    The clip scales each leaf as its update reads it, so one float32
    gradient is alive at a time (`clip_by_global_norm`'s bits)."""
    scale, gnorm = clip_scale(grads, cfg.clip_norm, mesh, specs)
    if cfg.name == "adafactor":
        new_p, new_s = adafactor_update(cfg, grads, state, params, mesh, specs, scale)
    else:
        new_p, new_s = adamw_update(cfg, grads, state, params, scale)
    return new_p, new_s, gnorm

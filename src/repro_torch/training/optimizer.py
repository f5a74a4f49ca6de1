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
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.bridge import tree_leaves, tree_map, tree_unzip

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


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares over every leaf, in float32."""
    return torch.sqrt(torch.stack([x.float().square().sum()
                                   for x in tree_leaves(tree)]).sum())


def clip_by_global_norm(grads, max_norm: float):
    """(the float32 gradients scaled to a global norm of at most
    max_norm, their norm before scaling)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: g.float() * scale, grads), norm


def _step0(params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=tree_leaves(params)[0].device)


# --- AdamW ------------------------------------------------------------------

def adamw_init(cfg: OptimizerConfig, params: Params) -> Params:
    dt = torch.bfloat16 if cfg.moment_dtype == "bfloat16" else torch.float32

    def zeros(p):
        return torch.zeros(p.shape, dtype=dt, device=p.device)

    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "step": _step0(params)}


def adamw_update(cfg: OptimizerConfig, grads, state, params):
    step = state["step"] + 1
    lr = lr_at(cfg, step)
    t = step.float()
    c1 = 1.0 - cfg.b1 ** t
    c2 = 1.0 - cfg.b2 ** t

    def upd(p, g, mu, nu):
        g = g.float()
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


def adafactor_init(cfg: OptimizerConfig, params: Params) -> Params:
    def mk(p):
        def zeros(shape):
            return torch.zeros(shape, dtype=torch.float32, device=p.device)
        if _factored(p.shape):
            return {"vr": zeros(p.shape[:-1]),
                    "vc": zeros(p.shape[:-2] + p.shape[-1:])}
        return {"v": zeros(p.shape)}
    return {"v": tree_map(mk, params), "step": _step0(params)}


def adafactor_update(cfg: OptimizerConfig, grads, state, params):
    step = state["step"] + 1
    lr = lr_at(cfg, step)
    beta2 = 1.0 - (step.float() + 1.0) ** -0.8

    def upd(p, g, v):
        g = g.float()
        g2 = g * g + 1e-30
        if _factored(p.shape):
            vr = beta2 * v["vr"] + (1 - beta2) * g2.mean(-1)
            vc = beta2 * v["vc"] + (1 - beta2) * g2.mean(-2)
            denom = (vr / torch.clamp(vr.mean(-1, keepdim=True), min=1e-30)
                     )[..., None] * vc[..., None, :]
            update = g * torch.rsqrt(denom + 1e-30)
            v_n = {"vr": vr, "vc": vc}
        else:
            vv = beta2 * v["v"] + (1 - beta2) * g2
            update = g * torch.rsqrt(vv + 1e-30)
            v_n = {"v": vv}
        # update clipping (RMS <= 1) as in the paper
        rms = torch.sqrt(torch.mean(update * update) + 1e-30)
        update = update / torch.clamp(rms, min=1.0)
        if p.dim() >= 2:
            update = update + cfg.weight_decay * p.float()
        return (p.float() - lr * update).to(p.dtype), v_n

    out = tree_map(upd, params, grads, state["v"])
    new_params, new_v = tree_unzip(params, out, 2)
    return new_params, {"v": new_v, "step": step}


# --- facade ------------------------------------------------------------------

def init_opt(cfg: OptimizerConfig, params: Params) -> Params:
    return adafactor_init(cfg, params) if cfg.name == "adafactor" \
        else adamw_init(cfg, params)


@torch.no_grad()
def apply_opt(cfg: OptimizerConfig, grads, state, params):
    """(new params, new state, the gradients' global norm before
    clipping); the inputs are not written."""
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    if cfg.name == "adafactor":
        new_p, new_s = adafactor_update(cfg, grads, state, params)
    else:
        new_p, new_s = adamw_update(cfg, grads, state, params)
    return new_p, new_s, gnorm

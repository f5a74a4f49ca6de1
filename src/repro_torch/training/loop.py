"""Training loop of the port (from `repro.training.loop`): a step with
microbatch gradient accumulation and optional int8 gradient compression,
checkpoint and resume, and the failure-injection hook of the restart
drill.

The step runs eagerly on one device (no mesh, no jit).  Gradients come
from autograd over `api.loss_fn`; on the card the hand-written kernels
run the forward and their plain versions give the backward
(`repro_torch.kernels._grad`).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import torch

from repro_torch.bridge import tree_leaves, tree_map, tree_unflatten
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data.pipeline import DataConfig, DataPipeline
from repro_torch.device import resolve_device
from repro_torch.models import api
from repro_torch.models.config import ModelConfig
from repro_torch.parallel import compression

from .optimizer import OptimizerConfig, apply_opt, init_opt

Params = Any


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    steps: int = 100
    microbatches: int = 1
    log_every: int = 10
    ckpt_every: int = 50
    ckpt_dir: str | None = None
    ckpt_keep: int = 3
    grad_compression: bool = False
    seed: int = 0


def value_and_grad(mcfg: ModelConfig, params: Params, batch: dict):
    """(the detached loss, the gradient tree, each leaf in its parameter's
    dtype; zeros where the loss does not reach a parameter, as JAX
    gives)."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    with torch.enable_grad():
        loss = api.loss_fn(mcfg, tree_unflatten(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), tree_unflatten(params, [
        torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)])


def make_train_step(mcfg: ModelConfig, ocfg: OptimizerConfig,
                    tcfg: TrainConfig) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, metrics).  With n
    microbatches the batch is cut to (n, B / n, ...) and the gradients
    summed in float32 in microbatch order, then divided by n; the loss is
    the mean of the microbatches' losses."""
    n_micro = tcfg.microbatches

    def train_step(params, opt_state, batch):
        if n_micro == 1:
            loss, grads = value_and_grad(mcfg, params, batch)
        else:
            split = {k: v.reshape(n_micro, v.shape[0] // n_micro, *v.shape[1:])
                     for k, v in batch.items()}
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                   device=p.device), params)
            lsum = 0.0
            for i in range(n_micro):
                loss_i, g = value_and_grad(mcfg, params,
                                           {k: v[i] for k, v in split.items()})
                grads = tree_map(torch.add, grads, g)
                lsum = lsum + loss_i
            grads = tree_map(lambda g: g / n_micro, grads)
            loss = lsum / n_micro

        new_state = {}
        if tcfg.grad_compression:
            grads, new_state["error_feedback"] = compression.compressed_gradients(
                grads, opt_state["error_feedback"])
        elif "error_feedback" in opt_state:
            new_state["error_feedback"] = opt_state["error_feedback"]
        params, new_state["inner"], gnorm = apply_opt(ocfg, grads, opt_state["inner"],
                                                      params)
        return params, new_state, {"loss": loss, "grad_norm": gnorm}

    return train_step


def init_train_state(mcfg: ModelConfig, ocfg: OptimizerConfig,
                     tcfg: TrainConfig, device=None) -> tuple[Params, Params]:
    """Random weights from tcfg.seed on `device` and a fresh optimizer
    state ({"inner"[, "error_feedback"]})."""
    params = api.init_params(mcfg, tcfg.seed, device=device)
    opt_state: dict = {"inner": init_opt(ocfg, params)}
    if tcfg.grad_compression:
        opt_state["error_feedback"] = compression.init_error_feedback(params)
    return params, opt_state


def train(mcfg: ModelConfig, ocfg: OptimizerConfig, tcfg: TrainConfig,
          dcfg: DataConfig, *, device=None, fail_at_step: int | None = None,
          log_fn: Callable[[str], None] = print) -> dict:
    """Run (or resume, from the latest checkpoint in tcfg.ckpt_dir) a
    training job on `device` (CUDA unless the caller names another).
    Returns {"losses": [(step, loss)] at every log_every-th and the last
    step, "params", "wall_s", "straggler_events"}.

    fail_at_step: raise after that step's checkpoint (fault injection for
    the restart drill)."""
    dev = resolve_device(device)
    step_fn = make_train_step(mcfg, ocfg, tcfg)
    params, opt_state = init_train_state(mcfg, ocfg, tcfg, dev)

    ckpt = CheckpointManager(tcfg.ckpt_dir, keep=tcfg.ckpt_keep) \
        if tcfg.ckpt_dir else None
    start_step = 0
    if ckpt is not None and ckpt.latest_step() is not None:
        (params, opt_state), meta = ckpt.restore((params, opt_state))
        start_step = int(meta["next_step"])
        log_fn(f"[train] resumed from step {start_step}")

    data = DataPipeline(dcfg)
    data.start(start_step)
    losses = []
    t0 = time.monotonic()
    try:
        for step in range(start_step, tcfg.steps):
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in data.next_batch(step).items()}
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            if step % tcfg.log_every == 0 or step == tcfg.steps - 1:
                loss = float(metrics["loss"])
                losses.append((step, loss))
                log_fn(f"[train] step={step} loss={loss:.4f} "
                       f"gnorm={float(metrics['grad_norm']):.3f}")
            if ckpt is not None and (step + 1) % tcfg.ckpt_every == 0:
                ckpt.save(step + 1, (params, opt_state),
                          meta={"next_step": step + 1})
            if fail_at_step is not None and step + 1 >= fail_at_step:
                raise RuntimeError(f"injected failure at step {step + 1}")
    finally:
        data.stop()
    if ckpt is not None:
        ckpt.save(tcfg.steps, (params, opt_state),
                  meta={"next_step": tcfg.steps})
    return {"losses": losses, "params": params,
            "wall_s": time.monotonic() - t0,
            "straggler_events": data.straggler_events}

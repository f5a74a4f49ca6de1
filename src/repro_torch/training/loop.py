"""Training loop of the port (from `repro.training.loop`): a step with
microbatch gradient accumulation and optional int8 gradient compression,
checkpoint and resume, and the failure-injection hook of the restart
drill.

The step runs eagerly (no jit).  Gradients come from autograd over
`api.loss_fn`; on the card the hand-written kernels run the forward and
their plain versions give the backward (`repro_torch.kernels._grad`).

On a mesh (`mesh=`, a `parallel.mesh.Mesh` over the ranks of a process
group; every rank runs the same calls) the model runs tensor-parallel
over "model" and data-parallel over ("pod", "data"): each rank holds its
blocks of the parameters (`api.init_params(mesh=)`) and of the optimizer
state (`sharding.optimizer_shardings`), takes its rows of the global
batch (`sharding.batch_spec`), and its loss is its share of the global
mean (labels of -1 ignored, so the count is global too).  The gradients
are summed over the DP ranks in one flattened all_reduce a step, after
the microbatches; the optimizer's and the compression's reductions are
over whole leaves, and checkpoints hold whole leaves (rank 0 writes;
every rank restores its blocks).  The numbers are JAX's unsharded
step's.  JAX's `train` replicates the optimizer state on a mesh; the
port keeps the rank's blocks, the layout JAX's dry run plans.

`hold="fsdp"` (`sharding.HOLDS`) holds the parameters and the optimizer
state as FSDP's blocks, over the DP axes too: each layer gathers its
leaves to their TP blocks while it runs, and their gradients come back
reduce-scattered (already summed over the DP ranks), so the flattened
DP sum leaves them out; the global-norm clip sums each leaf's squares
over every axis its held spec splits.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Any, Callable

import torch

from repro_torch.bridge import tree_leaves, tree_map, tree_paths, tree_unflatten
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data.pipeline import DataConfig, DataPipeline
from repro_torch.device import resolve_device
from repro_torch.models import api
from repro_torch.models.config import ModelConfig
from repro_torch.parallel import collectives as coll
from repro_torch.parallel import compression, sharding

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


def _local_value_and_grad(mcfg: ModelConfig, params: Params, batch: dict):
    """(the detached loss, the gradient tree, each leaf in its parameter's
    dtype; zeros where the loss does not reach a parameter, as JAX
    gives) of this rank's batch under the enclosing mesh, before any sum
    over DP ranks."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    with torch.enable_grad():
        loss = api.loss_fn(mcfg, tree_unflatten(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), tree_unflatten(params, [
        torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)])


def _split(mesh, rows: int):
    """The DP axes a global batch of `rows` rows splits over (None: every
    rank takes the whole batch, as `batch_spec` rules where they do not
    divide)."""
    return sharding.batch_spec(mesh, rows, 1)[0]


def _rows(mesh, batch: dict) -> dict:
    """This rank's rows of a global batch (`data_shardings`)."""
    specs = sharding.data_shardings(mesh, batch)
    return {k: sharding.local_slice(v, specs[k], mesh) for k, v in batch.items()}


DP_BUCKET = 1 << 28      # elements a flattened DP sum holds (1 GiB of float32)


def _dp_sum(mesh, dp, loss: torch.Tensor, grads: Params, summed: frozenset = frozenset()):
    """The loss shares and gradients summed over the DP axes `dp` in
    flattened float32 all_reduces, each over whole leaves of at most
    `DP_BUCKET` elements together (one, unless the gradients are larger;
    each leaf cast back to its dtype: an element's sum does not depend on
    the bucket); the leaves at the paths in `summed` (held leaves, whose
    gradients come back from their gather already summed) are left as
    they are."""
    if dp is None:
        return loss, grads
    paths = [sharding.path_str(p) for p, _ in tree_paths(grads)]
    leaves = tree_leaves(grads)
    out: list = list(leaves)
    buckets: list = [[]]
    size = 1                                  # the loss leads the first bucket
    for i, (p, g) in enumerate(zip(paths, leaves)):
        if p in summed:
            continue
        if buckets[-1] and size + g.numel() > DP_BUCKET:
            buckets.append([])
            size = 0
        buckets[-1].append(i)
        size += g.numel()
    for b, idx in enumerate(buckets):
        head = [loss.reshape(1).float()] if b == 0 else []
        flat = coll.all_reduce(torch.cat(head + [leaves[i].reshape(-1).float() for i in idx]),
                               mesh, dp)
        at = len(head)
        if b == 0:
            loss = flat[0]
        for i in idx:
            g = leaves[i]
            out[i] = flat[at:at + g.numel()].reshape(g.shape).to(g.dtype)
            at += g.numel()
    return loss, tree_unflatten(grads, out)


@functools.lru_cache(maxsize=8)
def _gathered(mcfg: ModelConfig, mesh, hold: str) -> frozenset:
    """The paths of the leaves a rank holds in another block than its TP
    block under `hold` (their gradients arrive summed over DP)."""
    held, comp = sharding.spec_maps(mcfg, mesh, hold)
    return frozenset(p for p, s in held.items() if s != comp[p])


def value_and_grad(mcfg: ModelConfig, params: Params, batch: dict, mesh=None,
                   hold: str | None = None):
    """(the detached loss, the gradient tree, each leaf in its parameter's
    dtype; zeros where the loss does not reach a parameter, as JAX
    gives).  On a mesh (`mesh`, default the enclosing `use_mesh`'s)
    `params` are this rank's blocks (held as `hold`, default the
    enclosing context's) and `batch` the global batch: the rank takes
    its rows, and the loss and the gradients (its blocks) are the global
    ones, summed over the DP ranks."""
    mesh = mesh if mesh is not None else sharding.current_mesh()
    if mesh is None:
        return _local_value_and_grad(mcfg, params, batch)
    hold = hold or sharding.current_hold()
    dp = _split(mesh, next(iter(batch.values())).shape[0])
    with sharding.use_mesh(mesh, data_split=dp is not None, hold=hold):
        loss, grads = _local_value_and_grad(mcfg, params, _rows(mesh, batch))
    return _dp_sum(mesh, dp, loss, grads, _gathered(mcfg, mesh, hold))


def param_specs(mcfg: ModelConfig, mesh, hold: str = "tp") -> dict:
    """'/'-joined path -> spec of every parameter on `mesh`, from the whole
    shapes (`api.param_shapes`): the blocks `api.init_params(mesh=,
    hold=)` draws (for "tp" with the whole-heads rule)."""
    return sharding.spec_maps(mcfg, mesh, hold)[0]


def state_specs(mcfg: ModelConfig, mesh, opt_state, hold: str = "tp") -> dict:
    """Specs by checkpoint path of a (params, opt_state) pair on `mesh`:
    the parameters' and `sharding.optimizer_shardings`' (over the whole
    shapes), both as held under `hold`."""
    out = {f"0/{k}": v for k, v in param_specs(mcfg, mesh, hold).items()}
    out.update({f"1/{k}": v for k, v in sharding.optimizer_shardings(
        mesh, sharding.whole_shapes(mcfg), opt_state, cfg=mcfg, hold=hold).items()})
    return out


def make_train_step(mcfg: ModelConfig, ocfg: OptimizerConfig,
                    tcfg: TrainConfig, mesh=None, hold: str = "tp") -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, metrics).  With n
    microbatches the batch is cut to (n, B / n, ...) and the gradients
    summed in float32 in microbatch order, then divided by n; the loss is
    the mean of the microbatches' losses.  On a mesh the state holds the
    rank's blocks and `batch` is the global batch: each microbatch's
    rows are split over the DP ranks, and the gradients summed over them
    once a step (`hold`: how the state is held, `sharding.HOLDS`)."""
    n_micro = tcfg.microbatches
    specs = None if mesh is None else param_specs(mcfg, mesh, hold)
    summed = frozenset() if mesh is None else _gathered(mcfg, mesh, hold)

    def grads_of(params, batch):
        if n_micro == 1:
            return _local_value_and_grad(mcfg, params, batch if mesh is None
                                         else _rows(mesh, batch))
        split = {k: v.reshape(n_micro, v.shape[0] // n_micro, *v.shape[1:])
                 for k, v in batch.items()}
        grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device), params)
        lsum = 0.0
        for i in range(n_micro):
            mb = {k: v[i] for k, v in split.items()}
            loss_i, g = _local_value_and_grad(mcfg, params,
                                              mb if mesh is None else _rows(mesh, mb))
            grads = tree_map(torch.add, grads, g)
            lsum = lsum + loss_i
        return lsum, grads

    def train_step(params, opt_state, batch):
        if mesh is None:
            loss, grads = grads_of(params, batch)
        else:
            dp = _split(mesh, next(iter(batch.values())).shape[0] // n_micro)
            with sharding.use_mesh(mesh, data_split=dp is not None, hold=hold):
                loss, grads = grads_of(params, batch)
            loss, grads = _dp_sum(mesh, dp, loss, grads, summed)
        if n_micro > 1:
            grads = tree_map(lambda g: g / n_micro, grads)
            loss = loss / n_micro
        new_state = {}
        if tcfg.grad_compression:
            grads, new_state["error_feedback"] = compression.compressed_gradients(
                grads, opt_state["error_feedback"], mesh, specs)
        elif "error_feedback" in opt_state:
            new_state["error_feedback"] = opt_state["error_feedback"]
        params, new_state["inner"], gnorm = apply_opt(ocfg, grads, opt_state["inner"],
                                                      params, mesh, specs)
        return params, new_state, {"loss": loss, "grad_norm": gnorm}

    return train_step


def init_train_state(mcfg: ModelConfig, ocfg: OptimizerConfig,
                     tcfg: TrainConfig, device=None, mesh=None,
                     hold: str = "tp") -> tuple[Params, Params]:
    """Random weights from tcfg.seed on `device` and a fresh optimizer
    state ({"inner"[, "error_feedback"]}); on a mesh this rank's blocks
    of both (held as `hold`), on the mesh's device."""
    params = api.init_params(mcfg, tcfg.seed, device=device, mesh=mesh, hold=hold)
    specs = None if mesh is None else param_specs(mcfg, mesh, hold)
    opt_state: dict = {"inner": init_opt(ocfg, params, mesh, specs)}
    if tcfg.grad_compression:
        opt_state["error_feedback"] = compression.init_error_feedback(params)
    return params, opt_state


def train(mcfg: ModelConfig, ocfg: OptimizerConfig, tcfg: TrainConfig,
          dcfg: DataConfig, *, device=None, mesh=None, hold: str = "tp",
          fail_at_step: int | None = None,
          log_fn: Callable[[str], None] = print) -> dict:
    """Run (or resume, from the latest checkpoint in tcfg.ckpt_dir) a
    training job on `device` (CUDA unless the caller names another), or
    on `mesh` (every rank calls it; the mesh's device): see the module
    docstring.  Returns {"losses": [(step, loss)] at every log_every-th
    and the last step, "params" (on a mesh the rank's blocks, held as
    `hold`), "wall_s", "straggler_events"}.

    fail_at_step: raise after that step's checkpoint (fault injection for
    the restart drill)."""
    dev = mesh.device if mesh is not None and device is None else resolve_device(device)
    step_fn = make_train_step(mcfg, ocfg, tcfg, mesh=mesh, hold=hold)
    params, opt_state = init_train_state(mcfg, ocfg, tcfg, dev, mesh=mesh, hold=hold)
    on_mesh = {} if mesh is None else {
        "mesh": mesh, "shardings": state_specs(mcfg, mesh, opt_state, hold)}

    ckpt = CheckpointManager(tcfg.ckpt_dir, keep=tcfg.ckpt_keep) \
        if tcfg.ckpt_dir else None
    start_step = 0
    if ckpt is not None and ckpt.latest_step() is not None:
        (params, opt_state), meta = ckpt.restore((params, opt_state), **on_mesh)
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
                          meta={"next_step": step + 1}, **on_mesh)
            if fail_at_step is not None and step + 1 >= fail_at_step:
                raise RuntimeError(f"injected failure at step {step + 1}")
    finally:
        data.stop()
    if ckpt is not None:
        ckpt.save(tcfg.steps, (params, opt_state),
                  meta={"next_step": tcfg.steps}, **on_mesh)
    return {"losses": losses, "params": params,
            "wall_s": time.monotonic() - t0,
            "straggler_events": data.straggler_events}

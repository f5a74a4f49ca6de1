"""GPipe-style pipeline parallelism of the port (from
`repro.parallel.pipeline`) over a named mesh axis: each rank of the axis
holds one stage, a contiguous block of the model's repeated layers, and
microbatches stream through on the schedule of JAX's shard_map version,
n_micro + n_stages - 1 ticks.

At every tick each stage runs its layers on its input (stage 0 injects
microbatch t, the others take what their predecessor sent), the last
stage keeps its output for microbatch t - (n_stages - 1), and the
activations shift one stage on around the ring (`collectives.shift`,
`batch_isend_irecv` over the axis's group; its backward shifts the
gradients back).  The output is the last stage's buffer summed over the
axis (`all_reduce`, identity backward), so every rank holds it in
microbatch order.  Every rank builds the same graph (where JAX selects
with `jnp.where`, so does this), which keeps the ranks' backward
collectives in step; a stage's parameters get their gradient once.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.bridge import tree_leaves, tree_map
from repro_torch.parallel import collectives as coll

Params = Any


def split_stages(stacked_params: Params, n_stages: int) -> Params:
    """(L, ...) stacked layer params -> (n_stages, L / n_stages, ...)."""
    def re(x):
        n = x.shape[0]
        if n % n_stages:
            raise ValueError(f"{n} layers do not split into {n_stages} stages")
        return x.reshape(n_stages, n // n_stages, *x.shape[1:])
    return tree_map(re, stacked_params)


def pipeline_apply(layer_fn: Callable, stage_params: Params, x: torch.Tensor, *,
                   mesh, axis: str = "pp") -> torch.Tensor:
    """Run x (n_micro, mb, ...) through the pipeline on `axis`.

    layer_fn(params_slice, h) -> h applies one stage's layer block.
    `stage_params`: this rank's stage, its block of `split_stages`'
    output along `axis` (leading dim 1).  Returns the outputs in
    microbatch order, (n_micro, mb, ...), on every rank."""
    n_stages = mesh.shape[axis]
    stage = mesh.coord(axis)
    if any(t.shape[0] != 1 for t in tree_leaves(stage_params)):
        raise ValueError("stage_params must hold this rank's stage (leading dim 1)")
    params = tree_map(lambda a: a[0], stage_params)
    n_micro = x.shape[0]
    first = torch.tensor(stage == 0, device=x.device)
    last = torch.tensor(stage == n_stages - 1, device=x.device)
    cur = torch.zeros_like(x[0])
    outs = []
    total = n_micro + n_stages - 1
    for t in range(total):
        h_out = layer_fn(params, torch.where(first, x[min(t, n_micro - 1)], cur))
        if t >= n_stages - 1:
            outs.append(h_out)      # microbatch t - (n_stages - 1), kept by the last stage
        if t < total - 1:           # the last tick's shift would carry nothing
            cur = coll.shift(h_out, mesh, axis)
    buf = torch.stack(outs)
    return coll.all_reduce(torch.where(last, buf, torch.zeros_like(buf)), mesh, axis)

"""The collectives explicit tensor parallelism needs, over the axes of a
`parallel.mesh.Mesh`: a sum over "model" (after a row-parallel product or
a vocab-parallel lookup), the gather of column shards (the vocab, rwkv6's
receptance, rglru's recurrent input) and, over "data", of a cluster's
per-step events, the all-to-all of the shard_map MoE dispatch and the
broadcast of rank 0's sampled tokens (and of a cluster's clock).

Each is a no-op over an axis of one rank (and with no mesh), and each
counts its calls in `COUNTS` where it runs, as the kernel wrappers
count launches.  gloo carries all four for CUDA tensors (all_reduce in
bfloat16 too; the list form of all-to-all it refuses, so the dispatch
uses `all_to_all_single`), which lets several ranks share one card;
NCCL carries them between cards.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

# calls that ran, by collective; single-writer: the rank's own thread
COUNTS = {"all_reduce": 0, "all_gather": 0, "all_to_all": 0, "broadcast": 0}


def reset() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


def _size(mesh, axes) -> int:
    if mesh is None:
        return 1
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    n = 1
    for a in axes:
        n *= mesh.shape.get(a, 1)
    return n


def all_reduce(x: torch.Tensor, mesh, axes="model") -> torch.Tensor:
    """The sum of x over `axes`, on every rank.  Reduces in place when x
    is contiguous: the caller passes a tensor it does not read again."""
    if _size(mesh, axes) == 1:
        return x
    y = x.contiguous()
    dist.all_reduce(y, group=mesh.group(axes))
    COUNTS["all_reduce"] += 1
    return y


def all_gather(x: torch.Tensor, mesh, axes="model", dim: int = -1) -> torch.Tensor:
    """Every rank's x over `axes`, concatenated along `dim` in rank order
    (the vocab shards of the logits back into one row)."""
    n = _size(mesh, axes)
    if n == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=mesh.group(axes))
    COUNTS["all_gather"] += 1
    return torch.cat(parts, dim)


def all_to_all(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """x's n equal chunks along dim 0 sent one to each rank of `axes`
    (chunk i to the rank at index i); returns the chunks received, in
    rank order along dim 0 (`lax.all_to_all(split_axis=0, concat_axis=0,
    tiled=True)`)."""
    n = _size(mesh, axes)
    if n == 1:
        return x
    if x.shape[0] % n:
        raise ValueError(f"all_to_all: dim 0 of {tuple(x.shape)} does not split "
                         f"over {n} ranks")
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x.contiguous(), group=mesh.group(axes))
    COUNTS["all_to_all"] += 1
    return out


def broadcast(x: torch.Tensor, mesh) -> torch.Tensor:
    """Rank 0's x on every rank of the mesh (in place)."""
    if _size(mesh, tuple(mesh.shape) if mesh is not None else ()) == 1:
        return x
    y = x.contiguous()
    dist.broadcast(y, src=mesh.root, group=mesh.group(tuple(mesh.axis_names)))
    COUNTS["broadcast"] += 1
    return y

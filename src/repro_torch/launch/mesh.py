"""Device meshes of the port (from `repro.launch.mesh`): the builders of
`parallel.mesh.Mesh` over the ranks of a `torch.distributed` process
group.  Rank r runs on `cuda:(local_rank % device_count)`, or on the
CPU.

Nothing here touches a device or a process group when the module is
imported.  `make_production_mesh` gives only the shape and axes of the
production mesh (no devices): the sharding rules read nothing else.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

from repro_torch.parallel.mesh import Mesh, MeshShape


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """The production mesh's shape: 16 x 16 ("data", "model"), or 2 x 16 x
    16 ("pod", "data", "model") over two pods.  No device is touched."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return MeshShape(axes, dict(zip(axes, shape)))


def local_device(device_type: str = "cuda") -> torch.device:
    """This process's device: `cuda:(LOCAL_RANK or rank) % device_count`,
    or the CPU."""
    if device_type != "cuda":
        return torch.device(device_type)
    rank = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    return torch.device("cuda", rank % torch.cuda.device_count())


def make_host_mesh(model_axis: int | None = None, *, backend: str | None = None,
                   device_type: str = "cuda") -> Mesh:
    """A ("data", "model") mesh over the ranks of the initialised process
    group: model `model_axis`, else 2 where the world size is even (and
    above 1) and 1 otherwise, as the JAX `make_host_mesh`; data the rest.
    Every rank must call it, in the same order (it makes subgroups).

    `backend` (default: the process group's) must be the group's own.
    NCCL takes one card a rank: with more ranks than cards it raises and
    names gloo, which carries CUDA tensors for ranks that share a card;
    no backend is swapped in quietly."""
    n = _world(backend, device_type)
    m = model_axis or (2 if n % 2 == 0 and n > 1 else 1)
    if n % m:
        raise ValueError(f"model axis {m} does not divide {n} ranks")
    return make_mesh((n // m, m), ("data", "model"), backend=backend,
                     device_type=device_type)


def _world(backend: str | None, device_type: str) -> int:
    """The world size, after checking the backend against the group's and
    (NCCL) the ranks against the cards."""
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs an initialised process group "
                           "(torch.distributed.init_process_group)")
    have = dist.get_backend()
    backend = backend or have
    if backend != have:
        raise ValueError(f"the process group runs {have!r}, not {backend!r}")
    n = dist.get_world_size()
    if device_type == "cuda":
        cards = torch.cuda.device_count()
        if backend == "nccl" and n > cards:
            raise RuntimeError(
                f"nccl needs one card a rank: {n} ranks over {cards} card(s); "
                f"use backend='gloo' for ranks that share a card")
    return n


def make_mesh(shape, axis_names, *, backend: str | None = None,
              device_type: str = "cuda") -> Mesh:
    """A mesh of `shape` over the named axes (the counterpart of
    `jax.make_mesh`), rank r at the row-major coordinates of r, over
    every rank of the initialised process group (the shape's product
    must be the world size).  Every axis subset gets its process
    subgroup (the whole set: the world).  Every rank must call it, in
    the same order (it makes subgroups); NCCL and the cards as in
    `make_host_mesh`."""
    shape, names = tuple(int(v) for v in shape), tuple(axis_names)
    if len(shape) != len(names):
        raise ValueError(f"mesh shape {shape} does not match axes {names}")
    n = _world(backend, device_type)
    total = 1
    for v in shape:
        total *= v
    if total != n:
        raise ValueError(f"mesh {dict(zip(names, shape))} holds {total} ranks, the "
                         f"process group {n}")
    rank = dist.get_rank()
    strides = [1] * len(shape)
    for i in range(len(shape) - 2, -1, -1):
        strides[i] = strides[i + 1] * shape[i + 1]
    coords = [[(r // strides[i]) % shape[i] for i in range(len(shape))] for r in range(n)]
    # every rank builds every subgroup in the same order (new_group is
    # collective over the whole world): the single axes first, in order
    subsets = sorted((tuple(a for j, a in enumerate(names) if mask >> j & 1)
                      for mask in range(1, 2 ** len(names))), key=len)
    groups: dict = {}
    for key in subsets:
        if len(key) == len(names):
            groups[key] = dist.group.WORLD if n > 1 else None
            continue
        fixed = [i for i, a in enumerate(names) if a not in key]
        blocks: dict = {}
        for r in range(n):
            blocks.setdefault(tuple(coords[r][i] for i in fixed), []).append(r)
        for ranks in blocks.values():
            g = dist.new_group(ranks) if len(ranks) > 1 else None
            if rank in ranks:
                groups[key] = g
    dev = local_device(device_type)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return Mesh(names, dict(zip(names, shape)), rank, dev, groups)

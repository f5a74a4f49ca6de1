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
    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh needs an initialised process group "
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
    m = model_axis or (2 if n % 2 == 0 and n > 1 else 1)
    if n % m:
        raise ValueError(f"model axis {m} does not divide {n} ranks")
    d = n // m
    rank = dist.get_rank()
    shape = {"data": d, "model": m}
    # every rank builds every subgroup in the same order (new_group is
    # collective over the whole world)
    groups: dict = {}
    for key, blocks in (
            (("data",), [[i * m + j for i in range(d)] for j in range(m)]),
            (("model",), [[i * m + j for j in range(m)] for i in range(d)])):
        for ranks in blocks:
            g = dist.new_group(ranks) if len(ranks) > 1 else None
            if rank in ranks:
                groups[key] = g
    groups[("data", "model")] = dist.group.WORLD if n > 1 else None
    dev = local_device(device_type)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return Mesh(("data", "model"), shape, rank, dev, groups)

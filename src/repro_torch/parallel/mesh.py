"""The port's device mesh: one rank's view of a ("data", "model") grid of
the ranks of a `torch.distributed` process group (from the JAX `Mesh`).

A `Mesh` lays rank r at coordinates (r // model, r % model), row-major
as `jax.make_mesh` lays devices out.  Each axis has a process subgroup
(the ranks that differ only in that coordinate), and ("data", "model")
the whole group; the collectives of `parallel/collectives.py` run over
them.  A `MeshShape` is a mesh's shape and axes without ranks or
devices: the sharding rules read nothing else.  `launch/mesh.py` builds
both.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """One rank's view of the mesh: axis names, sizes (`shape`, name ->
    size, as a JAX mesh's), its coordinates, its device and one process
    group for each axis and for the axis pair (None where the group has
    one rank).  `rank` is this rank's index in the mesh, `root` the
    global rank of the mesh's index 0 (a replica's mesh starts past 0)."""
    axis_names: tuple
    shape: dict
    rank: int
    device: torch.device
    groups: dict
    root: int = 0

    @property
    def size(self) -> int:
        n = 1
        for v in self.shape.values():
            n *= v
        return n

    def coord(self, name: str) -> int:
        """This rank's index along axis `name` (0 for an absent axis)."""
        if name not in self.shape:
            return 0
        names = list(self.axis_names)
        stride = 1
        for a in names[names.index(name) + 1:]:
            stride *= self.shape[a]
        return (self.rank // stride) % self.shape[name]

    def axis_rank(self, axes) -> int:
        """This rank's index in the flattened grid of `axes` (a name or a
        tuple of names, row-major)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        r = 0
        for a in axes:
            r = r * self.shape.get(a, 1) + self.coord(a)
        return r

    def axis_peer(self, axis: str, index: int) -> int:
        """The global rank of the rank at `index` along `axis` whose other
        coordinates are this rank's."""
        names = list(self.axis_names)
        stride = 1
        for a in names[names.index(axis) + 1:]:
            stride *= self.shape[a]
        return self.root + self.rank + (index - self.coord(axis)) * stride

    def group(self, axes):
        """The process group over `axes` (a name or a tuple of names);
        None when it holds this rank alone."""
        key = (axes,) if isinstance(axes, str) else tuple(
            a for a in self.axis_names if a in axes)
        return self.groups[key]


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's shape and axes without devices (`make_production_mesh`)."""
    axis_names: tuple
    shape: dict

"""Checkpoint manager of the port (from `repro.checkpoint.manager`):
atomic writes, keep-latest-K and exact resume, on the JAX package's
on-disk layout, so a checkpoint written by either package restores into
the other.

Layout (one directory per step):
    <dir>/step_000000042.tmp/...   -> atomically renamed to step_000000042/
        index.msgpack    {"step", "meta", "leaves": [{"path", "file",
                          "dtype", "shape"}]}
        arr_000000.npy   one file per leaf

Leaves are numbered in JAX's `tree_flatten_with_path` order (dict keys
sorted, list and tuple indices as path parts, None leaves left out) and
named by their path parts joined with "/"; a `(params, opt_state)` pair
is a tuple, so its paths start "0/" and "1/".  A bfloat16 leaf is
written as numpy writes JAX's: its raw 16-bit patterns under the void
descr "<V2", with "bfloat16" in the index; restore reads each leaf by
the index's dtype.  The index is msgpack where `msgpack` imports, else
JSON (as in JAX); the reader tells them apart by the first byte, so a
JSON index reads back anywhere.

On a mesh (`mesh=` with `shardings=`, the leaves' specs by checkpoint
path, as `sharding.param_spec_map` gives them) a rank holds its blocks:
`save` gathers every leaf whole and rank 0 writes it (as JAX's
`device_get` does), so a checkpoint crosses packages and mesh shapes;
`restore` has every rank read the whole leaf and keep its block
(`sharding.local_slice`): the elastic reshard, e.g. saved on a (2, 2)
mesh and restored on (4, 1), or saved from FSDP's blocks
(`training.loop.state_specs(hold="fsdp")`) and restored as TP blocks.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.bridge import tree_paths, tree_unflatten
from repro_torch.parallel import sharding

try:
    import msgpack
    _HAVE_MSGPACK = True
except ImportError:
    _HAVE_MSGPACK = False

Params = Any


def _path_names(tree) -> list[tuple[str, Any]]:
    return [("/".join(str(p) for p in path), leaf) for path, leaf in tree_paths(tree)]


def _write_leaf(path: str, t) -> tuple[str, list]:
    """Write one leaf as .npy; (its dtype's name, its shape)."""
    t = torch.as_tensor(t).detach().cpu().contiguous()
    with open(path, "wb") as f:
        if t.dtype == torch.bfloat16:
            bits = t.view(torch.int16).numpy()
            np.lib.format.write_array_header_1_0(
                f, {"descr": "<V2", "fortran_order": False, "shape": bits.shape})
            f.write(bits.tobytes())
        else:
            np.save(f, t.numpy())
    return str(t.dtype).removeprefix("torch."), list(t.shape)


def _read_leaf(path: str, dtype: str) -> torch.Tensor:
    arr = np.load(path)
    if dtype == "bfloat16":           # raw bits in a 2-byte void array
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, dtype=np.dtype(dtype), order="C"))


def _encode_index(index: dict) -> bytes:
    return msgpack.packb(index) if _HAVE_MSGPACK else json.dumps(index).encode()


def _decode_index(blob: bytes) -> dict:
    if blob[:1] == b"{":              # JSON (a msgpack map never starts so)
        return json.loads(blob.decode())
    if not _HAVE_MSGPACK:
        raise RuntimeError("checkpoint index is msgpack, and msgpack is not "
                           "installed")
    return msgpack.unpackb(blob)


@dataclasses.dataclass
class CheckpointManager:
    directory: str
    keep: int = 3

    def __post_init__(self):
        os.makedirs(self.directory, exist_ok=True)

    # -- save -----------------------------------------------------------
    def save(self, step: int, tree: Params, meta: dict | None = None, *,
             mesh=None, shardings: dict | None = None) -> str:
        """Write `tree` as step `step` (atomically; a step already published
        is kept).  On a mesh every rank calls it with its blocks: the
        leaves are gathered whole, rank 0 writes, and all return once the
        step is published."""
        name = f"step_{step:09d}"
        final = os.path.join(self.directory, name)
        if mesh is not None:
            whole = sharding.gather_tree(tree, shardings, mesh)
            if mesh.rank == 0:
                self._write(step, whole, meta, final)
            _barrier(mesh)
            return final
        return self._write(step, _path_names(tree), meta, final)

    def _write(self, step: int, leaves: list, meta: dict | None, final: str) -> str:
        tmp = final + ".tmp"
        if os.path.exists(final):      # idempotent: step already published
            return final
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        index = {"step": step, "meta": meta or {}, "leaves": []}
        for i, (path, leaf) in enumerate(leaves):
            fn = f"arr_{i:06d}.npy"
            dtype, shape = _write_leaf(os.path.join(tmp, fn), leaf)
            index["leaves"].append({"path": path, "file": fn, "dtype": dtype,
                                    "shape": shape})
        with open(os.path.join(tmp, "index.msgpack"), "wb") as f:
            f.write(_encode_index(index))
            f.flush()
            os.fsync(f.fileno())
        os.rename(tmp, final)                      # atomic publish
        self._gc()
        return final

    # -- restore ----------------------------------------------------------
    def steps(self) -> list[int]:
        out = []
        for d in os.listdir(self.directory):
            if d.startswith("step_") and not d.endswith(".tmp"):
                try:
                    out.append(int(d.split("_")[1]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> int | None:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, template: Params, step: int | None = None,
                shardings: dict | None = None, *, mesh=None) -> tuple[Params, dict]:
        """(the checkpoint at `step`, default the latest, in the structure
        of `template`, its meta).  Each leaf takes the index's dtype and
        the template leaf's device; KeyError for a leaf the checkpoint
        lacks, ValueError for a shape that differs from the template's.
        `shardings` over `mesh`: the template holds this rank's blocks,
        and each leaf read whole is cut to its block under its spec."""
        if (shardings is None) != (mesh is None):
            raise ValueError("restore takes shardings and mesh together")
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        d = os.path.join(self.directory, f"step_{step:09d}")
        with open(os.path.join(d, "index.msgpack"), "rb") as f:
            index = _decode_index(f.read())
        by_path = {e["path"]: e for e in index["leaves"]}
        out_leaves = []
        for path, leaf in _path_names(template):
            e = by_path.get(path)
            if e is None:
                raise KeyError(f"checkpoint missing leaf {path}")
            t = _read_leaf(os.path.join(d, e["file"]), e["dtype"])
            want = tuple(getattr(leaf, "shape", t.shape))
            if mesh is not None:
                t = sharding.local_slice(t, shardings[path], mesh)
            if tuple(t.shape) != want:
                raise ValueError(f"shape mismatch for {path}: ckpt "
                                 f"{tuple(t.shape)} vs template {want}")
            if isinstance(leaf, torch.Tensor):
                t = t.to(leaf.device)
            out_leaves.append(t)
        return tree_unflatten(template, out_leaves), index["meta"]

    def _gc(self) -> None:
        steps = self.steps()
        for s in steps[:-self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:09d}"),
                          ignore_errors=True)


def _barrier(mesh) -> None:
    group = mesh.group(tuple(mesh.axis_names))
    if group is not None:
        dist.barrier(group=group)

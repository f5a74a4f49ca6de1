"""Roofline analysis of a traced dry-run step (from `repro.launch.analyze`).

Hardware model: one NVIDIA H100 SXM (700 W), from its data sheet:
989 TFLOP/s dense bf16 on the tensor cores, 3.35 TB/s of HBM3 and 450
GB/s each way of NVLink.  These are the card's peaks, derived, not
measured.  A production mesh axis of 16 cards spans two 8-card hosts,
whose link between them is slower than NVLink, so the collective term
(bytes over the NVLink rate) is a lower bound.

JAX reads its counts off the compiled, SPMD-partitioned module; the port
counts what one rank's traced step does (`TraceCounter`), so every
quantity is per device, as JAX's are:

  * FLOPs from `torch.utils.flop_counter.FlopCounterMode` (the products
    and attention; elementwise work is not counted, as XLA counts little
    of it either);
  * bytes: every aten op's inputs plus outputs, counted unfused (views
    move nothing and are skipped).  Like XLA's unfused "bytes accessed",
    this is an upper bound on HBM traffic: a fused kernel reads its
    intermediates from registers or shared memory;
  * collective bytes: each collective's result bytes, by XLA's op names
    (`parallel.collectives.BYTES`);
  * the peak of live bytes: every storage the step creates, from its
    creation until its last tensor dies (counted by storage, not by
    tensor, since views share one), on top of the rank's inputs.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Any

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as _pt_leaves

from repro_torch.bridge import tree_leaves, tree_paths

PEAK_FLOPS = 989e12          # bf16 dense, tensor cores, per card
HBM_BW = 3.35e12             # bytes/s per card
LINK_BW = 450e9              # bytes/s per NVLink direction

COLLECTIVE_OPS = ("all-reduce", "all-gather", "reduce-scatter",
                  "all-to-all", "collective-permute")


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def storage_bytes(tree: Any) -> int:
    """The bytes of the distinct storages under a tree's tensors."""
    seen: dict = {}
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            seen[_storage_key(t)] = t.untyped_storage().nbytes()
    return sum(seen.values())


class TraceCounter(TorchDispatchMode):
    """Counts, for the aten ops dispatched inside it: `bytes` (each
    non-view op's tensor inputs plus outputs) and `peak` (the most live
    bytes at once: `hold` registers the inputs, then every storage an op
    creates is live until the last tensor on it is freed)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._refs: dict[int, list] = {}      # storage -> [nbytes, live tensors]

    def _release(self, key: int) -> None:
        ent = self._refs.get(key)
        if ent is None:
            return
        ent[1] -= 1
        if ent[1] == 0:
            self.live -= ent[0]
            del self._refs[key]

    def _track(self, t: torch.Tensor) -> None:
        key = _storage_key(t)
        ent = self._refs.get(key)
        if ent is None:
            ent = self._refs[key] = [t.untyped_storage().nbytes(), 0]
            self.live += ent[0]
            self.peak = max(self.peak, self.live)
        ent[1] += 1
        weakref.finalize(t, self._release, key)

    def hold(self, tree: Any) -> None:
        """Count the storages of `tree`'s tensors as live (the inputs)."""
        for t in tree_leaves(tree):
            if isinstance(t, torch.Tensor):
                self._track(t)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = [t for t in _pt_leaves(out) if isinstance(t, torch.Tensor)]
        if not func.is_view:
            ins = [t for t in _pt_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
            self.bytes += sum(t.numel() * t.element_size() for t in ins + outs)
        for t in outs:
            self._track(t)
        return out


@dataclasses.dataclass
class Roofline:
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    collectives: dict
    t_compute: float
    t_memory: float
    t_collective: float
    bottleneck: str
    model_flops: float
    model_flops_ratio: float          # useful / traced compute
    arg_bytes_per_device: float = 0.0
    temp_bytes_per_device: float = 0.0
    out_bytes_per_device: float = 0.0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def roofline_from_trace(counts: dict, model_flops_global: float,
                        n_devices: int) -> Roofline:
    """The three roofline terms of one rank's traced step.  `counts`:
    {"flops", "bytes", "collectives" (by op, with "total"), "arg_bytes",
    "temp_bytes", "out_bytes"}."""
    flops, nbytes = float(counts["flops"]), float(counts["bytes"])
    colls = {k: float(v) for k, v in counts["collectives"].items()}
    cb = colls["total"]
    t_c, t_m, t_x = flops / PEAK_FLOPS, nbytes / HBM_BW, cb / LINK_BW
    terms = {"compute": t_c, "memory": t_m, "collective": t_x}
    mf_dev = model_flops_global / max(n_devices, 1)
    return Roofline(
        flops_per_device=flops, bytes_per_device=nbytes,
        collective_bytes_per_device=cb, collectives=colls,
        t_compute=t_c, t_memory=t_m, t_collective=t_x,
        bottleneck=max(terms, key=terms.get), model_flops=model_flops_global,
        model_flops_ratio=(mf_dev / flops) if flops else 0.0,
        arg_bytes_per_device=float(counts["arg_bytes"]),
        temp_bytes_per_device=float(counts["temp_bytes"]),
        out_bytes_per_device=float(counts["out_bytes"]))


# --- MODEL_FLOPS ------------------------------------------------------------

def _named(params_shape: Any):
    for path, leaf in tree_paths(params_shape):
        yield "/".join(str(k) for k in path), leaf


def matmul_param_counts(params_shape: Any) -> tuple[float, float]:
    """(total, active) matmul-participating params.  MoE experts count
    `top_k/n_experts` toward active. Embedding tables excluded, LM head
    included (it is real matmul compute).  As in JAX, `active` is not
    corrected for the experts here (`model_flops_for` does it)."""
    total = active = 0.0
    for name, leaf in _named(params_shape):
        if leaf.dim() < 2:
            continue
        if name.endswith("embed") or "dec_pos" in name:
            continue
        n = 1.0
        for d in leaf.shape:
            n *= d
        total += n
        active += n
    return total, active


def model_flops_for(cfg, shape, params_shape) -> float:
    """6*N*D (train) / 2*N*D (prefill) / 2*N_active*B (decode, per step),
    N = matmul params (active for MoE)."""
    total = 0.0
    expert_total = 0.0
    for name, leaf in _named(params_shape):
        if leaf.dim() < 2 or name.endswith("embed") or "dec_pos" in name:
            continue
        n = 1.0
        for d in leaf.shape:
            n *= d
        total += n
        if "experts_" in name:
            expert_total += n
    active = total
    if cfg.use_moe and cfg.n_experts:
        active = total - expert_total * (1.0 - cfg.top_k / cfg.n_experts)
    tokens = shape.global_batch * shape.seq_len
    if shape.kind == "train":
        return 6.0 * active * tokens
    if shape.kind == "prefill":
        return 2.0 * active * tokens
    return 2.0 * active * shape.global_batch

"""Launch wrapper of the CUDA RG-LRU scan kernels (`csrc/rglru_scan.cu`),
the port of `rglru_scan_pallas`.

Takes a, b (B, S, W) and h0 (B, W) on one CUDA device.  a and b are
float32, bfloat16 or float16 (b is taken in a's type where that is
exact, else both in float32); h0 float32 or a's type (else converted to float32).
The batch and time strides are passed to the kernel, so a slice such as
the last step of an earlier scan needs no copy; a channel axis without
unit stride is copied to one.  Returns h (B, S, W) contiguous in a's
type, as the JAX kernel does, from a float32 recurrence.  The plan
(`kernels/_scan_plan.py`) picks the route: the step kernel for S = 1,
else the cluster kernel, with no larger cluster than the card holds
(the CUDA occupancy query).  Launches on PyTorch's current stream.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build as B
from repro_torch.kernels import _scan_plan

SCAN = B.Launcher("rglru_scan", "rglru_scan", [
    B.VOID_P, B.VOID_P, B.VOID_P, B.VOID_P, B.INT, B.INT, B.INT,
    B.INT64, B.INT64, B.INT64, B.INT64, B.INT64, B.INT, B.INT, B.INT, B.INT,
    B.VOID_P, ctypes.POINTER(ctypes.c_int)])
DTYPES = (torch.float32, torch.bfloat16, torch.float16)
# the kernel a launch ran, as the C entry reports it, and how many launches
# ran each (a record beside `SCAN.launches`, which counts them all)
KERNELS = {1: "rglru_step_kernel", 2: "rglru_scan_kernel"}
kernel_launches = dict.fromkeys(KERNELS.values(), 0)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def cluster_capacity(index: int, cluster: int, chunk: int, dtype: int,
                     h0_dtype: int) -> int:
    """Clusters of `cluster` blocks the card holds at once
    (`rglru_scan_max_clusters`, the CUDA occupancy query)."""
    with torch.cuda.device(index):
        fn = B.library("rglru_scan").rglru_scan_max_clusters
        fn.argtypes = [B.INT] * 4
        fn.restype = B.INT
        got = fn(cluster, chunk, dtype, h0_dtype)
    if got < 0:
        msg = B.library("rglru_scan").rglru_scan_error_string(-got)
        raise RuntimeError(f"rglru_scan: cluster occupancy query failed: CUDA "
                           f"error {-got} ({msg.decode(errors='replace')})")
    return got


def launch_plan(b: int, s: int, w: int, dtype: int, h0_dtype: int,
                index: int) -> _scan_plan.ScanPlan:
    """The plan a launch takes: the shapes' plan, its cluster halved
    until the card holds at least one cluster of it."""
    es = 4 if dtype == 0 else 2
    plan = _scan_plan.scan_plan(b, s, w, es, sms=_sm_count(index))
    while plan.cluster > 1 and cluster_capacity(
            index, plan.cluster, plan.chunk, dtype, h0_dtype) < 1:
        plan = _scan_plan.scan_plan(b, s, w, es, sms=_sm_count(index),
                                    max_cluster=plan.cluster // 2)
    return plan


def rglru_scan_cuda(a: torch.Tensor, b: torch.Tensor,
                    h0: torch.Tensor) -> torch.Tensor:
    B.require_cuda("rglru_scan", a, b, h0)
    if a.dim() != 3 or b.shape != a.shape or h0.shape != (a.shape[0], a.shape[2]):
        raise ValueError(f"rglru_scan: a, b (B, S, W) and h0 (B, W); got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}, {tuple(h0.shape)}")
    if a.dtype not in DTYPES or b.dtype not in DTYPES or not h0.is_floating_point():
        raise TypeError(f"rglru_scan: a and b must be float32, bfloat16 or float16, h0 "
                        f"floating; got {a.dtype}, {b.dtype}, {h0.dtype}")
    out_dtype = a.dtype
    if b.dtype != a.dtype:               # float32 holds either exactly
        a, b = a.float(), b.float()
    if h0.dtype not in (torch.float32, a.dtype):
        h0 = h0.float()
    a, b, h0 = (t if t.stride(-1) == 1 else t.contiguous() for t in (a, b, h0))
    bsz, s, w = a.shape
    out = torch.empty((bsz, s, w), dtype=a.dtype, device=a.device)
    if out.numel() == 0:
        return out.to(out_dtype)
    code = B.dtype_code(a, "rglru_scan")
    h0_code = B.dtype_code(h0, "rglru_scan h0")
    plan = launch_plan(bsz, s, w, code, h0_code, a.device.index or 0)
    # strides of size-1 dims as 0: they are never stepped, and PyTorch may
    # give them any value (which would cost the kernel its vector loads)
    sb, ss = (lambda t: t.stride(0) if bsz > 1 else 0), \
        (lambda t: t.stride(1) if s > 1 else 0)
    ran = ctypes.c_int(0)
    SCAN(a.data_ptr(), b.data_ptr(), h0.data_ptr(), out.data_ptr(), bsz, s, w,
         sb(a), ss(a), sb(b), ss(b), sb(h0), plan.cluster, plan.chunk, code,
         h0_code, B.stream(a), ctypes.byref(ran))
    if ran.value in KERNELS:
        kernel_launches[KERNELS[ran.value]] += 1
    return out.to(out_dtype)

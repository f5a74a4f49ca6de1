"""Launch wrappers of the CUDA fused RMSNorm(+residual) kernels
(`csrc/fused_norm.cu`), the port of `fused_rmsnorm_pallas` and
`fused_rmsnorm_residual_pallas`.

Take (N, d) row-major tensors on one CUDA device, float32 or bfloat16,
any d (one warp a row up to d 1024, one block a row above, the row held
in registers up to d 8192 and walked twice beyond); row inputs that are
not contiguous are copied; allocate the outputs and launch on PyTorch's
current stream.  Loads and
stores are 16-byte vectors where d is a multiple of 8 (bfloat16) or 4
(float32) and every pointer is aligned, else single values
(`load_width`).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.kernels import _build as B

REG_MAX_D = 8192           # widest row held in registers (kMaxD); wider: two passes
WARP_MAX_D = 1024          # widest row of the one-warp form (kWarpMaxD)
ROW_THREADS = 256          # threads of the one-row-a-block form (kRowThreads)

RMSNORM = B.Launcher("fused_norm", "fused_rmsnorm", [
    B.VOID_P, B.VOID_P, B.VOID_P, B.INT, B.INT, B.INT, B.FLOAT, B.INT, B.INT,
    B.VOID_P])
RMSNORM_RESIDUAL = B.Launcher("fused_norm", "fused_rmsnorm_residual", [
    B.VOID_P, B.VOID_P, B.VOID_P, B.VOID_P, B.VOID_P, B.INT, B.INT, B.INT,
    B.FLOAT, B.INT, B.INT, B.VOID_P])


@dataclass(frozen=True)
class NormLayout:
    """How `csrc/fused_norm.cu` cuts a row: `threads` threads a row (32:
    one warp; 256: one block), each holding chunks t, t + threads, ... of
    `vec` values (`chunks` of them at most); up to d 8192 `vec * chunks`
    values a thread are rounded up to 8, 16, 24 or 32 (registers); beyond,
    the wide kernel walks every chunk of the row twice."""
    threads: int
    vec: int
    chunks: int


def norm_layout(d: int, vec: int) -> NormLayout:
    """The kernel's layout of a d-wide row read `vec` values at a time."""
    if d < 1 or d % vec:
        raise ValueError(f"fused_rmsnorm: no layout for d {d}, vec {vec}")
    threads = 32 if d <= WARP_MAX_D else ROW_THREADS
    if d > REG_MAX_D:
        return NormLayout(threads, vec, -(-(d // vec) // threads))
    vals = -(-(d // vec) // threads) * vec
    return NormLayout(threads, vec, next(v for v in (8, 16, 24, 32) if vals <= v) // vec)


def load_width(d: int, rows: list[torch.Tensor], scale: torch.Tensor) -> int:
    """16-byte vectors (8 bfloat16 or 4 float32 values) where d is a
    multiple of their width and every pointer is aligned to them (scale
    to min(16, width * its size)); otherwise 1."""
    vec = 16 // rows[0].element_size()
    ok = d % vec == 0 and all(t.data_ptr() % 16 == 0 for t in rows) and \
        scale.data_ptr() % min(16, vec * scale.element_size()) == 0
    return vec if ok else 1


def _check(what: str, rows: list[torch.Tensor], scale: torch.Tensor):
    """The row inputs and scale as the kernels read them (contiguous:
    copied where not); raises on shapes or dtypes they do not take."""
    B.require_cuda(what, *rows, scale)
    x = rows[0]
    if x.dim() != 2 or x.shape[1] < 1:
        raise ValueError(f"{what}: x must be (N, d) with d > 0, got "
                         f"{tuple(x.shape)}")
    for t in rows:
        if t.shape != x.shape or t.dtype != x.dtype:
            raise ValueError(f"{what}: row inputs must share shape and dtype")
    if scale.shape != (x.shape[1],):
        raise ValueError(f"{what}: scale must be ({x.shape[1]},)")
    return [t.contiguous() for t in rows], scale.contiguous()


def fused_rmsnorm_cuda(x: torch.Tensor, scale: torch.Tensor, *,
                       eps: float = 1e-6) -> torch.Tensor:
    (x,), scale = _check("fused_rmsnorm", [x], scale)
    out = torch.empty_like(x)
    n, d = x.shape
    if n:
        RMSNORM(x.data_ptr(), scale.data_ptr(), out.data_ptr(), n, d,
                load_width(d, [x, out], scale), eps,
                B.dtype_code(x, "fused_rmsnorm"),
                B.dtype_code(scale, "fused_rmsnorm scale"), B.stream(x))
    return out


def fused_rmsnorm_residual_cuda(x: torch.Tensor, res: torch.Tensor,
                                scale: torch.Tensor, *, eps: float = 1e-6):
    (x, res), scale = _check("fused_rmsnorm_residual", [x, res], scale)
    s = torch.empty_like(x)
    out = torch.empty_like(x)
    n, d = x.shape
    if n:
        RMSNORM_RESIDUAL(
            x.data_ptr(), res.data_ptr(), scale.data_ptr(), s.data_ptr(),
            out.data_ptr(), n, d, load_width(d, [x, res, s, out], scale), eps,
            B.dtype_code(x, "fused_rmsnorm_residual"),
            B.dtype_code(scale, "fused_rmsnorm_residual scale"), B.stream(x))
    return s, out

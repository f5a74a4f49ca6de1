"""Launch wrappers of the CUDA fused RMSNorm(+residual) kernels
(`csrc/fused_norm.cu`), the port of `fused_rmsnorm_pallas` and
`fused_rmsnorm_residual_pallas`.

Take (N, d) row-major tensors on one CUDA device, float32 or bfloat16,
d <= 8192 (one warp a row up to d 2048, one block a row above);
allocate the outputs and launch on PyTorch's current stream.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build as B

MAX_D = 8192

RMSNORM = B.Launcher("fused_norm", "fused_rmsnorm", [
    B.VOID_P, B.VOID_P, B.VOID_P, B.INT, B.INT, B.FLOAT, B.INT, B.INT,
    B.VOID_P])
RMSNORM_RESIDUAL = B.Launcher("fused_norm", "fused_rmsnorm_residual", [
    B.VOID_P, B.VOID_P, B.VOID_P, B.VOID_P, B.VOID_P, B.INT, B.INT,
    B.FLOAT, B.INT, B.INT, B.VOID_P])


def _check(what: str, rows: list[torch.Tensor], scale: torch.Tensor) -> None:
    B.require_cuda(what, *rows, scale)
    x = rows[0]
    if x.dim() != 2 or not 0 < x.shape[1] <= MAX_D:
        raise ValueError(f"{what}: x must be (N, d) with 0 < d <= {MAX_D}, "
                         f"got {tuple(x.shape)}")
    for t in rows:
        if t.shape != x.shape or t.dtype != x.dtype or not t.is_contiguous():
            raise ValueError(f"{what}: row inputs must share shape and "
                             f"dtype and be contiguous")
    if scale.shape != (x.shape[1],) or not scale.is_contiguous():
        raise ValueError(f"{what}: scale must be a contiguous ({x.shape[1]},)")


def fused_rmsnorm_cuda(x: torch.Tensor, scale: torch.Tensor, *,
                       eps: float = 1e-6) -> torch.Tensor:
    _check("fused_rmsnorm", [x], scale)
    out = torch.empty_like(x)
    n, d = x.shape
    if n:
        RMSNORM(x.data_ptr(), scale.data_ptr(), out.data_ptr(), n, d, eps,
                B.dtype_code(x, "fused_rmsnorm"),
                B.dtype_code(scale, "fused_rmsnorm scale"), B.stream(x))
    return out


def fused_rmsnorm_residual_cuda(x: torch.Tensor, res: torch.Tensor,
                                scale: torch.Tensor, *, eps: float = 1e-6):
    _check("fused_rmsnorm_residual", [x, res], scale)
    s = torch.empty_like(x)
    out = torch.empty_like(x)
    n, d = x.shape
    if n:
        RMSNORM_RESIDUAL(
            x.data_ptr(), res.data_ptr(), scale.data_ptr(), s.data_ptr(),
            out.data_ptr(), n, d, eps,
            B.dtype_code(x, "fused_rmsnorm_residual"),
            B.dtype_code(scale, "fused_rmsnorm_residual scale"), B.stream(x))
    return s, out

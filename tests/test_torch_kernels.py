"""Kernel parity of the PyTorch/CUDA port on the CPU: for each ported TPU
kernel (fused RMSNorm, fused RMSNorm+residual, fused MLP, flash
attention) the port's plain version is held against the JAX Pallas op
(interpret mode) and the JAX `ref.py` on the same numpy inputs.

Tolerances are those of the JAX package's own kernel tests: 1e-5 (norm,
MLP) and 3e-5 (flash) in float32, 2.5e-2 in bfloat16.  The CUDA kernels
themselves run only on the card (`chip_smoke.py`); here the tests show
that a CPU tensor takes the plain version without touching the build.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import flash_attention_ref as jax_flash_ref
from repro.kernels.fused_mlp.ops import fused_mlp as jax_mlp
from repro.kernels.fused_mlp.ref import fused_mlp_ref as jax_mlp_ref
from repro.kernels.fused_norm.ops import fused_rmsnorm as jax_norm
from repro.kernels.fused_norm.ops import fused_rmsnorm_residual as jax_norm_res
from repro.kernels.fused_norm.ref import fused_rmsnorm_ref as jax_norm_ref
from repro.kernels.fused_norm.ref import fused_rmsnorm_residual_ref as jax_norm_res_ref
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.fused_mlp import kernel as mlp_kernel
from repro_torch.kernels.fused_mlp import ops as mlp_ops
from repro_torch.kernels.fused_mlp.ref import fused_mlp_ref
from repro_torch.kernels.fused_norm import kernel as norm_kernel
from repro_torch.kernels.fused_norm import ops as norm_ops
from repro_torch.kernels.fused_norm.ref import (fused_rmsnorm_ref,
                                                fused_rmsnorm_residual_ref)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(a: np.ndarray, dtype: str):
    """The same numpy values as a JAX array and a torch tensor, both
    rounded to `dtype` (round to nearest even on both sides)."""
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)


def _close(port: torch.Tensor, ref, tol: float) -> None:
    np.testing.assert_allclose(port.float().numpy(), np.asarray(ref, np.float32),
                               rtol=tol, atol=tol)


# -- fused RMSNorm (+residual) -------------------------------------------------

@pytest.mark.parametrize("n,d,dtype", [
    (8, 16, "float32"),
    (5, 32, "float32"),       # rows not a multiple of the TPU block
    (4, 576, "float32"),      # smollm width at decode batch
    (6, 16, "bfloat16"),
    (16, 576, "bfloat16"),
])
def test_fused_rmsnorm_matches_jax(n, d, dtype):
    rng = np.random.default_rng(n * 7 + d)
    x_np = rng.standard_normal((2, n, d)).astype(np.float32)
    r_np = rng.standard_normal((2, n, d)).astype(np.float32)
    g_np = rng.standard_normal((d,)).astype(np.float32)
    tol = 2.5e-2 if dtype == "bfloat16" else 1e-5
    (xj, xt), (rj, rt), (gj, gt) = (_pair(a, dtype) for a in (x_np, r_np, g_np))

    y = fused_rmsnorm_ref(xt, gt)
    assert y.dtype == xt.dtype and y.shape == xt.shape
    _close(y, jax_norm(xj, gj, bt=4, interpret=True), tol)
    _close(y, jax_norm_ref(xj, gj), tol)

    s, y2 = fused_rmsnorm_residual_ref(xt, rt, gt)
    sj, yj = jax_norm_res(xj, rj, gj, bt=4, interpret=True)
    sr, yr = jax_norm_res_ref(xj, rj, gj)
    for port, a, b in ((s, sj, sr), (y2, yj, yr)):
        _close(port, a, tol)
        _close(port, b, tol)


# -- fused MLP -----------------------------------------------------------------

@pytest.mark.parametrize("n,d,f,swiglu,dtype", [
    (8, 16, 32, True, "float32"),
    (10, 16, 48, False, "float32"),   # ragged + plain GELU (no gate)
    (3, 8, 8, True, "float32"),       # padding on both TPU block axes
    (4, 64, 96, True, "float32"),
    (6, 16, 32, True, "bfloat16"),
])
def test_fused_mlp_matches_jax(n, d, f, swiglu, dtype):
    rng = np.random.default_rng(n * 31 + f)
    x_np = rng.standard_normal((n, d)).astype(np.float32)
    ws_np = [(rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
             for s in ((d, f), (d, f), (f, d))]
    (xj, xt), (gj, gt), (ij, it), (oj, ot) = (
        _pair(a, dtype) for a in (x_np, *ws_np))
    tol = 2.5e-2 if dtype == "bfloat16" else 1e-5
    out = fused_mlp_ref(xt, gt if swiglu else None, it, ot, swiglu=swiglu)
    assert out.dtype == xt.dtype and out.shape == xt.shape
    _close(out, jax_mlp(xj, gj if swiglu else None, ij, oj, swiglu=swiglu,
                        bt=4, bf=16, interpret=True), tol)
    _close(out, jax_mlp_ref(xj, gj, ij, oj, swiglu=swiglu), tol)


# -- flash attention -----------------------------------------------------------

@pytest.mark.parametrize("b,sq,h,hkv,hd,window,dtype", [
    (2, 64, 4, 2, 32, None, "float32"),
    (1, 100, 4, 1, 64, None, "float32"),    # Sq not a multiple of the block
    (1, 48, 9, 3, 64, None, "float32"),     # smollm heads: GQA group 3
    (1, 64, 4, 2, 32, 24, "float32"),       # sliding window
    (2, 64, 4, 4, 32, None, "bfloat16"),
])
def test_flash_attention_matches_jax(b, sq, h, hkv, hd, window, dtype):
    rng = np.random.default_rng(sq * 7 + h)
    q_np = rng.standard_normal((b, sq, h, hd)).astype(np.float32)
    k_np = rng.standard_normal((b, sq, hkv, hd)).astype(np.float32)
    v_np = rng.standard_normal((b, sq, hkv, hd)).astype(np.float32)
    (qj, qt), (kj, kt), (vj, vt) = (_pair(a, dtype) for a in (q_np, k_np, v_np))
    tol = 2.5e-2 if dtype == "bfloat16" else 3e-5
    out = flash_attention_ref(qt, kt, vt, causal=True, window=window)
    assert out.dtype == qt.dtype and out.shape == qt.shape
    _close(out, jax_flash(qj, kj, vj, causal=True, window=window, bq=32,
                          bk=32, interpret=True), tol)
    # the JAX ref takes the (B*H, S, hd) kernel layout
    bhsd = lambda a: a.transpose(0, 2, 1, 3).reshape(-1, a.shape[1], a.shape[3])
    ref = jax_flash_ref(bhsd(qj), bhsd(kj), bhsd(vj), causal=True,
                        window=window).reshape(b, h, sq, hd).transpose(0, 2, 1, 3)
    _close(out, ref, tol)


def test_flash_attention_padded_bucket():
    """A prompt right-padded to its prefill bucket: rows of the real
    prompt equal the unpadded attention (causality makes padding exact)."""
    rng = np.random.default_rng(3)
    plen, bucket = 20, 32
    q, k, v = (torch.from_numpy(rng.standard_normal((1, bucket, s, 32))
                                .astype(np.float32)) for s in (6, 2, 2))
    for t in (q, k, v):
        t[:, plen:] = 0
    full = flash_attention_ref(q, k, v)
    real = flash_attention_ref(q[:, :plen], k[:, :plen], v[:, :plen])
    torch.testing.assert_close(full[:, :plen], real, rtol=3e-5, atol=3e-5)
    qj, kj, vj = (jnp.asarray(t.numpy()) for t in (q, k, v))
    _close(full, jax_flash(qj, kj, vj, bq=16, bk=16, interpret=True), 3e-5)


# -- dispatch: CPU takes the plain version, never the build -------------------

def test_build_module_imports_without_nvcc(monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()
    assert set(_build.SOURCES) == {"fused_norm", "fused_mlp", "flash_attention",
                                   "paged_decode", "moe_mlp", "wkv6", "rglru_scan"}
    for name in _build.SOURCES:
        assert (_build._SRC_DIR / f"{name}.cu").is_file()


def test_ptxas_usage_reads_registers_and_spills(monkeypatch):
    assert ("-Xptxas", "-v") == _build.NVCC_FLAGS[-2:]
    log = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z6kernelPf' for 'sm_90a'
ptxas info    : Function properties for _Z6kernelPf
    8 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers, 360 bytes cmem[0]
ptxas info    : Function properties for _Z6helperv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Compiling entry function '_Z7kernel2Pf' for 'sm_90a'
ptxas info    : Function properties for _Z7kernel2Pf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 255 registers, 360 bytes cmem[0]
"""
    monkeypatch.setattr(_build, "_BUILD_LOGS", {"fused_mlp": log})
    assert _build.ptxas_usage("fused_mlp") == [
        {"kernel": "_Z6kernelPf", "registers": 40, "spill_stores": 8,
         "spill_loads": 4},
        {"kernel": "_Z7kernel2Pf", "registers": 255, "spill_stores": 0,
         "spill_loads": 0}]
    assert _build.ptxas_usage("fused_norm") is None      # not built here


def test_cpu_ops_use_plain_version_and_never_build(monkeypatch):
    def no_build(*a, **k):
        raise AssertionError("a CPU tensor reached the CUDA build")

    monkeypatch.setattr(_build, "build", no_build)
    monkeypatch.setattr(_build, "library", no_build)
    launchers = (norm_kernel.RMSNORM, norm_kernel.RMSNORM_RESIDUAL,
                 mlp_kernel.MLP, flash_kernel.FLASH)
    before = [ln.launches for ln in launchers]
    g = torch.Generator().manual_seed(0)
    x, r = torch.randn(2, 5, 16, generator=g), torch.randn(2, 5, 16, generator=g)
    sc = torch.randn(16, generator=g)
    torch.testing.assert_close(norm_ops.fused_rmsnorm(x, sc),
                               fused_rmsnorm_ref(x, sc), rtol=0, atol=0)
    for a, b in zip(norm_ops.fused_rmsnorm_residual(x, r, sc),
                    fused_rmsnorm_residual_ref(x, r, sc)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    wg, wi = torch.randn(16, 24, generator=g), torch.randn(16, 24, generator=g)
    wo = torch.randn(24, 16, generator=g)
    torch.testing.assert_close(mlp_ops.fused_mlp(x, wg, wi, wo),
                               fused_mlp_ref(x, wg, wi, wo), rtol=0, atol=0)
    q = torch.randn(1, 7, 4, 32, generator=g)
    kv = torch.randn(1, 7, 2, 32, generator=g)
    torch.testing.assert_close(flash_ops.flash_attention(q, kv, kv),
                               flash_attention_ref(q, kv, kv), rtol=0, atol=0)
    assert [ln.launches for ln in launchers] == before


@pytest.mark.parametrize("call", [
    lambda t: norm_kernel.fused_rmsnorm_cuda(t, t[0]),
    lambda t: norm_kernel.fused_rmsnorm_residual_cuda(t, t, t[0]),
    lambda t: mlp_kernel.fused_mlp_cuda(t, t, t, t),
    lambda t: flash_kernel.flash_attention_cuda(t[None, :, None], t[None, :, None],
                                                t[None, :, None]),
])
def test_cuda_wrappers_refuse_cpu_tensors(call):
    """The launch wrappers take CUDA tensors only: a CPU tensor raises
    before any build or launch."""
    with pytest.raises(ValueError, match="CUDA"):
        call(torch.zeros(4, 32))

"""float16 in every port op, on the CPU.

Every Pallas kernel of the JAX package is dtype-generic (its output is
`.astype(o_ref.dtype)` of a float32 sum), and both packages' configs take
`dtype="float16"`.  Here each op's plain version (the CPU path of its
`ops` module, and the oracle chip_smoke.py holds the CUDA kernel to)
takes float16 inputs against the JAX Pallas op in interpret mode and the
JAX `ref.py`, on the same seed-made numpy values.  Then each CUDA wrapper,
with its launcher replaced by a recorder, is shown to pass float16's
element-type code (2) to the C entry rather than raising.

Tolerance 1e-2 (atol and rtol) on outputs of magnitude up to ~10: one
float16 rounding is 2^-11 relative, and the two frameworks' float32 sums
in different orders move a value across at most a rounding boundary;
norm sums (x + res rounded to float16) must agree exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.flash_attention.ops import paged_decode_attention as jax_paged
from repro.kernels.flash_attention.ref import paged_decode_attention_ref as jax_paged_ref
from repro.kernels.fused_mlp.ops import fused_mlp as jax_mlp
from repro.kernels.fused_mlp.ref import fused_mlp_ref as jax_mlp_ref
from repro.kernels.fused_norm.ops import fused_rmsnorm as jax_norm
from repro.kernels.fused_norm.ops import fused_rmsnorm_residual as jax_norm_res
from repro.kernels.fused_norm.ref import fused_rmsnorm_ref as jax_norm_ref
from repro.kernels.moe_mlp.ops import moe_mlp as jax_moe
from repro.kernels.moe_mlp.ref import moe_mlp_ref as jax_moe_ref
from repro.kernels.rglru_scan.ops import rglru_scan as jax_scan
from repro.kernels.rglru_scan.ref import rglru_scan_ref as jax_scan_ref
from repro.kernels.wkv6.ops import wkv6 as jax_wkv6
from repro.kernels.wkv6.ref import wkv6_ref as jax_wkv6_ref
from repro_torch.kernels import _attn_plan as ap
from repro_torch.kernels import _build
from repro_torch.kernels import _mlp_plan as mp
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.fused_mlp import kernel as mlp_kernel
from repro_torch.kernels.fused_mlp import ops as mlp_ops
from repro_torch.kernels.fused_norm import kernel as norm_kernel
from repro_torch.kernels.fused_norm import ops as norm_ops
from repro_torch.kernels.moe_mlp import kernel as moe_kernel
from repro_torch.kernels.moe_mlp import ops as moe_ops
from repro_torch.kernels.rglru_scan import kernel as scan_kernel
from repro_torch.kernels.rglru_scan import ops as scan_ops
from repro_torch.kernels.wkv6 import kernel as wkv_kernel
from repro_torch.kernels.wkv6 import ops as wkv_ops

TOL = 1e-2
F16 = 2                      # _build.DTYPE_CODES[torch.float16]


def _pair(a: np.ndarray):
    """The same values as float16 on both sides (rounded to nearest even)."""
    return jnp.asarray(a, jnp.float16), torch.from_numpy(a).to(torch.float16)


def _close(port: torch.Tensor, ref, tol: float = TOL) -> None:
    assert port.dtype == torch.float16
    np.testing.assert_allclose(port.float().numpy(), np.asarray(ref, np.float32),
                               rtol=tol, atol=tol)


def test_float16_has_a_code():
    assert _build.DTYPE_CODES[torch.float16] == F16
    assert _build.dtype_code(torch.zeros(1, dtype=torch.float16), "x") == F16
    with pytest.raises(TypeError, match="float16"):
        _build.dtype_code(torch.zeros(1, dtype=torch.float64), "x")


@pytest.mark.parametrize("n,d", [(6, 16), (16, 576)])
def test_norms(n, d):
    rng = np.random.default_rng(d)
    (xj, xt), (rj, rt), (gj, gt) = (_pair(a) for a in (
        rng.standard_normal((n, d)).astype(np.float32),
        rng.standard_normal((n, d)).astype(np.float32),
        (0.1 * rng.standard_normal((d,))).astype(np.float32)))
    y = norm_ops.fused_rmsnorm(xt, gt)
    _close(y, jax_norm(xj, gj, bt=4, interpret=True))
    _close(y, jax_norm_ref(xj, gj))
    s, y2 = norm_ops.fused_rmsnorm_residual(xt, rt, gt)
    sj, yj = jax_norm_res(xj, rj, gj, bt=4, interpret=True)
    np.testing.assert_array_equal(s.float().numpy(), np.asarray(sj, np.float32))
    _close(y2, yj)


@pytest.mark.parametrize("swiglu", [True, False])
def test_fused_mlp(swiglu):
    rng = np.random.default_rng(3)
    n, d, f = 6, 32, 64
    (xj, xt), (gj, gt), (ij, it), (oj, ot) = (_pair(a) for a in (
        rng.standard_normal((n, d)).astype(np.float32),
        *[(rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
          for s in ((d, f), (d, f), (f, d))]))
    out = mlp_ops.fused_mlp(xt, gt if swiglu else None, it, ot, swiglu=swiglu)
    _close(out, jax_mlp(xj, gj if swiglu else None, ij, oj, swiglu=swiglu,
                        bt=4, bf=16, interpret=True))
    _close(out, jax_mlp_ref(xj, gj, ij, oj, swiglu=swiglu))


def test_moe_mlp():
    rng = np.random.default_rng(4)
    e, c, d, f = 3, 8, 32, 64
    (xj, xt), (gj, gt), (ij, it), (oj, ot) = (_pair(a) for a in (
        rng.standard_normal((e, c, d)).astype(np.float32),
        *[(rng.standard_normal(s) / np.sqrt(s[1])).astype(np.float32)
          for s in ((e, d, f), (e, d, f), (e, f, d))]))
    out = moe_ops.moe_mlp(xt, gt, it, ot)
    _close(out, jax_moe(xj, gj, ij, oj, bt=8, bf=32, interpret=True))
    _close(out, jax_moe_ref(xj, gj, ij, oj))


@pytest.mark.parametrize("window", [None, 24])
def test_flash_attention(window):
    rng = np.random.default_rng(5)
    b, s, h, hkv, hd = 1, 64, 4, 2, 32
    (qj, qt), (kj, kt), (vj, vt) = (_pair(rng.standard_normal(sh).astype(np.float32))
                                    for sh in ((b, s, h, hd), (b, s, hkv, hd),
                                               (b, s, hkv, hd)))
    out = flash_ops.flash_attention(qt, kt, vt, causal=True, window=window)
    _close(out, jax_flash(qj, kj, vj, causal=True, window=window, bq=32, bk=32,
                          interpret=True))


def test_paged_decode_attention():
    rng = np.random.default_rng(6)
    b, h, hkv, hd, ps, npp = 3, 8, 2, 32, 8, 4
    n_pages = 1 + b * npp
    q = rng.standard_normal((b, 1, h, hd)).astype(np.float32)
    kp = rng.standard_normal((n_pages, ps, hkv, hd)).astype(np.float32)
    vp = rng.standard_normal((n_pages, ps, hkv, hd)).astype(np.float32)
    tables = np.arange(1, n_pages, dtype=np.int32).reshape(b, npp)
    lens = np.array([1, 13, 32], np.int32)
    (qj, qt), (kj, kt), (vj, vt) = (_pair(a) for a in (q, kp, vp))
    out = flash_ops.paged_decode_attention(qt, kt, vt, torch.from_numpy(tables),
                                           torch.from_numpy(lens))
    args = (qj, kj, vj, jnp.asarray(tables), jnp.asarray(lens))
    _close(out, jax_paged(*args, interpret=True))
    _close(out, jax_paged_ref(*args))


def test_rglru_scan():
    rng = np.random.default_rng(7)
    b, s, w = 2, 16, 128
    a = rng.uniform(0.0, 1.0, (b, s, w)).astype(np.float32)
    (aj, at), (xj, xt) = _pair(a), _pair(rng.standard_normal((b, s, w)).astype(np.float32))
    h0 = rng.standard_normal((b, w)).astype(np.float32)
    h = scan_ops.rglru_scan(at, xt, torch.from_numpy(h0))
    hj = jnp.asarray(h0)
    _close(h, jax_scan(aj, xj, hj, bs=8, bw=128, interpret=True))
    _close(h, jax_scan_ref(aj, xj, hj))


def test_wkv6():
    rng = np.random.default_rng(8)
    bh, s, d = 3, 16, 16
    r, k, v = (_pair((0.5 * rng.standard_normal((bh, s, d))).astype(np.float32))
               for _ in range(3))
    lw = _pair(-rng.uniform(0.01, 1.0, (bh, s, d)).astype(np.float32))
    u = (0.5 * rng.standard_normal((bh, 1, d))).astype(np.float32)
    s0 = (0.1 * rng.standard_normal((bh, d, d))).astype(np.float32)
    o, s_fin = wkv_ops.wkv6(r[1], k[1], v[1], lw[1], torch.from_numpy(u),
                            torch.from_numpy(s0), chunk=8)
    assert s_fin.dtype == torch.float32
    jin = (r[0], k[0], v[0], lw[0], jnp.asarray(u), jnp.asarray(s0))
    _close(o, jax_wkv6(*jin, chunk=8, interpret=True))
    oj, sj = jax_wkv6_ref(*jin)
    _close(o, oj)
    np.testing.assert_allclose(s_fin.numpy(), np.asarray(sj), rtol=TOL, atol=TOL)


# -- the wrappers pass float16's code to the C entries ------------------------

class _Recorder:
    def __init__(self):
        self.calls = []
        self.launches = 0

    def __call__(self, *args):
        self.calls.append(args)
        self.launches += 1


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(_build, "require_cuda", lambda what, *t: None)
    monkeypatch.setattr(_build, "stream", lambda t: 0)
    monkeypatch.setattr(flash_kernel, "_sm_count", lambda index: ap.SMS)


def _record(monkeypatch, mod, name):
    rec = _Recorder()
    monkeypatch.setattr(mod, name, rec)
    return rec


def test_norm_wrappers_pass_float16(monkeypatch, no_card):
    rec = _record(monkeypatch, norm_kernel, "RMSNORM")
    rec_r = _record(monkeypatch, norm_kernel, "RMSNORM_RESIDUAL")
    x = torch.zeros((4, 576), dtype=torch.float16)
    norm_kernel.fused_rmsnorm_cuda(x, torch.zeros(576, dtype=torch.float16))
    norm_kernel.fused_rmsnorm_residual_cuda(x, x, torch.zeros(576))
    assert rec.calls[-1][-3:-1] == (F16, F16)
    assert rec_r.calls[-1][-3:-1] == (F16, 0)                # float32 scale


@pytest.mark.parametrize("which", ["fused", "moe"])
def test_mlp_wrappers_pass_float16(monkeypatch, no_card, which):
    mod, name = (mlp_kernel, "MLP") if which == "fused" else (moe_kernel, "MOE")
    rec = _record(monkeypatch, mod, name)
    monkeypatch.setattr(mod, "launch_plan", lambda lib, e, n, d, f, dt, sw:
                        mp.mlp_plan(e, n, d, f, dt, swiglu=sw))
    lead = () if which == "fused" else (2,)
    x = torch.zeros(lead + (4, 580), dtype=torch.float16)
    w = torch.zeros(lead + (580, 1540), dtype=torch.float16)
    wo = torch.zeros(lead + (1540, 580), dtype=torch.float16)
    call = mlp_kernel.fused_mlp_cuda if which == "fused" else moe_kernel.moe_mlp_cuda
    assert call(x, w, w, wo).dtype == torch.float16
    args = rec.calls[-1]
    plan = mp.mlp_plan(2 if lead else 1, 4, 584, 1544, "float16")
    assert args[-5:-1] == (F16, plan.cl, plan.nt, plan.clusters)   # the cluster tile
    assert args[6 + len(lead):9 + len(lead)] == (4, 584, 1544)       # padded to 16 bytes


def test_flash_wrapper_passes_float16(monkeypatch, no_card):
    rec = _record(monkeypatch, flash_kernel, "FLASH")
    q = torch.zeros((1, 40, 4, 64), dtype=torch.float16)
    kv = torch.zeros((1, 40, 2, 64), dtype=torch.float16)
    assert flash_kernel.flash_attention_cuda(q, kv, kv).dtype == torch.float16
    args = rec.calls[-1]
    plan = ap.flash_plan(1, 4, 2, 40, 64)
    assert args[22:26] == (plan.warps, plan.stages, 1, F16)   # the tensor-core tile


def test_paged_wrapper_passes_float16(monkeypatch, no_card):
    rec = _record(monkeypatch, flash_kernel, "PAGED")
    b, h, hkv, hd, ps, npp = 4, 9, 3, 64, 16, 32
    q = torch.zeros((b, 1, h, hd), dtype=torch.float16)
    pool = torch.zeros((1 + b * npp, ps, hkv, hd), dtype=torch.float16)
    out = flash_kernel.paged_decode_attention_cuda(
        q, pool, pool, torch.zeros((b, npp), dtype=torch.int32),
        torch.full((b,), 5, dtype=torch.int32))
    assert out.dtype == torch.float16
    assert ap.paged_plan(b, h, hkv, npp, ps, hd, 2).route == "tc"
    assert rec.calls[-1][-2] == F16


def test_recurrent_wrappers_pass_float16(monkeypatch, no_card):
    rec = _record(monkeypatch, scan_kernel, "SCAN")
    monkeypatch.setattr(scan_kernel, "_sm_count", lambda index: 132)
    monkeypatch.setattr(scan_kernel, "cluster_capacity", lambda *a: 16)
    a = torch.zeros((2, 256, 2560), dtype=torch.float16)
    assert scan_kernel.rglru_scan_cuda(a, a, torch.zeros((2, 2560))).dtype == torch.float16
    assert rec.calls[-1][14:16] == (F16, 0)
    scan_kernel.rglru_scan_cuda(a, a, torch.zeros((2, 2560), dtype=torch.float16))
    assert rec.calls[-1][14:16] == (F16, F16)
    rec_w = _record(monkeypatch, wkv_kernel, "WKV6")
    r = torch.zeros((2, 5, 3, 64), dtype=torch.float16)
    o, st = wkv_kernel.wkv6_cuda(r, r, r, r, torch.zeros((3, 64)),
                                 torch.zeros((2, 3, 64, 64)))
    assert o.dtype == torch.float16 and st.dtype == torch.float32
    assert rec_w.calls[-1][-2] == F16


@pytest.mark.parametrize("dtype,code", [(torch.float32, 0), (torch.bfloat16, 1),
                                        (torch.float16, F16)])
def test_paged_int8_wrapper_passes_q_dtype(monkeypatch, no_card, dtype, code):
    """The int8 pool route reads q and the current k/v in their own dtype
    (no float32 copies: q's own pointer reaches the C entry) and writes
    its output in it; a current k/v in another dtype than q's is refused."""
    rec = _record(monkeypatch, flash_kernel, "PAGED_INT8")
    b, h, hkv, hd, ps, npp = 4, 9, 3, 64, 16, 32
    q = torch.zeros((b, 1, h, hd), dtype=dtype)
    pool = torch.zeros((1 + b * npp, ps, hkv, hd), dtype=torch.int8)
    sc = torch.ones((1 + b * npp, 1, hkv, 1))
    kn = torch.zeros((b, hkv, hd), dtype=dtype)
    tables = torch.zeros((b, npp), dtype=torch.int32)
    lengths = torch.full((b,), 5, dtype=torch.int32)
    out = flash_kernel.paged_decode_attention_int8_cuda(q, pool, pool, sc, sc, tables,
                                                         lengths, kn, kn)
    assert out.dtype == dtype and out.shape == q.shape
    args = rec.calls[-1]
    assert args[0] == q.data_ptr() and args[5] == out.data_ptr()
    assert args[-2] == code and args[-3] == pytest.approx(flash_kernel.LOG2E / 8.0)
    with pytest.raises(TypeError):
        flash_kernel.paged_decode_attention_int8_cuda(
            q, pool, pool, sc, sc, tables, lengths, kn.to(torch.float64), kn)

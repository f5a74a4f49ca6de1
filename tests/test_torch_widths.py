"""The port's ops at every width the JAX kernels take, on the CPU.

Each widened op's padding or splitting runs here through the plain
versions (the CUDA kernels run only on the card) and is held to the
unpadded plain result, and the plain version is held to the JAX kernel in
interpret mode at widths no served model uses:

* flash attention: hd zero-padded to the next kernel width
  (`padded_flash`, the scale kept at 1 / sqrt(hd)); hd 96, 100, 256.
* paged decode: the FMA kernel's lane chunks, the last masked past hd
  and up to four a lane above hd 256 (an emulation of its score sums);
  hd 100 and 576 (deepseek-v3's absorbed-MLA latent).
* wkv6: D and Dv zero-padded to multiples of 16, Dv > 128 in column
  blocks, D > 128 in row blocks summed in float32 (`widened`); (D, Dv) =
  (40, 24), (64, 256), (200, 64).
* the MLP tile (bfloat16): d and F zero-padded to multiples of 8
  (`padded_call`); d 580, F 1540, fused and MoE.
* fused norms: d 12288, past the widest row held in registers (the wide
  kernel's two passes; an emulation of its sum order).
* The launch wrappers hand the kernels the padded or split shapes (the
  launchers replaced by recorders).

Tolerances: padding adds zero terms, so padded results equal the
unpadded ones up to float32 sums regrouped by the matrix products' own
blocking (1e-6, abs + rel); a D split changes the order of one final
sum (1e-5); against the JAX kernels each op's test tolerance (flash
3e-5, paged 2e-5, wkv6 1e-4 as `tests/test_torch_recurrent_kernels.py`,
MLP 1e-5, norm 1e-5).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.flash_attention.ops import paged_decode_attention as jax_paged
from repro.kernels.fused_mlp.ops import fused_mlp as jax_mlp
from repro.kernels.fused_norm.ops import fused_rmsnorm as jax_norm
from repro.kernels.fused_norm.ops import fused_rmsnorm_residual as jax_norm_res
from repro.kernels.moe_mlp.ops import moe_mlp as jax_moe
from repro.kernels.wkv6.kernel import wkv6_pallas
from repro_torch.kernels import _attn_plan as ap
from repro_torch.kernels import _build
from repro_torch.kernels import _mlp_plan as mp
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.flash_attention.ref import (flash_attention_ref,
                                                     paged_decode_attention_ref)
from repro_torch.kernels.fused_mlp import kernel as mlp_kernel
from repro_torch.kernels.fused_mlp.ref import fused_mlp_ref
from repro_torch.kernels.fused_norm import kernel as norm_kernel
from repro_torch.kernels.fused_norm.ref import (fused_rmsnorm_ref,
                                                fused_rmsnorm_residual_ref)
from repro_torch.kernels.moe_mlp import kernel as moe_kernel
from repro_torch.kernels.moe_mlp.ref import moe_mlp_ref
from repro_torch.kernels.wkv6 import kernel as wkv_kernel
from repro_torch.kernels.wkv6.ref import wkv6_bshd_ref

PAD_TOL = 1e-6


def _close(got, want, tol):
    got = torch.as_tensor(np.asarray(got, np.float32)) if not isinstance(got, torch.Tensor) \
        else got.float()
    want = torch.as_tensor(np.asarray(want, np.float32)) if not isinstance(want, torch.Tensor) \
        else want.float()
    assert got.shape == want.shape
    err = (got - want).abs()
    assert bool((err <= tol + tol * want.abs()).all()), f"max err {float(err.max()):.3g}"


def _rand(rng, *shape, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))


# -- flash attention ---------------------------------------------------------------

def _flash_plain(q, k, v, causal, window, scale):
    return flash_attention_ref(q, k, v, causal=causal, window=window, scale=scale)


@pytest.mark.parametrize("hd", [96, 100, 256, 40, 200])
@pytest.mark.parametrize("window", [None, 7])
def test_flash_padding_matches_unpadded_and_jax(hd, window):
    rng = np.random.default_rng(hd)
    b, s, h, hkv = 1, 24, 4, 2
    q, k, v = _rand(rng, b, s, h, hd), _rand(rng, b, s, hkv, hd), _rand(rng, b, s, hkv, hd)
    hd_to = ap.padded_head_dim(hd)
    assert hd_to in ap.HEAD_DIMS and hd_to >= hd
    got = flash_kernel.padded_flash(q, k, v, causal=True, window=window, hd_to=hd_to,
                                    run=_flash_plain)
    want = flash_attention_ref(q, k, v, window=window)
    _close(got, want, PAD_TOL)
    if hd in (96, 100, 256):
        jq, jk, jv = (jnp.asarray(t.numpy()) for t in (q, k, v))
        _close(got, jax_flash(jq, jk, jv, window=window, bq=8, bk=8, interpret=True), 3e-5)


def test_flash_forced_padding_of_a_kernel_width():
    """hd 64 run at 80 (as chip_smoke.py forces it, to hold the padded
    route bit-equal to the native one on the card)."""
    rng = np.random.default_rng(1)
    q, k, v = _rand(rng, 1, 20, 3, 64), _rand(rng, 1, 20, 3, 64), _rand(rng, 1, 20, 3, 64)
    got = flash_kernel.padded_flash(q, k, v, causal=True, window=None, hd_to=80,
                                    run=_flash_plain)
    _close(got, flash_attention_ref(q, k, v), PAD_TOL)


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd,hd_to", [(100, 128), (256, 256), (96, 96), (33, 64)])
def test_flash_wrapper_launches_the_padded_width(monkeypatch, no_card, dtype, hd, hd_to):
    rec = _Recorder()
    monkeypatch.setattr(flash_kernel, "FLASH", rec)
    q = torch.zeros((1, 40, 4, hd), dtype=dtype)
    kv = torch.zeros((1, 40, 2, hd), dtype=dtype)
    out = flash_kernel.flash_attention_cuda(q, kv, kv)
    assert out.shape == q.shape and out.dtype == dtype
    args = rec.calls[-1]
    assert args[9] == hd_to                                  # hd the kernel runs
    assert args[21] == pytest.approx(1.0 / math.sqrt(hd))    # the real hd's scale
    plan = ap.flash_plan(1, 4, 2, 40, hd_to)
    assert args[23] == (plan.stages if dtype == torch.bfloat16 else 0)


def test_flash_wrapper_copies_unaligned_bf16_views(monkeypatch, no_card):
    rec = _Recorder()
    monkeypatch.setattr(flash_kernel, "FLASH", rec)
    base = torch.zeros((1, 16, 3, 65), dtype=torch.bfloat16)
    q = base[..., 1:]                                         # 2 bytes off, stride 65
    flash_kernel.flash_attention_cuda(q, q[:, :, :1], q[:, :, :1])
    args = rec.calls[-1]
    assert args[10:13] == (0, 3 * 64, 64)             # the aligned copy's (size-1 batch: 0)


def test_flash_stages_fit_shared_memory():
    for hd in ap.HEAD_DIMS:
        for warps in (4, ap.MAX_WARPS):
            assert ap.smem_bytes(hd, warps, ap.tc_stages(hd)) <= ap.SMEM_MAX
    assert ap.tc_stages(256) == 2 and ap.tc_stages(192) == 3
    assert ap.smem_bytes(256, 8, 3) > ap.SMEM_MAX >= ap.smem_bytes(256, 8, 2)


# -- paged decode --------------------------------------------------------------------

def _lane_chunk_scores(q, keys, hd):
    """paged_split_kernel's score of each key row: per lane chunk of 8
    values (32 lanes and up to 4 chunks a lane above hd 256), the tail past
    hd read as zeros from shared memory, the chunks summed lane by lane."""
    lanes = min(32, max(4, 1 << max(0, (-(-hd // 8) - 1).bit_length())))
    nc = -(-hd // (8 * lanes))
    width = 8 * lanes * nc
    qp = torch.nn.functional.pad(q, (0, width - hd)).reshape(*q.shape[:-1], nc, lanes, 8)
    kp = torch.nn.functional.pad(keys, (0, width - hd)).reshape(*keys.shape[:-1], nc, lanes, 8)
    part = torch.einsum("hpce,kpce->hkc", qp, kp)             # a lane's partial
    return part.sum(-1)


@pytest.mark.parametrize("hd", [100, 576, 36, 264])
def test_paged_lane_chunks_score_as_the_plain_dot(hd):
    rng = np.random.default_rng(hd)
    q, keys = _rand(rng, 4, hd), _rand(rng, 9, hd)
    _close(_lane_chunk_scores(q, keys, hd), q @ keys.T, 1e-5)


@pytest.mark.parametrize("hd", [100, 576])
def test_paged_plain_matches_jax_at_new_widths(hd):
    rng = np.random.default_rng(hd + 1)
    b, h, hkv, ps, npp = 2, 4, 2, 4, 3
    pages = 1 + b * npp
    q = _rand(rng, b, 1, h, hd)
    kp, vp = _rand(rng, pages, ps, hkv, hd), _rand(rng, pages, ps, hkv, hd)
    tables = torch.tensor([[1, 2, 3], [4, 5, 0]], dtype=torch.int32)
    lengths = torch.tensor([11, 6], dtype=torch.int32)
    got = paged_decode_attention_ref(q, kp, vp, tables, lengths)
    want = jax_paged(*(jnp.asarray(t.numpy()) for t in (q, kp, vp, tables, lengths)),
                     interpret=True)
    _close(got, want, 2e-5)
    plan = ap.paged_plan(b, h, hkv, npp, ps, hd, 4)
    assert plan.route == "fma" and plan.heads == (2 if hd <= 256 else 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [100, 576, 36])
def test_paged_wrapper_takes_any_head_dim(monkeypatch, no_card, dtype, hd):
    rec = _Recorder()
    monkeypatch.setattr(flash_kernel, "PAGED", rec)
    b, h, hkv, ps, npp = 4, 8, 2, 16, 32
    q = torch.zeros((b, 1, h, hd), dtype=dtype)
    pool = torch.zeros((1 + b * npp, ps, hkv, hd), dtype=dtype)
    out = flash_kernel.paged_decode_attention_cuda(
        q, pool, pool, torch.zeros((b, npp), dtype=torch.int32),
        torch.full((b,), 5, dtype=torch.int32))
    assert out.shape == q.shape
    args = rec.calls[-1]
    aligned = hd * q.element_size() % 16 == 0
    plan = ap.paged_plan(b, h, hkv, npp, ps, hd, q.element_size(), aligned=aligned)
    assert plan.route == "fma"
    assert args[7:17] == (b, h, hkv, hd, ps, npp, plan.pages, plan.splits,
                          plan.heads, plan.head_chunks)


# -- wkv6 ------------------------------------------------------------------------------

def _wkv_inputs(rng, b, s, h, d, dv):
    r, k = _rand(rng, b, s, h, d, scale=0.5), _rand(rng, b, s, h, d, scale=0.5)
    v = _rand(rng, b, s, h, dv, scale=0.5)
    logw = -torch.exp(_rand(rng, b, s, h, d).clamp(-1, 1))
    u, s0 = _rand(rng, h, d, scale=0.1), _rand(rng, b, h, d, dv, scale=0.1)
    return r, k, v, logw, u, s0


def _wkv_plain(r, k, v, logw, u, s0):
    return wkv6_bshd_ref(r, k, v, logw, u, s0, chunk=8)


@pytest.mark.parametrize("d,dv,tol", [(40, 24, PAD_TOL), (64, 256, PAD_TOL),
                                      (64, 136, PAD_TOL), (200, 64, 1e-5),
                                      (130, 20, 1e-5)])
@pytest.mark.parametrize("s", [1, 20])
def test_wkv6_widened_matches_unpadded(d, dv, tol, s):
    rng = np.random.default_rng(d * 1000 + dv + s)
    args = _wkv_inputs(rng, 2, s, 3, d, dv)
    o, st = wkv_kernel.widened(_wkv_plain, *args)
    wo, wst = _wkv_plain(*args)
    assert o.shape == wo.shape and st.shape == wst.shape
    _close(o, wo, tol)
    _close(st, wst, tol)


@pytest.mark.parametrize("d,dv", [(40, 24), (64, 256)])
def test_wkv6_widened_matches_jax_kernel(d, dv):
    rng = np.random.default_rng(d + dv)
    b, s, h = 1, 20, 2
    r, k, v, logw, u, s0 = _wkv_inputs(rng, b, s, h, d, dv)
    o, _ = wkv_kernel.widened(_wkv_plain, r, k, v, logw, u, s0)
    flat = lambda t: t.permute(0, 2, 1, 3).reshape(b * h, s, t.shape[-1]).numpy()
    want = wkv6_pallas(*(jnp.asarray(flat(t)) for t in (r, k, v, logw)),
                       jnp.asarray(u.repeat(b, 1)[:, None].numpy()),
                       jnp.asarray(s0.reshape(b * h, d, dv).numpy()), chunk=8,
                       interpret=True)
    _close(o.permute(0, 2, 1, 3).reshape(b * h, s, dv), want, 1e-4)


def test_wkv6_widened_bf16_rounds_o_once():
    """bfloat16 inputs with D > 128: the row blocks run in float32 and o is
    rounded to bfloat16 once, after the sum."""
    rng = np.random.default_rng(7)
    args = [t.bfloat16() if i < 4 else t for i, t in
            enumerate(_wkv_inputs(rng, 1, 20, 2, 160, 32))]
    o, st = wkv_kernel.widened(_wkv_plain, *args)
    assert o.dtype == torch.bfloat16 and st.dtype == torch.float32
    wo, _ = _wkv_plain(*args)
    ref = wo.float()
    assert bool(((o.float() - ref).abs() <= 1e-4 + 2.0 ** -7 * ref.abs()).all())


@pytest.mark.parametrize("d,dv,calls", [
    (40, 24, [(48, 32)]), (64, 256, [(64, 128), (64, 128)]),
    (64, 136, [(64, 128), (64, 16)]), (200, 64, [(128, 64), (80, 64)])])
def test_wkv6_wrapper_launches_kernel_widths(monkeypatch, d, dv, calls):
    rec = _Recorder()
    monkeypatch.setattr(_build, "require_cuda", lambda what, *t: None)
    monkeypatch.setattr(_build, "stream", lambda t: 0)
    monkeypatch.setattr(wkv_kernel, "WKV6", rec)
    b, s, h = 2, 5, 3
    r = torch.zeros((b, s, h, d))
    o, st = wkv_kernel.wkv6_cuda(r, r, torch.zeros((b, s, h, dv)), r,
                                 torch.zeros((h, d)), torch.zeros((b, h, d, dv)))
    assert o.shape == (b, s, h, dv) and st.shape == (b, h, d, dv)
    assert [c[12:14] for c in rec.calls] == calls
    assert all(c[12] in wkv_kernel.HEAD_DIMS and c[13] in wkv_kernel.HEAD_DIMS
               for c in rec.calls)


# -- the MLP tile ------------------------------------------------------------------------

@pytest.mark.parametrize("swiglu", [True, False])
def test_mlp_padding_matches_unpadded_and_jax(swiglu):
    rng = np.random.default_rng(int(swiglu))
    n, d, f = 4, 580, 1540
    x = _rand(rng, n, d)
    wg, wi = _rand(rng, d, f, scale=d ** -0.5), _rand(rng, d, f, scale=d ** -0.5)
    wo = _rand(rng, f, d, scale=f ** -0.5)
    g = wg if swiglu else None
    d_to, f_to = mp.tile_widths(d, f)
    assert (d_to, f_to) == (584, 1544)
    got = mp.padded_call(lambda *a: fused_mlp_ref(*a, swiglu=swiglu), x, g, wi, wo,
                         d_to, f_to)
    _close(got, fused_mlp_ref(x, g, wi, wo, swiglu=swiglu), PAD_TOL)
    want = jax_mlp(*(jnp.asarray(t.numpy()) for t in (x, wg, wi, wo)), swiglu=swiglu,
                   interpret=True)
    _close(got, want, 1e-5)


def test_moe_padding_matches_unpadded_and_jax():
    rng = np.random.default_rng(3)
    e, c, d, f = 2, 4, 580, 1540
    x = _rand(rng, e, c, d)
    wg, wi = _rand(rng, e, d, f, scale=d ** -0.5), _rand(rng, e, d, f, scale=d ** -0.5)
    wo = _rand(rng, e, f, d, scale=f ** -0.5)
    got = mp.padded_call(moe_mlp_ref, x, wg, wi, wo, *mp.tile_widths(d, f))
    _close(got, moe_mlp_ref(x, wg, wi, wo), PAD_TOL)
    want = jax_moe(*(jnp.asarray(t.numpy()) for t in (x, wg, wi, wo)), interpret=True)
    _close(got, want, 1e-5)


def test_mlp_padding_is_exact_in_bf16():
    """Zero padding adds exact zeros: in bfloat16 (products of bf16 values
    in float32) the padded plain result equals the unpadded one bit for
    bit on this CPU path."""
    rng = np.random.default_rng(9)
    x = _rand(rng, 3, 20).bfloat16()
    wg, wi, wo = _rand(rng, 20, 36).bfloat16(), _rand(rng, 20, 36).bfloat16(), \
        _rand(rng, 36, 20).bfloat16()
    plain = lambda *a: fused_mlp_ref(*[t.float() for t in a]).bfloat16()
    assert torch.equal(mp.padded_call(plain, x, wg, wi, wo, 24, 40), plain(x, wg, wi, wo))


@pytest.mark.parametrize("which", ["fused", "moe"])
def test_mlp_wrappers_launch_padded_widths(monkeypatch, which):
    mod, rec = (mlp_kernel, "MLP") if which == "fused" else (moe_kernel, "MOE")
    recorder = _Recorder()
    monkeypatch.setattr(_build, "require_cuda", lambda what, *t: None)
    monkeypatch.setattr(_build, "stream", lambda t: 0)
    monkeypatch.setattr(mod, rec, recorder)
    monkeypatch.setattr(mod, "launch_plan", lambda lib, e, n, d, f, dt, sw:
                        mp.mlp_plan(e, n, d, f, dt, swiglu=sw))
    lead = () if which == "fused" else (2,)
    d, f = 580, 1540
    x = torch.zeros(lead + (4, d), dtype=torch.bfloat16)
    w = torch.zeros(lead + (d, f), dtype=torch.bfloat16)
    wo = torch.zeros(lead + (f, d), dtype=torch.bfloat16)
    call = mlp_kernel.fused_mlp_cuda if which == "fused" else moe_kernel.moe_mlp_cuda
    out = call(x, w, w, wo)
    assert out.shape == x.shape and out.is_contiguous()
    args = recorder.calls[-1]
    assert args[6 + len(lead):9 + len(lead)] == (4, 584, 1544)


# -- fused norms ---------------------------------------------------------------------------

def _wide_norm_emulation(x, scale, eps=1e-6):
    """rmsnorm_wide_kernel's sum order in float32 numpy (vec 4): thread t
    over chunks t, t + 256, ... and their values in order (one fma each),
    the xor butterfly, the warps in order."""
    n, d = x.shape
    lay = norm_kernel.norm_layout(d, 4)
    assert lay.threads == 256 and d > norm_kernel.REG_MAX_D
    f32 = np.float32
    out = np.empty_like(x)
    for row in range(n):
        parts = np.zeros(256, f32)
        chunks = x[row].reshape(-1, 4)
        for i in range(lay.chunks):                 # every thread's i-th chunk at once
            rows = chunks[i * 256:(i + 1) * 256]
            for j in range(4):
                a = np.zeros(256, f32)
                a[:len(rows)] = rows[:, j]
                parts = (a.astype(np.float64) * a + parts).astype(f32)
        warps = parts.reshape(-1, 32)
        for off in (16, 8, 4, 2, 1):
            warps = warps + warps[:, np.arange(32) ^ off]
        tot = f32(0)
        for w in warps[:, 0]:
            tot = f32(tot + w)
        inv = f32(1) / np.sqrt(f32(tot / f32(d) + f32(eps)))
        out[row] = x[row] * inv * (f32(1) + scale)
    return out


def test_wide_norm_matches_jax():
    rng = np.random.default_rng(12288)
    n, d = 3, 12288
    x, r = (rng.standard_normal((n, d)).astype(np.float32) for _ in range(2))
    g = (rng.standard_normal(d) * 0.1).astype(np.float32)
    got = _wide_norm_emulation(x, g)
    _close(got, jax_norm(jnp.asarray(x), jnp.asarray(g), interpret=True), 1e-5)
    _close(fused_rmsnorm_ref(torch.from_numpy(x), torch.from_numpy(g)), got, 1e-5)
    s, y = fused_rmsnorm_residual_ref(*(torch.from_numpy(t) for t in (x, r, g)))
    js, jy = jax_norm_res(jnp.asarray(x), jnp.asarray(r), jnp.asarray(g), interpret=True)
    _close(s, js, 0.0)
    _close(_wide_norm_emulation(s.numpy(), g), jy, 1e-5)
    _close(y, jy, 1e-5)


@pytest.mark.parametrize("d,vec,chunks", [(12288, 8, 6), (12288, 4, 12), (8200, 1, 33),
                                          (65536, 8, 32)])
def test_wide_norm_layout(d, vec, chunks):
    lay = norm_kernel.norm_layout(d, vec)
    assert (lay.threads, lay.vec, lay.chunks) == (256, vec, chunks)
    assert lay.threads * lay.chunks * lay.vec >= d


def test_norm_wrapper_takes_wide_rows(monkeypatch):
    rec = _Recorder()
    monkeypatch.setattr(_build, "require_cuda", lambda what, *t: None)
    monkeypatch.setattr(_build, "stream", lambda t: 0)
    monkeypatch.setattr(norm_kernel, "RMSNORM", rec)
    x = torch.zeros((2, 12288), dtype=torch.bfloat16)
    out = norm_kernel.fused_rmsnorm_cuda(x, torch.zeros(12288, dtype=torch.bfloat16))
    assert out.shape == x.shape
    assert rec.calls[-1][3:6] == (2, 12288, 8)
    base = torch.zeros((2, 2 * 12288))                        # a strided view: copied
    norm_kernel.fused_rmsnorm_cuda(base[:, ::2], torch.zeros(12288))
    assert rec.calls[-1][3:5] == (2, 12288)

"""Kernel parity of the PyTorch/CUDA port's recurrent kernels on the CPU:
the plain versions of `wkv6` and `rglru_scan` against the JAX package's
oracles (`ref.py`), its model functions and its Pallas ops in interpret
mode, on the same numpy inputs.

Tolerances, float32: wkv6 1e-4 (sums run in another order, and the
chunked forms clip exponents at -60); rglru_scan 1e-5 against the
sequential oracles, 1e-4 against the model's associative scan, which
multiplies the a_t in a tree and folds h0 into b_0, so it rounds
differently.  The CUDA kernels run only on the card (`chip_smoke.py`);
here the tests show that a CPU tensor takes the plain version and never
reaches the build.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rglru_scan.ops import rglru_scan as jax_scan
from repro.kernels.rglru_scan.ref import rglru_scan_ref as jax_scan_ref
from repro.kernels.wkv6.ops import wkv6 as jax_wkv6
from repro.kernels.wkv6.ref import wkv6_ref as jax_wkv6_ref
from repro.models import rglru as jax_rglru
from repro.models import rwkv6 as jax_rwkv6
from repro_torch.kernels import _build
from repro_torch.kernels.rglru_scan import kernel as scan_kernel
from repro_torch.kernels.rglru_scan import ops as scan_ops
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref
from repro_torch.kernels.wkv6 import kernel as wkv_kernel
from repro_torch.kernels.wkv6 import ops as wkv_ops
from repro_torch.kernels.wkv6.ref import wkv6_bshd_ref, wkv6_ref

WKV_TOL = dict(rtol=1e-4, atol=1e-4)


def _close(port: torch.Tensor, ref, **tol) -> None:
    np.testing.assert_allclose(port.numpy(), np.asarray(ref, np.float32), **tol)


def _wkv_inputs(rng, lead, s, d, u_shape, s0_shape):
    """r, k, v, the decay w in (0, 1), logw = log(max(w, 1e-12)) as the
    model takes it, u and s0, all float32."""
    shape = (*lead[:1], s, *lead[1:], d)
    r, k, v = (0.5 * rng.standard_normal(shape).astype(np.float32) for _ in range(3))
    w = np.exp(-np.exp(rng.uniform(-1.0, 1.0, shape))).astype(np.float32)
    logw = np.log(np.maximum(w, 1e-12)).astype(np.float32)
    u = (0.1 * rng.standard_normal(u_shape)).astype(np.float32)
    s0 = (0.1 * rng.standard_normal(s0_shape)).astype(np.float32)
    return r, k, v, w, logw, u, s0


# -- wkv6 -----------------------------------------------------------------------

@pytest.mark.parametrize("bh,s,d,chunk", [
    (4, 16, 16, 8),
    (6, 37, 16, 8),       # S not a multiple of the chunk
    (3, 1, 32, 64),       # one decode step
    (2, 70, 64, 32),      # the serving head dim, chunk 32
])
def test_wkv6_plain_matches_jax_oracle_and_pallas(bh, s, d, chunk):
    rng = np.random.default_rng(bh * 100 + s)
    r, k, v, _, logw, u, s0 = _wkv_inputs(rng, (bh,), s, d, (bh, 1, d), (bh, d, d))
    o, s_fin = wkv_ops.wkv6(*(torch.from_numpy(a) for a in (r, k, v, logw, u, s0)),
                            chunk=chunk)
    assert o.shape == (bh, s, d) and s_fin.shape == (bh, d, d)
    assert o.dtype == s_fin.dtype == torch.float32
    jin = [jnp.asarray(a) for a in (r, k, v, logw, u, s0)]
    oj, sj = jax_wkv6_ref(*jin)
    _close(o, oj, **WKV_TOL)
    _close(s_fin, sj, **WKV_TOL)
    _close(o, jax_wkv6(*jin, chunk=chunk, interpret=True), **WKV_TOL)


@pytest.mark.parametrize("s,chunk", [(45, 8), (45, 32), (64, 32), (1, 8)])
def test_wkv6_model_layout_matches_jax_model(s, chunk):
    """The model-layout op against `rwkv6.wkv_chunked` (and, for one token,
    `wkv_sequential`, the JAX model's decode branch) from a nonzero
    state."""
    b, h, d = 2, 3, 16
    rng = np.random.default_rng(s + chunk)
    r, k, v, w, logw, u, s0 = _wkv_inputs(rng, (b, h), s, d, (h, d), (b, h, d, d))
    o, s_fin = wkv_ops.wkv6_bshd(*(torch.from_numpy(a) for a in (r, k, v, logw, u, s0)),
                                 chunk=chunk)
    jin = [jnp.asarray(a) for a in (r, k, v, w, u, s0)]
    oj, sj = jax_rwkv6.wkv_chunked(*jin, chunk)
    _close(o, oj, **WKV_TOL)
    _close(s_fin, sj, **WKV_TOL)
    if s == 1:
        oq, sq = jax_rwkv6.wkv_sequential(*jin)
        _close(o, oq, **WKV_TOL)
        _close(s_fin, sq, **WKV_TOL)


def test_wkv6_state_carries_across_calls():
    """Prefill then decode through the op equals one pass over the whole
    sequence: the final state is what the next call needs."""
    b, h, s, d = 1, 2, 20, 16
    rng = np.random.default_rng(4)
    r, k, v, _, logw, u, s0 = (torch.from_numpy(a) for a in _wkv_inputs(
        rng, (b, h), s, d, (h, d), (b, h, d, d)))
    o_all, s_all = wkv6_bshd_ref(r, k, v, logw, u, s0, chunk=8)
    o1, s1 = wkv6_bshd_ref(r[:, :17], k[:, :17], v[:, :17], logw[:, :17], u, s0,
                           chunk=8)
    outs = [o1]
    for t in range(17, s):
        ot, s1 = wkv6_bshd_ref(r[:, t:t + 1], k[:, t:t + 1], v[:, t:t + 1],
                               logw[:, t:t + 1], u, s1)
        outs.append(ot)
    torch.testing.assert_close(torch.cat(outs, 1), o_all, **WKV_TOL)
    torch.testing.assert_close(s1, s_all, **WKV_TOL)


def test_wkv6_layouts_agree():
    """`wkv6` (the JAX op's (BH, S, D) layout) and `wkv6_bshd` (the model
    layout) are one function."""
    b, h, s, d = 2, 3, 12, 16
    rng = np.random.default_rng(8)
    r, k, v, _, logw, u, s0 = (torch.from_numpy(a) for a in _wkv_inputs(
        rng, (b, h), s, d, (h, d), (b, h, d, d)))
    o, s_fin = wkv6_bshd_ref(r, k, v, logw, u, s0, chunk=4)
    flat = lambda t: t.permute(0, 2, 1, 3).reshape(b * h, s, d)
    ob, sb = wkv6_ref(flat(r), flat(k), flat(v), flat(logw),
                      u.repeat(b, 1)[:, None], s0.reshape(b * h, d, d), chunk=4)
    torch.testing.assert_close(ob, flat(o), rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(sb, s_fin.reshape(b * h, d, d), rtol=1e-6, atol=1e-6)


# -- rglru_scan -----------------------------------------------------------------

@pytest.mark.parametrize("b,s,w", [(2, 16, 128), (1, 300, 40), (4, 1, 64), (3, 9, 130)])
def test_rglru_scan_plain_matches_jax(b, s, w):
    rng = np.random.default_rng(b * 1000 + s + w)
    a = rng.uniform(0.0, 1.0, (b, s, w)).astype(np.float32)
    x = rng.standard_normal((b, s, w)).astype(np.float32)
    h0 = rng.standard_normal((b, w)).astype(np.float32)
    h = scan_ops.rglru_scan(*(torch.from_numpy(t) for t in (a, x, h0)))
    assert h.shape == (b, s, w) and h.dtype == torch.float32
    aj, xj, hj = (jnp.asarray(t) for t in (a, x, h0))
    _close(h, jax_scan_ref(aj, xj, hj), rtol=1e-5, atol=1e-5)
    _close(h, jax_scan(aj, xj, hj, bs=8, bw=128, interpret=True), rtol=1e-5, atol=1e-5)
    _close(h, jax_rglru.rglru_scan(aj, xj, hj), rtol=1e-4, atol=1e-4)


def test_rglru_scan_strided_h0():
    """h0 taken as the last step of an earlier scan (a strided view)
    continues that scan exactly."""
    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.uniform(0.0, 1.0, (2, 12, 32)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((2, 12, 32)).astype(np.float32))
    full = rglru_scan_ref(a, x, torch.zeros(2, 32))
    first = rglru_scan_ref(a[:, :7], x[:, :7], torch.zeros(2, 32))
    rest = rglru_scan_ref(a[:, 7:], x[:, 7:], first[:, -1])
    torch.testing.assert_close(torch.cat([first, rest], 1), full, rtol=0, atol=0)


# -- dispatch: CPU takes the plain version, never the build -------------------

def test_recurrent_cpu_ops_use_plain_version_and_never_build(monkeypatch):
    def no_build(*a, **k):
        raise AssertionError("a CPU tensor reached the CUDA build")

    monkeypatch.setattr(_build, "build", no_build)
    monkeypatch.setattr(_build, "library", no_build)
    before = (wkv_kernel.WKV6.launches, scan_kernel.SCAN.launches)
    g = torch.Generator().manual_seed(0)
    r, k, v = (torch.randn(2, 5, 3, 16, generator=g) for _ in range(3))
    logw = -torch.rand(2, 5, 3, 16, generator=g)
    u, s0 = torch.randn(3, 16, generator=g), torch.randn(2, 3, 16, 16, generator=g)
    for a, b in zip(wkv_ops.wkv6_bshd(r, k, v, logw, u, s0, chunk=4),
                    wkv6_bshd_ref(r, k, v, logw, u, s0, chunk=4)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    flat = [t[:, :, 0] for t in (r, k, v, logw)]
    for a, b in zip(wkv_ops.wkv6(*flat, u[:2, None], s0[:, 0]),
                    wkv6_ref(*flat, u[:2, None], s0[:, 0])):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    a, x, h0 = torch.rand(2, 5, 8, generator=g), torch.randn(2, 5, 8, generator=g), \
        torch.randn(2, 8, generator=g)
    torch.testing.assert_close(scan_ops.rglru_scan(a, x, h0), rglru_scan_ref(a, x, h0),
                               rtol=0, atol=0)
    assert (wkv_kernel.WKV6.launches, scan_kernel.SCAN.launches) == before


@pytest.mark.parametrize("call", [
    lambda t: wkv_kernel.wkv6_cuda(t, t, t, t, t[0, 0], t[:, 0, :, None].expand(-1, -1, 16, -1)),
    lambda t: scan_kernel.rglru_scan_cuda(t[0], t[0], t[0, 0]),
])
def test_recurrent_cuda_wrappers_refuse_cpu_tensors(call):
    """The launch wrappers take CUDA tensors only: a CPU tensor raises
    before any build or launch."""
    with pytest.raises(ValueError, match="CUDA"):
        call(torch.zeros(2, 4, 3, 16))

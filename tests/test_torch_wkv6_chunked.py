"""The chunked WKV6 of the port (`csrc/wkv6.cu`, S > 1) on the CPU.

* A float32 emulation of the kernels' order -- chunks of 32 in two
  sub-chunks of 16, log decays in base 2 summed inside each sub-chunk,
  the pairwise decays of a sub-chunk as running products of w <= 1, the
  keys of the first sub-chunk against the second's queries factored about
  the boundary between them, each chunk's own state update U and inside
  outputs computed apart from the state (pass 1), the state chain over
  the chunks (pass 2), o = oi + rq S_c (pass 3) -- against the JAX
  `wkv6_ref` (the sequential recurrence) and `wkv6_pallas` in interpret
  mode: S not a multiple of the chunk, Dv != D, decays down to logw = -80
  inside a chunk (no inf or NaN), bfloat16 inputs.
* The states the chain keeps at the chunk starts equal the sequential
  recurrence's after 32 c steps.
* The launch wrapper takes D and Dv (multiples of 16 up to 128) apart and
  both dtypes at validation, and hands the chunked kernels a workspace
  (the launcher is replaced by a recorder: the CUDA call runs only on the
  card); the plain CPU path takes bfloat16 too.

Tolerance 1e-4 (the recurrent kernels' float32 tolerance); a bfloat16 o
is held to one bfloat16 rounding (2^-7 of its size) beyond that.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.wkv6.kernel import wkv6_pallas
from repro.kernels.wkv6.ref import wkv6_ref as jax_wkv6_ref
from repro_torch.kernels import _build
from repro_torch.kernels.wkv6 import kernel as wkv_kernel
from repro_torch.kernels.wkv6 import ops as wkv_ops
from repro_torch.kernels.wkv6.ref import wkv6_bshd_ref

TOL = dict(rtol=1e-4, atol=1e-4)
C, SUB = 32, 16
LOG2E = 1.4426950408889634


def _chunked_emulation(r, k, v, logw, u, s0):
    """r/k/logw (B, S, H, D), v (B, S, H, Dv), u (H, D), s0 (B, H, D, Dv),
    float32.  Returns (o, s_final, the states at the chunk starts)."""
    b, s, h, d = r.shape
    dv = v.shape[-1]
    pad = (-s) % C
    if pad:
        r, k, v, logw = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad))
                         for t in (r, k, v, logw))
    nc = r.shape[1] // C
    rc, kc, vc, lc = (t.reshape(b, nc, C, h, t.shape[-1]).permute(1, 0, 3, 2, 4)
                      for t in (r, k, v, logw))          # (nc, B, H, C, *)
    prep = []
    for c in range(nc):                                  # pass 1: independent chunks
        rt, kt, vt, l2 = rc[c], kc[c], vc[c], lc[c] * LOG2E
        L = torch.cat([torch.cumsum(l2[..., :SUB, :], -2),
                       torch.cumsum(l2[..., SUB:, :], -2)], -2)   # inside each sub-chunk
        T0, T1 = L[..., SUB - 1, :], L[..., C - 1, :]
        lp = torch.cat([torch.zeros_like(L[..., :1, :]), L[..., :SUB - 1, :],
                        torch.zeros_like(L[..., :1, :]), L[..., SUB:C - 1, :]], -2)
        first = torch.arange(C) < SUB
        rq = rt * torch.exp2(lp + torch.where(first[:, None], 0.0, T0[..., None, :]))
        kend = kt * torch.exp2(torch.where(first[:, None], (T0[..., None, :] - L) + T1[..., None, :],
                                           T1[..., None, :] - L))
        dec = torch.exp2(T0 + T1)
        w = torch.exp2(l2)
        A = torch.zeros((b, h, C, C))
        for q in range(2):                               # running products
            for s_ in range(SUB):
                si = q * SUB + s_
                e = kt[..., si, :]
                A[..., si, si] = (rt[..., si, :] * u * kt[..., si, :]).sum(-1)
                for tt in range(s_ + 1, SUB):
                    ti = q * SUB + tt
                    A[..., ti, si] = (rt[..., ti, :] * e).sum(-1)
                    e = e * w[..., ti, :]
        rf = rt[..., SUB:, :] * torch.exp2(lp[..., SUB:, :])
        kb = kt[..., :SUB, :] * torch.exp2(T0[..., None, :] - L[..., :SUB, :])
        A[..., SUB:, :SUB] = torch.einsum("bhtd,bhsd->bhts", rf, kb)
        U = torch.einsum("bhsd,bhse->bhde", kend, vt)
        oi = torch.einsum("bhts,bhse->bhte", A, vt)
        prep.append((rq, dec, U, oi))
    states, st = [], s0.clone()
    for rq, dec, U, oi in prep:                          # pass 2: the chain
        states.append(st)
        st = dec[..., None] * st + U
    o = torch.stack([oi + torch.einsum("bhtd,bhde->bhte", rq, sc)   # pass 3
                     for (rq, _, _, oi), sc in zip(prep, states)])  # (nc, B, H, C, Dv)
    o = o.permute(1, 0, 3, 2, 4).reshape(b, nc * C, h, dv)[:, :s]
    return o, st, states


def _inputs(seed, b, s, h, d, dv, dtype=np.float32):
    rng = np.random.default_rng(seed)
    r, k = (0.5 * rng.standard_normal((b, s, h, d)) for _ in range(2))
    v = 0.5 * rng.standard_normal((b, s, h, dv))
    w = np.exp(-np.exp(rng.uniform(-1.0, 1.0, (b, s, h, d))))
    logw = np.log(np.maximum(w, 1e-12))
    u = 0.1 * rng.standard_normal((h, d))
    s0 = 0.1 * rng.standard_normal((b, h, d, dv))
    return [a.astype(dtype) for a in (r, k, v, logw)] + [u.astype(np.float32),
                                                          s0.astype(np.float32)]


def _jax(r, k, v, logw, u, s0):
    """(o (B, S, H, Dv), s (B, H, D, Dv)) of the JAX sequential oracle."""
    b, s, h, d = r.shape
    flat = lambda a: jnp.asarray(np.ascontiguousarray(
        np.transpose(a, (0, 2, 1, 3)).reshape(b * h, s, a.shape[-1])))
    uj = jnp.asarray(np.tile(u, (b, 1))[:, None])
    sj = jnp.asarray(s0.reshape(b * h, d, -1))
    o, st = jax_wkv6_ref(flat(r), flat(k), flat(v), flat(logw), uj, sj)
    pal = wkv6_pallas(flat(r), flat(k), flat(v), flat(logw), uj, sj, chunk=32,
                      interpret=True)
    unflat = lambda a: np.asarray(a).reshape(b, h, s, -1).transpose(0, 2, 1, 3)
    return unflat(o), np.asarray(st).reshape(b, h, d, -1), unflat(pal)


@pytest.mark.parametrize("b,s,h,d,dv", [
    (1, 64, 2, 16, 16),
    (2, 45, 2, 32, 16),       # S not a multiple of 32; Dv != D
    (1, 70, 1, 16, 48),       # Dv > D
    (2, 2, 3, 16, 16),        # a two-token prefill
])
def test_chunked_emulation_matches_jax(b, s, h, d, dv):
    arrays = _inputs(s * 10 + d, b, s, h, d, dv)
    o, st, _ = _chunked_emulation(*(torch.from_numpy(a) for a in arrays))
    want_o, want_s, pallas_o = _jax(*arrays)
    np.testing.assert_allclose(o.numpy(), want_o, **TOL)
    np.testing.assert_allclose(st.numpy(), want_s, **TOL)
    np.testing.assert_allclose(o.numpy(), pallas_o, **TOL)


def test_chunked_emulation_strong_decays_stay_finite():
    """logw = -80 across both sub-chunks of the first chunk and at the
    start of the second: nothing overflows, and the result is the
    sequential recurrence's."""
    arrays = _inputs(80, 1, 70, 2, 16, 32)
    arrays[3][:, 5:20] = -80.0
    arrays[3][:, 33:35] = -80.0
    o, st, states = _chunked_emulation(*(torch.from_numpy(a) for a in arrays))
    assert all(bool(torch.isfinite(t).all()) for t in (o, st, *states))
    want_o, want_s, _ = _jax(*arrays)
    np.testing.assert_allclose(o.numpy(), want_o, **TOL)
    np.testing.assert_allclose(st.numpy(), want_s, **TOL)


def test_chain_keeps_the_states_at_chunk_starts():
    arrays = _inputs(3, 1, 100, 2, 16, 16)
    t = [torch.from_numpy(a) for a in arrays]
    _, _, states = _chunked_emulation(*t)
    for c, sc in enumerate(states):
        if c == 0:
            torch.testing.assert_close(sc, t[5], rtol=0, atol=0)
            continue
        n = c * C
        _, want = wkv6_bshd_ref(t[0][:, :n], t[1][:, :n], t[2][:, :n], t[3][:, :n],
                                t[4], t[5], chunk=C)
        torch.testing.assert_close(sc, want, **TOL)


def test_chunked_emulation_bfloat16_inputs():
    arrays = _inputs(16, 1, 50, 2, 32, 32)
    t = [torch.from_numpy(a) for a in arrays]
    tb = [x.to(torch.bfloat16) for x in t[:4]]
    o, st, _ = _chunked_emulation(*[x.float() for x in tb], t[4], t[5])
    o = o.to(torch.bfloat16)
    want_o, want_s, _ = _jax(*[x.float().numpy() for x in tb], arrays[4], arrays[5])
    err = (o.float().numpy() - want_o).__abs__()
    assert (err <= 1e-4 + 2.0 ** -7 * np.abs(want_o)).all()
    np.testing.assert_allclose(st.numpy(), want_s, **TOL)
    # the plain CPU path takes bfloat16 the same way: o in bfloat16,
    # the state in float32
    po, ps_ = wkv_ops.wkv6_bshd(*tb, t[4], t[5], chunk=32)
    assert po.dtype == torch.bfloat16 and ps_.dtype == torch.float32
    assert ((po.float() - o.float()).abs() <= 1e-4 + 2.0 ** -7 * o.float().abs()).all()
    torch.testing.assert_close(ps_, st, **TOL)


# -- the wrapper: validation and what it launches --------------------------------

class _Recorder:
    def __init__(self):
        self.calls = []
        self.launches = 0

    def __call__(self, *args):
        self.calls.append(args)
        self.launches += 1


@pytest.fixture
def recorded(monkeypatch):
    rec = _Recorder()
    monkeypatch.setattr(_build, "require_cuda", lambda what, *t: None)
    monkeypatch.setattr(_build, "stream", lambda t: 0)
    monkeypatch.setattr(wkv_kernel, "WKV6", rec)
    return rec


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,d,dv", [(1, 64, 64), (1, 64, 32), (100, 64, 32),
                                    (40, 128, 48), (33, 16, 128)])
def test_wrapper_takes_d_and_dv_apart(recorded, dtype, s, d, dv):
    b, h = 2, 3
    r = torch.zeros((b, s, h, d), dtype=dtype)
    v = torch.zeros((b, s, h, dv), dtype=dtype)
    o, st = wkv_kernel.wkv6_cuda(r, r, v, r, torch.zeros((h, d), dtype=dtype),
                                 torch.zeros((b, h, d, dv)))
    assert o.shape == (b, s, h, dv) and o.dtype == dtype
    assert st.shape == (b, h, d, dv) and st.dtype == torch.float32
    args = recorded.calls[-1]
    assert args[9:14] == (b, s, h, d, dv)
    assert args[-2] == _build.DTYPE_CODES[dtype]
    n_ws = wkv_kernel.workspace_floats(b, s, h, d, dv)
    assert (args[8] is None) == (s == 1) == (n_ws == 0)


@pytest.mark.parametrize("case,err", [("s0 shape", ValueError), ("empty D", ValueError),
                                      ("float64", TypeError)])
def test_wrapper_refuses_what_the_kernel_does_not_take(recorded, case, err):
    """Any D and Dv run (tests/test_torch_widths.py); what still raises is
    a wrong s0, an empty head and a dtype the kernels do not take."""
    d = 0 if case == "empty D" else 40
    r = torch.zeros((1, 4, 2, d), dtype=torch.float64 if case == "float64" else torch.float32)
    s0 = torch.zeros((1, 2, d + (case == "s0 shape"), 24))
    with pytest.raises(err):
        wkv_kernel.wkv6_cuda(r, r, torch.zeros((1, 4, 2, 24), dtype=r.dtype), r,
                             torch.zeros((2, d)), s0)
    r64 = torch.zeros((1, 4, 2, 64))
    with pytest.raises(TypeError):
        wkv_kernel.wkv6_cuda(r64, r64.bfloat16(), r64, r64, torch.zeros((2, 64)),
                             torch.zeros((1, 2, 64, 64)))
    assert not recorded.calls

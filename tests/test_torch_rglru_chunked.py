"""The time-split RG-LRU scan of the port (`csrc/rglru_scan.cu`) on the CPU.

* A float32 emulation of the kernel's order, at the cluster and chunk
  sizes `kernels/_scan_plan.py:scan_plan` gives: pass 1 walks each
  warp's chunk from h = 0 (A = prod a, H = the chunk's last local h);
  the warps' summaries of a cluster are chained in (rank, warp) order
  from the round's carry, carry = A * carry + H, whose last link carries
  into the next round; pass 2 re-runs each chunk from its carry-in.  Every step a product and a sum rounded apart, as the
  kernel's __fmul_rn / __fadd_rn.  It is held against the port's
  `rglru_scan_ref` (the sequential loop) and the JAX `rglru_scan_pallas`
  in interpret mode: B 1 and 4, S 1-1024, W 40 and 2560, a near 1
  (0.9999) and near 0, float32 and bfloat16 inputs.
* `scan_plan`: at least the SM count in blocks at recurrentgemma's
  prefill, its shared memory within one block's limit for every S, its
  grid within limits, and the order covering each step once.
* The launch wrapper (the launcher replaced by a recorder: the CUDA call
  runs only on the card) hands the kernel the plan, takes bfloat16 and
  mixed dtypes and copies a channel axis without unit stride.

Tolerance 1e-5 (abs + rel; `TOL_F32["rglru_scan"]` of chip_smoke.py); a
bfloat16 h is held to one bfloat16 rounding (2^-8 of its size) of the
float32 reference, and to one bfloat16 step of the JAX kernel's.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rglru_scan.kernel import rglru_scan_pallas
from repro_torch.kernels import _build
from repro_torch.kernels import _scan_plan as sp
from repro_torch.kernels.rglru_scan import kernel as scan_kernel
from repro_torch.kernels.rglru_scan import ops as scan_ops
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref

TOL = 1e-5
BF16_REL = 2.0 ** -8                 # half a bfloat16 step: one rounding


def _emulation(a, b, h0, plan):
    """rglru_scan_kernel's arithmetic in float32 torch: a, b (B, S, W)
    (float32 values of the input dtype), h0 (B, W) -> h (B, S, W)
    float32, before the store's rounding."""
    a, b, h = a.float(), b.float(), h0.float()
    bsz, s, w = a.shape
    out = torch.empty((bsz, s, w), dtype=torch.float32)
    if plan.route == "step":
        out[:, 0] = a[:, 0] * h + b[:, 0]
        return out

    def summary(rg):
        A, H = torch.ones(bsz, w), torch.zeros(bsz, w)
        for t in rg:
            A = A * a[:, t]
            H = a[:, t] * H + b[:, t]
        return A, H

    carry = h
    for ranks in sp.scan_order(plan, s):
        ranges = [rg for warps in ranks for rg in warps]     # (rank, warp) order
        sums = [summary(rg) for rg in ranges]                 # pass 1
        c = carry
        for rg, (A, H) in zip(ranges, sums):
            hh = c                                            # pass 2 from the carry-in
            for t in rg:
                hh = a[:, t] * hh + b[:, t]
                out[:, t] = hh
            c = A * c + H                                     # the chain
        carry = c
    return out


def _inputs(b, s, w, regime, seed, normalised=True):
    """a in [0.9999, 1) ("near1") or [0, 1e-3) ("near0"); b as the
    RG-LRU makes it, sqrt(1 - a^2) * x (`models/rglru.py:_rglru_coeffs`),
    which keeps h of the size of x; unnormalised, b = x."""
    rng = np.random.default_rng(seed)
    if regime == "near1":
        a = (0.9999 + 1e-4 * rng.uniform(0.0, 1.0, (b, s, w))).astype(np.float32)
    else:
        a = rng.uniform(0.0, 1e-3, (b, s, w)).astype(np.float32)
    x = rng.standard_normal((b, s, w)).astype(np.float32)
    if normalised:
        x = (np.sqrt(np.maximum(1.0 - a.astype(np.float64) ** 2, 1e-12)) * x).astype(np.float32)
    h0 = rng.standard_normal((b, w)).astype(np.float32)
    return a, x, h0


def _within(got, ref, tol=TOL):
    got, ref = got.float(), ref.float()
    assert torch.isfinite(got).all()
    bad = (got - ref).abs() > tol + tol * ref.abs()
    assert not bad.any(), f"max err {float((got - ref).abs().max()):.3g}"


CASES = [(b, s, w) for b in (1, 4) for s in (1, 7, 255, 256, 257, 1024)
         for w in (40, 2560)]


@pytest.mark.parametrize("regime", ["near1", "near0"])
@pytest.mark.parametrize("b,s,w", CASES)
def test_emulation_matches_reference(b, s, w, regime):
    a, x, h0 = _inputs(b, s, w, regime, b * 7919 + s * 31 + w)
    plan = sp.scan_plan(b, s, w, 4)
    got = _emulation(*(torch.from_numpy(t) for t in (a, x, h0)), plan)
    _within(got, rglru_scan_ref(*(torch.from_numpy(t) for t in (a, x, h0))))


@pytest.mark.parametrize("regime", ["near1", "near0"])
@pytest.mark.parametrize("b,s,w", [(1, 7, 40), (1, 257, 40), (4, 255, 40),
                                   (1, 256, 2560), (1, 1024, 40), (4, 1, 2560)])
def test_emulation_matches_jax_kernel(b, s, w, regime):
    """The JAX Pallas kernel in interpret mode, at its own time blocks of
    256 (padded past S)."""
    a, x, h0 = _inputs(b, s, w, regime, b * 104729 + s + w)
    plan = sp.scan_plan(b, s, w, 4)
    got = _emulation(*(torch.from_numpy(t) for t in (a, x, h0)), plan)
    want = rglru_scan_pallas(*(jnp.asarray(t) for t in (a, x, h0)), interpret=True)
    _within(got, torch.from_numpy(np.asarray(want)))


@pytest.mark.parametrize("b,s,w", [(1, 256, 2560), (4, 257, 40), (1, 1, 2560)])
def test_bf16_inputs_within_one_rounding(b, s, w):
    """bfloat16 a and b, float32 h0: h comes out in bfloat16, within one
    bfloat16 rounding of the float32 recurrence on the same values and
    within one bfloat16 step of the JAX kernel's bfloat16 h."""
    a, x, h0 = _inputs(b, s, w, "near1", s + w)
    abf, xbf = (torch.from_numpy(t).bfloat16() for t in (a, x))
    plan = sp.scan_plan(b, s, w, 2)
    got = _emulation(abf, xbf, torch.from_numpy(h0), plan).bfloat16()
    ref = rglru_scan_ref(abf.float(), xbf.float(), torch.from_numpy(h0))
    assert got.dtype == torch.bfloat16
    assert bool(((got.float() - ref).abs() <= TOL + BF16_REL * ref.abs()).all())
    plain = scan_ops.rglru_scan(abf, xbf, torch.from_numpy(h0))
    assert plain.dtype == torch.bfloat16          # the CPU path, as JAX returns it
    want = rglru_scan_pallas(jnp.asarray(abf.float().numpy()).astype(jnp.bfloat16),
                             jnp.asarray(xbf.float().numpy()).astype(jnp.bfloat16),
                             jnp.asarray(h0), interpret=True)
    assert want.dtype == jnp.bfloat16
    want = torch.from_numpy(np.asarray(want.astype(jnp.float32)))
    assert bool(((got.float() - want).abs() <= TOL + 2 * BF16_REL * want.abs()).all())


@pytest.mark.parametrize("s", [255, 1024])
def test_unnormalised_inputs_round_no_worse_than_the_sequential_loop(s):
    """With a near 1 and b = x unnormalised, h is a random walk (|h| up to
    ~100 at S 1024) and the sequential float32 loop is itself ~1e-4 off
    the exact recurrence (float64), so no two float32 orders agree to
    1e-5 there, whatever the chunk.  The kernel's order stays of the same
    order as the sequential loop's own error of the exact value (abs +
    rel): within 4x of it (2.9x and 0.8x at these seeds)."""
    a, x, h0 = (torch.from_numpy(t) for t in _inputs(1, s, 40, "near1", 1,
                                                       normalised=False))
    exact = torch.empty(a.shape, dtype=torch.float64)
    h = h0.double()
    for t in range(s):
        h = a[:, t].double() * h + x[:, t].double()
        exact[:, t] = h
    rel = lambda y: float(((y.double() - exact).abs() / (1 + exact.abs())).max())
    seq = rel(rglru_scan_ref(a, x, h0))
    assert rel(_emulation(a, x, h0, sp.scan_plan(1, s, 40, 4))) <= 4 * seq + 1e-6


def test_emulation_is_the_sequential_loop_inside_a_chunk():
    """With one warp chunk covering all of S (S <= the chunk), the
    kernel's order is the sequential loop's, bit for bit."""
    a, x, h0 = (torch.from_numpy(t) for t in _inputs(2, 9, 40, "near1", 3))
    plan = sp.ScanPlan(route="cluster", cluster=1, chunk=32, rounds=1, blocks=4,
                       smem_bytes=sp.smem_bytes(32, 1, 4))
    torch.testing.assert_close(_emulation(a, x, h0, plan), rglru_scan_ref(a, x, h0),
                               rtol=0, atol=0)


# -- the plan --------------------------------------------------------------------

def test_plan_fills_the_card_at_recurrentgemma_prefill():
    p = sp.scan_plan(1, 256, 2560, 4)
    assert (p.route, p.cluster, p.chunk, p.rounds) == ("cluster", 4, 8, 1)
    assert p.blocks == 320 >= sp.SMS
    assert sp.scan_plan(1, 300, 2560, 4).blocks >= sp.SMS
    assert sp.scan_plan(4, 256, 2560, 4).cluster == 1      # 320 tiles fill it
    assert sp.scan_plan(4, 1, 2560, 4).route == "step"


@pytest.mark.parametrize("es", [2, 4])
def test_plan_stays_within_limits_for_every_s(es):
    for s in list(range(1, 600)) + [1023, 1024, 1025, 4096, 65536, 10 ** 6]:
        for b, w in ((1, 2560), (4, 2560), (1, 40), (64, 4096)):
            p = sp.scan_plan(b, s, w, es)
            assert p.smem_bytes <= sp.SMEM_MAX
            assert p.blocks <= 2 ** 31 - 1
            assert p.cluster in (1, 2, 4, 8) and 1 <= p.chunk <= sp.MAX_CHUNK
            if p.route == "cluster":
                assert p.rounds * p.cluster * p.tile >= s
                assert (p.rounds - 1) * p.cluster * p.tile < s
                if p.cluster > 1:           # each warp keeps >= MIN_STEPS
                    assert s >= p.cluster * sp.WARPS * sp.MIN_STEPS


@pytest.mark.parametrize("s", [2, 7, 255, 257, 1024, 5000])
def test_order_walks_every_step_once(s):
    p = sp.scan_plan(1, s, 2560, 4)
    steps = [t for ranks in sp.scan_order(p, s) for ranges in ranks
             for rg in ranges for t in rg]
    assert steps == list(range(s))


def test_plan_halves_a_cluster_the_card_cannot_hold(monkeypatch):
    monkeypatch.setattr(scan_kernel, "_sm_count", lambda index: sp.SMS)
    monkeypatch.setattr(scan_kernel, "cluster_capacity",
                        lambda index, cs, chunk, dt, hdt: 0 if cs > 2 else 5)
    p = scan_kernel.launch_plan(1, 256, 2560, 0, 0, 0)
    assert (p.cluster, p.chunk) == (2, 16)


# -- the launch wrapper ----------------------------------------------------------

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
    monkeypatch.setattr(scan_kernel, "SCAN", rec)
    monkeypatch.setattr(scan_kernel, "_sm_count", lambda index: sp.SMS)
    monkeypatch.setattr(scan_kernel, "cluster_capacity", lambda *a: 16)
    return rec


@pytest.mark.parametrize("adt,bdt,hdt,code,hcode", [
    (torch.float32, torch.float32, torch.float32, 0, 0),
    (torch.bfloat16, torch.bfloat16, torch.float32, 1, 0),
    (torch.bfloat16, torch.bfloat16, torch.bfloat16, 1, 1),
    (torch.bfloat16, torch.float32, torch.float32, 0, 0),     # both as float32
    (torch.float32, torch.float32, torch.bfloat16, 0, 0),     # h0 to float32
])
@pytest.mark.parametrize("s", [1, 256])
def test_wrapper_takes_both_dtypes(recorded, adt, bdt, hdt, code, hcode, s):
    b, w = 2, 2560
    a, x = torch.zeros((b, s, w), dtype=adt), torch.zeros((b, s, w), dtype=bdt)
    h = scan_kernel.rglru_scan_cuda(a, x, torch.zeros((b, w), dtype=hdt))
    assert h.shape == (b, s, w) and h.dtype == adt
    args = recorded.calls[-1]
    plan = sp.scan_plan(b, s, w, 2 if code else 4)
    assert args[4:7] == (b, s, w)
    assert args[12:16] == (plan.cluster, plan.chunk, code, hcode)


def test_wrapper_passes_strides_and_copies_a_strided_channel_axis(recorded):
    b, s, w = 2, 9, 64
    big = torch.zeros((b, s, 2 * w))
    h_prev = torch.zeros((b, 5, w))
    scan_kernel.rglru_scan_cuda(big[:, :, :w], big[:, :, w:], h_prev[:, -1])
    args = recorded.calls[-1]
    assert args[7:12] == (s * 2 * w, 2 * w, s * 2 * w, 2 * w, 5 * w)
    scan_kernel.rglru_scan_cuda(big[:, :, ::2], big[:, :, 1::2], h_prev[:, -1])
    args = recorded.calls[-1]
    assert args[7:9] == (s * w, w)                   # the contiguous copy's


def test_wrapper_refuses_float16_and_wrong_shapes(recorded):
    """float16 is one of the kernels' types since the float16 route landed
    (tests/test_torch_float16.py); a type they do not take (float64) and a
    wrong h0 shape still raise before any launch."""
    a = torch.zeros((1, 4, 8))
    with pytest.raises(TypeError):
        scan_kernel.rglru_scan_cuda(a.double(), a.double(), torch.zeros((1, 8)))
    with pytest.raises(ValueError):
        scan_kernel.rglru_scan_cuda(a, a, torch.zeros((1, 9)))
    assert not recorded.calls

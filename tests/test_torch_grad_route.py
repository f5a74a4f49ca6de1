"""Autograd through the port's CUDA kernel wrappers (`kernels/_grad.py`),
on the CPU: each kernel launcher is replaced by its plain version run
under `torch.no_grad()` (an output with no graph, as a kernel's), which
counts its calls.

* For the seven ops (`fused_rmsnorm`, `fused_rmsnorm_residual` with both
  outputs, `fused_mlp` with and without a gate, `flash_attention` with
  GQA, a window and k / v that need no gradient, `moe_mlp` with and
  without a gate, `rglru_scan` with and without h0's gradient, `wkv6` /
  `wkv6_bshd` with s_final unused and used), each op's card path under
  `_grad.run` gives exactly the plain op's gradients, in each input's
  dtype, from one kernel launch and none in the backward.
* Through the ops themselves, on `meta` tensors (not CPU tensors, so the
  card path is taken; the replaced launcher runs): the autograd Function
  is taken only when grad mode is on and an input requires a gradient,
  the kernel launching once either way; the paged decode ops raise
  under grad.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import _grad
from repro_torch.kernels.flash_attention import kernel as fk
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.flash_attention import ref as fref
from repro_torch.kernels.fused_mlp import kernel as mk
from repro_torch.kernels.fused_mlp import ops as mops
from repro_torch.kernels.fused_mlp import ref as mref
from repro_torch.kernels.fused_norm import kernel as nk
from repro_torch.kernels.fused_norm import ops as nops
from repro_torch.kernels.fused_norm import ref as nref
from repro_torch.kernels.moe_mlp import kernel as ek
from repro_torch.kernels.moe_mlp import ops as eops
from repro_torch.kernels.moe_mlp import ref as eref
from repro_torch.kernels.rglru_scan import kernel as gk
from repro_torch.kernels.rglru_scan import ops as gops
from repro_torch.kernels.rglru_scan import ref as gref
from repro_torch.kernels.wkv6 import kernel as wk
from repro_torch.kernels.wkv6 import ops as wops
from repro_torch.kernels.wkv6 import ref as wref

# (kernel module, launcher function name, its plain stand-in)
KERNELS = ((nk, "fused_rmsnorm_cuda", nref.fused_rmsnorm_ref),
           (nk, "fused_rmsnorm_residual_cuda", nref.fused_rmsnorm_residual_ref),
           (mk, "fused_mlp_cuda", mref.fused_mlp_ref),
           (fk, "flash_attention_cuda", fref.flash_attention_ref),
           (ek, "moe_mlp_cuda", eref.moe_mlp_ref),
           (gk, "rglru_scan_cuda", gref.rglru_scan_ref),
           (wk, "wkv6_cuda", wref.wkv6_bshd_ref))


@pytest.fixture
def launches(monkeypatch):
    """Each launcher replaced by its plain version under no_grad; returns
    the list of launcher names called, in order."""
    calls = []
    for mod, name, plain in KERNELS:
        def standin(*args, _plain=plain, _name=name, **kw):
            calls.append(_name)
            with torch.no_grad():
                return _plain(*args, **kw)
        monkeypatch.setattr(mod, name, standin)
    return calls


def _late(mod, name):
    """mod.name looked up at call time (so the fixture's stand-in runs)."""
    return lambda *args, **kw: getattr(mod, name)(*args, **kw)


def _t(rng, *shape, dtype=torch.float32, grad=True, scale=1.0):
    t = torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32))
    return t.to(dtype).requires_grad_(grad)


def _cases():
    """(id, card-path function, plain op, input builder, kw, outputs the
    loss uses)."""
    def norm(rng):
        return [_t(rng, 3, 5, 16), _t(rng, 16, scale=0.1)]

    def norm_res(rng):
        return [_t(rng, 3, 5, 16), _t(rng, 3, 5, 16), _t(rng, 16, scale=0.1)]

    def mlp(rng, gate=True, dtype=torch.float32):
        return [_t(rng, 2, 5, 16, dtype=dtype),
                _t(rng, 16, 32, dtype=dtype, scale=0.2) if gate else None,
                _t(rng, 16, 32, dtype=dtype, scale=0.2),
                _t(rng, 32, 16, dtype=dtype, scale=0.2)]

    def flash(rng, kv_grad=True):
        return [_t(rng, 2, 12, 4, 8), _t(rng, 2, 12, 2, 8, grad=kv_grad),
                _t(rng, 2, 12, 2, 8, grad=kv_grad)]

    def moe(rng, gate=True):
        return [_t(rng, 4, 8, 16),
                _t(rng, 4, 16, 32, scale=0.2) if gate else None,
                _t(rng, 4, 16, 32, scale=0.2), _t(rng, 4, 32, 16, scale=0.2)]

    def scan(rng, h0_grad=False):
        a = torch.sigmoid(_t(rng, 2, 10, 16, grad=False)).requires_grad_(True)
        return [a, _t(rng, 2, 10, 16), _t(rng, 2, 16, grad=h0_grad)]

    def wkv(rng, bh=False):
        lead = (4, 10) if bh else (2, 10, 2)
        logw = -torch.exp(_t(rng, *lead, 8, grad=False) - 1.0)
        return [_t(rng, *lead, 8, scale=0.5), _t(rng, *lead, 8, scale=0.5),
                _t(rng, *lead, 8), logw.requires_grad_(True),
                _t(rng, *((4, 1, 8) if bh else (2, 8)), scale=0.1),
                _t(rng, *((4, 8, 8) if bh else (2, 2, 8, 8)), scale=0.1)]

    return [
        ("rmsnorm", nops._rmsnorm_on_card, nref.fused_rmsnorm_ref, norm,
         {"eps": 1e-6}, (0,)),
        ("rmsnorm_residual", nops._rmsnorm_residual_on_card,
         nref.fused_rmsnorm_residual_ref, norm_res, {"eps": 1e-6}, (0, 1)),
        ("rmsnorm_residual_out_only", nops._rmsnorm_residual_on_card,
         nref.fused_rmsnorm_residual_ref, norm_res, {"eps": 1e-6}, (1,)),
        ("mlp_swiglu", mops._mlp_on_card, mref.fused_mlp_ref, mlp,
         {"swiglu": True}, (0,)),
        ("mlp_gelu", mops._mlp_on_card, mref.fused_mlp_ref,
         lambda rng: mlp(rng, gate=False), {"swiglu": False}, (0,)),
        ("mlp_bf16", mops._mlp_on_card, mref.fused_mlp_ref,
         lambda rng: mlp(rng, dtype=torch.bfloat16), {"swiglu": True}, (0,)),
        ("flash_gqa_window", _late(fk, "flash_attention_cuda"), fref.flash_attention_ref,
         flash, {"causal": True, "window": 5}, (0,)),
        ("flash_kv_no_grad", _late(fk, "flash_attention_cuda"), fref.flash_attention_ref,
         lambda rng: flash(rng, kv_grad=False), {"causal": True, "window": None},
         (0,)),
        ("moe_swiglu", _late(ek, "moe_mlp_cuda"), eref.moe_mlp_ref, moe, {"swiglu": True},
         (0,)),
        ("moe_gelu", _late(ek, "moe_mlp_cuda"), eref.moe_mlp_ref,
         lambda rng: moe(rng, gate=False), {"swiglu": False}, (0,)),
        ("rglru_h0_no_grad", _late(gk, "rglru_scan_cuda"), gref.rglru_scan_ref, scan, {},
         (0,)),
        ("rglru_h0_grad", _late(gk, "rglru_scan_cuda"), gref.rglru_scan_ref,
         lambda rng: scan(rng, h0_grad=True), {}, (0,)),
        ("wkv6_bshd_o_only", wops._bshd_on_card, wref.wkv6_bshd_ref, wkv,
         {"chunk": 4}, (0,)),
        ("wkv6_bshd_o_and_state", wops._bshd_on_card, wref.wkv6_bshd_ref, wkv,
         {"chunk": 4}, (0, 1)),
        ("wkv6_bh", wops._bh_on_card, wref.wkv6_ref, lambda rng: wkv(rng, bh=True),
         {"chunk": 4}, (0,)),
    ]


CASES = _cases()


def _loss(out, used, seed):
    outs = out if isinstance(out, tuple) else (out,)
    rng = np.random.default_rng(seed)
    total = 0.0
    for i in used:
        w = torch.from_numpy(rng.standard_normal(tuple(outs[i].shape)).astype(np.float32))
        total = total + (outs[i].float() * w).sum()
    return total


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_kernel_route_gives_the_plain_gradients(launches, case):
    _, on_card, plain, build, kw, used = case
    inputs = build(np.random.default_rng(0))
    wrt = [t for t in inputs if t is not None and t.requires_grad]
    out = _grad.run(on_card, plain, *inputs, **kw)
    assert len(launches) == 1
    first = out[0] if isinstance(out, tuple) else out
    assert type(first.grad_fn).__name__ == "_KernelFunctionBackward"
    got = torch.autograd.grad(_loss(out, used, 1), wrt)
    assert len(launches) == 1              # the backward launches nothing
    want = torch.autograd.grad(_loss(plain(*inputs, **kw), used, 1), wrt)
    for t, g, w in zip(wrt, got, want):
        assert g.dtype == t.dtype
        assert torch.equal(g, w)


def _meta(shape, grad):
    return torch.empty(shape, device="meta").requires_grad_(grad)


OP_CALLS = (
    ("fused_rmsnorm_cuda", lambda g: nops.fused_rmsnorm(_meta((3, 16), g),
                                                         _meta((16,), False))),
    ("fused_rmsnorm_residual_cuda", lambda g: nops.fused_rmsnorm_residual(
        _meta((3, 16), g), _meta((3, 16), False), _meta((16,), False))[1]),
    ("fused_mlp_cuda", lambda g: mops.fused_mlp(
        _meta((2, 3, 16), False), None, _meta((16, 32), g), _meta((32, 16), False),
        swiglu=False)),
    ("flash_attention_cuda", lambda g: fops.flash_attention(
        _meta((1, 6, 4, 8), g), _meta((1, 6, 2, 8), False),
        _meta((1, 6, 2, 8), False))),
    ("moe_mlp_cuda", lambda g: eops.moe_mlp(
        _meta((2, 8, 16), g), _meta((2, 16, 32), False), _meta((2, 16, 32), False),
        _meta((2, 32, 16), False))),
    ("rglru_scan_cuda", lambda g: gops.rglru_scan(
        _meta((1, 4, 8), False), _meta((1, 4, 8), g), _meta((1, 8), False))),
    ("wkv6_cuda", lambda g: wops.wkv6_bshd(
        *(_meta((1, 4, 2, 8), g) for _ in range(4)), _meta((2, 8), False),
        _meta((1, 2, 8, 8), False))[0]),
)


@pytest.mark.parametrize("launcher,call", OP_CALLS, ids=[c[0] for c in OP_CALLS])
def test_the_function_is_taken_only_when_a_gradient_is_wanted(launches, launcher,
                                                              call):
    out = call(True)
    assert type(out.grad_fn).__name__ == "_KernelFunctionBackward"
    out = call(False)
    assert out.grad_fn is None
    with torch.no_grad():
        out = call(True)
    assert out.grad_fn is None
    assert launches == [launcher] * 3


def test_paged_decode_ops_raise_under_grad(launches):
    q = _meta((2, 1, 4, 8), True)
    pages = _meta((5, 4, 2, 8), False)
    tables = torch.zeros((2, 2), dtype=torch.int32, device="meta")
    lengths = torch.zeros((2,), dtype=torch.int32, device="meta")
    with pytest.raises(RuntimeError, match="no gradient"):
        fops.paged_decode_attention(q, pages, pages, tables, lengths)
    scales = torch.empty((5, 2), device="meta")
    with pytest.raises(RuntimeError, match="no gradient"):
        fops.paged_decode_attention_int8(
            q, pages.to(torch.int8), pages.to(torch.int8), scales, scales, tables,
            lengths, _meta((2, 2, 8), False), _meta((2, 2, 8), False))
    assert launches == []

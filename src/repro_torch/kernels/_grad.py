"""Autograd through the CUDA kernels: the kernel's forward, the plain
version's gradients.

No JAX kernel has a VJP (the JAX package has no `custom_vjp` around a
Pallas call and trains through its plain paths), so there is no backward
kernel to port.  `run` gives an op on the card a gradient all the same:
the forward launches the hand-written kernel through the op's own
launcher (so the launch count counts it) and saves the inputs; the
backward recomputes the op's plain version (`ref.py`) on detached copies
of them under `enable_grad` and returns `torch.autograd.grad` of that
recomputation for the inputs that need a gradient, each in its input's
dtype.  The gradients are exactly the plain function's; the forward
stays the kernel's.

The route is taken only when a gradient is wanted (`wanted`): grad mode
on and an input that requires one.  Otherwise `run` calls the kernel as
it is, so serving launches the same kernels as before and pays nothing.
A kernel that fails to build or to launch raises either way; nothing
falls back to the plain forward.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.autograd.function import once_differentiable


def wanted(*inputs) -> bool:
    """Grad mode is on and some tensor input requires a gradient."""
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in inputs)


class _KernelFunction(torch.autograd.Function):
    """forward: `kernel(*inputs, **kw)`; backward: the gradients of
    `plain(*inputs, **kw)`.  `inputs` are tensors or None (an optional
    weight); `kw` holds the op's other arguments."""

    @staticmethod
    def forward(ctx, kernel: Callable, plain: Callable, kw: dict, *inputs):
        ctx.set_materialize_grads(False)     # an unused output's grad is None
        ctx.plain, ctx.kw = plain, kw
        ctx.save_for_backward(*inputs)       # the inputs, never the outputs
        return kernel(*inputs, **kw)

    @staticmethod
    @once_differentiable
    def backward(ctx, *grads):
        inputs = ctx.saved_tensors
        need = ctx.needs_input_grad[3:]
        with torch.enable_grad():
            det = [None if t is None else t.detach().requires_grad_(n)
                   for t, n in zip(inputs, need)]
            out = ctx.plain(*det, **ctx.kw)
        outs = out if isinstance(out, tuple) else (out,)
        pairs = [(o, g) for o, g in zip(outs, grads)
                 if g is not None and o.requires_grad]
        wrt = [t for t, n in zip(det, need) if n]
        got = iter(torch.autograd.grad([o for o, _ in pairs], wrt,
                                       [g for _, g in pairs], allow_unused=True)
                   if pairs and wrt else [None] * len(wrt))
        return (None, None, None, *(next(got) if n else None for n in need))


def run(kernel: Callable, plain: Callable, *inputs, **kw):
    """`kernel(*inputs, **kw)` for tensors on the card; under autograd
    (`wanted`) through `_KernelFunction`, so the plain version's
    gradients flow to the inputs."""
    if wanted(*inputs):
        return _KernelFunction.apply(kernel, plain, kw, *inputs)
    return kernel(*inputs, **kw)


def refuse(what: str, *inputs) -> None:
    """Raise when a gradient is wanted through an op that has no training
    path (the paged decode ops)."""
    if wanted(*inputs):
        raise RuntimeError(f"{what}: no gradient on the card (a decode-only "
                           f"op); run it under torch.no_grad()")

"""Named host spans for `torch.profiler`, free when no profiler runs.

`span(name, args)` is a context manager: a `record_function` range
while a profiler is recording, else one shared `nullcontext` (a bare
`record_function` costs ~14 µs on a CPU host even with no profiler,
the guarded form ~0.6 µs).  The profiler is the only switch.

A range is a kineto host event, so it shares the device trace's clock:
each device activity can be placed inside the spans open at its launch.
Every name starts with `mz.`:

* the engine (`serving/engine.py`): `mz.step` around `step()`,
  `mz.admit` around admission, `mz.prefill` around each admission's
  state call, `mz.decode` around the decode step's state call, `mz.sync`
  around each point where the host waits for the device (the drain
  before a state call, the NaN guard's read, the sampled tokens' reads,
  a mesh's agreement);
* the transformer's layers (`models/transformer.py`): `mz.attn`,
  `mz.mlp` or `mz.moe`, and `mz.unembed`;
* each launch of the port's own kernels (`kernels/_build.py`):
  `mz.launch`, a host op (`op`).

The profiler keeps no `args` string of a range anywhere it can be read
back, so `args` (e.g. a request's id) goes into the recorded name after
one space: `mz.prefill rid=7 len=1500`.

The profiler links a device activity to the innermost host *op* open at
its launch, and a `record_function` range is not an op: a kernel of the
port's ctypes libraries, launched outside every ATen op, had its launch
traced but linked to nothing (measured on an H100, nvcc's static and
shared CUDA runtime alike).  `op(name)` opens a range of function scope
instead, which the profiler does link a launch to.
"""
from __future__ import annotations

import contextlib

import torch
import torch.autograd.profiler as _profiler

_OFF = contextlib.nullcontext()


def span(name: str, args: str | None = None):
    """A `record_function` range named `name` (and `args`) while a
    profiler records; otherwise a shared no-op context."""
    if _profiler._is_profiler_enabled:
        return _profiler.record_function(f"{name} {args}" if args else name)
    return _OFF


def op(name: str):
    """A host op named `name` while a profiler records (launches made
    inside it are linked to it); otherwise a shared no-op context."""
    if _profiler._is_profiler_enabled:
        return torch._C._profiler._RecordFunctionFast(name)
    return _OFF

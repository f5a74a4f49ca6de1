"""The port's GPipe pipeline (`repro_torch.parallel.pipeline`) against the
JAX package's sequential stack, on the CPU, float32: the check of
`tests/parallel_prog.py:check_pipeline_parallel` on a ("pp",) mesh of 4
gloo ranks (`_torch_mesh.run`, one spawn for the module).

Each case draws L layers of w (d, d) (scale 0.3) and x (n_micro, mb, d)
with numpy; `split_stages` cuts the layers into 4 stages (one, and two,
layers a stage), each rank runs `pipeline_apply` of its stage, and the
output equals JAX's `tanh(h @ w)` applied layer after layer within 1e-4
(absolute and relative), on every rank, in microbatch order.  Under
torch autograd the gradients of sum(c * out) for x and for every layer's
w (each stage's, gathered) equal those of the sequential stack in torch
within 1e-5, each stage's parameters reached once: the ring shifted
n_micro + n_stages - 2 times each way, one all_reduce of the output.
`split_stages` itself equals JAX's.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_mesh
from repro.parallel import pipeline as jax_pipeline
from repro_torch.parallel import pipeline

STAGES = 4
D, MB = 16, 2
# name -> (layers, microbatches)
CASES = {"one_layer_a_stage": (4, 4), "two_layers_a_stage": (8, 6)}
FWD_TOL, GRAD_TOL = 1e-4, 1e-5


def _inputs(name):
    layers, n_micro = CASES[name]
    rng = np.random.default_rng(layers)
    ws = (rng.standard_normal((layers, D, D)) * 0.3).astype(np.float32)
    x = rng.standard_normal((n_micro, MB, D)).astype(np.float32)
    c = rng.standard_normal((n_micro, MB, D)).astype(np.float32)
    return ws, x, c


def _sequential_jax(ws, x):
    h = jnp.asarray(x)
    for w in ws:
        h = jnp.tanh(h @ jnp.asarray(w))
    return np.asarray(h)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jobs = [(name, "pipeline", {k: torch.from_numpy(v) for k, v in
                                zip(("ws", "x", "c"), _inputs(name))}) for name in CASES]
    return _torch_mesh.run(tmp_path_factory.mktemp("pp"), [(STAGES, 1)], jobs)[(STAGES, 1)]


@pytest.mark.parametrize("name", list(CASES))
def test_pipeline_output_matches_the_sequential_stack(runs, name):
    ws, x, _ = _inputs(name)
    want = _sequential_jax(ws, x)
    out = runs[name]
    np.testing.assert_allclose(out["plain"].numpy(), want, rtol=FWD_TOL, atol=FWD_TOL)
    np.testing.assert_allclose(out["out"].numpy(), want, rtol=FWD_TOL, atol=FWD_TOL)
    layers = CASES[name][0]
    assert out["split_shape"] == (STAGES, layers // STAGES, D, D)
    assert out["stage_shape"] == (1, layers // STAGES, D, D)


@pytest.mark.parametrize("name", list(CASES))
def test_pipeline_gradients_match_the_sequential_stack(runs, name):
    ws, x, c = _inputs(name)
    wt = torch.from_numpy(ws).requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    h = xt
    for i in range(ws.shape[0]):
        h = torch.tanh(h @ wt[i])
    (h * torch.from_numpy(c)).sum().backward()
    out = runs[name]
    np.testing.assert_allclose(out["grad_x"].numpy(), xt.grad.numpy(), rtol=0, atol=GRAD_TOL)
    np.testing.assert_allclose(out["grad_w"].numpy(), wt.grad.numpy(), rtol=0, atol=GRAD_TOL)
    n_micro = CASES[name][1]
    assert out["counts"] == {"shift": n_micro + STAGES - 2, "shift_bwd": n_micro + STAGES - 2,
                             "all_reduce": 1, "all_reduce_bwd": 1}


def test_split_stages_matches_jax():
    ws, _, _ = _inputs("two_layers_a_stage")
    tree = {"w": ws, "b": np.arange(8 * 3, dtype=np.float32).reshape(8, 3)}
    want = jax_pipeline.split_stages({k: jnp.asarray(v) for k, v in tree.items()}, STAGES)
    got = pipeline.split_stages({k: torch.from_numpy(v) for k, v in tree.items()}, STAGES)
    for k in tree:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    with pytest.raises(ValueError, match="do not split"):
        pipeline.split_stages({"w": torch.zeros(6, 2)}, STAGES)

"""The port's optimizers and int8 gradient compression against the JAX
package's (`repro.training.optimizer`, `repro.parallel.compression`) on
the same trees, made from a seed with numpy: float32 and bfloat16
parameters, stacked (L, d) norm scales (2-D, so weight-decayed as in
JAX), a 3-D expert tensor, 1-D vectors and a list.

* `lr_at` of the cosine, linear and constant schedules;
* `global_norm` and `clip_by_global_norm`, under and over the limit;
* AdamW (float32 and bfloat16 moments) and Adafactor, one update and
  six, the state trees leaf for leaf;
* `quantize_int8` / `compressed_gradients` with error feedback, over
  several rounds (the port's int8 codes equal JAX's), and the JAX test's
  bounds (one-shot error within a step; the accumulated estimate within
  1 % after 50 rounds).

Tolerances: float32 results within rtol 1e-5 (atol 1e-7); a bfloat16
parameter or moment within one bfloat16 rounding (rtol 2^-7) of JAX's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.parallel import compression as jax_comp
from repro.training import optimizer as jax_opt
from repro_torch import bridge
from repro_torch.parallel import compression
from repro_torch.training import optimizer as opt

F32_TOL = dict(rtol=1e-5, atol=1e-7)
BF16_TOL = dict(rtol=2 ** -7, atol=1e-6)

_jax_apply = jax.jit(jax_opt.apply_opt, static_argnums=0)


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)

    def r(*shape):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    return {"w": r(8, 16), "norm": r(3, 16), "b": r(16), "experts": r(2, 4, 6),
            "emb": [r(5, 4), r(1)]}


def _jax(tree, dtype=jnp.float32):
    return jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)


def _port(tree, dtype=torch.float32):
    return bridge.tree_map(lambda a: torch.from_numpy(a).to(dtype), tree)


def _close(port_tree, jax_tree):
    jp = bridge.tree_paths(jax.tree.map(lambda a: np.asarray(a, np.float32), jax_tree))
    tp = bridge.tree_paths(port_tree)
    assert [p for p, _ in jp] == [p for p, _ in tp]
    for (path, want), (_, got) in zip(jp, tp):
        tol = BF16_TOL if got.dtype == torch.bfloat16 else F32_TOL
        np.testing.assert_allclose(got.float().numpy(), want, **tol,
                                   err_msg="/".join(map(str, path)))


@pytest.mark.parametrize("schedule", ("cosine", "linear", "constant"))
def test_lr_schedules(schedule):
    cfg = dict(lr=1e-3, warmup_steps=10, total_steps=100, schedule=schedule)
    for step in (0, 1, 5, 9, 10, 11, 50, 99, 100, 150):
        want = float(jax_opt.lr_at(jax_opt.OptimizerConfig(**cfg), step))
        got = opt.lr_at(opt.OptimizerConfig(**cfg), torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        assert float(got) == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("max_norm", (0.5, 1e3))
def test_global_norm_and_clip(max_norm):
    g = _tree(1)
    assert float(opt.global_norm(_port(g))) == pytest.approx(
        float(jax_opt.global_norm(_jax(g))), rel=1e-6)
    jc, jn = jax_opt.clip_by_global_norm(_jax(g, jnp.bfloat16), max_norm)
    tc, tn = opt.clip_by_global_norm(_port(g, torch.bfloat16), max_norm)
    assert float(tn) == pytest.approx(float(jn), rel=1e-6)
    _close(tc, jc)


@pytest.mark.parametrize("steps", (1, 6))
@pytest.mark.parametrize("name,param_dtype,moments", [
    ("adamw", "float32", "float32"), ("adamw", "bfloat16", "float32"),
    ("adamw", "bfloat16", "bfloat16"), ("adafactor", "float32", "float32"),
    ("adafactor", "bfloat16", "float32")])
def test_updates_match_jax(name, param_dtype, moments, steps):
    cfg = dict(name=name, lr=1e-2, warmup_steps=2, total_steps=20,
               moment_dtype=moments)
    jcfg, tcfg = jax_opt.OptimizerConfig(**cfg), opt.OptimizerConfig(**cfg)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[param_dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[param_dtype]
    jp, tp = _jax(_tree(0), jdt), _port(_tree(0), tdt)
    js, ts = jax_opt.init_opt(jcfg, jp), opt.init_opt(tcfg, tp)
    _close(ts, js)
    for i in range(steps):
        g = _tree(10 + i, scale=0.3)
        jp, js, jn = _jax_apply(jcfg, _jax(g, jdt), js, jp)
        tp, ts, tn = opt.apply_opt(tcfg, _port(g, tdt), ts, tp)
        assert float(tn) == pytest.approx(float(jn), rel=1e-5)
    assert ts["step"].dtype == torch.int32 and int(ts["step"]) == steps
    _close(tp, jp)
    _close(ts, js)
    assert all(t.dtype == tdt for t in bridge.tree_leaves(tp))


def test_quantize_int8_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((64, 33)).astype(np.float32)
    x[0, :4] = (np.arange(4) + 0.5) * np.abs(x).max() / 127.0   # half-way ties
    jq, js = jax_comp.quantize_int8(jnp.asarray(x))
    tq, ts = compression.quantize_int8(torch.from_numpy(x))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert float(ts) == float(js)


def test_compressed_gradients_with_error_feedback_match_jax():
    jerr = jax_comp.init_error_feedback(_jax(_tree(0)))
    terr = compression.init_error_feedback(_port(_tree(0)))
    for i in range(5):
        g = _tree(20 + i)
        jg, jerr = jax_comp.compressed_gradients(_jax(g, jnp.bfloat16), jerr)
        tg, terr = compression.compressed_gradients(_port(g, torch.bfloat16), terr)
        _close(tg, jg)
        _close(terr, jerr)


def test_error_feedback_bounds():
    """The JAX test's bounds, on the port."""
    g = {"w": torch.linspace(-1, 1, 128).reshape(8, 16)}
    ghat, err = compression.compressed_gradients(g, compression.init_error_feedback(g))
    step = float(g["w"].abs().max()) / 127.0
    assert float((ghat["w"] - g["w"]).abs().max()) <= step
    total_true = torch.zeros_like(g["w"])
    total_est = torch.zeros_like(g["w"])
    err = compression.init_error_feedback(g)
    for _ in range(50):
        total_true += g["w"]
        ghat, err = compression.compressed_gradients(g, err)
        total_est += ghat["w"]
    assert float((total_est - total_true).abs().max() / total_true.abs().max()) < 0.01

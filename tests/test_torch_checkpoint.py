"""The port's checkpoint manager (`repro_torch.checkpoint.manager`):

* the five tests of `tests/test_checkpoint.py` on the port (roundtrip,
  keep-K, a stale `.tmp` ignored and re-saving idempotent, a shape
  mismatch and a missing leaf refused);
* across the packages: a JAX-written `(params, opt_state)` training
  state (smollm-135m's smoke config, float32) restores into the port's
  template and the port's into JAX's, leaf for leaf equal; the port
  writes the same files as JAX (index and .npy bytes) for the same tree;
* bfloat16: a port tree round-trips bit for bit, a JAX-written bf16
  leaf (numpy's '<V2' record) reads in the port bit for bit, and the
  port's bf16 .npy bytes equal JAX's;
* the index: a JSON index (written where msgpack is missing, by either
  package) reads back in the port where msgpack is installed.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.checkpoint import manager as jax_manager
from repro.training import loop as jax_loop
from repro.training import optimizer as jax_opt
from repro_torch import bridge, configs
from repro_torch.checkpoint import manager
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.training import loop
from repro_torch.training import optimizer as opt


def tree():
    return {"a": torch.arange(12.0).reshape(3, 4),
            "b": {"c": torch.ones((2,), dtype=torch.int32),
                  "d": [torch.zeros(()), torch.full((5,), 7.0)]}}


def _zeros_like(t):
    return bridge.tree_map(torch.zeros_like, t)


def test_roundtrip(tmp_path):
    m = CheckpointManager(str(tmp_path))
    t = tree()
    m.save(3, t, meta={"next_step": 3})
    out, meta = m.restore(_zeros_like(t))
    assert meta["next_step"] == 3
    for a, b in zip(bridge.tree_leaves(t), bridge.tree_leaves(out)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_keep_k_gc(tmp_path):
    m = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        m.save(s, {"x": torch.full((2,), float(s))})
    assert m.steps() == [3, 4]
    out, _ = m.restore({"x": torch.zeros((2,))})
    assert float(out["x"][0]) == 4.0


def test_stale_tmp_ignored_and_atomicity(tmp_path):
    m = CheckpointManager(str(tmp_path))
    m.save(5, {"x": torch.ones((2,))})
    os.makedirs(tmp_path / "step_000000009.tmp")
    assert m.latest_step() == 5
    m.save(5, {"x": torch.ones((2,))})
    assert m.steps() == [5]


def test_shape_mismatch_rejected(tmp_path):
    m = CheckpointManager(str(tmp_path))
    m.save(1, {"x": torch.ones((2,))})
    with pytest.raises(ValueError, match="shape mismatch"):
        m.restore({"x": torch.ones((3,))})


def test_missing_leaf_rejected(tmp_path):
    m = CheckpointManager(str(tmp_path))
    m.save(1, {"x": torch.ones((2,))})
    with pytest.raises(KeyError):
        m.restore({"x": torch.ones((2,)), "y": torch.ones((2,))})


# -- across the packages ----------------------------------------------------

def _states():
    """(the JAX training state, the port's template of the same tree):
    smollm-135m's smoke config, AdamW with error feedback."""
    arch = "smollm-135m"
    ocfg = dict(lr=1e-3, warmup_steps=2, total_steps=10)
    jstate = jax_loop.init_train_state(
        jax_configs.get_smoke_config(arch), jax_opt.OptimizerConfig(**ocfg),
        jax_loop.TrainConfig(grad_compression=True), jax.random.PRNGKey(0))
    tstate = loop.init_train_state(
        configs.get_smoke_config(arch), opt.OptimizerConfig(**ocfg),
        loop.TrainConfig(grad_compression=True, seed=1), device="cpu")
    return jstate, tstate


def _assert_same(port_tree, jax_tree):
    jp = bridge.tree_paths(jax.tree.map(np.asarray, jax_tree))
    tp = bridge.tree_paths(port_tree)
    assert [p for p, _ in jp] == [p for p, _ in tp]
    assert jp[0][0][0] == 0 and jp[-1][0][0] == 1    # the pair's paths: 0/..., 1/...
    for (_, a), (_, b) in zip(jp, tp):
        b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_jax_checkpoint_restores_into_the_port(tmp_path):
    jstate, tstate = _states()
    jax_manager.CheckpointManager(str(tmp_path)).save(4, jstate, meta={"next_step": 4})
    got, meta = CheckpointManager(str(tmp_path)).restore(tstate)
    assert meta == {"next_step": 4}
    assert isinstance(got, tuple) and got[1]["inner"]["step"].dtype == torch.int32
    _assert_same(got, jstate)


def test_port_checkpoint_restores_into_jax(tmp_path):
    jstate, tstate = _states()
    CheckpointManager(str(tmp_path)).save(6, tstate, meta={"next_step": 6})
    got, meta = jax_manager.CheckpointManager(str(tmp_path)).restore(jstate)
    assert meta == {"next_step": 6}
    _assert_same(tstate, got)


def test_port_writes_the_files_jax_writes(tmp_path):
    jstate, _ = _states()
    jstate = (jstate[0], {**jstate[1], "bf16": jnp.linspace(-3, 3, 10, dtype=jnp.bfloat16)})
    tstate = bridge.tree_to_torch(jax.tree.map(np.asarray, jstate))
    assert tstate[1]["bf16"].dtype == torch.bfloat16
    jdir = jax_manager.CheckpointManager(str(tmp_path / "jax")).save(2, jstate)
    tdir = CheckpointManager(str(tmp_path / "port")).save(2, tstate)
    names = sorted(os.listdir(jdir))
    assert names == sorted(os.listdir(tdir))
    for name in names:
        with open(os.path.join(jdir, name), "rb") as f, \
                open(os.path.join(tdir, name), "rb") as g:
            assert f.read() == g.read(), name


# -- bfloat16 -----------------------------------------------------------------

def test_bf16_roundtrip_is_bit_exact(tmp_path):
    rng = np.random.default_rng(0)
    t = {"w": torch.from_numpy(rng.standard_normal((7, 5)).astype(np.float32))
         .to(torch.bfloat16),
         "s": torch.tensor(-0.0, dtype=torch.bfloat16),
         "edge": torch.tensor([float("inf"), float("nan"), 1e-40, -3.0e38],
                              dtype=torch.bfloat16)}
    m = CheckpointManager(str(tmp_path))
    m.save(1, t)
    out, _ = m.restore(_zeros_like(t))
    for k in t:
        assert out[k].dtype == torch.bfloat16
        assert torch.equal(out[k].view(torch.int16), t[k].view(torch.int16))


def test_jax_bf16_leaf_reads_bit_exact(tmp_path):
    w = jnp.asarray(np.random.default_rng(1).standard_normal((4, 6)), jnp.bfloat16)
    jax_manager.CheckpointManager(str(tmp_path)).save(3, {"w": w, "n": jnp.int32(5)})
    out, _ = CheckpointManager(str(tmp_path)).restore(
        {"w": torch.zeros((4, 6), dtype=torch.bfloat16), "n": torch.zeros((), dtype=torch.int32)})
    assert out["w"].dtype == torch.bfloat16
    want = np.asarray(w).view(np.uint16).astype(np.int64)
    got = out["w"].view(torch.int16).numpy().view(np.uint16).astype(np.int64)
    np.testing.assert_array_equal(got, want)
    assert int(out["n"]) == 5


# -- the index ------------------------------------------------------------------

@pytest.mark.parametrize("writer", ("port", "jax"))
def test_json_index_reads_back(tmp_path, monkeypatch, writer):
    mod = manager if writer == "port" else jax_manager
    monkeypatch.setattr(mod, "_HAVE_MSGPACK", False)
    t = tree()
    if writer == "port":
        CheckpointManager(str(tmp_path)).save(2, t, meta={"next_step": 2})
    else:
        jax_manager.CheckpointManager(str(tmp_path)).save(
            2, jax.tree.map(lambda x: jnp.asarray(x.numpy()), t), meta={"next_step": 2})
    monkeypatch.undo()
    assert manager._HAVE_MSGPACK
    with open(tmp_path / "step_000000002" / "index.msgpack", "rb") as f:
        assert f.read(1) == b"{"
    out, meta = CheckpointManager(str(tmp_path)).restore(_zeros_like(t))
    assert meta == {"next_step": 2}
    for a, b in zip(bridge.tree_leaves(t), bridge.tree_leaves(out)):
        assert torch.equal(a, b)

"""The grouped and shard_map MoE dispatch of the port against the JAX
package's, on the CPU, float32.

* `moe_groups`: the port's `moe_block` (which takes
  `moe_block_grouped` when the groups divide the tokens) against JAX
  `moe_block_grouped` on one device, with and without a shared expert,
  at capacity factors that drop choices; groups that do not divide the
  tokens fall back to the plain dispatch, as in JAX; and the grouped
  dispatch on gloo meshes (1, 2) and (2, 2) with the experts sharded (EP)
  against JAX's unsharded result.
* `moe_shard_map`: JAX `moe_block_shard_map` computed in one JAX
  subprocess with `--xla_force_host_platform_device_count=4` (meshes (1,
  2) and (2, 2), its own time limit), against the port's on gloo ranks
  of the same meshes: the token split over every rank, the local
  capacity max(1, ceil(nl k / E cf)), one all_to_all each way, the
  fallback to `moe_block` when the tokens do not split (7 tokens), and
  the collectives each rank called.
Tolerance 1e-5 (absolute and relative) throughout.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import _torch_mesh
from repro.models import transformer as jax_tf
from repro.models.config import ModelConfig as JaxConfig
from repro_torch import bridge
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig

TOL = 1e-5
ROOT = Path(__file__).resolve().parents[1]
MOE = dict(n_layers=1, d_model=64, n_heads=4, kv_heads=2, d_ff=32, vocab=64,
           n_experts=4, top_k=2, dtype="float32", param_dtype="float32")
# name -> (config switches, x shape); the shard_map cases run on every mesh
SM_CASES = {
    "e4": (dict(), (2, 8)),
    "e8_shared": (dict(n_experts=8, n_shared_experts=1), (2, 8)),
    "drops": (dict(capacity_factor=0.5), (4, 8)),
    "fallback": (dict(), (1, 7)),
}
MESHES = [(2, 2), (4, 2)]           # (world, model axis): (1, 2) and (2, 2)
JAX_PROG = """
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, numpy as np
from jax.sharding import Mesh
from repro.models import transformer as T
from repro.models.config import ModelConfig
job = json.loads(sys.argv[1])
data = np.load(job["inputs"], allow_pickle=True).item()
out = {}
for name, (kw, mshape) in job["cases"].items():
    cfg = ModelConfig(**kw)
    p, x = data[name]
    devs = np.array(jax.devices()[:mshape[0] * mshape[1]]).reshape(mshape)
    with jax.set_mesh(Mesh(devs, ("data", "model"))):
        y = jax.jit(lambda p, x, cfg=cfg: T.moe_block(cfg, p, x))(p, x)
    out[name] = np.asarray(y)
np.save(job["outputs"], out, allow_pickle=True)
"""


def _layer(kw, seed=0):
    jcfg = JaxConfig(**dict(MOE, **kw))
    p = jax.tree.map(np.asarray, jax_tf._init_moe(jcfg, jax.random.PRNGKey(seed)))
    return jcfg, ModelConfig(**dict(MOE, **kw)), p


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal((*shape, MOE["d_model"])) \
        .astype(np.float32)


@pytest.mark.parametrize("kw,shape", [
    (dict(moe_groups=2), (2, 8)), (dict(moe_groups=4), (2, 8)),
    (dict(moe_groups=2, n_shared_experts=1, capacity_factor=0.5), (4, 8)),
    (dict(moe_groups=4, top_k=1, capacity_factor=2.0), (1, 32))],
    ids=["g2", "g4", "g2-shared-drops", "g4-top1"])
def test_grouped_matches_jax(kw, shape):
    jcfg, tcfg, p = _layer(kw)
    x = _x(shape)
    want = np.asarray(jax_tf.moe_block_grouped(jcfg, p, x))
    got = transformer.moe_block(tcfg, bridge.tree_to_torch(p), torch.as_tensor(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_groups_that_do_not_divide_fall_back():
    jcfg, tcfg, p = _layer(dict(moe_groups=3))
    x = _x((2, 8))                                  # 16 tokens, 3 groups
    want = np.asarray(jax_tf.moe_block(jcfg, p, x))
    got = transformer.moe_block(tcfg, bridge.tree_to_torch(p), torch.as_tensor(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    with pytest.raises(ValueError):
        transformer.moe_block_grouped(tcfg, bridge.tree_to_torch(p), torch.as_tensor(x))


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """The JAX shard_map results (one subprocess) and the port's on each
    gloo mesh (one spawn each), with the grouped EP jobs beside them."""
    tmp = tmp_path_factory.mktemp("moe_dispatch")
    inputs, jobs, want = {}, [], {}
    for name, (kw, shape) in SM_CASES.items():
        _, tcfg, p = _layer(dict(kw, moe_shard_map=True))
        x = _x(shape)
        inputs[name] = (p, x)
        jobs.append((f"sm_{name}", "moe", dict(cfg=tcfg, params=bridge.tree_to_torch(p),
                                              x=torch.as_tensor(x))))
    for name, kw in (("g2", dict(moe_groups=2)),
                     ("g2_shared", dict(moe_groups=2, n_shared_experts=1))):
        jcfg, tcfg, p = _layer(kw)
        x = _x((2, 8))
        want[f"grouped_{name}"] = np.asarray(jax_tf.moe_block_grouped(jcfg, p, x))
        jobs.append((f"grouped_{name}", "moe", dict(cfg=tcfg, params=bridge.tree_to_torch(p),
                                                    x=torch.as_tensor(x))))
    np.save(tmp / "inputs.npy", inputs, allow_pickle=True)
    for world, model in MESHES:
        mshape = (world // model, model)
        job = {"inputs": str(tmp / "inputs.npy"), "outputs": str(tmp / f"jax-{world}.npy"),
               "cases": {n: (dict(MOE, **kw, moe_shard_map=True), mshape)
                         for n, (kw, _) in SM_CASES.items()}}
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
        subprocess.run([sys.executable, "-c", JAX_PROG, json.dumps(job)], check=True,
                       env=env, timeout=180, cwd=ROOT)
        want[(world, model)] = np.load(tmp / f"jax-{world}.npy", allow_pickle=True).item()
    return want, _torch_mesh.run(tmp, MESHES, jobs)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"world{m[0]}-model{m[1]}")
@pytest.mark.parametrize("name", list(SM_CASES))
def test_shard_map_matches_jax(mesh_runs, name, mesh):
    want, got = mesh_runs
    out = got[mesh][f"sm_{name}"]
    np.testing.assert_allclose(out["y"].numpy(), want[mesh][name], rtol=TOL, atol=TOL)
    counts = out["counts"]
    kw, shape = SM_CASES[name]
    if name == "fallback":
        # moe_block with EP over "model": one all_reduce, no all_to_all
        assert counts["all_to_all"] == 0 and counts["all_reduce"] == 1
    else:
        # one all_to_all each way, the tokens gathered back, the shared
        # expert's row-parallel sum
        assert counts == {"all_to_all": 2, "all_gather": 1,
                          "all_reduce": int(bool(kw.get("n_shared_experts"))),
                          "broadcast": 0}


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"world{m[0]}-model{m[1]}")
@pytest.mark.parametrize("name", ["g2", "g2_shared"])
def test_grouped_under_ep_matches_jax(mesh_runs, name, mesh):
    want, got = mesh_runs
    out = got[mesh][f"grouped_{name}"]
    np.testing.assert_allclose(out["y"].numpy(), want[f"grouped_{name}"],
                               rtol=TOL, atol=TOL)
    assert out["counts"]["all_reduce"] == 1 + (name == "g2_shared")

"""The shard_map MoE dispatch on a mesh with a "pod" axis, the port's
against the JAX package's, on the CPU, float32.

JAX's `moe_block_shard_map` splits the tokens over every mesh axis,
("pod", "data", "model"): each rank routes n / n_tot tokens into local
capacity buffers of cap_l = max(1, ceil((n / n_tot) k / E cf)) slots,
the all_to_all runs over ("data", "model") inside each pod and the
experts are replicated over "pod".  It falls back to `moe_block` where
E % n_ep or n % n_tot.  JAX runs in one subprocess on a host-CPU mesh
of the same axes (`--xla_force_host_platform_device_count=4`); the
port's runs on 4 gloo ranks of a (2, 1, 2) ("pod", "data", "model")
mesh, the rows whole (serving) and split over ("pod", "data")
(training).  Cases: 4 and 8 experts (one shared), a capacity factor of
0.5 whose buffers overflow (choices are dropped), and 6 tokens, which
do not split over the 4 ranks (the fallback).  Tolerance 1e-5
(absolute and relative), as `test_torch_moe_dispatch.py`'s.

The overflow case is the record of a fault: the port once sized the
buffers for n / (data x model) tokens, twice JAX's on this mesh, so
where tokens overflowed it kept choices JAX drops.
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
POD = (2, 1, 2)                     # ("pod", "data", "model")
MOE = dict(n_layers=1, d_model=64, n_heads=4, kv_heads=2, d_ff=32, vocab=64,
           n_experts=4, top_k=2, dtype="float32", param_dtype="float32",
           moe_shard_map=True)
# name -> (config switches, x shape, rows split over ("pod", "data"))
CASES = {
    "e4": (dict(), (2, 8), False),
    "e8_shared": (dict(n_experts=8, n_shared_experts=1), (2, 8), False),
    "overflow": (dict(capacity_factor=0.5), (4, 8), False),
    "overflow_rows": (dict(capacity_factor=0.5), (4, 8), True),
    "e8_rows": (dict(n_experts=8), (2, 16), True),
    "fallback": (dict(), (1, 6), False),
}
JAX_PROG = """
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, numpy as np
from jax.sharding import Mesh
from repro.models import transformer as T
from repro.models.config import ModelConfig
job = json.loads(sys.argv[1])
data = np.load(job["inputs"], allow_pickle=True).item()
devs = np.array(jax.devices()[:4]).reshape(job["mesh"])
out = {}
for name, kw in job["cases"].items():
    cfg = ModelConfig(**kw)
    p, x = data[name]
    with jax.set_mesh(Mesh(devs, ("pod", "data", "model"))):
        y = jax.jit(lambda p, x, cfg=cfg: T.moe_block(cfg, p, x))(p, x)
    out[name] = np.asarray(y)
np.save(job["outputs"], out, allow_pickle=True)
"""


def _layer(kw, seed=0):
    jcfg = JaxConfig(**dict(MOE, **kw))
    p = jax.tree.map(np.asarray, jax_tf._init_moe(jcfg, jax.random.PRNGKey(seed)))
    return ModelConfig(**dict(MOE, **kw)), p


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal((*shape, MOE["d_model"])) \
        .astype(np.float32)


@pytest.fixture(scope="module")
def pod_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe_pod")
    inputs, jobs = {}, []
    for name, (kw, shape, rows) in CASES.items():
        tcfg, p = _layer(kw)
        x = _x(shape)
        inputs[name] = (p, x)
        jobs.append((name, "moe", dict(cfg=tcfg, params=bridge.tree_to_torch(p),
                                       x=torch.as_tensor(x), data_split=rows)))
    np.save(tmp / "inputs.npy", inputs, allow_pickle=True)
    job = {"inputs": str(tmp / "inputs.npy"), "outputs": str(tmp / "jax.npy"),
           "mesh": list(POD), "cases": {n: dict(MOE, **kw) for n, (kw, _, _) in CASES.items()}}
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")

    def jax_side():
        subprocess.run([sys.executable, "-c", JAX_PROG, json.dumps(job)], check=True,
                       env=env, timeout=180, cwd=ROOT)
        return np.load(tmp / "jax.npy", allow_pickle=True).item()

    return _torch_mesh.run(tmp, [POD], jobs, meanwhile=jax_side)


@pytest.mark.parametrize("name", list(CASES))
def test_shard_map_on_a_pod_mesh_matches_jax(pod_runs, name):
    want, got = pod_runs
    out = got[POD][name]
    np.testing.assert_allclose(out["y"].numpy(), want[name], rtol=TOL, atol=TOL)
    counts = out["counts"]
    kw, _, _ = CASES[name]
    if name == "fallback":
        assert counts["all_to_all"] == 0
    else:
        # one all_to_all each way inside the pod, the tokens gathered back
        # over the axes they split over, the shared expert's row sum
        assert counts["all_to_all"] == 2 and counts["all_gather"] == 1
        assert counts["all_reduce"] == int(bool(kw.get("n_shared_experts")))


def test_overflow_case_drops_choices():
    """The overflow case's local buffers are too small for every choice
    (so its agreement above covers dropped choices): with cap_l =
    ceil((n / n_tot) k / E cf) some expert gets more choices in a rank's
    tokens than it has slots."""
    kw, shape, _ = CASES["overflow"]
    tcfg, p = _layer(kw)
    x = torch.as_tensor(_x(shape)).reshape(-1, MOE["d_model"])
    n_tot = int(np.prod(POD))
    nl = x.shape[0] // n_tot
    cap_l = max(1, int(np.ceil(nl * tcfg.top_k / tcfg.n_experts * tcfg.capacity_factor)))
    _, idx = transformer.route(tcfg, bridge.tree_to_torch(p), x)
    per_rank = idx.reshape(n_tot, nl * tcfg.top_k)
    most = max(int(torch.bincount(r, minlength=tcfg.n_experts).max()) for r in per_rank)
    assert most > cap_l

"""Serving on a mesh: the port's tensor- and expert-parallel transformer
against the JAX package's unsharded one, on the CPU.

Gloo ranks spawned on the CPU (`_torch_mesh.run`, a `FileStore` under
`tmp_path`) build meshes (1, 2) and (2, 2) ("data", "model") and run,
in one spawn a mesh, every check below on the same float32 weights the
JAX `init_params` drew (the QKV biases made non-zero, so their shards
count):

* tiny GQA (tied embeddings), MoE with EP (4 experts over 2 ranks, a
  sliding window of 16), MoE with TP on f (3 experts, a shared expert,
  one leading dense layer), MLA and M-RoPE (QKV biases) configs:
  `forward`, the prefill's last logits and two greedy `decode_step`s
  within 2e-4 of JAX's unsharded run, and the collectives each rank
  called (the GQA forward: one all_reduce for the embedding and one for
  each attention and MLP, one all_gather for the logits);
* the port's `ServingEngine(mesh=...)` with decode_batch 2 of 3 slots:
  greedy tokens and finish reasons equal to the JAX engine's, paged,
  dense, int8 (paged pool and dense rectangles) where the config takes
  them (one full-width run, compact off);
* `replica_meshes` on the ranks: one replica a data rank, each with its
  own subgroups.
"""
import json

import jax
import numpy as np
import pytest
import torch

import _torch_mesh
from repro.models import api as jax_api
from repro.models.config import ModelConfig as JaxConfig
from repro.serving.engine import Request as JaxRequest
from repro.serving.engine import ServingEngine as JaxEngine
from repro_torch import bridge
from repro_torch.models.config import ModelConfig

TOL = 2e-4
BASE = dict(n_layers=2, d_model=64, n_heads=4, kv_heads=2, head_dim=16, d_ff=128,
            vocab=128, dtype="float32", param_dtype="float32", scan_layers=False)
CONFIGS = {
    "gqa": dict(BASE, tie_embeddings=True),
    "moe_ep": dict(BASE, n_experts=4, top_k=2, d_ff=64, window=16),
    "moe_f": dict(BASE, n_experts=3, top_k=2, moe_d_ff=64, n_shared_experts=1,
                  first_dense_layers=1),
    "mla": dict(BASE, kv_heads=4, mla_q_rank=32, mla_kv_rank=16, mla_rope_dim=8),
    "mrope": dict(BASE, mrope_sections=(2, 3, 3), qkv_bias=True),
}
# (config, engine switches): every KV mode each config serves
ENGINES = [("gqa", dict(paged=True)), ("gqa", dict(paged=False)),
           ("gqa", dict(paged=True, kv_quant=True)),
           ("gqa", dict(paged=False, kv_quant="dense")),
           ("gqa", dict(paged=False, compact=False)),
           ("moe_ep", dict(paged=False)), ("moe_f", dict(paged=False)),
           ("moe_f", dict(paged=False, kv_quant="dense")),
           ("mla", dict(paged=True)), ("mrope", dict(paged=True))]
ENGINE_KW = dict(max_batch=3, decode_batch=2, max_len=32)
MAX_NEW = 6
MESHES = [(2, 2), (4, 2)]           # (world, model axis): (1, 2) and (2, 2)
_INIT = jax.jit(jax_api.init_params, static_argnums=0)
_FORWARD = jax.jit(jax_api.forward, static_argnums=0)
_PREFILL = jax.jit(jax_api.prefill, static_argnums=(0, 3))
_DECODE = jax.jit(jax_api.decode_step, static_argnums=0)


def _weights(name):
    jcfg = JaxConfig(**CONFIGS[name])
    w = jax.tree.map(np.asarray, _INIT(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)

    def bias(path, a):
        key = getattr(path[-1], "key", None)
        return (rng.standard_normal(a.shape) * 0.1).astype(a.dtype) \
            if key in ("bq", "bk", "bv") else a
    return jcfg, jax.tree_util.tree_map_with_path(bias, w)


def _prompts():
    rng = np.random.default_rng(2)
    return [rng.integers(0, 128, size=int(n)).astype(np.int32) for n in (3, 14, 7, 20, 9)]


def _jax_forward(jcfg, w, toks, max_len):
    jt = jax.numpy.asarray(toks, dtype=jax.numpy.int32)
    fwd = np.asarray(_FORWARD(jcfg, w, {"tokens": jt}))
    last, cache = _PREFILL(jcfg, w, {"tokens": jt}, max_len)
    steps, tok = [], jax.numpy.argmax(last[:, -1], -1)[:, None].astype(jax.numpy.int32)
    for _ in range(2):
        lg, cache = _DECODE(jcfg, w, tok, cache)
        steps.append(np.asarray(lg))
        tok = jax.numpy.argmax(lg[:, -1], -1)[:, None].astype(jax.numpy.int32)
    return {"forward": fwd, "prefill": np.asarray(last), "decode": np.stack(steps)}


def _jax_engine(jcfg, w, **kw):
    eng = JaxEngine(jcfg, w, **ENGINE_KW, **kw)
    reqs = [JaxRequest(rid=i, prompt=p, max_new_tokens=MAX_NEW)
            for i, p in enumerate(_prompts())]
    for r in reqs:
        eng.submit(r)
    eng.run()
    return [r.out_tokens for r in reqs], [r.finish_reason for r in reqs]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's unsharded results and the port's on each mesh, by mesh."""
    toks = np.random.default_rng(3).integers(0, 128, size=(2, 12))
    jobs, want = [], {}
    weights = {name: _weights(name) for name in CONFIGS}
    for name, (jcfg, w) in weights.items():
        tcfg = ModelConfig(**CONFIGS[name])
        tw = bridge.tree_to_torch(w)
        want[name] = _jax_forward(jcfg, w, toks, 32)
        jobs.append((name, "forward", dict(cfg=tcfg, params=tw,
                                           tokens=torch.as_tensor(toks), max_len=32)))
    for i, (name, kw) in enumerate(ENGINES):
        jcfg, w = weights[name]
        want[f"engine{i}"] = _jax_engine(jcfg, w, **kw)
        jobs.append((f"engine{i}", "engine", dict(
            cfg=ModelConfig(**CONFIGS[name]), params=bridge.tree_to_torch(w),
            prompts=_prompts(), max_new=MAX_NEW, **ENGINE_KW, **kw)))
    jobs.append(("replicas", "replicas", {}))
    tmp = tmp_path_factory.mktemp("tp")
    return want, _torch_mesh.run(tmp, MESHES, jobs)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"world{m[0]}-model{m[1]}")
@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_and_decode_match_jax_unsharded(runs, name, mesh):
    want, got = runs
    out = got[mesh][name]
    for key in ("forward", "prefill", "decode"):
        np.testing.assert_allclose(out[key].numpy(), want[name][key],
                                   rtol=TOL, atol=TOL, err_msg=f"{name} {key}")


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"world{m[0]}-model{m[1]}")
def test_gqa_collectives_per_layer(runs, mesh):
    """Per model call: an all_reduce for the vocab-parallel embedding, one
    for each layer's attention and one for its MLP, an all_gather of the
    logits' vocab shards; four calls (forward, prefill, two decodes)."""
    _, got = runs
    n_layers = CONFIGS["gqa"]["n_layers"]
    counts = got[mesh]["gqa"]["counts"]
    assert counts == {"all_reduce": 4 * (1 + 2 * n_layers), "all_gather": 4,
                      "all_to_all": 0, "broadcast": 0}


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"world{m[0]}-model{m[1]}")
@pytest.mark.parametrize("case", range(len(ENGINES)),
                         ids=lambda i: f"{ENGINES[i][0]}-" + "-".join(
                             f"{k}={v}" for k, v in ENGINES[i][1].items()))
def test_engine_tokens_match_jax_unsharded(runs, case, mesh):
    want, got = runs
    out = got[mesh][f"engine{case}"]
    tokens, reasons = want[f"engine{case}"]
    assert out["tokens"] == tokens
    assert out["reasons"] == reasons
    # every sampled token was rank 0's, broadcast: one a prefill, one a step
    assert out["counts"]["broadcast"] == out["prefills"] + out["decode_steps"]


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"world{m[0]}-model{m[1]}")
def test_replica_meshes_on_ranks(runs, mesh):
    """One replica a data rank: rank 0's replica is ranks 0 .. model - 1
    (root 0), its model group sums their ranks and its root broadcasts."""
    _, got = runs
    out = got[mesh]["replicas"]
    world, model = mesh
    assert out["n"] == world // model
    assert out["shapes"] == [{"data": 1, "model": model}] * out["n"]
    assert (out["rank"], out["root"], out["bcast"]) == (0, 0, 0)
    assert out["sum"] == sum(range(model))


def _tp_policy(tmp_path, tp):
    from repro.core.policy import ExecutionPolicy as JaxPolicy
    from repro.core.policy import OperatorPolicy as JaxOperatorPolicy
    ops = [JaxOperatorPolicy(group=g, batch=4, tp=tp, memory="HBM3",
                             chiplet="WS-pe64-glb512K-2D", fused=True)
           for g in ("norm1+qkv_proj+attention", "norm2+mlp")]
    d = JaxPolicy(network="n", interval_s=1e-3, operators=ops).to_dict()
    path = tmp_path / "policy.json"
    path.write_text(json.dumps(d))
    return JaxPolicy.from_dict(d), path


@pytest.mark.parametrize("n_devices", [1, 2, 3, 4])
def test_apply_policy_mesh_tp_matches_jax(tmp_path, n_devices):
    """tp 2 takes a mesh where the cards divide by 2, with JAX's log lines."""
    from repro import configs as jax_configs
    from repro.launch.serve import apply_policy as jax_apply_policy
    from repro_torch import configs
    from repro_torch.launch.policy import load_policy
    from repro_torch.launch.serve import apply_policy

    jpol, path = _tp_policy(tmp_path, 2)
    _, jkw, jlines = jax_apply_policy(jpol, jax_configs.get_config("smollm-135m"), 8,
                                      n_devices=n_devices)
    _, tkw, tlines = apply_policy(load_policy(path), configs.get_config("smollm-135m"),
                                  8, n_devices=n_devices)
    assert tkw == jkw and tkw["mesh_tp"] == (2 if n_devices in (2, 4) else 1)
    assert tlines[-1] == jlines[-1]


def test_serve_main_refuses_replicas_on_a_mesh(tmp_path, monkeypatch):
    """2 cards at tp 2 make a (1, 2) mesh: its data axis of 1 does not
    divide into 2 replicas, and `main` refuses with JAX's
    `replica_meshes` error before it starts any rank."""
    import torch.multiprocessing as mp

    from repro.parallel import sharding as jax_sharding
    from repro_torch.launch import serve as tserve

    _, path = _tp_policy(tmp_path, 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(mp, "spawn", lambda *a, **k: pytest.fail("a rank was started"))
    with pytest.raises(ValueError) as want:
        jax_sharding.replica_meshes(jax.make_mesh((1, 1), ("data", "model")), 2)
    with pytest.raises(ValueError) as got:
        tserve.main(["--arch", "smollm-135m", "--smoke", "--policy", str(path),
                     "--replicas", "2"])
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("replicas,shapes", [(1, [{"data": 2, "model": 2}]),
                                             (2, [{"data": 1, "model": 2}] * 2)])
def test_serve_main_spawns_a_rank_a_card(tmp_path, monkeypatch, replicas, shapes):
    """4 cards at tp 2: one NCCL rank a card, on JAX's (cards / tp, tp) =
    (2, 2) mesh; one engine serves it whole (its dense batch over
    "data"), 2 replicas split its data axis into two (1, 2) meshes."""
    import torch.multiprocessing as mp

    from repro_torch.launch import serve as tserve
    from repro_torch.parallel import sharding
    from repro_torch.parallel.mesh import MeshShape

    _, path = _tp_policy(tmp_path, 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    seen = {}
    monkeypatch.setattr(mp, "spawn", lambda fn, args, nprocs, join: seen.update(
        fn=fn, args=args, nprocs=nprocs))
    tserve.main(["--arch", "smollm-135m", "--smoke", "--policy", str(path),
                 "--replicas", str(replicas)])
    world, tp = seen["args"][:2]
    assert seen["fn"] is tserve._serve_rank and seen["nprocs"] == world == 4 and tp == 2
    # the mesh each rank builds: make_host_mesh(model_axis=tp) over the world
    mesh = MeshShape(("data", "model"), {"data": world // tp, "model": tp})
    assert [dict(m.shape) for m in sharding.replica_meshes(mesh, replicas)] == shapes

"""FSDP execution of the port's transformer: the weights and the optimizer
state held as FSDP's blocks (`hold="fsdp"`: a dim over ("data", "model"),
JAX's `param_spec(fsdp=True)`), each layer gathering its leaves to their
TP blocks while it runs, on the CPU, float32.

Gloo ranks spawned on the CPU (`_torch_mesh.run`, one spawn for the
module) build a (2, 2) ("data", "model") mesh and a (3, 2) one, and run
every job while the JAX reference is computed:

* smoke configs of 2 layers (smollm-135m with its heads split whole
  under Adafactor and with 3 / 1 heads kept whole, mixtral-8x7b's MoE
  with EP, qwen2.5-32b's QKV biases): 2 training steps from JAX's weights with
  a clip norm of 0.05 (below every step's gradient norm, so the clip
  binds), held as FSDP's blocks and as the TP blocks.  The losses and
  the gathered parameters equal the TP run's and JAX's single-device
  step's on the same weights (3 / 4 cases; the whole-heads case against
  the TP run alone): losses within rtol 1e-4, parameters within atol
  1e-5 save for at most 8 elements within 4 lr (`test_torch_train_loop.py`'s
  tolerance, which `test_torch_train_mesh.py` takes).  Every
  parameter and optimizer leaf of a rank has its held block's shape,
  and the optimizer state's specs equal JAX's `optimizer_shardings(fsdp=
  True)` (Adafactor's `vr` and `vc` included).
* `ServingEngine(mesh=, hold="fsdp")` (max_batch 3): greedy tokens of
  prefill and decode equal the JAX engine's (smollm paged, mixtral
  dense).
* an FSDP checkpoint saved on (2, 2) restores bit-equal onto (4, 1)
  without FSDP.
* `gather_held` on leaves of known values, on (2, 2) and on the odd
  (3, 2) mesh (an FSDP block d M + m lies in TP block (d M + m) // D):
  forward to the TP block and the gradient back to the held block,
  exact, on every rank.
* rwkv6, recurrentgemma and whisper refuse `hold="fsdp"`.
"""
import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

import _torch_mesh
from repro import configs as jax_configs
from repro.models import api as jax_api
from repro.parallel import sharding as jax_sharding
from repro.serving.engine import Request as JaxRequest
from repro.serving.engine import ServingEngine as JaxEngine
from repro.training import optimizer as jax_opt
from repro_torch import bridge, configs
from repro_torch.models import api
from repro_torch.parallel import sharding
from repro_torch.training.optimizer import OptimizerConfig

TRAIN_RTOL, PARAM_ATOL = 1e-4, 1e-5          # as test_torch_train_mesh
F32 = dict(n_layers=2, dtype="float32", param_dtype="float32")
# name -> (arch, config switches, optimizer)
CASES = {"smollm_adafactor": ("smollm-135m", {}, "adafactor"),
         "smollm_whole_heads": ("smollm-135m", dict(n_heads=3, kv_heads=1), "adamw"),
         "mixtral": ("mixtral-8x7b", {}, "adamw"),
         "qwen": ("qwen2.5-32b", {}, "adamw")}
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=4, clip_norm=0.05)
STEPS = 2
ENGINES = [("smollm_adafactor", dict(paged=True)), ("mixtral", dict(paged=False))]
NO_JAX = ("smollm_whole_heads",)               # held against the TP run alone
ENGINE_KW = dict(max_batch=3, decode_batch=2, max_len=32)
MAX_NEW = 6
MESH, ODD = (4, 2), (6, 2)                     # (world, model): (2, 2) and (3, 2)


_VALUE_AND_GRAD = jax.jit(
    lambda cfg, p, b: jax.value_and_grad(lambda q: jax_api.loss_fn(cfg, q, b))(p),
    static_argnums=0)


def _configs(name):
    arch, kw, _ = CASES[name]
    return (jax_configs.get_smoke_config(arch).replace(**F32, **kw),
            configs.get_smoke_config(arch).replace(**F32, **kw))


def _weights(jcfg):
    return jax.tree.map(np.asarray, jax_api.init_params(jcfg, jax.random.PRNGKey(0)))


def _batch(vocab):
    rng = np.random.default_rng(4)
    return {k: rng.integers(0, vocab, (8, 16)).astype(np.int32) for k in ("tokens", "labels")}


def _prompts(vocab):
    rng = np.random.default_rng(2)
    return [rng.integers(0, vocab, size=int(n)).astype(np.int32) for n in (3, 14, 7, 20, 9)]


def _jax_train(jcfg, w, batch, opt_name):
    ocfg = jax_opt.OptimizerConfig(name=opt_name, **OPT)
    params = jax.tree.map(jnp.asarray, w)
    opt = jax_opt.init_opt(ocfg, params)
    b = jax.tree.map(jnp.asarray, batch)
    losses = []
    for _ in range(STEPS):
        loss, grads = _VALUE_AND_GRAD(jcfg, params, b)
        params, opt, _ = jax_opt.apply_opt(ocfg, grads, opt, params)
        losses.append(float(loss))
    ospec = jax.eval_shape(lambda: jax_opt.init_opt(ocfg, params))
    oshard = jax_sharding.optimizer_shardings(AbstractMesh((2, 2), ("data", "model")),
                                              params, {"inner": ospec}, fsdp=True)
    specs = {}
    for path, s in jax.tree_util.tree_flatten_with_path(oshard)[0]:
        keys = [getattr(p, "key", getattr(p, "idx", None)) for p in path]
        specs["/".join(map(str, keys))] = tuple(s.spec)
    flat = {"/".join(map(str, [getattr(p, "key", getattr(p, "idx", None)) for p in path])):
            np.asarray(x) for path, x in jax.tree_util.tree_flatten_with_path(params)[0]}
    return {"losses": losses, "params": flat, "opt_specs": specs}


def _jax_engine(jcfg, w, vocab, **kw):
    eng = JaxEngine(jcfg, w, **ENGINE_KW, **kw)
    reqs = [JaxRequest(rid=i, prompt=p, max_new_tokens=MAX_NEW)
            for i, p in enumerate(_prompts(vocab))]
    for r in reqs:
        eng.submit(r)
    eng.run()
    return [r.out_tokens for r in reqs]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jobs, refs = [], []
    weights = {}
    for name, (_, _, opt_name) in CASES.items():
        jcfg, tcfg = _configs(name)
        weights[name] = _weights(jcfg)
        batch = _batch(tcfg.vocab)
        jobs.append((f"train_{name}", "fsdp_train", dict(
            cfg=tcfg, params=bridge.tree_to_torch(weights[name]),
            batch={k: torch.from_numpy(v) for k, v in batch.items()},
            ocfg=OptimizerConfig(name=opt_name, **OPT), steps=STEPS), [MESH]))
        if name not in NO_JAX:
            refs.append((f"train_{name}", lambda j=jcfg, w=weights[name], b=batch,
                         o=opt_name: _jax_train(j, w, b, o)))
    for i, (name, kw) in enumerate(ENGINES):
        jcfg, tcfg = _configs(name)
        jobs.append((f"engine{i}", "engine", dict(
            cfg=tcfg, params=bridge.tree_to_torch(weights[name]), prompts=_prompts(tcfg.vocab),
            max_new=MAX_NEW, hold="fsdp", **ENGINE_KW, **kw), [MESH]))
        refs.append((f"engine{i}", lambda j=jcfg, w=weights[name], v=tcfg.vocab, k=kw:
                     _jax_engine(j, w, v, **k)))
    tmp = tmp_path_factory.mktemp("fsdp")
    _, tcfg = _configs("smollm_adafactor")
    from repro_torch.training.loop import TrainConfig
    jobs.append(("ckpt", "fsdp_ckpt", dict(cfg=tcfg, ocfg=OptimizerConfig(**OPT),
                                           tcfg=TrainConfig(steps=2),
                                           save_dir=str(tmp / "ckpt")), [MESH]))
    jobs.append(("layout", "fsdp_layout", {}))

    def meanwhile():            # JAX's references compile in threads of their own
        with concurrent.futures.ThreadPoolExecutor(len(refs)) as pool:
            futs = {k: pool.submit(fn) for k, fn in refs}
            return {k: f.result() for k, f in futs.items()}

    return _torch_mesh.run(tmp, [MESH, ODD], jobs, meanwhile=meanwhile)


def _close(got, want, lr, err_msg):
    """`test_torch_train_loop`'s tolerance: within 1e-5, save for at most 8
    elements within 2 x 2 lr (an Adam step near a zero gradient is
    sign-like, and a sign can flip between two sums)."""
    gap = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    over = gap > PARAM_ATOL
    assert over.sum() <= 8 and (gap.max(initial=0.0) <= 4 * lr), \
        f"{err_msg}: {int(over.sum())} elements past {PARAM_ATOL}, max {gap.max():.3g}"


@pytest.mark.parametrize("name", list(CASES))
def test_fsdp_training_equals_tp_and_jax(runs, name):
    want, got = runs
    out = got[MESH][f"train_{name}"]
    ref = want.get(f"train_{name}")
    fsdp, tp = out["fsdp"], out["tp"]
    assert min(fsdp["grad_norms"]) > OPT["clip_norm"]          # the clip binds
    np.testing.assert_allclose(fsdp["losses"], tp["losses"], rtol=TRAIN_RTOL)
    for path, t in fsdp["params"].items():
        _close(t.numpy(), tp["params"][path].numpy(), OPT["lr"], f"{name} {path} vs tp")
    if name in NO_JAX:
        return
    np.testing.assert_allclose(fsdp["losses"], ref["losses"], rtol=TRAIN_RTOL)
    for path, t in fsdp["params"].items():
        _close(t.numpy(), ref["params"][path], OPT["lr"], f"{name} {path} vs JAX")
    assert fsdp["holds_per_step"] > 0 and tp["holds_per_step"] == 0


@pytest.mark.parametrize("name", list(CASES))
def test_fsdp_state_holds_fsdp_blocks(runs, name):
    want, got = runs
    fsdp = got[MESH][f"train_{name}"]["fsdp"]
    assert fsdp["param_shapes_ok"] and fsdp["opt_shapes_ok"]
    assert any(("data", "model") in s for s in fsdp["param_specs"].values())
    if name in NO_JAX:
        return
    jax_specs = want[f"train_{name}"]["opt_specs"]
    for path, spec in fsdp["opt_specs"].items():
        jspec = tuple(jax_specs[path])
        assert spec == jspec + (None,) * (len(spec) - len(jspec)), path
    # the moments' blocks are the parameters' (a data rank holds half)
    for path, shape in fsdp["opt_local"].items():
        if path.startswith("inner/mu/"):
            spec = fsdp["param_specs"][path[len("inner/mu/"):]]
            if any(isinstance(a, tuple) and "data" in a for a in spec):
                whole = fsdp["params"][path[len("inner/mu/"):]].shape
                assert shape != tuple(whole)


@pytest.mark.parametrize("i", range(len(ENGINES)))
def test_fsdp_engine_tokens_equal_jax(runs, i):
    want, got = runs
    assert got[MESH][f"engine{i}"]["tokens"] == want[f"engine{i}"]


def test_fsdp_checkpoint_restores_without_fsdp(runs):
    _, got = runs
    out = got[MESH]["ckpt"]
    assert out["flat_shape"] == {"data": 4, "model": 1} and out["meta"] == {"next_step": 7}
    assert out["fsdp_specs"]                     # the saved layout was FSDP's
    saved = dict(out["saved"])
    for path, t in out["restored"]:
        assert torch.equal(t, saved[path]), path


@pytest.mark.parametrize("mesh", [MESH, ODD], ids=["2x2", "3x2"])
def test_gather_held_layout(runs, mesh):
    _, got = runs
    out = got[mesh]["layout"]
    assert set(out) == {"exchange0", "exchange1", "gather", "cut"}
    assert all(c["forward_ok"] and c["grad_ok"] for c in out.values())


@pytest.mark.parametrize("arch", ["rwkv6-3b", "recurrentgemma-2b", "whisper-base"])
def test_other_families_refuse_fsdp(arch):
    cfg = configs.get_smoke_config(arch)
    with pytest.raises(NotImplementedError, match="fsdp"):
        api.init_params(cfg, 0, device="cpu", mesh=sharding.MeshShape(
            ("data", "model"), {"data": 2, "model": 2}), hold="fsdp")

"""Training on a mesh: the port's gradients, `train(mesh=)`, optimizer and
batch specs and checkpoints across meshes, against the JAX package's
unsharded training, on the CPU, float32.

Gloo ranks spawned on the CPU (`_torch_mesh.run`, one spawn for the
whole module) build meshes (1, 2), (2, 2) and (4, 1) ("data", "model")
and run every job while the JAX reference is computed:

* the loss and every gradient leaf (gathered whole) of the port's
  `value_and_grad(cfg, blocks, batch)` inside `use_mesh(mesh)`, the
  global batch's rows split over "data", against `jax.value_and_grad`
  of JAX's unsharded loss on the same weights (loss within rtol 1e-5,
  every leaf within atol 1e-4, as `test_torch_train_loss.py`): a dense
  config whose heads shard whole, smollm's smoke config with its heads
  replicated (3 / 1), mixtral's with EP (capacity routed over the
  global batch on "data" 2) and with TP on f (3 experts), deepseek's
  with `moe_groups` (data-local groups) and with `moe_shard_map` (a
  capacity factor that drops nothing, the only setting where the shard
  split and JAX's unsharded route agree), rwkv6, recurrentgemma and
  whisper; labels of -1 fall unevenly on the data ranks.  The dense case
  is the repaired fault: before the collectives carried gradients, a
  sharded vocab left the loss with no path to the weights.
* the collectives' backward rules on toy tensors: all_gather "split" and
  "reduce_scatter" (a wrong choice is off by exactly the axis size),
  copy_to, all_reduce and all_to_all.
* `train(mesh=)` for 4 steps resumed from JAX's step-0 checkpoint (so
  the weights are JAX's), with AdamW, Adafactor, int8 gradient
  compression and 2 microbatches, against JAX's `train` for the same 4
  steps: losses within rtol 1e-4, parameters within atol 1e-5 (with
  compression, `test_torch_train_loop.py`'s allowance: at most 8
  elements past it, all within 4 lr, for a gradient rounding a quantum
  apart).
* a checkpoint saved on (2, 2) (rank 0 writing whole leaves) restores
  bit-equal in JAX's unsharded `CheckpointManager` and onto (4, 1) of the
  same ranks through `restore(shardings=)`.

In one process: `optimizer_shardings` and `data_shardings` equal JAX's
leaf for leaf on the stub {"data": 2, "model": 4} mesh of
`test_torch_sharding.py`; `launch.train` spawns one NCCL rank a card
where CUDA reports several (the spawn and the cards stubbed) and refuses
more ranks than cards, naming gloo.
"""
import concurrent.futures
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

import _torch_mesh
from repro import configs as jax_configs
from repro.checkpoint.manager import CheckpointManager as JaxCheckpointManager
from repro.data import pipeline as jax_pipeline
from repro.models import api as jax_api
from repro.models.config import ModelConfig as JaxConfig
from repro.parallel import sharding as jax_sharding
from repro.training import loop as jax_loop
from repro.training import optimizer as jax_opt
from repro_torch import bridge, configs
from repro_torch.data.pipeline import DataConfig
from repro_torch.models import api
from repro_torch.models.config import ModelConfig
from repro_torch.parallel import sharding
from repro_torch.training.loop import TrainConfig
from repro_torch.training.optimizer import OptimizerConfig, init_opt

LOSS_RTOL, GRAD_ATOL = 1e-5, 1e-4           # value_and_grad, as test_torch_train_loss
TRAIN_RTOL, PARAM_ATOL = 1e-4, 1e-5          # train, as test_torch_train_loop
MESHES = [(2, 2), (4, 2), (4, 1)]            # (world, model axis): (1, 2), (2, 2), (4, 1)
TINY = dict(n_layers=2, d_model=64, n_heads=4, kv_heads=2, head_dim=16, d_ff=128,
            vocab=256, dtype="float32", param_dtype="float32", scan_min_layers=2)
# name -> (smoke arch or None for TINY, config switches)
GRAD_CASES = {
    "dense_heads": (None, dict(name="tiny")),
    "smollm_replicated_heads": ("smollm-135m", dict(n_heads=3, kv_heads=1)),
    "mixtral_ep": ("mixtral-8x7b", dict()),
    "mixtral_tp_f": ("mixtral-8x7b", dict(n_experts=3)),
    "deepseek_groups": ("deepseek-v3-671b", dict(moe_groups=2)),
    "deepseek_shard_map": ("deepseek-v3-671b", dict(moe_shard_map=True, capacity_factor=2.0)),
    "rwkv6": ("rwkv6-3b", dict()),
    "rglru": ("recurrentgemma-2b", dict()),
    "whisper": ("whisper-base", dict()),
}
TRAIN_CASES = {
    "adamw": (dict(), dict()),
    "adafactor": (dict(name="adafactor"), dict()),
    "compression": (dict(), dict(grad_compression=True)),
    "microbatches": (dict(), dict(microbatches=2)),
}
OCFG = dict(lr=1e-3, warmup_steps=2, total_steps=10)
DCFG = dict(vocab=256, seq_len=32, global_batch=4, seed=7)
STEPS = 4
STUB = AbstractMesh((2, 4), ("data", "model"))

_jax_vg = jax.jit(jax.value_and_grad(jax_api.loss_fn, argnums=1), static_argnums=0)


def _cfgs(name):
    arch, kw = GRAD_CASES[name]
    if arch is None:
        return JaxConfig(**TINY, **kw), ModelConfig(**TINY, **kw)
    return (jax_configs.get_smoke_config(arch).replace(**kw),
            configs.get_smoke_config(arch).replace(**kw))


@functools.lru_cache(maxsize=None)
def _weights(jcfg):
    return jax.tree.map(np.asarray, jax.jit(jax_api.init_params, static_argnums=0)(
        jcfg, jax.random.PRNGKey(0)))


def _batch(cfg, b=4, s=16, seed=0):
    """A global batch of 4 rows; labels of -1 on 9 positions of row 0 and
    2 of row 3, so the data ranks hold different counts."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    batch["labels"][0, :9] = -1
    batch["labels"][3, :2] = -1
    if cfg.family == "whisper":
        batch["embeds"] = rng.standard_normal((b, 20, cfg.d_model)).astype(np.float32)
    return batch


def _jax_grads(name):
    jcfg, _ = _cfgs(name)
    batch = _batch(jcfg)
    loss, grads = _jax_vg(jcfg, _weights(jcfg), {k: jnp.asarray(v) for k, v in batch.items()})
    return float(loss), bridge.tree_paths(jax.tree.map(np.asarray, grads))


def _jax_train(ocfg_kw, tcfg_kw, ckpt_dir, steps):
    return jax_loop.train(JaxConfig(name="tiny", **TINY),
                          jax_opt.OptimizerConfig(**OCFG, **ocfg_kw),
                          jax_loop.TrainConfig(steps=steps, log_every=1, ckpt_every=100,
                                               ckpt_dir=ckpt_dir, **tcfg_kw),
                          jax_pipeline.DataConfig(**DCFG), log_fn=lambda _: None)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX's results, the port's by mesh), all from one spawn."""
    tmp = tmp_path_factory.mktemp("train_mesh")
    jobs = []
    for name in GRAD_CASES:
        jcfg, tcfg = _cfgs(name)
        jobs.append((f"grad-{name}", "grad", dict(
            cfg=tcfg, params=bridge.tree_to_torch(_weights(jcfg)),
            batch={k: torch.from_numpy(v) for k, v in _batch(jcfg).items()})))
    tiny = ModelConfig(name="tiny", **TINY)
    for name, (okw, tkw) in TRAIN_CASES.items():
        init = str(tmp / f"init-{name}")
        _jax_train(okw, tkw, init, 0)              # JAX's weights as a step-0 checkpoint
        jobs.append((f"train-{name}", "train", dict(
            cfg=tiny, ocfg=OptimizerConfig(**OCFG, **okw),
            tcfg=TrainConfig(steps=STEPS, log_every=1, ckpt_every=100, **tkw),
            dcfg=DataConfig(**DCFG), init_dir=init, out_dir=str(tmp / f"port-{name}")),
            [(4, 2), (4, 1)]))
    jobs.append(("ckpt", "ckpt", dict(cfg=tiny, ocfg=OptimizerConfig(**OCFG),
                                      tcfg=TrainConfig(), save_dir=str(tmp / "ckpt")),
                 [(4, 2)]))
    jobs.append(("collectives", "grad_rules", dict(), [(4, 2)]))

    def jax_side():
        # XLA compiles outside the GIL: the references compile side by side
        tasks = {f"grad-{name}": functools.partial(_jax_grads, name) for name in GRAD_CASES}
        tasks.update({f"train-{name}": functools.partial(
            _jax_train, okw, tkw, str(tmp / f"jax-{name}"), STEPS)
            for name, (okw, tkw) in TRAIN_CASES.items()})
        with concurrent.futures.ThreadPoolExecutor(4) as pool:
            futures = {key: pool.submit(fn) for key, fn in tasks.items()}
            return {key: f.result() for key, f in futures.items()}

    want, got = _torch_mesh.run(tmp, MESHES, jobs, meanwhile=jax_side)
    return want, got, tmp


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"world{m[0]}-model{m[1]}")
@pytest.mark.parametrize("name", list(GRAD_CASES))
def test_loss_and_grads_on_a_mesh_match_jax(runs, name, mesh):
    want, got, _ = runs
    jl, jg = want[f"grad-{name}"]
    out = got[mesh][f"grad-{name}"]
    assert out["loss"] == pytest.approx(jl, rel=LOSS_RTOL)
    assert [p for p, _ in out["grads"]] == ["/".join(map(str, p)) for p, _ in jg]
    for (path, a), (_, b) in zip(jg, out["grads"]):
        np.testing.assert_allclose(b.numpy(), a, rtol=0, atol=GRAD_ATOL,
                                   err_msg="/".join(map(str, path)))
    # the weights are reached: every leaf's gradient is nonzero somewhere
    # (the fault this repairs left them all zero, or raised)
    assert all(float(g.abs().max()) > 0 for _, g in out["grads"])


def test_value_and_grad_under_a_mesh_reaches_the_weights(runs):
    """The repaired fault, as it showed: the dense config on the (1, 2)
    mesh, vocab 256 sharded over 2, labels ignored unevenly; the
    gradients JAX's unsharded `jax.value_and_grad` gives, not zeros."""
    want, got, _ = runs
    out = got[(2, 2)]["grad-dense_heads"]
    _, jg = want["grad-dense_heads"]
    for (path, a), (_, b) in zip(jg, out["grads"]):
        np.testing.assert_allclose(b.numpy(), a, rtol=0, atol=GRAD_ATOL,
                                   err_msg="/".join(map(str, path)))
    # the backward ran its own collectives: the f operators' sums, the
    # logits' gather split back
    assert out["counts"]["copy_to_bwd"] > 0 and out["counts"]["all_gather_bwd"] > 0


@pytest.mark.parametrize("mesh", [(4, 2), (4, 1)], ids=lambda m: f"world{m[0]}-model{m[1]}")
@pytest.mark.parametrize("name", list(TRAIN_CASES))
def test_train_on_a_mesh_matches_jax(runs, name, mesh):
    want, got, _ = runs
    ref = want[f"train-{name}"]
    out = got[mesh][f"train-{name}"]
    assert out["lines"][0] == "[train] resumed from step 0"
    assert out["meta"] == {"next_step": STEPS}
    jl = dict(ref["losses"])
    assert [s for s, _ in out["losses"]] == list(range(STEPS))
    for step, loss in out["losses"]:
        assert loss == pytest.approx(jl[step], rel=TRAIN_RTOL)
    jp = bridge.tree_paths(jax.tree.map(np.asarray, ref["params"]))
    assert [p for p, _ in jp] == [p for p, _ in out["params"]]
    if name == "compression":
        # int8 rounding: a gradient sitting on a rounding boundary may
        # round a quantum apart between the frameworks, and the Adam step
        # near it then differs by up to ~2 lr (the port's unsharded run
        # shows one such element against JAX too); test_torch_train_loop's
        # allowance
        gaps = np.concatenate([np.abs(a - b.numpy()).ravel()
                               for (_, a), (_, b) in zip(jp, out["params"])])
        assert (gaps > PARAM_ATOL).sum() <= 8
        assert gaps.max() <= 2 * 2 * OCFG["lr"]
        return
    for (path, a), (_, b) in zip(jp, out["params"]):
        np.testing.assert_allclose(b.numpy(), a, rtol=0, atol=PARAM_ATOL,
                                   err_msg="/".join(map(str, path)))


def test_checkpoint_saved_on_a_mesh_restores_in_jax_and_resharded(runs):
    """Saved on (2, 2): JAX's unsharded manager reads every leaf bit for
    bit; the same ranks as a (4, 1) mesh restore it through `shardings=`
    bit for bit."""
    _, got, tmp = runs
    out = got[(4, 2)]["ckpt"]
    assert out["flat_shape"] == {"data": 4, "model": 1}
    assert out["meta"] == {"next_step": 7}
    saved = dict(out["saved"])
    assert [p for p, _ in out["restored"]] == list(saved)
    for path, t in out["restored"]:
        assert t.dtype == saved[path].dtype and torch.equal(t, saved[path]), path
    tiny = JaxConfig(name="tiny", **TINY)
    template = jax_loop.init_train_state(tiny, jax_opt.OptimizerConfig(**OCFG),
                                         jax_loop.TrainConfig(), jax.random.PRNGKey(1))
    (jp, jo), meta = JaxCheckpointManager(str(tmp / "ckpt")).restore(template)
    assert meta == {"next_step": 7}
    jax_leaves = bridge.tree_paths((jax.tree.map(np.asarray, jp), jax.tree.map(np.asarray, jo)))
    assert ["/".join(map(str, p)) for p, _ in jax_leaves] == list(saved)
    for path, a in jax_leaves:
        b = saved["/".join(map(str, path))].numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), path


def test_gradient_rules_of_the_collectives(runs):
    """On (2, 2): each collective's backward by its rule (the job's
    docstring); the split and reduce-scatter gathers differ by exactly
    the model axis (2) where the downstream is replicated."""
    _, got, _ = runs
    out = got[(4, 2)]["collectives"]
    for key, (value, expected) in out.items():
        np.testing.assert_allclose(value, expected, rtol=0, atol=0, err_msg=key)


@functools.lru_cache(maxsize=None)
def _full_shapes(arch):
    return jax.eval_shape(lambda c=jax_configs.get_config(arch):
                          jax_api.init_params(c, jax.random.PRNGKey(0)))


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_optimizer_shardings_match_jax(arch, opt):
    shapes = _full_shapes(arch)
    ocfg = jax_opt.OptimizerConfig(name=opt)
    jopt = jax.eval_shape(lambda: {"inner": jax_opt.init_opt(ocfg, shapes),
                                   "error_feedback": jax.tree.map(
                                       lambda p: jnp.zeros(p.shape, jnp.float32), shapes)})
    flat = jax.tree_util.tree_flatten_with_path(
        jax_sharding.optimizer_shardings(STUB, shapes, jopt))[0]
    want = {jax_sharding._path_str(p): tuple(s.spec) for p, s in flat}
    meta = bridge.tree_map(lambda s: torch.empty(s.shape, device="meta"), shapes)
    topt = {"inner": init_opt(OptimizerConfig(name=opt), meta),
            "error_feedback": bridge.tree_map(lambda p: torch.empty(p.shape, device="meta"),
                                              meta)}
    got = sharding.optimizer_shardings(STUB, meta, topt)
    assert got == {k: tuple(v) for k, v in want.items()}


def test_data_shardings_match_jax():
    batch = {"tokens": (8, 256), "labels": (8, 256), "embeds": (8, 4, 16), "odd": (3, 5)}
    jb = {k: jax.ShapeDtypeStruct(v, jnp.int32) for k, v in batch.items()}
    want = {k: tuple(s.spec) for k, s in jax_sharding.data_shardings(STUB, jb).items()}
    got = sharding.data_shardings(STUB, {k: torch.empty(v, device="meta")
                                         for k, v in batch.items()})
    # a PartitionSpec writes the one-axis tuple ("data",) as "data"
    assert {k: tuple(a[0] if isinstance(a, tuple) and len(a) == 1 else a for a in v)
            for k, v in got.items()} == want
    assert want["tokens"] == ("data", None) and want["odd"] == (None, None)


def test_train_launcher_spawns_one_nccl_rank_a_card(monkeypatch):
    """With more than one card `launch.train` spawns a rank on every card
    and trains on the mesh; one card trains unsharded."""
    import torch.multiprocessing as mp

    from repro_torch.launch import train as train_cli

    spawned = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(mp, "spawn", lambda fn, args, nprocs, join: spawned.append(
        (fn, args[0], nprocs, args[2])))
    argv = ["--arch", "smollm-135m", "--smoke", "--steps", "2"]
    assert train_cli.main(argv) is None
    assert [(fn, world, n) for fn, world, n, _ in spawned] == [(train_cli._train_rank, 4, 4)]
    assert spawned[0][3] == argv
    calls = []
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(train_cli, "train", lambda *a, **kw: calls.append(kw) or {
        "losses": [(0, 1.0), (1, 0.5)], "wall_s": 0.0, "straggler_events": 0})
    train_cli.main(argv)
    assert calls == [{"device": "cuda", "fail_at_step": None}] and len(spawned) == 1

"""The port's training loop (`repro_torch.training.loop`) on the CPU:

* resume from JAX: the JAX `train()` runs 2 steps and checkpoints; the
  port resumes from that directory and trains to step 4; JAX also runs
  the 4 steps straight.  The port's losses at steps 2 and 3 within rtol
  1e-4 of JAX's; its parameters within atol 1e-5 of JAX's, save for at
  most 8 elements that may sit up to 2 x 2 lr away (an Adam step near a
  zero gradient is sign-like, and a sign can flip between frameworks;
  none flipped when this was written: the largest gap was 4e-8);
* resume in the port: a run failed by `fail_at_step` and resumed equals
  an uninterrupted run bit for bit (losses and every parameter);
* two microbatches equal the whole batch; AdamW and Adafactor lower the
  loss; training with int8 gradient compression converges (the JAX
  tests' margins).
"""
import numpy as np
import pytest
import torch

from repro.data import pipeline as jax_pipeline
from repro.models.config import ModelConfig as JaxModelConfig
from repro.training import loop as jax_loop
from repro.training import optimizer as jax_opt
from repro_torch import bridge
from repro_torch.data.pipeline import DataConfig, DataPipeline
from repro_torch.models.config import ModelConfig
from repro_torch.training.loop import (TrainConfig, init_train_state,
                                       make_train_step, train)
from repro_torch.training.optimizer import OptimizerConfig

TINY_KW = dict(name="tiny", n_layers=2, d_model=64, n_heads=4, kv_heads=2,
               head_dim=16, d_ff=128, vocab=256, dtype="float32",
               param_dtype="float32", scan_min_layers=2)
TINY = ModelConfig(**TINY_KW)


def _quiet(_line):
    pass


def test_resume_from_a_jax_checkpoint_tracks_jax(tmp_path):
    ocfg = dict(lr=1e-3, warmup_steps=2, total_steps=10)
    dcfg = dict(vocab=256, seq_len=32, global_batch=4, seed=7)
    jtiny = JaxModelConfig(**TINY_KW)
    jax_loop.train(jtiny, jax_opt.OptimizerConfig(**ocfg),
                   jax_loop.TrainConfig(steps=2, log_every=1, ckpt_every=2,
                                        ckpt_dir=str(tmp_path / "a")),
                   jax_pipeline.DataConfig(**dcfg), log_fn=_quiet)
    lines = []
    port = train(TINY, OptimizerConfig(**ocfg),
                 TrainConfig(steps=4, log_every=1, ckpt_every=2,
                             ckpt_dir=str(tmp_path / "a")),
                 DataConfig(**dcfg), device="cpu", log_fn=lines.append)
    assert lines[0] == "[train] resumed from step 2"
    ref = jax_loop.train(jtiny, jax_opt.OptimizerConfig(**ocfg),
                         jax_loop.TrainConfig(steps=4, log_every=1, ckpt_every=2,
                                              ckpt_dir=str(tmp_path / "b")),
                         jax_pipeline.DataConfig(**dcfg), log_fn=_quiet)
    want = dict(ref["losses"])
    assert [s for s, _ in port["losses"]] == [2, 3]
    for step, loss in port["losses"]:
        assert loss == pytest.approx(want[step], rel=1e-4)
    jp = bridge.tree_paths(bridge.tree_map(np.asarray, ref["params"]))
    tp = bridge.tree_paths(port["params"])
    assert [p for p, _ in jp] == [p for p, _ in tp]
    gaps = np.concatenate([np.abs(a - b.numpy()).ravel() for (_, a), (_, b) in zip(jp, tp)])
    assert (gaps > 1e-5).sum() <= 8
    assert gaps.max() <= 2 * 2 * ocfg["lr"]


def test_failure_resume_bitwise_identical(tmp_path):
    ocfg = OptimizerConfig(lr=1e-3, warmup_steps=5, total_steps=40)
    dcfg = DataConfig(vocab=256, seq_len=32, global_batch=4, seed=7)
    t1 = TrainConfig(steps=12, log_every=1, ckpt_every=6, ckpt_dir=str(tmp_path / "a"))
    ref = train(TINY, ocfg, t1, dcfg, device="cpu", log_fn=_quiet)
    t2 = TrainConfig(steps=12, log_every=1, ckpt_every=6, ckpt_dir=str(tmp_path / "b"))
    with pytest.raises(RuntimeError, match="injected failure at step 6"):
        train(TINY, ocfg, t2, dcfg, device="cpu", fail_at_step=6, log_fn=_quiet)
    res = train(TINY, ocfg, t2, dcfg, device="cpu", log_fn=_quiet)
    assert [s for s, _ in res["losses"]] == list(range(6, 12))
    assert dict(res["losses"]) == {s: v for s, v in ref["losses"] if s >= 6}
    for a, b in zip(bridge.tree_leaves(ref["params"]), bridge.tree_leaves(res["params"])):
        assert torch.equal(a, b)


def test_microbatch_equivalence():
    """2 microbatches == the whole batch (same gradients up to numerics)."""
    ocfg = OptimizerConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    dcfg = DataConfig(vocab=256, seq_len=32, global_batch=8, seed=3)
    batch = {k: torch.from_numpy(v) for k, v in DataPipeline(dcfg).batch(0).items()}
    outs = {}
    for n_micro in (1, 2):
        tcfg = TrainConfig(steps=1, microbatches=n_micro)
        params, opt_state = init_train_state(TINY, ocfg, tcfg, device="cpu")
        p2, _, m = make_train_step(TINY, ocfg, tcfg)(params, opt_state, batch)
        outs[n_micro] = (p2, float(m["loss"]))
    assert outs[1][1] == pytest.approx(outs[2][1], rel=1e-5)
    for a, b in zip(bridge.tree_leaves(outs[1][0]), bridge.tree_leaves(outs[2][0])):
        assert float((a - b).abs().max()) < 1e-5


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_reduces_loss(name):
    ocfg = OptimizerConfig(name=name, lr=2e-3, warmup_steps=2, total_steps=60)
    dcfg = DataConfig(vocab=256, seq_len=64, global_batch=8, seed=7)
    out = train(TINY, ocfg, TrainConfig(steps=50, log_every=49), dcfg, device="cpu",
                log_fn=_quiet)
    losses = dict(out["losses"])
    assert losses[0] - losses[49] > 0.3, losses


def test_training_with_compression_converges():
    ocfg = OptimizerConfig(lr=2e-3, warmup_steps=2, total_steps=40)
    dcfg = DataConfig(vocab=256, seq_len=64, global_batch=8, seed=7)
    tcfg = TrainConfig(steps=40, log_every=39, grad_compression=True)
    params, opt_state = init_train_state(TINY, ocfg, tcfg, device="cpu")
    assert set(opt_state) == {"inner", "error_feedback"}
    out = train(TINY, ocfg, tcfg, dcfg, device="cpu", log_fn=_quiet)
    losses = dict(out["losses"])
    assert losses[0] - losses[39] > 0.2

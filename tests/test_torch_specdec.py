"""Speculative decoding of the PyTorch/CUDA port on the CPU against the
JAX package, float32, on the same transferred weights.

* `decode_window` (the verify forward) against the JAX `decode_window`:
  logits within 1e-4, the window's k/v written at its positions.
* `SpecDecodeEngine`: token streams, finish reasons and `spec_stats`
  equal to the JAX `SpecDecodeEngine`'s and to the port's target-only
  engine's (plain and kernel impls, full width and a compacted decode
  batch).
* `shared_trunk_draft` / `high_tar_pair` give the JAX package's trees,
  and acceptance 1.0 with k tokens an iteration.
* `spec_decode_greedy` equals the JAX loop; `spec_decode_sampled` is
  seeded-deterministic and a draft equal to the target accepts all.
* The engine rejects sampled requests and non-window targets.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import api as jax_api
from repro.models import transformer as jax_transformer
from repro.models.config import ModelConfig as JaxConfig
from repro.serving.engine import Request as JaxRequest
from repro.serving.specdec import SpecDecodeEngine as JaxSpecEngine
from repro.serving.specdec import high_tar_pair as jax_high_tar_pair
from repro.serving.specdec import spec_decode_greedy as jax_spec_greedy
from repro_torch import bridge
from repro_torch.models import api, transformer
from repro_torch.models.config import ModelConfig
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.specdec import (SpecDecodeEngine, high_tar_pair,
                                         shared_trunk_draft, spec_decode_greedy,
                                         spec_decode_sampled)

SPEC_KW = dict(name="spec", n_layers=4, d_model=32, n_heads=2, kv_heads=1,
               head_dim=16, d_ff=64, vocab=61, dtype="float32",
               param_dtype="float32", scan_layers=False)
KERNEL_IMPLS = dict(attn_impl="flash", mlp_impl="fused", norm_impl="fused")


def _weights(jcfg, seed=0):
    return jax.tree.map(np.asarray, jax_api.init_params(jcfg, jax.random.PRNGKey(seed)))


def _prompts(n=4, seed=13):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 61, size=int(rng.integers(3, 8))).astype(np.int32)
            for _ in range(n)]


def _serve(eng, reqs):
    for r in reqs:
        eng.submit(r)
    eng.run()
    return [r.out_tokens for r in reqs], [r.finish_reason for r in reqs]


@pytest.mark.parametrize("w", [1, 4])
def test_decode_window_matches_jax(w):
    jcfg, tcfg = JaxConfig(**SPEC_KW), ModelConfig(**SPEC_KW)
    wts = _weights(jcfg)
    rng = np.random.default_rng(w)
    prompt = rng.integers(0, 61, size=(2, 7)).astype(np.int32)
    window = rng.integers(0, 61, size=(2, w)).astype(np.int32)
    _, jc = jax_api.prefill(jcfg, wts, {"tokens": jnp.asarray(prompt)}, 16)
    jc = {"segments": jc["segments"], "index": jnp.asarray([7, 7], jnp.int32)}
    jl, jc2 = jax_api.decode_window(jcfg, wts, jnp.asarray(window), jc)
    params = bridge.tree_to_torch(wts)
    _, tc = api.prefill(tcfg, params, {"tokens": torch.as_tensor(prompt).long()}, 16)
    tc["index"] = torch.tensor([7, 7], dtype=torch.int32)
    tl, tc2 = api.decode_window(tcfg, params, torch.as_tensor(window).long(), tc)
    assert tl.shape == (2, w, 61)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
    assert tc2["index"].tolist() == np.asarray(jc2["index"]).tolist() == [7 + w] * 2
    np.testing.assert_allclose(tc2["segments"][0]["k"][:, :, 7:7 + w].numpy(),
                               np.asarray(jc2["segments"][0]["k"])[:, :, 7:7 + w],
                               rtol=1e-4, atol=1e-4)


def test_decode_window_refuses_what_it_cannot_verify():
    cfg = ModelConfig(**SPEC_KW).replace(window=8)
    assert not transformer.window_supported(cfg)
    with pytest.raises(NotImplementedError, match="plain-attention"):
        transformer.decode_window(cfg, {}, torch.zeros((1, 2), dtype=torch.long),
                                  {"index": 0, "segments": []})


@pytest.mark.parametrize("impls", [{}, KERNEL_IMPLS], ids=["plain", "kernels"])
@pytest.mark.parametrize("decode_batch", [None, 1], ids=["full", "compact"])
@pytest.mark.parametrize("k", [2, 3])
def test_spec_engine_matches_jax_and_target_only(impls, decode_batch, k):
    jcfg, tcfg = JaxConfig(**SPEC_KW).replace(**impls), ModelConfig(**SPEC_KW).replace(**impls)
    jdcfg, tdcfg = jcfg.replace(name="spec-d", n_layers=1), tcfg.replace(name="spec-d",
                                                                         n_layers=1)
    wts, dwts = _weights(jcfg), _weights(jdcfg, 1)
    kw = dict(max_batch=2, max_len=32, decode_batch=decode_batch)
    jeng = JaxSpecEngine(jcfg, wts, jdcfg, dwts, k=k, **kw)
    jtoks, jfin = _serve(jeng, [JaxRequest(rid=i, prompt=p, max_new_tokens=8)
                                for i, p in enumerate(_prompts())])
    params, dparams = bridge.tree_to_torch(wts), bridge.tree_to_torch(dwts)
    eng = SpecDecodeEngine(tcfg, params, tdcfg, dparams, k=k, device="cpu", **kw)
    toks, fin = _serve(eng, [Request(rid=i, prompt=p, max_new_tokens=8)
                             for i, p in enumerate(_prompts())])
    assert toks == jtoks and fin == jfin
    assert dataclasses.asdict(eng.spec_stats) == dataclasses.asdict(jeng.spec_stats)
    for key in ("decode_steps", "prefills", "tokens_out", "nan_steps"):
        assert eng.stats[key] == jeng.stats[key], key
    ref = ServingEngine(tcfg, params, paged=False, device="cpu", **kw)
    assert _serve(ref, [Request(rid=i, prompt=p, max_new_tokens=8)
                        for i, p in enumerate(_prompts())])[0] == toks


def test_shared_trunk_and_high_tar_pair_match_jax():
    jcfg, tcfg = JaxConfig(**SPEC_KW), ModelConfig(**SPEC_KW)
    wts = _weights(jcfg)
    jtp, jdcfg, jdp = jax_high_tar_pair(jcfg, jax.tree.map(jnp.asarray, wts), 2)
    tp, dcfg, dp = high_tar_pair(tcfg, bridge.tree_to_torch(wts), 2)
    assert dcfg.n_layers == jdcfg.n_layers == 2
    for jt, tt in ((jtp, tp), (jdp, dp)):
        jl = jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, jt))
        for path, a in jl:
            node = tt
            for key in path:
                node = node[getattr(key, "key", getattr(key, "idx", None))]
            assert np.array_equal(node.numpy(), a), path
    # the draft shares the target's tensors (views, no copy)
    params = bridge.tree_to_torch(wts)
    _, dp2 = shared_trunk_draft(tcfg, params, 2)
    assert dp2["embed"] is params["embed"]
    wq = dp2["segments"][0]["kind_dense"]["attn"]["wq"]
    assert wq.data_ptr() == params["segments"][0]["kind_dense"]["attn"]["wq"].data_ptr()
    with pytest.raises(ValueError, match="n_draft"):
        shared_trunk_draft(tcfg, params, 4)


@pytest.mark.parametrize("k", [2, 4])
def test_high_tar_pair_accepts_everything(k):
    tcfg = ModelConfig(**SPEC_KW)
    wts = _weights(JaxConfig(**SPEC_KW))
    tp, dcfg, dp = high_tar_pair(tcfg, bridge.tree_to_torch(wts), 2)
    eng = SpecDecodeEngine(tcfg, tp, dcfg, dp, k=k, max_batch=2, max_len=40,
                           device="cpu")
    _serve(eng, [Request(rid=i, prompt=p, max_new_tokens=9)
                 for i, p in enumerate(_prompts())])
    assert eng.spec_stats.acceptance_rate == pytest.approx(1.0)
    assert eng.spec_stats.tokens_per_iteration == pytest.approx(float(k))


def test_spec_decode_greedy_matches_jax():
    jcfg, tcfg = JaxConfig(**SPEC_KW), ModelConfig(**SPEC_KW)
    jdcfg, tdcfg = jcfg.replace(n_layers=1), tcfg.replace(n_layers=1)
    wts, dwts = _weights(jcfg), _weights(jdcfg, 1)
    prompt = np.arange(6, dtype=np.int32)
    # one-shot closures over this test's weights, as tests/test_serving.py's
    tf = jax.jit(lambda t: jax_transformer.forward(jcfg, wts, t))  # mzc: ignore[MZC013]
    df = jax.jit(lambda t: jax_transformer.forward(jdcfg, dwts, t))  # mzc: ignore[MZC013]
    jout, jst = jax_spec_greedy(tf, df, prompt, k=3, max_new_tokens=8)
    params, dparams = bridge.tree_to_torch(wts), bridge.tree_to_torch(dwts)
    out, st = spec_decode_greedy(
        lambda t: transformer.forward(tcfg, params, t),
        lambda t: transformer.forward(tdcfg, dparams, t), prompt, k=3,
        max_new_tokens=8, device="cpu")
    assert out.tolist() == np.asarray(jout).tolist()
    assert dataclasses.asdict(st) == dataclasses.asdict(jst)


def test_spec_decode_sampled_is_seeded_and_self_draft_accepts_all():
    tcfg = ModelConfig(**SPEC_KW)
    params = bridge.tree_to_torch(_weights(JaxConfig(**SPEC_KW)))
    dparams = bridge.tree_to_torch(_weights(JaxConfig(**SPEC_KW).replace(n_layers=1), 2))
    tf = lambda t: transformer.forward(tcfg, params, t)            # noqa: E731
    df = lambda t: transformer.forward(tcfg.replace(n_layers=1), dparams, t)  # noqa: E731
    runs = [spec_decode_sampled(tf, df, np.arange(4, dtype=np.int32),
                                torch.Generator().manual_seed(3), k=3,
                                max_new_tokens=8, device="cpu") for _ in range(2)]
    assert runs[0][0].tolist() == runs[1][0].tolist() and runs[0][1] == runs[1][1]
    assert len(runs[0][0]) == 8 and 0.0 <= runs[0][1].acceptance_rate <= 1.0
    _, st = spec_decode_sampled(tf, tf, np.arange(4, dtype=np.int32),
                                torch.Generator().manual_seed(4), k=3,
                                max_new_tokens=8, device="cpu")
    assert st.acceptance_rate == pytest.approx(1.0)


def test_spec_engine_is_greedy_only_and_needs_a_window_target():
    tcfg = ModelConfig(**SPEC_KW)
    params = bridge.tree_to_torch(_weights(JaxConfig(**SPEC_KW)))
    dcfg, dp = shared_trunk_draft(tcfg, params, 1)
    eng = SpecDecodeEngine(tcfg, params, dcfg, dp, k=2, max_batch=2, max_len=32,
                           device="cpu")
    with pytest.raises(ValueError, match="greedy"):
        eng.submit(Request(rid=0, prompt=np.asarray([1, 2, 3], np.int32),
                           temperature=0.7))
    with pytest.raises(ValueError, match="plain-attention"):
        SpecDecodeEngine(tcfg.replace(window=8), params, dcfg, dp, k=2, device="cpu")
    with pytest.raises(ValueError, match="k >= 2"):
        SpecDecodeEngine(tcfg, params, dcfg, dp, k=1, device="cpu")


def test_spec_engine_allocates_target_and_draft_caches_once(monkeypatch):
    """The engine builds `SpecKVState` in place of the base engine's
    target-only rectangles: two dense caches in all, target and draft."""
    from repro_torch.serving import state as state_mod
    from repro_torch.serving.specdec import SpecKVState

    built = []
    init = state_mod.DenseKVState.__init__

    def counted(self, mcfg, *a, **kw):
        built.append(mcfg.n_layers)
        init(self, mcfg, *a, **kw)

    monkeypatch.setattr(state_mod.DenseKVState, "__init__", counted)
    tcfg = ModelConfig(**SPEC_KW)
    params = bridge.tree_to_torch(_weights(JaxConfig(**SPEC_KW)))
    dcfg, dp = shared_trunk_draft(tcfg, params, 1)
    eng = SpecDecodeEngine(tcfg, params, dcfg, dp, k=2, max_batch=2, max_len=32,
                           device="cpu")
    assert sorted(built) == [1, 4]
    assert isinstance(eng.state, SpecKVState) and eng.draft_state is eng.state.draft
    assert eng.cache is eng.state.cache and eng.pool is None


def test_specdec_cli_on_cpu(capsys):
    from repro_torch.launch import serve as serve_mod

    serve_mod.main(["--arch", "smollm-135m", "--smoke", "--device", "cpu", "--scenario",
                    "specdec", "--k", "3", "--requests", "3", "--max-new", "5"])
    out = capsys.readouterr().out
    assert "scenario=spec_decode" in out and "specdec-live: 15 tokens" in out
    serve_mod.main(["--arch", "smollm-135m", "--smoke", "--device", "cpu", "--specdec",
                    "--max-new", "6"])
    assert "specdec: 6 tokens" in capsys.readouterr().out

"""Serving parity of the PyTorch/CUDA port on the CPU: the port's
`ServingEngine(device="cpu")` against the JAX `ServingEngine` on the same
transferred weights.  Token streams, finish reasons and preemption
counts must be equal on a golden-style trace (compared live, never with
frozen tokens: JAX's `init_params` draws depend on its PRNG settings), a
Zipf-mix trace, compact and full-width decode, and a small page pool
that forces preemption.  Also the `PagePool` rules and `apply_policy`
parity.
"""
import copy
import dataclasses
import json

import jax
import numpy as np
import pytest

from repro import configs as jax_configs
from repro.core.policy import ExecutionPolicy as JaxPolicy
from repro.core.policy import OperatorPolicy as JaxOperatorPolicy
from repro.launch.serve import apply_policy as jax_apply_policy
from repro.models import api as jax_api
from repro.models.config import ModelConfig as JaxConfig
from repro.serving import workload
from repro.serving.engine import Request as JaxRequest
from repro.serving.engine import ServingEngine as JaxEngine
from repro_torch import bridge, configs
from repro_torch.launch import policy as tpolicy
from repro_torch.launch.serve import apply_policy, serve
from repro_torch.models.config import ModelConfig
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.paged import PagePool, bucket_for, prefill_buckets

GOLDEN_KW = dict(name="golden", n_layers=2, d_model=64, n_heads=4, kv_heads=2,
                 head_dim=16, d_ff=128, vocab=97, dtype="float32",
                 param_dtype="float32", scan_layers=False)
KERNEL_IMPLS = dict(attn_impl="flash", mlp_impl="fused", norm_impl="fused")


def _golden_prompts():
    rng = np.random.default_rng(7)
    out = []
    for _ in range(6):
        plen = int(rng.integers(3, 9))
        out.append(rng.integers(0, 97, size=plen).astype(np.int32))
    return out


def _run_both(jcfg, tcfg, prompts, max_new, **eng_kw):
    """Serve the same prompts through both engines on the same weights;
    returns (jax requests, port requests, jax engine, port engine)."""
    w = jax.tree.map(np.asarray, jax_api.init_params(jcfg, jax.random.PRNGKey(0)))
    jeng = JaxEngine(jcfg, w, **eng_kw)
    teng = ServingEngine(tcfg, bridge.tree_to_torch(w), device="cpu", **eng_kw)
    jreqs = [JaxRequest(rid=i, prompt=p, max_new_tokens=max_new)
             for i, p in enumerate(prompts)]
    treqs = [Request(rid=i, prompt=p, max_new_tokens=max_new)
             for i, p in enumerate(prompts)]
    for r in jreqs:
        jeng.submit(r)
    jeng.run()
    serve(teng, treqs)
    return jreqs, treqs, jeng, teng


def _assert_same(jreqs, treqs, jeng, teng):
    assert [r.out_tokens for r in treqs] == [r.out_tokens for r in jreqs]
    assert [r.finish_reason for r in treqs] == [r.finish_reason for r in jreqs]
    for key in ("decode_steps", "prefills", "tokens_out", "preemptions",
                "rejected", "shed", "nan_steps"):
        assert teng.stats[key] == jeng.stats[key], key


@pytest.mark.parametrize("compact", [True, False], ids=["compact", "full"])
@pytest.mark.parametrize("impls", [{}, KERNEL_IMPLS], ids=["plain", "kernels"])
def test_golden_style_trace_matches_jax(compact, impls):
    jcfg = JaxConfig(**GOLDEN_KW).replace(**impls)
    tcfg = ModelConfig(**GOLDEN_KW).replace(**impls)
    jreqs, treqs, jeng, teng = _run_both(
        jcfg, tcfg, _golden_prompts(), 6, max_batch=4, max_len=32,
        paged=True, compact=compact, decode_batch=2)
    _assert_same(jreqs, treqs, jeng, teng)
    assert all(r.finish_reason == "max_new_tokens" for r in treqs)


def test_zipf_trace_matches_jax():
    """The Zipf short/medium/long mix crosses every prefill bucket of a
    max_len=64 engine; prompts come from the JAX workload generator."""
    jcfg = jax_configs.get_smoke_config("smollm-135m")
    tcfg = configs.get_smoke_config("smollm-135m")
    reqs = workload.zipf_mix_requests(np.random.default_rng(11), 10, jcfg.vocab,
                                      max_new_tokens=8)
    prompts = [r.prompt for r in reqs]
    assert {bucket_for(len(p), prefill_buckets(64)) for p in prompts} == {16, 32, 64}
    jreqs, treqs, jeng, teng = _run_both(jcfg, tcfg, prompts, 8, max_batch=4,
                                         max_len=64)
    _assert_same(jreqs, treqs, jeng, teng)


def test_preemption_under_page_pressure_matches_jax():
    """Seven pages for three slots of up to 40 tokens: the youngest slot is
    preempted and later resumed by re-prefill, exactly as in JAX."""
    jcfg = JaxConfig(**GOLDEN_KW)
    tcfg = ModelConfig(**GOLDEN_KW)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 97, size=int(n)).astype(np.int32)
               for n in (14, 18, 9, 22, 12)]
    jreqs, treqs, jeng, teng = _run_both(jcfg, tcfg, prompts, 16, max_batch=3,
                                         max_len=48, num_pages=7)
    _assert_same(jreqs, treqs, jeng, teng)
    assert teng.stats["preemptions"] > 0
    assert teng.pool.stats == jeng.pool.stats


def test_rejection_and_length_finish_match_jax():
    jcfg, tcfg = JaxConfig(**GOLDEN_KW), ModelConfig(**GOLDEN_KW)
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, 97, size=n).astype(np.int32) for n in (40, 28, 5)]
    jreqs, treqs, jeng, teng = _run_both(jcfg, tcfg, prompts, 12, max_batch=2,
                                         max_len=32)
    _assert_same(jreqs, treqs, jeng, teng)
    assert [r.finish_reason for r in treqs] == ["rejected", "length",
                                                "max_new_tokens"]


def test_shedding_and_nan_guard_match_jax():
    """A bounded queue sheds the overflow, an expired deadline is shed at
    admission, and non-finite logits stop the engine before it emits a
    decode token — in both engines alike."""
    jcfg, tcfg = JaxConfig(**GOLDEN_KW), ModelConfig(**GOLDEN_KW)
    w = jax.tree.map(np.asarray, jax_api.init_params(jcfg, jax.random.PRNGKey(0)))
    prompts = _golden_prompts()
    runs = []
    for eng, req_cls in ((JaxEngine(jcfg, w, max_batch=2, max_len=32,
                                    queue_bound=3), JaxRequest),
                         (ServingEngine(tcfg, bridge.tree_to_torch(w), max_batch=2,
                                        max_len=32, queue_bound=3, device="cpu"),
                          Request)):
        reqs = [req_cls(rid=i, prompt=p, max_new_tokens=4,
                        deadline_s=-1.0 if i == 1 else None)
                for i, p in enumerate(prompts)]
        accepted = [eng.submit(r) for r in reqs]
        eng.run()
        runs.append((accepted, [r.finish_reason for r in reqs],
                     [r.out_tokens for r in reqs], eng.stats["shed"]))
    assert runs[0] == runs[1]
    assert runs[1][0] == [True, True, True, False, False, False]
    assert runs[1][1][:3] == ["max_new_tokens", "shed", "max_new_tokens"]

    bad = copy.deepcopy(w)
    bad["final_norm"]["scale"] = np.full_like(bad["final_norm"]["scale"], np.nan)
    flags = []
    for eng, req_cls in ((JaxEngine(jcfg, bad, max_batch=2, max_len=32), JaxRequest),
                         (ServingEngine(tcfg, bridge.tree_to_torch(bad), max_batch=2,
                                        max_len=32, device="cpu"), Request)):
        reqs = [req_cls(rid=i, prompt=p, max_new_tokens=4)
                for i, p in enumerate(prompts[:2])]
        for r in reqs:
            eng.submit(r)
        eng.run()
        flags.append((eng.health["nan_detected"], eng.stats["nan_steps"],
                      eng.stats["decode_steps"], [len(r.out_tokens) for r in reqs]))
    assert flags[0] == flags[1] == (True, 1, 0, [1, 1])


# -- PagePool rules -----------------------------------------------------------

def test_page_pool_rules():
    cfg = ModelConfig(**GOLDEN_KW)
    pool = PagePool(cfg, max_batch=2, max_len=64, page_size=16, num_pages=6)
    assert pool.free_pages == 5 and pool.pages_in_use == 0
    assert pool.ensure(0, 20)                 # two pages, ascending from 1
    assert pool.owned(0) == (1, 2)
    assert pool.tables[0].tolist() == [1, 2, 0, 0]
    assert pool.ensure(1, 16) and pool.owned(1) == (3,)
    assert not pool.ensure(1, 64)             # needs 3 more, 2 free: atomic
    assert pool.owned(1) == (3,) and pool.free_pages == 2
    assert pool.table_row(0, 3).tolist() == [1, 2, 0]
    pool.index[0] = 20
    pool.release(0)
    assert pool.tables[0].tolist() == [0, 0, 0, 0] and pool.index[0] == 0
    assert pool.ensure(1, 48) and pool.owned(1) == (3, 1, 2)
    assert pool.stats == {"page_allocs": 5, "page_frees": 2,
                          "peak_pages_in_use": 3}
    with pytest.raises(ValueError):
        PagePool(cfg, 1, 32, page_size=12)
    assert prefill_buckets(64) == (16, 32, 64)
    assert prefill_buckets(512, 16) == (16, 32, 64, 128, 256, 512)


def test_engine_defaults_to_cuda_and_rejects_unported_states():
    """A transformer that cannot serve paged (paged=False, a sliding
    window, MoE) takes the dense KV state; int8 KV resolves to the JAX
    engine's mode (tests/test_torch_kv_quant.py); whisper takes the
    cross-attention state (tests/test_torch_whisper.py)."""
    cfg = configs.get_smoke_config("smollm-135m")
    for c, kw in ((cfg, dict(paged=False)), (cfg.replace(window=8), {}),
                  (configs.get_smoke_config("mixtral-8x7b"), {})):
        eng = ServingEngine(c, {}, device="cpu", **kw)
        assert eng.state.kind == "dense" and not eng.paged
    assert ServingEngine(cfg, {}, kv_quant=True, device="cpu").kv_quant_mode == "paged"
    assert ServingEngine(cfg, {}, kv_quant="dense", paged=False,
                         device="cpu").kv_quant_mode == "dense"
    eng = ServingEngine(cfg.replace(family="whisper"), {}, device="cpu")
    assert eng.state.kind == "cross_attn" and not eng.paged and eng.compact


# -- policies -----------------------------------------------------------------

def _policy_dicts():
    def pol(groups):
        ops = [JaxOperatorPolicy(group=g, batch=b, tp=tp, memory="HBM3",
                                 chiplet="WS-pe64-glb512K-2D", fused="+" in g)
               for g, b, tp in groups]
        return JaxPolicy(network="n", interval_s=1e-3, operators=ops).to_dict()

    return [pol([("norm1+qkv_proj+attention", 2, 2), ("mlp", 16, 1)]),
            pol([("qkv_proj+attention", 4, 1), ("norm2+mlp", 4, 1)]),
            pol([("attention", 4, 1), ("mlp", 4, 1)])]


@pytest.mark.parametrize("idx", [0, 1, 2])
@pytest.mark.parametrize("arch", ["smollm-135m", "qwen2.5-32b", "mixtral-8x7b",
                                  "rwkv6-3b", "recurrentgemma-2b"])
def test_apply_policy_matches_jax(arch, idx, tmp_path):
    d = _policy_dicts()[idx]
    path = tmp_path / "policy.json"
    path.write_text(json.dumps(d))
    tpol = tpolicy.load_policy(path)
    assert tpol.to_dict() == JaxPolicy.from_dict(d).to_dict()
    jcfg, jkw, _ = jax_apply_policy(JaxPolicy.from_dict(d),
                                    jax_configs.get_config(arch), 8, n_devices=1)
    tcfg, tkw, lines = apply_policy(tpol, configs.get_config(arch), 8, n_devices=1)
    for f in ("attn_impl", "mlp_impl", "norm_impl"):
        assert getattr(tcfg, f) == getattr(jcfg, f)
    assert tkw == jkw
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert lines[0].startswith("[serve] policy network=n fusion flags:")


def test_load_policy_reads_deployment_artifact(tmp_path):
    d = _policy_dicts()[1]
    art = {"schema": tpolicy.SCHEMA, "policies": {"n": d}}
    (tmp_path / "dep.json").write_text(json.dumps(art))
    assert tpolicy.load_policy(tmp_path / "dep.json").to_dict() == d
    two = copy.deepcopy(art)
    two["policies"]["m"] = d
    (tmp_path / "two.json").write_text(json.dumps(two))
    with pytest.raises(ValueError, match="name one"):
        tpolicy.load_policy(tmp_path / "two.json")
    assert tpolicy.load_policy(tmp_path / "two.json", "m").network == "n"

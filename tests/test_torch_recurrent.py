"""Recurrent families of the PyTorch/CUDA port on the CPU: RWKV6 and the
RG-LRU hybrid (recurrentgemma) against the JAX package on the same
transferred weights.

* the arch registry and the `init_params` tree (paths, shapes, dtypes);
* `forward`, `prefill` and `decode_step` logits, float32, within 1e-4, on
  the smoke configs of both archs and on the tiny configs of
  `tests/test_family_serving.py`; rglru prompts run past the window so
  the ring placement (`roll`) and the ring decode mask are exercised;
* `ServingEngine(device="cpu")` token streams, finish reasons and stats
  equal the JAX engine's under slot churn, `decode_batch < max_batch`
  rotation, a prompt at the capacity boundary and the NaN guard, through
  `RecurrentState`;
* the serve CLI on both smoke configs.
"""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.models import api as jax_api
from repro.models.config import ModelConfig as JaxConfig
from repro.serving.engine import Request as JaxRequest
from repro.serving.engine import ServingEngine as JaxEngine
from repro_torch import bridge, configs
from repro_torch.launch.serve import main as serve_main
from repro_torch.launch.serve import serve
from repro_torch.models import api
from repro_torch.models.config import ModelConfig
from repro_torch.serving.engine import Request, ServingEngine

ARCHS = ("rwkv6-3b", "recurrentgemma-2b")
TOL = dict(rtol=1e-4, atol=1e-4)

# the tiny family configs of tests/test_family_serving.py
TINY = dict(n_layers=2, d_model=32, d_ff=64, vocab=61,
            dtype="float32", param_dtype="float32")
TINY_CFGS = {
    "rglru": dict(name="fam-rg", family="rglru", n_heads=2, kv_heads=1,
                  head_dim=16, lru_width=48, attn_every=2, window=8, **TINY),
    "rwkv6": dict(name="fam-rw", family="rwkv6", head_dim=16, wkv_chunk=8, **TINY),
}


def _cfgs(name):
    """(JAX config, port config) by arch id (smoke config) or tiny family."""
    if name in TINY_CFGS:
        return JaxConfig(**TINY_CFGS[name]), ModelConfig(**TINY_CFGS[name])
    return jax_configs.get_smoke_config(name), configs.get_smoke_config(name)


def _weights(jcfg, seed=0):
    return jax.tree.map(np.asarray, jax_api.init_params(jcfg, jax.random.PRNGKey(seed)))


def _tree_spec(tree):
    """{path: (shape, dtype name)} of every leaf."""
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {jax.tree_util.keystr(p): (tuple(a.shape), str(a.dtype).replace("torch.", ""))
            for p, a in flat}


# -- configs and parameters ----------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_recurrent_configs_match_jax_registry(arch):
    for get_j, get_t in ((jax_configs.get_config, configs.get_config),
                         (jax_configs.get_smoke_config, configs.get_smoke_config)):
        assert dataclasses.asdict(get_t(arch)) == dataclasses.asdict(get_j(arch))


@pytest.mark.parametrize("name", [*ARCHS, *TINY_CFGS])
def test_init_params_tree_matches_jax(name):
    """Same paths, shapes and dtypes as JAX in both parameter dtypes (the
    float32 leaves `w0`, `u` and `lam` stay float32); a seed gives the
    same weights twice."""
    jcfg, tcfg = _cfgs(name)
    for dt in ("bfloat16", "float32"):
        jc, tc = jcfg.replace(param_dtype=dt), tcfg.replace(param_dtype=dt)
        spec_j = _tree_spec(jax.eval_shape(
            lambda c=jc: jax_api.init_params(c, jax.random.PRNGKey(0))))
        params = api.init_params(tc, 0, device="cpu")
        assert _tree_spec(params) == spec_j
    again = api.init_params(tc, 0, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(jax.tree_util.tree_leaves(params),
                                                 jax.tree_util.tree_leaves(again)))


# -- model parity ----------------------------------------------------------------

_jax_forward = jax.jit(lambda c, w, t: jax_api.forward(c, w, {"tokens": t}),
                       static_argnums=(0,))
_jax_prefill = jax.jit(lambda c, w, t, m: jax_api.prefill(c, w, {"tokens": t}, m),
                       static_argnums=(0, 3))
_jax_decode = jax.jit(jax_api.decode_step, static_argnums=(0,))


@pytest.mark.parametrize("name,seq,max_len", [
    ("rwkv6-3b", 45, 64),            # S not a multiple of wkv_chunk 32
    ("recurrentgemma-2b", 90, 128),  # past the smoke window 64: ring roll
    ("rwkv6", 11, 32),
    ("rglru", 13, 32),               # past the tiny window 8
])
def test_forward_prefill_decode_match_jax(name, seq, max_len):
    jcfg, tcfg = _cfgs(name)
    w = _weights(jcfg)
    params = bridge.tree_to_torch(w)
    rng = np.random.default_rng(seq)
    toks = rng.integers(0, jcfg.vocab, size=(2, seq)).astype(np.int32)
    tt = torch.from_numpy(toks).long()

    lj = _jax_forward(jcfg, w, jnp.asarray(toks))
    lt = api.forward(tcfg, params, {"tokens": tt})
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)

    last_j, cache_j = _jax_prefill(jcfg, w, jnp.asarray(toks), max_len)
    last_t, cache_t = api.prefill(tcfg, params, {"tokens": tt}, max_len)
    np.testing.assert_allclose(last_t.numpy(), np.asarray(last_j), **TOL)
    # the cache the port built is the cache JAX built
    flat_j = jax.tree_util.tree_leaves(cache_j)
    flat_t = jax.tree_util.tree_leaves(cache_t)
    assert len(flat_j) == len(flat_t)
    for a, b in zip(flat_j, flat_t):
        np.testing.assert_allclose(b.float().numpy(), np.asarray(a, np.float32), **TOL)

    # decode steps from the same prefilled cache, the last with a per-slot
    # index vector (rows at different positions)
    for step in range(4):
        if step == 3:
            vec = np.asarray([seq + 3, seq + 1], np.int32)
            cache_j = dict(cache_j, index=jnp.asarray(vec))
            cache_t = dict(cache_t, index=torch.from_numpy(vec))
        nxt = rng.integers(0, jcfg.vocab, size=(2, 1)).astype(np.int32)
        dj, cache_j = _jax_decode(jcfg, w, jnp.asarray(nxt), cache_j)
        dt, cache_t = api.decode_step(tcfg, params, torch.from_numpy(nxt).long(),
                                      cache_t)
        np.testing.assert_allclose(dt.numpy(), np.asarray(dj), **TOL)
    assert np.asarray(cache_t["index"]).tolist() == np.asarray(cache_j["index"]).tolist()


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_continuation_matches_jax(arch):
    jcfg, tcfg = _cfgs(arch)
    w = _weights(jcfg, seed=1)
    params = bridge.tree_to_torch(w)
    prompt = np.random.default_rng(2).integers(0, jcfg.vocab, (1, 70)).astype(np.int32)
    last, cache = _jax_prefill(jcfg, w, jnp.asarray(prompt), 128)
    out_j = [int(jnp.argmax(last[0, -1]))]
    for _ in range(7):
        lg, cache = _jax_decode(jcfg, w, jnp.asarray([[out_j[-1]]], jnp.int32), cache)
        out_j.append(int(jnp.argmax(lg[0, -1])))
    last, cache = api.prefill(tcfg, params, {"tokens": torch.from_numpy(prompt).long()},
                              128)
    out_t = [int(last[0, -1].argmax())]
    for _ in range(7):
        lg, cache = api.decode_step(tcfg, params, torch.tensor([[out_t[-1]]]), cache)
        out_t.append(int(lg[0, -1].argmax()))
    assert out_t == out_j


# -- engine parity ---------------------------------------------------------------

ENGINE_CASES = {
    # 3 requests through 2 slots: the first slot to finish is refilled
    "churn": (dict(max_batch=2, max_len=32), (5, 9, 7), 5),
    # 3 slots decoding 2 at a time in slot-id rotation
    "rotation": (dict(max_batch=3, max_len=32, decode_batch=2), (4, 6, 8, 5), 6),
    # capacity 32: 31 fits one decode ("length"), 32 is rejected
    "boundary": (dict(max_batch=2, max_len=32), (31, 32, 6), 4),
}


def _run_both(jcfg, tcfg, w, prompts, max_new, eng_kw):
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


@pytest.mark.parametrize("case", list(ENGINE_CASES))
@pytest.mark.parametrize("family", list(TINY_CFGS))
def test_engine_matches_jax(family, case):
    jcfg, tcfg = _cfgs(family)
    eng_kw, lens, max_new = ENGINE_CASES[case]
    rng = np.random.default_rng(len(lens))
    prompts = [rng.integers(0, jcfg.vocab, size=n).astype(np.int32) for n in lens]
    jreqs, treqs, jeng, teng = _run_both(jcfg, tcfg, _weights(jcfg), prompts,
                                         max_new, eng_kw)
    assert teng.state.kind == "recurrent" and teng.compact and teng.pool is None
    assert [r.out_tokens for r in treqs] == [r.out_tokens for r in jreqs]
    assert [r.finish_reason for r in treqs] == [r.finish_reason for r in jreqs]
    for key in ("decode_steps", "prefills", "tokens_out", "preemptions",
                "rejected", "shed", "nan_steps"):
        assert teng.stats[key] == jeng.stats[key], key
    if case == "boundary":
        assert [r.finish_reason for r in treqs] == ["length", "rejected",
                                                    "max_new_tokens"]
    else:
        assert all(r.finish_reason == "max_new_tokens" for r in treqs)


@pytest.mark.parametrize("family", list(TINY_CFGS))
def test_nan_guard_matches_jax(family):
    jcfg, tcfg = _cfgs(family)
    bad = copy.deepcopy(_weights(jcfg))
    if family == "rwkv6":
        bad["final_norm"] = np.full_like(bad["final_norm"], np.nan)
    else:
        bad["final_norm"]["scale"] = np.full_like(bad["final_norm"]["scale"], np.nan)
    prompts = [np.arange(3 + i, dtype=np.int32) for i in range(2)]
    flags = []
    for eng, req_cls in ((JaxEngine(jcfg, bad, max_batch=2, max_len=32), JaxRequest),
                         (ServingEngine(tcfg, bridge.tree_to_torch(bad), max_batch=2,
                                        max_len=32, device="cpu"), Request)):
        reqs = [req_cls(rid=i, prompt=p, max_new_tokens=4) for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.run()
        flags.append((eng.health["nan_detected"], eng.stats["nan_steps"],
                      eng.stats["decode_steps"], [len(r.out_tokens) for r in reqs]))
    assert flags[0] == flags[1] == (True, 1, 0, [1, 1])


@pytest.mark.parametrize("family", list(TINY_CFGS))
def test_single_slot_engine_matches_two_slot_jax(family):
    """One slot: the port splices the prefilled state into slot 0 as it
    does any slot.  (The JAX state's splice finds no batch axis when
    max_batch is 1 and decodes from a zero state, so the reference here
    is the JAX engine with two slots, serving the same one request.)"""
    jcfg, tcfg = _cfgs(family)
    w = _weights(jcfg)
    prompt = np.arange(3, 9, dtype=np.int32)
    jeng = JaxEngine(jcfg, w, max_batch=2, max_len=32)
    jreq = JaxRequest(rid=0, prompt=prompt, max_new_tokens=5)
    jeng.submit(jreq)
    jeng.run()
    teng = ServingEngine(tcfg, bridge.tree_to_torch(w), max_batch=1, max_len=32,
                         device="cpu")
    treq = Request(rid=0, prompt=prompt, max_new_tokens=5)
    serve(teng, [treq])
    assert treq.out_tokens == jreq.out_tokens


def test_engine_state_choice():
    """The state follows the JAX engine's choice: recurrent for rwkv6,
    dense for an unpaged transformer, cross-attention for whisper (always
    compact, with an encoder window of max_len by default)."""
    cfg = configs.get_smoke_config("rwkv6-3b")
    params = api.init_params(cfg, 0, device="cpu")
    eng = ServingEngine(cfg, params, max_batch=2, max_len=16, compact=False,
                        device="cpu")
    assert eng.state.kind == "recurrent" and eng.compact and not eng.paged
    assert eng.capacity == 16 and eng.state.cache["index"].shape == (2,)
    tf = configs.get_smoke_config("smollm-135m")
    assert ServingEngine(tf, {}, paged=False, device="cpu").state.kind == "dense"
    eng = ServingEngine(tf.replace(family="whisper", name="whisper"), {},
                        max_batch=2, max_len=16, compact=False, device="cpu")
    assert eng.state.kind == "cross_attn" and eng.compact and not eng.paged
    assert eng.state.cache["layers"][0]["ck"].shape[:2] == (2, 16)


# -- serve CLI -------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_runs_recurrent_smoke_on_cpu(arch, capsys):
    serve_main(["--arch", arch, "--smoke", "--device", "cpu", "--requests", "3",
                "--max-new", "4"])
    out = capsys.readouterr().out
    assert "12 tokens" in out and "3 prefills" in out and "on cpu" in out

"""MoE, sliding-window ring and dense KV state of the PyTorch/CUDA port on
the CPU, against the JAX package on the same numpy inputs and the same
transferred weights:

* the plain `moe_mlp_ref` (the CPU path of the op and the oracle of the
  CUDA kernel `csrc/moe_mlp.cu`) against the JAX `moe_mlp_ref` and the
  Pallas op in interpret mode, on the JAX kernel test's cases (3e-4 in
  float32, 2e-2 in bfloat16);
* the capacity `moe_block`, with and without capacity drops, and with
  shared experts behind a dense first layer;
* mixtral-8x7b's smoke config (MoE, window 64) through forward, prefill
  (cache included) and decode past the window, at 1e-4;
* `DenseKVState` engines (compacted and full width; smollm with
  `paged=False`, mixtral smoke, and a full-width MoE engine whose
  capacity drops tokens): token streams, finish reasons and stats equal
  to the JAX engine's;
* `mlp_impl="fused"` against `"dense"` on the CPU (the same function).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.kernels.moe_mlp.ops import moe_mlp as jax_moe
from repro.kernels.moe_mlp.ref import moe_mlp_ref as jax_moe_ref
from repro.models import transformer as jax_tf
from repro.serving.engine import Request as JaxRequest
from repro.serving.engine import ServingEngine as JaxEngine
from repro_torch import bridge, configs
from repro_torch.kernels.moe_mlp import kernel as moe_kernel
from repro_torch.kernels.moe_mlp import ops as moe_ops
from repro_torch.kernels.moe_mlp.ref import moe_mlp_ref
from repro_torch.launch.serve import serve
from repro_torch.models import api, transformer
from repro_torch.serving.engine import Request, ServingEngine

ARCH = "mixtral-8x7b"
TOL = dict(rtol=1e-4, atol=1e-4)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}

_jax_forward = jax.jit(jax_tf.forward, static_argnums=(0,))
_jax_prefill = jax.jit(jax_tf.prefill, static_argnums=(0, 3))
_jax_decode = jax.jit(jax_tf.decode_step, static_argnums=(0,))
_jax_moe_block = jax.jit(jax_tf.moe_block, static_argnums=(0,))


def _cfgs(**kw):
    return (jax_configs.get_smoke_config(ARCH).replace(**kw),
            configs.get_smoke_config(ARCH).replace(**kw))


def _weights(jcfg, seed=0):
    return jax.tree.map(np.asarray, jax_tf.init_params(jcfg, jax.random.PRNGKey(seed)))


# -- the moe_mlp op -------------------------------------------------------------

@pytest.mark.parametrize("E,C,d,F,sw,dtype", [
    (4, 32, 64, 128, True, "float32"),
    (1, 100, 32, 200, False, "float32"),     # dense-MLP degenerate case
    (2, 16, 128, 96, True, "float32"),
    (2, 32, 64, 128, True, "bfloat16"),
])
def test_moe_mlp_ref_matches_jax(E, C, d, F, sw, dtype):
    rng = np.random.default_rng(E * C)
    arrs = [(rng.standard_normal(shape) * s).astype(np.float32)
            for shape, s in (((E, C, d), 0.5), ((E, d, F), 0.1), ((E, d, F), 0.1),
                             ((E, F, d), 0.1))]
    jdt, tdt = DTYPES[dtype]
    xj, gj, ij, oj = (jnp.asarray(a, jdt) for a in arrs)
    xt, gt, it, ot = (torch.from_numpy(a).to(tdt) for a in arrs)
    got = moe_mlp_ref(xt, gt if sw else None, it, ot, swiglu=sw)
    tol = 2e-2 if dtype == "bfloat16" else 3e-4
    for want in (jax_moe_ref(xj, gj, ij, oj, swiglu=sw),
                 jax_moe(xj, gj, ij, oj, swiglu=sw, bt=16, bf=64, interpret=True)):
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   rtol=tol, atol=tol)
    assert got.dtype == tdt
    torch.testing.assert_close(moe_ops.moe_mlp(xt, gt, it, ot, swiglu=sw), got,
                               rtol=0, atol=0)


def test_moe_mlp_cuda_wrapper_refuses_cpu_tensors():
    t = torch.zeros(2, 4, 8)
    with pytest.raises(ValueError, match="CUDA"):
        moe_kernel.moe_mlp_cuda(t, torch.zeros(2, 8, 6), torch.zeros(2, 8, 6),
                                torch.zeros(2, 6, 8))


# -- moe_block --------------------------------------------------------------------

def _load(tcfg, p, x):
    """Most (token, choice) entries any expert receives."""
    _, idx = transformer.route(tcfg, p, x.reshape(-1, x.shape[-1]))
    return int(torch.bincount(idx.reshape(-1), minlength=tcfg.n_experts).max())


@pytest.mark.parametrize("capacity_factor,drops", [(1.25, False), (0.5, True)],
                         ids=["no-drops", "drops"])
def test_moe_block_matches_jax(capacity_factor, drops):
    jcfg, tcfg = _cfgs(capacity_factor=capacity_factor)
    w = _weights(jcfg)
    pj = w["segments"][0]["kind_moe"]
    pj = jax.tree.map(lambda a: a[0], pj)["moe"]
    pt = bridge.tree_to_torch(pj)
    x = np.random.default_rng(4).standard_normal((2, 24, tcfg.d_model)).astype(np.float32)
    xt = torch.from_numpy(x)
    cap = transformer.capacity(tcfg, 48)
    assert (_load(tcfg, pt, xt) > cap) == drops
    got = transformer.moe_block(tcfg, pt, xt)
    want = _jax_moe_block(jcfg, pj, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_shared_experts_and_dense_first_layer_match_jax():
    """The deepseek-style MoE layout (one dense layer, then MoE layers with
    a shared expert) on a plain-attention config."""
    kw = dict(name="moe-shared", n_layers=3, d_model=64, n_heads=4, kv_heads=2,
              head_dim=16, d_ff=128, vocab=97, n_experts=4, top_k=2,
              n_shared_experts=1, first_dense_layers=1, moe_d_ff=48,
              dtype="float32", param_dtype="float32", scan_layers=False)
    jcfg = jax_configs.get_smoke_config("smollm-135m").__class__(**kw)
    tcfg = configs.get_smoke_config("smollm-135m").__class__(**kw)
    w = _weights(jcfg)
    assert [next(iter(s)) for s in w["segments"]] == ["kind_dense", "kind_moe"]
    assert "shared" in w["segments"][1]["kind_moe"]["moe"]
    toks = np.random.default_rng(5).integers(0, 97, size=(2, 11)).astype(np.int32)
    got = transformer.forward(tcfg, bridge.tree_to_torch(w), torch.from_numpy(toks).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(_jax_forward(jcfg, w, jnp.asarray(toks))),
                               **TOL)


# -- mixtral smoke: forward, ring prefill, decode past the window ------------------

def test_mixtral_init_tree_matches_jax():
    jcfg, tcfg = _cfgs()
    shapes_j = jax.tree.map(lambda a: tuple(a.shape), jax.eval_shape(
        lambda: jax_tf.init_params(jcfg, jax.random.PRNGKey(0))))
    shapes_t = jax.tree.map(lambda a: tuple(a.shape), api.init_params(tcfg, 0, device="cpu"))
    assert shapes_t == shapes_j
    assert shapes_t["segments"][0]["kind_moe"]["moe"]["experts_in"] == \
        (tcfg.n_layers, tcfg.n_experts, tcfg.d_model, tcfg.d_ff)
    assert dataclasses.asdict(configs.get_config(ARCH)) == \
        dataclasses.asdict(jax_configs.get_config(ARCH))


@pytest.mark.parametrize("plen", [40, 80], ids=["inside-window", "past-window"])
def test_mixtral_forward_prefill_decode_match_jax(plen):
    jcfg, tcfg = _cfgs()
    assert tcfg.window == 64
    w = _weights(jcfg)
    params = bridge.tree_to_torch(w)
    rng = np.random.default_rng(plen)
    toks = rng.integers(0, jcfg.vocab, size=(2, plen)).astype(np.int32)
    np.testing.assert_allclose(
        api.forward(tcfg, params, {"tokens": torch.from_numpy(toks).long()}).numpy(),
        np.asarray(_jax_forward(jcfg, w, jnp.asarray(toks))), **TOL)

    last_j, cache_j = _jax_prefill(jcfg, w, jnp.asarray(toks), 96)
    last_t, cache_t = api.prefill(tcfg, params, {"tokens": torch.from_numpy(toks).long()}, 96)
    np.testing.assert_allclose(last_t.numpy(), np.asarray(last_j), **TOL)
    assert cache_t["segments"][0]["k"].shape[2] == transformer.cache_len(tcfg, 96) == 64
    for key in ("k", "v"):
        np.testing.assert_allclose(cache_t["segments"][0][key].numpy(),
                                   np.asarray(cache_j["segments"][0][key]), **TOL)
    # per-slot lengths, then decode steps that move the ring past the window
    cache_j = dict(cache_j, index=jnp.asarray([plen, plen - 9], jnp.int32))
    cache_t["index"] = torch.tensor([plen, plen - 9], dtype=torch.int32)
    for _ in range(30):
        nxt = rng.integers(0, jcfg.vocab, size=(2, 1)).astype(np.int32)
        dj, cache_j = _jax_decode(jcfg, w, jnp.asarray(nxt), cache_j)
        dt, cache_t = api.decode_step(tcfg, params, torch.from_numpy(nxt).long(), cache_t)
        np.testing.assert_allclose(dt.numpy(), np.asarray(dj), **TOL)
    assert cache_t["index"].tolist() == [plen + 30, plen + 21]


def test_cache_positions_follow_the_ring():
    """Python-style remainder on negative differences: slot j holds the
    largest position p <= index with p % clen == j, or -1."""
    tcfg = configs.get_smoke_config(ARCH)
    idx = torch.tensor([3, 63, 64, 130])
    pos = transformer._cache_positions(tcfg, idx, 64)
    want = jax_tf._cache_positions(jax_configs.get_smoke_config(ARCH),
                                   jnp.asarray(idx.numpy()), 64)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(want))
    assert pos[0, :5].tolist() == [0, 1, 2, 3, -1]


def test_fused_mlp_impl_matches_dense_on_cpu():
    _, tcfg = _cfgs()
    params = api.init_params(tcfg, 0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(6).integers(0, tcfg.vocab, size=(2, 70)))
    dense = api.forward(tcfg, params, {"tokens": toks})
    fused = api.forward(tcfg.replace(mlp_impl="fused", norm_impl="fused",
                                     attn_impl="flash"), params, {"tokens": toks})
    torch.testing.assert_close(fused, dense, rtol=1e-5, atol=1e-5)


# -- DenseKVState engines ----------------------------------------------------------

def _serve_both(jcfg, tcfg, prompts, max_new, **kw):
    w = _weights(jcfg)
    jeng = JaxEngine(jcfg, w, **kw)
    jreqs = [JaxRequest(rid=i, prompt=p, max_new_tokens=max_new)
             for i, p in enumerate(prompts)]
    for r in jreqs:
        jeng.submit(r)
    jeng.run()
    teng = ServingEngine(tcfg, bridge.tree_to_torch(w), device="cpu", **kw)
    treqs = [Request(rid=i, prompt=p, max_new_tokens=max_new)
             for i, p in enumerate(prompts)]
    serve(teng, treqs)
    assert teng.state.kind == "dense" and not teng.paged
    assert [r.out_tokens for r in treqs] == [r.out_tokens for r in jreqs]
    assert [r.finish_reason for r in treqs] == [r.finish_reason for r in jreqs]
    for key in ("decode_steps", "prefills", "tokens_out", "preemptions",
                "rejected", "shed", "nan_steps"):
        assert teng.stats[key] == jeng.stats[key], key
    return treqs


def _prompts(vocab, lens, seed=8):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in lens]


@pytest.mark.parametrize("compact", [True, False], ids=["compact", "full"])
@pytest.mark.parametrize("arch", ["smollm-135m", ARCH])
def test_dense_state_engine_matches_jax(arch, compact):
    """Four slots decoding two at a time; mixtral's prompts and streams
    cross its 64-token window, a prompt past max_len is rejected and one
    that reaches the end of the cache finishes with "length" while other
    slots still decode (at full width its empty slot then sits at index
    max_len, where the JAX scatter drops the write)."""
    jcfg = jax_configs.get_smoke_config(arch)
    tcfg = configs.get_smoke_config(arch)
    reqs = _serve_both(jcfg, tcfg,
                       _prompts(jcfg.vocab, (9, 88, 70, 30, 58, 100, 5)),
                       12, max_batch=4, max_len=96, decode_batch=2,
                       compact=compact, paged=False)
    reasons = [r.finish_reason for r in reqs]
    assert reasons.count("rejected") == 1 and reasons.count("length") == 1


@pytest.mark.parametrize("slots", [8, 16])
def test_full_width_moe_engine_with_capacity_drops_matches_jax(slots, monkeypatch):
    """All slots at full width: empty and finished slots' tokens still go
    through the router and take capacity.  A capacity factor of 0.25
    makes prefills drop tokens; a decode step can drop only past 8 slots
    (an expert takes at most one entry a token, and the capacity floor is
    8), so the 16-slot engine drops in decode steps too."""
    jcfg, tcfg = _cfgs(capacity_factor=0.25)
    drops = {"prefill": 0, "decode": 0}
    real = transformer.route

    def counted(c, p, xf):
        w, idx = real(c, p, xf)
        load = int(torch.bincount(idx.reshape(-1), minlength=c.n_experts).max())
        if load > transformer.capacity(c, xf.shape[0]):
            drops["decode" if xf.shape[0] == slots else "prefill"] += 1
        return w, idx

    monkeypatch.setattr(transformer, "route", counted)
    lens = (6, 20, 11, 33, 8, 15, 27, 12, 9, 30, 17, 5, 24, 14, 19)[:slots - 1]
    reqs = _serve_both(jcfg, tcfg, _prompts(jcfg.vocab, lens, 9), 10,
                       max_batch=slots, decode_batch=slots, max_len=64)
    assert all(r.finish_reason == "max_new_tokens" for r in reqs)
    assert drops["prefill"] > 0
    assert (drops["decode"] > 0) == (slots > 8)


def test_dense_state_one_slot_engine_splices_on_the_batch_axis():
    """With one slot the JAX `_tree_set_slot` finds no batch axis and drops
    the prefilled cache; the port splices on the batch axis always, so its
    one-slot engine matches a two-slot JAX engine serving one request."""
    jcfg, tcfg = _cfgs()
    w = _weights(jcfg)
    prompt = _prompts(jcfg.vocab, (21,))[0]
    jeng = JaxEngine(jcfg, w, max_batch=2, max_len=64)
    jreq = JaxRequest(rid=0, prompt=prompt, max_new_tokens=6)
    jeng.submit(jreq)
    jeng.run()
    teng = ServingEngine(tcfg, bridge.tree_to_torch(w), max_batch=1, max_len=64,
                         device="cpu")
    treq = Request(rid=0, prompt=prompt, max_new_tokens=6)
    serve(teng, [treq])
    assert treq.out_tokens == jreq.out_tokens


def test_serve_cli_runs_mixtral_smoke_on_cpu(capsys):
    from repro_torch.launch.serve import main as serve_main
    serve_main(["--arch", ARCH, "--smoke", "--device", "cpu", "--requests", "3",
                "--max-new", "4"])
    out = capsys.readouterr().out
    assert "12 tokens" in out and "3 prefills" in out and "on cpu" in out

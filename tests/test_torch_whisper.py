"""Whisper (encoder-decoder, LayerNorm, cross-attention state) in the
PyTorch/CUDA port on the CPU against the JAX package, float32, on the
same transferred weights (outputs within 1e-4, greedy tokens equal), with
whisper-base's smoke config:

* `layernorm` against the JAX `layernorm`; LayerNorm on a transformer
  (`norm="layernorm"`) through forward;
* the init tree leaf for leaf; `encode`, `forward`, `prefill` (self and
  cross caches) and `decode_step` with a per-slot index vector;
* the engine over `CrossAttnState`: requests with frames (shorter and
  longer than the encoder window) and without, slot churn over two and
  three slots, against the JAX engine (which drops a prefill with one
  slot, so every engine here has two or more);
* a mixed fleet (one transformer replica, one whisper replica, requests
  tagged by model) against the JAX `ServingCluster`.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.models import api as jax_api
from repro.models import common as jax_common
from repro.models import transformer as jax_tf
from repro.models import whisper as jax_whisper
from repro.serving import cluster as jax_cluster
from repro.serving.engine import Request as JaxRequest
from repro.serving.engine import ServingEngine as JaxEngine
from repro_torch import bridge, configs
from repro_torch.launch.serve import serve
from repro_torch.models import api, transformer, whisper
from repro_torch.models.common import layernorm
from repro_torch.serving import cluster
from repro_torch.serving.engine import Request, ServingEngine

ARCH = "whisper-base"
TOL = dict(rtol=1e-4, atol=1e-4)


def _cfgs(arch=ARCH, **kw):
    return (jax_configs.get_smoke_config(arch).replace(**kw),
            configs.get_smoke_config(arch).replace(**kw))


@functools.lru_cache(maxsize=None)
def _weights(jcfg, seed=0):
    """JAX init_params as a numpy tree, drawn once a config (the bridge
    copies it, so no test writes into it)."""
    return jax.tree.map(np.asarray, jax.jit(jax_api.init_params, static_argnums=0)(
        jcfg, jax.random.PRNGKey(seed)))


def _close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("shape,dtype", [((3, 5, 64), np.float32), ((7, 128), np.float32),
                                         ((4, 96), "bfloat16")])
def test_layernorm_matches_jax(shape, dtype):
    rng = np.random.default_rng(len(shape))
    x = (3.0 * rng.standard_normal(shape) + 1.0).astype(np.float32)
    scale = rng.standard_normal(shape[-1]).astype(np.float32)
    bias = rng.standard_normal(shape[-1]).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype is np.float32 else \
        (jnp.bfloat16, torch.bfloat16)
    want = jax_common.layernorm(jnp.asarray(x, jdt), jnp.asarray(scale, jdt),
                                jnp.asarray(bias, jdt))
    got = layernorm(torch.from_numpy(x).to(tdt), torch.from_numpy(scale).to(tdt),
                    torch.from_numpy(bias).to(tdt))
    assert got.dtype == tdt
    tol = 1e-5 if dtype is np.float32 else 1e-2
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def test_layernorm_transformer_matches_jax():
    """A transformer with norm="layernorm" (unit scale, zero bias at init;
    the fused flag has no LayerNorm kernel, as in JAX)."""
    jcfg, tcfg = _cfgs("smollm-135m", norm="layernorm", norm_impl="fused")
    w = _weights(jcfg)
    assert set(w["final_norm"]) == {"scale", "bias"}
    toks = np.random.default_rng(2).integers(0, jcfg.vocab, size=(2, 12)).astype(np.int32)
    _close(transformer.forward(tcfg, bridge.tree_to_torch(w), torch.from_numpy(toks).long()),
           jax_tf.forward(jcfg, w, jnp.asarray(toks)))


def test_init_tree_matches_jax():
    jcfg, tcfg = _cfgs()
    shapes_j = jax.tree.map(lambda a: tuple(a.shape), jax.eval_shape(
        lambda: jax_api.init_params(jcfg, jax.random.PRNGKey(0))))
    p = api.init_params(tcfg, 0, device="cpu")
    assert bridge.tree_map(lambda t: tuple(t.shape), p) == shapes_j
    assert p["dec_pos"].shape == (whisper.MAX_POS, tcfg.d_model)
    assert float(p["enc_ln"]["scale"].min()) == 1.0


def test_encode_prefill_decode_match_jax():
    """Two rows of 40 frames and 7 prompt tokens; then decode steps with
    a per-slot index vector of different lengths, as the engine runs it."""
    jcfg, tcfg = _cfgs()
    w = _weights(jcfg)
    params = bridge.tree_to_torch(w)
    rng = np.random.default_rng(0)
    frames = rng.standard_normal((2, 40, jcfg.d_model)).astype(np.float32)
    toks = rng.integers(0, jcfg.vocab, size=(2, 7)).astype(np.int32)
    fj, ft = jnp.asarray(frames), torch.from_numpy(frames)
    _close(whisper.encode(tcfg, params, ft), jax_whisper.encode(jcfg, w, fj))
    _close(api.forward(tcfg, params, {"embeds": ft, "tokens": torch.from_numpy(toks).long()}),
           jax_api.forward(jcfg, w, {"embeds": fj, "tokens": jnp.asarray(toks)}))
    lj, cj = jax_whisper.prefill(jcfg, w, fj, jnp.asarray(toks), 24)
    lt, ct = whisper.prefill(tcfg, params, ft, torch.from_numpy(toks).long(), 24)
    _close(lt, lj)
    for lcj, lct in zip(cj["layers"], ct["layers"]):
        for key in ("k", "v", "ck", "cv"):
            _close(lct[key], lcj[key])
    # per-slot lengths: slot 1 is two positions behind slot 0
    cj["index"] = jnp.asarray([7, 5], jnp.int32)
    ct["index"] = torch.tensor([7, 5], dtype=torch.int32)
    nxt = np.asarray(lj)[:, -1].argmax(-1)[:, None].astype(np.int32)
    for _ in range(4):
        lj, cj = jax_whisper.decode_step(jcfg, w, jnp.asarray(nxt), cj)
        lt, ct = whisper.decode_step(tcfg, params, torch.from_numpy(nxt).long(), ct)
        _close(lt, lj)
        nxt = np.asarray(lj)[:, -1].argmax(-1)[:, None].astype(np.int32)
    assert ct["index"].tolist() == [11, 9]
    for lcj, lct in zip(cj["layers"], ct["layers"]):
        _close(lct["k"], lcj["k"])


def _requests(mod, vocab, d, specs, max_new, seed=3):
    """Requests from (prompt length, frame count or 0 for None) pairs."""
    rng = np.random.default_rng(seed)
    out = []
    for i, (plen, nf) in enumerate(specs):
        frames = rng.standard_normal((nf, d)).astype(np.float32) if nf else None
        out.append(mod(rid=i, prompt=rng.integers(0, vocab, size=plen).astype(np.int32),
                       max_new_tokens=max_new, frames=frames))
    return out


@pytest.mark.parametrize("slots,decode_batch", [(2, 2), (3, 2)])
def test_engine_matches_jax(slots, decode_batch):
    """Frames shorter than the 32-frame window (zero-padded), longer
    (truncated) and absent (a zero window), over fewer slots than
    requests; a prompt that leaves no room to decode is rejected."""
    jcfg, tcfg = _cfgs()
    w = _weights(jcfg)
    specs = ((5, 20), (9, 0), (4, 50), (12, 32), (7, 0), (40, 10))
    kw = dict(max_batch=slots, decode_batch=decode_batch, max_len=32, enc_len=32)
    jeng = JaxEngine(jcfg, w, **kw)
    jreqs = _requests(JaxRequest, jcfg.vocab, jcfg.d_model, specs, 6)
    for r in jreqs:
        jeng.submit(r)
    jeng.run()
    teng = ServingEngine(tcfg, bridge.tree_to_torch(w), device="cpu", **kw)
    treqs = _requests(Request, tcfg.vocab, tcfg.d_model, specs, 6)
    serve(teng, treqs)
    assert teng.state.kind == "cross_attn" and teng.compact
    assert teng.cache["layers"][0]["ck"].shape == (slots, 32, 4, 32)
    assert [r.out_tokens for r in treqs] == [r.out_tokens for r in jreqs]
    assert [r.finish_reason for r in treqs] == [r.finish_reason for r in jreqs]
    assert [r.finish_reason for r in treqs].count("rejected") == 1
    for key in ("decode_steps", "prefills", "tokens_out", "rejected"):
        assert teng.stats[key] == jeng.stats[key], key


def test_enc_len_defaults_to_max_len():
    _, tcfg = _cfgs()
    eng = ServingEngine(tcfg, {}, max_batch=2, max_len=24, device="cpu")
    assert eng.state.enc_len == 24
    assert eng.cache["layers"][0]["cv"].shape[1] == 24


def test_mixed_fleet_with_a_whisper_replica_matches_jax():
    """One smollm replica and one whisper replica on one `enc_len`;
    requests tagged by model (whisper's with frames) go to their
    replica, and every stream equals the JAX cluster's."""
    names = ("smollm-135m", ARCH)
    jcfgs = [jax_configs.get_smoke_config(n) for n in names]
    tcfgs = [configs.get_smoke_config(n) for n in names]
    wts = [_weights(c) for c in jcfgs]
    out = []
    for port in (True, False):
        cfgs = tcfgs if port else jcfgs
        params = [bridge.tree_to_torch(w) for w in wts] if port else wts
        req = Request if port else JaxRequest
        reqs = []
        for j, c in enumerate(cfgs):
            for r in _requests(req, c.vocab, c.d_model,
                               ((6, 12 * j), (3, 0), (8, 30 * j)), 5, seed=j):
                r.rid, r.model = len(reqs), c.name
                if c.family != "whisper":
                    r.frames = None
                reqs.append(r)
        kw = dict(max_batch=2, max_len=32, enc_len=24, paged=False)
        if port:
            kw["device"] = "cpu"
        mod = cluster if port else jax_cluster
        cl = mod.ServingCluster(cfgs[0], params[0],
                                replica_models=list(zip(cfgs, params)), **kw)
        for r in reqs:
            cl.submit(r)
        cl.run()
        for r in reqs:
            assert cl.replicas[cl.assignment[r.rid]].mcfg.name == r.model
        out.append([(r.rid, r.model, r.out_tokens, r.finish_reason) for r in reqs])
    assert out[0] == out[1]
    assert all(reason == "max_new_tokens" for *_, reason in out[0])


def test_serve_cli_runs_whisper_smoke_on_cpu(capsys):
    from repro_torch.launch.serve import main as serve_main
    serve_main(["--arch", ARCH, "--smoke", "--device", "cpu", "--requests", "3",
                "--max-new", "4"])
    out = capsys.readouterr().out
    assert "12 tokens" in out and "3 prefills" in out and "on cpu" in out


"""Paged decode attention of the PyTorch/CUDA port on the CPU: the plain
`paged_decode_attention_ref` (the CPU path of the op, and the oracle of
the CUDA kernel `csrc/paged_decode.cu`) against the JAX reference and
the JAX Pallas op in interpret mode; garbage in the null page and past
the slot lengths never leaking into the output; and the decode route
that attends straight from the page pool (`attn_impl="flash"`) against
the gather -> decode_step -> scatter route it replaces and against the
JAX paged engine, on the same transferred weights.  Float32 throughout:
the op at 2e-5 (the JAX kernel test's tolerance), engine logits at 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import paged_decode_attention as jax_paged
from repro.kernels.flash_attention.ref import \
    paged_decode_attention_ref as jax_paged_ref
from repro import configs as jax_configs
from repro.models import api as jax_api
from repro.serving.engine import Request as JaxRequest
from repro.serving.engine import ServingEngine as JaxEngine
from repro_torch import bridge, configs
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import paged_decode_attention_ref
from repro_torch.launch.serve import serve
from repro_torch.models import transformer
from repro_torch.serving import paged
from repro_torch.serving.engine import Request, ServingEngine

ARCH = "smollm-135m"                # its smoke config: float32, 4 layers
POOL = dict(attn_impl="flash")      # decode from the pool
GATHER = dict(attn_impl="einsum")   # gather -> decode_step -> scatter


def _tables(rng, bsz, npp, pages, ps, lens):
    tables = np.zeros((bsz, npp), np.int32)
    perm = rng.permutation(np.arange(1, pages))
    off = 0
    for b in range(bsz):
        n = -(-int(lens[b]) // ps)
        tables[b, :n] = perm[off:off + n]
        off += n
    return tables


@pytest.mark.parametrize("group", [1, 4])
def test_paged_decode_ref_matches_jax(group):
    """The shapes of the JAX package's paged kernel test."""
    rng = np.random.default_rng(29)
    bsz, hkv, hd, pages, ps, npp = 4, 2, 16, 11, 8, 4
    h = hkv * group
    q = rng.normal(size=(bsz, 1, h, hd)).astype(np.float32)
    kp = rng.normal(size=(pages, ps, hkv, hd)).astype(np.float32)
    vp = rng.normal(size=(pages, ps, hkv, hd)).astype(np.float32)
    lens = np.asarray([5, 8, 17, 30], np.int32)
    tables = _tables(rng, bsz, npp, pages, ps, lens)
    args_t = [torch.from_numpy(a) for a in (q, kp, vp, tables, lens)]
    got = paged_decode_attention_ref(*args_t)
    args_j = [jnp.asarray(a) for a in (q, kp, vp, tables, lens)]
    for want in (jax_paged_ref(*args_j), jax_paged(*args_j, interpret=True)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                                   atol=2e-5)
    torch.testing.assert_close(flash_ops.paged_decode_attention(*args_t), got,
                               rtol=0, atol=0)


def test_paged_decode_ignores_null_and_stale_pages():
    """Poisoning the null page and the positions past each slot's length
    leaves the result unchanged, in the port and in JAX alike."""
    rng = np.random.default_rng(31)
    bsz, h, hd, pages, ps = 2, 2, 8, 6, 4
    q = rng.normal(size=(bsz, 1, h, hd)).astype(np.float32)
    kp = rng.normal(size=(pages, ps, h, hd)).astype(np.float32)
    vp = rng.normal(size=(pages, ps, h, hd)).astype(np.float32)
    tables = np.asarray([[1, 2, 0], [3, 0, 0]], np.int32)
    lens = np.asarray([6, 3], np.int32)
    base = flash_ops.paged_decode_attention(
        *[torch.from_numpy(a) for a in (q, kp, vp, tables, lens)])
    kp2, vp2 = kp.copy(), vp.copy()
    kp2[0], vp2[0] = 1e6, 1e6             # null page
    kp2[2, 2:], vp2[2, 2:] = -1e6, -1e6   # positions 6, 7 of slot 0
    kp2[3, 3:], vp2[3, 3:] = 1e6, -1e6    # position 3 of slot 1
    got = flash_ops.paged_decode_attention(
        *[torch.from_numpy(a) for a in (q, kp2, vp2, tables, lens)])
    torch.testing.assert_close(got, base, rtol=0, atol=0)
    want = jax_paged(*[jnp.asarray(a) for a in (q, kp2, vp2, tables, lens)],
                     interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_paged_decode_cuda_wrapper_refuses_cpu_tensors():
    t = torch.zeros(2, 1, 4, 32)
    with pytest.raises(ValueError, match="CUDA"):
        flash_kernel.paged_decode_attention_cuda(
            t, torch.zeros(3, 4, 2, 32), torch.zeros(3, 4, 2, 32),
            torch.zeros(2, 2, dtype=torch.int32),
            torch.ones(2, dtype=torch.int32))


# -- the pool route against the gather route -----------------------------------

def _weights(seed=0):
    jcfg = jax_configs.get_smoke_config(ARCH)
    return jax.tree.map(np.asarray, jax_api.init_params(jcfg, jax.random.PRNGKey(seed)))


def _prefilled_pool(cfg, params, prompts, page_size=4):
    pool = paged.PagePool(cfg, len(prompts), 48, page_size=page_size)
    for b, p in enumerate(prompts):
        plen = len(p)
        bucket = paged.bucket_for(plen, paged.prefill_buckets(48, 8))
        assert pool.ensure(b, plen + 8)
        toks = np.zeros((1, bucket), np.int64)
        toks[0, :plen] = p
        paged.paged_prefill(cfg, params, torch.from_numpy(toks), plen,
                            pool.segments, pool.table_row(b, bucket // page_size),
                            page_size)
        pool.index[b] = plen
    return pool


def test_pool_route_matches_gather_route_logits():
    """Three decode steps of smoke smollm over the same pool by both
    routes, with a compacted selection whose padding lane repeats a slot:
    logits within 1e-5 and the pools end equal."""
    w = _weights()
    params = bridge.tree_to_torch(w)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 512, size=n).astype(np.int32) for n in (5, 13, 9)]
    toks = rng.integers(0, 512, size=(3, 3, 1))
    sel = np.asarray([2, 0, 2])               # lane 2 pads with slot 2
    runs = {}
    for name, impl in (("pool", POOL), ("gather", GATHER)):
        cfg = configs.get_smoke_config(ARCH).replace(**impl)
        pool = _prefilled_pool(configs.get_smoke_config(ARCH), params, prompts)
        logits = []
        for step in range(3):
            logits.append(paged.paged_decode(
                cfg, params, torch.from_numpy(toks[step][sel]), pool.segments,
                pool.tables[sel], pool.index[sel]))
            pool.index[[0, 2]] += 1
        runs[name] = (torch.stack(logits), pool.segments)
    lp, pools_p = runs["pool"]
    lg, pools_g = runs["gather"]
    torch.testing.assert_close(lp, lg, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(lp[:, 0], lp[:, 2], rtol=0, atol=0)
    for a, b in zip(pools_p, pools_g):
        for key in ("k", "v"):
            torch.testing.assert_close(a[key], b[key], rtol=1e-6, atol=1e-6)


def test_pool_route_calls_the_paged_op_once_per_layer(monkeypatch):
    calls = []
    real = flash_ops.paged_decode_attention

    def counted(*a):
        calls.append(a[1].shape)
        return real(*a)

    monkeypatch.setattr(transformer.fops, "paged_decode_attention", counted)
    cfg = configs.get_smoke_config(ARCH).replace(**POOL)
    params = bridge.tree_to_torch(_weights())
    pool = _prefilled_pool(cfg, params, [np.arange(7, dtype=np.int32)])
    paged.paged_decode(cfg, params, torch.tensor([[3]]), pool.segments,
                       pool.tables[[0]], pool.index[[0]])
    assert len(calls) == cfg.n_layers


def _prompts():
    rng = np.random.default_rng(7)
    return [rng.integers(0, 512, size=int(n)).astype(np.int32)
            for n in rng.integers(3, 30, size=6)]


@pytest.mark.parametrize("compact", [True, False], ids=["compact", "full"])
def test_pool_route_engine_matches_gather_route_and_jax(compact):
    """Greedy streams of the pool-route engine equal the gather-route
    engine's and the JAX paged engine's, with churn over four slots."""
    w = _weights()
    kw = dict(max_batch=4, max_len=48, decode_batch=2, compact=compact,
              page_size=4)
    jeng = JaxEngine(jax_configs.get_smoke_config(ARCH), w, paged=True, **kw)
    jreqs = [JaxRequest(rid=i, prompt=p, max_new_tokens=7)
             for i, p in enumerate(_prompts())]
    for r in jreqs:
        jeng.submit(r)
    jeng.run()
    streams = {}
    for name, impl in (("pool", POOL), ("gather", GATHER)):
        cfg = configs.get_smoke_config(ARCH).replace(**impl)
        eng = ServingEngine(cfg, bridge.tree_to_torch(w), device="cpu", **kw)
        reqs = [Request(rid=i, prompt=p, max_new_tokens=7)
                for i, p in enumerate(_prompts())]
        serve(eng, reqs)
        streams[name] = [r.out_tokens for r in reqs]
        assert [r.finish_reason for r in reqs] == \
            [r.finish_reason for r in jreqs]
        for key in ("decode_steps", "prefills", "tokens_out", "preemptions"):
            assert eng.stats[key] == jeng.stats[key], key
    assert streams["pool"] == streams["gather"] == \
        [r.out_tokens for r in jreqs]

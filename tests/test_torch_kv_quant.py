"""int8 KV of the PyTorch/CUDA port on the CPU, against the JAX package.

* `repro_torch.serving.quant` against `repro.serving.quant` on the same
  seed-made numpy blocks: codes and scales equal (float32 and bfloat16
  inputs, both the pool's and the gathered block's position axis);
  `kv_page_nbytes` / `pages_for_byte_budget` equal for smollm-135m.
* The requantization fixed point the pool route rests on: an unchanged
  page requantizes to its own codes and scales, round after round.
* `paged_decode_attention_int8`'s plain version against a dense float32
  decode over the dequantized cache (the JAX gather route's math).
* The port's engine with `kv_quant=True` (paged: compact and full width,
  the plain gather route and the `flash` pool route, a small pool that
  forces preemption) and with `kv_quant="dense", paged=False`, against
  the JAX engine on the same weights in float32: equal greedy tokens,
  finish reasons and stats, and the final int8 pool (pages past the null
  page) within one code and a relative 1e-5 on the scales.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.models import api as jax_api
from repro.models.config import ModelConfig as JaxConfig
from repro.serving import paged as jax_paged
from repro.serving import quant as jax_quant
from repro.serving import workload as jax_workload
from repro.serving.engine import Request as JaxRequest
from repro.serving.engine import ServingEngine as JaxEngine
from repro_torch import bridge, configs
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.launch.serve import serve
from repro_torch.models.config import ModelConfig
from repro_torch.serving import paged, quant
from repro_torch.serving.engine import Request, ServingEngine, _kv_quant_mode

GOLDEN_KW = dict(name="golden", n_layers=2, d_model=64, n_heads=4, kv_heads=2,
                 head_dim=16, d_ff=128, vocab=97, dtype="float32",
                 param_dtype="float32", scan_layers=False)
KERNEL_IMPLS = dict(attn_impl="flash", mlp_impl="fused", norm_impl="fused")
# scales: the absmax / 127 of k and v that each framework computes in
# float32 with its own matmul sum order (after a preemption, ~20 steps:
# 1.3e-6 apart measured); the quantization itself agrees bit for bit
# (test_quantize_matches_jax)
SCALE_RTOL = 1e-5
CODE_ATOL = 1           # codes: a round(x / s) on a .5 boundary may differ


def _block(seed, shape, dtype=np.float32):
    return (np.random.default_rng(seed).standard_normal(shape) * 0.7).astype(dtype)


# -- quant.py against repro.serving.quant --------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,ps_axis", [((2, 5, 16, 3, 8), 2),
                                           ((2, 3, 4, 16, 3, 8), 3),
                                           ((2, 4, 40, 3, 8), 2)])
def test_quantize_matches_jax(dtype, shape, ps_axis):
    x = _block(0, shape)
    x[0, 1] = 0.0                                 # an all-zero page: the floor
    jx = jnp.asarray(x, dtype=dtype)
    tx = bridge.array_to_tensor(np.asarray(jx.astype(jnp.float32)), "cpu").to(
        getattr(torch, dtype))
    jq, js = jax_quant.quantize_block(jx, ps_axis)
    tq, ts = quant.quantize_block(tx, ps_axis)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    for dt in (torch.float32, torch.bfloat16):
        jd = jax_quant.dequantize_block(jq, js, getattr(jnp, str(dt)[6:]))
        td = quant.dequantize_block(tq, ts, dt)
        np.testing.assert_array_equal(td.float().numpy(),
                                      np.asarray(jd.astype(jnp.float32)))


def test_scale_struct_matches_jax():
    segs = [{"k": torch.zeros((3, 7, 16, 2, 8), dtype=torch.int8),
             "v": torch.zeros((3, 7, 16, 2, 8), dtype=torch.int8)}]
    jsegs = [{"k": jnp.zeros((3, 7, 16, 2, 8), jnp.int8),
              "v": jnp.zeros((3, 7, 16, 2, 8), jnp.int8)}]
    got = quant.scale_struct(segs)
    want = jax_quant.scale_struct(jsegs)
    assert [{k: tuple(t.shape) for k, t in s.items()} for s in got] == \
        [{k: tuple(a.shape) for k, a in s.items()} for s in want]
    assert got[0]["k"].dtype == torch.float32


@pytest.mark.parametrize("arch", ["smollm-135m", "internlm2-1.8b"])
@pytest.mark.parametrize("page_size", [16, 32])
def test_page_bytes_match_jax(arch, page_size):
    jcfg, tcfg = jax_configs.get_config(arch), configs.get_config(arch)
    for q in (False, True):
        assert quant.kv_page_nbytes(tcfg, page_size, q) == \
            jax_quant.kv_page_nbytes(jcfg, page_size, q)
        for budget in (1 << 20, 3 << 30):
            assert quant.pages_for_byte_budget(tcfg, budget, page_size, q) == \
                jax_quant.pages_for_byte_budget(jcfg, budget, page_size, q)


def test_int8_pages_per_byte_against_bf16():
    """smollm-135m, pages of 16: an int8 page (scales included) costs a
    little over half a bfloat16 one."""
    cfg = configs.get_config("smollm-135m")
    ratio = quant.kv_page_nbytes(cfg, 16, False) / quant.kv_page_nbytes(cfg, 16, True)
    assert 1.98 < ratio < 2.0
    budget = 1 << 30
    assert quant.pages_for_byte_budget(cfg, budget, 16, True) / \
        quant.pages_for_byte_budget(cfg, budget, 16, False) == pytest.approx(ratio, rel=1e-3)


@pytest.mark.parametrize("layout", ["pages", "dense"])
def test_requantize_matches_jax(layout):
    """The one zero-then-quantize rule: the gather route's page scatter
    (pages of 4 out of an (L, n, C, Hkv, hd) sub-cache, positions at or
    past each lane's new length zeroed) against the JAX
    `_scatter_pages_quant`, and a dense rectangle (one scale a lane and
    head) against the JAX `jnp.where` then `quantize_block`, bit for bit.
    Every lane's dead positions hold values that would set its scale."""
    L, n, npp, ps, hkv, hd = 2, 3, 3, 4, 2, 8
    dense = _block(6, (L, n, npp * ps, hkv, hd)) * 3.0
    new_len = np.array([5, 12, 1], np.int32)
    live = np.arange(npp * ps)[None, :] < new_len[:, None]
    dense[:, ~live] *= 10.0
    tlen = torch.from_numpy(new_len).long()
    if layout == "dense":
        want = jax_quant.quantize_block(
            jnp.where(live[None, :, :, None, None], jnp.asarray(dense), 0), 2)
        got = quant.requantize(torch.from_numpy(dense), tlen, 2)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        return
    tables = np.array([[1, 2, 3], [4, 5, 6], [7, 0, 0]], np.int32)
    pool = np.zeros((L, 8, ps, hkv, hd), np.int8)
    scales = np.zeros((L, 8, 1, hkv, 1), np.float32)
    jsegs, jsc = jax_paged._scatter_pages_quant(
        [{"k": jnp.asarray(pool)}], [{"k": jnp.asarray(scales)}],
        [{"k": jnp.asarray(dense)}], jnp.asarray(tables), jnp.asarray(new_len))
    tsegs, tsc = [{"k": torch.from_numpy(pool)}], [{"k": torch.from_numpy(scales)}]
    paged._scatter_pages_quant(tsegs, tsc, [{"k": torch.from_numpy(dense)}],
                               torch.from_numpy(tables).long(), tlen)
    np.testing.assert_array_equal(tsegs[0]["k"].numpy(), np.asarray(jsegs[0]["k"]))
    np.testing.assert_array_equal(tsc[0]["k"].numpy(), np.asarray(jsc[0]["k"]))


# -- the requantization fixed point ---------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_unchanged_pages_requantize_to_themselves(dtype):
    """Codes and scales of 1,200 (page, head) blocks survive 50 rounds of
    dequantize (to float32, as the decode step gathers) and requantize."""
    x = torch.from_numpy(_block(3, (2, 50, 16, 12, 64))).to(dtype)
    q0, s0 = quant.quantize_block(x, 2)
    q, s = q0, s0
    for _ in range(50):
        q, s = quant.quantize_block(quant.dequantize_block(q, s), 2)
    assert torch.equal(q, q0) and torch.equal(s, s0)


def test_requantize_page_touches_only_the_written_page():
    """`_requantize_page` writes the token at its offset, zeroes the
    positions past it and leaves every other page's bits as they were."""
    codes, scales = quant.quantize_block(torch.from_numpy(_block(4, (6, 8, 2, 16))), 1)
    before_c, before_s = codes.clone(), scales.clone()
    pages, offs = torch.tensor([3, 3]), torch.tensor([2, 2])      # a padding lane
    new = torch.from_numpy(_block(5, (1, 2, 16))).repeat(2, 1, 1)
    paged._requantize_page(codes, scales, pages, offs, new)
    others = [p for p in range(6) if p != 3]
    assert torch.equal(codes[others], before_c[others])
    assert torch.equal(scales[others], before_s[others])
    page = quant.dequantize_block(codes[3], scales[3])
    assert torch.all(codes[3, 3:] == 0)
    torch.testing.assert_close(page[2], new[0], atol=float(scales[3].max()) / 2 + 1e-7,
                               rtol=0)
    torch.testing.assert_close(page[:2], quant.dequantize_block(before_c[3], before_s[3])[:2],
                               atol=float(scales[3].max()) / 2 + 1e-7, rtol=0)


# -- the int8 decode op's plain version --------------------------------------------

def test_int8_decode_ref_matches_dense_attention():
    """Against the dense float32 decode over the dequantized pages with the
    current token's k/v written unquantized (the JAX gather route)."""
    rng = np.random.default_rng(6)
    b, h, hkv, hd, ps, npp = 3, 8, 2, 16, 4, 5
    n_pages = 1 + b * npp
    kq = torch.from_numpy(rng.integers(-127, 128, (n_pages, ps, hkv, hd)).astype(np.int8))
    vq = torch.from_numpy(rng.integers(-127, 128, (n_pages, ps, hkv, hd)).astype(np.int8))
    ks = torch.from_numpy(rng.uniform(1e-3, 2e-2, (n_pages, 1, hkv, 1)).astype(np.float32))
    vs = torch.from_numpy(rng.uniform(1e-3, 2e-2, (n_pages, 1, hkv, 1)).astype(np.float32))
    tables = torch.arange(1, n_pages, dtype=torch.int32).reshape(b, npp)
    lengths = torch.tensor([1, 7, 20], dtype=torch.int32)
    q = torch.from_numpy(rng.standard_normal((b, 1, h, hd)).astype(np.float32))
    kn = torch.from_numpy(rng.standard_normal((b, hkv, hd)).astype(np.float32))
    vn = torch.from_numpy(rng.standard_normal((b, hkv, hd)).astype(np.float32))
    got = fops.paged_decode_attention_int8(q, kq, vq, ks, vs, tables, lengths, kn, vn)
    for i in range(b):
        n = int(lengths[i])
        pages = tables[i].long()
        kd = (kq[pages].float() * ks[pages]).reshape(npp * ps, hkv, hd)[:n].clone()
        vd = (vq[pages].float() * vs[pages]).reshape(npp * ps, hkv, hd)[:n].clone()
        kd[n - 1], vd[n - 1] = kn[i], vn[i]
        kr = kd.repeat_interleave(h // hkv, 1)
        vr = vd.repeat_interleave(h // hkv, 1)
        p = torch.softmax(torch.einsum("hd,chd->hc", q[i, 0], kr) / hd ** 0.5, -1)
        torch.testing.assert_close(got[i, 0], torch.einsum("hc,chd->hd", p, vr),
                                   rtol=1e-5, atol=1e-6)


# -- engines against the JAX engine -------------------------------------------------

def test_kv_quant_mode_resolution():
    tcfg = ModelConfig(**GOLDEN_KW)
    wcfg = tcfg.replace(window=8)
    assert [_kv_quant_mode(v, True, tcfg) for v in (False, True, "1", "dense", "0", None)] \
        == ["", "paged", "paged", "paged", "", ""]
    assert [_kv_quant_mode(v, False, tcfg) for v in (True, "dense")] == ["", "dense"]
    assert _kv_quant_mode("dense", False, wcfg) == ""


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 97, size=int(n)).astype(np.int32) for n in lens]


def _run_both(jcfg, tcfg, prompts, max_new, **eng_kw):
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


def _assert_same_int8(jtrees, ttrees, first_page=0):
    """Codes within CODE_ATOL and scales within SCALE_RTOL, leaf by leaf;
    `first_page` 1 leaves out the never-read null page of a pool."""
    for jseg, tseg in zip(jtrees, ttrees):
        for key in ("k", "v"):
            got = tseg[key].numpy()[:, first_page:].astype(np.float64)
            want = np.asarray(jseg[key])[:, first_page:].astype(np.float64)
            if tseg[key].dtype == torch.int8:
                assert np.abs(got - want).max() <= CODE_ATOL, key
            else:
                np.testing.assert_allclose(got, want, rtol=SCALE_RTOL, atol=0)


@pytest.mark.parametrize("compact", [True, False], ids=["compact", "full"])
@pytest.mark.parametrize("impls", [{}, KERNEL_IMPLS], ids=["gather", "pool"])
def test_paged_int8_engine_matches_jax(compact, impls):
    jcfg = JaxConfig(**GOLDEN_KW).replace(**impls)
    tcfg = ModelConfig(**GOLDEN_KW).replace(**impls)
    jreqs, treqs, jeng, teng = _run_both(
        jcfg, tcfg, _prompts(7, (3, 8, 5, 17, 4, 6)), 10, max_batch=4,
        max_len=40, paged=True, compact=compact, decode_batch=2, kv_quant=True)
    assert teng.kv_quant_mode == "paged" and jeng.kv_quant
    _assert_same(jreqs, treqs, jeng, teng)
    assert teng.pool.segments[0]["k"].dtype == torch.int8
    _assert_same_int8(jeng.pool.segments, teng.pool.segments, first_page=1)
    _assert_same_int8(jeng.pool.scales, teng.pool.scales, first_page=1)


def test_paged_int8_preemption_matches_jax():
    """Seven pages for three slots: preemption and resume by re-prefill
    over the int8 pool, on the pool route."""
    jcfg = JaxConfig(**GOLDEN_KW).replace(**KERNEL_IMPLS)
    tcfg = ModelConfig(**GOLDEN_KW).replace(**KERNEL_IMPLS)
    jreqs, treqs, jeng, teng = _run_both(
        jcfg, tcfg, _prompts(5, (14, 18, 9, 22, 12)), 16, max_batch=3,
        max_len=48, num_pages=7, kv_quant=True)
    _assert_same(jreqs, treqs, jeng, teng)
    assert teng.stats["preemptions"] > 0
    assert teng.pool.stats == jeng.pool.stats
    _assert_same_int8(jeng.pool.scales, teng.pool.scales, first_page=1)


def test_zipf_trace_on_the_int8_pool_matches_jax():
    """smollm-135m's smoke config over a Zipf trace that crosses the 16 /
    32 / 64 buckets, int8 pool route."""
    jcfg = jax_configs.get_smoke_config("smollm-135m").replace(
        dtype="float32", param_dtype="float32", **KERNEL_IMPLS)
    tcfg = configs.get_smoke_config("smollm-135m").replace(
        dtype="float32", param_dtype="float32", **KERNEL_IMPLS)
    reqs = jax_workload.zipf_mix_requests(np.random.default_rng(11), 8, jcfg.vocab)
    jreqs, treqs, jeng, teng = _run_both(jcfg, tcfg, [r.prompt for r in reqs], 8,
                                         max_batch=4, max_len=64, kv_quant=True)
    _assert_same(jreqs, treqs, jeng, teng)


def test_pool_route_tokens_equal_gather_route():
    tcfg = ModelConfig(**GOLDEN_KW)
    w = bridge.tree_to_torch(jax.tree.map(
        np.asarray, jax_api.init_params(JaxConfig(**GOLDEN_KW), jax.random.PRNGKey(1))))
    outs = []
    for impls in ({}, KERNEL_IMPLS):
        eng = ServingEngine(tcfg.replace(**impls), w, device="cpu", max_batch=3,
                            max_len=40, kv_quant=True)
        reqs = [Request(rid=i, prompt=p, max_new_tokens=12)
                for i, p in enumerate(_prompts(2, (5, 11, 3, 16)))]
        serve(eng, reqs)
        outs.append([r.out_tokens for r in reqs])
    assert outs[0] == outs[1]


@pytest.mark.parametrize("compact", [True, False], ids=["compact", "full"])
def test_dense_int8_engine_matches_jax(compact):
    jcfg, tcfg = JaxConfig(**GOLDEN_KW), ModelConfig(**GOLDEN_KW)
    jreqs, treqs, jeng, teng = _run_both(
        jcfg, tcfg, _prompts(8, (3, 8, 5, 12, 4)), 10, max_batch=4, max_len=32,
        paged=False, compact=compact, decode_batch=2, kv_quant="dense")
    assert teng.kv_quant_mode == "dense" and jeng.kv_quant_dense
    _assert_same(jreqs, treqs, jeng, teng)
    _assert_same_int8(jeng.state.cache["segments"], teng.state.cache["segments"])
    _assert_same_int8(jeng.state.scales, teng.state.scales)


def test_attn_einsum_promotes_a_float32_cache_as_jax():
    """A bfloat16 q beside a float32 (dequantized) cache: promoted as
    `jnp.einsum` promotes, probabilities rounded to q's dtype."""
    from repro.models.common import attn_einsum as jax_attn
    from repro_torch.models.common import attn_einsum

    rng = np.random.default_rng(12)
    q = rng.standard_normal((1, 5, 4, 16)).astype(np.float32)
    k, v = (rng.standard_normal((1, 5, 2, 16)).astype(np.float32) for _ in range(2))
    got = attn_einsum(torch.from_numpy(q).bfloat16(), torch.from_numpy(k),
                      torch.from_numpy(v), causal=True, window=None)
    want = jax_attn(jnp.asarray(q, jnp.bfloat16), jnp.asarray(k), jnp.asarray(v),
                    causal=True, window=None)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-2, atol=2e-2)

"""`gqa_einsum`: the port's grouped one-token attention against the JAX
`decode_step` with `gqa_einsum=True`, on the CPU, float32.

h2o-danube-1.8b's heads (32 query / 8 KV heads of 80) at a small width,
with a sliding window of 8 that the decode wraps: a 6-token prefill,
then 10 greedy decode steps (positions 6-15, the ring written round
twice).  Every step's logits within 2e-4 (absolute and relative) of
JAX's, the greedy tokens equal, and the grouped form within the same
tolerance of the port's repeat form (`gqa_einsum` off) on the same
cache.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models import api as jax_api
from repro.models.config import ModelConfig as JaxConfig
from repro_torch import bridge
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig

TOL = 2e-4
KW = dict(n_layers=2, d_model=128, n_heads=32, kv_heads=8, head_dim=80, d_ff=64,
          vocab=64, window=8, gqa_einsum=True, dtype="float32",
          param_dtype="float32", scan_layers=False)
STEPS = 10
_DECODE = jax.jit(jax_api.decode_step, static_argnums=0)


def test_grouped_decode_matches_jax_past_the_window():
    jcfg, tcfg = JaxConfig(**KW), ModelConfig(**KW)
    w = jax.tree.map(np.asarray, jax_api.init_params(jcfg, jax.random.PRNGKey(0)))
    toks = np.random.default_rng(0).integers(0, KW["vocab"], size=(2, 6))
    jlast, jcache = jax_api.prefill(jcfg, w, {"tokens": jnp.asarray(toks, jnp.int32)}, 32)
    tw = bridge.tree_to_torch(w)
    tlast, tcache = transformer.prefill(tcfg, tw, torch.as_tensor(toks), 32)
    jtok = jnp.argmax(jlast[:, -1], -1)[:, None].astype(jnp.int32)
    ttok = tlast[:, -1].argmax(-1, keepdim=True)
    for _ in range(STEPS):
        jl, jcache = _DECODE(jcfg, w, jtok, jcache)
        # the repeat form on a copy of the same cache
        plain, _ = transformer.decode_step(tcfg.replace(gqa_einsum=False), tw, ttok,
                                           clone(tcache))
        tl, tcache = transformer.decode_step(tcfg, tw, ttok, tcache)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(tl.numpy(), plain.numpy(), rtol=TOL, atol=TOL)
        jtok = jnp.argmax(jl[:, -1], -1)[:, None].astype(jnp.int32)
        ttok = tl[:, -1].argmax(-1, keepdim=True)
        assert ttok.numpy().tolist() == np.asarray(jtok).tolist()
    assert int(tcache["index"]) == 6 + STEPS > 2 * KW["window"] - 1


def clone(cache):
    return {"segments": [{k: v.clone() for k, v in seg.items()} for seg in cache["segments"]],
            "index": cache["index"].clone()}

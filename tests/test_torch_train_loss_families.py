"""The port's training loss and its gradients against
`jax.value_and_grad(repro.models.api.loss_fn)` for the recurrent and
encoder-decoder families (`test_torch_train_loss.py` holds the
transformers), float32 smoke configs, on the same bridged weights and
batch (numpy, seeded):

* rwkv6-3b (the chunked plain WKV against JAX's scan: gaps up to 5e-5),
  recurrentgemma-2b (two recurrent layers and one attention layer in
  each three) and whisper-base over 20 frames;
* `remat` "full" and "dots" in each family's own place (rwkv6's and
  rglru's layer bodies, whisper's encoder attention): JAX's numbers, and
  bit for bit the port's own without remat.

Loss within rtol 1e-5, every gradient leaf within atol 1e-4.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.models import api as jax_api
from repro_torch import bridge, configs
from repro_torch.training.loop import value_and_grad

FAMILIES = ("rwkv6-3b", "recurrentgemma-2b", "whisper-base")
LOSS_RTOL, GRAD_ATOL = 1e-5, 1e-4

_jax_vg = jax.jit(jax.value_and_grad(jax_api.loss_fn, argnums=1), static_argnums=0)


@functools.lru_cache(maxsize=None)
def _weights(jcfg):
    return jax.tree.map(np.asarray, jax.jit(jax_api.init_params, static_argnums=0)(
        jcfg, jax.random.PRNGKey(0)))


def _batch(cfg, b=2, s=24, prefix=8, seed=0):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    batch["labels"][0, :3] = -1
    if cfg.family == "whisper":
        batch["embeds"] = rng.standard_normal((b, 20, cfg.d_model)).astype(np.float32)
    elif cfg.frontend == "vision":
        batch["embeds"] = rng.standard_normal((b, prefix, cfg.d_model)).astype(np.float32)
    return batch


def _jax_side(jcfg, batch):
    loss, grads = _jax_vg(jcfg, _weights(jcfg),
                          {k: jnp.asarray(v) for k, v in batch.items()})
    return float(loss), bridge.tree_paths(jax.tree.map(np.asarray, grads))


def _port_side(tcfg, jcfg, batch):
    loss, grads = value_and_grad(tcfg, bridge.tree_to_torch(_weights(jcfg)),
                                 {k: torch.from_numpy(v) for k, v in batch.items()})
    return float(loss), bridge.tree_paths(grads)


def _check(arch, **kw):
    jcfg = jax_configs.get_smoke_config(arch).replace(**kw)
    tcfg = configs.get_smoke_config(arch).replace(**kw)
    batch = _batch(jcfg)
    jl, jg = _jax_side(jcfg, batch)
    tl, tg = _port_side(tcfg, jcfg, batch)
    assert tl == pytest.approx(jl, rel=LOSS_RTOL)
    assert [p for p, _ in tg] == [p for p, _ in jg]
    for (path, a), (_, b) in zip(jg, tg):
        assert b.dtype == torch.float32
        np.testing.assert_allclose(b.numpy(), a, rtol=0, atol=GRAD_ATOL,
                                   err_msg="/".join(map(str, path)))
    return tl, tg


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_grads_match_jax(arch):
    _, grads = _check(arch)
    assert all(float(g.abs().max()) > 0 for _, g in grads)


@pytest.mark.parametrize("remat", ("full", "dots"))
@pytest.mark.parametrize("arch", FAMILIES)
def test_remat_changes_no_number(arch, remat):
    loss, grads = _check(arch, remat=remat)
    jcfg = jax_configs.get_smoke_config(arch)
    plain_loss, plain_grads = _port_side(configs.get_smoke_config(arch), jcfg,
                                         _batch(jcfg))
    assert loss == plain_loss
    for (_, a), (_, b) in zip(grads, plain_grads):
        assert torch.equal(a, b)

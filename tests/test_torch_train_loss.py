"""The port's training loss and its gradients against
`jax.value_and_grad(repro.models.api.loss_fn)`, float32 smoke configs, on
the same bridged weights and batch (numpy, seeded); the decoder-only
transformers here (`test_torch_train_loss_families.py` holds the other
families):

* the seven transformer archs, deepseek-v3-671b with its MTP term and
  qwen2-vl-2b with a vision `embeds` prefix;
* `fused_ce` (the chunked loss) on smollm-135m and qwen2-vl-2b, and
  `chunked_cross_entropy` over several chunks with a padded tail;
* `remat` "full" and "dots": the same loss and gradients as JAX's, and
  bit for bit the port's own without remat.

Loss within rtol 1e-5, every gradient leaf within atol 1e-4 (the gaps
measured here are under 2e-6); labels of -1 are ignored on both sides.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.models import api as jax_api
from repro.models import transformer as jax_tf
from repro_torch import bridge, configs
from repro_torch.models import api, transformer
from repro_torch.training.loop import value_and_grad

TRANSFORMERS = ("smollm-135m", "h2o-danube-1.8b", "internlm2-1.8b", "qwen2.5-32b",
                "mixtral-8x7b", "deepseek-v3-671b", "qwen2-vl-2b")
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


@pytest.mark.parametrize("arch", TRANSFORMERS)
def test_loss_and_grads_match_jax(arch):
    _, grads = _check(arch)
    # every leaf gets a gradient: the MTP subtree too, where there is one
    assert all(float(g.abs().max()) > 0 for _, g in grads)
    if arch == "deepseek-v3-671b":
        assert any(path[0] == "mtp" for path, _ in grads)


def test_mtp_term_is_in_the_loss():
    jcfg = jax_configs.get_smoke_config("deepseek-v3-671b")
    tcfg = configs.get_smoke_config("deepseek-v3-671b")
    assert tcfg.mtp
    w = bridge.tree_to_torch(_weights(jcfg))
    batch = {k: torch.from_numpy(v) for k, v in _batch(jcfg).items()}
    with_mtp = float(api.loss_fn(tcfg, w, batch))
    without = float(api.loss_fn(tcfg.replace(mtp=False), w, batch))
    assert with_mtp > without


def test_vision_prefix_carries_no_labels():
    """qwen2-vl-2b with an `embeds` prefix of 8 positions: the loss is the
    cross-entropy of the text positions' logits alone."""
    tcfg = configs.get_smoke_config("qwen2-vl-2b")
    jcfg = jax_configs.get_smoke_config("qwen2-vl-2b")
    w = bridge.tree_to_torch(_weights(jcfg))
    batch = {k: torch.from_numpy(v) for k, v in _batch(jcfg, prefix=8).items()}
    logits = transformer.forward(tcfg, w, batch["tokens"], embeds=batch["embeds"])
    assert logits.shape[1] == 8 + batch["tokens"].shape[1]
    want = transformer.cross_entropy(logits[:, 8:], batch["labels"])
    assert float(api.loss_fn(tcfg, w, batch)) == pytest.approx(float(want), rel=1e-6)


@pytest.mark.parametrize("arch", ("smollm-135m", "qwen2-vl-2b"))
def test_fused_ce_matches_jax_and_the_full_loss(arch):
    loss, grads = _check(arch, fused_ce=True)
    tcfg = configs.get_smoke_config(arch)
    jcfg = jax_configs.get_smoke_config(arch)
    full, full_grads = _port_side(tcfg, jcfg, _batch(jcfg))
    assert loss == pytest.approx(full, rel=1e-6)
    for (_, a), (_, b) in zip(grads, full_grads):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


def test_chunked_cross_entropy_over_several_chunks():
    """Chunks of 8 over 21 positions (a padded tail of 3): the same number
    as JAX's and as the whole-sequence loss."""
    jcfg = jax_configs.get_smoke_config("smollm-135m")
    tcfg = configs.get_smoke_config("smollm-135m")
    w = _weights(jcfg)
    rng = np.random.default_rng(3)
    h = rng.standard_normal((2, 21, jcfg.d_model)).astype(np.float32)
    y = rng.integers(-1, jcfg.vocab, (2, 21)).astype(np.int32)
    want = float(jax_tf.chunked_cross_entropy(jcfg, w, jnp.asarray(h), jnp.asarray(y),
                                              chunk=8))
    tw = bridge.tree_to_torch(w)
    got = transformer.chunked_cross_entropy(tcfg, tw, torch.from_numpy(h),
                                            torch.from_numpy(y), chunk=8)
    assert float(got) == pytest.approx(want, rel=LOSS_RTOL)
    full = transformer.cross_entropy(transformer.unembed(tcfg, tw, torch.from_numpy(h)),
                                     torch.from_numpy(y))
    assert float(got) == pytest.approx(float(full), rel=1e-6)


@pytest.mark.parametrize("remat", ("full", "dots"))
@pytest.mark.parametrize("arch", ("smollm-135m", "mixtral-8x7b"))
def test_remat_changes_no_number(arch, remat):
    loss, grads = _check(arch, remat=remat)
    jcfg = jax_configs.get_smoke_config(arch)
    plain_loss, plain_grads = _port_side(configs.get_smoke_config(arch), jcfg,
                                         _batch(jcfg))
    assert loss == plain_loss
    for (_, a), (_, b) in zip(grads, plain_grads):
        assert torch.equal(a, b)


def test_param_count_matches_jax():
    for arch in TRANSFORMERS:
        jcfg = jax_configs.get_smoke_config(arch)
        w = _weights(jcfg)
        assert api.param_count(bridge.tree_to_torch(w)) == jax_api.param_count(w)

"""The plain attention forms of the port (`repro_torch.models.common`)
against the JAX package's, on the same numpy inputs, float32 on the CPU:

* `attn_chunked` (a running max and sum over KV chunks of `attn_chunk`,
  p kept 0 in fully masked chunks) with and without a window, Sk not a
  multiple of the chunk, a query offset (Sq < Sk) and GQA;
* `attn_local` (query chunks of `window` against their own chunk and the
  previous one) with S not a multiple of the window, and GQA;
* the `auto` dispatch, which picks `chunked` for a prompt over 4096
  tokens with no window and `local` for a windowed prompt longer than
  its window, as `repro.models.common.attention` does.

Tolerance 2e-5 (rtol and atol): float32 sums in another order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.models import common as jax_common
from repro_torch import configs
from repro_torch.models import common

TOL = dict(rtol=2e-5, atol=2e-5)


def _qkv(seed, b, sq, sk, h, hkv, hd):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, hd)).astype(np.float32),
            rng.standard_normal((b, sk, hkv, hd)).astype(np.float32),
            rng.standard_normal((b, sk, hkv, hd)).astype(np.float32))


def _both(arrays):
    return [torch.from_numpy(a) for a in arrays], [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("sq,sk,h,hkv,chunk,window,q_offset", [
    (64, 64, 4, 4, 16, None, 0),       # Sk a multiple of the chunk
    (64, 64, 4, 2, 16, 24, 0),         # window, GQA
    (50, 50, 4, 2, 32, None, 0),       # Sk not a multiple of the chunk
    (37, 37, 2, 1, 16, 9, 0),          # both ragged, window under a chunk
    (8, 40, 4, 2, 16, None, 32),       # queries at positions 32..39
    (8, 40, 4, 2, 16, 12, 32),         # the same with a window
])
def test_attn_chunked_matches_jax(sq, sk, h, hkv, chunk, window, q_offset):
    t, j = _both(_qkv(sq * 7 + sk, 2, sq, sk, h, hkv, 16))
    got = common.attn_chunked(*t, causal=True, window=window, chunk=chunk,
                              q_offset=q_offset)
    want = jax_common.attn_chunked(*j, causal=True, window=window, chunk=chunk,
                                   q_offset=q_offset)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # and the plain einsum form, which computes the same function
    np.testing.assert_allclose(
        got.numpy(), common.attn_einsum(*t, causal=True, window=window,
                                        q_offset=q_offset).numpy(), **TOL)


def test_attn_chunked_non_causal():
    t, j = _both(_qkv(3, 1, 20, 45, 2, 2, 8))
    got = common.attn_chunked(*t, causal=False, window=None, chunk=16)
    want = jax_common.attn_chunked(*j, causal=False, window=None, chunk=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("s,h,hkv,window", [
    (48, 4, 4, 16),          # S a multiple of the window
    (50, 4, 2, 16),          # S not a multiple, GQA
    (33, 6, 2, 32),          # one full chunk and a ragged one
    (10, 2, 1, 16),          # shorter than the window
])
def test_attn_local_matches_jax(s, h, hkv, window):
    t, j = _both(_qkv(s + window, 2, s, s, h, hkv, 16))
    got = common.attn_local(*t, window=window)
    want = jax_common.attn_local(*j, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(
        got.numpy(), common.attn_einsum(*t, causal=True, window=window).numpy(),
        **TOL)


@pytest.mark.parametrize("s,window,chunk", [
    (4100, None, 1024),      # over 4096 tokens, no window: chunked
    (80, 32, 16),            # windowed and longer than the window: local
])
def test_auto_dispatch_matches_jax(s, window, chunk):
    kw = dict(attn_impl="auto", window=window, attn_chunk=chunk)
    cfg = configs.get_smoke_config("smollm-135m").replace(**kw)
    jcfg = jax_configs.get_smoke_config("smollm-135m").replace(**kw)
    t, j = _both(_qkv(s, 1, s, s, 2, 1, 8))
    got = common.attention(cfg, *t, causal=True)
    want = jax_common.attention(jcfg, *j, causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

"""Stand-ins for every input of a dry-run cell (from `repro.launch.specs`):
`meta` tensors of the right shape and dtype, with no storage.  The one
source of what each (arch x shape) cell traces.

  train_*:    train_step(params, opt_state, batch)
  prefill_*:  prefill(params, batch) -> (last_logits, cache)
  decode_* / long_*: decode_step(params, tokens, cache): one new token
              against a seq_len-deep cache or state (ring-capped for a
              sliding window, O(1) for the recurrent families).

The trees, shapes and dtypes are JAX's, leaf for leaf.  The parameters
come from `api.param_shapes` and the cache from `api.init_cache`, each
traced under a `FakeTensorMode`, so nothing is drawn or allocated.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.bridge import tree_map
from repro_torch.configs import SHAPES, Shape, get_config
from repro_torch.models import api
from repro_torch.models.config import ModelConfig


def meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(int(x) for x in shape), dtype=dtype, device="meta")


def batch_specs(cfg: ModelConfig, shape: Shape) -> dict:
    """The input batch of a train or prefill cell: whisper's frames (B, S,
    d) and decoder tokens (B, S / dec_seq_factor); a vision-stub prefix
    of S / vision_prefix_factor embeddings before the text tokens; else
    tokens (B, S).  Train cells add labels like the tokens."""
    b, s = shape.global_batch, shape.seq_len
    if cfg.family == "whisper":
        dec = s // cfg.dec_seq_factor
        out = {"embeds": meta((b, s, cfg.d_model), cfg.tdtype),
               "tokens": meta((b, dec), torch.int32)}
        if shape.kind == "train":
            out["labels"] = meta((b, dec), torch.int32)
        return out
    if cfg.frontend == "vision":
        p = s // cfg.vision_prefix_factor
        out = {"embeds": meta((b, p, cfg.d_model), cfg.tdtype),
               "tokens": meta((b, s - p), torch.int32)}
        if shape.kind == "train":
            out["labels"] = meta((b, s - p), torch.int32)
        return out
    out = {"tokens": meta((b, s), torch.int32)}
    if shape.kind == "train":
        out["labels"] = meta((b, s), torch.int32)
    return out


def cache_specs(cfg: ModelConfig, shape: Shape) -> Any:
    """The decode cell's whole cache: `api.init_cache` traced with no
    allocation.  Whisper's cross KV is the cell's seq_len deep, its
    self-cache bounded by the 8192-entry learned position table."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    b, s = shape.global_batch, shape.seq_len
    with FakeTensorMode():
        if cfg.family == "whisper":
            cache = api.init_cache(cfg, b, min(s // cfg.dec_seq_factor, 8192),
                                   device="cpu", enc_len=s)
        else:
            cache = api.init_cache(cfg, b, s, device="cpu")
    return tree_map(lambda t: meta(t.shape, t.dtype), cache)


def decode_specs(cfg: ModelConfig, shape: Shape) -> tuple:
    """(tokens (B, 1), cache) of a decode cell."""
    return meta((shape.global_batch, 1), torch.int32), cache_specs(cfg, shape)


def params_specs(cfg: ModelConfig) -> Any:
    return api.param_shapes(cfg)


def input_specs(arch: str, shape_name: str) -> dict:
    """Everything a dry-run cell needs, as `meta` tensors."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    out = {"cfg": cfg, "shape": shape, "params": params_specs(cfg)}
    if shape.kind == "decode":
        out["tokens"], out["cache"] = decode_specs(cfg, shape)
    else:
        out["batch"] = batch_specs(cfg, shape)
    return out

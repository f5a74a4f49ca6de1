"""Model facade of the port (from `repro.models.api`): family dispatch
for the dense transformer, RWKV6 and the RG-LRU hybrid (whisper is not
ported yet).  Entry points run on CUDA unless the caller passes
`device="cpu"`, and raise where CUDA is asked for and missing.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.device import resolve_device

from . import rglru, rwkv6, transformer
from .config import ModelConfig

Params = Any

_FAMS = {"transformer": transformer, "rglru": rglru, "rwkv6": rwkv6}


def family_module(cfg: ModelConfig):
    if cfg.family not in _FAMS:
        raise NotImplementedError(f"family {cfg.family} is not ported yet")
    return _FAMS[cfg.family]


def init_params(cfg: ModelConfig, seed: int = 0, *, device=None) -> Params:
    """Random weights from a seeded `torch.Generator` (drawn on the CPU,
    then moved to `device`)."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    return family_module(cfg).init_params(cfg, gen, dev)


def forward(cfg: ModelConfig, params: Params, batch: dict):
    return family_module(cfg).forward(cfg, params, batch["tokens"])


def prefill(cfg: ModelConfig, params: Params, batch: dict, max_len: int):
    return family_module(cfg).prefill(cfg, params, batch["tokens"], max_len)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device=None):
    """A zero cache for `batch` rows: the dense KV rectangles of a
    transformer (a ring of `window` slots for a sliding-window model),
    the recurrent state (and rglru's ring KV) otherwise."""
    return family_module(cfg).init_cache(cfg, batch, max_len,
                                         device=resolve_device(device))


def init_paged_cache(cfg: ModelConfig, num_pages: int, page_size: int, *,
                     device=None, dtype=None):
    """Paged KV page pools (transformer only, as in the JAX package)."""
    if cfg.family != "transformer":
        raise NotImplementedError(
            f"paged KV cache is transformer-only, not {cfg.family}")
    return transformer.init_paged_cache(
        cfg, num_pages, page_size, device=resolve_device(device), dtype=dtype)


def decode_step(cfg: ModelConfig, params: Params, tokens, cache):
    return family_module(cfg).decode_step(cfg, params, tokens, cache)


def decode_window(cfg: ModelConfig, params: Params, tokens, cache):
    """Verify a (B, W) token window in one cached forward (spec-decode);
    plain-attention transformers only: `transformer.decode_window`."""
    if cfg.family != "transformer":
        raise NotImplementedError(
            f"decode_window is transformer-only, not {cfg.family}")
    return transformer.decode_window(cfg, params, tokens, cache)

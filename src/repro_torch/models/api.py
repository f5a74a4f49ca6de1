"""Model facade of the port (from `repro.models.api`): the transformer
family only in this slice.  Entry points run on CUDA unless the caller
passes `device="cpu"`, and raise where CUDA is asked for and missing.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.device import resolve_device

from . import transformer
from .config import ModelConfig

Params = Any


def family_module(cfg: ModelConfig):
    if cfg.family != "transformer":
        raise NotImplementedError(f"family {cfg.family} is not ported yet")
    return transformer


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


def init_paged_cache(cfg: ModelConfig, num_pages: int, page_size: int, *,
                     device=None, dtype=None):
    return family_module(cfg).init_paged_cache(
        cfg, num_pages, page_size, device=resolve_device(device), dtype=dtype)


def decode_step(cfg: ModelConfig, params: Params, tokens, cache):
    return family_module(cfg).decode_step(cfg, params, tokens, cache)


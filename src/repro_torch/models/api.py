"""Model facade of the port (from `repro.models.api`): family dispatch
for the transformer, RWKV6, the RG-LRU hybrid and the whisper
encoder-decoder.  Entry points run on CUDA unless the caller passes
`device="cpu"`, and raise where CUDA is asked for and missing.

Batch dicts as in the JAX package: {"tokens": (B, S)[, "embeds": (B, P,
d)]} (a transformer's vision-stub prefix); whisper takes {"embeds":
frames (B, T, d), "tokens": decoder tokens}.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.bridge import tree_leaves, tree_map
from repro_torch.device import resolve_device
from repro_torch.parallel import sharding

from . import rglru, rwkv6, transformer, whisper
from .config import ModelConfig

Params = Any

_FAMS = {"transformer": transformer, "rglru": rglru, "rwkv6": rwkv6,
         "whisper": whisper}


def family_module(cfg: ModelConfig):
    if cfg.family not in _FAMS:
        raise NotImplementedError(f"family {cfg.family} is not ported yet")
    return _FAMS[cfg.family]


def init_params(cfg: ModelConfig, seed: int = 0, *, device=None, mesh=None,
                hold: str = "tp") -> Params:
    """Random weights from a `torch.Generator` seeded on `device` (default:
    the mesh's) and drawn there (no host copy of a large tensor; a seed
    gives other weights on CUDA than on the CPU).  `mesh`: this rank's
    blocks of the same draw, for every family (`sharding.shard_params`'
    blocks of the whole draw, bit for bit; each leaf cut as it is drawn,
    so a rank holds its shards and one layer's leaf at most).  `hold`:
    which blocks (`sharding.HOLDS`: "fsdp" holds FSDP's blocks, over the
    DP axes too); the transformer family alone takes another than "tp"."""
    if mesh is not None and device is None:
        device = mesh.device
    sharding.check_hold(cfg, hold)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    if hold != "tp":
        return transformer.init_params(cfg, gen, dev, mesh=mesh, hold=hold)
    return family_module(cfg).init_params(cfg, gen, dev, mesh=mesh)


def param_shapes(cfg: ModelConfig) -> Params:
    """The whole parameter tree as `meta` tensors (shapes and dtypes, no
    storage): `init_params` traced under a `FakeTensorMode`, so no weight
    is drawn.  On a mesh the sharding rules read the whole shapes from
    it, where each rank holds only its blocks."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        fake = init_params(cfg, 0, device="cpu")
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), fake)


def loss_fn(cfg: ModelConfig, params: Params, batch: dict) -> torch.Tensor:
    """The family's training loss of a batch {"tokens", "labels"[,
    "embeds"]} (whisper: "embeds" are the frames), a 0-d float32 tensor."""
    return family_module(cfg).loss_fn(cfg, params, batch)


def forward(cfg: ModelConfig, params: Params, batch: dict):
    m = family_module(cfg)
    if cfg.family == "whisper":
        return m.forward(cfg, params, batch["embeds"], batch["tokens"])
    if cfg.family == "transformer":
        return m.forward(cfg, params, batch.get("tokens"),
                         embeds=batch.get("embeds"))
    return m.forward(cfg, params, batch["tokens"])


def prefill(cfg: ModelConfig, params: Params, batch: dict, max_len: int):
    m = family_module(cfg)
    if cfg.family == "whisper":
        return m.prefill(cfg, params, batch["embeds"], batch["tokens"], max_len)
    if cfg.family == "transformer":
        return m.prefill(cfg, params, batch.get("tokens"), max_len,
                         embeds=batch.get("embeds"))
    return m.prefill(cfg, params, batch["tokens"], max_len)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device=None,
               enc_len: int | None = None):
    """A zero cache for `batch` rows: the dense KV rectangles of a
    transformer (a ring of `window` slots for a sliding-window model,
    latents for MLA), the recurrent state (and rglru's ring KV), or
    whisper's self and cross KV over an `enc_len` window (default
    `max_len`, as in the JAX package)."""
    dev = resolve_device(device)
    if cfg.family == "whisper":
        return whisper.init_cache(cfg, batch, max_len, enc_len or max_len,
                                  device=dev)
    return family_module(cfg).init_cache(cfg, batch, max_len, device=dev)


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


def param_count(params: Params) -> int:
    """Elements over every tensor of the tree."""
    return sum(t.numel() for t in tree_leaves(params))

"""Architecture registry of the port: the ten archs of `repro.configs`
(dense and sliding-window GQA transformers, M-RoPE qwen2-vl, the MLA
MoE deepseek-v3, mixtral's sliding-window MoE, the RWKV6 and RG-LRU
recurrent families and the whisper encoder-decoder), in its order.
Resolves `--arch <id>` like `repro.configs`.

Shapes: every arch pairs with the LM shape set below, as in JAX.
`decode_*` / `long_*` run one decode step against a seq_len cache;
`long_500k` runs only for the sub-quadratic archs (sliding window, SSM,
hybrid), and the dry run's cells (`cells`) leave the others out.
"""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.config import ModelConfig, smoke_config

_MODULES = {
    "h2o-danube-1.8b": ".h2o_danube_1_8b",
    "smollm-135m": ".smollm_135m",
    "internlm2-1.8b": ".internlm2_1_8b",
    "qwen2.5-32b": ".qwen2_5_32b",
    "mixtral-8x7b": ".mixtral_8x7b",
    "deepseek-v3-671b": ".deepseek_v3_671b",
    "qwen2-vl-2b": ".qwen2_vl_2b",
    "recurrentgemma-2b": ".recurrentgemma_2b",
    "whisper-base": ".whisper_base",
    "rwkv6-3b": ".rwkv6_3b",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    cfg = importlib.import_module(_MODULES[arch], __name__).config()
    cfg.validate()
    return cfg


def get_smoke_config(arch: str) -> ModelConfig:
    return smoke_config(get_config(arch))


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": Shape("train_4k", 4096, 256, "train"),
    "prefill_32k": Shape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": Shape("decode_32k", 32768, 128, "decode"),
    "long_500k": Shape("long_500k", 524288, 1, "decode"),
}

# sub-quadratic context handling: long_500k is runnable
LONG_CONTEXT_OK = {
    "h2o-danube-1.8b": True,       # SWA: O(S*W)
    "smollm-135m": False,          # full attention
    "internlm2-1.8b": False,
    "qwen2.5-32b": False,
    "mixtral-8x7b": True,          # SWA
    "deepseek-v3-671b": False,     # MLA compresses KV but is still O(S^2)
    "qwen2-vl-2b": False,
    "recurrentgemma-2b": True,     # RG-LRU state + 2k-window local attn
    "whisper-base": False,         # enc-dec full attention
    "rwkv6-3b": True,              # linear recurrence, O(1) state
}


def cells(include_skipped: bool = False) -> list[tuple[str, str]]:
    """All (arch, shape) dry-run cells; skips filtered unless asked."""
    out = []
    for arch in ARCH_IDS:
        for shape in SHAPES.values():
            skipped = shape.name == "long_500k" and not LONG_CONTEXT_OK[arch]
            if skipped and not include_skipped:
                continue
            out.append((arch, shape.name))
    return out

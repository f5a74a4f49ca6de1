"""Operator-level IR — the granularity at which Mozart reasons.

The paper's central claim (Section 2) is that memory demand, batching
benefit and utilization are properties of *individual operators*.  This
module defines that operator IR and the extractors that lower neural
networks (transformer LMs, CNNs, ViTs) into it.

Units: FLOPs are floating-point operations (1 MAC = 2 FLOPs), bytes are
bytes, all quantities are *per sample* (batch = 1); the performance model
scales them by batch size according to each operator's batching class.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

# Operator kinds understood by the performance model.
KINDS = ("gemm", "conv", "dwconv", "attention", "elementwise", "norm",
         "scan", "embed")

# Batching classes (Insight 2).
BATCH_SENSITIVE = "sensitive"   # weights reused across samples (projections)
BATCH_AGNOSTIC = "agnostic"     # no cross-sample reuse (attention, scans)


@dataclasses.dataclass(frozen=True)
class Operator:
    """A single computational operator, batch=1 granularity."""
    name: str
    kind: str
    flops: float                 # FLOPs per sample
    weight_bytes: float          # parameter bytes (shared across batch)
    act_in_bytes: float          # activation input bytes per sample
    act_out_bytes: float         # activation output bytes per sample
    parallel_work: float         # independent output lanes (PE utilization)
    batch_scaling: str = BATCH_SENSITIVE
    # For MoE expert GEMMs only `1/weight_reuse_divisor` of the resident
    # weights is touched per token on average (top_k / n_experts).
    weight_reuse_divisor: float = 1.0

    def __post_init__(self):
        assert self.kind in KINDS, self.kind
        assert self.batch_scaling in (BATCH_SENSITIVE, BATCH_AGNOSTIC)

    def __hash__(self):
        # Operator tuples key the per-group option caches; memoize the
        # hash (frozen -> fields never change).
        h = self.__dict__.get("_hash")
        if h is None:
            h = hash((self.name, self.kind, self.flops, self.weight_bytes,
                      self.act_in_bytes, self.act_out_bytes,
                      self.parallel_work, self.batch_scaling,
                      self.weight_reuse_divisor))
            object.__setattr__(self, "_hash", h)
        return h

    def arithmetic_intensity(self, batch: int = 1) -> float:
        """FLOPs per DRAM byte at a given batch size (first-order)."""
        f = self.flops * batch
        b = self.dram_bytes(batch)
        return f / max(b, 1.0)

    def to_dict(self) -> dict:
        return {"name": self.name, "kind": self.kind, "flops": self.flops,
                "weight_bytes": self.weight_bytes,
                "act_in_bytes": self.act_in_bytes,
                "act_out_bytes": self.act_out_bytes,
                "parallel_work": self.parallel_work,
                "batch_scaling": self.batch_scaling,
                "weight_reuse_divisor": self.weight_reuse_divisor}

    @staticmethod
    def from_dict(d: dict) -> "Operator":
        return Operator(**{k: d[k] for k in (
            "name", "kind", "flops", "weight_bytes", "act_in_bytes",
            "act_out_bytes", "parallel_work", "batch_scaling",
            "weight_reuse_divisor")})

    def dram_bytes(self, batch: int = 1) -> float:
        """Bytes that must cross DRAM for one execution at `batch`."""
        w = self.weight_bytes / self.weight_reuse_divisor \
            if self.batch_scaling == BATCH_SENSITIVE else \
            self.weight_bytes * batch / self.weight_reuse_divisor
        # MoE: at batch B, the fraction of experts touched grows; model the
        # touched weights as min(resident, per-token-touched * tokens).
        if self.weight_reuse_divisor > 1.0:
            w = min(self.weight_bytes,
                    (self.weight_bytes / self.weight_reuse_divisor) * batch)
        return w + (self.act_in_bytes + self.act_out_bytes) * batch


@dataclasses.dataclass(frozen=True)
class OperatorGraph:
    """A network (or representative region) lowered to a linear operator
    pipeline.  `repeat` compresses identical repeated segments (layers)."""
    network: str
    phase: str                   # "prefill" | "decode" | "vision"
    operators: tuple[Operator, ...]
    repeats: tuple[int, ...]     # same length as operators

    def __post_init__(self):
        assert len(self.operators) == len(self.repeats)

    @property
    def total_flops(self) -> float:
        return sum(o.flops * r for o, r in zip(self.operators, self.repeats))

    @property
    def total_weight_bytes(self) -> float:
        return sum(o.weight_bytes * r
                   for o, r in zip(self.operators, self.repeats))

    def to_dict(self) -> dict:
        return {"network": self.network, "phase": self.phase,
                "operators": [o.to_dict() for o in self.operators],
                "repeats": list(self.repeats)}

    @staticmethod
    def from_dict(d: dict) -> "OperatorGraph":
        return OperatorGraph(
            network=d["network"], phase=d["phase"],
            operators=tuple(Operator.from_dict(o) for o in d["operators"]),
            repeats=tuple(d["repeats"]))

    def expand(self, max_ops: int | None = None) -> list[Operator]:
        out: list[Operator] = []
        for o, r in zip(self.operators, self.repeats):
            for i in range(r):
                out.append(dataclasses.replace(o, name=f"{o.name}#{i}")
                           if r > 1 else o)
        if max_ops is not None and len(out) > max_ops:
            out = out[:max_ops]
        return out


# ---------------------------------------------------------------------------
# Transformer LM extraction
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LMSpec:
    """Architecture description sufficient for operator extraction.
    Mirrors the registry's model configs (`repro_torch.configs`), kept
    separate so the codesign stack needs no model code."""
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None
    swiglu: bool = True
    window: int | None = None          # sliding-window attention
    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    # MLA (DeepSeek): latent-compressed KV
    mla_kv_rank: int = 0
    mla_q_rank: int = 0
    mla_rope_dim: int = 64
    dtype_bytes: int = 2

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads


def _op(name, kind, flops, w, ain, aout, par, scaling=BATCH_SENSITIVE,
        reuse_div=1.0) -> Operator:
    return Operator(name=name, kind=kind, flops=float(flops),
                    weight_bytes=float(w), act_in_bytes=float(ain),
                    act_out_bytes=float(aout), parallel_work=float(par),
                    batch_scaling=scaling, weight_reuse_divisor=reuse_div)


def lm_layer_operators(spec: LMSpec, seq: int, cache_len: int,
                       phase: str) -> list[Operator]:
    """Operators for ONE transformer layer.

    prefill: seq tokens attend causally over themselves (+window cap).
    decode:  seq == 1 new token attends over cache_len cached tokens.
    """
    d, B = spec.d_model, spec.dtype_bytes
    hd = spec.hd
    q_dim = spec.n_heads * hd
    kv_dim = spec.kv_heads * hd
    S = seq
    ops: list[Operator] = []

    act = S * d * B
    ops.append(_op("norm1", "norm", 5 * S * d, d * B, act, act, S * d))

    if spec.mla_kv_rank:  # DeepSeek MLA
        r_kv, r_q, r_rope = spec.mla_kv_rank, spec.mla_q_rank, spec.mla_rope_dim
        # q down+up, kv down, k/v up projections
        w_q = (d * r_q + r_q * spec.n_heads * (hd + r_rope)) * B
        w_kv = (d * (r_kv + r_rope) + r_kv * spec.n_heads * (hd + hd)) * B
        f_q = 2 * S * (d * r_q + r_q * spec.n_heads * (hd + r_rope))
        f_kv = 2 * S * (d * (r_kv + r_rope) + r_kv * spec.n_heads * 2 * hd)
        ops.append(_op("mla_proj", "gemm", f_q + f_kv, w_q + w_kv,
                       act, S * spec.n_heads * (hd + r_rope) * B * 3,
                       S * spec.n_heads * hd))
        kv_token_bytes = (r_kv + r_rope) * B          # latent cache per token
    else:
        w_qkv = d * (q_dim + 2 * kv_dim) * B
        f_qkv = 2 * S * d * (q_dim + 2 * kv_dim)
        ops.append(_op("qkv_proj", "gemm", f_qkv, w_qkv, act,
                       S * (q_dim + 2 * kv_dim) * B, S * (q_dim + 2 * kv_dim)))
        kv_token_bytes = 2 * kv_dim * B

    # Attention core — batch-AGNOSTIC: zero weights, per-sample KV.
    ctx = cache_len if phase == "decode" else S
    if spec.window:
        ctx = min(ctx, spec.window)
    causal_frac = 0.5 if (phase != "decode" and spec.window is None) else 1.0
    f_attn = 2 * 2 * S * ctx * q_dim * causal_frac      # QK^T + PV
    kv_bytes = ctx * kv_token_bytes                      # cache/keys read
    ops.append(_op("attention", "attention", f_attn, 0.0,
                   S * q_dim * B + kv_bytes, S * q_dim * B,
                   S * spec.n_heads * ctx * causal_frac,
                   scaling=BATCH_AGNOSTIC))

    ops.append(_op("o_proj", "gemm", 2 * S * q_dim * d, q_dim * d * B,
                   S * q_dim * B, act, S * d))
    ops.append(_op("norm2", "norm", 5 * S * d, d * B, act, act, S * d))

    mlp_mults = 3 if spec.swiglu else 2
    if spec.n_experts:
        ops.append(_op("router", "gemm", 2 * S * d * spec.n_experts,
                       d * spec.n_experts * B, act,
                       S * spec.n_experts * B, S * spec.n_experts))
        if spec.n_shared_experts:
            sw = mlp_mults * d * spec.d_ff * spec.n_shared_experts * B
            ops.append(_op("shared_expert", "gemm",
                           2 * mlp_mults * S * d * spec.d_ff
                           * spec.n_shared_experts,
                           sw, act, act, S * spec.d_ff))
        ew = mlp_mults * d * spec.d_ff * spec.n_experts * B
        ops.append(_op("routed_experts", "gemm",
                       2 * mlp_mults * S * d * spec.d_ff * spec.top_k,
                       ew, act * spec.top_k, act, S * spec.d_ff * spec.top_k,
                       reuse_div=spec.n_experts / spec.top_k))
    else:
        ops.append(_op("mlp", "gemm", 2 * mlp_mults * S * d * spec.d_ff,
                       mlp_mults * d * spec.d_ff * B, act, act, S * spec.d_ff))
        ops.append(_op("mlp_act", "elementwise", 4 * S * spec.d_ff,
                       0.0, S * spec.d_ff * B, S * spec.d_ff * B,
                       S * spec.d_ff, scaling=BATCH_AGNOSTIC))
    return ops


def lm_operator_graph(spec: LMSpec, seq: int, phase: str = "prefill",
                      cache_len: int | None = None) -> OperatorGraph:
    """Lower a transformer LM to an operator pipeline.

    phase="prefill": process `seq` tokens.
    phase="decode":  process 1 token against `cache_len` cached tokens.
    """
    if phase == "decode":
        S, C = 1, (cache_len if cache_len is not None else seq)
    else:
        S, C = seq, 0
    d, B = spec.d_model, spec.dtype_bytes
    ops: list[Operator] = []
    repeats: list[int] = []

    # embedding lookup touches only the S gathered rows, not the table
    # (the full-table capacity requirement is handled by memory sizing).
    ops.append(_op("embed", "embed", 2 * S * d, S * d * B,
                   S * 4, S * d * B, S * d))
    repeats.append(1)

    layer = lm_layer_operators(spec, S, C, phase)
    for o in layer:
        ops.append(o)
        repeats.append(spec.n_layers)

    ops.append(_op("final_norm", "norm", 5 * S * d, d * B,
                   S * d * B, S * d * B, S * d))
    repeats.append(1)
    ops.append(_op("lm_head", "gemm", 2 * S * d * spec.vocab,
                   d * spec.vocab * B, S * d * B, S * spec.vocab * B,
                   S * spec.vocab))
    repeats.append(1)
    return OperatorGraph(network=f"{spec.name}_{phase}", phase=phase,
                         operators=tuple(ops), repeats=tuple(repeats))


# ---------------------------------------------------------------------------
# CNN / ViT extraction (paper workload suite: ResNet50, MobileNetV3,
# EfficientNet, RepLKNet-31B, ViT).  Representative regions, as in paper §5.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ConvLayer:
    name: str
    cin: int
    cout: int
    k: int
    stride: int
    h: int          # input spatial
    w: int
    repeat: int = 1
    depthwise: bool = False


def conv_ops(layer: ConvLayer, dtype_bytes: int = 2) -> Operator:
    ho, wo = layer.h // layer.stride, layer.w // layer.stride
    if layer.depthwise:
        flops = 2 * ho * wo * layer.cout * layer.k * layer.k
        w = layer.cout * layer.k * layer.k * dtype_bytes
        kind = "dwconv"
    else:
        flops = 2 * ho * wo * layer.cout * layer.cin * layer.k * layer.k
        w = layer.cout * layer.cin * layer.k * layer.k * dtype_bytes
        kind = "conv"
    ain = layer.h * layer.w * layer.cin * dtype_bytes
    aout = ho * wo * layer.cout * dtype_bytes
    return _op(layer.name, kind, flops, w, ain, aout, ho * wo * layer.cout)


def cnn_operator_graph(name: str, layers: Sequence[ConvLayer],
                       head_dim: tuple[int, int] | None = None,
                       dtype_bytes: int = 2) -> OperatorGraph:
    ops = [conv_ops(l, dtype_bytes) for l in layers]
    repeats = [l.repeat for l in layers]
    if head_dim is not None:
        cin, nclass = head_dim
        ops.append(_op("fc_head", "gemm", 2 * cin * nclass,
                       cin * nclass * dtype_bytes, cin * dtype_bytes,
                       nclass * dtype_bytes, nclass))
        repeats.append(1)
    return OperatorGraph(network=name, phase="vision",
                         operators=tuple(ops), repeats=tuple(repeats))


def resnet50_graph() -> OperatorGraph:
    L = ConvLayer
    layers = [
        L("stem", 3, 64, 7, 2, 224, 224),
        # bottleneck stages (1x1 reduce, 3x3, 1x1 expand) per block
        L("s1_1x1a", 64, 64, 1, 1, 56, 56, repeat=3),
        L("s1_3x3", 64, 64, 3, 1, 56, 56, repeat=3),
        L("s1_1x1b", 64, 256, 1, 1, 56, 56, repeat=3),
        L("s2_1x1a", 256, 128, 1, 1, 28, 28, repeat=4),
        L("s2_3x3", 128, 128, 3, 1, 28, 28, repeat=4),
        L("s2_1x1b", 128, 512, 1, 1, 28, 28, repeat=4),
        L("s3_1x1a", 512, 256, 1, 1, 14, 14, repeat=6),
        L("s3_3x3", 256, 256, 3, 1, 14, 14, repeat=6),
        L("s3_1x1b", 256, 1024, 1, 1, 14, 14, repeat=6),
        L("s4_1x1a", 1024, 512, 1, 1, 7, 7, repeat=3),
        L("s4_3x3", 512, 512, 3, 1, 7, 7, repeat=3),
        L("s4_1x1b", 512, 2048, 1, 1, 7, 7, repeat=3),
    ]
    return cnn_operator_graph("resnet50", layers, head_dim=(2048, 1000))


def mobilenetv3_graph() -> OperatorGraph:
    L = ConvLayer
    layers = [
        L("stem", 3, 16, 3, 2, 224, 224),
        L("b1_dw", 16, 16, 3, 1, 112, 112, depthwise=True),
        L("b1_pw", 16, 16, 1, 1, 112, 112),
        L("b2_exp", 16, 64, 1, 1, 112, 112),
        L("b2_dw", 64, 64, 3, 2, 112, 112, depthwise=True),
        L("b2_pw", 64, 24, 1, 1, 56, 56),
        L("b3_exp", 24, 120, 1, 1, 56, 56, repeat=3),
        L("b3_dw", 120, 120, 5, 1, 56, 56, repeat=3, depthwise=True),
        L("b3_pw", 120, 40, 1, 1, 56, 56, repeat=3),
        L("b4_exp", 40, 240, 1, 1, 28, 28, repeat=4),
        L("b4_dw", 240, 240, 3, 2, 28, 28, repeat=4, depthwise=True),
        L("b4_pw", 240, 80, 1, 1, 14, 14, repeat=4),
        L("b5_exp", 112, 672, 1, 1, 14, 14, repeat=3),
        L("b5_dw", 672, 672, 5, 1, 14, 14, repeat=3, depthwise=True),
        L("b5_pw", 672, 160, 1, 1, 14, 14, repeat=3),
        L("head", 160, 960, 1, 1, 7, 7),
    ]
    return cnn_operator_graph("mobilenetv3", layers, head_dim=(960, 1000))


def efficientnet_graph() -> OperatorGraph:
    L = ConvLayer
    layers = [
        L("stem", 3, 32, 3, 2, 224, 224),
        L("mb1_dw", 32, 32, 3, 1, 112, 112, depthwise=True),
        L("mb1_pw", 32, 16, 1, 1, 112, 112),
        L("mb2_exp", 16, 96, 1, 1, 112, 112, repeat=2),
        L("mb2_dw", 96, 96, 3, 2, 112, 112, repeat=2, depthwise=True),
        L("mb2_pw", 96, 24, 1, 1, 56, 56, repeat=2),
        L("mb3_exp", 24, 144, 1, 1, 56, 56, repeat=2),
        L("mb3_dw", 144, 144, 5, 2, 56, 56, repeat=2, depthwise=True),
        L("mb3_pw", 144, 40, 1, 1, 28, 28, repeat=2),
        L("mb4_exp", 40, 240, 1, 1, 28, 28, repeat=3),
        L("mb4_dw", 240, 240, 3, 2, 28, 28, repeat=3, depthwise=True),
        L("mb4_pw", 240, 80, 1, 1, 14, 14, repeat=3),
        L("mb6_exp", 112, 672, 1, 1, 14, 14, repeat=4),
        L("mb6_dw", 672, 672, 5, 2, 14, 14, repeat=4, depthwise=True),
        L("mb6_pw", 672, 192, 1, 1, 7, 7, repeat=4),
        L("head", 320, 1280, 1, 1, 7, 7),
    ]
    return cnn_operator_graph("efficientnet", layers, head_dim=(1280, 1000))


def replknet_graph() -> OperatorGraph:
    """RepLKNet-31B: the paper's large-kernel outlier — 31x31 depthwise
    convolutions interleaved with 1x1s (paper §1, §6.1)."""
    L = ConvLayer
    layers = [
        L("stem", 3, 128, 3, 2, 224, 224),
        L("s1_pw1", 128, 128, 1, 1, 56, 56, repeat=2),
        L("s1_lk31", 128, 128, 31, 1, 56, 56, repeat=2, depthwise=True),
        L("s1_pw2", 128, 512, 1, 1, 56, 56, repeat=2),
        L("s1_pw3", 512, 128, 1, 1, 56, 56, repeat=2),
        L("s2_pw1", 256, 256, 1, 1, 28, 28, repeat=2),
        L("s2_lk31", 256, 256, 31, 1, 28, 28, repeat=2, depthwise=True),
        L("s2_pw2", 256, 1024, 1, 1, 28, 28, repeat=2),
        L("s2_pw3", 1024, 256, 1, 1, 28, 28, repeat=2),
        L("s3_pw1", 512, 512, 1, 1, 14, 14, repeat=18),
        L("s3_lk31", 512, 512, 31, 1, 14, 14, repeat=18, depthwise=True),
        L("s3_pw2", 512, 2048, 1, 1, 14, 14, repeat=18),
        L("s3_pw3", 2048, 512, 1, 1, 14, 14, repeat=18),
        L("s4_pw1", 1024, 1024, 1, 1, 7, 7, repeat=2),
        L("s4_lk13", 1024, 1024, 13, 1, 7, 7, repeat=2, depthwise=True),
        L("s4_pw2", 1024, 4096, 1, 1, 7, 7, repeat=2),
        L("s4_pw3", 4096, 1024, 1, 1, 7, 7, repeat=2),
    ]
    return cnn_operator_graph("replknet31b", layers, head_dim=(1024, 1000))


def vit_graph(name: str = "vit_b16", d: int = 768, n_layers: int = 12,
              n_heads: int = 12, d_ff: int = 3072,
              n_tokens: int = 197) -> OperatorGraph:
    spec = LMSpec(name=name, n_layers=n_layers, d_model=d, n_heads=n_heads,
                  kv_heads=n_heads, d_ff=d_ff, vocab=1000, swiglu=False)
    g = lm_operator_graph(spec, seq=n_tokens, phase="prefill")
    return dataclasses.replace(g, network=name, phase="vision")


# Paper LLM workloads --------------------------------------------------------

OPT_66B = LMSpec(name="opt66b", n_layers=64, d_model=9216, n_heads=72,
                 kv_heads=72, d_ff=36864, vocab=50272, swiglu=False)
OPT_1_3B = LMSpec(name="opt1.3b", n_layers=24, d_model=2048, n_heads=32,
                  kv_heads=32, d_ff=8192, vocab=50272, swiglu=False)


def paper_workloads(seq: int = 2048) -> dict[str, OperatorGraph]:
    """The paper's evaluation suite (§5), as operator graphs."""
    return {
        "resnet50": resnet50_graph(),
        "mobilenetv3": mobilenetv3_graph(),
        "efficientnet": efficientnet_graph(),
        "replknet31b": replknet_graph(),
        "vit_b16": vit_graph(),
        "opt66b_prefill": lm_operator_graph(OPT_66B, seq, "prefill"),
        "opt66b_decode": lm_operator_graph(OPT_66B, seq, "decode",
                                           cache_len=seq),
    }

"""mfu (%): the model FLOPs of every prompt and output token the window
processed (`harness/work.model_flops`: 2 x the matmul parameters a token
uses, plus attention over the keys it sees) / (the window's seconds x
989 TFLOP/s, the H100 SXM's dense bf16 peak)."""
from harness import work


def read(ctx):
    prefills, positions = ctx["processed"]
    secs = ctx["closed"] - ctx["opened"]
    if secs <= 0 or not (prefills or positions):
        return None
    return work.model_flops(ctx["cfg"], prefills, positions) / (secs * work.PEAK_BF16_FLOPS) * 100.0

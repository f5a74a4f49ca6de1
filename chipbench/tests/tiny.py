"""Tiny copies of the benchmark's cells for CPU tests: each
configuration's file with small widths, a short mix, four slots."""
from __future__ import annotations

import copy
import json

from harness.bench import HERE, Cell

SMALL = {
    "h2o-danube-1.8b": dict(hidden_size=64, num_attention_heads=4, num_key_value_heads=2,
                            intermediate_size=96, vocab_size=512, num_hidden_layers=2,
                            sliding_window=24),
}


def config(name: str, dtype: str = "float32") -> dict:
    cfg = json.loads((HERE / "configs" / name / "config.json").read_text())
    cfg.update(SMALL[name], torch_dtype=dtype)
    return cfg


def cell(name: str, config_name: str, dtype: str = "float32", slots: int = 4,
         prompt=(8, 40), output=(4, 12), gap_limit: float = 1e-3) -> Cell:
    policy = json.loads((HERE / "configs" / config_name / "policy.json").read_text())
    traffic = {"loop": "closed", "deck": 8, "temperature": 0.0,
               "prompt": {"dist": "uniform", "min": prompt[0], "max": prompt[1]},
               "output": {"dist": "uniform", "min": output[0], "max": output[1]}}
    spec = {"slots": slots, "max_len": prompt[1] + output[1] + 8, "trace_seconds": 0.5,
            "check": {"sample_tokens": 24, "sample_max": 3, "logit_gap_limit": gap_limit}}
    return Cell(name=name, chips=1, config=config(config_name, dtype), policy=copy.deepcopy(policy),
                traffic=traffic, spec=spec, end_to_end=[], per_layer=[])


class StepClock:
    """A host clock that moves 1 ms at each read, so that a window on the
    CPU holds the same steps however loaded the host is."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        self.t += 1e-3
        return self.t


def run(c: Cell, seed: int, seconds: float, **kw) -> dict:
    """`harness.runner.run` on the CPU under a `StepClock`."""
    from harness import runner

    clock = StepClock()
    return runner.run(c, seed, seconds, False, device="cpu", t_start=clock(), clock=clock,
                      log=lambda m: None, **kw)

"""The plain references against the program's CPU path at a tiny size,
float32: the full forward (40 tokens past a 24-token window), and the
served path end to end (the gap of every served token nought)."""
import importlib

import pytest
import torch

from harness import runner, weights
from repro_torch.models import api

import tiny

REFS = {"h2o-danube-1.8b": "llama"}


def _setup(name):
    cfg = tiny.config(name)
    mc = runner.family(cfg).model_config(cfg)
    w = weights.draw(runner.layout(cfg, mc), 7, "cpu", torch.float32)
    ref = importlib.import_module(f"reference.{cfg['reference']}")
    toks = torch.randint(0, cfg["vocab_size"], (40,), generator=torch.Generator().manual_seed(3))
    return cfg, mc, w, ref, toks


@pytest.mark.parametrize("name", sorted(REFS))
def test_forward_matches_program(name):
    cfg, mc, w, ref, toks = _setup(name)
    with torch.no_grad():
        want = api.forward(mc, w, {"tokens": toks[None]})[0].float()
        got = ref.logits(cfg, w, toks, 1)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) < 2e-4 * float(want.abs().max())


@pytest.mark.parametrize("name", sorted(REFS))
def test_served_tokens_are_the_references_best(name):
    out = tiny.run(tiny.cell("t", name), 11, 0.3)
    assert out["correct"], out["checks"]
    assert out["checks"]["logit_gap"]["value"] < 1e-4
    assert out["failed"] == 0 and out["attempted"] > 4

"""A run with its timed path broken underneath comes out not correct:
each fault a served cell can have, planted in the program at a tiny size
on the CPU (the harness's look for a card skipped), judged against each
cell's own limits, against the same run unbroken."""
import json

import pytest

from repro_torch.models import transformer
from repro_torch.serving import engine as engine_mod

from harness.bench import HERE, ROOT
from harness.runner import COMPARED

import tiny

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [(w["name"], w["config"]) for w in BENCH["workloads"]]


def _run(cell, config, seed=5):
    c = tiny.cell("t", config, prompt=(8, 40), output=(4, 12))
    c.spec["check"] = json.loads((HERE / "cells" / f"{cell}.json").read_text())["check"]
    return tiny.run(c, seed, 0.3)


def _altered_tokens(monkeypatch):
    """Tokens altered where they are produced: at every fifth sampling
    (a prefill's first token, or a decode step's tokens) each token comes
    out one id higher, and is served and fed back so."""
    orig = engine_mod.ServingEngine._agree
    n = [0]

    def agree(self, values):
        out = orig(self, values)
        n[0] += 1
        return [(t + 1) % self.mcfg.vocab for t in out] if n[0] % 5 == 0 else out

    monkeypatch.setattr(engine_mod.ServingEngine, "_agree", agree)


def _state_unchanged(monkeypatch):
    """A decode step that returns its state unchanged: the new token's
    key and value (MLA: its latent) are never written to the cache."""
    monkeypatch.setattr(transformer, "write_slot", lambda cache, new, slot: None)


FAULTS = {"token_altered": _altered_tokens, "state_unchanged": _state_unchanged}


@pytest.mark.parametrize("cell", CELLS, ids=[c[0] for c in CELLS])
def test_unbroken_is_correct(cell):
    out = _run(*cell)
    assert out["correct"], out["checks"]
    assert any(n in out["checks"] for n in COMPARED)


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS, ids=[c[0] for c in CELLS])
def test_fault_is_not_correct(cell, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    out = _run(*cell)
    ck = out["checks"]
    assert not out["correct"], ck
    assert ck["failed_requests"]["value"] == 0
    assert any(ck[n]["value"] > ck[n]["limit"] for n in COMPARED if n in ck), ck

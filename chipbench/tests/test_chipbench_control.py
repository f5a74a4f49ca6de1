"""The control comes out not correct: the reference in float8 (the
precision below the configuration's bfloat16) put in the program's
place, its first choice at each served position judged by the float32
reference and by the harness's own decision (`runner.run(control=True)`)
against the cell's own limits, where the program passes them.

On the CPU at a small size (bfloat16 program); on the card at each
cell's own size (marked `card`)."""
import json
import time

import pytest

from harness import runner
from harness.runner import COMPARED
from harness.bench import HERE, load_cell

import tiny

CELLS = {"danube.longctx": "h2o-danube-1.8b", "danube.rag": "h2o-danube-1.8b"}


def _check(cell: str) -> dict:
    return json.loads((HERE / "cells" / f"{cell}.json").read_text())["check"]


def _judged(out: dict) -> None:
    """The control failed the harness's decision; the program's own
    numbers of the same run passed it."""
    ck = out["checks"]
    assert not out["correct"], ck
    assert any(ck[n]["value"] > ck[n]["limit"] for n in COMPARED if n in ck), ck
    assert out["failed"] == 0
    assert all(out["compared"][n] <= ck[n]["limit"] for n in COMPARED if n in ck), out["compared"]


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_control_fails_where_program_passes_small(cell, seed):
    c = tiny.cell("t", CELLS[cell], "bfloat16", prompt=(32, 96), output=(8, 16))
    c.spec["check"] = dict(_check(cell), sample_tokens=200, sample_max=20)
    c.config.update(vocab_size=4096)
    _judged(tiny.run(c, seed, 1.0, control=True))


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cells run at their own size")
    return torch


@pytest.mark.card
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_control_fails_where_program_passes_on_card(card, cell):
    c = load_cell(cell)
    for seed in (901, 902, 903):
        _judged(runner.run(c, seed, 20.0, False, device="cuda", t_start=time.monotonic(),
                           control=True, log=lambda m: None))

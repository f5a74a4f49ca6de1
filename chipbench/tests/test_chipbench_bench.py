"""BENCHMARK.json and the files it names: every cell, configuration,
mix and per-layer metric found by its name, and the declarations kept
to the benchmark's rules."""
import json
import re

import pytest

from harness.bench import HERE, ROOT, load_cell, reader

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_names_and_units():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += CELLS + [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"]) and m["better"] in ("lower", "higher")
    assert {m["name"] for m in BENCH["end_to_end"]} >= {"setup_s", "tokens_per_s"}
    for m in BENCH["end_to_end"]:
        assert 0 < m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")


def test_configs_name_their_files():
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        assert (ROOT / c["file"]).parent == HERE / "configs" / c["name"]
        assert not any(k.endswith(("_dim", "_rank", "_size")) for k in c["reduced"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_and_metrics(cell):
    c = load_cell(cell)
    assert c.chips == 1 and c.spec["slots"] >= 1
    assert any(f"{n}_limit" in c.spec["check"] for n in ("logit_gap", "mean_logit_gap"))
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    for m in c.per_layer:
        assert m["moves"] in e2e, (m["name"], m["moves"])
        assert callable(reader(m["name"]))


def test_per_layer_moves_an_end_to_end_metric():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and m["layer"]
        if "roofline" in m["name"]:
            assert m["unit"] == "%" and re.match(r"^[a-z_]+_roofline(\.|$)", m["name"])

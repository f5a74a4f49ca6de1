"""The benchmark's data, found by the names in `BENCHMARK.json`.

A cell (`workloads` entry) names a configuration and a traffic mix; the
files behind them are

* `chipbench/configs/<config>/config.json`: the published keys,
  `reference` (the module under `chipbench/reference/`) and `layout`
  (the module under `chipbench/layouts/` that reads the published keys
  into `repro_torch`'s `ModelConfig` and lays out the weights);
  `policy.json` beside it, the execution policy;
* `chipbench/traffic/<mix>.json`: lengths, loop and deck;
* `chipbench/cells/<cell>.json`: slots, `max_len`, the traced
  sub-window and the correctness check's sample and limit;
* `chipbench/layer_metrics/<metric>.py`: one reader a per-layer metric.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]          # chipbench/
ROOT = HERE.parent


def _json(path: Path) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict          # configs/<config>/config.json
    policy: dict          # configs/<config>/policy.json
    traffic: dict         # traffic/<mix>.json
    spec: dict            # cells/<cell>.json
    end_to_end: list      # the BENCHMARK.json metrics this cell reports
    per_layer: list


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench_path: Path | None = None) -> Cell:
    bench = _json(bench_path or ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[name]
    cdir = HERE / "configs" / w["config"]
    return Cell(
        name=name, chips=int(w["chips"]), config=_json(cdir / "config.json"),
        policy=_json(cdir / "policy.json"),
        traffic=_json(HERE / "traffic" / f"{w['traffic']}.json"),
        spec=_json(HERE / "cells" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)])


def load_module(path: Path, name: str):
    """A module from a file whose name need not be an identifier (a
    metric's reader: `layer_metrics/<metric>.py`)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str):
    """The `read(ctx)` of `layer_metrics/<metric>.py`."""
    path = HERE / "layer_metrics" / f"{metric}.py"
    return load_module(path, "chipbench_metric_" + metric.replace(".", "_")).read

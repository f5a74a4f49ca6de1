"""Render the dry run's roofline and cell tables (markdown) from the
port's records in experiments/dryrun_torch/ (from `repro.launch.report`).

    PYTHONPATH=src python -m repro_torch.launch.report [--mesh single] \\
        [--table roofline|dryrun]

The roofline terms divide by one H100 SXM's data-sheet peaks
(`launch.analyze`: derived, not measured), which the tables' headings
state.
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from .analyze import HBM_BW, LINK_BW, PEAK_FLOPS

DRYRUN_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                          "experiments", "dryrun_torch")
ORDER = {"train_4k": 0, "prefill_32k": 1, "decode_32k": 2, "long_500k": 3}


def peaks() -> str:
    return (f"H100 SXM data sheet, 700 W: {PEAK_FLOPS / 1e12:.0f} TFLOP/s bf16 dense, "
            f"{HBM_BW / 1e12:.2f} TB/s HBM, {LINK_BW / 1e9:.0f} GB/s NVLink each way "
            f"(derived, not measured)")


def load(mesh: str | None = None, tag: str = "", directory: str = DRYRUN_DIR) -> list[dict]:
    recs = []
    for fn in sorted(glob.glob(os.path.join(directory, "*.json"))):
        with open(fn) as f:
            r = json.load(f)
        if (mesh is None or r.get("mesh") == mesh) and r.get("tag", "") == tag:
            recs.append(r)
    recs.sort(key=lambda r: (r["arch"], ORDER.get(r["shape"], 9), r["mesh"]))
    return recs


def _fmt_t(x: float) -> str:
    if x >= 1.0:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x * 1e3:.2f}ms"
    return f"{x * 1e6:.1f}us"


def _fmt_b(x: float) -> str:
    for unit, div in (("TB", 1e12), ("GB", 1e9), ("MB", 1e6), ("KB", 1e3)):
        if x >= div:
            return f"{x / div:.2f}{unit}"
    return f"{x:.0f}B"


def roofline_table(mesh: str = "single", directory: str = DRYRUN_DIR) -> str:
    rows = [f"Roofline, one rank of the {mesh} mesh; peaks: {peaks()}.", "",
            "| arch | shape | t_comp | t_mem | t_coll | bottleneck | "
            "roofline-frac | MF-ratio | HBM/dev |",
            "|---|---|---|---|---|---|---|---|---|"]
    for r in load(mesh, directory=directory):
        if not r.get("ok"):
            rows.append(f"| {r['arch']} | {r['shape']} | FAIL "
                        f"{r.get('error', '')[:40]} | | | | | | |")
            continue
        rf = r["roofline"]
        t = (rf["t_compute"], rf["t_memory"], rf["t_collective"])
        dom = max(t)
        frac = rf["t_compute"] / dom if dom else 0.0
        ma = r.get("memory_analysis") or {}
        hbm = ma.get("argument_size_in_bytes", 0) + ma.get("temp_size_in_bytes", 0)
        rows.append(
            f"| {r['arch']} | {r['shape']} | {_fmt_t(t[0])} "
            f"| {_fmt_t(t[1])} | {_fmt_t(t[2])} | {rf['bottleneck']} "
            f"| {frac:.2f} | {rf['model_flops_ratio']:.3f} | {_fmt_b(hbm)} |")
    return "\n".join(rows)


def dryrun_table(directory: str = DRYRUN_DIR) -> str:
    """Every cell's per-device counts, one row a (arch, shape), each value
    "single / multi" (the two meshes)."""
    by: dict = {}
    for r in load(directory=directory):
        by.setdefault((r["arch"], r["shape"]), {})[r["mesh"]] = r
    rows = [f"Dry-run cells, per device (one rank's traced step, plain route), each value "
            f"single / multi pod; peaks: {peaks()}.", "",
            "| arch | shape | hold | ok | FLOPs/dev | bytes/dev | coll bytes/dev | "
            "args/dev | temps/dev | MF-ratio | trace |",
            "|---|---|---|---|---|---|---|---|---|---|---|"]

    def both(recs, fn):
        return " / ".join(fn(r) if r.get("ok") else "FAIL" for r in recs)

    for (arch, shape), meshes in sorted(by.items(), key=lambda kv: (kv[0][0],
                                                                  ORDER.get(kv[0][1], 9))):
        recs = [meshes[m] for m in ("single", "multi") if m in meshes]
        ok = " / ".join("yes" if r.get("ok") else f"FAIL {r.get('error', '')[:50]}"
                        for r in recs)
        rows.append(
            f"| {arch} | {shape} | {recs[0].get('hold', '')} | {ok} "
            f"| {both(recs, lambda r: format(r['roofline']['flops_per_device'], '.3g'))} "
            f"| {both(recs, lambda r: _fmt_b(r['roofline']['bytes_per_device']))} "
            f"| {both(recs, lambda r: _fmt_b(r['roofline']['collective_bytes_per_device']))} "
            f"| {both(recs, lambda r: _fmt_b(r['memory_analysis']['argument_size_in_bytes']))} "
            f"| {both(recs, lambda r: _fmt_b(r['memory_analysis']['temp_size_in_bytes']))} "
            f"| {both(recs, lambda r: format(r['roofline']['model_flops_ratio'], '.3f'))} "
            f"| {both(recs, lambda r: format(r.get('trace_s', 0), '.0f') + 's')} |")
    return "\n".join(rows)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--table", choices=("roofline", "dryrun"), default="roofline")
    args = ap.parse_args(argv)
    if args.table == "roofline":
        print(roofline_table(args.mesh))
    else:
        print(dryrun_table())


if __name__ == "__main__":
    main()

"""The port's benchmark: one run of one cell of `BENCHMARK.json`.

    python3 chipbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Serves the cell's configuration through `repro_torch`'s `ServingEngine`
on one CUDA device under a closed loop of clients, measures a window of
`--seconds`, checks the served tokens against the plain reference, and
prints one JSON line last on standard output: `correct`, `attempted`,
`failed`, `metrics` (the cell's end-to-end metrics; with `--trace 1` its
per-layer metrics), `device`, with `--trace 1` `breakdown`, and last
`checks`, each compared number beside its limit (also the last lines of
standard error).  Exits non-zero, printing no result, without enough
CUDA devices, and if JAX or the JAX package was loaded.
"""
import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def setup_env() -> None:
    """Caches at fixed paths inside the checkout; the program's package
    and the harness importable; libraries kept from loading JAX."""
    build = ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for p in (str(ROOT / "src"), str(HERE)):
        if p not in sys.path:
            sys.path.insert(0, p)


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def metrics_of(cell, out: dict, trace: bool) -> dict:
    """The cell's metrics of this run: end-to-end, or per-layer with
    `trace`; a per-layer reader that finds nothing leaves its metric out."""
    from harness.bench import reader

    ms = {}
    if trace:
        for m in cell.per_layer:
            v = reader(m["name"])(out["ctx"])
            if v is not None:
                ms[m["name"]] = {"value": v, "unit": m["unit"]}
        return ms
    e2e = dict(out["ctx"]["e2e"], setup_s=out["setup_s"])
    for m in cell.end_to_end:
        if e2e.get(m["name"]) is not None:
            ms[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    return ms


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    setup_env()
    from harness.bench import load_cell

    cell = load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"chipbench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"available: {torch.cuda.is_available()}, count "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    torch.set_num_threads(1)
    from harness import guard, runner

    out = runner.run(cell, args.seed, args.seconds, bool(args.trace), device="cuda",
                     t_start=T_START)
    print(f"[chipbench] {args.workload} seed {args.seed} on {card_line()}", file=sys.stderr)
    line = {"correct": out["correct"], "attempted": out["attempted"], "failed": out["failed"],
            "metrics": metrics_of(cell, out, bool(args.trace)),
            "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                       "count": cell.chips, "memory_peak_bytes": out["peak_bytes"]}}
    tr = out["trace"]
    if args.trace:
        line["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
        line["breakdown"] = {"device_ops": tr.device_ops, "idle_gaps": tr.idle_gaps}
    line["checks"] = out["checks"]
    bad = guard.forbidden_loaded()
    if bad:
        print(f"chipbench: modules of JAX or the JAX package were loaded: {bad}",
              file=sys.stderr)
        return 4
    if out["failure"]:
        print(f"chipbench: the run failed: {out['failure']}", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

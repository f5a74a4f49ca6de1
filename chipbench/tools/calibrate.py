"""Readings behind a cell's limit, on the card: runs of the cell in one
process, one a seed, each with the float8 control read over the same
prompts and served tokens (`harness/check.gaps(control=True)`); prints a
JSON line a seed with the program's numbers and whether they pass
(`program_correct`), the control's and the harness's decision on them
(`control_correct`, which has to be false), the end-to-end numbers and,
with --trace 1, the per-layer ones.

    python3 chipbench/tools/calibrate.py --workload <cell> --seeds 1,2,3 \
        --seconds 20 [--trace 1] [--out <file>.jsonl]

Not a benchmark run: `run.py` never reads the control.
"""
import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import run as bench_run  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out")
    args = ap.parse_args()
    bench_run.setup_env()
    import torch

    from harness import runner
    from harness.bench import load_cell

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 3
    torch.set_num_threads(1)
    cell = load_cell(args.workload)
    card = bench_run.card_line()
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.monotonic()
        out = runner.run(cell, seed, args.seconds, bool(args.trace), device="cuda", t_start=t0,
                         control=True)
        row = {"workload": args.workload, "seed": seed, "card": card,
               "program_correct": out["failure"] is None and out["failed"] == 0 and all(
                   out["compared"].get(n, float("inf")) <= c["limit"]
                   for n, c in out["checks"].items() if n in runner.COMPARED),
               "control_correct": out["correct"],
               "failed": out["failed"], "failure": out["failure"],
               "checks": out["checks"], "compared": out["compared"], "setup_s": out["setup_s"],
               "e2e": {k: v for k, v in out["ctx"]["e2e"].items()},
               "metrics": bench_run.metrics_of(cell, out, bool(args.trace)),
               "peak_bytes": out["peak_bytes"], "wall_s": time.monotonic() - t0}
        if args.trace:
            tr = out["trace"]
            row.update(busy_s=tr.busy_s, window_s=tr.window_s, attributed=tr.attributed,
                       device_ops=tr.device_ops, idle_gaps=tr.idle_gaps, calls=tr.calls,
                       device_s=tr.device_s)
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            with open(args.out, "a", encoding="utf-8") as f:
                f.write(line + "\n")
        del out
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

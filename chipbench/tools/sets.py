"""Runs `chipbench/run.py` once a seed, each a process of its own as the
check runs it, and appends each run's result line (with its seed, exit
code, wall seconds and the last lines of its standard error) to a file.

    python3 chipbench/tools/sets.py --workload <cell> --seeds 1,2,3 \
        --seconds 20 --trace 0 --out <file>.jsonl
"""
import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", required=True)
    ap.add_argument("--trace", default="0")
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    for seed in args.seeds.split(","):
        t0 = time.monotonic()
        p = subprocess.run([sys.executable, "chipbench/run.py", "--workload", args.workload,
                            "--seed", seed, "--seconds", args.seconds, "--trace", args.trace],
                           cwd=ROOT, capture_output=True, text=True)
        lines = p.stdout.strip().splitlines()
        try:
            result = json.loads(lines[-1]) if lines else None
        except json.JSONDecodeError:
            result = None
        row = {"workload": args.workload, "seed": int(seed), "trace": int(args.trace),
               "rc": p.returncode, "wall_s": time.monotonic() - t0, "result": result,
               "stderr_tail": p.stderr[-3000:]}
        with open(out, "a", encoding="utf-8") as f:
            f.write(json.dumps(row) + "\n")
        print(json.dumps({k: row[k] for k in ("workload", "seed", "rc", "wall_s")}
                         | {"result": result}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

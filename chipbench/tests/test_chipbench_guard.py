"""No JAX and no JAX package in a run: the check by whole top-level
name, what the harness loads, and a run without a card printing no
result."""
import subprocess
import sys

from harness import guard
from harness.bench import ROOT


def test_whole_top_level_names():
    assert guard.forbidden_loaded({"repro_torch", "repro_torch.serving", "jaxtyping",
                                   "reprox", "flax_like"}) == []
    assert guard.forbidden_loaded({"repro", "repro.models", "jax", "jaxlib.xla_client",
                                   "flax.linen", "numpy"}) == [
        "flax.linen", "jax", "jaxlib.xla_client", "repro", "repro.models"]


def _python(code: str):
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)


def test_the_harness_loads_neither():
    code = ("import sys; sys.path[:0] = ['src', 'chipbench']\n"
            "import run; run.setup_env()\n"
            "from harness import runner, trace, check, guard\n"
            "from harness.bench import load_cell, reader\n"
            "import reference.llama, layouts.transformer\n"
            "import repro_torch.serving.engine, repro_torch.launch.serve\n"
            "import json; b = json.load(open('BENCHMARK.json'))\n"
            "[reader(m['name']) for m in b['per_layer']]\n"
            "[load_cell(w['name']) for w in b['workloads']]\n"
            "print(guard.forbidden_loaded())")
    p = _python(code)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip().splitlines()[-1] == "[]"


def test_no_card_no_result():
    p = subprocess.run([sys.executable, "chipbench/run.py", "--workload", "danube.rag",
                        "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True, timeout=300,
                       env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
                            "HOME": str(ROOT / "build")})
    assert p.returncode != 0
    assert p.stdout.strip() == ""

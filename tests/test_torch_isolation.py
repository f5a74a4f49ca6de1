"""The PyTorch/CUDA port stands alone: no module of `src/repro_torch/`,
and not `chip_smoke.py`, imports JAX or the JAX package `repro`; no file
of the port is a second knob registry or reads `MOZART_*` variables; and
its entry points run on CUDA unless told otherwise, raising where there
is no CUDA device."""
import ast
import pathlib

import pytest
import torch

from repro_torch import configs
from repro_torch.serving.engine import ServingEngine

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_modules(path: pathlib.Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module or "")
    return names


def test_port_files_exist():
    rel = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    assert "chip_smoke.py" in rel
    for name in ("fused_norm", "fused_mlp", "flash_attention", "moe_mlp", "wkv6",
                 "rglru_scan"):
        for part in ("kernel", "ops", "ref"):
            assert f"src/repro_torch/kernels/{name}/{part}.py" in rel
    for path in ("configs/mixtral_8x7b.py", "csrc/paged_decode.cu",
                 "csrc/moe_mlp.cu", "csrc/mlp_tile.cuh", "kernels/_mlp_plan.py",
                 "kernels/_attn_plan.py"):
        assert (ROOT / "src" / "repro_torch" / path).is_file(), path


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_or_repro_import(path):
    bad = sorted(m for m in _imported_modules(path)
                 if m.split(".")[0] in FORBIDDEN)
    assert not bad, f"{path.name} imports {bad}"


def test_no_knob_registry_or_env_knobs():
    for path in PORT_FILES:
        assert not path.as_posix().endswith("launch/knobs.py")
        assert "MOZART_" not in path.read_text(), path


def test_engine_without_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    cfg = configs.get_smoke_config("smollm-135m")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(cfg, {})

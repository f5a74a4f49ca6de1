"""pytest set-up for the benchmark's own tests (`pytest chipbench/tests`):
the harness and the program's package importable, and the `card` marker
for the tests that need a CUDA device (they decide inside a fixture and
skip without one)."""
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
for p in (str(HERE.parent / "src"), str(HERE)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device; skips without one")

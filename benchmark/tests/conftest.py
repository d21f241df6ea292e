"""The benchmark's own tests (not collected by the repository's
`pytest tests/`):  python -m pytest benchmark/tests -q

Tests that need a CUDA card carry the `cuda` marker and decide inside the
test whether there is one."""
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
for p in (BENCH, os.path.dirname(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips without one")

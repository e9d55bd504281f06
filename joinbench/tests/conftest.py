"""The benchmark's own tests: ``python -m pytest joinbench/tests -q`` from
the checkout's root (CPU); on a machine with a card, ``python -m pytest
joinbench/tests -q -m gpu`` runs the tests marked ``gpu``.  They import
no JAX."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: runs on a CUDA device; skips without one")

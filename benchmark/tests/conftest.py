"""CPU tests of the benchmark harness (``python3 -m pytest benchmark/tests``).
Tests marked ``card`` need a CUDA device and skip without one; on the card
they run with ``python3 -m pytest benchmark/tests -m card``."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skips without one")

"""The benchmark's CPU tests: ``python -m pytest rtbench/tests -q``."""

import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; decides inside the test and skips without one")

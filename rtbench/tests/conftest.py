"""The benchmark's CPU tests: ``python -m pytest rtbench/tests -q``."""

import os
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; decides inside the test and skips without one")
    # Workers of ``-n N`` share the cores: each with all of them in
    # torch's pool oversubscribes the host many times over.
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    if workers > 1:
        import torch

        torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))

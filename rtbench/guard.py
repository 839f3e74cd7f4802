"""What a run checks about its process: its age, the cards it has, and
that the JAX package and JAX stayed out of it."""

from __future__ import annotations

import os
import sys
import time

# Top-level module names that may not be loaded in a run's process.
FORBIDDEN = ("jax", "jaxlib", "flax", "rt_rs_tpu")


class RunRefused(Exception):
    """The run cannot give a result (no card, too few, a forbidden
    module); its message says why."""


def process_age_s() -> float:
    """Seconds since this process started (Linux: from /proc; the start
    tick has 1/CLK_TCK resolution)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start_ticks = int(fields[19])  # field 22, starttime, after pid and comm
    return time.clock_gettime(time.CLOCK_BOOTTIME) - start_ticks / os.sysconf("SC_CLK_TCK")


def forbidden_modules(modules=None) -> list[str]:
    """Names in ``modules`` (default ``sys.modules``) whose top-level
    name, the part before the first dot, is one of :data:`FORBIDDEN`:
    compared whole, so ``rt_rs_tpu_torch`` is allowed."""
    modules = sys.modules if modules is None else modules
    return sorted(m for m in modules if m.split(".", 1)[0] in FORBIDDEN)


def require_no_jax() -> None:
    found = forbidden_modules()
    if found:
        raise RunRefused(f"forbidden modules loaded in the run's process: {', '.join(found)}")


def require_cards(n: int) -> None:
    import torch

    if not torch.cuda.is_available():
        raise RunRefused("no CUDA device: the benchmark runs on the card only")
    if torch.cuda.device_count() < n:
        raise RunRefused(f"the cell needs {n} CUDA devices, {torch.cuda.device_count()} found")

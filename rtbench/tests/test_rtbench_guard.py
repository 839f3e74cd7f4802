"""The no-JAX check compares whole top-level names; a run on a host
without a card fails with no result."""

import os
import pathlib
import subprocess
import sys

import pytest

from rtbench import guard

ROOT = pathlib.Path(__file__).resolve().parents[2]


@pytest.mark.parametrize(
    "name, bad",
    [
        ("jax", True), ("jax.numpy", True), ("jaxlib.xla_client", True), ("flax", True),
        ("rt_rs_tpu", True), ("rt_rs_tpu.ops.shade", True),
        ("rt_rs_tpu_torch", False), ("rt_rs_tpu_torch.renderer", False), ("jaxtyping", False),
        ("rtbench.harness", False), ("torch", False),
    ],
)
def test_forbidden_names_are_whole(name, bad):
    assert guard.forbidden_modules({name: None}) == ([name] if bad else [])


def test_the_harness_and_the_port_load_no_jax():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from rtbench import harness, calibrate, faults\n"
        "from rtbench.drive import make_renderer\n"
        "import rt_rs_tpu_torch.renderer\n"
        "from rtbench import guard; guard.require_no_jax(); print('clean')\n"
    ) % str(ROOT)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    out = subprocess.run(
        [sys.executable, "rtbench/run.py", "--workload", "teatime.orbit_384", "--seed", "5", "--seconds", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 2
    assert out.stdout == ""
    assert "no CUDA device" in out.stderr


def test_process_age():
    assert 0.0 <= guard.process_age_s() < 24 * 3600

"""On the card: one short run of each cell through ``rtbench/run.py``,
correct, with its metrics.  Run there with
``python3 -m pytest rtbench/tests -m card -q``."""

import json
import pathlib
import subprocess
import sys

import pytest

from rtbench import spec

ROOT = pathlib.Path(__file__).resolve().parents[2]


@pytest.mark.card
@pytest.mark.parametrize("cell", [w["name"] for w in spec.benchmark()["workloads"]])
def test_cell_runs_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "rtbench/run.py", "--workload", cell, "--seed", "3000000001", "--seconds", "2"],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"
    want = {m["name"] for m in spec.metrics_of(spec.benchmark(), "end_to_end", cell)}
    assert set(res["metrics"]) == want


@pytest.mark.card
def test_dynamic_cell_runs_through_the_harness():
    """The dynamic cell through ``harness.run`` in this process: the
    program's DynamicRenderer refits every frame of the breathing, and the
    reference traces each sampled frame's arrays; correct, with the
    structure of one frame counted."""
    import torch

    from rtbench import harness

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = "teatime_refit.breathe_1080"
    res = harness.run(spec.benchmark(), cell, 2**31 + 4099, 2.0, False, log=lambda line: None)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 64 and res["failed"] == 0
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert set(m) == {x["name"] for x in spec.metrics_of(spec.benchmark(), "end_to_end", cell)}
    assert m["accel_bytes"] > 0 and m["frame_ms"] > 0

"""A whole run but the look for a card, on the CPU at a small size:
sound, it comes out correct; with the timed path broken underneath
(each fault of ``rtbench/faults.py`` that the cell can have), not
correct."""

import pytest

from rtbench import faults, harness, spec

# a small mix of the cells' kind: their loop, a few frames
ORBIT = {
    "kind": "orbit", "width": 16, "height": 12, "chain": 4, "mult": 5.0, "frames_per_sync": 4,
    "warmup_syncs": 1, "trace_seconds": 0.1, "check": {"frames": 8, "pixels": 96},
}
# the same of the breathe kind, two dispatches of two frames a call (a
# CPU frame of DynamicRenderer takes seconds), so that a window's second
# dispatch renders other poses than the first's
BREATHE = {**ORBIT, "kind": "breathe", "chain": 2, "breathe": spec.traffic("breathe_1080")["breathe"]}
SEED = 2**31 + 977
# one cell on each path: kernel G at two sizes, and the packet kernels
# under DynamicRenderer's per-frame refit
CELLS = {"teatime.orbit_384": ORBIT, "teapots3.orbit_1080": ORBIT, "teatime_refit.breathe_1080": BREATHE}
CASES = [
    (cell, fault)
    for cell, mix in CELLS.items()
    for fault in sorted(faults.FAULTS)
    if fault not in faults.GEOMETRY_FAULTS or mix["kind"] == "breathe"
]


def run(cell, plant=None):
    undo = plant() if plant is not None else None
    try:
        return harness.run(
            spec.benchmark(), cell, SEED, 1.0, False, device="cpu", traffic=CELLS[cell], log=lambda line: None
        )
    finally:
        if undo is not None:
            undo()


@pytest.mark.parametrize("cell", list(CELLS))
def test_sound_run_is_correct(cell):
    res = run(cell)
    assert res["correct"] and res["failed"] == 0
    assert list(res)[-1] == "checks"
    assert set(res["metrics"]) == {m["name"] for m in spec.metrics_of(spec.benchmark(), "end_to_end", cell)}


@pytest.mark.parametrize("cell, fault", CASES, ids=[f"{c}-{f}" for c, f in CASES])
def test_fault_is_caught(cell, fault):
    res = run(cell, faults.FAULTS[fault])
    assert not res["correct"], res["checks"]

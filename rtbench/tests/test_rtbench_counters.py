"""The readers of the port's own counters and spans: the idle split by
the renderer's host spans on a synthetic trace, the counter readers on
stale and missing snapshots, the readers on the program's own snapshot
on the CPU, and (marked ``card``) a traced run of each cell on the card:

    python3 -m pytest rtbench/tests -m card -q
"""

import json
import pathlib
import subprocess
import sys

import pytest

from rtbench import counters, spans, spec
from rtbench.trace import Trace, base_name

ROOT = pathlib.Path(__file__).resolve().parents[2]

COUNTED = ["live_share", "cull_entries_m", "walk_nodes_per_ray", "walk_prims_per_ray"]
TOTALS = ["capture_s", "build_s"]


def synthetic():
    """A window of 10 ms, 2 frames: kernels with gaps, a graph replay
    and a copy-out on the host.  Device busy 0-2, 3-4, 6-7, 8-9 ms."""
    device = [
        ("mt_trace_items_kernel", 0.000, 0.002),
        ("shade_post_kernel", 0.003, 0.004),
        ("vectorized_elementwise_kernel", 0.006, 0.007),
        ("Memcpy DtoD (Device -> Device)", 0.008, 0.009),
    ]
    host = [
        ("rt.dispatch", 0.0000, 0.0050),
        ("rt.prepare", 0.0000, 0.0010),
        ("rt.replay", 0.0010, 0.0045),
        ("cudaGraphLaunch", 0.0011, 0.0044),  # not an rt. span: the replay stays innermost
        ("rt.copy_out", 0.0055, 0.0080),
        ("aten::clone", 0.0056, 0.0079),
        ("rt.sync", 0.0085, 0.0100),
    ]
    return Trace(0.0, 0.010, 2, device, host)


def test_idle_gaps_split_by_the_innermost_rt_span():
    t = synthetic()
    # gaps 2-3 (middle in rt.replay), 4-6 (middle 5.0, in rt.dispatch
    # past the replay), 7-8 (rt.copy_out), 9-10 (rt.sync)
    idle = spans.idle_by_span(t)
    assert idle == pytest.approx({"rt.replay": 0.001, "rt.dispatch": 0.002, "rt.copy_out": 0.001, "rt.sync": 0.001})
    assert spec.metric_reader("idle_launch_ms").read(t) == pytest.approx(0.001 * 1e3 / 2)
    assert spec.metric_reader("idle_host_ms").read(t) == pytest.approx(0.004 * 1e3 / 2)
    for name in ("idle_launch_ms", "idle_host_ms"):
        assert spec.metric_reader(f"{name}.384").read(t) == spec.metric_reader(name).read(t)


def test_idle_readers_need_an_rt_span():
    t = synthetic()
    t.host = [h for h in t.host if not h[0].startswith("rt.")]
    assert spans.idle_by_span(t) is None
    assert spec.metric_reader("idle_launch_ms").read(t) is None
    assert spec.metric_reader("idle_host_ms").read(t) is None


def fake_snapshot(frames):
    return {
        "live_rays": [100, 40, 20, 10, 0, 0, 0, 0], "slots": [200, 200, 200, 200, 0, 0, 0, 0],
        "cull_entries": {"rows.interval": 3_000_000, "anyhit.refine": 1_000_000},
        "walk_rays": 50, "walk_nodes": 200, "walk_prims": 75, "frames": frames,
        "capture_s": 0.4, "captures": 2, "build_s": 0.07, "library_s": 0.01, "library_built": 0, "launches": {},
    }


def test_counter_readers_read_a_snapshot_of_the_window(monkeypatch):
    t = synthetic()
    monkeypatch.setattr(counters, "snapshot", lambda trace: fake_snapshot(2))
    read = {n: spec.metric_reader(n).read(t) for n in COUNTED + TOTALS}
    assert read["live_share"] == pytest.approx(70 / 600)
    assert read["cull_entries_m"] == pytest.approx(2.0)
    assert read["walk_nodes_per_ray"] == pytest.approx(4.0)
    assert read["walk_prims_per_ray"] == pytest.approx(1.5)
    assert read["capture_s"] == 0.4 and read["build_s"] == 0.07
    assert spec.metric_reader("live_share.384").read(t) == read["live_share"]
    for name in ("walk_nodes_per_ray", "walk_prims_per_ray"):
        assert spec.metric_reader(f"{name}.384").read(t) == read[name]


@pytest.mark.parametrize("snap", [None, "stale"])
def test_counter_readers_refuse_a_stale_or_missing_snapshot(monkeypatch, snap):
    t = synthetic()
    monkeypatch.setattr(counters, "snapshot", lambda trace: None if snap is None else fake_snapshot(3))
    for name in COUNTED:
        assert spec.metric_reader(name).read(t) is None, name
    if snap is None:
        for name in TOTALS:
            assert spec.metric_reader(name).read(t) is None, name


def test_a_program_without_tracing_reads_as_nothing(monkeypatch):
    import builtins

    real = builtins.__import__

    def no_tracing(name, globals=None, locals=None, fromlist=(), level=0):
        if name == "rt_rs_tpu_torch" and fromlist and "tracing" in fromlist:
            raise ImportError("no rt_rs_tpu_torch.tracing")
        return real(name, globals, locals, fromlist, level)

    monkeypatch.setattr(builtins, "__import__", no_tracing)
    assert counters.snapshot(synthetic()) is None
    for name in COUNTED + TOTALS:
        assert spec.metric_reader(name).read(synthetic()) is None


def test_readers_read_the_programs_snapshot():
    """The CPU twins count while a profiler session records; a trace of
    the frames rendered in it reads them (a CPU trace has no device
    operation, so one stands in)."""
    from torch.profiler import ProfilerActivity, profile

    from rt_rs_tpu_torch import Renderer, tracing
    from rt_rs_tpu_torch.scene.presets import torus_scene

    r = Renderer(torus_scene(), size=(16, 12), device="cpu", handler="pbvh")
    r.render_frame()  # a check outside a session: the next one starts from zero
    with profile(activities=[ProfilerActivity.CPU]):
        r.animate(2, chain=2)
    snap = tracing.snapshot()
    t = Trace(0.0, 1.0, 2, [("mt_trace_items_kernel", 0.1, 0.2)], [])
    assert spec.metric_reader("live_share").read(t) == pytest.approx(sum(snap["live_rays"][1:]) / sum(snap["slots"][1:]))
    assert 0.0 < spec.metric_reader("live_share").read(t) < 1.0
    assert spec.metric_reader("cull_entries_m").read(t) == pytest.approx(sum(snap["cull_entries"].values()) / 2e6)
    assert spec.metric_reader("walk_nodes_per_ray").read(t) is None  # pbvh walks no tree
    assert spec.metric_reader("build_s").read(t) == snap["build_s"] > 0.0
    assert spec.metric_reader("capture_s").read(t) is None  # the CPU captures no graph
    t.frames = 3
    assert spec.metric_reader("live_share").read(t) is None


@pytest.mark.card
@pytest.mark.parametrize("cell", [w["name"] for w in spec.benchmark()["workloads"]])
def test_traced_run_reads_the_programs_counters(cell):
    """A ``--trace 1`` run reads every per-layer metric of the cell, the
    port's counters and spans within their ranges: the counters of the
    kernels the cell runs (the packet kernels, kernel G or the records
    walk), found by name in the trace's breakdown."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "rtbench/run.py", "--workload", cell, "--seed", "3000000002", "--seconds", "2", "--trace", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert set(m) == {x["name"] for x in spec.metrics_of(spec.benchmark(), "per_layer", cell)}

    def reading(name):
        return m[name + ".384"] if cell.endswith("384") else m[name]

    assert 0.0 < reading("live_share") <= 1.0
    assert m["capture_s"] > 0.0 and m.get("build_s", 1.0) > 0.0  # DynamicRenderer times no rt.build
    # what the cell runs, by the kernels its traced window spent most on
    ran = {base_name(n) for n, _ in res["breakdown"]["device_ops"]}

    if any(n.startswith("mt_trace") for n in ran):  # the packet kernels
        assert reading("cull_entries_m") > 0.0
    if "bvh_walk_tiled_kernel" in ran:  # kernel G
        assert reading("walk_nodes_per_ray") >= 1.0 and 0.0 < reading("walk_blocked_share") < 1.0
    if "bvh_walk_rf_kernel" in ran:  # the records walk
        assert m["rf_records_per_ray"] >= 1.0
    assert ran & {"mt_trace_items_kernel", "bvh_walk_tiled_kernel", "bvh_walk_rf_kernel"}

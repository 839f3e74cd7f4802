"""``walk_blocked_share``: its reader on a snapshot of the window, on a
stale or missing one, on a program that counts no any-hit walk, and on
the program's own snapshot of a threaded frame on the CPU."""

import pytest

from rtbench import counters, spec
from rtbench.trace import Trace


def window(frames=2):
    return Trace(0.0, 0.010, frames, [("bvh_walk_tiled_kernel", 0.001, 0.002)], [])


def fake_snapshot(frames, **walk):
    return {
        "live_rays": [0] * 8, "slots": [0] * 8, "cull_entries": {},
        "walk_rays": 50, "walk_nodes": 200, "walk_prims": 75, **walk, "frames": frames,
        "capture_s": 0.0, "captures": 0, "build_s": 0.0, "library_s": 0.0, "library_built": 0, "launches": {},
    }


def test_reads_blocked_over_anyhit(monkeypatch):
    monkeypatch.setattr(counters, "snapshot", lambda trace: fake_snapshot(2, walk_anyhit=40, walk_blocked=10))
    assert spec.metric_reader("walk_blocked_share").read(window()) == pytest.approx(0.25)


@pytest.mark.parametrize(
    "snap",
    [
        None,  # no device operation, or no tracing module
        fake_snapshot(3, walk_anyhit=40, walk_blocked=10),  # another window's frames
        fake_snapshot(2),  # a program without the any-hit counters (the parent's)
        fake_snapshot(2, walk_anyhit=0, walk_blocked=0),  # no any-hit walk (the packet cells)
    ],
)
def test_reads_nothing_where_nothing_was_counted(monkeypatch, snap):
    monkeypatch.setattr(counters, "snapshot", lambda trace: snap)
    assert spec.metric_reader("walk_blocked_share").read(window()) is None


def test_declared_for_the_walks_cell_only():
    """Declared for the cells that walk kernel G: the 1080p ones under
    ``frame_ms``, the 384x288 one apart under ``frame_ms.384``."""
    per_layer = {x["name"]: x for x in spec.benchmark()["per_layer"]}
    m, m384 = per_layer["walk_blocked_share"], per_layer["walk_blocked_share.384"]
    assert (m["unit"], m["better"], m["layer"], m["moves"]) == ("share", "higher", "kernels", "frame_ms")
    assert m["workloads"] == ["teatime.orbit_1080", "teapots3.orbit_1080"]
    assert (m384["unit"], m384["better"], m384["layer"], m384["moves"]) == ("share", "higher", "kernels", "frame_ms.384")
    assert m384["workloads"] == ["teatime.orbit_384"]
    assert spec.metric_reader("walk_blocked_share.384").read is spec.metric_reader("walk_blocked_share").read


def test_reads_the_programs_snapshot():
    """A threaded bvh frame on the CPU: the twins count its shadow
    rays' any-hit walks while a profiler session records, and the
    reader reads blocked over walked, strictly between 0 and 1."""
    from torch.profiler import ProfilerActivity, profile

    from rt_rs_tpu_torch import Renderer, tracing
    from rt_rs_tpu_torch.scene.presets import torus_scene

    r = Renderer(torus_scene(), size=(16, 12), device="cpu", handler="bvh")
    r.render_frame()  # a check outside a session: the next one starts from zero
    with profile(activities=[ProfilerActivity.CPU]):
        r.render_frame()
    snap = tracing.snapshot()
    share = spec.metric_reader("walk_blocked_share").read(Trace(0.0, 1.0, 1, [("bvh_walk_tiled_kernel", 0.1, 0.2)], []))
    assert 0 < snap["walk_blocked"] < snap["walk_anyhit"] <= snap["walk_rays"]
    assert share == pytest.approx(snap["walk_blocked"] / snap["walk_anyhit"])

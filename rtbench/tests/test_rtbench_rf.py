"""The cell ``teatime_rf.orbit_1080``'s files: its readers of the RF
records walk (``rf_records_per_ray``, ``rf_prims_per_ray`` from the
port's counters; ``rf_walk_roofline`` from the device trace) on
synthetic traces and on the program's own snapshot on the CPU, the
kernel-name split that puts the records walk under ``intersect_ms``, and
the configuration ``teatime_rf``, whose scene is ``teatime``'s."""

import json

import numpy as np
import pytest

from rtbench import counters, scenes, spec
from rtbench.trace import Trace

CELL = "teatime_rf.orbit_1080"
KERNEL = "void (anonymous namespace)::bvh_walk_rf_kernel<1>(float const*, unsigned char const*, uint4 const*)"


def window(frames=2, device=None):
    """A 10 ms window of ``frames`` frames: 3 ms of the records walk in
    two launches, a shading kernel and kernel G by default."""
    if device is None:
        device = [
            (KERNEL, 0.000, 0.002),
            ("void (anonymous namespace)::bvh_walk_rf_scratch_kernel<2>(float const*)", 0.004, 0.005),
            ("shade_post_kernel", 0.005, 0.006),
            ("bvh_walk_tiled_kernel", 0.006, 0.007),
        ]
    return Trace(0.0, 0.010, frames, device, [])


def fake_snapshot(frames, **rf):
    return {
        "live_rays": [0] * 8, "slots": [0] * 8, "cull_entries": {},
        "walk_rays": 0, "walk_nodes": 0, "walk_prims": 0, "walk_anyhit": 0, "walk_blocked": 0,
        **rf, "frames": frames,
        "capture_s": 0.0, "captures": 0, "build_s": 0.0, "library_s": 0.0, "library_built": 0, "launches": {},
    }


def test_counter_readers_read_per_ray(monkeypatch):
    monkeypatch.setattr(counters, "snapshot", lambda trace: fake_snapshot(2, rf_rays=50, rf_records=1500, rf_prims=200))
    assert spec.metric_reader("rf_records_per_ray").read(window()) == pytest.approx(30.0)
    assert spec.metric_reader("rf_prims_per_ray").read(window()) == pytest.approx(4.0)


@pytest.mark.parametrize(
    "snap",
    [
        None,  # no device operation, or no tracing module
        fake_snapshot(3, rf_rays=50, rf_records=1500, rf_prims=200),  # another window's frames
        fake_snapshot(2),  # a program without the records walk's counters (the parent's)
        fake_snapshot(2, rf_rays=0, rf_records=0, rf_prims=0),  # no ray walked the records
    ],
)
def test_counter_readers_read_nothing_where_nothing_was_counted(monkeypatch, snap):
    monkeypatch.setattr(counters, "snapshot", lambda trace: snap)
    for name in ("rf_records_per_ray", "rf_prims_per_ray"):
        assert spec.metric_reader(name).read(window()) is None


def test_roofline_arithmetic():
    """The floor is 1920 x 1080 primary rays x 40 bytes (32 read, t and
    pid written) at 3.35 TB/s, 0.0248 ms a frame; over 1.5 ms of
    bvh_walk_rf* a frame (3 ms in 2 frames; kernel G and shading not
    counted) that is 1.65%."""
    reader = spec.metric_reader("rf_walk_roofline")
    mix = spec.traffic("orbit_1080")
    floor = mix["width"] * mix["height"] * 40 / 3.35e12
    assert reader.floor_s() == pytest.approx(floor) and floor == pytest.approx(0.02476e-3, rel=1e-3)
    assert reader.read(window()) == pytest.approx(100.0 * floor / 1.5e-3)
    assert reader.read(window(frames=1)) == pytest.approx(100.0 * floor / 3.0e-3)
    assert reader.read(window(device=[("bvh_walk_tiled_kernel", 0.0, 0.002)])) is None  # kernel G alone
    assert reader.read(window(device=[("mt_trace_items_kernel", 0.0, 0.002)])) is None  # the packet kernels
    assert reader.read(window(frames=0)) is None
    assert reader.read(Trace(0.0, 0.01, 2, [], [])) is None


def test_records_walk_is_intersection_not_glue():
    t = window(device=[(KERNEL, 0.0, 0.002), ("vectorized_elementwise_kernel", 0.002, 0.003)])
    assert spec.metric_reader("intersect_ms").read(t) == pytest.approx(1.0)
    assert spec.metric_reader("glue_ms").read(t) == pytest.approx(0.5)


def test_declared_for_the_rf_cell():
    bench = spec.benchmark()
    w = spec.workload(bench, CELL)
    assert (w["config"], w["traffic"], w["chips"]) == ("teatime_rf", "orbit_1080", 1)
    for name, unit, better in (
        ("rf_records_per_ray", "records", "lower"), ("rf_prims_per_ray", "prims", "lower"),
        ("rf_walk_roofline", "%", "higher"),
    ):
        (m,) = [x for x in bench["per_layer"] if x["name"] == name]
        assert (m["unit"], m["better"], m["layer"], m["moves"], m["source"]) == (unit, better, "kernels", "frame_ms", "device_trace")
        assert m["workloads"] == [CELL]
    e2e = {m["name"] for m in spec.metrics_of(bench, "end_to_end", CELL)}
    assert e2e == {"frame_ms", "accel_bytes", "setup_s"}
    layers = {m["name"] for m in spec.metrics_of(bench, "per_layer", CELL)}
    assert {"intersect_ms", "shade_ms", "glue_ms", "device_idle.frame", "live_share", "idle_launch_ms",
            "idle_host_ms", "capture_s", "build_s"} <= layers
    assert not layers & {"cull_entries_m", "walk_nodes_per_ray", "walk_prims_per_ray", "walk_blocked_share"}


def test_teatime_rf_is_teatimes_scene():
    """``teatime_rf`` builds ``teatime``'s scene arrays byte for byte and
    differs from it only in its handler and what it says of itself; the
    records it states are what ``pack_rf`` makes of that scene."""
    from rt_rs_tpu_torch.bvh import build_bvh
    from rt_rs_tpu_torch.bvh.rf import pack_rf
    from rt_rs_tpu_torch.scene import Scene
    from rt_rs_tpu_torch.scene.camera import CameraController, CameraUniform

    bench = spec.benchmark()
    rf, base = spec.config(bench, "teatime_rf"), spec.config(bench, "teatime")
    a, b = scenes.build(rf), scenes.build(base)
    for f in ("vert_pos", "vert_norm", "prim_indices", "prim_material", "light_pos", "light_strength",
              "mat_color", "mat_albedo", "mat_spec"):
        assert getattr(a, f).tobytes() == getattr(b, f).tobytes(), f
    assert (a.camera_pos, a.camera_at) == (b.camera_pos, b.camera_at)
    for k in ("mesh", "copies", "floor", "camera", "lights", "materials", "compute", "triangles", "bounces",
              "reduced", "assumed"):
        assert rf[k] == base[k], k
    assert rf["renderer"] == {"handler": "rf_bvh"} and base["renderer"] == {"handler": "bvh"}
    s = Scene.empty(camera=CameraUniform(a.camera_pos, a.camera_at), camera_controller=CameraController("Orbit"))
    for f in ("vert_pos", "vert_norm", "prim_indices", "prim_material", "light_pos", "light_strength",
              "mat_color", "mat_albedo", "mat_spec"):
        setattr(s, f, np.array(getattr(a, f), copy=True))
    data = build_bvh(s, eps=0.02, target_item_count=rf["format"]["target_item_count"])
    packed = pack_rf(data, *data.cover_bounds(s))
    assert rf["records"] == {
        "total": packed.num_records, "bytes": packed.byte_size(), "node_records": data.num_nodes,
        "leaf_payload_records": int(data.is_leaf().sum()), "depth": data.max_depth(),
    }
    assert json.dumps(rf["records"]) == json.dumps(
        {"total": 6131, "bytes": 98096, "node_records": 4087, "leaf_payload_records": 2044, "depth": 16}
    )


def test_readers_read_the_programs_snapshot():
    """An rf_bvh frame on the CPU: the twin counts its records walks
    while a profiler session records, and the readers read them."""
    from torch.profiler import ProfilerActivity, profile

    from rt_rs_tpu_torch import Renderer, tracing
    from rt_rs_tpu_torch.scene.presets import torus_scene

    r = Renderer(torus_scene(), size=(16, 12), device="cpu", handler="rf_bvh")
    r.render_frame()  # a check outside a session: the next one starts from zero
    with profile(activities=[ProfilerActivity.CPU]):
        r.render_frame()
    snap = tracing.snapshot()
    t = Trace(0.0, 1.0, 1, [(KERNEL, 0.1, 0.2)], [])
    assert spec.metric_reader("rf_records_per_ray").read(t) == pytest.approx(snap["rf_records"] / snap["rf_rays"])
    assert spec.metric_reader("rf_prims_per_ray").read(t) == pytest.approx(snap["rf_prims"] / snap["rf_rays"])
    assert snap["rf_records"] > snap["rf_prims"] > snap["rf_rays"] > 0
    assert spec.metric_reader("walk_nodes_per_ray").read(t) is None  # kernel G walks nothing

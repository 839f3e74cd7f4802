"""The cell ``teapots3_rebuild.breathe_1080``'s files: the configuration,
``teapots3``'s scene under ``DynamicRenderer``'s walked rebuild; the
structure whose bytes ``accel_bytes`` counts; the readers of the build
kernels ``wide_build*`` (``rebuild_ms``, ``rebuild_roofline``) and of the
counter ``rebuild_nodes`` on synthetic traces; and whole runs on the CPU
at a small size, sound and with each fault planted."""

import pytest
import torch

from rtbench import accel, drive, faults, harness, scenes, spec
from rtbench.trace import Trace

CELL = "teapots3_rebuild.breathe_1080"
KERNEL = "(anonymous namespace)::wide_build_collapse_kernel(int, int, int, int4 const*, int const*)"


def config():
    return spec.config(spec.benchmark(), "teapots3_rebuild")


def test_configuration_is_teapots3_under_the_walked_rebuild():
    """``teapots3_refit``'s scene keys, cuts and breathing, and
    ``DynamicRenderer`` at its default lifecycle, a rebuild every frame,
    with the walk named explicitly."""
    from rt_rs_tpu_torch.renderer import DynamicRenderer

    bench = spec.benchmark()
    c, refit = config(), spec.config(bench, "teapots3_refit")
    for k in (
        "mesh", "copies", "floor", "camera", "lights", "materials", "compute", "triangles", "bounces", "reduced",
        "assumed",
    ):
        assert c[k] == refit[k], k
    assert c["renderer"] == {"class": "DynamicRenderer", "refit": False, "backend": "threaded"}
    assert "LBVH build ms" in c["source"] and "configs[4]" in c["source"] and "teapots3" in c["source"]
    assert len(c["source"]) <= 200
    a = scenes.build(c)
    assert a.num_prims == c["triangles"] == 18962
    r = drive.make_renderer(a, c, 16, 12, "cpu")
    assert type(r) is DynamicRenderer and r._walk and not r._refit and r.stats.name == "BVH-rebuild"
    w = spec.workload(bench, CELL)
    assert (w["config"], w["traffic"], w["chips"]) == ("teapots3_rebuild", "breathe_1080", 1)


def test_accel_bytes_count_the_records_and_the_build_buffers_once():
    """The structure a card's build leaves (``wide_build.WideBuild``: the
    packed records and the build's buffers, sized from P): each tensor
    once, however often it is reached; reckoned from P alone."""
    from rt_rs_tpu_torch.ops import wide_build

    p = config()["triangles"]
    b = wide_build.workspace(p, "cpu")
    parts = [b.tree.nodes, b.tree.prims, *b.work.values()]
    want = sum(t.numel() * t.element_size() for t in parts)
    n = p - 1
    assert b.tree.nodes.shape == (n, 32) and b.tree.prims.shape == (p, 12)
    reckoned = n * 128 + p * 48 + (
        32 + 4 * p * 6 + 4 * ((1 << 14) + 1) + 4 * (1 << 14) + 16 * n + 4 * n * 3 + 32 * n + 32 * p + 8 * n
        + 16 * n * 2 + 16
    )
    assert want == reckoned == 6_426_280
    assert accel.tensor_bytes(b) == accel.tensor_bytes((b, b.tree, b.work, b)) == want


def window(frames=2, device=None):
    """A 10 ms window of ``frames`` frames: 40 us of the build in two
    launches, kernel G and a shading kernel by default."""
    if device is None:
        device = [
            (KERNEL, 0.000, 0.00002),
            ("bvh_walk_tiled_kernel", 0.001, 0.002),
            ("(anonymous namespace)::wide_build_nodes_kernel(int)", 0.003, 0.00302),
            ("shade_post_kernel", 0.005, 0.006),
        ]
    return Trace(0.0, 0.010, frames, device, [])


def test_rebuild_readers_arithmetic():
    """``rebuild_ms``: 40 us over 2 frames; ``rebuild_roofline``: the
    floor, 18,962 triangles x 84 bytes at 3.35 TB/s (0.475 us), over it."""
    ms, roof = spec.metric_reader("rebuild_ms"), spec.metric_reader("rebuild_roofline")
    floor = 18962 * 84 / 3.35e12
    assert roof.floor_s() == pytest.approx(floor) and floor == pytest.approx(0.4755e-6, rel=1e-3)
    assert ms.read(window()) == pytest.approx(0.02)
    assert roof.read(window()) == pytest.approx(100.0 * floor / 20e-6)
    assert ms.read(window(frames=1)) == pytest.approx(0.04)


@pytest.mark.parametrize(
    "trace",
    [
        window(device=[("bvh_walk_tiled_kernel", 0.0, 0.002), ("shade_post_kernel", 0.002, 0.003)]),
        window(device=[("(anonymous namespace)::wide_refit_kernel(int)", 0.0, 0.001)]),
        window(frames=0),
        Trace(0.0, 0.01, 2, [], []),
    ],
    ids=["walk only", "the refit", "no frames", "no device"],
)
def test_rebuild_readers_read_nothing_where_no_build_kernel_ran(trace):
    for name in ("rebuild_ms", "rebuild_roofline", "rebuild_nodes"):
        assert spec.metric_reader(name).read(trace) is None, name


def test_rebuild_nodes_reads_the_counter_a_frame(monkeypatch):
    from rtbench import counters

    snap = {"frames": 4, "rebuild_nodes": 4 * 3144}
    monkeypatch.setattr(counters, "snapshot", lambda trace: snap)
    t = window(frames=4)
    assert spec.metric_reader("rebuild_nodes").read(t) == pytest.approx(3144)
    monkeypatch.setattr(counters, "snapshot", lambda trace: {"frames": 4})  # a program without the counter
    assert spec.metric_reader("rebuild_nodes").read(t) is None


def test_the_build_is_glue_not_intersection():
    """``wide_build`` is neither an intersection nor a shading kernel,
    so it counts in ``glue_ms`` beside ``rebuild_ms``."""
    t = window(device=[(KERNEL, 0.0, 0.002), ("bvh_walk_tiled_kernel", 0.002, 0.003)])
    assert spec.metric_reader("intersect_ms").read(t) == pytest.approx(0.5)
    assert spec.metric_reader("glue_ms").read(t) == pytest.approx(1.0)
    assert spec.metric_reader("rebuild_ms").read(t) == pytest.approx(1.0)


def test_declared_for_the_new_cell():
    bench = spec.benchmark()
    for name, unit, source in (
        ("rebuild_ms", "ms", "device_trace"), ("rebuild_roofline", "%", "device_trace"),
        ("rebuild_nodes", "nodes", "program_counter"),
    ):
        (m,) = [x for x in bench["per_layer"] if x["name"] == name]
        assert (m["unit"], m["layer"], m["moves"], m["source"]) == (unit, "handlers", "frame_ms", source)
        assert m["workloads"] == [CELL]
    e2e = {m["name"] for m in spec.metrics_of(bench, "end_to_end", CELL)}
    assert e2e == {"frame_ms", "accel_bytes", "setup_s"}
    layers = {m["name"] for m in spec.metrics_of(bench, "per_layer", CELL)}
    assert layers == {
        "intersect_ms", "shade_ms", "glue_ms", "device_idle.frame", "live_share", "idle_launch_ms", "idle_host_ms",
        "capture_s", "build_s", "walk_nodes_per_ray", "walk_prims_per_ray", "walk_blocked_share", "rebuild_ms",
        "rebuild_roofline", "rebuild_nodes",
    }


# two dispatches of two frames a call at 16x12
BREATHE = {
    "kind": "breathe", "width": 16, "height": 12, "chain": 2, "mult": 5.0, "frames_per_sync": 4,
    "warmup_syncs": 1, "trace_seconds": 0.1, "check": {"frames": 8, "pixels": 96},
    "breathe": spec.traffic("breathe_1080")["breathe"],
}
SEED = 2**31 + 2039


def run(plant=None):
    undo = plant() if plant is not None else None
    try:
        return harness.run(spec.benchmark(), CELL, SEED, 1.0, False, device="cpu", traffic=BREATHE, log=lambda line: None)
    finally:
        if undo is not None:
            undo()


def test_sound_run_is_correct():
    res = run()
    assert res["correct"] and res["failed"] == 0
    assert set(res["metrics"]) == {m["name"] for m in spec.metrics_of(spec.benchmark(), "end_to_end", CELL)}
    assert res["metrics"]["accel_bytes"]["value"] > 0


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_fault_is_caught(fault):
    res = run(faults.FAULTS[fault])
    assert not res["correct"], res["checks"]


@pytest.mark.card
def test_card_structure_is_the_records_and_the_build_buffers():
    """On the card the structure is the build's buffers with the packed
    records: no binary tree and no corner arrays."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from rt_rs_tpu_torch.ops import wide_build

    runner = drive.Runner(scenes.build(config()), config(), {**spec.traffic("breathe_1080"), "width": 64, "height": 48}, "cuda")
    b = runner.structure()
    assert isinstance(b, wide_build.WideBuild) and b.tree.binary == ()
    parts = [b.tree.nodes, b.tree.prims, *b.work.values()]
    assert accel.tensor_bytes(b, "cuda") == sum(t.numel() * t.element_size() for t in parts) == 6_426_280

"""The cell ``teapots3_refit.breathe_1080``'s files: the configuration,
``teapots3``'s scene under ``DynamicRenderer``'s walked refit; the
structure whose bytes ``accel_bytes`` counts; the readers of the refit
kernel ``wide_refit`` (``refit_ms``, ``refit_roofline``) on synthetic
traces; and whole runs on the CPU at a small size, sound and with each
fault planted."""

import pytest
import torch

from rtbench import accel, drive, faults, harness, scenes, spec
from rtbench.trace import Trace

CELL = "teapots3_refit.breathe_1080"
KERNEL = "(anonymous namespace)::wide_refit_kernel((anonymous namespace)::Corners, int2 const*, int)"


def config():
    return spec.config(spec.benchmark(), "teapots3_refit")


def test_configuration_is_teapots3_under_the_walked_refit():
    """``teapots3``'s scene keys and cuts, the breathing of
    ``teatime_refit``, and ``DynamicRenderer`` with the walk named
    explicitly: the rest pose's tree refit every frame."""
    from rt_rs_tpu_torch.renderer import DynamicRenderer

    bench = spec.benchmark()
    c, base, refit = config(), spec.config(bench, "teapots3"), spec.config(bench, "teatime_refit")
    for k in ("mesh", "copies", "floor", "camera", "lights", "materials", "compute", "triangles", "bounces", "reduced"):
        assert c[k] == base[k], k
    assert c["assumed"] == {**base["assumed"], "animation": refit["assumed"]["animation"]}
    assert c["renderer"] == {"class": "DynamicRenderer", "refit": True, "backend": "threaded"}
    assert "configs[4]" in c["source"] and "teapots3" in c["source"]
    a, b = scenes.build(c), scenes.build(base)
    for f in drive.SCENE_FIELDS:
        assert getattr(a, f).tobytes() == getattr(b, f).tobytes(), f
    assert a.num_prims == c["triangles"] == 18962
    r = drive.make_renderer(a, c, 16, 12, "cpu")
    assert type(r) is DynamicRenderer and r._walk and r.stats.name == "BVH-refit"
    w = spec.workload(bench, CELL)
    assert (w["config"], w["traffic"], w["chips"]) == ("teapots3_refit", "breathe_1080", 1)


def test_accel_bytes_count_the_records_and_the_map_once():
    """The walked structure a card builds (``wide.RefitWalk``: the
    packed records and the refit's map, no binary tree): each tensor
    once, however often it is reached."""
    from rt_rs_tpu_torch.bvh import build_bvh, wide
    from rt_rs_tpu_torch.handlers.bvh import accel_from_bvh_data, reorder_scene_arrays

    r = drive.make_renderer(scenes.build(config()), config(), 16, 12, "cpu")
    data = build_bvh(r.scene, eps=0.02, target_item_count=2)
    n = accel_from_bvh_data(data, r.scene, torch.device("cpu"))
    a = reorder_scene_arrays(r.scene.pack(device="cpu"), data.indices)
    host = wide.pack_walk(
        n.node_min, n.node_max, n.hit_link, n.miss_link, n.leaf_count, n.leaf_start, a.pa, a.pb, a.pc,
        payload=False,
    )
    tree = wide.WalkTree(binary=(), payload=False, nodes=host.nodes, prims=host.prims, stack=host.stack)
    refit = wide.refit_map(tree, rows=a.pa.shape[0])
    parts = (tree.nodes, tree.prims, refit.prim_meta, refit.slot_word, refit.slot_range)
    want = sum(t.numel() * t.element_size() for t in parts)
    assert want == tree.prims.shape[0] * (48 + 8) + tree.nodes.shape[0] * 128 + refit.slot_word.shape[0] * 12
    walk = wide.RefitWalk(tree, refit)
    assert accel.tensor_bytes(walk) == accel.tensor_bytes((walk, tree, refit, walk)) == want


def window(frames=2, device=None):
    """A 10 ms window of ``frames`` frames: 40 us of the refit in two
    launches, kernel G and a shading kernel by default."""
    if device is None:
        device = [
            (KERNEL, 0.000, 0.00002),
            ("bvh_walk_tiled_kernel", 0.001, 0.002),
            (KERNEL, 0.003, 0.00302),
            ("shade_post_kernel", 0.005, 0.006),
        ]
    return Trace(0.0, 0.010, frames, device, [])


def test_refit_readers_arithmetic():
    """``refit_ms``: 40 us over 2 frames; ``refit_roofline``: the floor,
    18,962 triangles x 84 bytes at 3.35 TB/s (0.475 us), over it."""
    ms, roof = spec.metric_reader("refit_ms"), spec.metric_reader("refit_roofline")
    floor = 18962 * 84 / 3.35e12
    assert roof.floor_s() == pytest.approx(floor) and floor == pytest.approx(0.4755e-6, rel=1e-3)
    assert ms.read(window()) == pytest.approx(0.02)
    assert roof.read(window()) == pytest.approx(100.0 * floor / 20e-6)
    assert ms.read(window(frames=1)) == pytest.approx(0.04)


@pytest.mark.parametrize(
    "trace",
    [
        window(device=[("bvh_walk_tiled_kernel", 0.0, 0.002), ("shade_post_kernel", 0.002, 0.003)]),
        window(device=[("mt_trace_items_kernel", 0.0, 0.002), ("vectorized_elementwise_kernel", 0.002, 0.003)]),
        window(frames=0),
        Trace(0.0, 0.01, 2, [], []),
    ],
    ids=["walk only", "the chunk refit's packet frame", "no frames", "no device"],
)
def test_refit_readers_read_nothing_where_no_refit_kernel_ran(trace):
    for name in ("refit_ms", "refit_roofline"):
        assert spec.metric_reader(name).read(trace) is None, name


def test_the_refit_is_glue_not_intersection():
    """``wide_refit`` is neither an intersection nor a shading kernel,
    so it counts in ``glue_ms`` beside ``refit_ms``."""
    t = window(device=[(KERNEL, 0.0, 0.002), ("bvh_walk_tiled_kernel", 0.002, 0.003)])
    assert spec.metric_reader("intersect_ms").read(t) == pytest.approx(0.5)
    assert spec.metric_reader("glue_ms").read(t) == pytest.approx(1.0)
    assert spec.metric_reader("refit_ms").read(t) == pytest.approx(1.0)


def test_declared_for_the_new_cell():
    bench = spec.benchmark()
    for name, unit in (("refit_ms", "ms"), ("refit_roofline", "%")):
        (m,) = [x for x in bench["per_layer"] if x["name"] == name]
        assert (m["unit"], m["layer"], m["moves"], m["source"]) == (unit, "handlers", "frame_ms", "device_trace")
        assert m["workloads"] == [CELL]
    e2e = {m["name"] for m in spec.metrics_of(bench, "end_to_end", CELL)}
    assert e2e == {"frame_ms", "accel_bytes", "setup_s"}
    layers = {m["name"] for m in spec.metrics_of(bench, "per_layer", CELL)}
    assert {
        "intersect_ms", "shade_ms", "glue_ms", "device_idle.frame", "live_share", "idle_launch_ms", "idle_host_ms",
        "capture_s", "build_s", "walk_nodes_per_ray", "walk_prims_per_ray", "walk_blocked_share", "refit_ms",
        "refit_roofline",
    } <= layers
    assert "cull_entries_m" not in layers


# two dispatches of two frames a call at 16x12 (a CPU frame of the walk
# over 18,962 triangles takes about a second)
BREATHE = {
    "kind": "breathe", "width": 16, "height": 12, "chain": 2, "mult": 5.0, "frames_per_sync": 4,
    "warmup_syncs": 1, "trace_seconds": 0.1, "check": {"frames": 8, "pixels": 96},
    "breathe": spec.traffic("breathe_1080")["breathe"],
}
SEED = 2**31 + 2029


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
def test_card_structure_is_the_records_and_the_map():
    """On the card the structure holds the packed records and the map
    alone: no binary tree, and no corner arrays."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    runner = drive.Runner(scenes.build(config()), config(), {**spec.traffic("breathe_1080"), "width": 64, "height": 48}, "cuda")
    walk = runner.structure()
    tree, refit = walk.tree, walk.refit
    assert tree.binary == ()
    parts = (tree.nodes, tree.prims, refit.prim_meta, refit.slot_word, refit.slot_range)
    assert accel.tensor_bytes(walk, "cuda") == sum(t.numel() * t.element_size() for t in parts)

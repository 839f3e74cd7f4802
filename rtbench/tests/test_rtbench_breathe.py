"""Animated geometry: the ``breathe`` kind's arrays, the configuration
that picks ``DynamicRenderer`` with its refit, the reference traced on
each frame's arrays, and a static cell's run unchanged by all of it."""

import dataclasses
import hashlib
import math

import numpy as np
import pytest
import torch

from rtbench import accel, check, drive, harness, scenes, spec
from rtbench.reference import Reference

CELL = "teatime_refit.breathe_1080"
MIX = spec.traffic("breathe_1080")
SEEDS = [2**31 + 977, 55, 4294967311]


def breathe():
    return spec.kind("breathe")


def scene():
    return scenes.build(spec.config(spec.benchmark(), "teatime_refit"))


def test_the_mix_is_the_sources_breathing():
    """``amp`` 0.01 and ``rate`` 0.3, the 1% wobble of
    ``experiments/baseline_configs.py``; a phase within one cycle."""
    assert MIX["breathe"] == {"amp": 0.01, "rate": 0.3}
    phases = {breathe().phase(MIX, s) for s in [*SEEDS, *range(200)]}
    assert phases <= set(range(21)) and len(phases) > 15


@pytest.mark.parametrize("i", [0, 3, 7, 1000])
def test_arrays_follow_the_formula(i):
    """Every vertex, the floor's too, scaled by ``1 + amp sin(rate (i +
    i0))``, worked out in float64 and rounded; the rest normals kept."""
    sc, seed = scene(), SEEDS[0]
    ((vp, vn),) = breathe().geometry(MIX, seed, sc, [i])
    s = 1.0 + 0.01 * math.sin(0.3 * (i + breathe().phase(MIX, seed)))
    assert vp.dtype == vn.dtype == np.float32 and vp.shape == vn.shape == sc.vert_pos.shape
    assert np.array_equal(vp, (np.asarray(sc.vert_pos, np.float64) * s).astype(np.float32))
    assert np.array_equal(vn, sc.vert_norm) and not np.shares_memory(vn, sc.vert_norm)
    assert not np.array_equal(vp, sc.vert_pos)


def test_a_pure_function_of_the_frame_and_the_seed():
    """Frame ``i``'s arrays are the same however they are asked for;
    frames differ within a window; a seed shifts the same cycle by its
    phase."""
    sc = scene()
    for seed in SEEDS:
        many = breathe().geometry(MIX, seed, sc, range(24))
        for i in (0, 5, 23):
            assert many[i][0].tobytes() == breathe().geometry(MIX, seed, sc, [i])[0][0].tobytes()
        assert len({p.tobytes() for p, _ in many}) == 24
    a, b = SEEDS[:2]
    shift = breathe().phase(MIX, a) - breathe().phase(MIX, b)
    pa = breathe().geometry(MIX, a, sc, [30])[0][0]
    pb = breathe().geometry(MIX, b, sc, [30 + shift])[0][0]
    assert pa.tobytes() == pb.tobytes()


def test_runner_hands_each_frame_its_arrays():
    """The runner hands the program, as ``vertex_fn(i)`` of a call from
    frame ``first``, frame ``first + i``'s arrays of the seed under way,
    fresh ones each time they are asked for."""
    sc, config, seed = scene(), spec.config(spec.benchmark(), "teatime_refit"), SEEDS[2]
    runner = drive.Runner(sc, config, {**MIX, "width": 16, "height": 12}, "cpu")
    calls = []
    runner.r.animate = lambda frames, **kw: calls.append(kw["vertex_fn"])
    runner.start(seed)
    runner.animate(16, 96)
    (fn,) = calls
    for i in (0, 5, 13):
        vp, vn = fn(i)
        ((wp, wn),) = breathe().geometry(MIX, seed, sc, [96 + i])
        assert vp.tobytes() == wp.tobytes() and vn.tobytes() == wn.tobytes()
        assert not np.shares_memory(vp, fn(i)[0])


def test_configuration_picks_the_dynamic_renderer():
    """``teatime_refit`` is ``teatime``'s scene under ``DynamicRenderer``
    with the source's refit; a configuration that names no class builds
    ``Renderer``, as before."""
    from rt_rs_tpu_torch.renderer import DynamicRenderer, Renderer

    bench = spec.benchmark()
    dyn, base = spec.config(bench, "teatime_refit"), spec.config(bench, "teatime")
    for k in ("mesh", "copies", "floor", "camera", "lights", "materials", "compute", "triangles", "bounces", "reduced"):
        assert dyn[k] == base[k], k
    assert "animation" in dyn["assumed"] and "per-frame BVH refit" in dyn["source"]
    assert dyn["renderer"] == {"class": "DynamicRenderer", "refit": True}
    r = drive.make_renderer(scenes.build(dyn), dyn, 16, 12, "cpu")
    assert type(r) is DynamicRenderer and r.stats.name == "LBVH-refit"
    assert type(drive.make_renderer(scenes.build(base), base, 16, 12, "cpu")) is Renderer
    with pytest.raises(ValueError, match="renderer class"):
        drive.make_renderer(scenes.build(base), {**base, "renderer": {"class": "Viewer"}}, 16, 12, "cpu")
    w = spec.workload(bench, CELL)
    assert (w["config"], w["traffic"], w["chips"]) == ("teatime_refit", "breathe_1080", 1)
    assert callable(spec.kind(MIX["kind"]).geometry)
    orbit = spec.traffic("orbit_1080")
    assert {k: v for k, v in MIX.items() if k not in ("kind", "why", "breathe")} == {
        k: v for k, v in orbit.items() if k not in ("kind", "why")
    }


def test_accel_bytes_of_a_dynamic_renderer():
    """The structure one frame builds: the chunk table with its rows
    table over the rest pose's Morton order, the bytes the port states."""
    sc, config = scene(), spec.config(spec.benchmark(), "teatime_refit")
    runner = drive.Runner(sc, config, {**MIX, "width": 16, "height": 12}, "cpu")
    table = runner.structure()
    assert table.attr is not None
    got = accel.tensor_bytes(table, "cpu")
    assert got == runner.r.stats.size == sum(
        t.untyped_storage().nbytes() for t in (table.comp, table.bmin, table.bmax, table.attr)
    )


def test_reference_traces_each_frame_in_its_own_scene():
    """The harness's reference of a dynamic cell's frames equals, frame
    by frame, :class:`Reference` built on a scene that holds that frame's
    arrays."""
    mix = {**MIX, "width": 12, "height": 9}
    cell = harness.Cell.load(spec.benchmark(), CELL, mix)
    seed, ids = SEEDS[1], [0, 3, 10, 13]
    pix = np.arange(12 * 9)
    views = [(pos, at, pix) for pos, at in breathe().cameras(mix, seed, cell.scene, ids)]
    got = harness.reference_frames(cell, seed, ids, views, "cpu")
    for (vp, vn), view, colours in zip(breathe().geometry(mix, seed, cell.scene, ids), views, got):
        own = dataclasses.replace(cell.scene, vert_pos=vp, vert_norm=vn)
        (want,) = Reference(own, cell.config["compute"], "cpu").frames([view], 12, 9)
        assert np.array_equal(colours, want)
    rest = Reference(cell.scene, cell.config["compute"], "cpu").frames(views, 12, 9)
    assert not np.array_equal(np.stack(got), np.stack(rest))  # the poses show
    # the control traces the same scenes in bfloat16, and fails
    low = harness.reference_frames(cell, seed, ids, views, "cpu", torch.bfloat16)
    ok, _ = check.verdict(check.numbers(list(zip(low, got)))[0], spec.limits(CELL))
    assert not ok


# (cell) -> the samples' frame ids, the sha256 of their frame ids and
# pixel indices, and of the reference's colours, recorded from the
# harness before it took geometry: a static cell's run is unchanged.
STATIC = {
    "teatime.orbit_384": (
        [0, 1, 2, 7],
        "a0cf585c37b1c47df13d867b45a42966f1aaea59975c179180045b4622f919d7",
        "03114d675a465ad49ececfd3d9ace004c5e72a772c5ba945186c4788846c2505",
    ),
    "teapots3.orbit_1080": (
        [0, 1, 2, 7],
        "a0cf585c37b1c47df13d867b45a42966f1aaea59975c179180045b4622f919d7",
        "11e59578478480ee6071441309a0a412ae688237ba7945e0d3431c15bf0d5b64",
    ),
}
# 12 frames in one call (seconds 0), one kept frame a chain position
STATIC_MIX = {
    "kind": "orbit", "width": 16, "height": 12, "chain": 4, "mult": 5.0, "frames_per_sync": 12,
    "warmup_syncs": 1, "trace_seconds": 0.1, "check": {"frames": 4, "pixels": 96},
}


@pytest.mark.parametrize("cell", sorted(STATIC))
def test_static_cell_runs_as_before(cell, monkeypatch):
    seen = {}
    numbers = check.numbers

    def spy(pairs):
        seen["want"] = [w for _, w in pairs]
        return numbers(pairs)

    monkeypatch.setattr(check, "numbers", spy)
    judge = harness.judge

    def spy_judge(cell_, seed, samples, dev):
        seen["s"] = samples
        return judge(cell_, seed, samples, dev)

    monkeypatch.setattr(harness, "judge", spy_judge)
    res = harness.run(spec.benchmark(), cell, 2**31 + 977, 0.0, False, device="cpu", traffic=STATIC_MIX, log=lambda line: None)
    ids, sampled, colours = STATIC[cell]
    h = hashlib.sha256()
    for i, pix, _ in seen["s"]:
        h.update(np.int64(i).tobytes())
        h.update(np.asarray(pix, np.int64).tobytes())
    hw = hashlib.sha256()
    for w in seen["want"]:
        hw.update(np.ascontiguousarray(w, np.float32).tobytes())
    assert [i for i, _, _ in seen["s"]] == ids and res["attempted"] == 12
    assert h.hexdigest() == sampled and hw.hexdigest() == colours
    assert res["correct"] and {n: c["value"] for n, c in res["checks"].items()} == {"bad_px": 0.0, "worst_frame": 0.0}

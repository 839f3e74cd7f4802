"""``DynamicRenderer``'s walked refit: kernel G over the ``bvh`` handler's
tree, built once at the rest pose and refit every frame (the walked
rebuild is tests/test_torch_wide_build.py's).

The referee of a pose's frame is the static ``bvh`` Renderer of a scene
holding that pose's vertices, with the rest pose's tree
(``BvhIntrs(data=...)``): its ``cover_bounds`` recomputes the boxes on
the posed vertices, which is what the refit computes.  The two are
equal bit for bit on scenes without duplicate vertex triples (the
dynamic path bounds the collapsed corners).  The walk enters the binary
walk's leaves in its order, whatever wide topology it packs, so the
rest pose's collapse changes no bit either.  A second referee is the
benchmark's plain reference (``rtbench/reference.py``), within its check's
2/255 a channel.

The poses are the benchmark's ``breathe`` animation: every vertex
scaled by ``1 + 0.01 sin(0.3 i)`` in f64, rounded to f32.

This file imports no JAX, so on the card it runs without the tests'
conftest (the tests marked ``card`` skip without one):

    python3 -m pytest tests/test_torch_dynamic_walk.py -m card --noconftest -q
"""

from __future__ import annotations

import copy
import dataclasses
import math
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from rt_rs_tpu_torch import ComputeConfig, Config, DynamicRenderer, Renderer, Resolution, tracing
from rt_rs_tpu_torch.bvh import build_bvh, wide
from rt_rs_tpu_torch.handlers.bvh import BvhIntrs, accel_from_bvh_data, reorder_scene_arrays
from rt_rs_tpu_torch.handlers.lbvh import TABLE_CAP
from rt_rs_tpu_torch.ops import bvh_walk, cuda, wide_refit
from rt_rs_tpu_torch.renderer import dynamic_walks
from rt_rs_tpu_torch.scene.presets import random_soup, torus_ghost, torus_row, torus_scene

torch.set_num_threads(
    max(1, (os.cpu_count() or 1) // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))
)

SIZE = (32, 24)
POSES = (0, 3, 7, 12)  # frame 0 is the rest pose (sin 0 = 0)


def breathe(scene, i: int):
    """Frame ``i`` of the breathing -> (vert_pos, vert_norm) f32 arrays,
    the rest normals kept."""
    s = 1.0 + 0.01 * math.sin(0.3 * i)
    vp = (np.asarray(scene.vert_pos, np.float64) * s).astype(np.float32)
    return vp, np.asarray(scene.vert_norm, np.float32)


def config(width: int, height: int, bounces: int = 4) -> Config:
    return Config(compute=ComputeConfig(bounces=bounces), resolution=Resolution.sized(width, height))


def walker(scene, size=SIZE, bounces: int = 4, device="cpu", **kw) -> DynamicRenderer:
    kw.setdefault("backend", "threaded")
    return DynamicRenderer(scene, config=config(*size, bounces), refit=True, device=device, **kw)


def rest_data(scene):
    """The tree the walked path builds at the rest pose: the ``bvh``
    handler's builder at its defaults."""
    h = BvhIntrs()
    return build_bvh(scene, eps=h.eps, target_item_count=h.target_item_count)


def referee(scene, i: int, data, size=SIZE, bounces: int = 4, device="cpu") -> torch.Tensor:
    """Pose ``i``'s frame by the static ``bvh`` Renderer on the rest
    pose's tree."""
    posed = copy.deepcopy(scene)
    posed.vert_pos = breathe(scene, i)[0]
    return Renderer(posed, config=config(*size, bounces), handler=BvhIntrs(data=data), device=device).render_frame()


@pytest.fixture(scope="module")
def torus():
    scene = torus_scene()
    return scene, rest_data(scene), walker(scene)


def test_the_torus_has_no_duplicate_triples():
    idx = np.asarray(torus_scene().prim_indices)
    assert np.unique(np.sort(idx, axis=1), axis=0).shape[0] == idx.shape[0]


@pytest.mark.parametrize("i", POSES)
def test_frames_equal_the_rest_pose_tree_referee(torus, i):
    scene, data, r = torus
    got = r.render_frame(*breathe(scene, i))
    want = referee(scene, i, data)
    assert torch.equal(got, want), float((got - want).abs().max())
    assert got.mean() > 0.05


def test_frames_agree_with_the_plain_reference():
    """At 96x72, 1,024 pixels of each of two poses, drawn from a seed as
    the benchmark's check draws them, within its 2/255 a channel of
    ``rtbench/reference.py`` (but at most 0.5% of them, the cells'
    limit: edge pixels where f32 rounding picks another triangle)."""
    from rtbench import check
    from rtbench.reference import Reference

    scene = torus_scene()
    w, h = 96, 72
    r = walker(scene, size=(w, h))
    cfg = r.config.compute
    compute = {
        "t_min": cfg.t_min, "t_max": cfg.t_max, "eps": cfg.eps, "bounces": cfg.bounces,
        "camera_light_source": cfg.camera_light_source,
    }
    rng = np.random.default_rng(2**31 + 977)
    for i in (0, 5):
        posed = copy.deepcopy(scene)
        posed.vert_pos = breathe(scene, i)[0]
        pix = rng.choice(w * h, 1024, replace=False)
        got = r.render_frame(*breathe(scene, i)).reshape(-1, 3).numpy()[pix]
        (want,) = Reference(posed, compute, "cpu").frames([(scene.camera.pos, scene.camera.at, pix)], w, h)
        off = check.off_pixels(got, want)
        assert off.mean() <= 0.005, (i, int(off.sum()))


def test_past_the_chunk_cap():
    """``torus_row(3)``, 18,962 triangles, past the chunk table's 12,288:
    the default ``"auto"`` walks it with ``refit=True``, equal to the
    referee at a breathing pose."""
    scene = torus_row(3)
    assert scene.num_prims > TABLE_CAP
    size = (16, 12)
    r = walker(scene, size=size, bounces=2, backend="auto")
    assert r._walk and r.stats.name == "BVH-refit"
    got = r.render_frame(*breathe(scene, 4))
    assert torch.equal(got, referee(scene, 4, rest_data(scene), size=size, bounces=2))
    assert got.mean() > 0.02


def posed_arrays(scene, data, i: int, device="cpu"):
    """Pose ``i``'s leaf-ordered scene arrays and the binary tree over
    them (links and ``cover_bounds`` at the pose)."""
    posed = copy.deepcopy(scene)
    posed.vert_pos = breathe(scene, i)[0]
    nodes = accel_from_bvh_data(data, posed, torch.device(device))
    return reorder_scene_arrays(posed.pack(device=device), data.indices), nodes


@pytest.mark.parametrize("make", [torus_scene, lambda: torus_row(2)], ids=["torus", "row2"])
def test_wide_refit_twin_equals_the_pack(make):
    """At a pose, the twin's records equal ``pack_walk``'s of the posed
    tree packed with the rest pose's topology (its areas), bit for bit;
    the binary refit equals ``cover_bounds`` at the pose."""
    scene = make()
    data = rest_data(scene)
    rest, n = posed_arrays(scene, data, 0)
    links = (n.hit_link, n.miss_link, n.leaf_count, n.leaf_start)
    packed = wide.pack_walk(n.node_min, n.node_max, *links, rest.pa, rest.pb, rest.pc, payload=False)
    refit = wide.refit_map(packed, rows=rest.pa.shape[0])
    area = wide.surface_areas(n.node_min.numpy(), n.node_max.numpy())
    topo = wide.binary_refit_topology(*links, scene.num_prims)
    assert refit.block_slots > 0 and refit.slot_range[0, 1] - refit.slot_range[0, 0] > wide.REFIT_BLOCK_RANGE
    for i in (5, 11):
        a, pn = posed_arrays(scene, data, i)
        want = wide.pack_walk(pn.node_min, pn.node_max, *links, a.pa, a.pb, a.pc, payload=False, area=area)
        tree = wide.WalkTree(binary=(), payload=False, nodes=packed.nodes.clone(), prims=packed.prims.clone())
        wide_refit.wide_refit(a.pa, a.pb, a.pc, tree, refit)
        assert torch.equal(tree.nodes, want.nodes) and torch.equal(tree.prims, want.prims), i
        assert not torch.equal(tree.prims, packed.prims)
        lo, hi = wide_refit.binary_refit(a.pa, a.pb, a.pc, topo)
        assert torch.equal(lo, pn.node_min) and torch.equal(hi, pn.node_max), i


def test_refit_map_reads_and_checks_the_records():
    """Each used slot's range is the prims under it, a contiguous run;
    the map raises where the records break that."""
    scene = torus_scene()
    data = rest_data(scene)
    a, n = posed_arrays(scene, data, 0)
    links = (n.hit_link, n.miss_link, n.leaf_count, n.leaf_start)
    packed = wide.pack_walk(n.node_min, n.node_max, *links, a.pa, a.pb, a.pc, payload=False)
    refit = wide.refit_map(packed, rows=a.pa.shape[0])
    words = packed.nodes[:, 6 * wide.WIDTH : 7 * wide.WIDTH]
    assert refit.slot_word.shape[0] == int((words != 0).sum())
    lengths = refit.slot_range[:, 1] - refit.slot_range[:, 0]
    assert bool((lengths[:-1] >= lengths[1:]).all()) and int(lengths.min()) >= 1
    assert refit.block_slots == int((lengths > wide.REFIT_BLOCK_RANGE).sum())
    assert torch.equal(refit.prim_meta, packed.prims[:, [3, 7]])
    # a leaf word that points into another leaf's prims
    bad = packed.nodes.clone()
    k, s = [int(x) for x in torch.nonzero(bad[:, 6 * wide.WIDTH : 7 * wide.WIDTH] < 0)[0]]
    bad[k, 6 * wide.WIDTH + s] = ~(~bad[k, 6 * wide.WIDTH + s] + 1)
    with pytest.raises(wide.WideTreeError):
        wide.refit_map(dataclasses.replace(packed, nodes=bad), rows=a.pa.shape[0])
    # corner arrays too short for the prims' rows
    with pytest.raises(wide.WideTreeError, match="pid"):
        wide.refit_map(packed, rows=2)


def test_backend_rule():
    """``"packet"`` past the cap raises at the first frame; ``"threaded"``
    walks with or without a refit; ``"auto"`` walks with ``refit=True``
    at every scene size, and for a rebuild keeps the chunk table up to
    its cap and walks the tree built every frame past it."""
    small, big = torus_scene(), torus_row(3)
    auto, packet = walker(small, backend="auto"), walker(small, backend="packet")
    assert auto._walk and auto.stats.name == "BVH-refit"
    assert not packet._walk and packet.stats.name == "LBVH-refit"
    assert walker(random_soup(3, 10), backend="auto")._walk
    threaded = DynamicRenderer(small, config=config(*SIZE), backend="threaded", device="cpu")
    assert threaded._walk and threaded.stats.name == "BVH-rebuild"
    with pytest.raises(ValueError, match="12288"):
        walker(big, size=(8, 8), backend="packet").render_frame()
    with pytest.raises(ValueError, match="12288"):
        DynamicRenderer(big, config=config(8, 8), backend="packet", device="cpu").render_frame()
    past = DynamicRenderer(big, config=config(8, 8), device="cpu")
    assert past._walk and past.stats.name == "BVH-rebuild"
    with pytest.raises(ValueError, match="unknown backend"):
        walker(small, backend="wide")
    cases = [
        ("auto", True, 10, True), ("auto", False, 10, False), ("auto", False, TABLE_CAP, False),
        ("auto", False, TABLE_CAP + 1, True), ("auto", True, TABLE_CAP + 1, True),
        ("packet", True, 10, False), ("packet", False, TABLE_CAP + 1, False),
        ("threaded", True, 10, True), ("threaded", False, 10, True), ("threaded", False, TABLE_CAP + 1, True),
    ]
    for backend, refit, prims, walks in cases:
        assert dynamic_walks(backend, refit, prims) == walks, (backend, refit, prims)
    assert not dynamic_walks("auto", False, 12_000, tri_chunk=64) and dynamic_walks("auto", False, 12_000, tri_chunk=5000)


@pytest.mark.parametrize("i", (3, 12))
def test_default_refit_walks(i):
    """A ``DynamicRenderer`` with ``refit=True`` and the default backend
    walks kernel G's tree: its frames equal the referee's."""
    scene = torus_scene()
    r = DynamicRenderer(scene, config=config(*SIZE), refit=True, device="cpu")
    assert r.stats.name == "BVH-refit"
    assert torch.equal(r.render_frame(*breathe(scene, i)), referee(scene, i, rest_data(scene)))


def test_default_rebuild_takes_the_chunk_table():
    """A rebuild under the default backend keeps the chunk table up to its
    cap (past it, tests/test_torch_wide_build.py walks)."""
    r = DynamicRenderer(torus_scene(), config=config(*SIZE), device="cpu")
    assert not r._walk and r.stats.name == "LBVH-rebuild"


def test_negative_material_scene():
    """``torus_ghost()`` takes the flat path on the walk's closest hits,
    equal to the referee's."""
    scene = torus_ghost()
    r = walker(scene, bounces=2)
    assert not r._use_rows
    data = rest_data(scene)
    for i in (0, 6):
        got = r.render_frame(*breathe(scene, i))
        assert torch.equal(got, referee(scene, i, data, bounces=2)), i
    assert np.nan_to_num(got.numpy()).mean() > 0.05


def test_chain_matches_eager_frames(torus):
    """``animate(chain=2, vertex_fn=)`` on the CPU: a dispatch's frame 0
    is the eager frame bit for bit, frame 1 the eager step of its pose at
    the f32 camera the dispatch wrote out."""
    scene, _, _ = torus
    r = walker(scene, size=(16, 16), bounces=1)
    vs = [breathe(scene, i) for i in range(2)]
    frames, poses = r._run_chain(2, 5.0, np.stack([v[0] for v in vs]), np.stack([v[1] for v in vs]))
    frames, poses = frames.clone(), poses.clone()
    at = torch.tensor(scene.camera.at, dtype=torch.float32)
    for j, (vp, vn) in enumerate(vs):
        assert torch.equal(frames[j], r._step(torch.from_numpy(vp), torch.from_numpy(vn), poses[j], at)), j
    assert torch.equal(frames[0], r.render_frame(*vs[0]))


def test_the_rest_pose_build_is_timed():
    before = tracing.snapshot()["build_s"]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        walker(torus_scene())
    assert tracing.snapshot()["build_s"] > before
    assert [e.name for e in prof.events()].count("rt.build") == 1


# ----------------------------------------------------------------------
# on the card


def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def card_walker(scene, size=(96, 72), **kw):
    return walker(scene, size=size, device=card(), **kw)


@pytest.mark.card
def test_card_structure_holds_the_records_and_the_map():
    r = card_walker(torus_row(3))
    vp, vn = (torch.from_numpy(x).cuda() for x in breathe(r.scene, 0))
    accel = r._build(r._frame_arrays(vp, vn))[0]
    assert isinstance(accel, wide.RefitWalk) and accel.tree.binary == ()
    assert accel.tree.nodes.is_cuda and accel.refit.slot_range.is_cuda
    assert accel.refit.prim_meta.shape[0] == accel.tree.prims.shape[0] == r.scene.num_prims


@pytest.mark.card
@pytest.mark.parametrize("i", [0, 4, 9])
def test_card_wide_refit_equals_its_twin(i):
    """The kernel's records at a pose, bit for bit the twin's (on the
    card and on the CPU), and twice alike."""
    r = card_walker(torus_row(3))
    a = r._frame_arrays(*(torch.from_numpy(x).cuda() for x in breathe(r.scene, i)))
    tree, refit = r._tree, r._refit_map
    wide_refit.wide_refit(a.pa, a.pb, a.pc, tree, refit)
    torch.cuda.synchronize()
    kern = (tree.nodes.clone(), tree.prims.clone())
    twin = wide.WalkTree(binary=(), payload=False, nodes=tree.nodes.clone().zero_(), prims=tree.prims.clone().zero_())
    # the child words are the pack's: the twin writes only boxes and prims
    twin.nodes[:, 6 * wide.WIDTH :] = kern[0][:, 6 * wide.WIDTH :]
    wide_refit.wide_refit_reference(a.pa, a.pb, a.pc, twin, refit)
    assert torch.equal(twin.nodes, kern[0]) and torch.equal(twin.prims, kern[1])
    cpu_map = wide.RefitMap(
        prim_meta=refit.prim_meta.cpu(), slot_word=refit.slot_word.cpu(), slot_range=refit.slot_range.cpu(),
        rows=refit.rows, block_slots=refit.block_slots,
    )
    cpu = wide.WalkTree(binary=(), payload=False, nodes=kern[0].cpu(), prims=kern[1].cpu())
    wide_refit.wide_refit(a.pa.cpu(), a.pb.cpu(), a.pc.cpu(), cpu, cpu_map)
    assert torch.equal(cpu.nodes, kern[0].cpu()) and torch.equal(cpu.prims, kern[1].cpu())
    wide_refit.wide_refit(a.pa, a.pb, a.pc, tree, refit)
    assert torch.equal(tree.nodes, kern[0]) and torch.equal(tree.prims, kern[1])


@pytest.mark.card
@pytest.mark.parametrize("i", [0, 7])
def test_card_walk_on_the_refit_records_equals_the_twin_walk(i, monkeypatch):
    """Every kernel G call of a pose's frame, replayed through the twin
    walk on the binary tree refit at that pose, bit for bit; and the
    frame equals the static ``bvh`` referee's on the card (the glue's
    torch ops round as the card does, so frames are compared on one
    device)."""
    dev = card()
    scene = torus_row(3)
    r = card_walker(scene)
    calls = []
    inner = bvh_walk.bvh_walk_tiled

    def rec(*a, **kw):
        out = inner(*a, **kw)
        calls.append((a, kw, out))
        return out

    monkeypatch.setattr(bvh_walk, "bvh_walk_tiled", rec)
    frame = r.render_frame(*breathe(scene, i))
    monkeypatch.undo()
    data = rest_data(scene)
    a = r._frame_arrays(*(torch.from_numpy(x).to(dev) for x in breathe(scene, i)))
    n = accel_from_bvh_data(data, scene, dev)
    links = (n.hit_link, n.miss_link, n.leaf_count, n.leaf_start)
    lo, hi = wide_refit.binary_refit(a.pa, a.pb, a.pc, wide.binary_refit_topology(*links, scene.num_prims))
    tree = wide.WalkTree(binary=(lo, hi, *links, a.pa, a.pb, a.pc), payload=False)
    assert [kw["mode"] for _, kw, _ in calls] == ["closest"] + ["anyhit", "closest"] * 3 + ["anyhit"]
    for (payload, valid, _), kw, out in calls:
        twin = bvh_walk.bvh_walk_tiled_reference(payload, valid, tree, **kw)
        got = out if isinstance(out, tuple) else (out,)
        want = twin if isinstance(twin, tuple) else (twin,)
        for g, w in zip(got, want, strict=True):
            assert torch.equal(g, w), kw["mode"]
    assert torch.equal(frame, referee(scene, i, data, size=(96, 72), device=dev))


@pytest.mark.card
def test_card_chain_equals_eager_frames_and_counts_every_rewrite():
    """``animate(chain=16, vertex_fn=)``'s graph: each frame bit-equal to
    the eager step of its pose at the f32 camera the dispatch wrote out;
    with tracing on, each replayed frame rewrites all Q prims and all U
    used slots once, in one launch."""
    k = 16
    scene = torus_row(3)
    r = card_walker(scene)
    seen = []
    r.animate(k, chain=k, vertex_fn=lambda i: (seen.append(i), breathe(scene, i))[1])
    assert seen == list(range(k))
    vs = [breathe(scene, i) for i in range(k)]
    stack = (np.stack([v[0] for v in vs]), np.stack([v[1] for v in vs]))
    frames, poses = (x.clone() for x in r._run_chain(k, 5.0, *stack))
    at = torch.tensor(scene.camera.at, dtype=torch.float32, device="cuda")
    for j, (vp, vn) in enumerate(vs):
        eager = r._step(torch.from_numpy(vp).cuda(), torch.from_numpy(vn).cuda(), poses[j], at)
        assert torch.equal(frames[j], eager), j
    before = cuda.LAUNCHES["wide_refit"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        r._run_chain(k, 5.0, *stack)
        torch.cuda.synchronize()
    snap = tracing.snapshot()
    assert snap["frames"] == k and cuda.LAUNCHES["wide_refit"] - before == k
    assert snap["refit_prims"] == k * r._refit_map.prim_meta.shape[0]
    assert snap["refit_nodes"] == k * r._refit_map.slot_word.shape[0]
    assert snap["walk_rays"] > 0
    tracing.begin("cuda", 0)  # outside the session: disarmed

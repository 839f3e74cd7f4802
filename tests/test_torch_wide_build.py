"""``DynamicRenderer``'s walked rebuild: kernel G's wide tree built from
each frame's corners (``ops/wide_build.py``, ``csrc/wide_build.cu``).

The twin's records are held to the walk's invariants
(``wide_build.check_tree``: ``wide.refit_map``'s checks) and to
``wide.pack_walk`` of the twin's own binary tree, which packs the same
prims and, where the stack bound never binds, the same nodes.  The
stack bound is held on adversarial keys.  Frames are held to the
benchmark's plain reference (``rtbench/reference.py``) within its
check's 2/255 a channel on at most 0.5% of the pixels, the rule
``tests/test_torch_dynamic_walk.py`` holds the walked refit to (edge
pixels where f32 rounding picks another triangle); the JAX comparison
below the chunk table's cap is in ``tests/test_torch_dynamic.py``.

This file imports no JAX, so on the card it runs without the tests'
conftest (the tests marked ``card`` skip without one):

    python3 -m pytest tests/test_torch_wide_build.py -m card --noconftest -q
"""

from __future__ import annotations

import copy
import math
import os
import pathlib
import re

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from rt_rs_tpu_torch import ComputeConfig, Config, DynamicRenderer, Resolution, tracing
from rt_rs_tpu_torch.bvh import wide
from rt_rs_tpu_torch.handlers.lbvh import TABLE_CAP
from rt_rs_tpu_torch.ops import bvh_walk, cuda, wide_build
from rt_rs_tpu_torch.scene.presets import deep_chain, random_soup, torus_row, torus_scene

torch.set_num_threads(
    max(1, (os.cpu_count() or 1) // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))
)

SEED = 2**31 + 28


def breathe(scene, i: int):
    """Frame ``i`` of the benchmark's ``breathe`` kind: every vertex
    scaled by ``1 + 0.01 sin(0.3 i)`` in f64, rounded to f32; the rest
    normals kept."""
    s = 1.0 + 0.01 * math.sin(0.3 * i)
    return (np.asarray(scene.vert_pos, np.float64) * s).astype(np.float32), np.asarray(scene.vert_norm, np.float32)


def posed(scene, i: int):
    out = copy.deepcopy(scene)
    out.vert_pos = breathe(scene, i)[0]
    return out


def phases(n: int = 3) -> list[int]:
    """``n`` breathing phases ``i0`` drawn from the file's seed."""
    return [int(x) for x in np.random.default_rng(SEED).integers(0, 1000, n)]


def rebuilder(scene, size=(64, 48), bounces: int = 4, device="cpu", **kw) -> DynamicRenderer:
    kw.setdefault("backend", "threaded")
    return DynamicRenderer(
        scene, config=Config(compute=ComputeConfig(bounces=bounces), resolution=Resolution.sized(*size)),
        device=device, **kw,
    )


def twin_of(scene):
    a = scene.pack(device="cpu")
    return wide_build.wide_build_reference(a.pa, a.pb, a.pc)


SCENES = {
    "one prim": lambda: random_soup(3, 1),
    "four": lambda: random_soup(4, 4),
    "soup": lambda: random_soup(5, 200),
    "chain": deep_chain,
    "torus": torus_scene,
    "row3 breathing": lambda: posed(torus_row(3), 7),
}


@pytest.mark.parametrize("leaf", [wide_build.LEAF_PRIMS, 4])
@pytest.mark.parametrize("name", SCENES)
def test_twin_records_hold_the_walks_invariants(name, leaf, monkeypatch):
    """Leaves own every packed prim once, children follow their parent,
    each node's prims are one contiguous run and the root's all of them;
    the twin's binary tree passes ``pack_walk``'s checks, which pack the
    same prims and, the stack bound not binding here, the same nodes."""
    monkeypatch.setattr(wide_build, "LEAF_PRIMS", leaf)
    scene = SCENES[name]()
    tb = twin_of(scene)
    p = scene.num_prims
    assert tb.nodes.shape == (max(p - 1, 1), wide.NODE_WORDS) and tb.prims.shape == (p, wide.PRIM_WORDS)
    wide_build.check_tree(tb.nodes, tb.prims, tb.count)
    assert sorted(tb.prims[:, 3].tolist()) == list(range(1, p + 1))  # every scene row once
    packed = wide.pack_walk(*tb.binary, payload=True)
    assert torch.equal(packed.prims, tb.prims)
    assert torch.equal(packed.nodes, tb.nodes[: tb.count]) and packed.stack == tb.collapsed.need
    assert tb.collapsed.need <= wide.LOCAL_STACK
    leaves = int(tb.prims[:, 7].sum())
    assert leaves == int((tb.binary[4] > 0).sum()) and int(tb.binary[4].max()) <= leaf


def test_leaves_of_more_prims_are_contiguous_runs(monkeypatch):
    """With leaves of up to 4 prims, a leaf's prims are consecutive
    sorted positions and its last is marked."""
    monkeypatch.setattr(wide_build, "LEAF_PRIMS", 4)
    tb = twin_of(random_soup(6, 300))
    count, slots = tb.binary[4], tb.binary[5].reshape(-1, wide.SLOTS)
    rows = tb.order + 1
    pos = {int(r): q for q, r in enumerate(rows)}
    for c, s in zip(count.tolist(), slots.tolist()):
        if c:
            qs = [pos[r] for r in s[:c]]
            assert qs == list(range(qs[0], qs[0] + c)) and tb.prims[qs[-1], 7] == 1
            assert all(tb.prims[q, 7] == 0 for q in qs[:-1])
    assert int(count.max()) > 1


def test_the_kernels_constants_are_the_twins():
    """``csrc/wide_build.cu``'s constants equal those the twin and the
    walk are written with."""
    src = (pathlib.Path(wide_build.__file__).resolve().parent.parent / "csrc" / "wide_build.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kWidth") == wide.WIDTH and const("kNodeWords") == wide.NODE_WORDS
    assert const("kLocalStack") == wide.LOCAL_STACK and const("kSlots") == wide.SLOTS
    assert const("kBucketBits") == wide_build.BUCKET_BITS
    assert 1 <= wide_build.LEAF_PRIMS <= wide.SLOTS


def depth_of(h: wide_build.Hierarchy) -> np.ndarray:
    """Each internal node's binary depth."""
    depth = np.zeros(h.p - 1, dtype=np.int64)
    for v in range(1, h.p - 1):
        u = v
        while h.parent[u] >= 0:
            depth[v] += 1
            u = h.parent[u]
    return depth


def caterpillar() -> tuple[torch.Tensor, np.ndarray]:
    """30 groups of 12 equal codes, group k's code 2^(29 - k): a spine
    30 deep, each spine node's other child a group's 12-prim subtree;
    the areas rank the small subtrees first (``1 / prims``), so a
    wide node would keep its spine child first while pushing three
    (unbounded, 90 entries at the deepest)."""
    codes = torch.tensor([1 << (29 - k) for k in range(30) for _ in range(12)], dtype=torch.int32)
    codes = torch.sort(codes).values
    h = wide_build.hierarchy(codes)
    return codes, 1.0 / (h.last - h.first + 1).astype(np.float64)


CODES = {
    "equal": lambda: (torch.zeros(5000, dtype=torch.int32), None),
    "geometric": lambda: (torch.tensor([1 << k for k in range(30)], dtype=torch.int32), None),
    "caterpillar": caterpillar,
}


@pytest.mark.parametrize("case", CODES)
def test_depth_and_stack_bounds_on_adversarial_keys(case, monkeypatch):
    """The radix tree over P keys is at most ``key_bits(P) - 1``
    internal levels deep; every wide node holds at most ``slack(P)``
    entries beyond its binary depth, so no walk needs more than
    ``LOCAL_STACK``.  On the caterpillar the bound binds: largest area
    first alone would need more than ``LOCAL_STACK`` entries."""
    codes, area = CODES[case]()
    h = wide_build.hierarchy(codes)
    p = codes.shape[0]
    if area is None:
        area = np.ones(p - 1)
    depth = depth_of(h)
    assert depth.max() <= wide_build.key_bits(p) - 1
    if case == "geometric":
        assert depth.max() == 28  # a comb: each split one code bit lower
    col = wide_build.collapse(h, area)
    slack = wide_build.slack(p)
    for v, held, d in zip(col.roots, col.held, col.depth):
        assert d == depth[v] and held <= d + slack
    assert col.need <= wide.LOCAL_STACK
    if case == "caterpillar":
        assert max(held - d for held, d in zip(col.held, col.depth)) == slack
        monkeypatch.setattr(wide_build, "slack", lambda p: 10**9)
        assert wide_build.collapse(h, area).need > wide.LOCAL_STACK


def test_the_build_follows_the_frame():
    """The records of a moved pose hold that pose's corners and bounds:
    the prim records carry each prim's scene row and its corners' bits,
    and the rest pose's records differ."""
    scene = torus_row(3)
    rest, moved = twin_of(scene), twin_of(posed(scene, 5))
    a = posed(scene, 5).pack(device="cpu")
    row = moved.prims[:, 3].long()
    assert torch.equal(moved.prims[:, 0:3], a.pa[row].view(torch.int32))
    assert torch.equal(moved.prims[:, 4:7], (a.pb[row] - a.pa[row]).view(torch.int32))
    assert not torch.equal(rest.nodes, moved.nodes) and not torch.equal(rest.prims, moved.prims)


REFERENCE_CASES = [("soup", s) for s in (11, 12, 13)] + [("row3", i) for i in phases()]


@pytest.mark.parametrize("kind,n", REFERENCE_CASES)
def test_walked_rebuild_agrees_with_the_plain_reference(kind, n):
    """64x48 frames of the walked rebuild (``backend="threaded"``), on
    three seeded soups and at three seeded breathing phases of
    ``torus_row(3)`` (past the chunk table's cap, under the default
    ``"auto"``), within 2/255 a channel of ``rtbench/reference.py`` on
    at least 99.5% of the pixels."""
    from rtbench import check
    from rtbench.reference import Reference

    w, h = 64, 48
    if kind == "soup":
        scene, verts = random_soup(n, 300), None
        r = rebuilder(scene)
    else:
        scene = torus_row(3)
        verts = breathe(scene, n)
        r = rebuilder(scene, backend="auto")
        assert scene.num_prims > TABLE_CAP and r._walk
    assert r.stats.name == "BVH-rebuild"
    got = (r.render_frame() if verts is None else r.render_frame(*verts)).reshape(-1, 3).numpy()
    cfg = r.config.compute
    compute = {
        "t_min": cfg.t_min, "t_max": cfg.t_max, "eps": cfg.eps, "bounces": cfg.bounces,
        "camera_light_source": cfg.camera_light_source,
    }
    target = scene if verts is None else posed(scene, n)
    pix = np.arange(w * h)
    (want,) = Reference(target, compute, "cpu").frames([(scene.camera.pos, scene.camera.at, pix)], w, h)
    off = check.off_pixels(got, want)
    assert off.mean() <= 0.005, (kind, n, int(off.sum()))
    assert got.mean() > 0.02


# ----------------------------------------------------------------------
# on the card


def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


CARD_SCENES = {
    "one prim": lambda: random_soup(3, 1),
    "soup": lambda: random_soup(5, 2000),
    "chain": deep_chain,
    "row3 rest": lambda: torus_row(3),
    "row3 pose 9": lambda: posed(torus_row(3), 9),
}


@pytest.mark.card
@pytest.mark.parametrize("leaf", [wide_build.LEAF_PRIMS, 4])
@pytest.mark.parametrize("name", CARD_SCENES)
def test_card_build_equals_its_twin(name, leaf, monkeypatch):
    """The kernels' records, bit for bit the twin's, with the twin's wide
    node count, and twice alike."""
    dev = card()
    monkeypatch.setattr(wide_build, "LEAF_PRIMS", leaf)
    scene = CARD_SCENES[name]()
    a = scene.pack(device="cpu")
    twin = wide_build.wide_build_reference(a.pa, a.pb, a.pc)
    build = wide_build.workspace(scene.num_prims, dev)
    corners = [x.to(dev) for x in (a.pa, a.pb, a.pc)]
    tree = wide_build.wide_build(*corners, build)
    first = (tree.nodes.clone(), tree.prims.clone())
    assert torch.equal(first[0].cpu(), twin.nodes) and torch.equal(first[1].cpu(), twin.prims)
    assert int(build.work["count"][0]) == twin.count
    wide_build.wide_build(*corners, build)
    assert torch.equal(tree.nodes, first[0]) and torch.equal(tree.prims, first[1])


@pytest.mark.card
@pytest.mark.parametrize("i", [0, 7])
def test_card_walk_on_the_built_records_equals_the_twin_walk(i, monkeypatch):
    """Every kernel G call of a pose's frame, replayed through the twin
    walk on the twin's binary tree of that pose, bit for bit."""
    dev = card()
    scene = torus_row(3)
    r = rebuilder(scene, size=(96, 72), device=dev)
    calls = []
    inner = bvh_walk.bvh_walk_tiled

    def rec(*a, **kw):
        out = inner(*a, **kw)
        calls.append((a, kw, out))
        return out

    monkeypatch.setattr(bvh_walk, "bvh_walk_tiled", rec)
    r.render_frame(*breathe(scene, i))
    monkeypatch.undo()
    a = r._frame_arrays(*(torch.from_numpy(x).to(dev) for x in breathe(scene, i)))
    tree = wide_build.wide_build_reference(a.pa.cpu(), a.pb.cpu(), a.pc.cpu()).walk_tree()
    assert [kw["mode"] for _, kw, _ in calls] == ["closest"] + ["anyhit", "closest"] * 3 + ["anyhit"]
    for (payload, valid, _), kw, out in calls:
        twin = bvh_walk.bvh_walk_tiled_reference(payload.cpu(), valid.cpu(), tree, **kw)
        got = out if isinstance(out, tuple) else (out,)
        want = twin if isinstance(twin, tuple) else (twin,)
        for g, w in zip(got, want, strict=True):
            assert torch.equal(g.cpu(), w), kw["mode"]


@pytest.mark.card
def test_card_chain_equals_eager_frames_and_counts_every_build():
    """``animate(chain=16, vertex_fn=)``'s graph: each frame bit-equal to
    the eager step of its pose at the f32 camera the dispatch wrote out;
    with tracing on, each replayed frame builds once (the build's
    launches) and writes all P prim records and the twin's wide nodes."""
    k = 16
    dev = card()
    scene = torus_row(3)
    r = rebuilder(scene, size=(96, 72), device=dev)
    r.animate(k, chain=k, vertex_fn=lambda i: breathe(scene, i))
    vs = [breathe(scene, i) for i in range(k)]
    stack = (np.stack([v[0] for v in vs]), np.stack([v[1] for v in vs]))
    frames, poses = (x.clone() for x in r._run_chain(k, 5.0, *stack))
    at = torch.tensor(scene.camera.at, dtype=torch.float32, device=dev)
    for j, (vp, vn) in enumerate(vs):
        eager = r._step(torch.from_numpy(vp).to(dev), torch.from_numpy(vn).to(dev), poses[j], at)
        assert torch.equal(frames[j], eager), j
    before = cuda.LAUNCHES["wide_build"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        r._run_chain(k, 5.0, *stack)
        torch.cuda.synchronize()
    snap = tracing.snapshot()
    assert snap["frames"] == k and cuda.LAUNCHES["wide_build"] - before == k
    assert snap["rebuild_prims"] == k * scene.num_prims
    assert snap["rebuild_nodes"] == sum(twin_of(posed(scene, i)).count for i in range(k))
    assert snap["walk_rays"] > 0
    tracing.begin("cuda", 0)  # outside the session: disarmed

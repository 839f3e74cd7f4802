"""Kernel G's design in its plain mirror: the packed wide tree of
``rt_rs_tpu_torch/bvh/wide.py`` and ``ops/bvh_walk.py::bvh_walk_wide_reference``.

The pack's records round-trip to the handlers' binary tree and prims,
its invariants hold on the torus, the canyon and ``rf_bvh``'s tree, and
hand-made trees that break one raise.  The mirror (the wide nodes, the
stack, the packed prims) equals the twin ``bvh_walk_reference`` bit for
bit in both leaf modes, with the twin's prim tests in the twin's order
(a scalar walk over the escape links here gives that order), on seeded
rays with axis-parallel (+-0.0) and NaN directions, invalid and excluded
rays: the torus, a slice of the canyon, two coincident copies of the
torus (ties at equal t), a single-leaf tree, payload leaves with
empty slots, and trees whose walk needs more than the kernel's local
stack (a hand-made chain, ``deep_chain``).  Against the JAX package's
``_bvh_intersect`` / ``_rf_intersect`` on a small tree, at the tolerance
of tests/test_torch_bvh.py.  The handlers pack only on a CUDA device, so
these tests pack the CPU builds' trees themselves; the deep chain and a
scene with no prims render through both tree handlers on the CPU.
"""

from __future__ import annotations

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rt_rs_tpu
from rt_rs_tpu.handlers import get_handler as jax_get_handler
from rt_rs_tpu.handlers.bvh import _bvh_intersect
from rt_rs_tpu.handlers.rf import _rf_intersect
from rt_rs_tpu_torch import ComputeConfig
from rt_rs_tpu_torch.bvh import wide
from rt_rs_tpu_torch.handlers import get_handler
from rt_rs_tpu_torch.ops import bvh_walk as bw
from rt_rs_tpu_torch.ops import cuda
from rt_rs_tpu_torch import Config, Renderer, Resolution
from rt_rs_tpu_torch.scene.presets import (
    deep_chain, ghost_scene, no_prims, tiled_copies, torus_canyon, torus_scene,
)
from tests.test_torch_bvh import close_hits
from tests.torch_rf_tree import rf_walk_build

torch.set_num_threads(
    max(1, (os.cpu_count() or 1) // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))
)

CFG = ComputeConfig()
WIN = dict(t_min=CFG.t_min, t_max=CFG.t_max, eps=CFG.eps)


def accel_of(scene, handler: str, **kwargs):
    """(accel, arrays) of the threaded ``handler`` on the CPU; for
    ``rf_bvh``, its records unpacked to the tree kernel G's payload
    leaves walk (``tests/torch_rf_tree.py``)."""
    if handler == "rf_bvh":
        return rf_walk_build(scene, **kwargs)[:2]
    return get_handler(handler, backend="threaded", **kwargs).build(scene, scene.pack(device="cpu"))


def packed(accel) -> wide.WalkTree:
    """The accel's tree packed as a CUDA build packs it."""
    return wide.pack_walk(*accel.walk.binary, payload=accel.walk.payload)


@pytest.fixture(scope="module")
def built():
    """case -> (scene, accel, arrays, packed tree): the trees the walk
    takes."""
    torus, canyon = torus_scene(), torus_canyon()
    ties = tiled_copies(torus_scene(), [(0.0, 0.0, 0.0)] * 2)
    cases = {
        "torus bvh": (torus, "bvh"), "torus rf_bvh": (torus, "rf_bvh"), "canyon bvh": (canyon, "bvh"),
        "ties bvh": (ties, "bvh"), "ties rf_bvh": (ties, "rf_bvh"),
        "one leaf bvh": (ghost_scene(1), "bvh"), "one leaf rf_bvh": (ghost_scene(1), "rf_bvh"),
    }
    out = {}
    for k, (scene, h) in cases.items():
        accel, arrays = accel_of(scene, h)
        out[k] = (scene, accel, arrays, packed(accel))
    return out


def rays(scene, n: int, seed: int, nan: int = 6, origin=None):
    """Seeded rays at ``scene``'s geometry -> (o, d, excl, valid): from
    a sphere around its middle (or from ``origin``), with rays of a zero
    y component (+0.0 and -0.0), rays along +-y with -0.0 elsewhere,
    ``nan`` NaN directions, 5% invalid and 20% excluding a prim."""
    rng = np.random.default_rng(seed)
    v = scene.vert_pos.astype(np.float64)
    mid, size = (v.min(0) + v.max(0)) / 2, float(np.linalg.norm(v.max(0) - v.min(0)))
    if origin is None:
        o = rng.normal(size=(n, 3))
        o = mid + 0.6 * size * o / np.linalg.norm(o, axis=1, keepdims=True)
    else:
        o = np.tile(np.asarray(origin, np.float64), (n, 1))
    d = mid + rng.uniform(-0.25, 0.25, (n, 3)) * size - o
    o = o.astype(np.float32)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    q = n // 16
    d[:q, 1] = 0.0
    d[q : 2 * q, 1] = -0.0
    d[2 * q : 3 * q] = np.float32(-0.0)
    d[2 * q : 3 * q, 1] = np.where(o[2 * q : 3 * q, 1] > mid[1], -1.0, 1.0)
    d[3 * q : 3 * q + nan] = np.nan
    valid = rng.random(n) > 0.05
    excl = np.where(rng.random(n) < 0.2, rng.integers(1, scene.num_prims + 1, n), 0).astype(np.int32)
    return tuple(torch.from_numpy(x) for x in (o, d, excl, valid))


# ----------------------------------------------------------------------
# The pack


def wobbled(tree):
    """The twin's slab bounds of every binary node, as int32 bits."""
    bmin, bmax = tree.binary[0], tree.binary[1]
    wob = 2e-6 + 1e-5 * torch.maximum(bmin.abs(), bmax.abs())
    return (bmin - wob).view(torch.int32), (bmax + wob).view(torch.int32)


def leaf_prims(tree) -> list[tuple[int, list[int]]]:
    """(binary leaf, its prims to test) in preorder, from the binary
    tree's own fields (empty slots and empty leaves dropped)."""
    _, _, _, _, count, leaves = (x.numpy() for x in tree.binary[:6])
    out = []
    for i in np.nonzero(count > 0)[0]:
        c = int(count[i])
        ids = leaves[i * 8 : i * 8 + c] if tree.payload else np.arange(leaves[i], leaves[i] + c)
        ids = [int(x) for x in ids if x != 0]
        if ids:
            out.append((int(i), ids))
    return out


def wide_leaves(tree):
    """Every wide node's children, from the root -> [(a leaf child's
    first packed prim, its slot's bounds lo [3], hi [3])] and the count
    of wide nodes reached."""
    w = wide.WIDTH
    nodes = tree.nodes
    seen, out, stack = 0, [], [0]
    while stack:
        k = stack.pop()
        seen += 1
        words = nodes[k, 6 * w : 7 * w].tolist()
        kids = []
        for s, word in enumerate(words):
            if word == 0:
                continue
            box = nodes[k, : 6 * w].reshape(3, 2, w)[:, :, s]
            kids.append((word, box[:, 0], box[:, 1]))
        for word, lo, hi in reversed(kids):
            if word > 0:
                stack.append(word)
        out += [(~word, lo, hi) for word, lo, hi in kids if word < 0]
    return out, seen


@pytest.mark.parametrize("case", ["torus bvh", "torus rf_bvh", "canyon bvh", "ties rf_bvh", "one leaf bvh"])
def test_pack_round_trips(built, case):
    """Packed prims are (a, b - a, c - a, pid) of the binary tree's
    leaves in preorder, ``last`` on each leaf's final prim; every wide
    node is reached once; every leaf child's box is its binary leaf's
    slab bounds; every node record's padding is zero."""
    _, accel, _, tree = built[case]
    assert accel.walk.nodes is None and accel.walk.prims is None  # a CPU build packs nothing
    assert all(x is y for x, y in zip(accel.walk.binary, tree.binary, strict=True))
    assert tree.nodes.dtype == tree.prims.dtype == torch.int32
    assert tree.nodes.shape[1] == wide.NODE_WORDS and tree.prims.shape[1] == wide.PRIM_WORDS
    pa, pb, pc = tree.binary[6:]
    leaves = leaf_prims(tree)
    ids = torch.tensor([p for _, ps in leaves for p in ps])
    f = tree.prims.view(torch.float32)
    assert torch.equal(tree.prims[:, 3], ids.int())
    assert torch.equal(f[:, 0:3], pa[ids]) and torch.equal(f[:, 4:7], pb[ids] - pa[ids])
    assert torch.equal(f[:, 8:11], pc[ids] - pa[ids])
    ends = np.cumsum([len(ps) for _, ps in leaves]) - 1
    last = np.zeros(ids.shape[0], np.int32)
    last[ends] = 1
    np.testing.assert_array_equal(tree.prims[:, 7].numpy(), last)
    assert not tree.prims[:, 11].any() and not tree.nodes[:, 7 * wide.WIDTH :].any()

    lo_w, hi_w = wobbled(tree)
    starts = {int(s): i for (i, _), s in zip(leaves, np.concatenate([[0], ends[:-1] + 1]), strict=True)}
    found, seen = wide_leaves(tree)
    assert seen == tree.nodes.shape[0]
    assert sorted(s for s, _, _ in found) == sorted(starts)
    for s, lo, hi in found:
        i = starts[s]
        assert torch.equal(lo, lo_w[i]) and torch.equal(hi, hi_w[i])
    assert 0 <= tree.stack <= wide.LOCAL_STACK  # these trees take the local-stack kernel


@pytest.mark.parametrize("case", ["torus bvh", "torus rf_bvh", "canyon bvh"])
def test_invariants_hold(built, case):
    """First child i + 1, a leaf's hit link its escape, children's boxes
    inside their parent's exactly in f32 (the rf tree on its f16-decoded
    bounds), and every leaf box with min <= max."""
    _, accel, _, _ = built[case]
    node_min, node_max, hit, miss, count = (x.numpy() for x in accel.walk.binary[:5])
    leaf = count > 0
    fst, snd = wide._children(hit.astype(np.int64), miss.astype(np.int64), leaf)
    inner = np.nonzero(~leaf)[0]
    np.testing.assert_array_equal(fst[inner], inner + 1)
    np.testing.assert_array_equal(hit[leaf], miss[leaf])
    for c in (fst[inner], snd[inner]):
        assert (node_min[inner] <= node_min[c]).all() and (node_max[inner] >= node_max[c]).all()
    assert (node_min[leaf] <= node_max[leaf]).all()


def handmade(payload: bool = False):
    """A small valid tree [root [a [l1 l2] l3]] over 5 prims -> the
    pack's arguments as a list (node_min, node_max, hit, miss, count,
    leaves, pa, pb, pc)."""
    box = lambda lo, hi: (np.full(3, lo, np.float32), np.full(3, hi, np.float32))  # noqa: E731
    bounds = [box(0, 4), box(0, 2), box(0, 1), box(1, 2), box(2, 4)]
    node_min = torch.tensor(np.stack([b[0] for b in bounds]))
    node_max = torch.tensor(np.stack([b[1] for b in bounds]))
    hit = torch.tensor([1, 2, 3, 4, 5], dtype=torch.int32)
    miss = torch.tensor([5, 4, 3, 4, 5], dtype=torch.int32)
    count = torch.tensor([0, 0, 2, 1, 1], dtype=torch.int32)
    if payload:
        leaves = torch.zeros(5 * 8, dtype=torch.int32)
        leaves[16:18] = torch.tensor([1, 2])
        leaves[24] = 3
        leaves[32] = 4
    else:
        leaves = torch.tensor([0, 0, 1, 3, 4], dtype=torch.int32)
    rng = np.random.default_rng(0)
    corners = [torch.tensor(rng.uniform(0.5, 1.5, (5, 3)).astype(np.float32)) for _ in range(3)]
    return [node_min, node_max, hit, miss, count, leaves, *corners]


def _break(args, what: str):
    node_min, node_max, hit, miss, count, leaves = args[:6]
    if what == "first child":
        hit[1] = 3
    elif what == "leaf hit link":
        hit[2] = 4
    elif what == "second child":
        miss[2] = 4
    elif what == "escape":
        miss[4] = 3
    elif what == "nesting":
        node_min[3, 1] = -1.0
    elif what == "inverted leaf":
        node_min[4, 0], node_max[4, 0] = 3.0, 2.5
    elif what == "prim id":
        leaves[4] = 5
    elif what == "nan bound":
        node_max[2, 2] = float("nan")
    elif what == "no room":
        count[4] = 0  # the last node made interior: no children fit before its escape
    return args


@pytest.mark.parametrize(
    "what, match",
    [
        ("first child", "first child"),
        ("leaf hit link", "escape"),
        ("second child", "escape|subtree ends"),
        ("escape", "miss link"),
        ("nesting", "not inside"),
        ("inverted leaf", "not inside|inverted"),
        ("prim id", "prim ids"),
        ("nan bound", "not inside"),
        ("no room", "no room"),
    ],
)
def test_pack_raises_on_a_broken_invariant(what, match):
    wide.pack_walk(*handmade(), payload=False)  # the unbroken tree packs
    with pytest.raises(wide.WideTreeError, match=match):
        wide.pack_walk(*_break(handmade(), what), payload=False)


def chain(depth: int) -> tuple:
    """A chain of ``depth`` interior nodes, each with a leaf second
    child: in preorder I_0 .. I_(depth-1), then the leaves L_depth,
    L_(depth-1), .. L_0, every box the unit cube -> the pack's
    arguments.  Each wide node holds three of its levels and pushes
    three entries."""
    m = 2 * depth + 1
    hit = torch.arange(1, m + 1, dtype=torch.int32)  # a first child, or a leaf's escape
    miss = hit.clone()  # a leaf's escape is the node after it
    miss[0] = m
    miss[1:depth] = torch.tensor([2 * depth - j + 1 for j in range(1, depth)], dtype=torch.int32)
    count = torch.zeros(m, dtype=torch.int32)
    count[depth:] = 1
    leaves = torch.zeros(m, dtype=torch.int32)
    leaves[depth:] = torch.arange(1, depth + 2, dtype=torch.int32)
    rng = np.random.default_rng(depth)
    corners = [torch.from_numpy(rng.random((depth + 2, 3), dtype=np.float32)) for _ in range(3)]
    return (torch.zeros(m, 3), torch.ones(m, 3), hit, miss, count, leaves, *corners)


def test_pack_raises_on_the_payload_limit():
    """More than 8 payload slots in a leaf raise."""
    args = handmade(payload=True)
    wide.pack_walk(*args, payload=True)
    args[4][2] = 9
    with pytest.raises(wide.WideTreeError, match="8-slot"):
        wide.pack_walk(*args, payload=True)


@pytest.mark.parametrize("depth", [30, 3 * wide.LOCAL_STACK])
def test_chain_stack_grows_with_depth(depth):
    """A chain needs one stack entry a level, past the kernel's local
    stack too: such a tree packs (the wrapper then takes the scratch
    kernel) and its mirror walk equals the twin's, using that stack."""
    tree = wide.pack_walk(*chain(depth), payload=False)
    assert tree.stack == depth
    rng = np.random.default_rng(depth)
    o = torch.from_numpy(np.c_[rng.uniform(0.2, 0.8, (64, 2)), np.full(64, -1.0)].astype(np.float32))
    d = torch.from_numpy(np.c_[rng.uniform(-0.05, 0.05, (64, 2)), np.ones(64)].astype(np.float32))
    excl, valid = torch.zeros(64, dtype=torch.int32), torch.ones(64, dtype=torch.bool)
    work, _, _ = check_mirror(tree, o, d, excl, valid, order_rows=range(0, 64, 13))
    assert work.max_stack == depth


def test_scratch_threads():
    """The scratch kernel's threads: one a ray where the stacks fit in
    SCRATCH_BYTES, else as many as fit, a multiple of the block."""
    assert bw.scratch_threads(1000, 100) == 1024
    assert bw.scratch_threads(0, 100) == bw.BLOCK
    big = bw.scratch_threads(2_073_600, 100)
    assert big % bw.BLOCK == 0 and big * 100 * 8 <= bw.SCRATCH_BYTES < (big + bw.BLOCK) * 100 * 8
    assert bw.scratch_threads(10, 10**7) == bw.BLOCK


def test_constants_match_the_kernel():
    """WIDTH, LOCAL_STACK and BLOCK are csrc/bvh_walk.cu's kWidth,
    kLocalStack and kBlock."""
    src = (cuda.CSRC / "bvh_walk.cu").read_text()
    assert int(re.search(r"kWidth = (\d+);", src).group(1)) == wide.WIDTH
    assert int(re.search(r"kLocalStack = (\d+);", src).group(1)) == wide.LOCAL_STACK
    assert int(re.search(r"kBlock = (\d+);", src).group(1)) == bw.BLOCK
    assert wide.NODE_WORDS == 8 * wide.WIDTH


def test_footprints_and_device_bytes(built):
    """``stats`` keeps the JAX package's footprints; the packed records
    are internal, their bytes reported apart (none on a CPU build)."""
    for case, size in (("torus bvh", 366_672), ("torus rf_bvh", 98_096), ("canyon bvh", 2_932_752)):
        _, accel, _, tree = built[case]
        h = get_handler(case.split()[1], backend="threaded")
        assert h.stats(accel).size == size
        assert accel.walk.device_bytes == 0
        assert tree.device_bytes == tree.nodes.numel() * 4 + tree.prims.numel() * 4
    packet, _ = get_handler("bvh", backend="packet").build(built["torus bvh"][0], built["torus bvh"][0].pack(device="cpu"))
    assert packet.walk is None and packet.chunks is not None


# ----------------------------------------------------------------------
# The mirror against the twin


def scalar_walk(tree, o, d, excl, valid, r: int):
    """Ray ``r``'s binary walk alone over the escape links, in NumPy
    f32 scalars (the twin's slab test and tri_intersect_pairs op for op)
    -> (t, pid, the pids whose prim it tests in order)."""
    node_min, node_max, hit, miss, count, leaves, pa, pb, pc = (x.numpy() for x in tree.binary)
    f = np.float32
    wob = f(2e-6) + f(1e-5) * np.maximum(np.abs(node_min), np.abs(node_max))
    lo_w, hi_w = node_min - wob, node_max + wob
    oo, dd = o[r].numpy(), d[r].numpy()
    best_t, best_id, seq = f(CFG.t_max + 1.0), 0, []
    idx = 0 if bool(valid[r]) else node_min.shape[0]
    with np.errstate(all="ignore"):
        inv = f(1.0) / dd
        while idx < node_min.shape[0]:
            t0, t1 = (lo_w[idx] - oo) * inv, (hi_w[idx] - oo) * inv
            nan = np.isnan(t0) | np.isnan(t1)
            near = np.where(nan, -np.inf, np.minimum(t0, t1)).max()
            far = np.where(nan, np.inf, np.maximum(t0, t1)).min()
            if not (near <= far and far >= CFG.t_min and near <= best_t):
                idx = int(miss[idx])
                continue
            c = int(count[idx])
            ids = leaves[idx * 8 : idx * 8 + c] if tree.payload else range(leaves[idx], leaves[idx] + c)
            for p in (int(x) for x in ids):
                if p == 0 or p == int(excl[r]):
                    continue
                seq.append(p)
                a, e1, e2 = pa[p], pb[p] - pa[p], pc[p] - pa[p]
                px, py, pz = dd[1] * e2[2] - dd[2] * e2[1], dd[2] * e2[0] - dd[0] * e2[2], dd[0] * e2[1] - dd[1] * e2[0]
                tx, ty, tz = oo - a
                qx, qy, qz = ty * e1[2] - tz * e1[1], tz * e1[0] - tx * e1[2], tx * e1[1] - ty * e1[0]
                det = e1[0] * px + e1[1] * py + e1[2] * pz
                u = tx * px + ty * py + tz * pz
                v = dd[0] * qx + dd[1] * qy + dd[2] * qz
                eps = f(CFG.eps)
                ok = (det > eps and u >= 0 and u <= det and v >= 0 and u + v <= det) or (
                    det < -eps and u <= 0 and u >= det and v <= 0 and u + v >= det
                )
                if ok:
                    w = (e2[0] * qx + e2[1] * qy + e2[2] * qz) / det
                    if CFG.t_min < w < CFG.t_max and w < best_t:
                        best_t, best_id = w, p
            idx = int(hit[idx])
    return best_t, best_id, seq


def check_mirror(tree, o, d, excl, valid, order_rows=()):
    """The mirror against the twin: (t, pid) bit for bit and equal prim
    tests; on ``order_rows`` each ray's tests, in order, those of the
    ray's binary walk alone (which gives the twin's t and pid)."""
    twin_work, wide_work = bw.WalkWork(), bw.WideWork(order=[[] for _ in range(o.shape[0])])
    t0, p0 = bw.walk_reference(o, d, excl, valid, tree, work=twin_work, **WIN)
    t1, p1 = bw.bvh_walk_wide_reference(o, d, excl, valid, tree, work=wide_work, **WIN)
    assert torch.equal(t0.view(torch.int32), t1.view(torch.int32))
    assert torch.equal(p0, p1)
    assert wide_work.prim_tests == twin_work.prim_tests > 0
    assert wide_work.max_stack <= tree.stack
    assert sum(len(x) for x in wide_work.order) == wide_work.prim_tests
    for r in order_rows:
        t, pid, seq = scalar_walk(tree, o, d, excl, valid, r)
        assert (np.float32(t).view(np.int32), pid) == (int(t0[r].view(torch.int32)), int(p0[r])), r
        assert wide_work.order[r] == seq, r
    return wide_work, t1, p1


@pytest.mark.parametrize("case", ["torus bvh", "torus rf_bvh", "ties bvh", "ties rf_bvh"])
def test_mirror_equals_twin(built, case):
    scene, _, _, tree = built[case]
    o, d, excl, valid = rays(scene, 640, seed=11, nan=0 if case.startswith("ties") else 2)
    work, _, pid = check_mirror(tree, o, d, excl, valid, order_rows=range(0, 640, 9))
    assert work.node_visits > 0
    hit = pid[valid] != 0
    assert 0.1 < hit.float().mean() < 0.99
    assert (pid[~valid] == 0).all() and (pid[excl != 0] != excl[excl != 0]).all()


def test_mirror_equals_twin_on_the_canyon(built):
    """A slice of rays from the canyon's camera over its 50,562
    triangles (the deepest tree)."""
    scene, _, _, tree = built["canyon bvh"]
    o, d, excl, valid = rays(scene, 512, seed=3, nan=0, origin=scene.camera.pos)
    check_mirror(tree, o, d, excl, valid)


@pytest.mark.parametrize("handler", ["bvh", "rf_bvh"])
def test_mirror_equals_twin_on_a_single_leaf(built, handler):
    scene, _, _, tree = built[f"one leaf {handler}"]
    assert int((tree.binary[4] > 0).sum()) == 1 and tree.nodes.shape[0] == 1
    o, d, excl, valid = rays(scene, 256, seed=5)
    excl[:64] = 1  # exclude the wall on a quarter of the rays
    check_mirror(tree, o, d, excl, valid)


def test_mirror_equals_twin_with_empty_payload_slots(built):
    """rf_bvh's payload with a slot in three emptied: the twin skips the
    0, the pack drops it (and a leaf left with none)."""
    scene, _, _, full = built["torus rf_bvh"]
    b = list(full.binary)
    payload, count = b[5].clone(), b[4]
    rng = np.random.default_rng(2)
    for i in np.nonzero(count.numpy() > 0)[0]:
        if rng.random() < 0.3:
            payload[i * 8 + rng.integers(0, int(count[i]))] = 0
    b[5] = payload
    tree = wide.pack_walk(*b, payload=True)
    assert tree.prims.shape[0] < full.prims.shape[0]
    o, d, excl, valid = rays(scene, 512, seed=8, nan=2)
    check_mirror(tree, o, d, excl, valid, order_rows=range(0, 512, 17))


# ----------------------------------------------------------------------
# The mirror against the JAX package


@pytest.mark.parametrize("handler", ["bvh", "rf_bvh"])
def test_mirror_matches_jax(handler):
    """On a small torus (402 triangles) against ``_bvh_intersect`` /
    ``_rf_intersect``: t within rtol 1e-5, pid equal but near-ties."""
    scene = torus_scene(segments=(20, 10))
    accel, _ = accel_of(scene, handler)
    js = rt_rs_tpu.Scene.from_json(scene.to_json())
    jaccel, jarrays = jax_get_handler(handler, backend="threaded").build(js, js.pack())
    o, d, excl, valid = rays(scene, 1000, seed=21)
    t, pid = bw.bvh_walk_wide_reference(o, d, excl, valid, packed(accel), **WIN)
    jfn, jtree = (_bvh_intersect, jaccel.nodes) if handler == "bvh" else (_rf_intersect, jaccel.records)
    jt, jpid = jfn(
        jtree, jarrays.pa, jarrays.pb, jarrays.pc, *(jnp.asarray(x.numpy()) for x in (o, d, excl, valid)), **WIN
    )
    close_hits(t.numpy(), pid.numpy(), jt, jpid, CFG.t_max)
    assert 0.1 < (pid[valid] != 0).float().mean() < 0.99


# ----------------------------------------------------------------------
# Trees at the edges, through the handlers


def frames(scene, handler: str, **kwargs) -> dict:
    """backend -> the 48x32 frame of ``handler`` on the CPU."""
    out = {}
    for backend in ("threaded", "packet"):
        r = Renderer(
            scene, config=Config(resolution=Resolution.sized(48, 32)), handler=handler,
            handler_kwargs=dict(backend=backend, **kwargs), device="cpu",
        )
        out[backend] = r.render_frame()
    return out


@pytest.mark.parametrize("handler", ["bvh", "rf_bvh"])
def test_deep_chain_renders_and_packs(handler):
    """``deep_chain``'s tree, about 100 levels deep with ``eps=0``,
    renders through the threaded walk as through the packet kernels;
    packed, its walk needs more than the kernel's local stack, and the
    mirror equals the twin on rays from its camera."""
    scene = deep_chain()
    f = frames(scene, handler, eps=0.0)
    assert torch.equal(f["threaded"], f["packet"])
    lit = (f["threaded"].sum(-1) > 0).float().mean()
    assert 0.02 < lit < 0.5
    accel, _ = accel_of(scene, handler, eps=0.0)
    tree = packed(accel)
    assert tree.stack > wide.LOCAL_STACK
    o, d, excl, valid = rays(scene, 512, seed=13, nan=2, origin=scene.camera.pos)
    d[::4] = torch.tensor([0.0, -0.3, 1.0]) - o[::4]  # a quarter toward the chain's tip at the origin
    work, _, pid = check_mirror(tree, o, d, excl, valid, order_rows=range(0, 512, 31))
    assert work.max_stack > wide.LOCAL_STACK // 2 and (pid[valid] != 0).any()


@pytest.mark.parametrize("handler", ["bvh", "rf_bvh"])
def test_empty_scene_renders_black_and_packs(handler):
    """A scene with no prims renders black through both backends; its
    tree packs as one node over a copy of the null row, and the mirror
    equals the twin (every ray misses)."""
    scene = no_prims()
    f = frames(scene, handler)
    assert torch.equal(f["threaded"], f["packet"]) and not f["threaded"].any()
    accel, arrays = accel_of(scene, handler)
    assert arrays.pa.shape[0] == 2 and not arrays.pa.any()
    tree = packed(accel)
    assert tree.nodes.shape[0] == 1 and tree.prims.shape[0] == 1 and tree.stack == 0
    o, d, excl, valid = rays(ghost_scene(1), 128, seed=4, nan=2)  # toward the origin
    twin_work, wide_work = bw.WalkWork(), bw.WideWork()
    t0, p0 = bw.walk_reference(o, d, excl, valid, tree, work=twin_work, **WIN)
    t1, p1 = bw.bvh_walk_wide_reference(o, d, excl, valid, tree, work=wide_work, **WIN)
    assert torch.equal(t0, t1) and torch.equal(p0, p1) and not p0.any()
    assert wide_work.prim_tests == twin_work.prim_tests > 0


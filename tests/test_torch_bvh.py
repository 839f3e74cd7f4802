"""rt_rs_tpu_torch's ``bvh`` and ``rf_bvh`` handlers, their tree data
and the threaded walk (``ops/bvh_walk.py``) against the JAX package's.

Inputs are built in code: ``torus_scene()`` (6,322 triangles; 7,639
nodes at 2 items a leaf, 4,087 at 4), ``torus_canyon()`` for the RF
record limit, and rays made from a seed with NumPy.  Tree data, RF
records and the walk's tensors are host arithmetic: bit-equal.  The walk
against the JAX ``lax.while_loop``: XLA:CPU contracts the Möller–Trumbore
arithmetic into FMAs where the port rounds every op, so t is held at
rtol 1e-5 and pid equal except near-ties (at most 0.1% of rays), the
rule of tests/test_torch_intersect.py.  Frames are in
tests/test_torch_bvh_frames.py.
"""

from __future__ import annotations

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rt_rs_tpu
from rt_rs_tpu.bvh import BvhData as JaxBvhData
from rt_rs_tpu.bvh import build_bvh as jax_build_bvh
from rt_rs_tpu.bvh import rf as jrf
from rt_rs_tpu.handlers import get_handler as jax_get_handler
from rt_rs_tpu.handlers.bvh import _bvh_intersect
from rt_rs_tpu.handlers.rf import _rf_intersect
from rt_rs_tpu_torch import ComputeConfig, Scene, convert
from rt_rs_tpu_torch.bvh import BvhData, build_bvh
from rt_rs_tpu_torch.bvh import rf
from rt_rs_tpu_torch.handlers import get_handler
from rt_rs_tpu_torch.ops import bvh_walk as bw
from rt_rs_tpu_torch.scene.presets import torus_canyon, torus_scene
from tests.torch_rf_tree import rf_walk_build

torch.set_num_threads(
    max(1, (os.cpu_count() or 1) // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))
)

CFG = ComputeConfig()
N_RAYS = 1500


def jax_scene(scene: Scene):
    return rt_rs_tpu.Scene.from_json(scene.to_json())


@pytest.fixture(scope="module")
def torus():
    return torus_scene()


@pytest.fixture(scope="module")
def trees(torus):
    """target_item_count -> (the port's tree, the JAX package's tree)."""
    js = jax_scene(torus)
    return {k: (build_bvh(torus, target_item_count=k), jax_build_bvh(js, target_item_count=k)) for k in (2, 4)}


def _fields_equal(a, b, fields):
    for f in fields:
        np.testing.assert_array_equal(np.asarray(getattr(a, f)), np.asarray(getattr(b, f)), err_msg=f)


@pytest.mark.parametrize("items", [2, 4])
def test_tree_helpers_match_jax(torus, trees, items):
    ours, ref = trees[items]
    _fields_equal(ours, ref, ("fst", "snd", "item_idx", "item_count", "bounds_min", "bounds_max", "indices"))
    assert ours.num_nodes == {2: 7639, 4: 4087}[items]
    np.testing.assert_array_equal(ours.is_leaf(), ref.is_leaf())
    for a, b in zip(ours.escape_links(), ref.escape_links(), strict=True):
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    for a, b in zip(ours.cover_bounds(torus), ref.cover_bounds(jax_scene(torus)), strict=True):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    assert ours.max_depth() == ref.max_depth() > 1
    assert ours.byte_size() == ref.byte_size() == 48 * ours.num_nodes
    # The same methods on the JAX package's tree carried across.
    moved = convert.bvh_data(ref)
    for a, b in zip(moved.escape_links(), ref.escape_links(), strict=True):
        np.testing.assert_array_equal(a, b)


def test_escape_links_walk_every_node_once(trees):
    """Entering every box visits each node exactly once, in preorder,
    and reaches END (the walk's termination)."""
    data = trees[2][0]
    hit, miss = data.escape_links()
    seen, i = [], 0
    while i < data.num_nodes:
        seen.append(i)
        i = int(hit[i])
    assert seen == list(range(data.num_nodes))
    assert (miss > np.arange(data.num_nodes)).all() and (hit > np.arange(data.num_nodes)).all()


def test_f16_rounding_and_packing_match_jax():
    rng = np.random.default_rng(3)
    x = np.concatenate(
        [rng.normal(size=4000) * 10.0 ** rng.integers(-6, 5, 4000), [0.0, -0.0, 1.0, 65504.0, -1e-9]]
    ).astype(np.float32)
    for ours, ref in ((rf._f16_down, jrf._f16_down), (rf._f16_up, jrf._f16_up)):
        a, b = ours(x), ref(x)
        np.testing.assert_array_equal(a.view(np.uint16), b.view(np.uint16))
    assert (rf._f16_down(x).astype(np.float32) <= x).all()
    assert (rf._f16_up(x).astype(np.float32) >= x).all()
    lo, hi = rf._f16_down(x), rf._f16_up(x)
    packed = rf.pack2x16(lo, hi)
    np.testing.assert_array_equal(packed, jrf.pack2x16(lo, hi))
    for a, b in zip(rf.unpack2x16(packed), jrf.unpack2x16(packed), strict=True):
        np.testing.assert_array_equal(a, b)


def test_rf_records_match_jax(torus, trees):
    ours, ref = trees[4]
    mine = rf.pack_rf(ours, *ours.cover_bounds(torus))
    theirs = jrf.pack_rf(ref, *ref.cover_bounds(jax_scene(torus)))
    assert mine.records.dtype == np.uint32
    np.testing.assert_array_equal(mine.records, theirs.records)
    assert mine.num_records == 6131 and mine.byte_size() == theirs.byte_size() == 98096
    un, jun = rf.unpack_rf(mine), jrf.unpack_rf(convert.rf_data(theirs))
    assert sorted(un) == sorted(jun)
    for k in un:
        np.testing.assert_array_equal(un[k], jun[k], err_msg=k)
    # The structural walk: one payload record after each leaf record.
    assert un["is_leaf"].sum() == un["is_payload"].sum() == 2044
    assert not (un["is_leaf"] & un["is_payload"]).any()


def test_unpack_rf_reads_payload_words_structurally():
    """A payload word whose slot 7 holds a prim id >= 2^15 sets bit 31:
    a bare MSB test would call that payload record a leaf."""
    data = BvhData(
        fst=np.array([1, 0, 0], np.uint32), snd=np.array([2, 0, 0], np.uint32),
        item_idx=np.array([0, 0, 8], np.uint32), item_count=np.array([0, 8, 1], np.uint32),
        bounds_min=np.zeros((3, 3), np.float32), bounds_max=np.ones((3, 3), np.float32),
        indices=np.array([1, 2, 3, 4, 5, 6, 7, 40000, 9], np.uint32),
    )
    mine = rf.pack_rf(data)
    assert mine.records[2, 3] >> 31 == 1  # the payload word, MSB set
    un = rf.unpack_rf(mine)
    np.testing.assert_array_equal(un["is_leaf"], [False, True, False, True, False])
    np.testing.assert_array_equal(un["is_payload"], [False, False, True, False, True])
    assert un["leaf_prims"][1, 7] == 40001
    jun = jrf.unpack_rf(jrf.pack_rf(JaxBvhData(**{k: getattr(data, k) for k in vars(data)})))
    for k in un:
        np.testing.assert_array_equal(un[k], jun[k], err_msg=k)


def test_rf_format_error_on_the_canyon():
    """torus_canyon() needs 49,277 records, past the 2^15 limit: both
    packages refuse it (the tree built once, carried to the JAX package)."""
    data = build_bvh(torus_canyon(), target_item_count=4)
    assert data.num_nodes + int(data.is_leaf().sum()) == 49277
    with pytest.raises(rf.RfFormatError, match="15-bit"):
        rf.pack_rf(data)
    with pytest.raises(jrf.RfFormatError, match="15-bit"):
        jrf.pack_rf(JaxBvhData(**{k: getattr(data, k) for k in vars(data)}))
    assert rf.MAX_RECORDS == jrf.MAX_RECORDS and rf.MAX_LEAF_ITEMS == jrf.MAX_LEAF_ITEMS
    assert rf.MAX_PRIM_ID == jrf.MAX_PRIM_ID


def test_rf_format_error_on_a_coincident_leaf():
    """16 coincident triangles cannot be split: one leaf past 8 slots
    (tests/test_rf.py::test_rf_limits)."""
    scene = Scene.empty()
    verts = np.random.default_rng(1).normal(size=(3, 3)).astype(np.float32) * 1e-6
    scene.vert_pos = np.tile(verts, (16, 1)).astype(np.float32)
    scene.vert_norm = np.zeros_like(scene.vert_pos)
    scene.prim_indices = np.arange(48, dtype=np.uint32).reshape(16, 3)
    scene.prim_material = np.zeros(16, dtype=np.int32)
    data = build_bvh(scene, target_item_count=4)
    ref = jax_build_bvh(jax_scene(scene), target_item_count=4)
    assert int(data.item_count.max()) == int(ref.item_count.max()) > rf.MAX_LEAF_ITEMS
    with pytest.raises(rf.RfFormatError, match="8-slot"):
        rf.pack_rf(data)
    with pytest.raises(jrf.RfFormatError, match="8-slot"):
        jrf.pack_rf(ref)


def _rays(torus, seed: int = 5, n: int = N_RAYS):
    """Rays at the torus from a seed: mostly toward its middle, with
    axis-parallel rays (zero direction components), NaN directions,
    invalid rays and excluded prims."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3))
    o = (6.0 * o / np.linalg.norm(o, axis=1, keepdims=True)).astype(np.float32)
    d = rng.uniform(-1.5, 1.5, (n, 3)) - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    d[:40, 1] = 0.0
    d[40:60, 0] = d[40:60, 2] = 0.0  # along y only
    d[40:60, 1] = np.where(o[40:60, 1] > 0, -1.0, 1.0)
    d[60:70] = np.nan
    valid = rng.random(n) > 0.05
    excl = np.where(rng.random(n) < 0.2, rng.integers(1, torus.num_prims + 1, n), 0).astype(np.int32)
    return o, d, excl, valid


def _walk_args(arrays, tree):
    return (*tree, arrays.pa, arrays.pb, arrays.pc)


def close_hits(t, pid, jt, jpid, t_max: float):
    """t within rtol 1e-5 and pid equal, except near-ties and edge
    flips on at most 0.1% of rays."""
    t, pid, jt, jpid = (np.asarray(x) for x in (t, pid, jt, jpid))
    diff = pid != jpid
    assert diff.mean() <= 1e-3, f"{diff.sum()} pids differ"
    np.testing.assert_allclose(t[~diff], jt[~diff], rtol=1e-5)
    miss = np.float32(t_max + 1.0)
    assert (t[pid == 0] == miss).all() and (jt[jpid == 0] == miss).all()


@pytest.mark.parametrize("handler", ["bvh", "rf_bvh"])
def test_walk_matches_jax(torus, handler):
    """bvh_walk_reference (contiguous / payload leaves) against the JAX
    _bvh_intersect / _rf_intersect on the same tree and rays; the walk's
    tensors bit-equal to the JAX handler's."""
    if handler == "rf_bvh":
        # the records unpacked to the JAX walk's f32 arrays
        accel, arrays, _ = rf_walk_build(torus)
    else:
        accel, arrays = get_handler(handler, backend="threaded").build(torus, torus.pack(device="cpu"))
    jh = jax_get_handler(handler, backend="threaded")
    js = jax_scene(torus)
    jaccel, jarrays = jh.build(js, js.pack())
    if handler == "bvh":
        nodes, jnodes = accel.nodes, jaccel.nodes
        fields = ("node_min", "node_max", "hit_link", "miss_link", "leaf_start", "leaf_count")
        tree = (nodes.node_min, nodes.node_max, nodes.hit_link, nodes.miss_link, nodes.leaf_count, nodes.leaf_start)
        jfn = _bvh_intersect
    else:
        nodes, jnodes = accel.records, jaccel.records
        fields = ("node_min", "node_max", "hit_link", "miss_link", "payload", "leaf_count")
        tree = (nodes.node_min, nodes.node_max, nodes.hit_link, nodes.miss_link, nodes.leaf_count, nodes.payload)
        jfn = _rf_intersect
    for f in fields:
        np.testing.assert_array_equal(getattr(nodes, f).numpy(), np.asarray(getattr(jnodes, f)), err_msg=f)
    assert nodes.num_nodes == jnodes.num_nodes and nodes.footprint == jnodes.footprint
    for f in ("pa", "pb", "pc"):
        np.testing.assert_array_equal(getattr(arrays, f).numpy(), np.asarray(getattr(jarrays, f)))

    o, d, excl, valid = _rays(torus)
    win = dict(t_min=CFG.t_min, t_max=CFG.t_max, eps=CFG.eps)
    work = bw.WalkWork()
    t, pid = bw.bvh_walk_reference(
        *(torch.from_numpy(x) for x in (o, d, excl, valid)), *_walk_args(arrays, tree),
        payload=handler == "rf_bvh", work=work, **win,
    )
    jt, jpid = jfn(jnodes, jarrays.pa, jarrays.pb, jarrays.pc, *(jnp.asarray(x) for x in (o, d, excl, valid)), **win)
    close_hits(t.numpy(), pid.numpy(), jt, jpid, CFG.t_max)
    pid = pid.numpy()
    assert 0.2 < (pid[valid] != 0).mean() < 0.95  # hits and misses
    assert (pid[~valid] == 0).all() and (pid[60:70] == 0).all()  # invalid and NaN rays miss
    assert (pid[excl != 0] != excl[excl != 0]).all()
    assert (pid[40:60][valid[40:60]] != 0).any()  # axis-parallel rays hit
    # NaN rays enter every node: the walk still ends, its steps counted.
    assert work.node_steps > 0 and work.prim_tests > 0
    assert 0 < work.nodes_read <= nodes.num_nodes and 0 < work.prims_read <= torus.num_prims


def _tiles(o, d, excl, valid, r: int = 60):
    """Flat rays (N a multiple of ``r``) as ``tile_rays``-shaped tiles:
    payload [8, N // r, r] (excl as f32 in row 6, no cap), valid
    [N // r, r]."""
    t = o.shape[0] // r
    payload = torch.cat(
        [o.T.reshape(3, t, r), d.T.reshape(3, t, r), excl.to(torch.float32).reshape(1, t, r), o.new_zeros((1, t, r))]
    )
    return payload.contiguous(), valid.reshape(t, r)


def test_wrapper_runs_the_twin_on_cpu_and_counts(torus):
    """On CPU tensors the wrapper's closest mode is the twin on the
    accel's binary tree, on the tiles' rays (``tile_rays`` gives them
    back); the counts of a walk grow with its rays, and tiles of no ray
    walk nothing."""
    h = get_handler("bvh", backend="threaded")
    accel, arrays = h.build(torus, torus.pack(device="cpu"))
    n = accel.nodes
    tree = (n.node_min, n.node_max, n.hit_link, n.miss_link, n.leaf_count, n.leaf_start)
    assert all(x is y for x, y in zip(accel.walk.binary, _walk_args(arrays, tree), strict=True))
    o, d, excl, valid = (torch.from_numpy(x[70:]) for x in _rays(torus, seed=9, n=370))  # no NaN rays
    payload, tv = _tiles(o, d, excl, valid)
    assert all(torch.equal(x, y) for x, y in zip(bw.tile_rays(payload, tv)[:4], (o, d, excl, valid)))
    win = dict(t_min=CFG.t_min, t_max=CFG.t_max, eps=CFG.eps)
    a = bw.bvh_walk_tiled(payload, tv, accel.walk, mode="closest", **win)
    b = bw.bvh_walk_reference(o, d, excl, valid, *_walk_args(arrays, tree), payload=False, **win)
    assert all(torch.equal(x.reshape(-1), y) for x, y in zip(a, b, strict=True))
    half, full = bw.WalkWork(), bw.WalkWork()
    bw.bvh_walk_reference(o[:150], d[:150], excl[:150], valid[:150], *_walk_args(arrays, tree), payload=False, work=half, **win)
    bw.bvh_walk_reference(o, d, excl, valid, *_walk_args(arrays, tree), payload=False, work=full, **win)
    assert 0 < half.node_steps < full.node_steps and 0 < half.prim_tests < full.prim_tests
    t, pid = bw.bvh_walk_tiled(payload[:, :0], tv[:0], accel.walk, mode="closest", **win)
    assert t.shape == pid.shape == (0, 60)
    assert bw.walk_name(False, "closest") == "bvh_walk[bvh,closest]"
    assert bw.walk_name(True, "anyhit") == "bvh_walk[rf,anyhit]"


def _intersect(handler, scene, **kwargs):
    h = get_handler(handler, **kwargs)
    accel, arrays = h.build(scene, scene.pack(device="cpu"))
    return h, arrays, h.intersect_fn(accel, arrays, CFG)


def _flat_rays(torus, seed):
    o, d, _, _ = _rays(torus, seed=seed, n=400)
    keep = np.isfinite(d).all(axis=1)
    o, d = torch.from_numpy(o[keep]), torch.from_numpy(d[keep])
    return o, d, torch.zeros((o.shape[0],), dtype=torch.int32)


@pytest.mark.parametrize("handler", ["bvh", "rf_bvh"])
def test_walk_matches_naive(torus, handler):
    """The threaded walk's closest hits are the brute-force ones; bvh's
    ids are rows of its leaf-ordered arrays, rf_bvh keeps scene order."""
    h, _, fn = _intersect(handler, torus, backend="threaded")
    _, _, naive = _intersect("naive", torus)
    o, d, excl = _flat_rays(torus, 11)
    t, pid = fn(o, d, excl)
    t0, id0 = naive(o, d, excl, torch.ones_like(excl, dtype=torch.bool))
    np.testing.assert_allclose(t.numpy(), t0.numpy(), rtol=1e-5)
    if handler == "bvh":
        perm = np.concatenate([[0], h.bvh_data.indices.astype(np.int64) + 1])
        pid = torch.from_numpy(perm[pid.numpy()]).int()
    assert torch.equal(pid, id0) and 0.2 < (pid != 0).float().mean() < 0.95


@pytest.mark.parametrize("handler", ["bvh", "rf_bvh"])
def test_packet_backend_matches_threaded(torus, handler):
    """backend="packet" (the pbvh kernels' twins over leaf order) gives
    the threaded walk's hits, ids included (tests/test_bvh.py:181-203,
    tests/test_rf.py:143-170); rf_bvh's packet ids map back through the
    leaf order, and exclude in their own id space."""
    ht, _, ft = _intersect(handler, torus, backend="threaded")
    hp, _, fp = _intersect(handler, torus, backend="packet")
    o, d, excl = _flat_rays(torus, 33)
    ones = torch.ones_like(excl, dtype=torch.bool)
    t0, i0 = ft(o, d, excl, ones)
    t1, i1 = fp(o, d, excl, ones)
    np.testing.assert_allclose(t1.numpy(), t0.numpy(), rtol=1e-5)
    if handler == "bvh":
        assert torch.equal(i1, i0)
    else:
        perm = np.concatenate([[0], hp.bvh_data.indices.astype(np.int64) + 1])
        np.testing.assert_array_equal(perm[i1.numpy()], i0.numpy())
        _, i2 = fp(o, d, i1, ones)
        hits = i1 != 0
        assert (i2[hits] != i1[hits]).all()


@pytest.mark.parametrize(
    "backend, num_prims, device, packet",
    [
        # "auto" walks on every device and past or within the JAX
        # package's 12,288-triangle packet cap (its TPU's VMEM model)
        *[("auto", n, dev, False) for dev in ("cpu", "cuda") for n in (6322, 12288, 12289)],
        ("packet", 50562, "cpu", True),
        ("packet", 6322, "cuda", True),
        ("threaded", 10, "cuda", False),
        ("threaded", 6322, "cpu", False),
    ],
)
def test_backend_rule(backend, num_prims, device, packet):
    from rt_rs_tpu_torch.handlers.bvh import use_packet

    assert use_packet(backend, num_prims, torch.device(device)) is packet


def test_backend_rule_refuses_unknown_modes():
    with pytest.raises(ValueError, match="backend"):
        get_handler("bvh", backend="nope")
    with pytest.raises(ValueError, match="refine"):
        get_handler("rf_bvh", refine="nope")


def test_checkpoint_through_path(torus, tmp_path):
    """A tree written with to_json and loaded through path= (the
    BvhConfig::Bytes route) gives the built tree's walk and stats; the
    JAX package's checkpoint of the same tree is the same file."""
    data = build_bvh(torus)
    path = tmp_path / "torus.bvh.json"
    data.save(str(path))
    jpath = tmp_path / "torus_jax.bvh.json"
    jax_build_bvh(jax_scene(torus)).save(str(jpath))
    assert path.read_bytes() == jpath.read_bytes()
    _, _, built = _intersect("bvh", torus, backend="threaded")
    h, _, loaded = _intersect("bvh", torus, backend="threaded", path=str(jpath))
    o, d, excl = _flat_rays(torus, 17)
    for a, b in zip(built(o, d, excl), loaded(o, d, excl)):
        assert torch.equal(a, b)
    _fields_equal(h.bvh_data, data, ("fst", "snd", "item_idx", "item_count", "bounds_min", "bounds_max", "indices"))
    accel, _ = h.build(torus, torus.pack(device="cpu"))
    assert h.stats(accel).size == 48 * data.num_nodes


@pytest.mark.parametrize("handler", ["bvh", "rf_bvh"])
def test_stats_match_jax(torus, handler):
    h = get_handler(handler)
    accel, _ = h.build(torus, torus.pack(device="cpu"))
    jh = jax_get_handler(handler)
    js = jax_scene(torus)
    jaccel, _ = jh.build(js, js.pack())
    ours, ref = h.stats(accel), jh.stats(jaccel)
    assert (ours.name, ours.size) == (ref.name, ref.size)
    assert ours.size == {"bvh": 366672, "rf_bvh": 98096}[handler]

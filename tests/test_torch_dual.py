"""Dual-granularity chunk tables (pbvh's ``tri_chunk_fine``) and the flat
segmented entry of rt_rs_tpu_torch against the JAX package's.

A dual table packs one leaf order twice, at the coarse chunk height (64)
and a fine one: a triangle's prim id is its leaf index plus 1 in both,
and the per-(ray, triangle) arithmetic does not depend on the height,
so a dual frame is the single-table frame bit for bit, whichever table
each call sweeps.  Segments are forced as the JAX package's tests force
them: ``MAX_VMEM_CHUNKS`` = 16 splits ``torus_scene``'s coarse table
(with its rows table) into 4 segments of 2,048 triangles, and its fine
tc = 16 table (no rows table) into 13 of 512.

The tables are built by the same IEEE operations in both packages, so
they are bit-equal.  The flat segmented entry is bit-equal to the port's
``tiled_as_flat`` over the segmented tiled entry in scene order; against
the JAX package's interpret-mode kernels ``t`` is held at rtol 1e-5
(XLA:CPU contracts the Möller–Trumbore arithmetic into FMAs) and a pid
may differ only at a near-tie, as in tests/test_torch_segmented.py.
"""

from __future__ import annotations

import os
from functools import partial

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rt_rs_tpu
from rt_rs_tpu.handlers import get_handler as jax_get_handler
from rt_rs_tpu.ops.pallas import packet_trace as jpt
from rt_rs_tpu_torch import Config, Renderer, Resolution, convert
from rt_rs_tpu_torch.handlers.base import tiled_as_flat
from rt_rs_tpu_torch.handlers.pbvh import PacketBvhIntrs
from rt_rs_tpu_torch.ops import packet_trace as pt
from rt_rs_tpu_torch.scene.presets import torus_ghost, torus_scene

torch.set_num_threads(
    max(1, (os.cpu_count() or 1) // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))
)

FORCED_CAP = 16
SIZE = (32, 24)
KW = dict(t_min=0.01, t_max=1000.0, eps=1e-7)


def _config(width: int, height: int) -> Config:
    return Config(resolution=Resolution.sized(width, height))


def frame(scene=None, seg_order="auto", **hkw) -> torch.Tensor:
    r = Renderer(
        torus_scene() if scene is None else scene, config=_config(*SIZE), handler="pbvh",
        handler_kwargs=hkw or None, device="cpu", seg_order=seg_order,
    )
    return r.render_frame()


@pytest.fixture
def forced(monkeypatch):
    monkeypatch.setattr(pt, "MAX_VMEM_CHUNKS", FORCED_CAP)
    monkeypatch.setattr(jpt, "MAX_VMEM_CHUNKS", FORCED_CAP)


@pytest.fixture(scope="module")
def single() -> torch.Tensor:
    """The single-table frame (resident; the segmented one is equal)."""
    return frame()


@pytest.mark.parametrize("fine", [16, 32])
def test_resident_dual_frame_equals_single(single, fine):
    r = Renderer(
        torus_scene(), config=_config(*SIZE), handler="pbvh",
        handler_kwargs={"tri_chunk_fine": fine}, device="cpu",
    )
    assert isinstance(r.accel, pt.DualTriChunks) and r.accel.fine.tri_chunk == fine
    assert torch.equal(r.render_frame(), single)


@pytest.mark.parametrize(
    "fine,order", [(16, "scene"), (16, "auto"), (16, (3, 1, 0, 2)), (64, (3, 2, 1, 0))]
)
def test_segmented_dual_frame_equals_single(forced, single, fine, order):
    assert torch.equal(frame(seg_order=order, tri_chunk_fine=fine), single)


def test_dual_dispatch_and_the_fine_tables_order(forced, monkeypatch):
    """Calls with ``refine`` sweep the fine table, the others the coarse
    one; rows calls run on the coarse table only.  The fine table takes
    the coarse ``seg_order`` when its segment count is the same (fine tc
    64 here: 4 segments) and keeps build order otherwise (tc 16: 13)."""
    seen = []
    orig = pt.packet_closest_hit_segmented_tiled

    def spy(seg, payload, valid, t_cap=None, **kw):
        seen.append(
            (seg.segments[0].tri_chunk, bool(kw.get("refine")), kw.get("emit_rows", False),
             kw.get("any_hit", False), kw.get("seg_order"))
        )
        return orig(seg, payload, valid, t_cap, **kw)

    monkeypatch.setattr(pt, "packet_closest_hit_segmented_tiled", spy)
    for fine, fine_order in ((16, None), (64, (3, 2, 1, 0))):
        seen.clear()
        r = Renderer(
            torus_scene(), config=_config(16, 16), handler="pbvh",
            handler_kwargs={"tri_chunk_fine": fine}, device="cpu", force_rows=True,
            seg_order=(3, 2, 1, 0),
        )
        accel = r.accel
        assert len(accel.coarse.segments) == 4
        assert len(accel.fine.segments) == (13 if fine == 16 else 4)
        assert accel.fine.segments[0].attr is None and accel.coarse.segments[0].attr is not None
        r.render_frame()
        assert seen and {s[1] for s in seen} == {False, True}
        for tc, refine, rows, _, order in seen:
            if refine and not rows:
                assert tc == fine and order == fine_order
            else:
                assert tc == 64 and order == (3, 2, 1, 0)


def test_dual_tables_bit_equal_to_jax_and_convert(forced):
    """The port's dual tables (resident, and forced into segments) are
    the JAX package's, carried across by ``convert.dual_chunks``; so are
    the segment counts and ``prim_base``."""
    scene = torus_scene()
    jscene = rt_rs_tpu.Scene.from_json(scene.to_json())
    for mode, cap in (("segmented", FORCED_CAP), ("resident", 1536)):
        pt.MAX_VMEM_CHUNKS = jpt.MAX_VMEM_CHUNKS = cap
        ours, _ = PacketBvhIntrs(tri_chunk_fine=16).build(scene, scene.pack(device="cpu"))
        ref, _ = jax_get_handler("pbvh", tri_chunk_fine=16, interpret=True).build(jscene, jscene.pack())
        assert isinstance(ref, jpt.DualTriChunks)
        carried = convert.dual_chunks(ref, device="cpu")
        for table in ("coarse", "fine"):
            a, b = getattr(ours, table), getattr(carried, table)
            assert type(a) is type(b), (mode, table)
            if isinstance(a, pt.SegmentedTriChunks):
                assert a.prim_base == b.prim_base
                a, b = pt.flatten_segments(a), pt.flatten_segments(b)
            for f in ("comp", "bmin", "bmax"):
                assert torch.equal(getattr(a, f), getattr(b, f)), (mode, table, f)
            assert (a.attr is None) == (b.attr is None) == (table == "fine")
            if a.attr is not None:
                assert torch.equal(a.attr, b.attr)


def test_stats_count_both_tables_like_jax(forced):
    """A dual table's footprint adds the fine table's, rows table aside,
    in both packages (each counts its own layout: the port's compact
    components and [P + 1, 32] rows table, the JAX package's lane-padded
    components and [Nc, 32, 128] attribute table)."""
    scene = torus_scene()
    jscene = rt_rs_tpu.Scene.from_json(scene.to_json())

    def ours(**kw):
        h = PacketBvhIntrs(**kw)
        return h.stats(h.build(scene, scene.pack(device="cpu"))[0])

    def theirs(**kw):
        h = jax_get_handler("pbvh", interpret=True, **kw)
        return h.stats(h.build(jscene, jscene.pack())[0])

    nc16 = -(-(-(-scene.num_prims // 16)) // pt.CHUNK_ALIGN) * pt.CHUNK_ALIGN
    for cap in (FORCED_CAP, 1536):
        pt.MAX_VMEM_CHUNKS = jpt.MAX_VMEM_CHUNKS = cap
        s64, s16, dual = ours(), ours(tri_chunk=16), ours(tri_chunk_fine=16)
        j64, j16, jdual = theirs(), theirs(tri_chunk=16), theirs(tri_chunk_fine=16)
        assert dual.name == jdual.name == "Packet-BVH"
        assert dual.size - s64.size == s16.size - (nc16 * 16 + 1) * 32 * 4
        assert jdual.size - j64.size == j16.size - nc16 * 32 * jpt.LANES * 4


def _rays(n: int, seed: int, n_prims: int):
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3)) * 4.0
    o[:, 1] = np.abs(o[:, 1]) + 1.0
    d = rng.uniform(-2.0, 2.0, (n, 3)) - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    excl = np.where(rng.random(n) < 0.3, rng.integers(1, n_prims + 1, n), 0).astype(np.int32)
    valid = rng.random(n) > 0.1
    return o.astype(np.float32), d, excl, valid


def test_flat_segmented_entry(forced):
    """``packet_closest_hit_segmented`` equals ``tiled_as_flat`` over the
    segmented tiled entry in scene order, bit for bit on valid rays, and
    the JAX package's flat segmented entry; pbvh's flat entry takes it
    for a segmented table (and the coarse table of a dual one)."""
    scene = torus_scene()
    h = PacketBvhIntrs()
    seg, arrays = h.build(scene, scene.pack(device="cpu"))
    assert isinstance(seg, pt.SegmentedTriChunks) and len(seg.segments) == 4
    o, d, excl, valid = _rays(600, 3, scene.num_prims)
    args = [torch.from_numpy(x) for x in (o, d, excl, valid)]
    cap = torch.full((600,), 30.0)
    for t_cap in (None, cap):
        t, pid = pt.packet_closest_hit_segmented(seg, *args, t_cap, ray_tile=256, **KW)
        flat = tiled_as_flat(partial(pt.packet_closest_hit_segmented_tiled, seg, **KW), 256)
        ft, fpid = flat(*args, t_cap=t_cap)
        v = args[3]
        assert torch.equal(t[v], ft[v]) and torch.equal(pid[v], fpid[v])
        assert (pid[v] > 0).sum() > 100 and pid.dtype == torch.int32
    jseg = jpt.split_chunks(
        jpt.build_tri_chunks(
            arrays.pa.numpy(), arrays.pb.numpy(), arrays.pc.numpy(), max_chunks=None,
            tri_chunk=64, shade_rows=arrays.shade_table.numpy(),
        )
    )
    jt, jpid = jpt.packet_closest_hit_segmented(
        jseg, *(jnp.asarray(x) for x in (o, d, excl, valid)), ray_tile=256, interpret=True, **KW
    )
    t, pid = pt.packet_closest_hit_segmented(seg, *args, ray_tile=256, **KW)
    v = valid
    jt, jpid = np.asarray(jt)[v], np.asarray(jpid)[v]
    np.testing.assert_allclose(t.numpy()[v], jt, rtol=1e-5)
    assert (pid.numpy()[v] != jpid).mean() <= 1e-3
    cfg = Config().compute
    for accel in (seg, pt.DualTriChunks(coarse=seg, fine=seg)):
        fn = PacketBvhIntrs().intersect_fn(accel, arrays, cfg)
        assert fn.func is pt.packet_closest_hit_segmented and fn.args[0] is seg


def test_negative_material_dual_frames(forced):
    """The flat path on a dual table (coarse table, flat segmented
    entry) equals the single table's frame, resident and segmented."""
    ghost = torus_ghost()
    seg = frame(ghost)
    assert torch.equal(frame(ghost, tri_chunk_fine=16), seg)
    pt.MAX_VMEM_CHUNKS = 1536
    assert torch.equal(frame(ghost, tri_chunk_fine=16), seg)
    pt.MAX_VMEM_CHUNKS = FORCED_CAP


def test_dma_takes_no_fine_table(forced):
    scene = torus_scene()
    accel, _ = PacketBvhIntrs(tri_chunk_fine=16, streaming_mode="dma").build(
        scene, scene.pack(device="cpu")
    )
    assert isinstance(accel, pt.TriChunks) and accel.attr is None

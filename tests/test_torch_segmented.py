"""rt_rs_tpu_torch's segmented tables against the JAX package's.

Segmentation is forced as the JAX package's own tests force it
(tests/test_seg_order.py): ``MAX_VMEM_CHUNKS`` = 16 in both packages
shrinks the resident budget so ``torus_scene`` (6,322 triangles) splits
into 4 segments of 2,048.  ``torus_row(2)`` (12,642 triangles) splits
into 2 at the default caps.

Tolerances are those of tests/test_torch_packet_trace.py: segment
tables, bases, culls and compacted lists are built by the same IEEE
operations on both sides, so they are bit-equal; against the JAX
package's interpret-mode kernels ``t`` is held at rtol 1e-5 (XLA:CPU
contracts the Möller–Trumbore arithmetic into FMAs) and a pid may
differ only at a near-tie; rows are equal where pids are, blocked
verdicts are equal.  Against the port's own flat call on
``flatten_segments`` a segmented call is bit-equal on valid rays, in
every visit order: that is the test that the merge is right.
"""

from __future__ import annotations

import itertools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rt_rs_tpu
from rt_rs_tpu.handlers import get_handler as jax_get_handler
from rt_rs_tpu.ops.pallas import packet_trace as jpt
from rt_rs_tpu_torch import Config, ComputeConfig, Renderer, Resolution, convert
from rt_rs_tpu_torch.handlers.pbvh import PacketBvhIntrs
from rt_rs_tpu_torch.ops import packet_trace as pt
from rt_rs_tpu_torch.ops import shade
from rt_rs_tpu_torch.renderer import _segmented_parts
from rt_rs_tpu_torch.scene.presets import torus_row, torus_scene

# pytest-xdist runs several test processes at once; torch's default of
# one OpenMP thread per core in each of them oversubscribes the CPUs.
torch.set_num_threads(
    max(1, (os.cpu_count() or 1) // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))
)

T_MIN, T_MAX, EPS = 0.01, 1000.0, 1e-7
KW = dict(t_min=T_MIN, t_max=T_MAX, eps=EPS)
FORCED_CAP = 16  # MAX_VMEM_CHUNKS that splits torus_scene into 4 segments


def build_both(scene):
    """(port accel, JAX SegmentedTriChunks) of one scene: the port's
    pbvh build and the JAX package's split of the same reordered
    corners."""
    accel, arrays = PacketBvhIntrs().build(scene, scene.pack(device="cpu"))
    jc = jpt.build_tri_chunks(
        arrays.pa.numpy(), arrays.pb.numpy(), arrays.pc.numpy(),
        max_chunks=None, tri_chunk=64, shade_rows=arrays.shade_table.numpy(),
    )
    return accel, jpt.split_chunks(jc), arrays


@pytest.fixture(scope="module")
def forced():
    """torus_scene split under the forced cap in both packages."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pt, "MAX_VMEM_CHUNKS", FORCED_CAP)
        mp.setattr(jpt, "MAX_VMEM_CHUNKS", FORCED_CAP)
        scene = torus_scene()
        seg, jseg, arrays = build_both(scene)
    return seg, jseg, scene.num_prims


def test_forced_split_and_row2_byte_equal_to_jax():
    """Segment boundaries, prim bases and tables equal the JAX
    package's split, under the forced cap and for torus_row(2) at the
    default caps; the JAX package's own pbvh build agrees."""
    for cap, scene, n_seg in ((FORCED_CAP, torus_scene(), 4), (None, torus_row(2), 2)):
        with pytest.MonkeyPatch.context() as mp:
            if cap is not None:
                mp.setattr(pt, "MAX_VMEM_CHUNKS", cap)
                mp.setattr(jpt, "MAX_VMEM_CHUNKS", cap)
            seg, jseg, _ = build_both(scene)
            jscene = rt_rs_tpu.Scene.from_json(scene.to_json())
            jaccel, _ = jax_get_handler("pbvh").build(jscene, jscene.pack())
        assert isinstance(seg, pt.SegmentedTriChunks) and len(seg.segments) == n_seg
        assert seg.prim_base == jseg.prim_base == jaccel.prim_base
        theirs = convert.segmented_chunks(jaccel, device="cpu")
        assert theirs.prim_base == seg.prim_base
        for ours, ref in zip(seg.segments, theirs.segments, strict=True):
            assert ours.num_chunks == ref.num_chunks
            for f in ("comp", "bmin", "bmax"):
                assert getattr(ours, f).numpy().tobytes() == getattr(ref, f).numpy().tobytes(), f
        # One rows table, shared by every segment, equal to the JAX
        # package's per-segment slices laid end to end.
        assert all(s.attr is seg.segments[0].attr for s in seg.segments)
        assert seg.segments[0].attr.numpy().tobytes() == theirs.segments[0].attr.numpy().tobytes()
        flat = pt.flatten_segments(seg)
        assert flat.num_chunks == seg.num_chunks
        assert pt.flatten_segments(seg, pad_multiple=7).num_chunks % 7 == 0


def test_segmented_chunks_checks_prim_base(forced):
    _, jseg, _ = forced
    bad = jpt.SegmentedTriChunks(segments=jseg.segments, prim_base=(0,) * len(jseg.segments))
    with pytest.raises(ValueError, match="prim_base"):
        convert.segmented_chunks(bad, device="cpu")


def _payload(case: str, n_prims: int):
    """Primary rays at 64x48, or divergent bounce / shadow-like rays
    (tests/test_torch_packet_trace.py's cases) -> numpy payload, valid,
    cap."""
    if case == "primary":
        scene = torus_scene()
        payload, valid, _ = shade.camera_ray_tiles(
            torch.tensor(scene.camera.pos, dtype=torch.float32),
            torch.tensor(scene.camera.at, dtype=torch.float32),
            64, 48, 256, block=(16, 16),
        )
        return payload.numpy(), valid.numpy(), None
    rng = np.random.default_rng({"bounce": 1, "shadow": 2}[case])
    t_tiles, r = 32, 256
    o = rng.uniform(-3.5, 3.5, (3, t_tiles, r))
    d = rng.normal(size=(3, t_tiles, r))
    d[rng.random((3, t_tiles, r)) < 0.05] = 0.0
    d /= np.maximum(np.linalg.norm(d, axis=0, keepdims=True), 1e-6)
    excl = rng.integers(0, n_prims + 1, (1, t_tiles, r))
    cap = rng.uniform(0.2, 12.0, (1, t_tiles, r))
    with_cap = case == "shadow"
    payload = np.concatenate([o, d, excl, cap if with_cap else 0 * cap]).astype(np.float32)
    valid = rng.random((t_tiles, r)) < 0.7
    valid[3] = False  # a whole dead tile
    return payload, valid, (cap[0].astype(np.float32) if with_cap else None)


# mode -> (ray case, per-ray refine cull)
MODES = {"closest": ("primary", False), "rows": ("bounce", True), "anyhit": ("shadow", True)}


def _call(fn, chunks, mode, payload, valid, cap, **kw):
    case, refine = MODES[mode]
    flags = dict(emit_rows=mode == "rows", any_hit=mode == "anyhit")
    return fn(chunks, payload, valid, cap, refine=refine, **flags, **KW, **kw)


def _t(x):
    return None if x is None else torch.from_numpy(np.asarray(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


@pytest.mark.parametrize("chain", [True, False])
@pytest.mark.parametrize("order", ["scene", "reversed"])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_segmented_twin_matches_jax(forced, mode, order, chain):
    seg, jseg, n = forced
    payload, valid, cap = _payload(MODES[mode][0], n)
    so = None if order == "scene" else tuple(reversed(range(len(seg.segments))))
    kw = dict(chain=chain, seg_order=so)
    ours = _call(pt.packet_closest_hit_segmented_tiled, seg, mode, _t(payload), _t(valid), _t(cap), **kw)
    ref = _call(
        jpt.packet_closest_hit_segmented_tiled, jseg, mode, _j(payload), _j(valid), _j(cap),
        interpret=True, **kw,
    )
    if mode == "anyhit":
        np.testing.assert_array_equal(ours.numpy()[valid], np.asarray(ref)[valid])
        assert 0.05 < ours.numpy()[valid].mean() < 0.95  # both outcomes occur
        return
    t, pid, jt, jpid = ours[0].numpy()[valid], ours[1].numpy()[valid], np.asarray(ref[0])[valid], np.asarray(ref[1])[valid]
    np.testing.assert_allclose(t, jt, rtol=1e-5)
    diff = pid != jpid
    assert diff.mean() <= 1e-3, f"{diff.sum()} pids differ"
    assert (np.abs(t[diff] - jt[diff]) <= 1e-5 * np.abs(jt[diff])).all()
    assert 0.05 < (pid != 0).mean()  # the case really hits geometry
    if mode == "rows":
        rows, jrows = ours[2].numpy()[:, valid], np.asarray(ref[2])[:, valid]
        np.testing.assert_array_equal(rows[:, ~diff], jrows[:, ~diff])
        np.testing.assert_array_equal(rows.T, seg.segments[0].attr.numpy()[pid])


@pytest.mark.parametrize("mode", sorted(MODES))
def test_segmented_bit_equal_to_flat_in_every_order(forced, mode):
    """Every permutation of the 4 segments, chained and not, gives the
    flat call's outputs bit for bit on valid rays."""
    seg, _, n = forced
    payload, valid, cap = _payload(MODES[mode][0], n)
    # 64 of each tile's rays keep the 48 x 4 calls quick.
    payload, valid = _t(payload[:, :, :64]), _t(valid[:, :64])
    cap = None if cap is None else _t(cap[:, :64])
    flat = _call(pt.packet_closest_hit_tiled, pt.flatten_segments(seg), mode, payload, valid, cap)
    flat = flat if isinstance(flat, tuple) else (flat,)
    orders = list(itertools.permutations(range(len(seg.segments))))
    assert len(orders) == 24
    for i, order in enumerate(orders):
        chain = i % 2 == 0
        out = _call(
            pt.packet_closest_hit_segmented_tiled, seg, mode, payload, valid, cap,
            chain=chain, seg_order=order,
        )
        out = out if isinstance(out, tuple) else (out,)
        for a, b in zip(out, flat, strict=True):
            assert torch.equal(a[..., valid], b[..., valid]), (order, chain)


def test_segmented_entry_checks(forced):
    seg, _, n = forced
    payload, valid, _ = (_t(x) for x in _payload("primary", n))
    with pytest.raises(ValueError, match="permutation"):
        pt.packet_closest_hit_segmented_tiled(seg, payload, valid, seg_order=(0, 0, 1, 2), **KW)
    with pytest.raises(ValueError, match="mutually exclusive"):
        pt.packet_closest_hit_segmented_tiled(seg, payload, valid, emit_rows=True, any_hit=True, **KW)
    last = seg.segments[-1]
    huge = pt.SegmentedTriChunks(segments=(last,), prim_base=((1 << 24) - 64,))
    with pytest.raises(ValueError, match="2\\^24"):
        pt.packet_closest_hit_segmented_tiled(huge, payload, valid, **KW)
    # The f32 prim-id guard covers the base.
    with pytest.raises(ValueError, match="2\\^24"):
        pt.packet_closest_hit_tiled(last, payload, valid, pid_base=1 << 24, **KW)


def test_chunk_overlap_mask_ray_major_bit_equal(forced):
    """The streaming path's ray-major interval cull equals the JAX
    package's eager one bit for bit."""
    seg, jseg, n = forced
    payload, valid, cap = _payload("shadow", n)
    flat, jflat = pt.flatten_segments(seg), jpt.flatten_segments(jseg)
    o = payload[0:3].transpose(1, 2, 0)
    with np.errstate(divide="ignore"):  # zero direction components -> inf
        inv = 1.0 / payload[3:6].transpose(1, 2, 0)
    ours = pt.chunk_overlap_mask(
        _t(o), _t(inv), _t(valid), flat.bmin, flat.bmax, t_min=T_MIN, t_max=T_MAX, t_cap=_t(cap)
    )
    ref = jpt.chunk_overlap_mask(
        _j(o), _j(inv), _j(valid), jflat.bmin, jflat.bmax, t_min=T_MIN, t_max=T_MAX, t_cap=_j(cap)
    )
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    assert 0 < int(ours.sum()) < ours.numel()


def _renderer(monkeypatch, **kw):
    monkeypatch.setattr(pt, "MAX_VMEM_CHUNKS", FORCED_CAP)
    cfg = Config(compute=ComputeConfig(bounces=2), resolution=Resolution.sized(32, 16))
    return Renderer(torus_scene(), config=cfg, handler="pbvh", device="cpu", **kw)


def test_renderer_seg_order_modes(monkeypatch):
    """``auto`` picks a camera-front-to-back permutation that flips with
    the camera and is cached per order; a tuple pins one; resident
    tables ignore the knob; a bad value raises."""
    r = _renderer(monkeypatch)
    n = len(_segmented_parts(r.accel))
    o1 = r._frame_handler().seg_order
    assert sorted(o1) == list(range(n))
    assert r._frame_handler() is r._frame_handler()
    pos = np.asarray(r.camera.pos, np.float64)
    mid = r._seg_centers.mean(0)
    r.camera = type(r.camera)(tuple(2 * mid - pos), tuple(r.camera.at))
    o2 = r._frame_handler().seg_order
    assert sorted(o2) == sorted(o1) and o1 != o2
    fixed = _renderer(monkeypatch, seg_order=(3, 2, 1, 0))
    assert fixed._frame_handler().seg_order == (3, 2, 1, 0)
    assert _renderer(monkeypatch, seg_order="scene")._frame_handler() is not None
    with pytest.raises(ValueError, match="seg_order"):
        _renderer(monkeypatch, seg_order="nearest")
    monkeypatch.setattr(pt, "MAX_VMEM_CHUNKS", 1536)
    resident = Renderer(torus_scene(), config=Config(resolution=Resolution.sized(16, 16)), handler="pbvh", device="cpu")
    assert resident.seg_order == "scene" and resident._frame_handler() is resident.handler


def test_segmented_handler_entries_and_stats(monkeypatch):
    """Segmented tables take the gather branch by default and offer rows
    and any-hit entries; the rows table is counted once."""
    r = _renderer(monkeypatch)
    h = r.handler
    assert not h.rows_default(r.accel, 512)
    cfg = r.config.compute
    assert h.intersect_tiled_rows_fn(r.accel, r.arrays, cfg) is not None
    assert h.intersect_tiled_anyhit_fn(r.accel, r.arrays, cfg) is not None
    _, rows_fn, anyhit_fn = r._bound(r._frame_handler())
    assert rows_fn is None and anyhit_fn is None
    segs = r.accel.segments
    size = sum(s.comp.nbytes + s.bmin.nbytes + s.bmax.nbytes for s in segs) + segs[0].attr.nbytes
    assert r.stats.size == size
    # The flat-ray entry (the JAX package's packet_closest_hit layout)
    # equals the tiled entry.
    payload, valid, _ = _payload("bounce", 6322)
    p, v = _t(payload), _t(valid)
    t, pid = h.intersect_tiled_fn(r.accel, r.arrays, cfg)(p, v)
    o = p[0:3].permute(1, 2, 0).reshape(-1, 3)
    d = p[3:6].permute(1, 2, 0).reshape(-1, 3)
    excl = p[6].reshape(-1).to(torch.int32)
    ft, fpid = h.intersect_fn(r.accel, r.arrays, cfg)(o[:5000], d[:5000], excl[:5000], v.reshape(-1)[:5000])
    vv = v.reshape(-1)[:5000]
    assert torch.equal(ft[vv], t.reshape(-1)[:5000][vv])
    assert torch.equal(fpid[vv], pid.reshape(-1)[:5000][vv])

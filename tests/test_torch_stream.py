"""rt_rs_tpu_torch's streamed tables (``streaming_mode="dma"``) against
the JAX package's.

Two inputs: the 300-triangle soup of tests/test_stream.py (8-triangle
chunks, so 32 chunks per block and the int32 word's bit 31 in use), and
``torus_scene`` routed to the streamed table by forcing
``MAX_VMEM_CHUNKS`` = 16 in both packages (64-triangle chunks, 8 per
block).  The host half (interval cull, block words, block lists and
counts) is bit-equal to eager JAX.  Kernel E's twin is held to the JAX
package's interpret-mode kernel with the tolerances of
tests/test_torch_packet_trace.py (t rtol 1e-5, pids equal except
near-ties), and to the port's flat closest hit bit for bit on valid
rays (both are exact).  Frames are held at atol 2e-5.
"""

from __future__ import annotations

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rt_rs_tpu
from rt_rs_tpu.ops.pallas import packet_stream as jps
from rt_rs_tpu.ops.pallas import packet_trace as jpt
from rt_rs_tpu_torch import Config, ComputeConfig, Renderer, Resolution, convert
from rt_rs_tpu_torch.handlers import get_handler
from rt_rs_tpu_torch.ops import packet_stream as ps
from rt_rs_tpu_torch.ops import packet_trace as pt
from rt_rs_tpu_torch.scene.presets import torus_scene

# pytest-xdist runs several test processes at once; torch's default of
# one OpenMP thread per core in each of them oversubscribes the CPUs.
torch.set_num_threads(
    max(1, (os.cpu_count() or 1) // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))
)

T_MIN, T_MAX, EPS = 0.01, 1000.0, 1e-7
KW = dict(t_min=T_MIN, t_max=T_MAX, eps=EPS)
FORCED_CAP = 16


def soup_case():
    """tests/test_stream.py:38-61: 300 random triangles, 96 rays."""
    rng = np.random.default_rng(50)
    n_tris = 300
    scene = rt_rs_tpu.Scene.empty()
    scene.vert_pos = rng.normal(size=(n_tris * 3, 3), scale=5.0).astype(np.float32)
    scene.vert_norm = np.tile(np.array([[0, 1, 0]], np.float32), (n_tris * 3, 1))
    scene.prim_indices = np.arange(n_tris * 3, dtype=np.uint32).reshape(-1, 3)
    scene.prim_material = np.zeros(n_tris, dtype=np.int32)
    scene.mat_color = np.array([[1.0, 1.0, 1.0]], np.float32)
    scene.mat_albedo = np.array([[1.0, 0.0, 0.0]], np.float32)
    scene.mat_spec = np.array([1.0], np.float32)
    arrays = scene.pack()
    jc = jpt.build_tri_chunks(arrays.pa, arrays.pb, arrays.pc, max_chunks=None)
    o = rng.normal(size=(96, 3), scale=8.0).astype(np.float32)
    d = rng.normal(size=(96, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return jc, o, d, np.zeros(96, np.int32), np.ones(96, bool), None


def torus_case():
    """torus_scene on the streamed table (forced cap), 8,192 divergent
    bounce-like rays: 70% valid, random exclusions, per-ray caps."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pt, "MAX_VMEM_CHUNKS", FORCED_CAP)
        scene = torus_scene()
        accel, arrays = get_handler("pbvh", streaming_mode="dma").build(
            scene, scene.pack(device="cpu")
        )
    assert isinstance(accel, pt.TriChunks) and accel.attr is None
    jc = jpt.build_tri_chunks(
        arrays.pa.numpy(), arrays.pb.numpy(), arrays.pc.numpy(), max_chunks=None, tri_chunk=64
    )
    rng = np.random.default_rng(7)
    n = 8192
    o = rng.uniform(-3.5, 3.5, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d[rng.random((n, 3)) < 0.05] = 0.0
    d = (d / np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-6)).astype(np.float32)
    excl = rng.integers(0, scene.num_prims + 1, n).astype(np.int32)
    valid = rng.random(n) < 0.7
    cap = rng.uniform(0.2, 12.0, n).astype(np.float32)
    return jc, o, d, excl, valid, cap


CASES = {"soup": soup_case, "torus": torus_case}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    jc, o, d, excl, valid, cap = CASES[request.param]()
    ours = convert.tri_chunks(jc.comp, jc.bmin, jc.bmax, jc.num_chunks, device="cpu")
    return request.param, ours, jc, (o, d, excl, valid, cap)


def _t(x):
    return None if x is None else torch.from_numpy(np.asarray(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


def jax_block_lists(jc, o, d, valid, cap):
    """stream_closest_hit's host half (packet_stream.py:198-255), run
    eagerly."""
    n, nc, tc = o.shape[0], jc.num_chunks, int(jc.comp.shape[1])
    cpb = min(32, max(1, jps.BLOCK_SUBLANES // tc))
    nb = -(-nc // cpb)
    t_tiles = max(1, -(-n // jpt.RAY_TILE))
    t_groups = -(-t_tiles // jpt.TILE_GROUP)
    t_tiles = t_groups * jpt.TILE_GROUP
    n_pad = t_tiles * jpt.RAY_TILE
    o_p = jnp.pad(_j(o), ((0, n_pad - n), (0, 0))).reshape(t_tiles, jpt.RAY_TILE, 3)
    d_p = jnp.pad(_j(d), ((0, n_pad - n), (0, 0))).reshape(t_tiles, jpt.RAY_TILE, 3)
    valid_p = jnp.pad(_j(valid), (0, n_pad - n)).reshape(t_tiles, jpt.RAY_TILE)
    cap_p = None if cap is None else jnp.pad(_j(cap), (0, n_pad - n)).reshape(t_tiles, jpt.RAY_TILE)
    overlap = jpt.chunk_overlap_mask(
        o_p, 1.0 / d_p, valid_p, jc.bmin, jc.bmax, t_min=T_MIN, t_max=T_MAX, t_cap=cap_p
    )
    bits = jnp.pad(overlap, ((0, 0), (0, nb * cpb - nc))).astype(jnp.int32)
    weights = jnp.int32(1) << jnp.arange(cpb, dtype=jnp.int32)
    words = jnp.sum(bits.reshape(t_tiles, nb, cpb) * weights[None, None, :], axis=-1, dtype=jnp.int32)
    block_any = jnp.any(words.reshape(t_groups, jpt.TILE_GROUP, nb) != 0, axis=1)
    order = jnp.argsort(~block_any, axis=1, stable=True).astype(jnp.int32)
    counts = jnp.sum(block_any, axis=1, dtype=jnp.int32)
    return words, order, counts


def test_block_lists_bit_equal_to_jax(case):
    name, ours, jc, (o, d, excl, valid, cap) = case
    s = ps.stream_inputs(ours, _t(o), _t(d), _t(excl), _t(valid), _t(cap), t_min=T_MIN, t_max=T_MAX)
    words, order, counts = jax_block_lists(jc, o, d, valid, cap)
    np.testing.assert_array_equal(s.words.numpy(), np.asarray(words))
    np.testing.assert_array_equal(s.blockids.numpy(), np.asarray(order))
    np.testing.assert_array_equal(s.counts.numpy(), np.asarray(counts))
    assert s.payload.shape[1] % 32 == 0 and s.payload.shape[2] == ps.STREAM_LANES
    assert int(s.counts.max()) > 0
    if name == "soup":  # 32 chunks per block: the sign bit is in use
        assert ps.chunks_per_block(ours.tri_chunk) == 32 and (s.words < 0).any()


def test_stream_twin_matches_jax_kernel(case):
    name, ours, jc, (o, d, excl, valid, cap) = case
    t, pid = ps.stream_closest_hit(ours, _t(o), _t(d), _t(excl), _t(valid), _t(cap), **KW)
    jt, jpid = jps.stream_closest_hit(
        jc, _j(o), _j(d), _j(excl), _j(valid), _j(cap), interpret=True, **KW
    )
    t, pid, jt, jpid = t.numpy()[valid], pid.numpy()[valid], np.asarray(jt)[valid], np.asarray(jpid)[valid]
    np.testing.assert_allclose(t, jt, rtol=1e-5)
    diff = pid != jpid
    assert diff.mean() <= 1e-3, f"{diff.sum()} pids differ"
    assert (np.abs(t[diff] - jt[diff]) <= 1e-5 * np.abs(jt[diff])).all()
    assert 0.05 < (pid != 0).mean()
    assert (t[pid == 0] == np.float32(T_MAX + 1.0)).all()


def test_stream_equals_flat_closest_hit(case):
    """Kernel E's twin and the flat closest hit (kernel B's twin) on the
    same 128-ray tiles with the same interval cull test the same chunks
    of each tile: equal bit for bit on valid rays.  (A ``t_cap`` only
    narrows the cull, so hits beyond a ray's cap may differ between
    culls; the same cull makes them equal too.)"""
    name, ours, jc, (o, d, excl, valid, cap) = case
    s = ps.stream_inputs(ours, _t(o), _t(d), _t(excl), _t(valid), _t(cap), t_min=T_MIN, t_max=T_MAX)
    t, pid = ps.mt_stream(s.payload, s.table, s.words, s.blockids, s.counts, **KW)
    v = s.payload[7] > 0
    cap_t = None if cap is None else torch.cat([_t(cap), torch.zeros(v.numel() - len(cap))]).reshape(v.shape)
    ft, fpid = pt.packet_closest_hit_tiled(ours, s.payload, v, cap_t, refine=False, **KW)
    assert torch.equal(t[v], ft[v]) and torch.equal(pid[v], fpid[v])


def test_stream_checks_and_dma_handler():
    jc, o, d, excl, valid, cap = soup_case()
    ours = convert.tri_chunks(jc.comp, jc.bmin, jc.bmax, jc.num_chunks, device="cpu")
    huge = pt.TriChunks(
        torch.zeros(1, 64, 9).expand(1 << 18, 64, 9), ours.bmin, ours.bmax, 1 << 18
    )
    with pytest.raises(ValueError, match="2\\^24"):
        ps.stream_closest_hit(huge, _t(o), _t(d), _t(excl), **KW)
    assert [ps.chunks_per_block(tc) for tc in (8, 16, 64, 100)] == [32, 32, 8, 5]
    h = get_handler("pbvh", streaming_mode="dma")
    assert h.block_lanes == 128
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pt, "MAX_VMEM_CHUNKS", FORCED_CAP)
        scene = torus_scene()
        r = Renderer(scene, config=Config(resolution=Resolution.sized(16, 16)), handler=h, device="cpu")
        cfg = r.config.compute
        assert h.intersect_tiled_rows_fn(r.accel, r.arrays, cfg) is None
        assert h.intersect_tiled_anyhit_fn(r.accel, r.arrays, cfg) is None
        assert not hasattr(h.intersect_tiled_fn(r.accel, r.arrays, cfg), "supports_refine")
    assert r.block == (8, 16) and r.stats.size == sum(
        t.nbytes for t in (r.accel.comp, r.accel.bmin, r.accel.bmax)
    )
    with pytest.raises(ValueError, match="streaming_mode"):
        get_handler("pbvh", streaming_mode="hbm")


def test_dma_frame_matches_jax(monkeypatch):
    """torus_scene forced onto the streamed table: the port's frame (128-ray
    tiles, gather branch, kernel E's twin) against the JAX package's."""
    monkeypatch.setattr(pt, "MAX_VMEM_CHUNKS", FORCED_CAP)
    monkeypatch.setattr(jpt, "MAX_VMEM_CHUNKS", FORCED_CAP)
    scene = torus_scene()
    kw = dict(handler="pbvh", handler_kwargs={"streaming_mode": "dma"})
    cfg = Config(compute=ComputeConfig(bounces=2), resolution=Resolution.sized(32, 16))
    ours = Renderer(scene, config=cfg, device="cpu", **kw)
    assert isinstance(ours.accel, pt.TriChunks) and ours.block == (8, 16)
    frame = ours.render_frame().numpy()
    jr = rt_rs_tpu.Renderer(
        rt_rs_tpu.Scene.from_json(scene.to_json()),
        config=rt_rs_tpu.Config(
            compute=rt_rs_tpu.ComputeConfig(bounces=2),
            resolution=rt_rs_tpu.Resolution.sized(32, 16),
        ),
        **kw,
    )
    ref = np.asarray(jr.render_frame())
    assert np.isfinite(frame).all() and frame.mean() > 0.05
    np.testing.assert_allclose(frame, ref, rtol=0, atol=2e-5)

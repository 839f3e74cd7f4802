"""rt_rs_tpu_torch's packet trace against the JAX package's.

Both packages get the same chunk table (built from the same reordered
corners; byte-equality is test_torch_scene's) and the same ray payloads
(numpy, from a seed).  The JAX side runs eagerly for its XLA glue and in
interpret mode for its Pallas kernels, as its own tests run them.

Tolerances: the culls and the compaction are comparisons of IEEE
subtractions, products and quotients, so they must be bit-equal.  The
Möller–Trumbore hit distance is not: XLA:CPU fuses and contracts the
interpret-mode kernel's arithmetic, which moved JAX's ``w`` by up to
2.6e-6 relative against the same ops rounded one by one (measured on
random inputs), so ``t`` is held at rtol 1e-5 and a pid may differ only
at a near-tie (both candidates within 1e-5 relative; at most 0.1% of
the rays).
"""

from __future__ import annotations

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rt_rs_tpu.ops.pallas import packet_trace as jpt
from rt_rs_tpu_torch.handlers.pbvh import PacketBvhIntrs
from rt_rs_tpu_torch.ops import cuda, shade
from rt_rs_tpu_torch.ops import packet_trace as pt
from rt_rs_tpu_torch.scene.presets import torus_scene

# pytest-xdist runs several test processes at once; torch's default of
# one OpenMP thread per core in each of them oversubscribes the CPUs,
# and the spinning threads slowed these tests about tenfold.
torch.set_num_threads(
    max(1, (os.cpu_count() or 1) // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))
)

T_MIN, T_MAX, EPS = 0.01, 1000.0, 1e-7
KW = dict(t_min=T_MIN, t_max=T_MAX, eps=EPS)


@pytest.fixture(scope="module")
def tables():
    """(port TriChunks, JAX TriChunks, n_prims) for torus_scene."""
    scene = torus_scene()
    chunks, arrays = PacketBvhIntrs().build(scene, scene.pack(device="cpu"))
    corners = [arrays.pa.numpy(), arrays.pb.numpy(), arrays.pc.numpy()]
    jc = jpt.build_tri_chunks(
        *corners, max_chunks=None, tri_chunk=64,
        shade_rows=arrays.shade_table.numpy(),
    )
    return chunks, jc, scene.num_prims


def primary_payload():
    """64x48 camera rays: [8, 32, 256] payload, valid [32, 256]."""
    scene = torus_scene()
    payload, valid, _ = shade.camera_ray_tiles(
        torch.tensor(scene.camera.pos, dtype=torch.float32),
        torch.tensor(scene.camera.at, dtype=torch.float32),
        64, 48, 256, block=(16, 16),
    )
    return payload.numpy(), valid.numpy(), None


def scattered_payload(seed: int, n_prims: int, with_cap: bool):
    """Divergent rays (bounce / shadow-like): origins around the torus,
    random directions (some components exactly 0), 70% valid, random
    exclusion ids and, for shadow-like batches, per-ray caps in row 7."""
    rng = np.random.default_rng(seed)
    t_tiles, r = 32, 256
    o = rng.uniform(-3.5, 3.5, (3, t_tiles, r))
    d = rng.normal(size=(3, t_tiles, r))
    d[rng.random((3, t_tiles, r)) < 0.05] = 0.0
    d /= np.maximum(np.linalg.norm(d, axis=0, keepdims=True), 1e-6)
    excl = rng.integers(0, n_prims + 1, (1, t_tiles, r))
    cap = rng.uniform(0.2, 12.0, (1, t_tiles, r))
    payload = np.concatenate([o, d, excl, cap if with_cap else 0 * cap]).astype(np.float32)
    valid = rng.random((t_tiles, r)) < 0.7
    valid[3] = False  # a whole dead tile
    return payload, valid, (cap[0].astype(np.float32) if with_cap else None)


CASES = {
    "primary": lambda n: primary_payload(),
    "bounce": lambda n: scattered_payload(1, n, with_cap=False),
    "shadow": lambda n: scattered_payload(2, n, with_cap=True),
}


def _t(x):
    return None if x is None else torch.from_numpy(np.asarray(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


@pytest.mark.parametrize("case", sorted(CASES))
def test_interval_cull_and_compaction_bit_equal(tables, case):
    chunks, jc, n = tables
    payload, valid, cap = CASES[case](n)
    ours = pt.chunk_overlap_mask_cm(
        _t(payload[0:3]), 1.0 / _t(payload[3:6]), _t(valid), chunks.bmin, chunks.bmax,
        t_min=T_MIN, t_max=T_MAX, t_cap=_t(cap),
    )
    ref = jpt.chunk_overlap_mask_cm(
        _j(payload[0:3]), 1.0 / _j(payload[3:6]), _j(valid), jc.bmin, jc.bmax,
        t_min=T_MIN, t_max=T_MAX, t_cap=_j(cap),
    )
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    ids, counts = pt.compact(ours)
    jids = jnp.argsort(~ref, axis=1, stable=True).astype(jnp.int32)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jnp.sum(ref, axis=1, dtype=jnp.int32)))
    assert ours[~torch.from_numpy(valid).any(dim=1)].sum() == 0


@pytest.mark.parametrize("case", sorted(CASES))
def test_refine_twin_matches_jax_kernel(tables, case):
    chunks, jc, n = tables
    payload, valid, cap = CASES[case](n)
    ours = pt.chunk_overlap_mask_perray(
        _t(payload), _t(valid), chunks.bmin, chunks.bmax,
        t_min=T_MIN, t_max=T_MAX, t_cap=_t(cap),
    )
    ref = jpt._perray_overlap_kernel_call(
        _j(payload), _j(valid), jc.bmin, jc.bmax,
        t_min=T_MIN, t_max=T_MAX, t_cap=_j(cap), interpret=True,
    )
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    xla = jpt.chunk_overlap_mask_perray_cm(
        _j(payload[0:3]), 1.0 / _j(payload[3:6]), _j(valid), jc.bmin, jc.bmax,
        t_min=T_MIN, t_max=T_MAX, t_cap=_j(cap),
    )
    np.testing.assert_array_equal(ours.numpy(), np.asarray(xla))
    # The per-ray cull is never looser than the tile-interval cull.
    interval = pt.chunk_overlap_mask_cm(
        _t(payload[0:3]), 1.0 / _t(payload[3:6]), _t(valid), chunks.bmin, chunks.bmax,
        t_min=T_MIN, t_max=T_MAX, t_cap=_t(cap),
    )
    assert not (ours & ~interval).any()


def assert_hits_match(t, pid, jt, jpid, valid):
    t, pid, jt, jpid = t[valid], pid[valid], jt[valid], jpid[valid]
    np.testing.assert_allclose(t, jt, rtol=1e-5)
    diff = pid != jpid
    assert diff.mean() <= 1e-3, f"{diff.sum()} pids differ"
    # A differing pid is a near-tie: both candidates hit at (nearly) t.
    assert (np.abs(t[diff] - jt[diff]) <= 1e-5 * np.abs(jt[diff])).all()
    return ~diff


@pytest.mark.parametrize(
    "case,mode",
    [("primary", "closest"), ("primary", "rows"), ("bounce", "rows"), ("shadow", "anyhit")],
)
def test_mt_twin_matches_jax_kernel(tables, case, mode):
    chunks, jc, n = tables
    payload, valid, cap = CASES[case](n)
    refine = case != "primary"
    flags = dict(emit_rows=mode == "rows", any_hit=mode == "anyhit")
    ours = pt.packet_closest_hit_tiled(
        chunks, _t(payload), _t(valid), _t(cap), refine=refine, **flags, **KW
    )
    ref = jpt.packet_closest_hit_tiled(
        jc, _j(payload), _j(valid), _j(cap), refine=refine, interpret=True,
        **flags, **KW,
    )
    if mode == "anyhit":
        np.testing.assert_array_equal(ours.numpy()[valid], np.asarray(ref)[valid])
        assert 0.05 < ours.numpy()[valid].mean() < 0.95  # both outcomes occur
        return
    same = assert_hits_match(
        ours[0].numpy(), ours[1].numpy(), np.asarray(ref[0]), np.asarray(ref[1]), valid
    )
    hits = ours[1].numpy()[valid] != 0
    assert 0.05 < hits.mean()  # the case really hits geometry
    if mode == "rows":
        rows, jrows = ours[2].numpy()[:, valid], np.asarray(ref[2])[:, valid]
        np.testing.assert_array_equal(rows[:, same], jrows[:, same])
        # The rows are the winners' shade rows, zeros on a miss.
        table = chunks.attr.numpy()
        np.testing.assert_array_equal(rows.T, table[ours[1].numpy()[valid]])


def test_mt_kernel_twin_modes_agree(tables):
    """any-hit == (closest hit below the cap); rows mode's (t, pid) ==
    closest mode's."""
    chunks, _, n = tables
    payload, valid, cap = CASES["shadow"](n)
    args = (chunks, _t(payload), _t(valid), _t(cap))
    t, pid = pt.packet_closest_hit_tiled(*args, **KW)
    t2, pid2, _ = pt.packet_closest_hit_tiled(*args, emit_rows=True, **KW)
    blocked = pt.packet_closest_hit_tiled(*args, any_hit=True, **KW)
    assert torch.equal(t, t2) and torch.equal(pid, pid2)
    v = torch.from_numpy(valid)
    closest_blocked = (pid != 0) & (t < torch.from_numpy(payload[7]))
    assert torch.equal(blocked[v], closest_blocked[v])
    miss = pid == 0
    assert (t[miss] == np.float32(T_MAX + 1.0)).all()


def test_mt_twin_matches_bruteforce(tables):
    """Closest hit over every triangle (no cull) == the culled trace:
    the culls are conservative."""
    chunks, _, n = tables
    payload, valid, _ = CASES["bounce"](n)
    p = _t(payload)
    t, pid = pt.packet_closest_hit_tiled(chunks, p, _t(valid), refine=True, **KW)
    nc = chunks.num_chunks
    all_ids = torch.arange(nc, dtype=torch.int32).expand(p.shape[1], nc).contiguous()
    counts = torch.full((p.shape[1],), nc, dtype=torch.int32)
    bt, bpid = pt.mt_trace_reference(chunks.comp, p, all_ids, counts, mode="closest", **KW)
    v = torch.from_numpy(valid)
    assert torch.equal(t[v], bt[v]) and torch.equal(pid[v], bpid[v])


def test_entry_checks(tables):
    chunks, _, _ = tables
    payload, valid, _ = primary_payload()
    p, v = _t(payload), _t(valid)
    with pytest.raises(ValueError, match="mutually exclusive"):
        pt.packet_closest_hit_tiled(chunks, p, v, emit_rows=True, any_hit=True, **KW)
    with pytest.raises(ValueError, match="multiple of 32"):
        pt.packet_closest_hit_tiled(chunks, p[:, :31], v[:31], **KW)
    no_rows = pt.TriChunks(chunks.comp, chunks.bmin, chunks.bmax, chunks.num_chunks)
    with pytest.raises(ValueError, match="shade_rows"):
        pt.packet_closest_hit_tiled(no_rows, p, v, emit_rows=True, **KW)
    huge = pt.TriChunks(
        torch.zeros(1, 64, 9).expand(1 << 18, 64, 9), chunks.bmin, chunks.bmax, 1 << 18
    )
    with pytest.raises(ValueError, match="2\\^24"):
        pt.packet_closest_hit_tiled(huge, p, v, **KW)
    with pytest.raises(ValueError, match="unknown mode"):
        pt.mt_trace(chunks.comp, p, None, None, mode="nearest", **KW)


def test_tag_refine_and_compact_order():
    fn = pt.tag_refine(lambda **kw: kw, "bounces")
    assert fn.supports_refine and fn() == {}
    assert pt.tag_refine(lambda **kw: kw, "all")() == {"refine": True}
    assert not pt.tag_refine(lambda **kw: kw, "off").supports_refine
    with pytest.raises(ValueError):
        pt.tag_refine(lambda: 0, "sometimes")
    mask = torch.tensor([[False, True, False, True, True], [False] * 5])
    ids, counts = pt.compact(mask)
    assert ids.dtype == torch.int32 and counts.tolist() == [3, 0]
    assert ids[0].tolist() == [1, 3, 4, 0, 2] and ids[1].tolist() == [0, 1, 2, 3, 4]


def test_kernel_argument_checks():
    dev = torch.device("cpu")
    x = torch.zeros(4, 8)
    cuda.check("x", x, torch.float32, (4, 8), dev)
    with pytest.raises(TypeError, match="dtype"):
        cuda.check("x", x, torch.int32, (4, 8), dev)
    with pytest.raises(ValueError, match="shape"):
        cuda.check("x", x, torch.float32, (8, 4), dev)
    with pytest.raises(ValueError, match="contiguous"):
        cuda.check("x", x.T, torch.float32, (8, 4), dev)
    key = cuda.build_key()
    assert key == cuda.build_key() and len(key) == 16
    assert {s.name for s in cuda.sources()} >= {
        "refine_cull.cu", "mt_trace.cu", "shade_pre.cu", "shade_post.cu", "common.cuh",
    }
    assert "-fmad=false" in cuda.NVCC_FLAGS
    assert not any("fast_math" in f or "fast-math" in f for f in cuda.NVCC_FLAGS)

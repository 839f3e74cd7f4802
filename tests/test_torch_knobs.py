"""rt_rs_tpu_torch's cull knobs, early exit and fused bounce shading
against the JAX package's (kernel level; frames are in
test_torch_knob_frames.py).

The JAX side runs eagerly for its XLA glue and in interpret mode for its
Pallas kernels, as its own tests run them.  Tolerances follow
tests/test_torch_packet_trace.py and tests/test_torch_shade_tile.py:

* port against port (a knob on against the knob off): bit-equal on
  valid rays; every knob changes the work, never the result;
* culls, compacted lists and early exit's sort keys against the JAX
  package's eager glue: bit-equal (IEEE subtractions, products and
  quotients, and a stable sort);
* hits against the JAX package's interpret-mode kernel: t at rtol 1e-5
  and pids equal except at near-ties (XLA:CPU contracts the
  Möller–Trumbore arithmetic into FMAs);
* shading against the JAX package's: atol 2e-6, ray components and
  distances also at 2 ULP relative.
"""

from __future__ import annotations

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rt_rs_tpu.ops.pallas import packet_trace as jpt
from rt_rs_tpu.ops.pallas import shade_tile as jst
from rt_rs_tpu_torch import Config, Renderer, Resolution
from rt_rs_tpu_torch.handlers.pbvh import PacketBvhIntrs
from rt_rs_tpu_torch.ops import cuda, shade, shade_tile
from rt_rs_tpu_torch.ops import packet_trace as pt
from rt_rs_tpu_torch.scene.presets import torus_row, torus_scene

# pytest-xdist runs several test processes at once; torch's default of
# one OpenMP thread per core in each of them oversubscribes the CPUs.
torch.set_num_threads(
    max(1, (os.cpu_count() or 1) // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))
)

T_MIN, T_MAX, EPS = 0.01, 1000.0, 1e-7
KW = dict(t_min=T_MIN, t_max=T_MAX, eps=EPS)
FORCED_CAP = 16  # MAX_VMEM_CHUNKS that splits torus_scene into 4 segments
SHADE_ATOL = 2e-6
RAY_RTOL = 2.4e-7  # 2 ULP of float32


def _t(x):
    return None if x is None else torch.from_numpy(np.asarray(x))


def _j(x):
    return None if x is None else jnp.asarray(np.asarray(x))


@pytest.fixture(scope="module")
def tables():
    """(port TriChunks, JAX TriChunks) of torus_scene."""
    scene = torus_scene()
    chunks, arrays = PacketBvhIntrs().build(scene, scene.pack(device="cpu"))
    jc = jpt.build_tri_chunks(
        arrays.pa.numpy(), arrays.pb.numpy(), arrays.pc.numpy(),
        max_chunks=None, tri_chunk=64, shade_rows=arrays.shade_table.numpy(),
    )
    return chunks, jc


def random_rays(seed: int = 11, nan_tile: bool = False):
    """tests/test_pbvh.py's early-exit rays: 32 tiles of 256, origins
    ~N(0, 5), random directions, valid with probability 0.7 ->
    (payload [8, T, r], valid [T, r]) as numpy.  ``nan_tile`` gives
    tile 5 NaN directions (a camera with pos == at) and tile 6 a few."""
    rng = np.random.default_rng(seed)
    t_tiles, r = 32, 256
    o = rng.normal(size=(3, t_tiles, r), scale=5.0)
    d = rng.normal(size=(3, t_tiles, r))
    if nan_tile:
        d[:, 5] = np.nan
        d[:, 6, :10] = np.nan
    payload = np.concatenate([o, d, np.zeros((2, t_tiles, r))]).astype(np.float32)
    return payload, rng.random((t_tiles, r)) > 0.3


def assert_hits_match(ours, ref, valid):
    """The hit rule against the JAX package's kernel -> rays whose pid
    agrees (rows are compared there)."""
    t, pid = ours[0].numpy()[valid], ours[1].numpy()[valid]
    jt, jpid = np.asarray(ref[0])[valid], np.asarray(ref[1])[valid]
    np.testing.assert_allclose(t, jt, rtol=1e-5)
    diff = pid != jpid
    assert diff.mean() <= 1e-3, f"{diff.sum()} pids differ"
    assert (np.abs(t[diff] - jt[diff]) <= 1e-5 * np.abs(jt[diff])).all()
    assert (pid != 0).mean() > 0.05  # the rays really hit geometry
    return ~diff


def assert_valid_equal(a, b, valid):
    """Bit-equal on valid rays, output by output."""
    v = torch.from_numpy(np.asarray(valid))
    for x, y in zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,), strict=True):
        assert torch.equal(x[..., v], y[..., v])


# ----------------------------------------------------------------------
# early exit


@pytest.mark.parametrize("cull", ["interval", "refined"])
def test_early_exit_lists_match_jax(tables, cull):
    """ids, counts and the sorted keys ed equal the JAX package's eager
    prelude (the interval cull's near bound as the key, unlisted chunks
    at 3e38, a stable argsort), for the interval and the per-ray list;
    tiles of NaN rays included."""
    chunks, jc = tables
    payload, valid = random_rays(nan_tile=True)
    p, v = _t(payload), _t(valid)
    win = dict(t_min=T_MIN, t_max=T_MAX)
    ov, near = pt.chunk_overlap_mask_cm(
        p[0:3], 1.0 / p[3:6], v, chunks.bmin, chunks.bmax, want_near=True, **win
    )
    jov, jnear = jpt.chunk_overlap_mask_cm(
        _j(payload[0:3]), 1.0 / _j(payload[3:6]), _j(valid), jc.bmin, jc.bmax,
        want_near=True, **win,
    )
    np.testing.assert_array_equal(near.numpy(), np.asarray(jnear))
    if cull == "refined":
        ov = pt.chunk_overlap_mask_perray(p, v, chunks.bmin, chunks.bmax, t_cap=None, **win)
        jov = jpt.chunk_overlap_mask_perray_cm(
            _j(payload[0:3]), 1.0 / _j(payload[3:6]), _j(valid), jc.bmin, jc.bmax, **win
        )
    np.testing.assert_array_equal(ov.numpy(), np.asarray(jov))
    ids, counts, ed = pt.early_exit_lists(ov, near)
    key = jnp.where(jov, jnear, jnp.float32(3.0e38))
    order = jnp.argsort(key, axis=1, stable=True).astype(jnp.int32)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(order))
    np.testing.assert_array_equal(ed.numpy(), np.asarray(jnp.take_along_axis(key, order, axis=1)))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jov.sum(axis=1)))
    # The interval cull keeps every chunk for the NaN tile; the per-ray
    # slab test drops them all.
    real = int((chunks.bmin <= chunks.bmax).all(dim=1).sum())
    assert counts[5] == (real if cull == "interval" else 0)
    # NaN keys (none arise from the cull above) sort last, as in JAX.
    nan_key = torch.tensor([[1.0, np.nan, 3e38, -1.0, np.nan, 2.0, 3e38]])
    ids, _, _ = pt.early_exit_lists(torch.ones_like(nan_key, dtype=torch.bool), nan_key)
    np.testing.assert_array_equal(
        ids.numpy(), np.asarray(jnp.argsort(_j(nan_key.numpy()), axis=1, stable=True))
    )


@pytest.mark.parametrize("extra", [{}, {"refine": True}, {"emit_rows": True}], ids=["closest", "refine", "rows"])
def test_early_exit_kernel_level(tables, extra):
    """Mirrors tests/test_pbvh.py::test_early_exit_bit_exact: the
    early-exit twin is bit-equal to the default twin on valid rays, and
    matches the JAX package's early-exit kernel under the hit rule."""
    chunks, jc = tables
    payload, valid = random_rays()
    p, v = _t(payload), _t(valid)
    base = pt.packet_closest_hit_tiled(chunks, p, v, **KW, **extra)
    fast = pt.packet_closest_hit_tiled(chunks, p, v, early_exit=True, **KW, **extra)
    assert_valid_equal(base, fast, valid)
    ref = jpt.packet_closest_hit_tiled(
        jc, _j(payload), _j(valid), early_exit=True, interpret=True, **KW, **extra
    )
    same = assert_hits_match(fast, ref, valid)
    if "emit_rows" in extra:
        rows, jrows = fast[2].numpy()[:, valid], np.asarray(ref[2])[:, valid]
        np.testing.assert_array_equal(rows[:, same], jrows[:, same])
    # Ignored for any-hit, as in the JAX package.
    cap = _t(np.full(valid.shape, 5.0, np.float32))
    p7 = p.clone()
    p7[7] = 5.0
    assert_valid_equal(
        pt.packet_closest_hit_tiled(chunks, p7, v, cap, any_hit=True, **KW),
        pt.packet_closest_hit_tiled(chunks, p7, v, cap, any_hit=True, early_exit=True, **KW),
        valid,
    )


def test_early_exit_segmented():
    """Segmentation forced (4 segments): the early-exit segmented call
    is bit-equal to the default one on valid rays, closest and rows."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pt, "MAX_VMEM_CHUNKS", FORCED_CAP)
        scene = torus_scene()
        seg, _ = PacketBvhIntrs().build(scene, scene.pack(device="cpu"))
    assert isinstance(seg, pt.SegmentedTriChunks) and len(seg.segments) == 4
    payload, valid = random_rays(seed=3)
    p, v = _t(payload), _t(valid)
    for extra in ({}, {"emit_rows": True, "refine": True}):
        base = pt.packet_closest_hit_segmented_tiled(seg, p, v, **KW, **extra)
        fast = pt.packet_closest_hit_segmented_tiled(seg, p, v, early_exit=True, **KW, **extra)
        assert_valid_equal(base, fast, valid)


def head_on_rays():
    """(torus_row(2)'s flattened table, payload [8, 32, 256], valid):
    rays that all hit the first torus head-on."""
    scene = torus_row(2)
    accel, _ = PacketBvhIntrs().build(scene, scene.pack(device="cpu"))
    chunks = pt.flatten_segments(accel)
    rng = np.random.default_rng(5)
    t_tiles, r = 32, 256
    o = np.stack(
        [
            np.full((t_tiles, r), -20.0),
            rng.uniform(-0.3, 0.3, (t_tiles, r)),
            rng.uniform(-0.3, 0.3, (t_tiles, r)),
        ]
    )
    d = np.stack([np.ones((t_tiles, r)), *rng.uniform(-1e-3, 1e-3, (2, t_tiles, r))])
    payload = _t(np.concatenate([o, d, np.zeros((2, t_tiles, r))]).astype(np.float32))
    return chunks, payload, torch.ones((t_tiles, r), dtype=torch.bool)


def test_early_exit_skips_entries():
    """Rays that all hit the first torus of torus_row(2) head-on: every
    tile stops before the end of its list (the second torus lies behind
    the first), and the result equals the full walk."""
    chunks, payload, valid = head_on_rays()
    win = dict(t_min=T_MIN, t_max=T_MAX)
    ov, near = pt.chunk_overlap_mask_cm(
        payload[0:3], 1.0 / payload[3:6], valid, chunks.bmin, chunks.bmax, want_near=True, **win
    )
    ids, counts, ed = pt.early_exit_lists(ov, near)
    args = (chunks.comp, payload, ids, counts)
    tested = pt.entries_tested(*args, None, ed, mode="closest", **KW)
    assert (tested < counts).all(), (tested, counts)
    t, pid = pt.mt_trace_reference(*args, None, ed, mode="closest", **KW)
    assert (pid != 0).all() and (t < 14.0).all()  # the first torus, x = -6.8
    full = pt.mt_trace_reference(*args, mode="closest", **KW)
    assert_valid_equal(full, (t, pid), valid)
    assert torch.equal(pt.entries_tested(*args, mode="closest", **KW), counts.long())


def test_early_exit_checks(tables):
    chunks, _ = tables
    payload, valid = random_rays()
    p, v = _t(payload), _t(valid)
    with pytest.raises(ValueError, match="early_exit requires cull_block == 1"):
        pt.packet_closest_hit_tiled(chunks, p, v, early_exit=True, cull_block=4, **KW)
    ed = torch.zeros((32, chunks.num_chunks))
    with pytest.raises(ValueError, match="any-hit"):
        pt.mt_trace(chunks.comp, p, None, None, None, ed, mode="anyhit", **KW)


def exit_case(tables, case: str):
    """(chunks, payload, valid, ids, counts, ed) of one early-exit call:
    ``random_rays`` (30% invalid, a tile of NaN rays: no tile stops),
    ``head_on_rays`` (every tile stops early), or torus_scene's 64x48
    primaries (12 live tiles of 32) with skewed lists, sorted by the
    interval cull's entry bounds: the busiest tile listing every chunk
    and the rest nothing, or every tile listing every chunk."""
    if case == "head-on":
        chunks, payload, valid = head_on_rays()
    elif case == "random":
        chunks = tables[0]
        payload, valid = (_t(x) for x in random_rays(nan_tile=True))
    else:
        chunks = tables[0]
        scene = torus_scene()
        payload, valid, _ = shade.camera_ray_tiles(
            torch.tensor(scene.camera.pos, dtype=torch.float32),
            torch.tensor(scene.camera.at, dtype=torch.float32), 64, 48, 256, block=(16, 16),
        )
    ov, near = pt.chunk_overlap_mask_cm(
        payload[0:3], 1.0 / payload[3:6], valid, chunks.bmin, chunks.bmax, want_near=True,
        t_min=T_MIN, t_max=T_MAX,
    )
    if case == "one tile":
        busiest = int(ov.sum(dim=1).argmax())
        ov = torch.zeros_like(ov)
        ov[busiest] = True
    elif case == "every tile":
        ov = torch.ones_like(ov)
    ids, counts, ed = pt.early_exit_lists(ov, near)
    return chunks, payload, valid, ids, counts, ed


EXIT_SPLIT_CASES = [
    ("random", 1, "closest"),
    ("random", 8, "rows"),
    ("head-on", 1, "rows"),
    ("head-on", 3, "closest"),
    ("head-on", 4, "rows"),
    ("head-on", 8, "closest"),
    ("one tile", 8, "rows"),
    ("one tile", 16, "closest"),
    ("every tile", 3, "rows"),
    ("every tile", 8, "closest"),
]


@pytest.mark.parametrize("case,per_item,mode", EXIT_SPLIT_CASES)
def test_early_exit_split_bit_equal_to_the_twin(tables, case, per_item, mode):
    """Early exit's balanced mirror: the same bits in every merge order
    on every ray; the twin's bits on valid rays, and on every ray of the
    tiles whose list fits the lead item."""
    chunks, payload, valid, ids, counts, ed = exit_case(tables, case)
    args = (chunks.comp, payload, ids, counts, chunks.attr if mode == "rows" else None, ed)
    kw = dict(mode=mode, per_item=per_item, **KW)
    n_rest = pt.mt_items(torch.clamp(counts - per_item, min=0), per_item)[0].numel()
    g = torch.Generator().manual_seed(per_item)
    got = pt.mt_trace_exit_split_reference(*args, **kw)
    for order in (torch.randperm(n_rest, generator=g), torch.arange(n_rest).flip(0)):
        again = pt.mt_trace_exit_split_reference(*args, order=order, **kw)
        assert_valid_equal(got, again, torch.ones_like(valid))
    want = pt.mt_trace_reference(*args, mode=mode, **KW)
    assert_valid_equal(got, want, valid)
    single = (counts <= per_item)[:, None].expand_as(valid)
    assert_valid_equal(got, want, single)
    assert bool((got[1][valid] != 0).any())  # the call hits geometry
    tested = pt.exit_entries_tested(*args, **kw)
    assert bool((tested <= counts).all())
    if case == "head-on" and per_item >= pt.EXIT_CHECK:
        # The lead's snapshot prunes like the walk: each tile stops early.
        assert bool((tested < counts).all()), (tested, counts)


@pytest.mark.parametrize("extra", [{}, {"emit_rows": True}], ids=["closest", "rows"])
def test_early_exit_split_matches_jax_and_default(tables, extra):
    """The mirror on torus_scene's 96x72 primaries (27 live tiles of
    32), at the kernel's item size and at 8 (where some tiles stop
    early): bit-equal to the default mode on valid rays, and matching the
    JAX package's early-exit kernel (interpret mode) under the hit
    rule."""
    chunks, jc = tables
    scene = torus_scene()
    p, v, _ = shade.camera_ray_tiles(
        torch.tensor(scene.camera.pos, dtype=torch.float32),
        torch.tensor(scene.camera.at, dtype=torch.float32), 96, 72, 256, block=(16, 16),
    )
    valid = v.numpy()
    ov, near = pt.chunk_overlap_mask_cm(
        p[0:3], 1.0 / p[3:6], v, chunks.bmin, chunks.bmax, want_near=True, t_min=T_MIN, t_max=T_MAX
    )
    ids, counts, ed = pt.early_exit_lists(ov, near)
    mode = "rows" if extra else "closest"
    args = (chunks.comp, p, ids, counts, chunks.attr if extra else None, ed)
    base = pt.packet_closest_hit_tiled(chunks, p, v, **KW, **extra)
    ref = jpt.packet_closest_hit_tiled(
        jc, _j(p.numpy()), _j(valid), early_exit=True, interpret=True, **KW, **extra
    )
    for per_item in (None, 8):
        ours = pt.mt_trace_exit_split_reference(*args, mode=mode, per_item=per_item, **KW)
        assert_valid_equal(ours, base, valid)
        same = assert_hits_match(ours, ref, valid)
        if extra:
            rows, jrows = ours[2].numpy()[:, valid], np.asarray(ref[2])[:, valid]
            np.testing.assert_array_equal(rows[:, same], jrows[:, same])
    tested = pt.exit_entries_tested(*args, mode=mode, per_item=8, **KW)
    assert int(tested.sum()) < int(counts.sum())


def test_exit_item_size_mirrors_the_kernel():
    """The mirror's default item size is the kernel's compile-time one
    (``ITEM_EXIT`` in csrc/mt_trace.cu)."""
    src = (cuda.CSRC / "mt_trace.cu").read_text()
    (size,) = re.findall(r"ITEM_EXIT = (\d+)", src)
    assert int(size) == pt.MT_EXIT_ITEM_SIZE >= 1


# ----------------------------------------------------------------------
# cull_block and subgroup refine


@pytest.mark.parametrize("cull_block", [1, 4, 32])
def test_cull_block(tables, cull_block):
    """Each cull_block's hits are bit-equal to cull_block=1 on valid rays
    (interval and per-ray cull) and match the JAX package's run."""
    chunks, jc = tables
    payload, valid = random_rays(seed=7)
    p, v = _t(payload), _t(valid)
    for refine in (False, True):
        one = pt.packet_closest_hit_tiled(chunks, p, v, refine=refine, **KW)
        blk = pt.packet_closest_hit_tiled(chunks, p, v, refine=refine, cull_block=cull_block, **KW)
        assert_valid_equal(one, blk, valid)
    ref = jpt.packet_closest_hit_tiled(
        jc, _j(payload), _j(valid), cull_block=cull_block, interpret=True, **KW
    )
    assert_hits_match(blk, ref, valid)
    with pytest.raises(ValueError, match="cull_block"):
        pt.packet_closest_hit_tiled(chunks, p, v, cull_block=3, **KW)


def test_subgroup_refine(tables):
    """refine=8: the mask equals the JAX package's
    chunk_overlap_mask_subgroup_cm, never looser than the interval cull,
    and the hits equal refine=True's on valid rays."""
    chunks, jc = tables
    payload, valid = random_rays(seed=9)
    p, v = _t(payload), _t(valid)
    cap = np.random.default_rng(9).uniform(0.5, 12.0, valid.shape).astype(np.float32)
    win = dict(t_min=T_MIN, t_max=T_MAX)
    ours = pt.chunk_overlap_mask_subgroup_cm(
        p[0:3], 1.0 / p[3:6], v, chunks.bmin, chunks.bmax, t_cap=_t(cap), sub=8, **win
    )
    ref = jpt.chunk_overlap_mask_subgroup_cm(
        _j(payload[0:3]), 1.0 / _j(payload[3:6]), _j(valid), jc.bmin, jc.bmax,
        t_cap=_j(cap), sub=8, **win,
    )
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    interval = pt.chunk_overlap_mask_cm(p[0:3], 1.0 / p[3:6], v, chunks.bmin, chunks.bmax, **win)
    assert not (ours & ~interval).any()
    for extra in ({}, {"emit_rows": True, "early_exit": True}):
        sub8 = pt.packet_closest_hit_tiled(chunks, p, v, refine=8, **KW, **extra)
        exact = pt.packet_closest_hit_tiled(chunks, p, v, refine=True, **KW, **extra)
        assert_valid_equal(sub8, exact, valid)
    with pytest.raises(ValueError, match="subgroup"):
        pt.packet_closest_hit_tiled(chunks, p, v, refine=7, **KW)


# ----------------------------------------------------------------------
# shade_bounce


@pytest.fixture(scope="module")
def bounce_state():
    """Bounces 0 and 1 of a 64x48 torus_scene frame (the port's emit
    branch): post inputs of bounce 0 in both shadow modes, pre inputs of
    bounce 1, and the two bounces' active masks and subgroup flags."""
    cfg = Config(resolution=Resolution.sized(64, 48))
    r = Renderer(torus_scene(), config=cfg, handler="pbvh", device="cpu")
    c = cfg.compute
    pos = torch.tensor(r.camera.pos, dtype=torch.float32)
    payload, valid, _ = shade.camera_ray_tiles(
        pos, torch.tensor(r.camera.at, dtype=torch.float32), 64, 48, 256, block=r.block
    )
    intersect_fn, _, anyhit_fn = r._bound(r.handler)

    def live(active):
        return active.reshape(-1, 8 * 256).any(dim=1).to(torch.int32)

    table = r.arrays.shade_table
    t, pid = intersect_fn(payload, valid)
    active = valid & (pid != 0) & (t < c.t_max) & (t > c.t_min)
    pid = torch.where(active, pid, 0)
    lights = torch.cat([r.arrays.light_pos, r.arrays.light_strength[:, None]], dim=1)
    k, n_tiles = lights.shape[0], t.shape[0]
    sh, caps, masks, nxt = shade_tile.shade_pre(
        table, pid, payload, t, live(active), lights, emit_next=True
    )
    sh_valid = (active[None] & (masks > 0)).reshape(k * n_tiles, -1)
    kw = dict(t_cap=caps.reshape(k * n_tiles, -1), refine=True)
    blocked = anyhit_fn(sh, sh_valid, **kw).reshape(caps.shape).float()
    st, sid = intersect_fn(sh, sh_valid, **kw)
    shadows = {
        True: (blocked, blocked),
        False: (st.reshape(caps.shape), sid.reshape(caps.shape).float()),
    }
    t2, pid2 = intersect_fn(nxt, active, refine=True)
    active2 = active & (pid2 != 0) & (t2 < c.t_max) & (t2 > c.t_min)
    pid2 = torch.where(active2, pid2, 0)
    return dict(
        table=table, post=(pid, payload, t, active.float()), caps=caps, shadows=shadows,
        pre=(pid2, nxt, t2), live=torch.stack([live(active), live(active2)]),
        lights=lights.contiguous(), active=active.numpy(), active2=active2.numpy(),
    )


def _close_on(ours, ref, active, what, rtol=0.0):
    ours, ref = np.asarray(ours), np.asarray(ref)
    np.testing.assert_allclose(
        ours[..., active], ref[..., active], rtol=rtol, atol=SHADE_ATOL, err_msg=what
    )


@pytest.mark.parametrize("emit_next", [True, False])
@pytest.mark.parametrize("blocked_mode", [True, False])
def test_shade_bounce(bounce_state, blocked_mode, emit_next):
    """The twin of kernel F is bit-equal to shade_post + shade_pre, and
    matches the JAX package's shade_bounce (interpret mode)."""
    s = bounce_state
    table = s["table"]
    sh_t, sh_id = s["shadows"][blocked_mode]
    args = (table, *s["post"], sh_t, sh_id, s["caps"], *s["pre"], s["live"], s["lights"])
    flags = dict(first_bounce=True, t_min=T_MIN, t_max=T_MAX, blocked_mode=blocked_mode)
    ours = shade_tile.shade_bounce(*args, emit_next=emit_next, **flags)
    post = shade_tile.shade_post(
        table, *s["post"], sh_t, sh_id, s["caps"], s["live"][0], s["lights"], **flags
    )
    pre = shade_tile.shade_pre(table, *s["pre"], s["live"][1], s["lights"], emit_next=emit_next)
    for a, b in zip(ours, (post, *pre), strict=True):
        if a is None or b is None:
            assert a is None and b is None
        else:
            np.testing.assert_array_equal(a.numpy(), b.numpy())  # NaN == NaN
    color, sh, caps, masks, nxt = ours
    (pid, *post), (pid2, nxt2, t2) = s["post"], s["pre"]
    jargs = (
        shade_tile.table_rows(table, pid), *post, sh_t, sh_id, s["caps"],
        shade_tile.table_rows(table, pid2), nxt2, t2, pid2.float(), s["live"], s["lights"],
    )
    jcolor, jsh, jcaps, jmasks, jnxt = jst.shade_bounce(
        *(_j(x) for x in jargs), emit_next=emit_next, interpret=True, **flags
    )
    a, a2 = s["active"], s["active2"]
    k = s["lights"].shape[0]
    _close_on(color, jcolor, a, "colour")
    _close_on(sh, jnp.concatenate(list(jsh), axis=1), np.tile(a2, (k, 1)), "shadow rays", RAY_RTOL)
    _close_on(caps, jnp.stack(list(jcaps)), a2, "caps", RAY_RTOL)
    np.testing.assert_array_equal(masks.numpy()[:, a2], np.stack([np.asarray(m) for m in jmasks])[:, a2])
    assert (nxt is None) == (jnxt is None) == (not emit_next)
    if emit_next:
        _close_on(nxt, jnxt, a2, "reflection rays", RAY_RTOL)
    assert color.numpy()[:, a].mean() > 0.01 and a2.sum() > 200

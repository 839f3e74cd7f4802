"""Kernel B's balanced design (csrc/mt_trace.cu) in its plain-PyTorch
mirror, and the shading twins' IEEE rsqrt.

On the card ``mt_trace`` cuts each tile's chunk list into work items of
a few consecutive entries, runs them on a persistent grid in whatever
order the blocks take them, and merges each ray's hits with an atomic
minimum of a 64-bit (t, pid) key.  ``packet_trace`` mirrors the three
parts (``hit_key``, ``mt_items``, ``mt_trace_split_reference``); here
they are held to the twin of the per-tile walk, ``mt_trace_reference``,
bit for bit in every merge order, and to the JAX package's kernel
(interpret mode) at the tolerances of tests/test_torch_packet_trace.py.
The inputs are ``torus_scene``'s chunk table and seeded numpy rays.
"""

from __future__ import annotations

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rt_rs_tpu.ops.pallas import packet_trace as jpt
from rt_rs_tpu_torch.handlers.pbvh import PacketBvhIntrs
from rt_rs_tpu_torch.ops import cuda, shade, shade_tile
from rt_rs_tpu_torch.ops import packet_trace as pt
from rt_rs_tpu_torch.scene.presets import torus_scene

# One OpenMP thread pool per pytest-xdist worker (see
# tests/test_torch_packet_trace.py).
torch.set_num_threads(
    max(1, (os.cpu_count() or 1) // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))
)

T_MIN, T_MAX, EPS = 0.01, 1000.0, 1e-7
KW = dict(t_min=T_MIN, t_max=T_MAX, eps=EPS)
MISS = np.float32(T_MAX + 1.0)


@pytest.fixture(scope="module")
def tables():
    """(port TriChunks, JAX TriChunks, n_prims) for torus_scene."""
    scene = torus_scene()
    chunks, arrays = PacketBvhIntrs().build(scene, scene.pack(device="cpu"))
    corners = [arrays.pa.numpy(), arrays.pb.numpy(), arrays.pc.numpy()]
    jc = jpt.build_tri_chunks(
        *corners, max_chunks=None, tri_chunk=64, shade_rows=arrays.shade_table.numpy()
    )
    return chunks, jc, scene.num_prims


def primary_payload(n_prims: int):
    """64x48 camera rays: [8, 32, 256] payload, valid [32, 256]."""
    scene = torus_scene()
    payload, valid, _ = shade.camera_ray_tiles(
        torch.tensor(scene.camera.pos, dtype=torch.float32),
        torch.tensor(scene.camera.at, dtype=torch.float32),
        64, 48, 256, block=(16, 16),
    )
    return payload.numpy(), valid.numpy()


def scattered_payload(seed: int, n_prims: int, with_cap: bool):
    """Divergent rays around the torus (bounce- or shadow-like): random
    directions, 70% valid, random exclusion ids, caps in row 7 for
    shadow-like batches."""
    rng = np.random.default_rng(seed)
    t_tiles, r = 32, 256
    o = rng.uniform(-3.5, 3.5, (3, t_tiles, r))
    d = rng.normal(size=(3, t_tiles, r))
    d /= np.maximum(np.linalg.norm(d, axis=0, keepdims=True), 1e-6)
    excl = rng.integers(0, n_prims + 1, (1, t_tiles, r))
    cap = rng.uniform(0.2, 12.0, (1, t_tiles, r))
    payload = np.concatenate([o, d, excl, cap if with_cap else 0 * cap]).astype(np.float32)
    return payload, rng.random((t_tiles, r)) < 0.7


CASES = {
    "primary": lambda n: primary_payload(n),
    "bounce": lambda n: scattered_payload(1, n, with_cap=False),
    "shadow": lambda n: scattered_payload(2, n, with_cap=True),
}


def lists(chunks, case: str, n_prims: int, skewed: bool):
    """(payload, valid, ids, counts) of one call: the interval cull's
    compacted lists (per-ray refine for the scattered cases) or, skewed,
    one tile listing every chunk and every other tile empty."""
    payload, valid = CASES[case](n_prims)
    p, v = torch.from_numpy(payload), torch.from_numpy(valid)
    if skewed:
        nc = chunks.num_chunks
        ids = torch.arange(nc, dtype=torch.int32).expand(p.shape[1], nc).contiguous()
        counts = torch.zeros(p.shape[1], dtype=torch.int32)
        counts[5] = nc
        return p, v, ids, counts
    if case == "primary":
        overlap = pt.chunk_overlap_mask_cm(
            p[0:3], 1.0 / p[3:6], v, chunks.bmin, chunks.bmax, t_min=T_MIN, t_max=T_MAX
        )
    else:
        cap = p[7] if case == "shadow" else None
        overlap = pt.chunk_overlap_mask_perray(
            p, v, chunks.bmin, chunks.bmax, t_min=T_MIN, t_max=T_MAX, t_cap=cap
        )
    ids, counts = pt.compact(overlap)
    return p, v, ids, counts


def bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def assert_bit_equal(got, want, what: str) -> None:
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype and a.shape == b.shape, f"{what} output {i}"
        assert torch.equal(bits(a), bits(b)), f"{what} output {i}: not bit-equal"


@pytest.mark.parametrize("seed", [0, 1])
def test_hit_key_orders_like_t_then_pid(seed):
    rng = np.random.default_rng(seed)
    n = 600
    t = rng.choice(
        np.array([-0.0, 0.0, -1e-30, 1e-30, -3.5, 2.0, MISS, 1e-45, -1e-45], np.float32), n
    )
    rand = (rng.standard_normal(n) * 10.0 ** rng.integers(-6, 6, n)).astype(np.float32)
    t = np.where(rng.random(n) < 0.5, t, rand).astype(np.float32)
    pid = rng.integers(0, 40, n).astype(np.int32)  # many (t, pid) ties
    pid[:10] = (1 << 24) - 1
    key = pt.hit_key(torch.from_numpy(t), torch.from_numpy(pid)).numpy()
    ti, tj = t[:, None], t[None, :]
    pi, pj = pid[:, None], pid[None, :]
    less = (ti < tj) | ((ti == tj) & (pi < pj))
    equal = (ti == tj) & (pi == pj)
    np.testing.assert_array_equal(key[:, None] < key[None, :], less)
    np.testing.assert_array_equal(key[:, None] == key[None, :], equal)
    t2, pid2 = pt.hit_key_decode(torch.from_numpy(key))
    canonical = np.where(t == 0.0, np.float32(0.0), t)  # -0.0 comes back as +0.0
    np.testing.assert_array_equal(t2.numpy().view(np.int32), canonical.view(np.int32))
    np.testing.assert_array_equal(pid2.numpy(), pid)


@pytest.mark.parametrize("per_item", [1, 3, 8])
def test_items_cover_every_entry_once(per_item):
    nc = 128
    counts = sorted({0, 1, max(per_item - 1, 0), per_item, per_item + 1, nc})
    counts = torch.tensor(counts + [0, 2 * per_item, 5], dtype=torch.int32)
    tile, k0, n = pt.mt_items(counts, per_item)
    want = sum(-(-int(c) // per_item) for c in counts)
    assert tile.numel() == k0.numel() == n.numel() == want
    assert bool((n >= 1).all() and (n <= per_item).all())
    assert bool((tile[1:] >= tile[:-1]).all())  # tiles in order
    for t, c in enumerate(counts.tolist()):
        mine = (tile == t).nonzero()[:, 0]
        covered = sorted(k for i in mine.tolist() for k in range(int(k0[i]), int(k0[i] + n[i])))
        assert covered == list(range(c)), f"tile {t} (count {c})"


SPLIT_CASES = [
    ("primary", "closest", False),
    ("primary", "rows", False),
    ("bounce", "rows", False),
    ("shadow", "anyhit", False),
    ("bounce", "closest", True),
    ("bounce", "rows", True),
    ("shadow", "anyhit", True),
]


@pytest.mark.parametrize("per_item", [1, 3, 8])
@pytest.mark.parametrize("case,mode,skewed", SPLIT_CASES)
def test_split_merge_bit_equal_to_the_walk(tables, case, mode, skewed, per_item):
    """Every item order gives the per-tile walk's result bit for bit."""
    chunks, _, n = tables
    p, _, ids, counts = lists(chunks, case, n, skewed)
    attr = chunks.attr if mode == "rows" else None
    want = pt.mt_trace_reference(chunks.comp, p, ids, counts, attr, mode=mode, **KW)
    n_items = pt.mt_items(counts, per_item)[0].numel()
    g = torch.Generator().manual_seed(per_item)
    orders = (None, torch.randperm(n_items, generator=g), torch.arange(n_items).flip(0))
    for order in orders:
        got = pt.mt_trace_split_reference(
            chunks.comp, p, ids, counts, attr, mode=mode, per_item=per_item, order=order, **KW
        )
        assert_bit_equal(got, want, f"{case} {mode} per_item={per_item}")
    if mode == "anyhit":  # both outcomes occur on the listed tiles
        assert 0.05 < float(want[counts > 0].float().mean()) < 0.95
    else:
        assert bool((want[1] != 0).any())  # the call hits geometry


@pytest.mark.parametrize("case,mode", [("primary", "rows"), ("shadow", "anyhit")])
def test_split_merge_matches_jax_kernel(tables, case, mode):
    """The mirror against the JAX package's kernel on the same lists."""
    chunks, jc, n = tables
    p, v, ids, counts = lists(chunks, case, n, skewed=False)
    attr = chunks.attr if mode == "rows" else None
    ours = pt.mt_trace_split_reference(chunks.comp, p, ids, counts, attr, mode=mode, **KW)
    cap = p[7] if mode == "anyhit" else None
    ref = jpt.packet_closest_hit_tiled(
        jc, jnp.asarray(p.numpy()), jnp.asarray(v.numpy()),
        None if cap is None else jnp.asarray(cap.numpy()),
        refine=case != "primary", interpret=True, emit_rows=mode == "rows",
        any_hit=mode == "anyhit", **KW,
    )
    valid = v.numpy()
    if mode == "anyhit":
        np.testing.assert_array_equal(ours.numpy()[valid], np.asarray(ref)[valid])
        return
    t, pid, jt, jpid = ours[0].numpy(), ours[1].numpy(), np.asarray(ref[0]), np.asarray(ref[1])
    np.testing.assert_allclose(t[valid], jt[valid], rtol=1e-5)
    same = pid[valid] == jpid[valid]
    assert same.mean() >= 1 - 1e-3
    rows, jrows = ours[2].numpy()[:, valid], np.asarray(ref[2])[:, valid]
    np.testing.assert_array_equal(rows[:, same], jrows[:, same])


@pytest.mark.parametrize("mode", pt.MT_MODES)
def test_item_sizes_mirror_the_kernel(mode):
    """The mirror's default item size per mode is the kernel's
    compile-time one (``ITEM_*`` in csrc/mt_trace.cu)."""
    src = (cuda.CSRC / "mt_trace.cu").read_text()
    sizes = dict(re.findall(r"ITEM_(CLOSEST|ROWS|ANYHIT) = (\d+)", src))
    assert int(sizes[mode.upper()]) == pt.MT_ITEM_SIZES[mode] >= 1


def test_split_merge_edges(tables):
    """No items at all (every list empty) and one entry per tile."""
    chunks, _, n = tables
    p, _, ids, counts = lists(chunks, "bounce", n, skewed=False)
    for c in (torch.zeros_like(counts), torch.clamp(counts, max=1)):
        for mode in pt.MT_MODES:
            attr = chunks.attr if mode == "rows" else None
            want = pt.mt_trace_reference(chunks.comp, p, ids, c, attr, mode=mode, **KW)
            got = pt.mt_trace_split_reference(chunks.comp, p, ids, c, attr, mode=mode, **KW)
            assert_bit_equal(got, want, f"{mode} counts <= 1")
    t, pid = pt.mt_trace_split_reference(chunks.comp, p, ids, torch.zeros_like(counts), mode="closest", **KW)
    assert bool((t == MISS).all() and (pid == 0).all())


def shade_inputs(seed: int):
    """Seeded shading inputs: 8 tiles of 32 rays, 2 lights, half the
    subgroups live."""
    rng = np.random.default_rng(seed)
    t_tiles, r = 16, 32
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))  # noqa: E731
    rows, payload = f(32, t_tiles, r), f(8, t_tiles, r)
    rows[24] = rows[24].abs() * 8.0  # specular powers
    t = torch.from_numpy(rng.uniform(0.1, 5.0, (t_tiles, r)).astype(np.float32))
    pid_f = torch.from_numpy(rng.integers(1, 100, (t_tiles, r)).astype(np.float32))
    live_sg = torch.tensor([1, 0], dtype=torch.int32)
    lights = torch.tensor([[0.0, 5.0, -3.0, 1.0], [2.0, 4.0, 1.0, 0.5]])
    return rows, payload, t, pid_f, live_sg, lights, rng


@pytest.mark.parametrize("kernel", ["shade_pre", "shade_post", "shade_bounce"])
def test_shade_twins_unchanged_by_the_rsqrt_routing(kernel, monkeypatch):
    """On the CPU the twins' IEEE rsqrt is torch.rsqrt: the same bits as
    before the routing."""
    rows, payload, t, pid_f, live_sg, lights, rng = shade_inputs(3)
    sh_t = torch.from_numpy(rng.uniform(-1.0, 20.0, (2, *t.shape)).astype(np.float32))
    sh_id = torch.from_numpy(rng.integers(0, 3, (2, *t.shape)).astype(np.float32))
    caps = torch.from_numpy(rng.uniform(0.5, 10.0, (2, *t.shape)).astype(np.float32))
    active = (torch.from_numpy(rng.random(t.shape)) < 0.8).to(torch.float32)
    post_kw = dict(first_bounce=False, t_min=T_MIN, t_max=T_MAX)

    def run():
        if kernel == "shade_pre":
            return shade_tile.shade_pre_reference(rows, payload, t, pid_f, live_sg, lights, True)
        if kernel == "shade_post":
            return shade_tile.shade_post_reference(
                rows, payload, t, active, sh_t, sh_id, caps, live_sg, lights, **post_kw
            )
        return shade_tile.shade_bounce_reference(
            rows, payload, t, active, sh_t, sh_id, caps, rows, payload, t, pid_f,
            torch.stack([live_sg, live_sg]), lights, emit_next=True, **post_kw,
        )

    assert shade._rsqrt is shade_tile._rsqrt  # the glue's and the twins' are one
    routed = run()
    monkeypatch.setattr(shade_tile, "_rsqrt", torch.rsqrt)
    plain = run()
    got = tuple(x for x in (routed if isinstance(routed, tuple) else (routed,)) if x is not None)
    want = tuple(x for x in (plain if isinstance(plain, tuple) else (plain,)) if x is not None)
    assert_bit_equal(got, want, kernel)

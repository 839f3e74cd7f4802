"""The RF-BVH records walk (``ops/bvh_walk_rf.py``, ``csrc/bvh_walk_rf.cu``)
and the ``rf_bvh`` handler that keeps only its records.

On the CPU: the twin against brute force in its three modes on seeded
triangle soups and a small row of tori (exclusion ids, invalid and NaN
rays included), against the scalar NumPy oracle of ``tests/oracle.py``;
a plain-torch decode of the records, written here from the format,
against ``bvh/rf.py``'s ``unpack_rf``; the twin's counts against a
scalar walk of that decode; rf_bvh frames against the bvh handler's and
the JAX package's rf frames; the accel's bytes; the format's limits.

The card's checks (marked ``card``; JAX is imported only inside the one
test that compares with it, so the file runs on the card without the
tests' conftest): each mode's kernel, the local-stack kernel and the
scratch kernel, bit-equal to the twin and run twice alike, its counts
equal to the twin's:

    python3 -m pytest tests/test_torch_rf_walk.py -m card --noconftest -q
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from rt_rs_tpu_torch import ComputeConfig, Renderer, tracing
from rt_rs_tpu_torch.bvh.rf import MAX_LEAF_ITEMS, RfFormatError, unpack_rf
from rt_rs_tpu_torch.handlers import get_handler
from rt_rs_tpu_torch.ops import bvh_walk_rf as rw
from rt_rs_tpu_torch.ops import cuda
from rt_rs_tpu_torch.ops.bvh_walk import node_slab
from rt_rs_tpu_torch.ops.intersect import closest_hit_bruteforce, tri_intersect_pairs
from rt_rs_tpu_torch.scene.presets import (
    deep_chain, no_prims, random_soup, tiled_copies, torus_canyon, torus_row, torus_scene,
)

torch.set_num_threads(
    max(1, (os.cpu_count() or 1) // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))
)

CFG = ComputeConfig()
WIN = dict(t_min=CFG.t_min, t_max=CFG.t_max, eps=CFG.eps)
MODES = ("closest", "rows", "anyhit")


def small_row():
    """Three small tori (12 x 8 segments) in a row, each over its floor."""
    return tiled_copies(torus_scene(segments=(12, 8)), [(-6.0, 0.0, 0.0), (0.0, 0.0, 0.0), (6.0, 0.0, 0.0)])


SCENES = {
    "soup 300": lambda: random_soup(1, 300),
    "soup 1000": lambda: random_soup(2, 1000, scale=3.0),
    "small row": small_row,
}


def build(scene, device="cpu", **kw):
    """(accel, arrays) of rf_bvh's records walk on ``scene``."""
    return get_handler("rf_bvh", **kw).build(scene, scene.pack(device=device))


def rays(scene, n: int, seed: int, nan: int = 4):
    """Seeded rays at ``scene``'s geometry -> (o, d, excl, valid): from
    a sphere around its middle toward it, with axis-parallel directions
    (+-0.0 components, rays along +-y), ``nan`` NaN directions, 5%
    invalid and 20% excluding a prim."""
    rng = np.random.default_rng(seed)
    v = scene.vert_pos.astype(np.float64) if scene.num_prims else np.zeros((1, 3))
    mid, size = (v.min(0) + v.max(0)) / 2, max(float(np.linalg.norm(v.max(0) - v.min(0))), 1.0)
    o = rng.normal(size=(n, 3))
    o = mid + 0.6 * size * o / np.linalg.norm(o, axis=1, keepdims=True)
    d = mid + rng.uniform(-0.25, 0.25, (n, 3)) * size - o
    o = o.astype(np.float32)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    q = n // 16
    d[:q, 1] = 0.0
    d[q : 2 * q, 1] = -0.0
    d[2 * q : 3 * q, 0] = d[2 * q : 3 * q, 2] = np.float32(-0.0)
    d[2 * q : 3 * q, 1] = np.where(o[2 * q : 3 * q, 1] > mid[1], -1.0, 1.0)
    d[3 * q : 3 * q + nan] = np.nan
    valid = rng.random(n) > 0.05
    excl = np.where(rng.random(n) < 0.2, rng.integers(1, max(scene.num_prims, 1) + 1, n), 0).astype(np.int32)
    return tuple(torch.from_numpy(x) for x in (o, d, excl, valid))


def tiles(o, d, excl, valid, cap=None, r=128):
    """Flat rays as component-major tiles (payload [8, T, r], valid [T, r]),
    N a multiple of r; row 7 ``cap`` or t_max."""
    n = o.shape[0]
    cap = torch.full((n,), CFG.t_max) if cap is None else cap
    payload = torch.cat([o.T, d.T, excl[None].to(torch.float32), cap[None]]).contiguous()
    return payload.reshape(8, n // r, r), valid.reshape(n // r, r)


def caps(t, seed: int):
    """Caps around each ray's closest t: at it, an ulp above and below,
    half and twice it, beyond and below t_max, NaN, in turn."""
    rng = np.random.default_rng(seed)
    t = t.numpy().astype(np.float32)
    choices = np.stack([
        t, np.nextafter(t, np.float32(np.inf)), np.nextafter(t, np.float32(-np.inf)), t * np.float32(0.5),
        t * np.float32(2.0), np.full_like(t, CFG.t_max + 7.0), np.full_like(t, CFG.t_max * 0.5),
        np.full_like(t, np.nan),
    ])
    return torch.from_numpy(choices[rng.integers(0, choices.shape[0], t.shape[0]), np.arange(t.shape[0])])


# ----------------------------------------------------------------------
# The twin against brute force


@pytest.mark.parametrize("label", list(SCENES))
def test_twin_is_brute_force_in_every_mode(label):
    """Closest: (t, pid) of every ray equal to the brute-force scan's
    (the same triangle arithmetic, the first of equal t, so the smallest
    pid); rows: the winner's shade-table row; any-hit: the brute-force
    verdict ``pid != 0 and t < cap`` at caps around each hit."""
    scene = SCENES[label]()
    accel, arrays = build(scene)
    o, d, excl, valid = rays(scene, 1024, seed=5)
    bt, bid = closest_hit_bruteforce(o, d, arrays.pa, arrays.pb, arrays.pc, excl, **WIN)
    bt = torch.where(valid, bt, np.float32(CFG.t_max + 1.0))
    bid = torch.where(valid, bid, 0)
    assert 0.1 < (bid[valid] != 0).float().mean() < 0.95
    cap = caps(bt, 9)
    payload, tv = tiles(o, d, excl, valid, cap)
    table = arrays.shade_table.contiguous()
    args = (payload, tv, accel.records, arrays.pa, arrays.pb, arrays.pc)
    t, pid = rw.bvh_walk_rf_tiled(*args, mode="closest", **WIN)
    assert torch.equal(t.reshape(-1), bt) and torch.equal(pid.reshape(-1), bid)
    t2, pid2, rows = rw.bvh_walk_rf_tiled(*args, mode="rows", table=table, **WIN)
    assert torch.equal(t2, t) and torch.equal(pid2, pid)
    assert torch.equal(rows, table[bid.long()].T.reshape(32, *tv.shape))
    blocked = rw.bvh_walk_rf_tiled(*args, mode="anyhit", **WIN)
    assert torch.equal(blocked.reshape(-1), (bid != 0) & (bt < cap))
    assert 0 < int(blocked.sum()) < int((bid != 0).sum())


def test_twin_matches_the_numpy_oracle():
    """The records walk on a soup against ``tests/oracle.py``'s scalar
    brute force (NumPy, the reference's naive intersector): pid equal,
    t within rtol 1e-5, on rays with exclusion ids."""
    from tests.oracle import Oracle

    scene = SCENES["soup 300"]()
    accel, arrays = build(scene)
    o, d, excl, _ = rays(scene, 256, seed=21, nan=0)
    valid = torch.ones(256, dtype=torch.bool)
    payload, tv = tiles(o, d, excl, valid)
    t, pid = (x.reshape(-1) for x in rw.bvh_walk_rf_tiled(
        payload, tv, accel.records, arrays.pa, arrays.pb, arrays.pc, mode="closest", **WIN
    ))
    oracle = Oracle(scene, CFG)
    ref = [oracle.intrs(o[i].numpy(), d[i].numpy(), int(excl[i])) for i in range(256)]
    rt = np.array([x[0] for x in ref], np.float32)
    rid = np.array([x[1] for x in ref])
    np.testing.assert_array_equal(pid.numpy(), rid)
    np.testing.assert_allclose(t.numpy(), rt, rtol=1e-5)
    assert 0.1 < (rid != 0).mean() < 0.95


def test_twin_on_the_edges():
    """Coincident copies tie at equal t on every hit: the smallest pid
    wins, as in the brute-force scan; the deep chain (a stack past the
    kernel's local one) and the scene with no prims (every ray misses)."""
    ties = tiled_copies(torus_scene(segments=(12, 8)), [(0.0, 0.0, 0.0)] * 2)
    for scene, kw in ((ties, {}), (deep_chain(), {"eps": 0.0}), (no_prims(), {})):
        accel, arrays = build(scene, **kw)
        o, d, excl, valid = rays(scene, 512, seed=3, nan=2)
        bt, bid = closest_hit_bruteforce(o, d, arrays.pa, arrays.pb, arrays.pc, excl, **WIN)
        payload, tv = tiles(o, d, excl, valid)
        t, pid = rw.bvh_walk_rf_tiled(payload, tv, accel.records, arrays.pa, arrays.pb, arrays.pc, **WIN)
        ok = valid & torch.isfinite(d).all(dim=1)
        assert torch.equal(t.reshape(-1)[ok], bt[ok]) and torch.equal(pid.reshape(-1)[ok], bid[ok])
        if scene is ties:
            assert (pid.reshape(-1)[ok] != 0).any()
    assert build(deep_chain(), eps=0.0)[0].records.depth > rw.LOCAL_STACK
    assert not pid.any()


@pytest.mark.parametrize("handler", ["bvh", "rf_bvh"])
def test_flat_entry_is_the_tiled_entry(handler):
    """A tree handler's ``intersect_fn`` (the flat path) is its tiled
    closest entry on the rays padded into tiles: the same hits as brute
    force, ids rows of the handler's arrays (scene order for rf_bvh,
    leaf order for bvh)."""
    scene = torus_scene()
    h = get_handler(handler)
    accel, arrays = h.build(scene, scene.pack(device="cpu"))
    o, d, excl, valid = rays(scene, 300, seed=8, nan=0)
    t, pid = h.intersect_fn(accel, arrays, CFG)(o, d, excl, valid)
    bt, bid = closest_hit_bruteforce(o, d, arrays.pa, arrays.pb, arrays.pc, excl, **WIN)
    assert torch.equal(t[valid], bt[valid]) and torch.equal(pid[valid], bid[valid])
    assert (pid[~valid] == 0).all()


# ----------------------------------------------------------------------
# The records, decoded independently


def f16_manual(bits: torch.Tensor) -> torch.Tensor:
    """IEEE binary16 patterns -> float64 values, from sign, exponent and
    mantissa (no float16 dtype involved)."""
    bits = bits.to(torch.int64)
    sign = torch.where((bits >> 15) & 1 == 1, -1.0, 1.0).double()
    exp = (bits >> 10) & 0x1F
    man = (bits & 0x3FF).double()
    normal = sign * torch.pow(2.0, (exp - 15).double()) * (1.0 + man / 1024.0)
    sub = sign * man / 1024.0 * 2.0**-14
    special = torch.where(man == 0, sign * torch.inf, torch.nan)
    return torch.where(exp == 0, sub, torch.where(exp == 31, special, normal))


def decode(words: torch.Tensor) -> dict:
    """The records [R, 4] int32, decoded from the format with plain
    integer arithmetic: a sequential read (a leaf record's next record is
    its payload)."""
    u = words.to(torch.int64) & 0xFFFFFFFF
    r = u.shape[0]
    out = {
        "bmin": f16_manual(u[:, :3] & 0xFFFF), "bmax": f16_manual(u[:, :3] >> 16),
        "is_leaf": torch.zeros(r, dtype=torch.bool), "is_payload": torch.zeros(r, dtype=torch.bool),
        "fst": (u[:, 3] >> 16) & 0x7FFF, "snd": u[:, 3] & 0xFFFF,
        "leaf_prims": torch.zeros((r, 8), dtype=torch.int64),
    }
    i = 0
    while i < r:
        if u[i, 3] >> 31:
            out["is_leaf"][i] = out["is_payload"][i + 1] = True
            out["leaf_prims"][i] = torch.stack([u[i + 1] & 0xFFFF, u[i + 1] >> 16], dim=1).reshape(8)
            i += 2
        else:
            i += 1
    return out


@pytest.mark.parametrize("label", ["teatime", "soup 1000"])
def test_records_decode_as_unpack_rf(label):
    """The device's words are ``pack_rf``'s records; decoded here from
    the format they equal ``unpack_rf``'s fields, and the walk's own
    decoders (``decode_bounds``, ``decode_slots``) give the same."""
    scene = torus_scene() if label == "teatime" else SCENES[label]()
    h = get_handler("rf_bvh")
    accel, _ = h.build(scene, scene.pack(device="cpu"))
    words = accel.records.words
    assert words.dtype == torch.int32 and words.shape == (h.rf_data.num_records, 4)
    np.testing.assert_array_equal(words.numpy().view(np.uint32), h.rf_data.records)
    mine, theirs = decode(words), unpack_rf(h.rf_data)
    for k in ("bmin", "bmax"):
        np.testing.assert_array_equal(mine[k].numpy(), theirs[k].astype(np.float64))
    nodes = ~mine["is_payload"]
    for k in ("is_leaf", "is_payload"):
        np.testing.assert_array_equal(mine[k].numpy(), theirs[k])
    for k in ("fst", "snd"):
        np.testing.assert_array_equal(mine[k][nodes & ~mine["is_leaf"]].numpy(), theirs[k][(~theirs["is_payload"]) & ~theirs["is_leaf"]])
    np.testing.assert_array_equal(mine["leaf_prims"].numpy(), theirs["leaf_prims"])
    lo, hi = rw.decode_bounds(words)
    assert torch.equal(lo.double(), mine["bmin"]) and torch.equal(hi.double(), mine["bmax"])
    leaves = torch.nonzero(mine["is_leaf"]).flatten()
    assert torch.equal(rw.decode_slots(words[leaves + 1]).long(), mine["leaf_prims"][leaves])
    assert mine["is_leaf"].sum() + (nodes & ~mine["is_leaf"]).sum() == h.bvh_data.num_nodes
    assert accel.records.depth == h.bvh_data.max_depth()


def scalar_walk(dec, o, d, ex, pa, pb, pc, cap=None):
    """One ray's walk over the decoded records, a record at a time, fst
    before snd -> (t, pid or blocked, records tested, slots tested)."""
    inv = 1.0 / d
    best_t = torch.tensor(CFG.t_max + 1.0, dtype=torch.float32) if cap is None else cap.clone()
    best_id, records, prims, stack = 0, 0, 0, [0]
    while stack:
        i = stack.pop()
        records += 1
        lo = dec["bmin"][i].float()[None]
        hi = dec["bmax"][i].float()[None]
        near, far = node_slab(o[None], inv[None], lo, hi)
        if not (near <= far and far >= CFG.t_min and near <= best_t):
            continue
        if not dec["is_leaf"][i]:
            stack += [int(dec["snd"][i]), int(dec["fst"][i])]
            continue
        for pid in dec["leaf_prims"][i].tolist():
            if pid == 0 or pid == ex:
                continue
            prims += 1
            t = tri_intersect_pairs(o[None], d[None], pa[pid][None], pb[pid][None], pc[pid][None], **WIN)[0]
            if not (CFG.t_min < t < CFG.t_max):
                continue
            if cap is not None and t < best_t:
                return None, True, records, prims
            if cap is None and (t < best_t or (t == best_t and pid < best_id)):
                best_t, best_id = t, pid
    return best_t, (best_id if cap is None else False), records, prims


def test_twin_counts_are_a_scalar_walks():
    """The twin's rays, records and slots tested, in closest and any-hit
    modes, are what a scalar walk of the independently decoded records
    counts on the same rays (and its results the twin's)."""
    scene = torus_scene()
    accel, arrays = build(scene)
    dec = decode(accel.records.words)
    o, d, excl, valid = rays(scene, 128, seed=17, nan=0)
    t, pid = rw.bvh_walk_rf_reference(o, d, excl, valid, accel.records, arrays.pa, arrays.pb, arrays.pc, **WIN)
    cap = caps(t, 4)
    for mode_cap in (None, cap):
        work = rw.RfWork()
        out = rw.bvh_walk_rf_reference(
            o, d, excl, valid, accel.records, arrays.pa, arrays.pb, arrays.pc, cap=mode_cap, work=work, **WIN
        )
        records = prims = 0
        for i in torch.nonzero(valid).flatten().tolist():
            c = None if mode_cap is None else mode_cap[i]
            bt, res, n_rec, n_prim = scalar_walk(dec, o[i], d[i], int(excl[i]), arrays.pa, arrays.pb, arrays.pc, c)
            records, prims = records + n_rec, prims + n_prim
            if mode_cap is None:
                assert float(bt) == float(out[0][i]) and res == int(out[1][i])
            else:
                assert res == bool(out[i])
        assert (work.rays, work.records, work.prims) == (int(valid.sum()), records, prims)
        assert work.records > 2 * work.rays


def test_tracing_counts_a_frames_records_walks(monkeypatch):
    """While a profiler session records, the CPU twin adds each call's
    counts to rf_rays, rf_records and rf_prims: over a frame they equal
    the counts of the recorded calls, and kernel G counts nothing."""
    calls = []
    inner = rw.bvh_walk_rf_tiled_reference

    def wrapped(*a, **kw):
        calls.append((a, kw))
        return inner(*a, **kw)

    monkeypatch.setattr(rw, "bvh_walk_rf_tiled_reference", wrapped)
    r = Renderer(torus_scene(), size=(16, 12), device="cpu", handler="rf_bvh")
    tracing.begin("cpu", 0)
    with profile(activities=[ProfilerActivity.CPU]):
        r.render_frame()
    snap = tracing.snapshot()
    want = rw.RfWork()
    for a, kw in calls:
        inner(*a, **{**kw, "work": want})
    assert len(calls) == 2 * CFG.bounces
    assert (snap["rf_rays"], snap["rf_records"], snap["rf_prims"]) == (want.rays, want.records, want.prims)
    assert snap["rf_records"] > snap["rf_prims"] > snap["rf_rays"] > 0
    assert snap["walk_rays"] == 0


# ----------------------------------------------------------------------
# The handler


def test_accel_holds_the_records_alone():
    """The accel's tensors are the [R, 4] int32 records: 16 bytes a
    record, the footprint ``stats`` reports; no chunk table, no f32
    unpack and no wide tree; the threaded backend is the same walk."""
    from rtbench.accel import tensor_bytes

    scene = torus_scene()
    for backend in ("auto", "threaded"):
        h = get_handler("rf_bvh", backend=backend)
        accel, arrays = h.build(scene, scene.pack(device="cpu"))
        assert tensor_bytes(accel) == 16 * h.rf_data.num_records == h.stats(accel).size == 98_096
        assert accel.chunks is None and arrays.pa.shape[0] == scene.num_prims + 1
    packet, _ = get_handler("rf_bvh", backend="packet").build(scene, scene.pack(device="cpu"))
    assert packet.chunks is not None and packet.footprint == 98_096


def test_format_limits_still_raise():
    """Past the format's limits the build raises RfFormatError: the
    canyon's records pass 2^15, and a leaf of coincident triangles holds
    more than 8 prims."""
    with pytest.raises(RfFormatError, match="15-bit"):
        build(torus_canyon())
    coincident = tiled_copies(random_soup(3, 1), [(0.0, 0.0, 0.0)] * (MAX_LEAF_ITEMS + 2))
    with pytest.raises(RfFormatError, match="8-slot"):
        build(coincident, target_item_count=MAX_LEAF_ITEMS + 2)


@pytest.mark.parametrize("handler", ["bvh", "jax rf_bvh"])
def test_frames_match(handler):
    """rf_bvh's 64x48 frame (the records walk through the emit branch)
    against the bvh handler's and the JAX package's threaded rf_bvh
    frame, within 2e-5."""
    ours = Renderer(torus_scene(), size=(64, 48), device="cpu", handler="rf_bvh").render_frame().numpy()
    assert np.isfinite(ours).all() and ours.mean() > 0.05
    if handler == "bvh":
        ref = Renderer(torus_scene(), size=(64, 48), device="cpu", handler="bvh").render_frame().numpy()
    else:
        import rt_rs_tpu

        ref = np.asarray(rt_rs_tpu.Renderer(
            rt_rs_tpu.Scene.from_json(torus_scene().to_json()),
            config=rt_rs_tpu.Config(resolution=rt_rs_tpu.Resolution.sized(64, 48)),
            handler="rf_bvh", handler_kwargs={"backend": "threaded"},
        ).render_frame())
    np.testing.assert_allclose(ours, ref, rtol=0, atol=2e-5)


def test_kernel_source_agrees():
    """The wrapper's constants are the kernel's, and every kernel name
    begins with ``bvh_walk_rf`` (the benchmark's readers match on it)."""
    import re

    src = (cuda.CSRC / "bvh_walk_rf.cu").read_text()
    assert int(re.search(r"kLocalStack = (\d+);", src).group(1)) == rw.LOCAL_STACK
    assert int(re.search(r"kBlock = (\d+);", src).group(1)) == rw.BLOCK
    kernels = re.findall(r"__global__ void __launch_bounds__\(kBlock\)\s+(\w+)\(", src)
    assert kernels and all(k.startswith("bvh_walk_rf") for k in kernels)
    assert rw.scratch_threads(10, 100) == rw.BLOCK
    assert rw.scratch_threads(10**9, 1 << 14) % rw.BLOCK == 0


# ---- on the card ----


def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


CARD_SCENES = {
    "teatime": (torus_scene, {}),
    "teapots3": (lambda: torus_row(3), {}),
    "deep chain": (deep_chain, {"eps": 0.0}),
    "no prims": (no_prims, {}),
}


@pytest.mark.card
@pytest.mark.parametrize("label", list(CARD_SCENES))
def test_card_kernel_equals_the_twin(label):
    """Each mode's kernel bit-equal to the twin on 8,192 seeded rays
    (caps around each hit for any-hit), run twice alike, with the twin's
    counts; the deep chain through the scratch kernel."""
    dev = card()
    make, kw = CARD_SCENES[label]
    scene = make()
    accel_c, arrays_c = build(scene, device=dev, **kw)
    accel, arrays = build(scene, **kw)
    o, d, excl, valid = rays(scene, 8192, seed=7)
    t, _ = rw.bvh_walk_rf_reference(o, d, excl, valid, accel.records, arrays.pa, arrays.pb, arrays.pc, **WIN)
    payload, tv = tiles(o, d, excl, valid, caps(t, 11))
    assert (accel_c.records.depth > rw.LOCAL_STACK) == (label == "deep chain")
    for mode in MODES:
        table, table_c = (arrays.shade_table, arrays_c.shade_table.contiguous()) if mode == "rows" else (None, None)
        work = rw.RfWork()
        twin = rw.bvh_walk_rf_tiled_reference(
            payload, tv, accel.records, arrays.pa, arrays.pb, arrays.pc, mode=mode, table=table, work=work, **WIN
        )
        args = (payload.to(dev), tv.to(dev), accel_c.records, arrays_c.pa, arrays_c.pb, arrays_c.pc)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            tracing.begin(dev, 0)
            kern = rw.bvh_walk_rf_tiled(*args, mode=mode, table=table_c, **WIN)
            snap = tracing.snapshot()
        tracing.begin(dev, 0)
        assert (snap["rf_rays"], snap["rf_records"], snap["rf_prims"]) == (work.rays, work.records, work.prims)
        kern = (kern,) if torch.is_tensor(kern) else kern
        twin = (twin,) if torch.is_tensor(twin) else twin
        for a, b in zip(kern, twin, strict=True):
            assert a.dtype == b.dtype and torch.equal(a.cpu(), b)
        again = rw.bvh_walk_rf_tiled(*args, mode=mode, table=table_c, **WIN)
        for a, b in zip((again,) if torch.is_tensor(again) else again, kern, strict=True):
            assert torch.equal(a, b)


@pytest.mark.card
def test_card_frames_walk_the_records():
    """On the card rf_bvh's frames launch the records walk in closest and
    any-hit modes and no other walk, and equal the gather branch's."""
    dev = card()
    before = cuda.LAUNCHES.copy()
    emit = Renderer(torus_scene(), size=(96, 72), device=dev, handler="rf_bvh").render_frame()
    launched = cuda.LAUNCHES - before
    assert launched[rw.walk_name("closest")] == CFG.bounces and launched[rw.walk_name("anyhit")] == CFG.bounces
    assert launched[rw.walk_name("rows")] == 0
    assert not any(k.startswith(("bvh_walk[", "mt_trace")) for k in launched)
    gather = Renderer(torus_scene(), size=(96, 72), device=dev, handler="rf_bvh", force_rows=False).render_frame()
    assert torch.equal(emit, gather)

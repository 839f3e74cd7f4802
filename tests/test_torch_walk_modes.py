"""Kernel G's tiled entry (``ops/bvh_walk.py::bvh_walk_tiled``) in its
three modes, and the threaded frames that take it.

The modes' designs in the plain mirror (``bvh_walk_wide_reference``,
the kernel's loop over the packed wide tree) against the twin
(``bvh_walk_tiled_reference``: the binary walk, ``table[pid]`` for the
rows, the closest hit against the cap for any-hit), bit for bit, in both
leaf kinds, on seeded ray tiles with axis-parallel and NaN directions,
invalid and excluded rays; the any-hit verdict at its edges (a cap at,
just above and below the hit, above and below ``t_max``, NaN; the hit's
prim excluded; ``t_min`` on a hit; invalid rays).  Threaded ``bvh`` and
``rf_bvh`` frames through the emit branch (closest hits and any-hit
shadows, the shading reading the hits' rows from the table) equal the
gather branch (``force_rows=False``) bit for bit, with the knobs
``narrow``, ``retile`` and ``fuse_bounce``.

The card's checks (marked ``card``; this file imports no JAX, so it
runs there without the tests' conftest): each mode's kernel against
its twin and the mirror, run twice alike, with its counts equal to the
mirror's, the frames on the card, emit = gather, and the default ``bvh``
Renderer (``backend="auto"``), which walks on the card within the JAX
package's 12,288-triangle packet cap too, equal to pbvh's frames on the
teatime scene and on its negative-material variant (the flat path):

    python3 -m pytest tests/test_torch_walk_modes.py -m card --noconftest -q
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from rt_rs_tpu_torch import ComputeConfig, Renderer, tracing
from rt_rs_tpu_torch.bvh import wide
from rt_rs_tpu_torch.handlers import get_handler
from rt_rs_tpu_torch.ops import bvh_walk as bw
from rt_rs_tpu_torch.ops import bvh_walk_rf
from rt_rs_tpu_torch.scene.presets import deep_chain, no_prims, tiled_copies, torus_ghost, torus_scene
from tests.torch_rf_tree import rf_walk_build

torch.set_num_threads(
    max(1, (os.cpu_count() or 1) // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))
)

CFG = ComputeConfig()
WIN = dict(t_min=CFG.t_min, t_max=CFG.t_max, eps=CFG.eps)
HANDLERS = ("bvh", "rf_bvh")
# label -> (scene, handler kwargs, NaN rays): a NaN ray enters every node,
# which the lockstep twin takes a step each, so only the small trees get
# them here (the card's synthetic walks in chip_smoke.py give the torus
# its NaN rays).
SCENES = {
    "torus": (torus_scene, {}, 0),
    "ties": (lambda: tiled_copies(torus_scene(), [(0.0, 0.0, 0.0)] * 2), {}, 0),
    "deep chain": (deep_chain, {"eps": 0.0}, 4),
    "no prims": (no_prims, {}, 4),
}
KNOBS = {"default": {}, "narrow": {"narrow": 128}, "retile": {"retile": True}, "fuse_bounce": {"fuse_bounce": True}}


def build(label: str, handler: str, device="cpu"):
    """(kernel G's tree, shade table, prims) of the threaded ``handler``
    on ``label``'s scene."""
    make, kw, _ = SCENES[label]
    scene = make()
    if handler == "rf_bvh":
        # the records unpacked to the tree kernel G's payload leaves walk
        accel, arrays, _ = rf_walk_build(scene, device=device, **kw)
    else:
        accel, arrays = get_handler(handler, backend="threaded", **kw).build(scene, scene.pack(device=device))
    return accel.walk, arrays.shade_table.contiguous(), max(scene.num_prims, 1)


def packed(tree: wide.WalkTree) -> wide.WalkTree:
    """A CPU tree packed as a CUDA build packs it (the mirror's records)."""
    return wide.pack_walk(*tree.binary, payload=tree.payload)


def ray_tiles(t_tiles: int, r: int, seed: int, num_prims: int, nan: int = 4):
    """Seeded ray tiles -> (payload [8, T, r], valid [T, r]): from a
    sphere of radius 6 toward the middle, with axis-parallel directions
    (+-0.0 components, rays along +-y), ``nan`` NaN directions, 5%
    invalid and 20% excluding a prim (chip_smoke.py's ``walk_rays``);
    row 7 (the cap) t_max."""
    n = t_tiles * r
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3))
    o = (6.0 * o / np.linalg.norm(o, axis=1, keepdims=True)).astype(np.float32)
    d = rng.uniform(-1.5, 1.5, (n, 3)) - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    q = n // 16
    d[:q, 1] = 0.0
    d[q : 2 * q, 1] = -0.0
    d[2 * q : 3 * q, 0] = d[2 * q : 3 * q, 2] = np.float32(-0.0)
    d[2 * q : 3 * q, 1] = np.where(o[2 * q : 3 * q, 1] > 0, -1.0, 1.0)
    d[3 * q : 3 * q + nan] = np.nan
    valid = rng.random(n) > 0.05
    excl = np.where(rng.random(n) < 0.2, rng.integers(1, num_prims + 1, n), 0)
    payload = np.ascontiguousarray(np.concatenate([o.T, d.T, excl[None], np.full((1, n), CFG.t_max)]), np.float32)
    return torch.from_numpy(payload).reshape(8, t_tiles, r), torch.from_numpy(valid).reshape(t_tiles, r)


def with_caps(payload, t, seed: int):
    """``payload`` with row 7 set from each ray's closest ``t``: a cap
    at the hit, just above and below it, half and twice it, beyond and
    below ``t_max``, and NaN, in turn over the rays."""
    rng = np.random.default_rng(seed)
    t = t.reshape(-1).numpy().astype(np.float32)
    above = np.nextafter(t, np.float32(np.inf))
    below = np.nextafter(t, np.float32(-np.inf))
    choices = np.stack([
        t, above, below, t * np.float32(0.5), t * np.float32(2.0),
        np.full_like(t, CFG.t_max + 7.0), np.full_like(t, CFG.t_max * 0.5), np.full_like(t, np.nan),
    ])
    cap = choices[rng.integers(0, choices.shape[0], t.shape[0]), np.arange(t.shape[0])]
    out = payload.clone()
    out[7] = torch.from_numpy(cap.astype(np.float32)).reshape(out.shape[1:])
    return out


def mirror(payload, valid, tree, mode, table=None, **win):
    """The kernel's design in ``mode`` on the tiles, by the wide mirror."""
    table = table if mode == "rows" else None
    return bw.bvh_walk_tiled_wide_reference(payload, valid, packed(tree), mode=mode, table=table, **win)


def assert_same(a, b):
    a, b = (a,) if torch.is_tensor(a) else a, (b,) if torch.is_tensor(b) else b
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x.cpu(), y.cpu())


def mode_args(mode, table):
    return {"mode": mode, "table": table if mode == "rows" else None}


@pytest.mark.parametrize("handler", HANDLERS)
@pytest.mark.parametrize("label", list(SCENES))
def test_modes_mirror_equals_twin(handler, label):
    """Each mode's design (the mirror) against the twin, bit for bit:
    closest and rows on the seeded tiles, any-hit on caps set around
    each ray's closest hit."""
    tree, table, num_prims = build(label, handler)
    payload, valid = ray_tiles(16, 128, 7, num_prims, nan=SCENES[label][2])
    t, pid = bw.bvh_walk_tiled_reference(payload, valid, tree, **WIN)
    payload = with_caps(payload, t, 11)
    for mode in bw.WALK_MODES:
        twin = bw.bvh_walk_tiled_reference(payload, valid, tree, **mode_args(mode, table), **WIN)
        assert_same(mirror(payload, valid, tree, mode, table, **WIN), twin)
        assert_same(bw.bvh_walk_tiled(payload, valid, tree, **mode_args(mode, table), **WIN), twin)
    t2, pid2, rows = bw.bvh_walk_tiled_reference(payload, valid, tree, **mode_args("rows", table), **WIN)
    assert torch.equal(t2, t) and torch.equal(pid2, pid)
    assert torch.equal(rows[:, ~valid], table[0][:, None].expand(32, int((~valid).sum())))
    if label != "no prims":
        assert 0 < int((pid != 0).sum()) < pid.numel()


@pytest.mark.parametrize("handler", HANDLERS)
def test_anyhit_is_the_closest_verdict_at_its_edges(handler):
    tree, table, num_prims = build("torus", handler)
    payload, valid = ray_tiles(8, 128, 3, num_prims, nan=0)
    payload[6] = 0.0  # no exclusion
    valid[:] = True
    t, pid = bw.bvh_walk_tiled_reference(payload, valid, tree, **WIN)
    hit = pid != 0
    assert 0 < int(hit.sum()) < hit.numel()

    def anyhit(pay, val=valid, **win):
        win = {**WIN, **win}
        got = mirror(pay, val, tree, "anyhit", **win)
        assert torch.equal(got, bw.bvh_walk_tiled(pay, val, tree, mode="anyhit", **win))
        return got

    def capped(cap):
        pay = payload.clone()
        pay[7] = cap
        return pay

    inf = torch.tensor(float("inf"))
    # the cap beyond t_max: blocked exactly where something is hit
    assert torch.equal(anyhit(capped(torch.full_like(t, CFG.t_max + 7.0))), hit)
    assert torch.equal(anyhit(capped(torch.full_like(t, inf))), hit)
    # a cap at the hit blocks nothing (t < cap is strict); one ulp above does
    assert torch.equal(anyhit(capped(torch.where(hit, t, 1.0))), torch.zeros_like(hit))
    assert torch.equal(anyhit(capped(torch.where(hit, torch.nextafter(t, inf), 0.0))), hit)
    # a cap below t_max: blocked where the hit lies below it
    cap = torch.full_like(t, float(t[hit].median()))
    assert torch.equal(anyhit(capped(cap)), hit & (t < cap))
    # excluding the hit prim: the verdict of the next hit behind it
    excl = payload.clone()
    excl[6] = pid.to(torch.float32)
    excl[7] = CFG.t_max + 7.0
    t2, pid2 = bw.bvh_walk_tiled_reference(excl, valid, tree, **WIN)
    assert torch.equal(anyhit(excl), pid2 != 0)
    assert int((hit & (pid2 == 0)).sum()) > 0  # some rays see nothing behind their hit
    # t_min on a hit: that hit no longer counts
    far = capped(torch.full_like(t, CFG.t_max + 7.0))
    t_min = float(t[hit][0])
    t3, pid3 = bw.bvh_walk_tiled_reference(far, valid, tree, **{**WIN, "t_min": t_min})
    assert torch.equal(anyhit(far, t_min=t_min), pid3 != 0)
    # invalid rays are never blocked
    val = valid.clone()
    val[:, ::3] = False
    got = anyhit(capped(torch.full_like(t, CFG.t_max + 7.0)), val)
    assert torch.equal(got, hit & val)


def test_modes_raise_on_bad_arguments():
    tree, table, num_prims = build("torus", "bvh")
    payload, valid = ray_tiles(1, 128, 1, num_prims)
    with pytest.raises(ValueError, match="unknown walk mode"):
        bw.bvh_walk_tiled(payload, valid, tree, mode="nearest", **WIN)
    with pytest.raises(ValueError, match="table"):
        bw.bvh_walk_tiled(payload, valid, tree, mode="rows", **WIN)
    with pytest.raises(ValueError, match="table"):
        bw.bvh_walk_tiled(payload, valid, tree, mode="anyhit", table=table, **WIN)


def renderer(handler, size=(96, 72), device="cpu", **kw):
    return Renderer(torus_scene(), size=size, device=device, handler=handler, handler_kwargs={"backend": "threaded"}, **kw)


def record_modes(monkeypatch, handler: str) -> list:
    """The modes of the tiled walk calls ``handler``'s frames make:
    kernel G's for bvh, the records walk's for rf_bvh."""
    mod, name = (bvh_walk_rf, "bvh_walk_rf_tiled") if handler == "rf_bvh" else (bw, "bvh_walk_tiled")
    modes = []
    inner = getattr(mod, name)

    def wrapped(*a, **kw):
        modes.append(kw.get("mode", "closest"))
        return inner(*a, **kw)

    monkeypatch.setattr(mod, name, wrapped)
    return modes


@pytest.mark.parametrize("knob", list(KNOBS))
@pytest.mark.parametrize("handler", HANDLERS)
def test_emit_frames_equal_gather_frames(handler, knob, monkeypatch):
    """The threaded frame through the emit branch (closest hits, any-hit
    shadows) is the gather branch's bit for bit, and each branch calls
    the tiled entry in its own modes: no frame calls the rows mode."""
    modes = record_modes(monkeypatch, handler)
    emit = renderer(handler, **KNOBS[knob]).render_frame()
    bounces = CFG.bounces
    assert modes == ["closest"] + ["anyhit", "closest"] * (bounces - 1) + ["anyhit"]
    modes.clear()
    gather = renderer(handler, force_rows=False, **KNOBS[knob]).render_frame()
    assert modes == ["closest"] * (1 + bounces)
    assert emit.mean() > 0.05
    assert torch.equal(emit, gather)


def test_tree_handlers_offer_the_walks_modes():
    """Where the accel holds a walk the tree handlers offer the tiled,
    rows and any-hit entries; the accel holds no shade table."""
    r = renderer("bvh", size=(16, 12))
    closest, rows, anyhit = r._bound(r.handler)
    assert rows is not None and anyhit is not None
    assert r.accel.chunks is None and r.accel.walk is not None
    table = r.arrays.shade_table.untyped_storage().data_ptr()
    stack, seen = [r.accel], []
    while stack:
        x = stack.pop()
        if torch.is_tensor(x):
            seen.append(x.untyped_storage().data_ptr())
        elif isinstance(x, (tuple, list)):
            stack.extend(x)
        elif hasattr(x, "__dataclass_fields__"):
            stack.extend(getattr(x, f) for f in x.__dataclass_fields__)
    assert len(seen) > 10 and table not in seen


def test_anyhit_counters_count_the_shadow_walks(monkeypatch):
    """The CPU twins' walk_anyhit and walk_blocked over a frame equal a
    count made by hand from the recorded any-hit calls: their valid rays
    and their blocked verdicts."""
    calls = []
    inner = bw.bvh_walk_tiled

    def wrapped(*a, **kw):
        out = inner(*a, **kw)
        calls.append((a, kw, out))
        return out

    monkeypatch.setattr(bw, "bvh_walk_tiled", wrapped)
    r = renderer("bvh", size=(16, 12))
    tracing.begin("cpu", 0)
    with profile(activities=[ProfilerActivity.CPU]):
        r.render_frame()
    snap = tracing.snapshot()
    shadows = [(a, out) for a, kw, out in calls if kw["mode"] == "anyhit"]
    assert len(shadows) == CFG.bounces
    assert snap["walk_anyhit"] == sum(int(a[1].sum()) for a, _ in shadows)
    assert snap["walk_blocked"] == sum(int(out.sum()) for _, out in shadows)
    assert 0 < snap["walk_blocked"] < snap["walk_anyhit"]


# ---- on the card ----


def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _counts(device) -> dict:
    buf = tracing.buffer(device).cpu()
    words = buf[1:].reshape(len(tracing.COUNTERS), tracing.SUB).sum(dim=1).tolist()
    return {n: v for n, v in zip(tracing.COUNTERS, words) if n.startswith("walk_")}


@pytest.mark.card
@pytest.mark.parametrize("handler", HANDLERS)
@pytest.mark.parametrize("label", list(SCENES))
def test_card_modes_equal_the_twin(handler, label):
    """Each mode's kernel (the local-stack kernel, or the scratch kernel
    on the deep chain) bit-equal to its twin and to the mirror, run
    twice alike, and its counts equal the mirror's."""
    dev = card()
    tree_c, table_c, num_prims = build(label, handler, device=dev)
    tree, table, _ = build(label, handler)
    payload, valid = ray_tiles(64, 128, 7, num_prims, nan=SCENES[label][2])
    t, _ = bw.bvh_walk_tiled_reference(payload, valid, tree, **WIN)
    payload = with_caps(payload, t, 11)
    if label == "deep chain":
        assert tree_c.stack > wide.LOCAL_STACK
    for mode in bw.WALK_MODES:
        kw = dict(**WIN, mode=mode)
        twin = bw.bvh_walk_tiled_reference(payload, valid, tree, **kw, table=table if mode == "rows" else None)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            tracing.begin(dev, 0)
            tracing.begin("cpu", 0)
            kern = bw.bvh_walk_tiled(
                payload.to(dev), valid.to(dev), tree_c, **kw, table=table_c if mode == "rows" else None,
            )
            bw.bvh_walk_tiled(payload, valid, tree, **kw, table=table if mode == "rows" else None)
            assert _counts(dev) == _counts("cpu"), (mode, _counts(dev), _counts("cpu"))
        tracing.begin(dev, 0)
        tracing.begin("cpu", 0)
        assert_same(kern, twin)
        assert_same(kern, mirror(payload, valid, tree, mode, table, **WIN))
        again = bw.bvh_walk_tiled(payload.to(dev), valid.to(dev), tree_c, **kw, table=table_c if mode == "rows" else None)
        assert_same(again, kern)


@pytest.mark.card
@pytest.mark.parametrize("knob", list(KNOBS))
@pytest.mark.parametrize("handler", HANDLERS)
def test_card_emit_frames_equal_gather_frames(handler, knob):
    """On the card the emit branch's frame is the gather branch's bit
    for bit, and its kernels launched in their modes (no rows mode)."""
    from rt_rs_tpu_torch.ops import cuda

    dev = card()
    before = cuda.LAUNCHES.copy()
    emit = renderer(handler, device=dev, **KNOBS[knob]).render_frame()
    name = bvh_walk_rf.walk_name if handler == "rf_bvh" else (lambda mode: bw.walk_name(False, mode))
    launched = cuda.LAUNCHES - before
    assert launched[name("closest")] == CFG.bounces and launched[name("anyhit")] == CFG.bounces
    assert launched[name("rows")] == 0
    gather = renderer(handler, device=dev, force_rows=False, **KNOBS[knob]).render_frame()
    assert torch.equal(emit, gather)


def default_renderer(handler: str, scene, size, device):
    """``Renderer(scene)`` at the handler's defaults (``bvh``: backend
    ``"auto"``)."""
    return Renderer(scene, size=size, device=device, handler=handler)


@pytest.mark.card
def test_card_default_bvh_walks():
    """``"auto"`` on the card builds kernel G's packed tree and no packet
    table for the teatime scene (6,322 triangles, within the cap)."""
    r = default_renderer("bvh", torus_scene(), (64, 48), card())
    assert r.accel.walk is not None and r.accel.chunks is None


@pytest.mark.card
@pytest.mark.parametrize("size", [(384, 288), (1920, 1080)], ids=["384x288", "1920x1080"])
def test_card_default_bvh_frames_equal_pbvh(size):
    """The default ``bvh`` frame of the teatime scene, through kernel G's
    closest and any-hit modes, is pbvh's (the packet kernels') bit for
    bit."""
    from rt_rs_tpu_torch.ops import cuda

    dev = card()
    before = cuda.LAUNCHES.copy()
    walk = default_renderer("bvh", torus_scene(), size, dev).render_frame()
    launched = cuda.LAUNCHES - before
    assert launched[bw.walk_name(False, "closest")] == CFG.bounces
    assert not any(k.startswith(("mt_trace", "refine_cull")) for k in launched), launched
    packet = default_renderer("pbvh", torus_scene(), size, dev).render_frame()
    assert walk.mean() > 0.05
    assert torch.equal(walk, packet)


@pytest.mark.card
def test_card_negative_material_default_bvh_equals_pbvh():
    """A negative-material scene within the cap (``torus_ghost()``, 6,326
    triangles) takes the flat path; through the default ``bvh`` it calls
    kernel G's closest mode on the rays padded into tiles, and its frame
    is pbvh's bit for bit."""
    from rt_rs_tpu_torch.ops import cuda

    dev = card()
    before = cuda.LAUNCHES.copy()
    walk = default_renderer("bvh", torus_ghost(), (384, 288), dev).render_frame()
    assert (cuda.LAUNCHES - before)[bw.walk_name(False, "closest")] > 0
    packet = default_renderer("pbvh", torus_ghost(), (384, 288), dev).render_frame()
    assert walk.mean() > 0.05
    assert torch.equal(walk, packet)

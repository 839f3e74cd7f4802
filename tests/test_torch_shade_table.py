"""The shading kernels read each hit's row from the resident shade table.

Kernels C, D and F (``ops/shade_tile.py``) take a bounce's pids and the
scene's shade table and read ``table[pid]``; no frame path calls an
intersect entry's rows mode, which wrote a [32, T, r] plane of rows for
the shading to read back.  Here:

* on the CPU, frames of the threaded ``bvh`` and ``rf_bvh`` walks, of
  pbvh (resident; segmented, on the gather branch and with rows forced)
  and of lbvh, at their defaults and with ``fuse_bounce``, ``retile``,
  ``narrow`` and ``shadow_cull=False``, rendered with the rows entry
  replaced by one that raises if called: each equals the frame at the
  defaults bit for bit, and the JAX package's stored frame of its scene
  within 2e-5;
* on the card (marked ``card``; this file imports no JAX, so it runs
  there without the tests' conftest): a captured ``animate(chain=16)``
  records no rows-mode launch on the ``bvh``, ``rf_bvh`` and ``pbvh``
  paths; kernels C, D and F bit-equal to their twins on the bounce
  batches of ``tests/torch_bounce_batches.py``; and the teatime scene's
  1920x1080 frame bit-equal to the frame of the loop this replaced:
  each intersect's rows mode emitting the plane, the plane-reading
  twins shading it:

    python3 -m pytest tests/test_torch_shade_table.py -m card --noconftest -q
"""

from __future__ import annotations

import os
import pathlib

import numpy as np
import pytest
import torch

from rt_rs_tpu_torch import Config, Renderer, Resolution
from rt_rs_tpu_torch.ops import bvh_walk, bvh_walk_rf, cuda, shade, shade_tile
from rt_rs_tpu_torch.ops import packet_trace as pt
from rt_rs_tpu_torch.scene.presets import torus_row, torus_scene
from tests import torch_bounce_batches as bb

torch.set_num_threads(
    max(1, (os.cpu_count() or 1) // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))
)

DATA = pathlib.Path(__file__).resolve().parent / "data"
ATOL = 2e-5
SIZE = (96, 72)
# label -> (scene, Renderer kwargs, stored JAX frame, its key)
CASES = {
    "bvh": (
        torus_scene, dict(handler="bvh", handler_kwargs={"backend": "threaded"}),
        "torch_port_bvh_torus_96x72.npz", "bvh",
    ),
    "rf_bvh": (torus_scene, dict(handler="rf_bvh"), "torch_port_bvh_torus_96x72.npz", "rf_bvh"),
    "pbvh": (torus_scene, dict(handler="pbvh"), "torch_port_torus_96x72.npz", "frame"),
    "pbvh segmented": (lambda: torus_row(2), dict(handler="pbvh"), "torch_port_torus_row2_96x72.npz", "frame"),
    "pbvh segmented rows": (
        lambda: torus_row(2), dict(handler="pbvh", force_rows=True), "torch_port_torus_row2_96x72.npz", "frame",
    ),
    "lbvh": (torus_scene, dict(handler="lbvh"), "torch_port_lbvh_torus_96x72.npz", "frame"),
}
KNOBS = {
    "default": {}, "fuse_bounce": {"fuse_bounce": True}, "retile": {"retile": True},
    "narrow": {"narrow": 128}, "shadow_cull_off": {"shadow_cull": False},
}
ROWS_MODES = (bvh_walk.walk_name(False, "rows"), bvh_walk_rf.walk_name("rows"), pt.mt_name("rows", False))


def _raises(*a, **kw):
    raise AssertionError("a frame called an intersect entry's rows mode")


def no_rows_calls(monkeypatch) -> None:
    """Every Renderer's rows entry, where it offers one, raises if called;
    the frame keeps the branch it offers."""
    inner = Renderer._bound

    def bound(self, h):
        closest, rows, anyhit = inner(self, h)
        return closest, None if rows is None else _raises, anyhit

    monkeypatch.setattr(Renderer, "_bound", bound)


def renderer(label: str, size=SIZE, device="cpu", **knobs) -> Renderer:
    scene, kw, _, _ = CASES[label]
    return Renderer(scene(), config=Config(resolution=Resolution.sized(*size)), device=device, **kw, **knobs)


_DEFAULTS: dict = {}


@pytest.mark.parametrize("knob", list(KNOBS))
@pytest.mark.parametrize("label", list(CASES))
def test_frames_call_no_rows_entry(label, knob, monkeypatch):
    no_rows_calls(monkeypatch)
    r = renderer(label, **KNOBS[knob])
    emit = r._bound(r._frame_handler())[1] is not None
    assert emit == (label not in ("pbvh segmented",))  # the branch each path takes
    frame = r.render_frame().numpy()
    if label not in _DEFAULTS:
        _DEFAULTS[label] = frame if knob == "default" else renderer(label).render_frame().numpy()
    np.testing.assert_array_equal(frame, _DEFAULTS[label])
    _, _, file, key = CASES[label]
    np.testing.assert_allclose(frame, np.load(DATA / file)[key], rtol=0, atol=ATOL)
    assert frame.mean() > 0.05


# ---- on the card ----


def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("handler", ["bvh", "rf_bvh", "pbvh"])
def test_card_chain_launches_no_rows_mode(handler):
    """A captured ``animate(chain=16)`` of the teatime scene launches the
    closest-hit and shading kernels and no rows mode."""
    dev = card()
    r = Renderer(torus_scene(), size=(384, 288), device=dev, handler=handler)
    before = cuda.LAUNCHES.copy()
    r.animate(32, chain=16)
    launched = cuda.LAUNCHES - before
    assert not any(k in launched for k in ROWS_MODES), launched
    closest = {
        "bvh": bvh_walk.walk_name(False, "closest"), "rf_bvh": bvh_walk_rf.walk_name("closest"),
        "pbvh": pt.mt_name("closest", False),
    }[handler]
    # a frame: bounce 0 and three continuations, each shaded by C and D
    assert launched[closest] == launched["shade_pre"] == launched["shade_post"] > 0


@pytest.mark.card
@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_card_shading_kernels_equal_their_twins(k):
    """Kernels C, D and F reading ``table[pid]`` bit-equal to their
    twins on the card (the plane-reading references on ``table_rows``),
    on both bounce batches, both shadow modes and both bounce kinds."""
    dev = card()
    r = bb.renderer()
    b0, b1 = bb.bounce_batches(r)
    table, lights = r.arrays.shade_table.to(dev), bb.lights(r, k).to(dev)

    def on(x):
        return x.to(dev) if torch.is_tensor(x) else x

    def same(name, args, kw):
        args = tuple(on(a) for a in args)
        kern, twin = getattr(shade_tile, name)(*args, **kw), shade_tile.twin(name, *args, **kw)
        for a, b in zip(outputs(kern), outputs(twin), strict=True):
            torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True, msg=name)

    for b in (b0, b1):
        for emit_next in (True, False):
            same("shade_pre", (table, b.pid, b.payload, b.t, b.live_sg, lights, emit_next), {})
        for blocked_mode in (True, False):
            sh = bb.shadows(r, b, bb.lights(r, k), blocked_mode)
            for first_bounce in (True, False):
                kw = dict(
                    first_bounce=first_bounce, t_min=bb.CFG.t_min, t_max=bb.CFG.t_max,
                    blocked_mode=blocked_mode,
                )
                post = (b.pid, b.payload, b.t, b.active.float(), *sh)
                same("shade_post", (table, *post, b.live_sg, lights), kw)
                if b is b0:
                    live2 = torch.stack([b0.live_sg, b1.live_sg])
                    args = (table, *post, b1.pid, b1.payload, b1.t, live2, lights)
                    same("shade_bounce", args, dict(kw, emit_next=True))


def outputs(x) -> list:
    return [o for o in (x if isinstance(x, tuple) else (x,)) if o is not None]


def rows_plane_frame(r: Renderer) -> torch.Tensor:
    """``r``'s frame through the loop this replaced, at the default knobs
    on the emit branch: bounce 0 and each continuation through the rows
    entry, which emits the hits' rows as a [32, T, r] plane, and the
    plane-reading twins (``*_reference``) shading it."""
    cfg = r.config.compute
    closest, rows_fn, anyhit_fn = r._bound(r._frame_handler())
    assert rows_fn is not None and anyhit_fn is not None
    pos, at = (r._camera_tensor(v) for v in (r.camera.pos, r.camera.at))
    payload, valid, n_pixels = shade.camera_ray_tiles(
        pos, at, r.width, r.height, r.handler.block_lanes, block=r.block
    )
    t_tiles, ray_tile = valid.shape
    lights = torch.cat([r.arrays.light_pos, r.arrays.light_strength[:, None]], dim=1).contiguous()
    k = lights.shape[0]
    assert cfg.camera_light_source == 0.0 and k > 0

    def refine(fn):
        return {"refine": True} if getattr(fn, "supports_refine", False) else {}

    def liveness(t, pid, active):
        pid = torch.where(active, pid, 0)
        active = active & (pid != 0) & (t < cfg.t_max) & (t > cfg.t_min)
        return pid, active, active.reshape(-1, 8 * ray_tile).any(dim=1).to(torch.int32)

    t, pid, rows = rows_fn(payload, valid)
    pid, active, live_sg = liveness(t, pid, valid)
    sh_pay, caps, cmasks, nxt = shade_tile.shade_pre_reference(
        rows, payload, t, pid.float(), live_sg, lights, cfg.bounces > 1
    )
    color = torch.zeros((3, t_tiles, ray_tile), dtype=torch.float32, device=payload.device)
    for bounce in range(cfg.bounces):
        last = bounce + 1 >= cfg.bounces
        sh_valid = (active[None] & (cmasks > 0.0)).reshape(k * t_tiles, ray_tile)
        blocked = anyhit_fn(sh_pay, sh_valid, t_cap=caps.reshape(k * t_tiles, ray_tile), **refine(anyhit_fn))
        sh_t = blocked.reshape(k, t_tiles, ray_tile).float()
        if not last:
            t2, pid2, rows2 = rows_fn(nxt, active, **refine(rows_fn))
        color = color + shade_tile.shade_post_reference(
            rows, payload, t, active.float(), sh_t, sh_t, caps, live_sg, lights,
            first_bounce=bounce == 0, t_min=cfg.t_min, t_max=cfg.t_max, blocked_mode=True,
        )
        if last:
            break
        pid2, active2, live_sg2 = liveness(t2, pid2, active)
        sh_pay, caps, cmasks, nxt2 = shade_tile.shade_pre_reference(
            rows2, nxt, t2, pid2.float(), live_sg2, lights, bounce + 2 < cfg.bounces
        )
        rows, payload, t, active, live_sg, nxt = rows2, nxt, t2, active2, live_sg2, nxt2
    flat = color.reshape(3, -1)[:, :n_pixels].T
    return shade.unblock_colors(flat, r.width, r.height, r.block)


@pytest.mark.card
def test_card_teatime_1080p_frame_equals_the_rows_plane_frame():
    """The default ``bvh`` teatime frame at 1920x1080 (kernel G's closest
    and any-hit modes, kernels C and D on the table) is the frame of
    kernel G's rows mode and the plane-reading twins, bit for bit."""
    dev = card()
    r = Renderer(torus_scene(), size=(1920, 1080), device=dev, handler="bvh")
    before = cuda.LAUNCHES.copy()
    frame = r.render_frame()
    assert (cuda.LAUNCHES - before)[bvh_walk.walk_name(False, "rows")] == 0
    old = rows_plane_frame(r)
    assert frame.mean() > 0.05
    assert torch.equal(frame, old)

"""rt_rs_tpu_torch's flat frame path (``shade.render`` / ``shade.trace``)
against the JAX package's.

The flat path renders scenes with a real ``material = -1`` prim: such a
prim blocks camera rays and casts no shadow (the shadow test gathers
``prim_mat``; tests/test_negative_material.py).  Both packages render
the same file-free scenes (the port's presets, loaded by the JAX
package through their JSON); the JAX package runs its Pallas kernels in
interpret mode, the port its kernels' plain-PyTorch twins.

Tolerances: frames at atol 2e-5, the bound the JAX package holds
between its own two frame paths (tests/test_shade_tiled.py); measured
here 1.7e-6 for the ghost scenes and 1.1e-6 for
``torus_ghost()`` at 96x72.  Camera rays at atol 2e-7 (a unit direction
is a few ULP from XLA:CPU's, which contracts ``right * x + up * y`` into
FMAs).

``tests/data/torch_port_torus_ghost_96x72.npz`` (``torus_ghost()`` at
96x72) and ``tests/data/torch_port_ghost_64x48.npz`` (``ghost_scene``
with ghost material -1 and 1 at 64x48) are the JAX package's frames,
rendered with XLA:CPU held to SSE4.2 so that they round op by op like
the port (see tests/test_torch_render.py); ``chip_smoke.py`` holds the
port's CUDA frames to them.  Regenerate them with
``PYTHONPATH=. python tests/test_torch_flat.py``.
"""

from __future__ import annotations

import os
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rt_rs_tpu
from rt_rs_tpu.config import ComputeConfig as JComputeConfig
from rt_rs_tpu.handlers import get_handler as jget_handler
from rt_rs_tpu.ops import shade as jshade
from rt_rs_tpu_torch import Config, ComputeConfig, Renderer, Resolution, Scene
from rt_rs_tpu_torch.handlers import get_handler
from rt_rs_tpu_torch.ops import shade
from rt_rs_tpu_torch.scene.presets import ghost_scene, torus_ghost, torus_scene

torch.set_num_threads(
    max(1, (os.cpu_count() or 1) // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))
)

ROOT = pathlib.Path(__file__).resolve().parent.parent
GHOST_FRAMES = ROOT / "tests" / "data" / "torch_port_ghost_64x48.npz"
TORUS_GHOST_FRAME = ROOT / "tests" / "data" / "torch_port_torus_ghost_96x72.npz"
ATOL = 2e-5
GHOST_MATERIALS = (-1, 1)


def _config(width: int, height: int, **compute) -> Config:
    return Config(compute=ComputeConfig(**compute), resolution=Resolution.sized(width, height))


def jax_frame(scene: Scene, width: int, height: int, handler: str = "pbvh") -> np.ndarray:
    jr = rt_rs_tpu.Renderer(
        rt_rs_tpu.Scene.from_json(scene.to_json()),
        config=rt_rs_tpu.Config(resolution=rt_rs_tpu.Resolution.sized(width, height)),
        handler=handler,
    )
    return np.asarray(jr.render_frame())


def port_frame(scene: Scene, width: int, height: int, handler: str = "pbvh") -> np.ndarray:
    r = Renderer(scene, config=_config(width, height), handler=handler, device="cpu")
    return r.render_frame().numpy()


def _cam(scene: Scene):
    return (
        torch.tensor(scene.camera.pos, dtype=torch.float32),
        torch.tensor(scene.camera.at, dtype=torch.float32),
    )


@pytest.mark.parametrize(
    "block,band", [(None, None), ((8, 16), None), ((16, 16), None), (None, (5, 7)), ((8, 16), (3, 9))]
)
def test_camera_rays_match_jax(block, band):
    pos, at = _cam(torus_scene())
    y0, rows = band if band else (0, None)
    o, d = shade.camera_rays(pos, at, 37, 23, y_offset=y0, rows=rows, block=block)
    jo, jd = jshade.camera_rays(
        jnp.asarray(pos.numpy()), jnp.asarray(at.numpy()), 37, 23, y_offset=y0, rows=rows, block=block
    )
    assert o.shape == jo.shape and d.shape == jd.shape
    np.testing.assert_array_equal(o.numpy(), np.asarray(jo))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=0, atol=2e-7)


def test_glue_rsqrt_rounds_each_op():
    """``shade._rsqrt`` is ``1 / sqrt`` with the square root and the
    quotient each correctly rounded (NumPy's f32 ops), bit for bit, the
    rounding of the stored JAX frames; ``chip_smoke.py`` holds the card's
    form to the same bits."""
    x = (np.random.default_rng(0).random(1 << 20) * 100.0 + 1e-3).astype(np.float32)
    ref = np.float32(1.0) / np.sqrt(x)
    np.testing.assert_array_equal(shade._rsqrt(torch.from_numpy(x)).numpy(), ref)


@pytest.mark.parametrize("block", [None, (16, 16)])
def test_camera_rays_are_the_tiles_rays(block):
    """The flat and tiled layouts hold the same rays bit for bit."""
    pos, at = _cam(torus_scene())
    o, d = shade.camera_rays(pos, at, 40, 24, block=block)
    payload, valid, n = shade.camera_ray_tiles(pos, at, 40, 24, 256, block=block)
    assert n == o.shape[0] and int(valid.sum()) == n
    assert torch.equal(payload[0:3].permute(1, 2, 0).reshape(-1, 3)[:n], o)
    assert torch.equal(payload[3:6].permute(1, 2, 0).reshape(-1, 3)[:n], d)


@pytest.mark.parametrize("headlight", [0.0, 1.5])
def test_trace_matches_jax(headlight):
    """shade.trace through pbvh's flat entry == the JAX package's
    shade.trace on the same rays (torus_scene, 32x24)."""
    scene = torus_scene()
    cfg = ComputeConfig(camera_light_source=headlight)
    h = get_handler("pbvh")
    accel, arrays = h.build(scene, scene.pack(device="cpu"))
    pos, at = _cam(scene)
    o, d = shade.camera_rays(pos, at, 32, 24, block=(16, 16))
    ours = shade.trace(arrays, h.intersect_fn(accel, arrays, cfg), cfg, o, d)

    js = rt_rs_tpu.Scene.from_json(scene.to_json())
    jcfg = JComputeConfig(camera_light_source=headlight)
    jh = jget_handler("pbvh")
    jacc, jarr = jh.build(js, js.pack())
    ref = jshade.trace(
        jarr, jh.intersect_fn(jacc, jarr, jcfg), jcfg, jnp.asarray(o.numpy()), jnp.asarray(d.numpy())
    )
    assert ours.shape == (o.shape[0], 3) and float(ours.mean()) > 0.05
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0, atol=ATOL)


def test_flat_and_tiled_frames_agree():
    """The two frame paths of one scene: shade.render through the flat
    entry == the Renderer's tiled frame (torus_scene, 48x32)."""
    scene = torus_scene()
    r = Renderer(scene, config=_config(48, 32), handler="pbvh", device="cpu")
    tiled = r.render_frame().numpy()
    flat_fn = r.handler.intersect_fn(r.accel, r.arrays, r.config.compute)
    for block in (None, r.block):
        flat = shade.render(r.arrays, flat_fn, r.config.compute, *_cam(scene), 48, 32, block=block)
        np.testing.assert_allclose(flat.numpy(), tiled, rtol=0, atol=ATOL)


@pytest.mark.parametrize("material", GHOST_MATERIALS)
def test_ghost_frames_match_jax(material):
    """Against the live JAX Renderer at 62x46: at 64x48 pixel row 12
    grazes the ghost's bottom edge (u = 0 exactly), which XLA:CPU's FMA
    contraction resolves the other way in 3 pixels; the stored frames
    below hold 64x48 against JAX frames rendered without contraction."""
    scene = ghost_scene(material)
    assert scene.pack(device="cpu").no_negative_materials == (material >= 0)
    ours, ref = port_frame(scene, 62, 46), jax_frame(scene, 62, 46)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("material", GHOST_MATERIALS)
def test_ghost_frames_match_stored_jax_frames(material):
    ref = np.load(GHOST_FRAMES)[f"material_{material}"]
    np.testing.assert_allclose(port_frame(ghost_scene(material), 64, 48), ref, rtol=0, atol=ATOL)


def test_ghost_blocks_camera_but_not_light():
    """The two semantics of a negative-material prim, against the
    positive twin of the same geometry (tests/test_negative_material.py)."""
    neg = port_frame(ghost_scene(-1), 64, 48)
    pos = port_frame(ghost_scene(1), 64, 48)
    assert ((neg.sum(-1) == 0.0) & (pos.sum(-1) > 0.0)).any(), "no camera ray blocked"
    both = (neg.sum(-1) > 0.0) & (pos.sum(-1) > 0.0)
    assert (both & (neg.sum(-1) > pos.sum(-1) + 1e-4)).any(), "the ghost cast a shadow"


@pytest.mark.parametrize("handler", ["pbvh", "bvh"])
def test_torus_ghost_matches_stored_jax_frame(handler):
    """The flat path through the packet kernels (pbvh) and through the
    threaded walk (bvh, the default handler) against the stored JAX
    frame."""
    scene = torus_ghost()
    assert scene.num_prims == 6326 and not scene.pack(device="cpu").no_negative_materials
    ours = port_frame(scene, 96, 72, handler)
    ref = np.load(TORUS_GHOST_FRAME)["frame"]
    np.testing.assert_allclose(ours, ref, rtol=0, atol=ATOL)
    # The view panel blocks the camera rays that reach it.
    plain = port_frame(torus_scene(), 96, 72, handler)
    assert ((ours.sum(-1) == 0.0) & (plain.sum(-1) > 0.0)).sum() > 50


def test_renderer_entries_on_negative_materials():
    """render_image, orbit and animate take the flat path too."""
    r = Renderer(ghost_scene(-1), config=_config(24, 16), handler="pbvh", device="cpu")
    frame = r.render_frame().numpy()
    img = r.render_image()
    np.testing.assert_array_equal(img, np.round(np.clip(frame, 0.0, 1.0) * 255.0).astype(np.uint8))
    seen = []
    times = r.animate(2, on_frame=lambda i, f, dt: seen.append(f.numpy()))
    assert len(times) == 2 and np.array_equal(seen[0], frame)
    assert r.camera == ghost_scene(-1).camera.orbited(1.0).orbited(1.0)


def test_negative_materials_keep_seg_order(monkeypatch):
    """A segmented negative-material scene keeps the caller's
    ``seg_order`` on the flat path, as the JAX package does; its frame is
    the same bits in every order.  Segmentation is forced by
    ``MAX_VMEM_CHUNKS`` = 16 (read through the module)."""
    from rt_rs_tpu_torch.ops import packet_trace as pt

    monkeypatch.setattr(pt, "MAX_VMEM_CHUNKS", 16)
    cfg = _config(32, 16, bounces=2)
    auto = Renderer(torus_ghost(), config=cfg, handler="pbvh", device="cpu")
    n = len(auto.accel.segments)
    assert n > 1 and auto.seg_order == "auto"
    assert sorted(auto._frame_handler().seg_order) == list(range(n))
    fixed = tuple(reversed(range(n)))
    pinned = Renderer(torus_ghost(), config=cfg, handler="pbvh", device="cpu", seg_order=fixed)
    assert pinned._frame_handler().seg_order == fixed
    ref = Renderer(torus_ghost(), config=cfg, handler="pbvh", device="cpu", seg_order="scene").render_frame()
    assert float(ref.mean()) > 0.01
    assert torch.equal(auto.render_frame(), ref) and torch.equal(pinned.render_frame(), ref)


def test_compacting_equals_the_unwrapped_call():
    scene = torus_scene()
    h = get_handler("pbvh")
    cfg = ComputeConfig()
    accel, arrays = h.build(scene, scene.pack(device="cpu"))
    fn = h.intersect_fn(accel, arrays, cfg)
    rng = np.random.default_rng(0)
    n = 3000
    o = torch.from_numpy(rng.uniform(-6.0, 6.0, (n, 3)).astype(np.float32))
    d = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32))
    d = d / d.norm(dim=1, keepdim=True)
    excl = torch.from_numpy(rng.integers(0, scene.num_prims, n).astype(np.int32))
    valid = torch.from_numpy(rng.random(n) < 0.3)
    cap = torch.from_numpy(rng.uniform(1.0, 20.0, n).astype(np.float32))
    t, pid = fn(o, d, excl, valid, t_cap=cap)
    ct, cpid = shade.compacting(fn)(o, d, excl, valid, t_cap=cap)
    assert torch.equal(t[valid], ct[valid]) and torch.equal(pid[valid], cpid[valid])
    assert (pid[valid] != 0).float().mean() > 0.1
    # and a compacting frame is the frame
    pos, at = _cam(scene)
    a = shade.render(arrays, fn, cfg, pos, at, 24, 16)
    b = shade.render(arrays, fn, cfg, pos, at, 24, 16, compact=True)
    assert torch.equal(a, b)


def test_trace_tiled_refuses_negative_materials():
    scene = ghost_scene(-1)
    pos, at = _cam(scene)
    payload, valid, _ = shade.camera_ray_tiles(pos, at, 32, 24, 128)
    with pytest.raises(ValueError, match="negative"):
        shade.trace_tiled(scene.pack(device="cpu"), None, ComputeConfig(), payload, valid, pos)


if __name__ == "__main__":
    import jax

    # Read when the first computation starts the CPU backend.
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " --xla_cpu_max_isa=SSE4_2").strip()
    jax.config.update("jax_platforms", "cpu")
    frames = {f"material_{m}": jax_frame(ghost_scene(m), 64, 48) for m in GHOST_MATERIALS}
    np.savez_compressed(GHOST_FRAMES, **frames)
    print(f"wrote {GHOST_FRAMES}: {sorted(frames)}")
    frame = jax_frame(torus_ghost(), 96, 72)
    np.savez_compressed(TORUS_GHOST_FRAME, frame=frame)
    print(f"wrote {TORUS_GHOST_FRAME}: {frame.shape}, mean {frame.mean():.6f}")

"""File-free scenes for the port's parity tests and on-card checks.

Counterpart of ``rt_rs_tpu/scene/presets.py``, whose scenes read OBJ
and JSON files from the reference checkout.  These are built in NumPy
from parameters alone, so both packages can render them anywhere: the
JAX package loads one through ``rt_rs_tpu.scene.Scene.from_json(
scene.to_json())`` (the f32 values round-trip exactly).

* :func:`torus_scene` — the teatime-class frame: 6,320 smooth-shaded
  torus triangles (teatime's count) over a 2-triangle floor, the
  two lights of the JAX package's mesh presets, 4 bounces (the
  ``ComputeConfig`` default).  At 6,322 triangles it fits the
  with-attrs resident table, so both packages take the emit-rows path.
* :func:`random_soup` — the ``_random_scene`` pattern of the fuzz
  tests (normal-distributed vertices, one white material) plus a
  camera and a light so it renders.
"""

from __future__ import annotations

import numpy as np

from rt_rs_tpu_torch.scene import Scene
from rt_rs_tpu_torch.scene.camera import CameraController, CameraUniform

# The JAX package's mesh-preset lights (rt_rs_tpu/scene/presets.py:65-68).
LIGHT_POS = ((30.0, 40.0, -20.0), (-25.0, 30.0, 25.0))
LIGHT_STRENGTH = (1.6, 1.2)


def torus_scene(
    major: float = 2.0,
    minor: float = 0.8,
    segments: tuple[int, int] = (79, 40),
    floor_y: float = -1.2,
    floor_half: float = 20.0,
) -> Scene:
    """A smooth-normal torus (axis +Y, centred on the origin) above a
    square floor, seen from (0, 3, -9) with the Orbit controller.
    ``segments = (around the axis, around the tube)`` gives
    ``2 * s0 * s1`` triangles (6,320 at the default)."""
    n_u, n_v = segments
    u = np.arange(n_u, dtype=np.float64) * (2.0 * np.pi / n_u)
    v = np.arange(n_v, dtype=np.float64) * (2.0 * np.pi / n_v)
    uu, vv = np.meshgrid(u, v, indexing="ij")  # [n_u, n_v]
    ring = major + minor * np.cos(vv)
    pos = np.stack(
        [ring * np.cos(uu), minor * np.sin(vv), ring * np.sin(uu)], axis=-1
    ).reshape(-1, 3)
    # Smooth normal: the unit vector from the tube's centre line.
    nrm = np.stack(
        [np.cos(vv) * np.cos(uu), np.sin(vv), np.cos(vv) * np.sin(uu)],
        axis=-1,
    ).reshape(-1, 3)

    i = np.arange(n_u)[:, None]
    j = np.arange(n_v)[None, :]
    i1 = (i + 1) % n_u
    j1 = (j + 1) % n_v
    a = (i * n_v + j).reshape(-1)
    b = (i1 * n_v + j).reshape(-1)
    c = (i1 * n_v + j1).reshape(-1)
    d = (i * n_v + j1).reshape(-1)
    tris = np.stack(
        [np.stack([a, b, c], 1), np.stack([a, c, d], 1)], axis=1
    ).reshape(-1, 3)

    nv = pos.shape[0]
    f = floor_half
    floor_pos = np.array(
        [[-f, floor_y, -f], [f, floor_y, -f], [f, floor_y, f], [-f, floor_y, f]]
    )
    floor_nrm = np.tile([[0.0, 1.0, 0.0]], (4, 1))
    floor_tris = nv + np.array([[0, 1, 2], [0, 2, 3]])

    scene = Scene.empty(
        camera=CameraUniform((0.0, 3.0, -9.0), (0.0, 0.0, 0.0)),
        camera_controller=CameraController("Orbit"),
    )
    scene.vert_pos = np.concatenate([pos, floor_pos]).astype(np.float32)
    scene.vert_norm = np.concatenate([nrm, floor_nrm]).astype(np.float32)
    scene.prim_indices = np.concatenate([tris, floor_tris]).astype(np.uint32)
    scene.prim_material = np.concatenate(
        [np.zeros(len(tris), np.int32), np.ones(2, np.int32)]
    )
    scene.light_pos = np.array(LIGHT_POS, dtype=np.float32)
    scene.light_strength = np.array(LIGHT_STRENGTH, dtype=np.float32)
    scene.mat_color = np.array([[0.5, 0.1, 0.1], [0.6, 0.6, 0.6]], np.float32)
    scene.mat_albedo = np.array([[0.9, 0.1, 0.3], [0.8, 0.2, 0.5]], np.float32)
    scene.mat_spec = np.array([10.0, 4.0], np.float32)
    return scene


def random_soup(seed: int, n: int, scale: float = 5.0) -> Scene:
    """``n`` independent random triangles (``_random_scene`` of the
    fuzz tests, drawn from ``numpy.random.default_rng(seed)``), viewed
    from (0, 2, -20) under one light."""
    rng = np.random.default_rng(seed)
    scene = Scene.empty(
        camera=CameraUniform((0.0, 2.0, -20.0), (0.0, 0.0, 0.0)),
        camera_controller=CameraController("Orbit"),
    )
    scene.vert_pos = rng.normal(size=(n * 3, 3), scale=scale).astype(np.float32)
    scene.vert_norm = np.tile(np.array([[0, 1, 0]], np.float32), (n * 3, 1))
    scene.prim_indices = np.arange(n * 3, dtype=np.uint32).reshape(-1, 3)
    scene.prim_material = np.zeros(n, dtype=np.int32)
    scene.light_pos = np.array([LIGHT_POS[0]], dtype=np.float32)
    scene.light_strength = np.array([LIGHT_STRENGTH[0]], dtype=np.float32)
    scene.mat_color = np.array([[1.0, 1.0, 1.0]], np.float32)
    scene.mat_albedo = np.array([[1.0, 0.0, 0.0]], np.float32)
    scene.mat_spec = np.array([1.0], np.float32)
    return scene

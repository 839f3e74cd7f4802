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
* :func:`gather_band_torus` — a 10,002-triangle torus scene: one
  table, but past the rows table's cap, so the gather branch.
* :func:`torus_row` and :func:`torus_canyon` — scenes beyond the
  resident cap built with :func:`tiled_copies`: 2 or 3 tori in a row
  (12,642 / 18,962 triangles; the teapots3 analogue) and the 8-torus,
  50,562-triangle canyon of the JAX package's segmented-path
  measurements.
* :func:`ghost_scene` and :func:`torus_ghost` — scenes with real
  ``material = -1`` prims, which block camera rays and cast no shadow
  (the flat frame path): the JAX package's 2-triangle test scene, and
  torus_scene with two ghost panels (6,326 triangles).
* :func:`random_soup` — the ``_random_scene`` pattern of the fuzz
  tests (normal-distributed vertices, one white material) plus a
  camera and a light so it renders.
* :func:`no_prims` — a camera, a light and a material but no prims:
  its frame is traced, through the unloaded pseudo-leaf, and is black.
* :func:`deep_chain` — triangles shrinking toward the origin by 2.2x
  each, so a midpoint-split BVH built with ``eps=0`` is a chain about
  one level a triangle deep: the degenerate tree whose walk needs a
  deep stack.
* :data:`MESH_VIEWS`, :func:`mesh_scene`, :func:`tiled_teapots` and
  :func:`golden_set` — the JAX package's presets over the reference's
  bundled OBJ meshes and scene JSON files, read from the directories
  the caller names.
"""

from __future__ import annotations

import numpy as np

from rt_rs_tpu_torch.scene import Scene
from rt_rs_tpu_torch.scene.camera import CameraController, CameraUniform
from rt_rs_tpu_torch.scene.obj import load_obj

# The JAX package's mesh-preset lights (rt_rs_tpu/scene/presets.py:65-68).
LIGHT_POS = ((30.0, 40.0, -20.0), (-25.0, 30.0, 25.0))
LIGHT_STRENGTH = (1.6, 1.2)


def _torus_mesh(
    major: float, minor: float, segments: tuple[int, int]
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """A smooth-normal torus (axis +Y, centred on the origin) ->
    (positions, normals, triangles); ``2 * s0 * s1`` triangles."""
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
    return pos, nrm, tris


def _add_floor(scene: Scene, floor_y: float, floor_half: float) -> Scene:
    """Append a square 2-triangle floor (material 1) to ``scene``."""
    nv = scene.vert_pos.shape[0]
    f = floor_half
    floor_pos = np.array(
        [[-f, floor_y, -f], [f, floor_y, -f], [f, floor_y, f], [-f, floor_y, f]]
    )
    floor_nrm = np.tile([[0.0, 1.0, 0.0]], (4, 1))
    floor_tris = nv + np.array([[0, 1, 2], [0, 2, 3]])
    scene.vert_pos = np.concatenate([scene.vert_pos, floor_pos]).astype(np.float32)
    scene.vert_norm = np.concatenate([scene.vert_norm, floor_nrm]).astype(np.float32)
    scene.prim_indices = np.concatenate([scene.prim_indices, floor_tris]).astype(np.uint32)
    scene.prim_material = np.concatenate(
        [scene.prim_material, np.ones(2, np.int32)]
    ).astype(np.int32)
    return scene


def _torus_only(major: float, minor: float, segments: tuple[int, int]) -> Scene:
    """The torus of :func:`torus_scene` without its floor, with its
    camera, lights and both materials (torus 0, floor 1)."""
    pos, nrm, tris = _torus_mesh(major, minor, segments)
    scene = Scene.empty(
        camera=CameraUniform((0.0, 3.0, -9.0), (0.0, 0.0, 0.0)),
        camera_controller=CameraController("Orbit"),
    )
    scene.vert_pos = pos.astype(np.float32)
    scene.vert_norm = nrm.astype(np.float32)
    scene.prim_indices = tris.astype(np.uint32)
    scene.prim_material = np.zeros(len(tris), np.int32)
    scene.light_pos = np.array(LIGHT_POS, dtype=np.float32)
    scene.light_strength = np.array(LIGHT_STRENGTH, dtype=np.float32)
    scene.mat_color = np.array([[0.5, 0.1, 0.1], [0.6, 0.6, 0.6]], np.float32)
    scene.mat_albedo = np.array([[0.9, 0.1, 0.3], [0.8, 0.2, 0.5]], np.float32)
    scene.mat_spec = np.array([10.0, 4.0], np.float32)
    return scene


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
    return _add_floor(_torus_only(major, minor, segments), floor_y, floor_half)


def gather_band_torus() -> Scene:
    """:func:`torus_scene` with a finer torus: 10,000 + 2 triangles.
    That is beyond the with-rows resident cap (8,192) but within the
    plain one (12,288), so both packages keep one table and take the
    gather branch."""
    return torus_scene(segments=(100, 50))


def tiled_copies(base: Scene, offsets) -> Scene:
    """``base``'s geometry replicated at ``offsets`` (camera, lights and
    materials carried over): the JAX package's beyond-resident scene
    recipe (``rt_rs_tpu/scene/presets.py::tiled_copies``)."""
    big = Scene.empty(camera=base.camera, camera_controller=base.camera_controller)
    big.light_pos = base.light_pos
    big.light_strength = base.light_strength
    big.mat_color = base.mat_color
    big.mat_albedo = base.mat_albedo
    big.mat_spec = base.mat_spec
    nv = base.vert_pos.shape[0]
    big.vert_pos = np.concatenate(
        [base.vert_pos + np.asarray(off, np.float32) for off in offsets]
    )
    big.vert_norm = np.concatenate([base.vert_norm] * len(offsets))
    big.prim_indices = np.concatenate(
        [base.prim_indices + i * nv for i in range(len(offsets))]
    ).astype(np.uint32)
    big.prim_material = np.concatenate([base.prim_material] * len(offsets))
    return big


def torus_row(n: int = 2, floor_y: float = -1.2, floor_half: float = 20.0) -> Scene:
    """``n`` tori of :func:`torus_scene` in a row along x, 8 apart (the
    JAX package's ``tiled_teapots`` recipe), over one floor, with
    torus_scene's camera and lights: 6,320 n + 2 triangles.  n = 2 gives
    12,642 (2 segments), n = 3 gives 18,962 (3 segments, the teapots3
    analogue)."""
    offsets = [((i - (n - 1) / 2.0) * 8.0, 0.0, 0.0) for i in range(n)]
    base = _torus_only(2.0, 0.8, (79, 40))
    return _add_floor(tiled_copies(base, offsets), floor_y, floor_half)


def torus_canyon(floor_y: float = -1.2, floor_half: float = 40.0) -> Scene:
    """The JAX package's 50K-triangle "canyon" layout
    (experiments/measure_round3.py:49-73) with tori: 8 copies of the
    torus of :func:`torus_scene` at (+-9, 0 or 7, +-9), over one floor
    (not one per copy, so the upper tori do not rest on a slab),
    8 x 6,320 + 2 = 50,562 triangles (7 segments of at most 8,192).
    torus_scene's lights and materials; the camera is pulled back to
    (0, 16, -36), looking at (0, 3, 0), so the whole canyon is in view."""
    offsets = [
        (dx * 9.0, dy * 7.0, dz * 9.0)
        for dx in (-1, 1)
        for dy in (0, 1)
        for dz in (-1, 1)
    ]
    scene = tiled_copies(_torus_only(2.0, 0.8, (79, 40)), offsets)
    scene.camera = CameraUniform((0.0, 16.0, -36.0), (0.0, 3.0, 0.0))
    return _add_floor(scene, floor_y, floor_half)


def ghost_scene(ghost_material: int) -> Scene:
    """A lit wall and a small "ghost" triangle between the light and the
    wall's centre, across part of the camera's view: the scene of the
    JAX package's negative-material tests
    (tests/test_negative_material.py:34-70).  With ``ghost_material =
    -1`` the ghost blocks camera rays but passes light; with a real
    material it shadows the wall instead."""
    scene = Scene.empty(camera=CameraUniform((0.0, 0.0, -4.0), (0.0, 0.0, 2.0)))
    scene.vert_pos = np.array(
        [
            # wall at z = 2, facing the camera (its bottom edge at -3.3,
            # off every pixel row's knife edge)
            [-4.0, -3.3, 2.0], [4.0, -3.3, 2.0], [0.3, 5.0, 2.0],
            # ghost at z = 0
            [1.5, -1.0, 0.0], [3.0, -1.0, 0.0], [2.2, 1.0, 0.0],
        ],
        dtype=np.float32,
    )
    scene.vert_norm = np.tile(np.array([[0.0, 0.0, -1.0]], np.float32), (6, 1))
    scene.prim_indices = np.array([[0, 1, 2], [3, 4, 5]], dtype=np.uint32)
    scene.prim_material = np.array([0, ghost_material], dtype=np.int32)
    scene.light_pos = np.array([[4.0, 0.0, -2.0]], dtype=np.float32)
    scene.light_strength = np.array([1.5], dtype=np.float32)
    scene.mat_color = np.array([[0.8, 0.2, 0.2], [0.2, 0.8, 0.2]], np.float32)
    scene.mat_albedo = np.array([[1.0, 0.5, 0.5], [1.0, 0.5, 0.5]], np.float32)
    scene.mat_spec = np.array([8.0, 8.0], np.float32)
    return scene


def _add_panel(scene: Scene, corners, material: int) -> Scene:
    """Append a flat quad (2 triangles, ``corners`` in order around it)
    with material ``material`` to ``scene``."""
    corners = np.asarray(corners, np.float64)
    nrm = np.cross(corners[1] - corners[0], corners[2] - corners[0])
    nrm /= np.linalg.norm(nrm)
    nv = scene.vert_pos.shape[0]
    scene.vert_pos = np.concatenate([scene.vert_pos, corners]).astype(np.float32)
    scene.vert_norm = np.concatenate([scene.vert_norm, np.tile(nrm, (4, 1))]).astype(np.float32)
    scene.prim_indices = np.concatenate(
        [scene.prim_indices, nv + np.array([[0, 1, 2], [0, 2, 3]])]
    ).astype(np.uint32)
    scene.prim_material = np.concatenate(
        [scene.prim_material, np.full(2, material, np.int32)]
    ).astype(np.int32)
    return scene


def torus_ghost() -> Scene:
    """:func:`torus_scene` with two ``material = -1`` ghost panels, 6,326
    triangles: the full-size negative-material scene.  One 8x8 panel
    stands 15 units from the torus towards the first light, out of the
    camera's view: it must cast no shadow.  One 2x3 panel stands upright
    between the camera and the torus (z = -5), over part of the view: it
    blocks the camera rays that reach it."""
    scene = torus_scene()
    to_light = np.asarray(LIGHT_POS[0], np.float64)
    to_light /= np.linalg.norm(to_light)
    u = np.cross(to_light, (0.0, 1.0, 0.0))
    u /= np.linalg.norm(u)
    v = np.cross(u, to_light)
    c = 15.0 * to_light
    shade_panel = [c - 4 * u - 4 * v, c + 4 * u - 4 * v, c + 4 * u + 4 * v, c - 4 * u + 4 * v]
    view_panel = [(0.5, -1.0, -5.0), (0.5, 2.0, -5.0), (2.5, 2.0, -5.0), (2.5, -1.0, -5.0)]
    return _add_panel(_add_panel(scene, shade_panel, -1), view_panel, -1)


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


def deep_chain(n: int = 102) -> Scene:
    """``n`` triangles ``x_k * {(1, 0, 0), (2, 0, 0), (1, 1, 0)}``
    with ``x_k = 2.2**-k`` in the plane z = 0, facing a camera at z = -3
    under one light.  Each midpoint split of their node (longest axis x)
    puts the largest triangle alone in its second child: with
    ``eps=0`` (no split stops for a small node) the BVH is a chain of
    about ``n`` levels, the smallest triangles about 1e-34 across."""
    scene = Scene.empty(
        camera=CameraUniform((0.8, 0.3, -3.0), (0.8, 0.3, 0.0)),
        camera_controller=CameraController("Orbit"),
    )
    x = 2.2 ** -np.arange(n, dtype=np.float64)
    tri = np.array([[1.0, 0.0, 0.0], [2.0, 0.0, 0.0], [1.0, 1.0, 0.0]])
    scene.vert_pos = (x[:, None, None] * tri[None]).reshape(-1, 3).astype(np.float32)
    scene.vert_norm = np.tile(np.array([[0, 0, -1]], np.float32), (3 * n, 1))
    scene.prim_indices = np.arange(3 * n, dtype=np.uint32).reshape(-1, 3)
    scene.prim_material = np.zeros(n, dtype=np.int32)
    scene.light_pos = np.array([[0.8, 2.0, -3.0]], dtype=np.float32)
    scene.light_strength = np.array([1.5], dtype=np.float32)
    scene.mat_color = np.array([[1.0, 1.0, 1.0]], np.float32)
    scene.mat_albedo = np.array([[1.0, 0.0, 0.0]], np.float32)
    scene.mat_spec = np.array([1.0], np.float32)
    return scene


def no_prims() -> Scene:
    """A scene with no prims but a camera, one light and one material,
    so that a Renderer traces its frame (black)."""
    scene = Scene.empty(camera=CameraUniform((0.0, 0.0, -4.0), (0.0, 0.0, 2.0)))
    scene.light_pos = np.array([[0.0, 2.0, -3.0]], dtype=np.float32)
    scene.light_strength = np.array([1.0], dtype=np.float32)
    scene.mat_color = np.array([[1.0, 1.0, 1.0]], np.float32)
    scene.mat_albedo = np.array([[1.0, 0.0, 0.0]], np.float32)
    scene.mat_spec = np.array([1.0], np.float32)
    return scene


# The presets below read the reference's bundled meshes and scenes
# (rt_rs_tpu/scene/presets.py:40-160).  The directories are required
# arguments: the port assumes no reference checkout on its host.

# mesh -> (camera position, bounces); the camera frames the whole model.
MESH_VIEWS = {
    "dodecahedron": ((0.0, 0.0, -6.0), 2),
    "magnolia": ((0.0, 0.0, -180.0), 2),
    "shuttle": ((0.0, 6.0, -25.0), 4),
    "cessna": ((0.0, 10.0, -60.0), 4),
}


def mesh_scene(name: str, meshes_dir: str, lights: bool = True) -> tuple[Scene, int]:
    """``meshes_dir/<name>.obj`` (a mesh of MESH_VIEWS) under two lights
    -> (scene, bounces)."""
    campos, bounces = MESH_VIEWS[name]
    scene = Scene.empty(
        camera=CameraUniform(campos, (0.0, 0.0, 0.0)),
        camera_controller=CameraController("Orbit"),
    )
    scene.mat_color = np.array([[0.5, 0.1, 0.1]], dtype=np.float32)
    scene.mat_albedo = np.array([[0.9, 0.1, 0.3]], dtype=np.float32)
    scene.mat_spec = np.array([10.0], dtype=np.float32)
    if lights:
        scene.light_pos = np.array(LIGHT_POS, dtype=np.float32)
        scene.light_strength = np.array(LIGHT_STRENGTH, dtype=np.float32)
    scene.add_mesh(load_obj(f"{meshes_dir}/{name}.obj"), 0)
    return scene, bounces


def tiled_teapots(n: int, scenes_dir: str) -> Scene:
    """``n`` copies of ``scenes_dir/teatime.json`` in a row, 8 apart:
    n = 3 gives 18,960 prims, past the resident table's 12,288, so pbvh
    takes segmented tables."""
    base = Scene.load(f"{scenes_dir}/teatime.json")
    offsets = [((i - (n - 1) / 2.0) * 8.0, 0.0, 0.0) for i in range(n)]
    return tiled_copies(base, offsets)


def golden_set(meshes_dir: str, scenes_dir: str) -> dict[str, tuple[Scene, int]]:
    """name -> (scene, bounces) for every golden of the JAX package
    beyond the two shipped JSON scenes (those load from ``scenes_dir``):
    cessna (degenerate faces: NaN normals), shuttle, the ghost scene
    (a ``material = -1`` prim: the flat path) and three teapots
    (segmented tables)."""
    return {
        "cessna": mesh_scene("cessna", meshes_dir),
        "shuttle": mesh_scene("shuttle", meshes_dir),
        "ghost": (ghost_scene(-1), 4),
        "teapots3": (tiled_teapots(3, scenes_dir), 4),
    }

"""The benchmark's scenes, built from a configuration file's numbers.

A frozen NumPy copy of the arithmetic of the port's mesh presets
(``torus_scene`` and ``torus_row``): a smooth-normal torus, copies
of it at offsets, a square two-triangle floor, lights and materials.
The benchmark hands the resulting arrays both to the program and to the
plain reference, so a later change to the program's presets cannot move
the yardstick.  Imports NumPy only.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class SceneData:
    """A scene as plain arrays: vertices [V, 3] f32, triangles [P, 3]
    u32 with one material id each [P] i32, lights [L, 3] / [L] f32,
    materials [M, 3] / [M, 3] / [M] f32, the camera's position and
    target (3 floats each)."""

    vert_pos: np.ndarray
    vert_norm: np.ndarray
    prim_indices: np.ndarray
    prim_material: np.ndarray
    light_pos: np.ndarray
    light_strength: np.ndarray
    mat_color: np.ndarray
    mat_albedo: np.ndarray
    mat_spec: np.ndarray
    camera_pos: tuple[float, float, float]
    camera_at: tuple[float, float, float]

    @property
    def num_prims(self) -> int:
        return int(self.prim_indices.shape[0])


def torus_mesh(
    major: float, minor: float, segments: tuple[int, int]
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """A smooth-normal torus (axis +Y, centred on the origin) ->
    (positions f64, normals f64, triangles int64); ``2 * s0 * s1``
    triangles."""
    n_u, n_v = segments
    u = np.arange(n_u, dtype=np.float64) * (2.0 * np.pi / n_u)
    v = np.arange(n_v, dtype=np.float64) * (2.0 * np.pi / n_v)
    uu, vv = np.meshgrid(u, v, indexing="ij")
    ring = major + minor * np.cos(vv)
    pos = np.stack([ring * np.cos(uu), minor * np.sin(vv), ring * np.sin(uu)], axis=-1).reshape(-1, 3)
    # the unit vector from the tube's centre line
    nrm = np.stack(
        [np.cos(vv) * np.cos(uu), np.sin(vv), np.cos(vv) * np.sin(uu)], axis=-1
    ).reshape(-1, 3)
    i = np.arange(n_u)[:, None]
    j = np.arange(n_v)[None, :]
    i1 = (i + 1) % n_u
    j1 = (j + 1) % n_v
    a = (i * n_v + j).reshape(-1)
    b = (i1 * n_v + j).reshape(-1)
    c = (i1 * n_v + j1).reshape(-1)
    d = (i * n_v + j1).reshape(-1)
    tris = np.stack([np.stack([a, b, c], 1), np.stack([a, c, d], 1)], axis=1).reshape(-1, 3)
    return pos, nrm, tris


def build(config: dict) -> SceneData:
    """The scene of a configuration file: its ``mesh`` (a ``torus`` of
    ``major``, ``minor`` and ``segments``), placed once or at each of
    ``copies`` (offsets), then the ``floor`` (``y``, ``half``), under
    ``lights`` with ``materials`` (torus 0, floor 1), seen by
    ``camera``."""
    t = config["mesh"]["torus"]
    pos, nrm, tris = torus_mesh(float(t["major"]), float(t["minor"]), tuple(t["segments"]))
    vert_pos = pos.astype(np.float32)
    vert_norm = nrm.astype(np.float32)
    prim_indices = tris.astype(np.uint32)
    prim_material = np.zeros(len(tris), np.int32)
    copies = config.get("copies")
    if copies is not None:
        nv = vert_pos.shape[0]
        vert_pos = np.concatenate([vert_pos + np.asarray(off, np.float32) for off in copies])
        vert_norm = np.concatenate([vert_norm] * len(copies))
        prim_indices = np.concatenate(
            [prim_indices + i * nv for i in range(len(copies))]
        ).astype(np.uint32)
        prim_material = np.concatenate([prim_material] * len(copies))

    floor_y, f = float(config["floor"]["y"]), float(config["floor"]["half"])
    nv = vert_pos.shape[0]
    floor_pos = np.array([[-f, floor_y, -f], [f, floor_y, -f], [f, floor_y, f], [-f, floor_y, f]])
    floor_nrm = np.tile([[0.0, 1.0, 0.0]], (4, 1))
    floor_tris = nv + np.array([[0, 1, 2], [0, 2, 3]])
    vert_pos = np.concatenate([vert_pos, floor_pos]).astype(np.float32)
    vert_norm = np.concatenate([vert_norm, floor_nrm]).astype(np.float32)
    prim_indices = np.concatenate([prim_indices, floor_tris]).astype(np.uint32)
    prim_material = np.concatenate([prim_material, np.ones(2, np.int32)]).astype(np.int32)

    mats = config["materials"]
    return SceneData(
        vert_pos=vert_pos,
        vert_norm=vert_norm,
        prim_indices=prim_indices,
        prim_material=prim_material,
        light_pos=np.array(config["lights"]["pos"], dtype=np.float32).reshape(-1, 3),
        light_strength=np.array(config["lights"]["strength"], dtype=np.float32),
        mat_color=np.array(mats["color"], np.float32),
        mat_albedo=np.array(mats["albedo"], np.float32),
        mat_spec=np.array(mats["spec"], np.float32),
        camera_pos=tuple(float(x) for x in config["camera"]["pos"]),
        camera_at=tuple(float(x) for x in config["camera"]["at"]),
    )

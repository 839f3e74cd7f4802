"""Scene data model, JSON serde and device packing.

Counterpart of ``rt_rs_tpu/scene/__init__.py`` (reference:
``src/lib/scene/mod.rs:16-272``): the same JSON schema (``camera``,
``camera_controller``, ``prims``, ``vertices``, ``lights``,
``materials``) and the same NumPy arrays, so a scene written by either
package loads unchanged in the other.  :meth:`Scene.pack` places the
:class:`SceneArrays` on an explicit torch device.  :meth:`Scene.add_mesh`
imports an OBJ mesh (``src/lib/scene/mod.rs:274-343``) and
:meth:`Scene.unloaded` is the reference's ``Scene::Unloaded``
placeholder.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Mapping

import numpy as np
import torch

from rt_rs_tpu_torch.geom import (
    Light,
    Prim,
    PrimMat,
    PrimVertex,
    SceneFormatError,
    f32_json,
)
from rt_rs_tpu_torch.scene.camera import CameraController, CameraUniform
from rt_rs_tpu_torch.scene.obj import ObjMesh


@dataclasses.dataclass
class Scene:
    """An in-memory scene; numpy-backed for fast build/IO."""

    camera: CameraUniform
    camera_controller: CameraController
    # [P, 3] uint32 vertex indices / [P] int32 material ids (no null prim here)
    prim_indices: np.ndarray
    prim_material: np.ndarray
    # [V, 3] float32
    vert_pos: np.ndarray
    vert_norm: np.ndarray
    # [L, 3] / [L]
    light_pos: np.ndarray
    light_strength: np.ndarray
    # [M, 3] / [M, 3] / [M]
    mat_color: np.ndarray
    mat_albedo: np.ndarray
    mat_spec: np.ndarray
    # The reference's ``Scene::Unloaded`` variant
    # (``src/lib/scene/mod.rs:16-27``): the placeholder IS a scene
    # (:meth:`unloaded`) and this flag marks it; serializing it is an
    # error, like the reference's ``unreachable!``.
    is_unloaded: bool = False

    @classmethod
    def empty(
        cls,
        camera: CameraUniform | None = None,
        camera_controller: CameraController | None = None,
    ) -> "Scene":
        return cls(
            camera=camera or CameraUniform((0.0, 0.0, 0.0), (0.0, 0.0, 0.0)),
            camera_controller=camera_controller or CameraController("Fixed"),
            prim_indices=np.zeros((0, 3), dtype=np.uint32),
            prim_material=np.zeros((0,), dtype=np.int32),
            vert_pos=np.zeros((0, 3), dtype=np.float32),
            vert_norm=np.zeros((0, 3), dtype=np.float32),
            light_pos=np.zeros((0, 3), dtype=np.float32),
            light_strength=np.zeros((0,), dtype=np.float32),
            mat_color=np.zeros((0, 3), dtype=np.float32),
            mat_albedo=np.zeros((0, 3), dtype=np.float32),
            mat_spec=np.zeros((0,), dtype=np.float32),
        )

    @classmethod
    def unloaded(cls) -> "Scene":
        """The ``Scene::pack_unloaded`` placeholder
        (``src/lib/scene/mod.rs:115-131``): one degenerate prim over a
        single zero vertex, one zero-strength light, one zero material.
        It renders black, never errors, and carries ``is_unloaded=True``
        so viewers know no real scene is loaded yet."""
        scene = cls.empty()
        scene.prim_indices = np.zeros((1, 3), dtype=np.uint32)
        scene.prim_material = np.zeros((1,), dtype=np.int32)
        scene.vert_pos = np.zeros((1, 3), dtype=np.float32)
        scene.vert_norm = np.zeros((1, 3), dtype=np.float32)
        scene.light_pos = np.zeros((1, 3), dtype=np.float32)
        scene.light_strength = np.zeros((1,), dtype=np.float32)
        scene.mat_color = np.zeros((1, 3), dtype=np.float32)
        scene.mat_albedo = np.zeros((1, 3), dtype=np.float32)
        scene.mat_spec = np.zeros((1,), dtype=np.float32)
        scene.is_unloaded = True
        return scene

    @property
    def num_prims(self) -> int:
        return int(self.prim_indices.shape[0])

    @property
    def num_vertices(self) -> int:
        return int(self.vert_pos.shape[0])

    # ------------------------------------------------------------------
    # JSON serde (reference schema, scene/mod.rs:29-109)

    @classmethod
    def from_json(cls, data: Mapping[str, Any]) -> "Scene":
        try:
            camera = CameraUniform.from_json(data["camera"])
            controller = CameraController.from_json(data["camera_controller"])
            prims = [Prim.from_json(p) for p in data["prims"]]
            vertices = [PrimVertex.from_json(v) for v in data["vertices"]]
            lights = [Light.from_json(l) for l in data["lights"]]
            materials = [PrimMat.from_json(m) for m in data["materials"]]
        except KeyError as e:
            raise SceneFormatError(f"scene JSON missing field {e}") from e

        scene = cls.empty(camera, controller)
        if prims:
            scene.prim_indices = np.array(
                [p.indices for p in prims], dtype=np.uint32
            )
            scene.prim_material = np.array(
                [p.material for p in prims], dtype=np.int32
            )
        if vertices:
            scene.vert_pos = np.array([v.pos for v in vertices], dtype=np.float32)
            scene.vert_norm = np.array([v.normal for v in vertices], dtype=np.float32)
        if lights:
            scene.light_pos = np.array([l.pos for l in lights], dtype=np.float32)
            scene.light_strength = np.array(
                [l.strength for l in lights], dtype=np.float32
            )
        if materials:
            scene.mat_color = np.array([m.color for m in materials], dtype=np.float32)
            scene.mat_albedo = np.array([m.albedo for m in materials], dtype=np.float32)
            scene.mat_spec = np.array([m.spec for m in materials], dtype=np.float32)
        return scene

    def to_json(self) -> dict[str, Any]:
        if self.is_unloaded:
            # unreachable!() in the reference (scene/mod.rs:88).
            raise SceneFormatError("cannot serialize an unloaded scene")
        return {
            "camera": self.camera.to_json(),
            "camera_controller": self.camera_controller.to_json(),
            "prims": [
                {
                    "indices": [int(i) for i in self.prim_indices[p]],
                    "material": int(self.prim_material[p]),
                }
                for p in range(self.num_prims)
            ],
            "vertices": [
                {
                    "pos": [f32_json(x) for x in self.vert_pos[v]],
                    "normal": [f32_json(x) for x in self.vert_norm[v]],
                }
                for v in range(self.num_vertices)
            ],
            "lights": [
                {
                    "pos": [f32_json(x) for x in self.light_pos[l]],
                    "strength": f32_json(self.light_strength[l]),
                }
                for l in range(self.light_pos.shape[0])
            ],
            "materials": [
                {
                    "color": [f32_json(x) for x in self.mat_color[m]],
                    "albedo": [f32_json(x) for x in self.mat_albedo[m]],
                    "spec": f32_json(self.mat_spec[m]),
                }
                for m in range(self.mat_color.shape[0])
            ],
        }

    @classmethod
    def load(cls, path: str) -> "Scene":
        with open(path, "r") as f:
            return cls.from_json(json.load(f))

    def save(self, path: str, pretty: bool = True) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=2 if pretty else None)

    # ------------------------------------------------------------------
    # OBJ import (scene/mod.rs:274-343)

    def add_mesh(self, obj: ObjMesh, material: int) -> None:
        """Append an OBJ mesh (reference ``add_mesh`` semantics).

        Missing per-corner OBJ normals are synthesized as angle-weighted
        face-normal sums, renormalized per position
        (``scene/mod.rs:288-338``); supplied OBJ normals are accumulated
        unscaled, exactly like the reference.  All arithmetic is f32 in
        the reference's operation order, as in the JAX package, so both
        packages produce the same vertex and normal bits."""
        base = self.num_vertices
        positions = obj.positions.astype(np.float32)  # [Vp, 3]
        npos = positions.shape[0]
        acc: list[list[np.ndarray]] = [[] for _ in range(npos)]

        f32 = np.float32

        def dot(a, b):
            # V3Ops::dot fold order (v3.rs:45-50): ((0+x)+y)+z in f32.
            return f32(f32(f32(f32(0.0) + a[0] * b[0]) + a[1] * b[1]) + a[2] * b[2])

        def mag(v):
            return f32(np.sqrt(dot(v, v)))

        def cross(a, b):
            return np.array(
                [
                    a[1] * b[2] - a[2] * b[1],
                    a[2] * b[0] - a[0] * b[2],
                    a[0] * b[1] - a[1] * b[0],
                ],
                dtype=np.float32,
            )

        def normalize(v):
            m = mag(v)
            return np.array([v[0] / m, v[1] / m, v[2] / m], dtype=np.float32)

        def angle(at, fst, snd):
            # V3Ops::angle (v3.rs:74-79), f32 ops, no clamping: a
            # degenerate corner yields NaN exactly like Rust's acos.
            ab = fst - at
            ac = snd - at
            with np.errstate(invalid="ignore"):
                return f32(np.arccos(f32(dot(ab, ac) / f32(mag(ab) * mag(ac)))))

        new_prims: list[tuple[int, int, int]] = []
        for (ia, ib, ic), (na, nb, nc) in obj.triangles():
            pa, pb, pc = positions[ia], positions[ib], positions[ic]
            fn = normalize(cross(pb - pa, pc - pa))
            for idx, given, corner_angle in (
                (ia, na, lambda: angle(pa, pb, pc)),
                (ib, nb, lambda: angle(pb, pc, pa)),
                (ic, nc, lambda: angle(pc, pa, pb)),
            ):
                if given is not None:
                    acc[idx].append(np.asarray(given, dtype=np.float32))
                else:
                    acc[idx].append(fn * corner_angle())
            new_prims.append((base + ia, base + ib, base + ic))

        normals = np.zeros((npos, 3), dtype=np.float32)
        for i, parts in enumerate(acc):
            # fold(add) then normalize (scene/mod.rs:330-332), f32.
            n = np.zeros(3, dtype=np.float32)
            for p in parts:
                n = n + p
            m = mag(n)
            normals[i] = (
                np.array([n[0] / m, n[1] / m, n[2] / m], dtype=np.float32) if m > 0 else n
            )

        self.vert_pos = np.concatenate([self.vert_pos, positions], axis=0)
        self.vert_norm = np.concatenate([self.vert_norm, normals], axis=0)
        if new_prims:
            self.prim_indices = np.concatenate(
                [self.prim_indices, np.array(new_prims, dtype=np.uint32)], axis=0
            )
            self.prim_material = np.concatenate(
                [
                    self.prim_material,
                    np.full((len(new_prims),), material, dtype=np.int32),
                ],
                axis=0,
            )

    # ------------------------------------------------------------------
    # Device packing

    def pack(self, *, device: str | torch.device) -> "SceneArrays":
        """The scene's device arrays, on ``device`` (no default: the
        port's entry points run on the card unless asked otherwise)."""
        from rt_rs_tpu_torch.scene.arrays import SceneArrays

        return SceneArrays.from_scene(self, device)


__all__ = ["Scene", "SceneFormatError"]

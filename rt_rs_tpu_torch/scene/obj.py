"""Wavefront OBJ parsing.

Counterpart of ``rt_rs_tpu/scene/obj.py`` (reference: the Rust
``wavefront`` crate, ``src/tools/construct.rs:175``,
``src/lib/scene/mod.rs:291-299``): a unique position list, per-corner
optional normals, and fan triangulation of polygonal faces.  This is the
JAX package's pure-Python parser, its correctness oracle, and the
native C++ parser (:mod:`rt_rs_tpu_torch.native`), which ``load_obj``
takes unless ``RT_NATIVE=0``.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass
class ObjMesh:
    positions: np.ndarray  # [V, 3] float64
    normals: np.ndarray  # [N, 3] float64 (may be empty)
    # faces: list of list of (position_index, normal_index|-1)
    faces: list[list[tuple[int, int]]]

    def triangles(
        self,
    ) -> Iterator[tuple[tuple[int, int, int], tuple]]:
        """Yield fan-triangulated faces.

        Each item is ``((ia, ib, ic), (na, nb, nc))`` where the second
        triple holds per-corner normal vectors (``np.ndarray``) or
        ``None`` when the face corner has no OBJ normal.
        """
        for face in self.faces:
            if len(face) < 3:
                continue
            for k in range(1, len(face) - 1):
                corners = (face[0], face[k], face[k + 1])
                idx = tuple(c[0] for c in corners)
                nrm = tuple(
                    self.normals[c[1]] if c[1] >= 0 else None for c in corners
                )
                yield idx, nrm


def _parse_index(token: str, count: int) -> int:
    """OBJ 1-based index (negative = from end) -> 0-based."""
    i = int(token)
    return i - 1 if i > 0 else count + i


def load_obj(path: str) -> ObjMesh:
    """Parse an OBJ file with the native C++ parser (identical output;
    built at first use, and a failed build raises); ``RT_NATIVE=0``
    selects :func:`_load_obj_py`.  The native mesh lists the faces
    already fan-triangulated, so :meth:`ObjMesh.triangles` yields the
    same triangles from either."""
    from rt_rs_tpu_torch.native import bindings

    if bindings.available():
        pos, norm, tri_pos, tri_norm = bindings.obj_load_native(path)
        faces = [
            [(int(tri_pos[t, k]), int(tri_norm[t, k])) for k in range(3)]
            for t in range(tri_pos.shape[0])
        ]
        return ObjMesh(positions=pos, normals=norm, faces=faces)
    return _load_obj_py(path)


def _load_obj_py(path: str) -> ObjMesh:
    """The Python parser, the oracle.

    Values parse text -> f64 here and ``Scene.add_mesh`` rounds them to
    f32 (the reference parses text -> f32 directly): the two differ only
    for a decimal of ~16+ significant digits that lands on an f32 tie,
    as in the JAX package."""
    positions: list[list[float]] = []
    normals: list[list[float]] = []
    faces: list[list[tuple[int, int]]] = []

    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            tag = parts[0]
            if tag == "v":
                positions.append([float(x) for x in parts[1:4]])
            elif tag == "vn":
                normals.append([float(x) for x in parts[1:4]])
            elif tag == "f":
                face: list[tuple[int, int]] = []
                for corner in parts[1:]:
                    comps = corner.split("/")
                    vi = _parse_index(comps[0], len(positions))
                    ni = -1
                    if len(comps) >= 3 and comps[2]:
                        ni = _parse_index(comps[2], len(normals))
                    face.append((vi, ni))
                faces.append(face)

    return ObjMesh(
        positions=np.array(positions, dtype=np.float64).reshape(-1, 3),
        normals=np.array(normals, dtype=np.float64).reshape(-1, 3),
        faces=faces,
    )

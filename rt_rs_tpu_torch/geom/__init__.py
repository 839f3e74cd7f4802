"""Geometry data model.

Host-side (NumPy) counterparts of the reference's GPU POD structs
(``src/lib/geom/mod.rs``): triangles are index triples plus a material
id, vertices carry position + normal, materials carry color/albedo/spec.
Instead of 16/32-byte padded C structs uploaded to storage buffers, the
device layout is structure-of-arrays torch tensors (see
``rt_rs_tpu_torch.scene.Scene.pack``).

JSON (de)serialization keeps the reference's validation semantics: any
vector field must have exactly 3 components
(``src/lib/geom/mod.rs:27-42`` raises ``invalid_length`` otherwise).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Sequence

from rt_rs_tpu_torch.geom import v3  # re-export module  # noqa: F401


class SceneFormatError(ValueError):
    """Raised when scene JSON violates the reference schema."""


def f32_json(v) -> float:
    """Shortest-roundtrip f32 value for JSON output.

    The reference serializes f32 fields with serde_json's
    shortest-roundtrip formatting ("0.1", not "0.10000000149011612");
    emitting the f64 widening of the f32 would change the text (same
    value).  Going through numpy's unique positional repr reproduces
    the shortest form.
    """
    import numpy as np

    return float(np.format_float_positional(np.float32(v), unique=True))


def _vec3(values: Any, what: str) -> tuple[float, float, float]:
    if not isinstance(values, Sequence) or len(values) != 3:
        raise SceneFormatError(
            f"{what}: expected an array of len 3, got {values!r}"
        )
    return (float(values[0]), float(values[1]), float(values[2]))


@dataclasses.dataclass(frozen=True)
class Prim:
    """A triangle: vertex indices + material id (geom/mod.rs:10-13).

    ``material == -1`` marks the null/miss sentinel primitive the
    renderer prepends at index 0 (``src/lib/scene/mod.rs:161-166``).
    """

    indices: tuple[int, int, int]
    material: int

    @classmethod
    def from_json(cls, data: Mapping[str, Any]) -> "Prim":
        idx = data["indices"]
        if not isinstance(idx, Sequence) or len(idx) != 3:
            raise SceneFormatError(
                f"prim indices: expected an array of len 3, got {idx!r}"
            )
        return cls(
            indices=(int(idx[0]), int(idx[1]), int(idx[2])),
            material=int(data["material"]),
        )

    def to_json(self) -> dict[str, Any]:
        return {"indices": list(self.indices), "material": self.material}


@dataclasses.dataclass(frozen=True)
class PrimVertex:
    """Vertex position + normal (geom/mod.rs:56-63)."""

    pos: tuple[float, float, float]
    normal: tuple[float, float, float]

    @classmethod
    def from_json(cls, data: Mapping[str, Any]) -> "PrimVertex":
        return cls(
            pos=_vec3(data["pos"], "vertex pos"),
            normal=_vec3(data["normal"], "vertex normal"),
        )

    def to_json(self) -> dict[str, Any]:
        return {"pos": list(self.pos), "normal": list(self.normal)}


@dataclasses.dataclass(frozen=True)
class PrimMat:
    """Material: color, albedo (diffuse/spec/bounce weights), spec power
    (geom/mod.rs:131-137)."""

    color: tuple[float, float, float]
    albedo: tuple[float, float, float]
    spec: float

    @classmethod
    def from_json(cls, data: Mapping[str, Any]) -> "PrimMat":
        return cls(
            color=_vec3(data["color"], "material color"),
            albedo=_vec3(data["albedo"], "material albedo"),
            spec=float(data["spec"]),
        )

    def to_json(self) -> dict[str, Any]:
        return {
            "color": list(self.color),
            "albedo": list(self.albedo),
            "spec": self.spec,
        }


@dataclasses.dataclass(frozen=True)
class Light:
    """Point light (geom/light.rs:6-9)."""

    pos: tuple[float, float, float]
    strength: float

    @classmethod
    def from_json(cls, data: Mapping[str, Any]) -> "Light":
        return cls(pos=_vec3(data["pos"], "light pos"), strength=float(data["strength"]))

    def to_json(self) -> dict[str, Any]:
        return {"pos": list(self.pos), "strength": self.strength}


__all__ = [
    "SceneFormatError",
    "Prim",
    "PrimVertex",
    "PrimMat",
    "Light",
    "v3",
]

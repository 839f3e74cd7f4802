"""Camera model and controllers.

Parity targets:

* ``CameraUniform`` — the 24-byte pos/at uniform
  (``src/lib/scene/camera.rs:8-15``), here a plain dataclass whose
  values feed the frame step as two f32 vec3 tensors.
* ``CameraController`` — ``Fixed`` / ``Orbit`` with the reference's
  orbit integration: ``theta = atan2(z, x) + 0.0314 * SPEED * dt`` about
  the +Y axis through ``at`` (``src/lib/scene/camera.rs:168-204``,
  ``SPEED = 0.1``).

The pinhole ray generation lives in :mod:`rt_rs_tpu_torch.ops.shade`
(``camera_ray``), matching ``src/lib/shaders/compute.wgsl:103-118``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping

import torch

from rt_rs_tpu_torch.geom import SceneFormatError, _vec3, f32_json

ORBIT_SPEED = 0.1  # camera.rs:171
ORBIT_RATE = 0.0314  # camera.rs:181


@dataclasses.dataclass(frozen=True)
class CameraUniform:
    pos: tuple[float, float, float]
    at: tuple[float, float, float]

    @classmethod
    def from_json(cls, data: Mapping[str, Any]) -> "CameraUniform":
        return cls(pos=_vec3(data["pos"], "camera pos"), at=_vec3(data["at"], "camera at"))

    def to_json(self) -> dict[str, Any]:
        # f32-exact floats — the ONE serialization form (Scene.to_json
        # delegates here; the round-trip invariants require f32_json).
        return {
            "pos": [f32_json(x) for x in self.pos],
            "at": [f32_json(x) for x in self.at],
        }

    def orbited(self, mult: float) -> "CameraUniform":
        """One orbit step (reference ``orbit``, camera.rs:177-189).

        Rotates ``pos`` about the vertical axis through ``at`` by
        ``ORBIT_RATE * mult`` radians; ``mult`` is signed
        (left = +, right = -) and already includes ``SPEED * dt``.
        """
        x = self.pos[0] - self.at[0]
        z = self.pos[2] - self.at[2]
        theta = math.atan2(z, x) + ORBIT_RATE * mult
        r = math.sqrt(x * x + z * z)
        return CameraUniform(
            pos=(
                self.at[0] + r * math.cos(theta),
                self.pos[1],
                self.at[2] + r * math.sin(theta),
            ),
            at=self.at,
        )


def orbit_f32(pos: torch.Tensor, at: torch.Tensor, mult: torch.Tensor) -> torch.Tensor:
    """:meth:`CameraUniform.orbited` in f32 on ``pos`` / ``at`` [3] and
    ``mult`` [] float32 tensors -> the new position [3], in the JAX
    package's op order (``_orbit_f32``, rt_rs_tpu/renderer.py:68-80):
    ``atan2``, ``+ ORBIT_RATE * mult``, ``sqrt(x*x + z*z)``, ``cos``,
    ``sin``.  ``Renderer.animate(chain=)`` advances the orbit with it
    between the frames of one dispatch, on the device."""
    x = pos[0] - at[0]
    z = pos[2] - at[2]
    theta = torch.atan2(z, x) + ORBIT_RATE * mult
    r = torch.sqrt(x * x + z * z)
    return torch.stack([at[0] + r * torch.cos(theta), pos[1], at[2] + r * torch.sin(theta)])


@dataclasses.dataclass
class CameraController:
    """``Fixed`` or ``Orbit { left, right }`` (camera.rs:78-83).

    ``update`` mirrors ``CameraController::update`` (camera.rs:168-204):
    returns the new uniform when an orbit key is held, else ``None``.
    """

    kind: str = "Fixed"  # "Fixed" | "Orbit"
    left: bool = False
    right: bool = False

    @classmethod
    def from_json(cls, data: Any) -> "CameraController":
        if data == "Fixed":
            return cls(kind="Fixed")
        if data == "Orbit":
            return cls(kind="Orbit")
        raise SceneFormatError(f"unknown camera controller {data!r}")

    def to_json(self) -> str:
        return self.kind

    def handle_key(self, key: str, pressed: bool) -> bool:
        if self.kind != "Orbit":
            return False
        if key == "left":
            self.left = pressed
            return True
        if key == "right":
            self.right = pressed
            return True
        return False

    def update(self, uniform: CameraUniform, dt: float) -> CameraUniform | None:
        if self.kind != "Orbit":
            return None
        if self.left:
            return uniform.orbited(ORBIT_SPEED * dt)
        if self.right:
            return uniform.orbited(-1.0 * ORBIT_SPEED * dt)
        return None

"""Run/compute configuration.

Mirrors the reference config layer (``src/lib/mod.rs:56-166``): the same
field names, defaults and JSON shapes, so config JSON written for the
reference loads unchanged.  ``ComputeConfig`` is the payload the
reference uploads verbatim as the group(1) uniform
(``src/lib/mod.rs:115-139``); here it is a frozen dataclass the frame
path reads (``bounces`` sets the length of the bounce loop).

Copied unchanged from ``rt_rs_tpu/config.py`` so configs load the same
in both packages.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping


@dataclasses.dataclass(frozen=True)
class ComputeConfig:
    """Shader-visible options (reference: ``src/lib/mod.rs:115-139``).

    ``ambience`` is carried for config parity but — exactly like the
    reference shader — never used by the lighting model
    (``src/lib/shaders/compute.wgsl:29-30`` declares it; nothing reads
    it).
    """

    t_min: float = 0.01
    t_max: float = 1000.0
    camera_light_source: float = 0.0
    bounces: int = 4
    eps: float = 0.0000001
    ambience: float = 0.1

    @classmethod
    def from_json(cls, data: Mapping[str, Any] | None) -> "ComputeConfig":
        data = dict(data or {})
        defaults = cls()
        return cls(
            t_min=float(data.get("t_min", defaults.t_min)),
            t_max=float(data.get("t_max", defaults.t_max)),
            camera_light_source=float(
                data.get("camera_light_source", defaults.camera_light_source)
            ),
            bounces=int(data.get("bounces", defaults.bounces)),
            eps=float(data.get("eps", defaults.eps)),
            ambience=float(data.get("ambience", defaults.ambience)),
        )


@dataclasses.dataclass(frozen=True)
class Resolution:
    """Render-target resolution.

    The reference's untagged enum ``Dynamic(wg) | Sized(w,h) |
    Fixed{size, wg}`` (``src/lib/mod.rs:56-77``) collapses here to an
    optional size plus the parsed ``wg`` value.  The reference's
    workgroup size picks the pixel tile a GPU workgroup covers
    (``src/lib/mod.rs:79-105``); the packet analogue is the pixel-block
    shape a ray tile covers (``shade.camera_rays(block=)``)
    — :meth:`block` maps ``wg_hint`` to it (wg x (128/wg) pixels, so
    the default wg=16 gives the measured-best 8x16; PERF.md).
    """

    width: int | None = None
    height: int | None = None
    wg_hint: int | None = 16

    @classmethod
    def dynamic(cls, wg: int = 16) -> "Resolution":
        return cls(width=None, height=None, wg_hint=wg)

    @classmethod
    def sized(cls, width: int, height: int) -> "Resolution":
        return cls(width=width, height=height, wg_hint=None)

    @classmethod
    def fixed(cls, width: int, height: int, wg: int) -> "Resolution":
        return cls(width=width, height=height, wg_hint=wg)

    @classmethod
    def from_json(cls, data: Any) -> "Resolution":
        """Parse the reference's untagged ``Resolution`` JSON forms."""
        if data is None:
            return cls()
        if isinstance(data, (int, float)):  # Dynamic(wg)
            return cls.dynamic(int(data))
        if isinstance(data, Mapping):
            if "size" in data:  # Fixed { size, wg }
                size = data["size"]
                return cls.fixed(int(size["width"]), int(size["height"]), int(data["wg"]))
            if "width" in data:  # Sized(PhysicalSize)
                return cls.sized(int(data["width"]), int(data["height"]))
        raise ValueError(f"unrecognized resolution JSON: {data!r}")

    def size(self, fallback: tuple[int, int] = (640, 480)) -> tuple[int, int]:
        if self.width is None or self.height is None:
            return fallback
        return (self.width, self.height)

    def wg(self) -> int:
        """The reference's workgroup-size selection
        (``Resolution::wg()``, ``src/lib/mod.rs:79-105``): Dynamic/Fixed
        carry an explicit ``wg``; Sized derives it as ``gcd(width,
        height)``; any result with ``wg * wg > 256`` (the WebGPU
        workgroup ceiling) collapses to 16."""
        import math

        if self.wg_hint is not None:
            dim = int(self.wg_hint)
        elif self.width is not None and self.height is not None:
            dim = math.gcd(int(self.width), int(self.height))  # Sized
        else:
            dim = 16
        return 16 if dim * dim > 256 else dim

    def block(self, lanes: int = 128) -> tuple[int, int]:
        """Packet pixel-block shape ``(bh, bw)`` from :meth:`wg`:
        ``bw = clamp(wg, 1..lanes)`` pixels wide, ``lanes/bw`` tall —
        one ``lanes``-ray packet tile per block (the ``Resolution::wg()``
        analogue; consumed by ``Renderer``)."""
        bw = max(1, min(self.wg(), lanes))
        while lanes % bw:  # keep bh * bw == lanes exact
            bw -= 1
        return (lanes // bw, bw)


@dataclasses.dataclass(frozen=True)
class Config:
    """Top-level run config (reference: ``src/lib/mod.rs:141-166``)."""

    compute: ComputeConfig = dataclasses.field(default_factory=ComputeConfig)
    resolution: Resolution = dataclasses.field(default_factory=Resolution)
    fps: int = 60

    @classmethod
    def from_json(cls, data: Mapping[str, Any] | None) -> "Config":
        data = dict(data or {})
        return cls(
            compute=ComputeConfig.from_json(data.get("compute")),
            resolution=Resolution.from_json(data.get("resolution")),
            fps=int(data.get("fps", 60)),
        )

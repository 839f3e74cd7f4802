"""Acceleration-structure backend protocol.

Counterpart of ``rt_rs_tpu/handlers/base.py`` (reference: the
``IntrsHandler`` trait, ``src/lib/handlers/mod.rs:52-67``).  A handler
builds its device tensors from the packed scene (and may permute the
scene's prims into its leaf order), then hands the frame paths their
intersect callables: the flat contract of
:func:`rt_rs_tpu_torch.ops.shade.trace` and the tiled one of
:func:`rt_rs_tpu_torch.ops.shade.trace_tiled`.
"""

from __future__ import annotations

import abc
import dataclasses
from typing import Any

import torch

from rt_rs_tpu_torch.config import ComputeConfig
from rt_rs_tpu_torch.ops.packet_trace import flat_call
from rt_rs_tpu_torch.scene import Scene
from rt_rs_tpu_torch.scene.arrays import SceneArrays


@dataclasses.dataclass(frozen=True)
class IntrsStats:
    """Handler name + acceleration-structure byte footprint
    (``src/lib/handlers/mod.rs:47-50``)."""

    name: str
    size: int


class IntrsHandler(abc.ABC):
    """One acceleration backend."""

    name: str = "?"
    block_lanes: int = 128  # rays per ray tile; one pixel block each

    @abc.abstractmethod
    def build(self, scene: Scene, arrays: SceneArrays) -> tuple[Any, SceneArrays]:
        """Build the device structures on ``arrays.device`` -> ``(accel,
        arrays)``, where ``arrays`` is the (possibly leaf-reordered)
        scene to shade with."""

    @abc.abstractmethod
    def stats(self, accel: Any) -> IntrsStats:
        ...

    @abc.abstractmethod
    def intersect_fn(self, accel: Any, arrays: SceneArrays, cfg: ComputeConfig):
        """Closest hit over a flat batch of rays: ``(o [N, 3], d [N, 3],
        excl [N] int32, valid [N] bool or None, *, t_cap=None [N]) ->
        (t [N], pid [N] int32)``; outputs are specified for valid rays,
        and ``t_cap`` only narrows culling."""

    def intersect_tiled_fn(self, accel: Any, arrays: SceneArrays, cfg: ComputeConfig):
        """Closest hit over component-major ray tiles: ``(payload
        [8, T, r], valid [T, r], t_cap=None) -> (t [T, r], pid [T, r])``
        (payload row 6 is the f32 exclusion id).

        Backends with a native tiled entry override this; the default
        adapts :meth:`intersect_fn` with one relayout per call."""
        aos = self.intersect_fn(accel, arrays, cfg)

        def tiled(payload, valid, t_cap=None):
            t_tiles, r = valid.shape
            o = payload[0:3].permute(1, 2, 0).reshape(-1, 3)
            d = payload[3:6].permute(1, 2, 0).reshape(-1, 3)
            excl = payload[6].reshape(-1).to(torch.int32)
            cap = None if t_cap is None else t_cap.reshape(-1)
            t, pid = aos(o, d, excl, valid.reshape(-1), t_cap=cap)
            return t.reshape(t_tiles, r), pid.reshape(t_tiles, r)

        return tiled

    def intersect_tiled_rows_fn(self, accel: Any, arrays: SceneArrays, cfg: ComputeConfig):
        """Closest hit that also emits the winners' shade-table rows:
        ``(payload, valid, t_cap=None) -> (t, pid, rows [32, T, r])``.
        ``None`` (default) = unsupported.  A frame takes the emit branch
        where it is offered, but calls the closest-hit entry: the
        shading kernels read each hit's row from the shade table."""
        return None

    def intersect_tiled_anyhit_fn(self, accel: Any, arrays: SceneArrays, cfg: ComputeConfig):
        """Occlusion only: ``(payload, valid, t_cap=None) -> blocked
        [T, r] bool``, True iff some prim other than the exclusion lies
        in ``(t_min, payload row 7)``.  ``None`` (default) =
        unsupported."""
        return None

    def rows_default(self, accel: Any, n_pixels: int) -> bool:
        """Whether a frame takes the kernel-emitted-rows branch: the JAX
        package's default for resident tables at every size."""
        return True


def tiled_as_flat(tiled_fn, ray_tile: int):
    """A tiled closest-hit entry as an :meth:`IntrsHandler.intersect_fn`
    (the JAX package's ``packet_closest_hit`` layout,
    :func:`rt_rs_tpu_torch.ops.packet_trace.flat_call`)."""

    def flat(o, d, excl, valid=None, *, t_cap=None):
        return flat_call(tiled_fn, ray_tile, o, d, excl, valid, t_cap)

    return flat

"""The no-op backend: every ray misses.

Counterpart of ``rt_rs_tpu/handlers/blank.py`` (``BlankIntrs``,
``src/lib/handlers/blank.rs``): it measures the fixed cost of
everything around intersection, the study's overhead baseline
(pdf §4.2.1).  Its tiled entry is native (constant misses in the tiled
layout), so a frame through it times the frame pipeline alone, without
the flat adapter's relayout that no real backend pays.
"""

from __future__ import annotations

from typing import Any

import torch

from rt_rs_tpu_torch.config import ComputeConfig
from rt_rs_tpu_torch.handlers.base import IntrsHandler, IntrsStats
from rt_rs_tpu_torch.scene import Scene
from rt_rs_tpu_torch.scene.arrays import SceneArrays


def _misses(shape, cfg: ComputeConfig, device) -> tuple[torch.Tensor, torch.Tensor]:
    return (
        torch.full(shape, cfg.t_max + 1.0, dtype=torch.float32, device=device),
        torch.zeros(shape, dtype=torch.int32, device=device),
    )


class BlankIntrs(IntrsHandler):
    name = "Blank"

    def build(self, scene: Scene, arrays: SceneArrays):
        return None, arrays

    def stats(self, accel: Any) -> IntrsStats:
        return IntrsStats(name="Blank", size=0)

    def intersect_fn(self, accel, arrays: SceneArrays, cfg: ComputeConfig):
        def intersect(o, d, excl, valid=None, t_cap=None):
            return _misses((o.shape[0],), cfg, o.device)

        return intersect

    def intersect_tiled_fn(self, accel, arrays: SceneArrays, cfg: ComputeConfig):
        def tiled(payload, valid, t_cap=None):
            return _misses(tuple(valid.shape), cfg, payload.device)

        return tiled

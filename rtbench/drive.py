"""The benchmark's side of the program: build ``rt_rs_tpu_torch.Renderer``
from the benchmark's arrays, warm it up, and drive its window.

The only module of the benchmark that imports the program, with the
traffic kinds' loops (``rtbench/traffic/<kind>.py``) that it calls.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from rtbench import sampling, spec
from rtbench import trace as tr
from rtbench.reference import orbit_camera

SCENE_FIELDS = (
    "vert_pos", "vert_norm", "prim_indices", "prim_material", "light_pos",
    "light_strength", "mat_color", "mat_albedo", "mat_spec",
)


def make_renderer(scene, config: dict, width: int, height: int, device: str):
    """``Renderer(scene, device=device)`` at the program's defaults,
    given the configuration's compute numbers and handler, over the
    benchmark's arrays."""
    from rt_rs_tpu_torch.config import ComputeConfig, Config
    from rt_rs_tpu_torch.renderer import Renderer
    from rt_rs_tpu_torch.scene import Scene
    from rt_rs_tpu_torch.scene.camera import CameraController, CameraUniform

    s = Scene.empty(
        camera=CameraUniform(scene.camera_pos, scene.camera_at),
        camera_controller=CameraController("Orbit"),
    )
    for f in SCENE_FIELDS:
        setattr(s, f, np.array(getattr(scene, f), copy=True))
    kw = dict(config.get("renderer", {}))
    handler = kw.pop("handler", "bvh")
    return Renderer(
        s, config=Config(compute=ComputeConfig(**config["compute"])), handler=handler,
        size=(width, height), device=device, **kw,
    )


def start_camera(scene, seed: int):
    """The camera a run starts from: the configuration's, turned about
    the orbit's axis by the seed's starting angle."""
    from rt_rs_tpu_torch.scene.camera import CameraUniform

    angle = sampling.start_angle(seed)
    return CameraUniform(orbit_camera(scene.camera_pos, scene.camera_at, angle), scene.camera_at)


@dataclasses.dataclass
class Window:
    """What a run measured, which the end-to-end metrics' readers read:
    the window's frames and wall seconds, the kind's own series of
    seconds (name -> values), the sampled pixels; then, filled in by the
    harness, the set-up seconds, the bytes of the program's structure on
    the device and the device's readings (``device`` of the line)."""

    frames: int
    wall_s: float
    series: dict[str, list[float]]
    sampler: sampling.Sampler
    setup_s: float = 0.0
    accel_bytes: int = 0
    device: dict = dataclasses.field(default_factory=dict)


class Runner:
    """One cell's renderer, driven by its traffic kind."""

    def __init__(self, scene, config: dict, mix: dict, device: str):
        self.scene, self.mix, self.device = scene, mix, torch.device(device)
        self.width, self.height = int(mix["width"]), int(mix["height"])
        self.kind = spec.kind(mix["kind"])
        self.r = make_renderer(scene, config, self.width, self.height, device)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def sampler(self, seed: int) -> sampling.Sampler:
        c = self.mix["check"]
        strata = self.kind.strata(self.mix)
        return sampling.Sampler(
            seed, strata, max(1, int(c["frames"]) // strata), int(c["pixels"]), self.width, self.height
        )

    def warm_up(self, seed: int) -> None:
        """Every shape the window uses, once, from the seed's camera."""
        self.r.camera = start_camera(self.scene, seed)
        self.kind.warm_up(self, seed)
        self.sync()

    def window(self, seed: int, seconds: float) -> Window:
        """The measured window from the seed's starting camera."""
        self.r.camera = start_camera(self.scene, seed)
        sampler, series = self.sampler(seed), {}
        frames, wall = self.kind.loop(self, seconds, sampler, series)
        return Window(frames, wall, series, sampler)

    def traced(self, seed: int, seconds: float) -> tr.Trace:
        """A profiled window of ``seconds`` (frames not compared) ->
        its :class:`rtbench.trace.Trace`."""
        from torch.profiler import ProfilerActivity, profile, record_function

        self.r.camera = start_camera(self.scene, seed)
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.device.type == "cuda" else [])
        with profile(activities=acts) as prof:
            with record_function(tr.WINDOW_MARK):
                frames, _ = self.kind.loop(self, seconds)
                self.sync()
        return tr.collect(prof, frames)

    def close(self) -> None:
        """Drop the renderer (its tensors, graphs and pool)."""
        self.r = None

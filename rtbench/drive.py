"""The benchmark's side of the program: build ``rt_rs_tpu_torch.Renderer``
(or ``DynamicRenderer``) from the benchmark's arrays, warm it up, and
drive its window.

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


# The renderers a configuration's ``renderer`` block may name under
# ``class`` (default ``Renderer``); its other keys are the class's
# keyword arguments.
RENDERERS = ("Renderer", "DynamicRenderer")


def make_renderer(scene, config: dict, width: int, height: int, device: str):
    """The configuration's renderer over the benchmark's arrays, at the
    program's defaults but for the configuration's compute numbers and
    the ``renderer`` block's keyword arguments: ``Renderer`` with its
    handler (default ``bvh``), or ``DynamicRenderer`` (``refit``,
    ``tri_chunk``, ...), which builds its structure every frame."""
    from rt_rs_tpu_torch import renderer
    from rt_rs_tpu_torch.config import ComputeConfig, Config
    from rt_rs_tpu_torch.scene import Scene
    from rt_rs_tpu_torch.scene.camera import CameraController, CameraUniform

    s = Scene.empty(
        camera=CameraUniform(scene.camera_pos, scene.camera_at),
        camera_controller=CameraController("Orbit"),
    )
    for f in SCENE_FIELDS:
        setattr(s, f, np.array(getattr(scene, f), copy=True))
    kw = dict(config.get("renderer", {}))
    name = kw.pop("class", "Renderer")
    if name not in RENDERERS:
        raise ValueError(f"renderer class {name!r} is none of {RENDERERS}")
    if name == "Renderer":
        kw["handler"] = kw.pop("handler", "bvh")
    return getattr(renderer, name)(
        s, config=Config(compute=ComputeConfig(**config["compute"])), size=(width, height), device=device, **kw,
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
    """One cell's renderer, driven by its traffic kind, from the seed of
    the warm-up or window under way."""

    def __init__(self, scene, config: dict, mix: dict, device: str):
        self.scene, self.mix, self.device = scene, mix, torch.device(device)
        self.width, self.height = int(mix["width"]), int(mix["height"])
        self.kind = spec.kind(mix["kind"])
        self.r = make_renderer(scene, config, self.width, self.height, device)
        self.seed = 0

    def start(self, seed: int) -> None:
        """Put the renderer's camera at the seed's start."""
        self.seed = seed
        self.r.camera = start_camera(self.scene, seed)

    def animate(self, frames: int, first: int, **kw):
        """``animate(frames, **kw)`` of the renderer, the window's frames
        ``first`` on.  Where the kind gives geometry, frame ``first + i``'s
        vertex arrays go to the program as ``vertex_fn(i)``, made on the
        host when the program asks for them, as a host that animates a
        mesh hands over new arrays each frame."""
        geometry = getattr(self.kind, "geometry", None)
        if geometry is not None:
            kw["vertex_fn"] = lambda i: geometry(self.mix, self.seed, self.scene, [first + i])[0]
        return self.r.animate(frames, **kw)

    def structure(self):
        """What ``accel_bytes`` walks: ``Renderer.accel``, the resident
        structure; for a renderer that keeps none and builds one every
        frame (``DynamicRenderer``), the structure one frame builds from
        the rest pose's vertices (the chunk table with its rows table)."""
        resident = getattr(self.r, "accel", None)
        if resident is not None:
            return resident

        def dev(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

        return self.r._build(self.r._frame_arrays(dev(self.scene.vert_pos), dev(self.scene.vert_norm)))[0]

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
        self.start(seed)
        self.kind.warm_up(self, seed)
        self.sync()

    def window(self, seed: int, seconds: float) -> Window:
        """The measured window from the seed's starting camera."""
        self.start(seed)
        sampler, series = self.sampler(seed), {}
        frames, wall = self.kind.loop(self, seconds, sampler, series)
        return Window(frames, wall, series, sampler)

    def traced(self, seed: int, seconds: float) -> tr.Trace:
        """A profiled window of ``seconds`` (frames not compared) ->
        its :class:`rtbench.trace.Trace`."""
        from torch.profiler import ProfilerActivity, profile, record_function

        self.start(seed)
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.device.type == "cuda" else [])
        with profile(activities=acts) as prof:
            with record_function(tr.WINDOW_MARK):
                frames, _ = self.kind.loop(self, seconds)
                self.sync()
        return tr.collect(prof, frames)

    def close(self) -> None:
        """Drop the renderer (its tensors, graphs and pool)."""
        self.r = None

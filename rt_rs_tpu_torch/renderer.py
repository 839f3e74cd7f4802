"""The frame engine: ``Renderer`` and ``run_headless``.

Counterpart of ``rt_rs_tpu/renderer.py``.  ``Renderer`` packs the scene
onto an explicit torch device once, lets the handler build its
acceleration tensors there, binds the handler's intersect entries, and
renders a frame by calling :func:`rt_rs_tpu_torch.ops.shade.render_tiled`
(PyTorch runs eagerly, so there is no compile step).  On a CUDA device
every kernel of the frame is a hand-written CUDA kernel; on the CPU the
same calls run their plain-PyTorch twins.

Not ported yet: ``animate(chain>1)``, ``seg_order`` (segmented tables),
the XLA fallback for negative materials and ``DynamicRenderer``
(ROADMAP module items 9, 10 and 12).
"""

from __future__ import annotations

import time
import warnings
from typing import Any, Callable

import numpy as np
import torch

from rt_rs_tpu_torch.config import ComputeConfig, Config
from rt_rs_tpu_torch.handlers import get_handler
from rt_rs_tpu_torch.handlers.base import IntrsHandler, IntrsStats
from rt_rs_tpu_torch.ops import shade
from rt_rs_tpu_torch.scene import Scene


def device_sync(x: torch.Tensor) -> None:
    """Wait until the device has finished ``x`` (a no-op on the CPU)."""
    if x.is_cuda:
        torch.cuda.synchronize(x.device)


class Renderer:
    """Owns the packed scene, the accel tensors and the frame entries."""

    def __init__(
        self,
        scene: Scene,
        config: Config | None = None,
        handler: str | IntrsHandler = "pbvh",
        handler_kwargs: dict[str, Any] | None = None,
        size: tuple[int, int] | None = None,
        device: str | torch.device = "cuda",
    ):
        """``device`` is where every tensor lives and every kernel runs
        (default ``"cuda"``; there is no fallback to the CPU: pass
        ``device="cpu"`` to run the plain-PyTorch twins).  Rays are
        generated in pixel blocks of one ray tile each, shaped by the
        config's workgroup hint (16x16 for pbvh's 256-ray tiles)."""
        self.scene = scene
        self.device = torch.device(device)
        self.config = config or Config()
        if isinstance(handler, IntrsHandler):
            self.handler = handler
        else:
            self.handler = get_handler(handler, **(handler_kwargs or {}))
        self.block = self.config.resolution.block(self.handler.block_lanes)
        self.width, self.height = (
            size if size is not None else self.config.resolution.size()
        )

        arrays = scene.pack(self.device)
        self.accel, self.arrays = self.handler.build(scene, arrays)
        self.stats: IntrsStats = self.handler.stats(self.accel)
        self._bind()

        self.camera = scene.camera
        self.camera_controller = scene.camera_controller
        if tuple(self.camera.pos) == tuple(self.camera.at):
            # pos == at normalizes a zero vector into NaN ray directions.
            warnings.warn(
                "camera pos == at: ray directions will be NaN "
                "(the reference renders garbage here too); set a "
                "real camera on the scene",
                stacklevel=2,
            )

    def _bind(self) -> None:
        """Bind the handler's intersect entries to the current config:
        kernel-emitted rows with any-hit shadows where the handler
        offers them (the frame path's default)."""
        if not self.arrays.no_negative_materials:
            raise NotImplementedError(
                "scenes with negative materials need the XLA trace() path, "
                "which is not ported to rt_rs_tpu_torch yet (ROADMAP module "
                "item 9)"
            )
        h, cfg = self.handler, self.config.compute
        self._rows_fn = self._anyhit_fn = None
        if h.rows_default(self.accel, self.width * self.height):
            self._rows_fn = h.intersect_tiled_rows_fn(self.accel, self.arrays, cfg)
            if self._rows_fn is not None:
                self._anyhit_fn = h.intersect_tiled_anyhit_fn(
                    self.accel, self.arrays, cfg
                )
        self._intersect_fn = h.intersect_tiled_fn(self.accel, self.arrays, cfg)

    def _camera_tensor(self, v) -> torch.Tensor:
        return torch.tensor(v, dtype=torch.float32, device=self.device)

    def render_frame(self, block: bool = True) -> torch.Tensor:
        """Render one frame -> [H, W, 3] float32 tensor on the device.
        ``block`` waits for the device to finish it."""
        out = shade.render_tiled(
            self.arrays,
            self._intersect_fn,
            self.config.compute,
            self._camera_tensor(self.camera.pos),
            self._camera_tensor(self.camera.at),
            self.width,
            self.height,
            ray_tile=self.handler.block_lanes,
            block=self.block,
            intersect_rows_fn=self._rows_fn,
            intersect_anyhit_fn=self._anyhit_fn,
        )
        if block:
            device_sync(out)
        return out

    def render_image(self) -> np.ndarray:
        """One frame as uint8 RGB (the rgba8unorm store,
        compute.wgsl:291: clamp to [0,1], round to 8 bits)."""
        frame = self.render_frame(block=False).cpu().numpy()
        return np.round(np.clip(frame, 0.0, 1.0) * 255.0).astype(np.uint8)

    def orbit(self, mult: float) -> None:
        """Advance the orbit camera by ``0.0314 * mult`` radians
        (camera.rs:177-189)."""
        self.camera = self.camera.orbited(mult)

    def update_config(self, compute: ComputeConfig) -> None:
        """Live compute-config swap (``State::update_config``,
        state/mod.rs:731-743)."""
        self.config = Config(
            compute=compute, resolution=self.config.resolution, fps=self.config.fps
        )
        self._bind()

    def animate(
        self,
        frames: int,
        orbit_mult: float = 1.0,
        on_frame: Callable[[int, torch.Tensor, float], None] | None = None,
        sync_every: int = 20,
        chain: int | None = None,
    ) -> list[float]:
        """Render ``frames`` orbit steps -> per-frame seconds (the
        study's benchmark protocol: N frames over camera orbit
        rotations).  The device is synchronised every ``sync_every``
        frames and the elapsed time is spread over them."""
        if chain is not None and chain > 1:
            raise NotImplementedError(
                "animate(chain>1) is not ported to rt_rs_tpu_torch yet "
                "(ROADMAP module item 12)"
            )
        return _animate_loop(
            lambda i: self.render_frame(block=False),
            self.orbit, frames, orbit_mult, on_frame, sync_every,
        )


def _animate_loop(
    render_one: Callable[[int], torch.Tensor],
    orbit: Callable[[float], None],
    frames: int,
    orbit_mult: float,
    on_frame: Callable[[int, torch.Tensor, float], None] | None,
    sync_every: int,
) -> list[float]:
    """The shared animate/benchmark frame loop."""
    times: list[float] = []
    pending: list[torch.Tensor] = []
    t0 = time.perf_counter()
    for i in range(frames):
        frame = render_one(i)
        pending.append(frame)
        if len(pending) >= sync_every or i == frames - 1:
            device_sync(frame)
            dt = (time.perf_counter() - t0) / len(pending)
            times.extend([dt] * len(pending))
            if on_frame is not None:
                base = i + 1 - len(pending)
                for j, f in enumerate(pending):
                    on_frame(base + j, f, dt)
            pending = []
            t0 = time.perf_counter()
        orbit(orbit_mult)
    return times


def run_headless(
    scene_path: str,
    handler: str = "pbvh",
    handler_kwargs: dict[str, Any] | None = None,
    config: Config | None = None,
    size: tuple[int, int] | None = None,
    frames: int = 1,
    out_path: str | None = None,
    device: str | torch.device = "cuda",
) -> Renderer:
    """Load a scene JSON and render ``frames`` orbit steps, writing the
    last one to ``out_path``; the ``demo`` binary analogue
    (``src/demo.rs``)."""
    scene = Scene.load(scene_path)
    renderer = Renderer(
        scene,
        config=config,
        handler=handler,
        handler_kwargs=handler_kwargs,
        size=size,
        device=device,
    )
    image = None
    for _ in range(frames):
        image = renderer.render_image()
        renderer.orbit(1.0)
    if out_path is not None and image is not None:
        from rt_rs_tpu_torch.utils.image import write_png

        write_png(out_path, image)
    return renderer

"""The frame engine: ``Renderer`` and ``run_headless``.

Counterpart of ``rt_rs_tpu/renderer.py``.  ``Renderer`` packs the scene
onto an explicit torch device once, lets the handler build its
acceleration tensors there, binds the handler's intersect entries, and
renders a frame by calling :func:`rt_rs_tpu_torch.ops.shade.render_tiled`,
or, for scenes with a real ``material = -1`` prim, the flat path
:func:`rt_rs_tpu_torch.ops.shade.render` with the handler's flat
``intersect_fn`` (the JAX package's branch; its shadow test gathers the
material).  PyTorch runs eagerly, so there is no compile step.  On a
CUDA device every kernel of the frame is a hand-written CUDA kernel; on
the CPU the same calls run their plain-PyTorch twins.

Not ported yet: ``animate(chain>1)`` and ``DynamicRenderer`` (ROADMAP
module item 12).
"""

from __future__ import annotations

import copy
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


def _segmented_parts(accel):
    """The accel's segments if it is a segmented table, else None."""
    from rt_rs_tpu_torch.ops.packet_trace import SegmentedTriChunks

    return accel.segments if isinstance(accel, SegmentedTriChunks) else None


# 26 snap directions ({-1,0,1}^3 minus the origin, normalized): the
# quantization grid of seg_order="auto", which bounds the number of
# distinct segment orders (and cached entries) at 26.
_SNAP_DIRS = np.array(
    [
        (x, y, z)
        for x in (-1.0, 0.0, 1.0)
        for y in (-1.0, 0.0, 1.0)
        for z in (-1.0, 0.0, 1.0)
        if (x, y, z) != (0.0, 0.0, 0.0)
    ]
)
_SNAP_DIRS /= np.linalg.norm(_SNAP_DIRS, axis=1, keepdims=True)


def retile_default(n_pixels: int) -> bool:
    """``Renderer(retile=None)``'s choice of the between-bounce live-tile
    compaction (``shade.trace_tiled(retile=)``): off at every size, as
    in the JAX package, until the card measures otherwise."""
    return False


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
        block: tuple[int, int] | None | str = "auto",
        force_rows: bool | None = None,
        fuse_bounce: bool = False,
        shadow_cull: bool = True,
        retile: bool | None = None,
        narrow: int | None = None,
        seg_order: str | tuple[int, ...] | None = "auto",
    ):
        """``device`` is where every tensor lives and every kernel runs
        (default ``"cuda"``; there is no fallback to the CPU: pass
        ``device="cpu"`` to run the plain-PyTorch twins).  Rays are
        generated in pixel blocks of one ray tile each, shaped by the
        config's workgroup hint (``block="auto"``: 16x16 for pbvh's
        256-ray tiles, 8x16 for the streaming kernel's 128); a tuple
        fixes the block shape, None keeps raster order.

        ``fuse_bounce``, ``shadow_cull``, ``retile`` (None:
        :func:`retile_default`) and ``narrow`` pass to
        :func:`rt_rs_tpu_torch.ops.shade.trace_tiled`; like ``block``
        they change the work, never the frame, and default as in the
        JAX package.

        ``force_rows`` overrides the handler's ``rows_default`` (None:
        the kernel-emitted-rows branch for resident tables, the gather
        branch for segmented ones).  ``seg_order`` sets the visit order
        of a segmented table's segments: ``"auto"`` (default) visits
        them camera-front-to-back each frame, with the camera direction
        snapped to 26 bins; a tuple fixes one order; ``"scene"`` keeps
        build order.  Results are the same for every order (the merge
        is (t, pid)-lexicographic); the order only decides how early
        near hits cap the farther segments' culls.  A no-op for other
        tables."""
        self.scene = scene
        self.device = torch.device(device)
        self.force_rows = force_rows
        self.fuse_bounce = fuse_bounce
        self.shadow_cull = shadow_cull
        self.retile = retile
        self.narrow = narrow
        self.config = config or Config()
        if isinstance(handler, IntrsHandler):
            self.handler = handler
        else:
            self.handler = get_handler(handler, **(handler_kwargs or {}))
        if block == "auto":
            self.block = self.config.resolution.block(self.handler.block_lanes)
        else:
            self.block = block
        self.width, self.height = (
            size if size is not None else self.config.resolution.size()
        )

        arrays = scene.pack(device=self.device)
        self.accel, self.arrays = self.handler.build(scene, arrays)
        self.stats: IntrsStats = self.handler.stats(self.accel)
        self._entries: dict[int, tuple] = {}

        self.seg_order = seg_order
        self._order_handlers: dict[tuple[int, ...], IntrsHandler] = {}
        self._seg_centers: np.ndarray | None = None
        if seg_order not in ("scene", None):
            segs = _segmented_parts(self.accel)
            if segs is None or not hasattr(self.handler, "seg_order"):
                self.seg_order = "scene"  # inapplicable: a no-op
            elif isinstance(seg_order, tuple):
                self._frame_handler_for(tuple(int(i) for i in seg_order))
            elif seg_order == "auto":
                self._seg_centers = np.stack(
                    [
                        (s.bmin.amin(0) + s.bmax.amax(0)).cpu().numpy() / 2.0
                        for s in segs
                    ]
                )
            else:
                raise ValueError(f"unknown seg_order {seg_order!r}")

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

    def _frame_handler_for(self, order: tuple[int, ...]) -> IntrsHandler:
        """A cached shallow copy of the handler pinned to one segment
        visit order."""
        h = self._order_handlers.get(order)
        if h is None:
            h = copy.copy(self.handler)
            h.seg_order = order
            self._order_handlers[order] = h
        return h

    def _frame_handler(self) -> IntrsHandler:
        """The handler for this frame: with ``seg_order="auto"`` on a
        segmented table, a copy pinned to the camera-front-to-back order
        (segment centres sorted by distance from a point at the camera's
        distance in the snapped camera direction)."""
        if self._seg_centers is None:
            if self._order_handlers:  # a fixed tuple: its one copy
                return next(iter(self._order_handlers.values()))
            return self.handler
        centers = self._seg_centers
        mid = centers.mean(0)
        v = np.asarray(self.camera.pos, np.float64) - mid
        r = float(np.linalg.norm(v))
        if not np.isfinite(r) or r == 0.0:
            return self.handler
        u = _SNAP_DIRS[int(np.argmax(_SNAP_DIRS @ (v / r)))]
        d = np.linalg.norm(centers - (mid + u * r), axis=1)
        return self._frame_handler_for(tuple(int(i) for i in np.argsort(d, kind="stable")))

    def _bound(self, h: IntrsHandler) -> tuple:
        """``h``'s intersect entries under the current config ->
        (closest hit, rows or None, any-hit or None): kernel-emitted
        rows with any-hit shadows where the handler offers them and
        ``force_rows`` / ``rows_default`` asks for them, else the gather
        branch; for a negative-material scene, (the flat closest hit,
        None, None)."""
        entries = self._entries.get(id(h))
        if entries is None and not self.arrays.no_negative_materials:
            entries = (h.intersect_fn(self.accel, self.arrays, self.config.compute), None, None)
            self._entries[id(h)] = entries
        if entries is None:
            cfg = self.config.compute
            rows_fn = anyhit_fn = None
            use_rows = (
                h.rows_default(self.accel, self.width * self.height)
                if self.force_rows is None
                else self.force_rows
            )
            if use_rows:
                rows_fn = h.intersect_tiled_rows_fn(self.accel, self.arrays, cfg)
                if rows_fn is not None:
                    anyhit_fn = h.intersect_tiled_anyhit_fn(self.accel, self.arrays, cfg)
            entries = (
                h.intersect_tiled_fn(self.accel, self.arrays, cfg), rows_fn, anyhit_fn
            )
            self._entries[id(h)] = entries
        return entries

    def _camera_tensor(self, v) -> torch.Tensor:
        return torch.tensor(v, dtype=torch.float32, device=self.device)

    def render_frame(self, block: bool = True) -> torch.Tensor:
        """Render one frame -> [H, W, 3] float32 tensor on the device.
        ``block`` waits for the device to finish it."""
        intersect_fn, rows_fn, anyhit_fn = self._bound(self._frame_handler())
        if not self.arrays.no_negative_materials:
            out = shade.render(
                self.arrays, intersect_fn, self.config.compute,
                self._camera_tensor(self.camera.pos),
                self._camera_tensor(self.camera.at),
                self.width, self.height, block=self.block,
            )
            if block:
                device_sync(out)
            return out
        out = shade.render_tiled(
            self.arrays,
            intersect_fn,
            self.config.compute,
            self._camera_tensor(self.camera.pos),
            self._camera_tensor(self.camera.at),
            self.width,
            self.height,
            ray_tile=self.handler.block_lanes,
            block=self.block,
            intersect_rows_fn=rows_fn,
            intersect_anyhit_fn=anyhit_fn,
            fuse_bounce=self.fuse_bounce,
            shadow_cull=self.shadow_cull,
            retile=(
                retile_default(self.width * self.height)
                if self.retile is None
                else self.retile
            ),
            narrow=self.narrow,
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
        self._entries.clear()

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

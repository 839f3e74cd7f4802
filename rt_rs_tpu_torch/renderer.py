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

``animate(chain=K)`` renders K orbit frames per dispatch, the orbit
advanced in f32 between them: on a CUDA device one replay of a captured
CUDA graph, on the CPU the same frames eagerly.  ``render_frame`` stays
eager.

Not ported yet: ``DynamicRenderer`` (ROADMAP §1 item 6).
"""

from __future__ import annotations

import collections
import copy
import dataclasses
import time
import warnings
from typing import Any, Callable, Hashable

import numpy as np
import torch

from rt_rs_tpu_torch.config import ComputeConfig, Config
from rt_rs_tpu_torch.handlers import get_handler
from rt_rs_tpu_torch.handlers.base import IntrsHandler, IntrsStats
from rt_rs_tpu_torch.ops import cuda, shade
from rt_rs_tpu_torch.scene import Scene
from rt_rs_tpu_torch.scene.camera import orbit_f32

# Chains kept per Renderer, least recently used evicted first: one per
# (K, segment order, config, knobs).  seg_order="auto" gives at most 26
# orders, so every order of one K fits.  On a CUDA device an entry is a
# captured graph; the K frames' buffers are shared by the graphs of one
# K, and their intermediates by all graphs in one memory pool, so an
# entry adds little device memory of its own (PERF.md §6).
CHAIN_CACHE_LIMIT = 32


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


class LruCache:
    """A mapping of at most ``limit`` entries that evicts the least
    recently used one."""

    def __init__(self, limit: int):
        if limit < 1:
            raise ValueError(f"cache limit {limit} must be at least 1")
        self.limit = limit
        self._entries: collections.OrderedDict[Hashable, Any] = collections.OrderedDict()

    def get(self, key: Hashable, make: Callable[[], Any]) -> Any:
        """The entry of ``key``, made by ``make()`` on a miss."""
        if key in self._entries:
            self._entries.move_to_end(key)
            return self._entries[key]
        value = make()
        self._entries[key] = value
        while len(self._entries) > self.limit:
            self._entries.popitem(last=False)
        return value

    def keys(self) -> list:
        """Keys from the least to the most recently used."""
        return list(self._entries)

    def clear(self) -> None:
        self._entries.clear()

    def __len__(self) -> int:
        return len(self._entries)


@dataclasses.dataclass
class _ChainIO:
    """The fixed buffers of the chains of one K: the camera inputs
    (filled before each dispatch) and the K frames [K, H, W, 3] with the
    f32 camera positions [K, 3] they were rendered at (overwritten by
    each dispatch)."""

    pos: torch.Tensor
    at: torch.Tensor
    mult: torch.Tensor
    frames: torch.Tensor
    poses: torch.Tensor


@dataclasses.dataclass
class _Chain:
    """A cache entry: on a CUDA device the captured graph of K frames
    and the kernel launches each replay makes; on the CPU no graph."""

    graph: Any = None
    launches: collections.Counter = dataclasses.field(default_factory=collections.Counter)


class Renderer:
    """Owns the packed scene, the accel tensors and the frame entries."""

    def __init__(
        self,
        scene: Scene,
        config: Config | None = None,
        handler: str | IntrsHandler = "bvh",
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
        """``handler`` defaults to ``"bvh"``, as in the JAX package
        (``handler_kwargs`` pass to it).  ``device`` is where every
        tensor lives and every kernel runs (default ``"cuda"``; there is
        no fallback to the CPU: pass ``device="cpu"`` to run the
        plain-PyTorch twins).  Rays are generated in pixel blocks of one
        ray tile each, shaped by the config's workgroup hint
        (``block="auto"``: 16x16 for the 256-ray tiles of pbvh, bvh and
        rf_bvh, 8x16 for the streaming kernel's 128); a tuple
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
        self._chains = LruCache(CHAIN_CACHE_LIMIT)
        self._chain_io: dict[int, _ChainIO] = {}
        self._graph_pool = None  # the chains' shared CUDA graph memory pool

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
        if tuple(self.camera.pos) == tuple(self.camera.at) and not scene.is_unloaded:
            # pos == at normalizes a zero vector into NaN ray directions
            # (the unloaded placeholder renders black regardless: its NaN
            # rays all miss the degenerate prim).
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

    def _host_f32(self, v) -> torch.Tensor:
        """A host vector as an f32 CPU tensor, pinned when the device is
        a card, so that copying it there does not wait for the device."""
        t = torch.tensor(v, dtype=torch.float32)
        return t.pin_memory() if self.device.type == "cuda" else t

    def _camera_tensor(self, v) -> torch.Tensor:
        return self._host_f32(v).to(self.device, non_blocking=True)

    def _render(self, h: IntrsHandler, pos: torch.Tensor, at: torch.Tensor) -> torch.Tensor:
        """One frame through ``h``'s entries from the f32 camera tensors
        ``pos`` and ``at`` [3] -> [H, W, 3]: the tiled path, or the flat
        one for a negative-material scene."""
        intersect_fn, rows_fn, anyhit_fn = self._bound(h)
        if not self.arrays.no_negative_materials:
            return shade.render(
                self.arrays, intersect_fn, self.config.compute, pos, at,
                self.width, self.height, block=self.block,
            )
        return shade.render_tiled(
            self.arrays,
            intersect_fn,
            self.config.compute,
            pos,
            at,
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

    def render_frame(self, block: bool = True) -> torch.Tensor:
        """Render one frame -> [H, W, 3] float32 tensor on the device.
        ``block`` waits for the device to finish it."""
        out = self._render(
            self._frame_handler(),
            self._camera_tensor(self.camera.pos),
            self._camera_tensor(self.camera.at),
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
        self._chains.clear()

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
        frames and the elapsed time is spread over them; ``on_frame(i,
        frame, dt)`` then sees each of them, in order, as a device
        tensor.

        ``chain`` (K > 1) renders K frames per dispatch, the contract of
        the JAX package's ``animate(chain=)``: frame 0 of a dispatch is
        the unchained frame at the host camera; frames 1..K-1 advance
        the orbit in f32 (:func:`~rt_rs_tpu_torch.scene.camera.orbit_f32`),
        a few ULP from the host's f64 orbit; a last dispatch renders K
        frames and keeps those it needs.  The host camera stays
        canonical: after each dispatch it takes one f64 orbit step per
        frame kept, so it ends bit-identical to the loop's.  With
        ``seg_order="auto"`` the order is taken once per dispatch, from
        its first camera.  On a CUDA device a dispatch is one replay of
        a CUDA graph captured at the first dispatch of its (K, segment
        order, config, knobs); a capture that fails raises.  On the CPU
        the frames run eagerly."""
        if chain is not None and chain > 1:
            return self._animate_chained(frames, orbit_mult, on_frame, sync_every, chain)
        return _animate_loop(
            lambda i: self.render_frame(block=False),
            self.orbit, frames, orbit_mult, on_frame, sync_every,
        )

    def _chain_key(self, k: int, h: IntrsHandler) -> tuple:
        return (
            k, getattr(h, "seg_order", None), self.config.compute, self.block,
            self.force_rows, self.fuse_bounce, self.shadow_cull, self.retile, self.narrow,
        )

    def _io(self, k: int) -> _ChainIO:
        io = self._chain_io.get(k)
        if io is None:
            f32 = dict(dtype=torch.float32, device=self.device)
            io = _ChainIO(
                pos=torch.zeros(3, **f32),
                at=torch.zeros(3, **f32),
                mult=torch.zeros((), **f32),
                frames=torch.zeros((k, self.height, self.width, 3), **f32),
                poses=torch.zeros((k, 3), **f32),
            )
            self._chain_io[k] = io
        return io

    def _chain_frames(self, h: IntrsHandler, k: int, io: _ChainIO) -> None:
        """The K frames of one dispatch from ``io``'s camera into
        ``io.frames`` / ``io.poses``: the body of a captured graph."""
        pos = io.pos
        for j in range(k):
            io.frames[j].copy_(self._render(h, pos, io.at))
            io.poses[j].copy_(pos)
            pos = orbit_f32(pos, io.at, io.mult)

    def _capture(self, h: IntrsHandler, k: int, io: _ChainIO) -> _Chain:
        """Capture :meth:`_chain_frames` in a CUDA graph.  The kernels
        are built and one eager frame runs on a side stream first, so
        that nothing is set up lazily inside the capture.  The launches
        the capture records are counted at each replay, not here."""
        cuda.library()
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            self._render(h, io.pos, io.at)
        current.wait_stream(side)
        if self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()

        def capture():
            with torch.cuda.graph(graph, pool=self._graph_pool):
                self._chain_frames(h, k, io)

        return _Chain(graph, cuda.captured_launches(capture))

    def _run_chain(self, k: int, orbit_mult: float) -> tuple[torch.Tensor, torch.Tensor, IntrsHandler]:
        """One dispatch of K frames from the host camera (which it does
        not move) -> (frames [K, H, W, 3], their f32 camera positions
        [K, 3], the frame handler).  The two tensors are the chains'
        fixed buffers: the next dispatch of this K overwrites them."""
        h = self._frame_handler()
        io = self._io(k)
        io.pos.copy_(self._host_f32(self.camera.pos), non_blocking=True)
        io.at.copy_(self._host_f32(self.camera.at), non_blocking=True)
        io.mult.fill_(orbit_mult)
        if self.device.type == "cuda":
            chain = self._chains.get(self._chain_key(k, h), lambda: self._capture(h, k, io))
            chain.graph.replay()
            cuda.LAUNCHES.update(chain.launches)
        else:
            self._chains.get(self._chain_key(k, h), _Chain)
            self._chain_frames(h, k, io)
        return io.frames, io.poses, h

    def _animate_chained(self, frames, orbit_mult, on_frame, sync_every, k) -> list[float]:
        """:meth:`animate` with ``chain=k`` (the JAX package's
        ``_animate_chained``): the kept frames of each dispatch are
        copied out of the chains' buffers before the next one."""
        times: list[float] = []
        pending: list[torch.Tensor] = []  # [m, H, W, 3] per dispatch
        done = 0
        t0 = time.perf_counter()
        while done < frames:
            m = min(k, frames - done)
            stacked = self._run_chain(k, orbit_mult)[0][:m].clone()
            pending.append(stacked)
            for _ in range(m):
                self.orbit(orbit_mult)
            done += m
            n_pend = sum(p.shape[0] for p in pending)
            if n_pend >= sync_every or done >= frames:
                device_sync(stacked)
                dt = (time.perf_counter() - t0) / n_pend
                times.extend([dt] * n_pend)
                if on_frame is not None:
                    base = done - n_pend
                    for i, f in enumerate(f for p in pending for f in p):
                        on_frame(base + i, f, dt)
                pending = []
                t0 = time.perf_counter()
        return times


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
    handler: str = "bvh",
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

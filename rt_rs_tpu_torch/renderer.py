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

``DynamicRenderer`` renders animated geometry: each frame gathers the
prims' corners from new vertex tensors and rebuilds its structure on the
device, then traces it through the same kernels: the chunk table (a
Morton sort, or, with ``refit=True``, new bounds over the rest pose's
order) for the packet kernels, or kernel G's wide tree, built once at
the rest pose and refit every frame.  Its ``animate(chain=K)`` captures
K such steps, rebuild included, in one CUDA graph.
"""

from __future__ import annotations

import collections
import copy
import dataclasses
import time
import warnings
from functools import partial
from typing import Any, Callable, Hashable

import numpy as np
import torch

from rt_rs_tpu_torch import tracing
from rt_rs_tpu_torch.bvh import build_bvh, wide
from rt_rs_tpu_torch.config import ComputeConfig, Config
from rt_rs_tpu_torch.handlers import get_handler
from rt_rs_tpu_torch.handlers.base import IntrsHandler, IntrsStats, tiled_as_flat
from rt_rs_tpu_torch.handlers.bvh import (
    BvhIntrs, TreeIntrs, accel_from_bvh_data, check_modes, reorder_scene_arrays, walk_tiled_fn,
)
from rt_rs_tpu_torch.handlers.lbvh import build_accel_device, chunk_footprint, chunk_table_fits, device_chunks
from rt_rs_tpu_torch.ops import cuda, shade, wide_build, wide_refit
from rt_rs_tpu_torch.ops import packet_trace as pt
from rt_rs_tpu_torch.ops.lbvh import centroid_codes, morton_order
from rt_rs_tpu_torch.scene import Scene
from rt_rs_tpu_torch.scene.arrays import intersect_indices
from rt_rs_tpu_torch.scene.camera import orbit_f32

# Chains kept per Renderer, least recently used evicted first: one per
# (K, segment order, config, knobs).  seg_order="auto" gives at most 26
# orders, so every order of one K fits.  On a CUDA device an entry is a
# captured graph; the K frames' buffers are shared by the graphs of one
# K, and their intermediates by all graphs in one memory pool, so an
# entry adds little device memory of its own (PERF.md §6).
CHAIN_CACHE_LIMIT = 32
# Chunk height of DynamicRenderer's per-frame tables, the JAX package's:
# at 64 a 6,320-triangle scene still fits the rows table's budget
# (8,192 triangles; 4,096 at 16).
DYNAMIC_TRI_CHUNK = 64


def _segmented_parts(accel):
    """The accel's segments if it is (or a dual table's coarse table
    is) a segmented table, else None."""
    from rt_rs_tpu_torch.ops.packet_trace import DualTriChunks, SegmentedTriChunks

    if isinstance(accel, DualTriChunks):
        accel = accel.coarse
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


def _host_f32(v, device: torch.device) -> torch.Tensor:
    """Host values as an f32 CPU tensor, pinned when ``device`` is a
    card, so that copying it there does not wait for the device."""
    t = torch.as_tensor(np.asarray(v, dtype=np.float32))
    return t.pin_memory() if device.type == "cuda" else t


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
class _DynamicIO(_ChainIO):
    """:class:`_ChainIO` with the K frames' vertex positions and
    normals (``verts`` [2, K, V, 3], filled before each dispatch) and, on
    a card, two pinned host buffers of that shape which the dispatches
    fill in turn, each with the event of its last upload (``staging``;
    None on the CPU)."""

    verts: torch.Tensor
    staging: list | None = None
    turn: int = 0

    @property
    def vert_pos(self) -> torch.Tensor:
        return self.verts[0]

    @property
    def vert_norm(self) -> torch.Tensor:
        return self.verts[1]

    def upload(self, vert_pos, vert_norm) -> None:
        """Frame ``j``'s arrays ``vert_pos[j]``, ``vert_norm[j]`` [V, 3]
        (stacked NumPy arrays, or sequences of arrays) into ``verts``: on
        a card stacked into the next pinned buffer, once the upload that
        last read it has run, and from there to the device in one
        asynchronous copy; on the CPU directly.  The stacking is NumPy's,
        one call an array, which costs the host less than a torch copy a
        frame."""
        if self.staging is None:
            host = self.verts
        else:
            host, uploaded = self.staging[self.turn]
            self.turn ^= 1
            uploaded.synchronize()
        out = host.numpy()
        np.stack([np.asarray(v) for v in vert_pos], out=out[0])
        np.stack([np.asarray(v) for v in vert_norm], out=out[1])
        if self.staging is not None:
            self.verts.copy_(host, non_blocking=True)
            uploaded.record()


@dataclasses.dataclass
class _Chain:
    """A cache entry: on a CUDA device the captured graph of K frames
    and the kernel launches each replay makes; on the CPU no graph."""

    graph: Any = None
    launches: collections.Counter = dataclasses.field(default_factory=collections.Counter)


def _capture_graph(
    device: torch.device, warm_up: Callable[[], Any], body: Callable[[], None], pool
) -> _Chain:
    """Capture ``body`` in a CUDA graph in memory pool ``pool``.  The
    kernels are built and ``warm_up`` (one eager frame) runs on a side
    stream first, so that nothing is set up lazily inside the capture.
    The launches the capture records are counted at each replay, not
    here; a capture that fails raises.  The trace counters count the
    warm-up frame (tracing.py)."""
    cuda.library()
    tracing.buffer(device)  # the counters' address, captured as it is
    current = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(current)
    with torch.cuda.stream(side):
        warm_up()
    tracing.add_frames(1)
    current.wait_stream(side)
    graph = torch.cuda.CUDAGraph()

    def capture():
        with torch.cuda.graph(graph, pool=pool):
            body()

    return _Chain(graph, cuda.captured_launches(capture))


class _ChainDispatch:
    """The dispatch of ``animate(chain=K)``, shared by :class:`Renderer`
    and :class:`DynamicRenderer`, which set ``device``, ``camera``,
    ``_chains`` (an :class:`LruCache` of :class:`_Chain`) and
    ``_graph_pool`` (None until the first capture).  A dispatch checks
    tracing once (``tracing.begin``) and runs under the span
    ``rt.dispatch``: ``rt.prepare`` (the chain's inputs and key), then
    ``rt.capture`` at a key's first dispatch on a card, and
    ``rt.replay``."""

    def _fill_camera(self, io: _ChainIO, orbit_mult: float) -> None:
        """``io``'s camera inputs from the host camera (which does not
        move)."""
        io.pos.copy_(_host_f32(self.camera.pos, self.device), non_blocking=True)
        io.at.copy_(_host_f32(self.camera.at, self.device), non_blocking=True)
        io.mult.fill_(orbit_mult)

    def _replay(self, key: Hashable, warm_up, body) -> None:
        """Run ``body``, K frames into the chains' buffers: on a card
        one replay of the graph cached under ``key``, captured at the
        key's first dispatch (:func:`_capture_graph`); on the CPU
        eagerly."""
        if self.device.type == "cuda":
            if self._graph_pool is None:
                self._graph_pool = torch.cuda.graph_pool_handle()

            def capture() -> _Chain:
                with tracing.setup("rt.capture", "capture_s", "captures"):
                    return _capture_graph(self.device, warm_up, body, self._graph_pool)

            chain = self._chains.get(key, capture)
        else:
            chain = self._chains.get(key, _Chain)
        with tracing.span("rt.replay"):
            if chain.graph is None:
                body()
            else:
                chain.graph.replay()
        cuda.LAUNCHES.update(chain.launches)


def _chained_loop(frames, k, orbit_mult, orbit, dispatch, on_frame, sync_every) -> list[float]:
    """The ``animate(chain=k)`` loop (the JAX package's
    ``_animate_chained``): ``dispatch(done)`` renders the K frames from
    frame ``done`` into the chains' buffers [K, H, W, 3]; the kept ones
    are copied out before the next dispatch, and the host camera takes
    one f64 orbit step per kept frame."""
    times: list[float] = []
    pending: list[torch.Tensor] = []  # [m, H, W, 3] per dispatch
    done = 0
    t0 = time.perf_counter()
    while done < frames:
        m = min(k, frames - done)
        out = dispatch(done)
        with tracing.span("rt.copy_out"):
            stacked = out[:m].clone()
        pending.append(stacked)
        with tracing.span("rt.orbit"):
            for _ in range(m):
                orbit(orbit_mult)
        done += m
        n_pend = sum(p.shape[0] for p in pending)
        if n_pend >= sync_every or done >= frames:
            with tracing.span("rt.sync"):
                device_sync(stacked)
            dt = (time.perf_counter() - t0) / n_pend
            times.extend([dt] * n_pend)
            if on_frame is not None:
                with tracing.span("rt.deliver"):
                    base = done - n_pend
                    for i, f in enumerate(f for p in pending for f in p):
                        on_frame(base + i, f, dt)
            pending = []
            t0 = time.perf_counter()
    return times


class Renderer(_ChainDispatch):
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

        with tracing.setup("rt.build", "build_s"):
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
        (closest hit, rows or None, any-hit or None): the emit branch
        (separate bounce calls, any-hit shadows) where the handler offers
        a rows entry and ``force_rows`` / ``rows_default`` asks for it,
        else the gather branch; for a negative-material scene, (the flat closest hit,
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
        return _host_f32(v, self.device).to(self.device, non_blocking=True)

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
        tracing.begin(self.device, 1)
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
            return _chained_loop(
                frames, chain, orbit_mult, self.orbit,
                lambda done: self._run_chain(chain, orbit_mult)[0], on_frame, sync_every,
            )
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

    def _run_chain(self, k: int, orbit_mult: float) -> tuple[torch.Tensor, torch.Tensor, IntrsHandler]:
        """One dispatch of K frames from the host camera (which it does
        not move) -> (frames [K, H, W, 3], their f32 camera positions
        [K, 3], the frame handler).  The two tensors are the chains'
        fixed buffers: the next dispatch of this K overwrites them."""
        tracing.begin(self.device, k)
        with tracing.span("rt.dispatch"):
            with tracing.span("rt.prepare"):
                h = self._frame_handler()
                io = self._io(k)
                self._fill_camera(io, orbit_mult)
                key = self._chain_key(k, h)
            self._replay(
                key, lambda: self._render(h, io.pos, io.at), lambda: self._chain_frames(h, k, io)
            )
        return io.frames, io.poses, h


def dynamic_walks(backend: str, refit: bool, prims: int, tri_chunk: int = DYNAMIC_TRI_CHUNK) -> bool:
    """``DynamicRenderer``'s backend rule -> whether it walks kernel G's
    tree (else the chunk table and the packet kernels), for a scene of
    ``prims`` triangles:

    * ``"packet"``: the chunk table, bounded by the JAX package's
      12,288 triangles (a larger scene raises at its first frame);
    * ``"threaded"``: the walk, at every scene size: with ``refit=True``
      over the tree built on the host once, at the rest pose, and refit
      every frame; with a rebuild over a tree built on the device every
      frame (:func:`~rt_rs_tpu_torch.ops.wide_build.wide_build`);
    * ``"auto"``: the walk with ``refit=True``, at every scene size, as
      the ``bvh`` handler's ``"auto"`` walks (the JAX package's cap is its
      TPU's VMEM byte model; on an H100 a 1080p frame of the breathing
      6,322-triangle teatime scene takes 2.76 ms walked against 15.39 ms
      on the chunk table's packet kernels); a rebuild keeps the chunk
      table wherever it fits (``tri_chunk`` high chunks within 12,288
      triangles), and past it walks the tree built every frame."""
    if backend == "threaded":
        return True
    return backend == "auto" and (refit or not chunk_table_fits(prims, tri_chunk))


class DynamicRenderer(_ChainDispatch):
    """Animated geometry with a per-frame rebuild on the device.

    Counterpart of the JAX package's ``DynamicRenderer``.  One frame
    step gathers the prims' corners from the frame's vertex positions
    and normals, rebuilds the shade table, rebuilds the structure on
    the device and renders through it: the tiled path with any-hit
    shadows, or the flat one for a scene with a real ``material = -1``
    prim.  Two structures (``backend``, :func:`dynamic_walks`):

    * the chunk table of the packet kernels, the default for a rebuild
      of at most 12,288 triangles, the JAX package's bound
      (:func:`~rt_rs_tpu_torch.handlers.lbvh.build_accel_device`, or
      with ``refit=True`` and ``backend="packet"``
      :func:`~rt_rs_tpu_torch.handlers.lbvh.device_chunks` over the rest
      pose's Morton order), with its rows table;
    * kernel G's wide tree, walked in the closest and any-hit modes at
      every scene size: the default with ``refit=True``, the ``bvh``
      handler's tree built once on the host at the rest pose and packed
      once, then each frame its boxes and prims rewritten from the
      corners by :func:`~rt_rs_tpu_torch.ops.wide_refit.wide_refit`; and
      the default for a rebuild past the chunk table's bound, an LBVH
      built from each frame's corners on the device and packed there
      (:func:`~rt_rs_tpu_torch.ops.wide_build.wide_build`), its prims
      carrying their scene rows so that the scene tensors keep their
      order.  On the CPU, where nothing is packed for the refit, the
      twin walks the binary tree, its covering bounds refit in torch ops
      (:func:`~rt_rs_tpu_torch.ops.wide_refit.binary_refit`); a rebuild
      walks the binary tree the build's twin makes.

    Every host decision (the rows gate, the path) is taken at
    construction, so a step reads nothing back from the device and a
    CUDA graph can capture it (``animate(chain=K)``).  The construction
    is timed as the set-up step ``rt.build`` (``tracing.setup``)."""

    def __init__(
        self,
        scene: Scene,
        config: Config | None = None,
        size: tuple[int, int] | None = None,
        refit: bool = False,
        force_rows: bool | None = None,
        tri_chunk: int | None = None,
        refine: bool = True,
        device: str | torch.device = "cuda",
        backend: str = "auto",
    ):
        """``device`` as for :class:`Renderer` (default ``"cuda"``).

        ``refit=True`` fixes the structure's order at the rest pose and
        each frame only rebuilds its bounds and contents: the chunk
        table sorts once and bakes that order into the corner gathers;
        the walk builds its tree once and bakes its leaf order in.  A
        stale order loosens the bounds but never changes a result:
        re-create the renderer when the geometry drifts far from the
        rest pose.  A rebuild (the default) builds the structure anew
        from each frame's corners.  ``backend`` (``"auto"``,
        ``"threaded"`` or ``"packet"``, the ``bvh`` handler's values)
        picks the structure by :func:`dynamic_walks`: ``"auto"`` walks
        with ``refit=True``, and for a rebuild keeps the chunk table up
        to its 12,288 triangles and walks past them.

        ``force_rows`` overrides the kernel-emitted-rows default (on):
        the chunk table's rows need a scene without negative materials,
        a finite shade table at the rest pose and a rows table within
        :func:`~rt_rs_tpu_torch.ops.packet_trace.rows_budget_ok` at the
        chunk height ``tri_chunk`` (None: DYNAMIC_TRI_CHUNK).  With the
        chunk table's rows on, :meth:`render_frame` refuses non-finite
        vertex data (NumPy arrays every frame, tensors on the first
        frame only), as the JAX package does; ``force_rows=False``
        renders it on the gather branch.  The walk takes the emit branch
        wherever the scene has no negative material (its shading reads
        each hit's row by pid), unless ``force_rows=False``.
        ``refine`` (default True) lets the packet kernels' bounce and
        shadow batches take the per-ray cull."""
        check_modes(backend, "bounces" if refine else "off")  # refine: the packet kernels' "bounces" policy
        self.scene = scene
        self.device = torch.device(device)
        self.config = config or Config()
        self.width, self.height = (
            size if size is not None else self.config.resolution.size()
        )
        self.camera = scene.camera
        # One chunk height for the rows gate and every build.
        tc = DYNAMIC_TRI_CHUNK if tri_chunk is None else tri_chunk
        self._walk = dynamic_walks(backend, refit, scene.num_prims, tc)
        self._tree: wide.WalkTree | None = None  # the packed records (on a card)
        self._refit_map: wide.RefitMap | None = None
        self._binary: wide.BinaryRefit | None = None  # the CPU twin's topology
        self._rebuild: wide_build.WideBuild | None = None  # a walked rebuild's buffers (on a card)
        with tracing.setup("rt.build", "build_s"):
            base = scene.pack(device=self.device)
            # The static pack's duplicate-triple collapse: topology is fixed,
            # so each frame's gathers inherit its self-exclusion semantics.
            prim_idx = torch.from_numpy(
                np.asarray(intersect_indices(scene.prim_indices), dtype=np.int64).reshape(-1, 3)
            ).to(self.device)
            if self._walk and refit:
                base, prim_idx = self._build_tree(scene, base, prim_idx)
            elif self._walk and self.device.type == "cuda":
                self._rebuild = wide_build.workspace(scene.num_prims, self.device)
            elif self._walk and scene.num_prims < 1:
                raise ValueError("a walked rebuild needs at least one prim")
            elif refit:
                order = morton_order(centroid_codes(base.pa[1:], base.pb[1:], base.pc[1:])).long()
                prim_idx = prim_idx[order]
                perm = torch.cat([order.new_zeros(1), order + 1])
                base = dataclasses.replace(base, prim_mat=base.prim_mat[perm])
        if self._walk:
            self._use_rows = bool((True if force_rows is None else force_rows) and base.no_negative_materials)
        else:
            finite_rest = bool(torch.isfinite(base.shade_table).all())
            self._use_rows = bool(
                (True if force_rows is None else force_rows)
                and base.no_negative_materials
                and finite_rest
                and pt.rows_budget_ok(base.pa.shape[0] - 1, tc)
            )
        # The chunk table's rows table refuses non-finite vertex data.
        self._refuse_nonfinite = self._use_rows and not self._walk
        self._inputs_checked = False
        self._base = base
        self._prim_idx = prim_idx
        self._tri_chunk = tc
        self._refit = refit
        self._refine = refine
        self._block = self.config.resolution.block(pt.TUNED_RAY_TILE)
        self._rest_norm = torch.from_numpy(
            np.asarray(scene.vert_norm, dtype=np.float32)
        ).to(self.device)
        self._stats: IntrsStats | None = None
        self._chains = LruCache(CHAIN_CACHE_LIMIT)
        self._chain_io: dict[int, _DynamicIO] = {}
        self._graph_pool = None

    def _build_tree(self, scene: Scene, base, prim_idx):
        """The walk's set-up, once: the ``bvh`` handler's tree of the rest
        pose with its defaults, its leaf order baked into the scene
        tensors and the corner gathers, and then, on a card, the tree
        packed for kernel G with the map its refit reads (the binary
        tree is not kept there); on the CPU the binary tree's topology
        for :func:`~rt_rs_tpu_torch.ops.wide_refit.binary_refit` ->
        (leaf-ordered base, prim_idx)."""
        h = BvhIntrs()
        data = build_bvh(scene, eps=h.eps, target_item_count=h.target_item_count)
        base = reorder_scene_arrays(base, data.indices)
        prim_idx = prim_idx[torch.from_numpy(np.asarray(data.indices, dtype=np.int64)).to(self.device)]
        nodes = accel_from_bvh_data(data, scene, torch.device("cpu"))
        links = (nodes.hit_link, nodes.miss_link, nodes.leaf_count, nodes.leaf_start)
        self._footprint = nodes.footprint
        if self.device.type == "cuda":
            host = wide.pack_walk(
                nodes.node_min, nodes.node_max, *links, *(x.cpu() for x in (base.pa, base.pb, base.pc)),
                payload=False,
            )
            self._tree = wide.WalkTree(
                binary=(), payload=False, nodes=host.nodes.to(self.device),
                prims=host.prims.to(self.device), stack=host.stack,
            )
            self._refit_map = wide.refit_map(self._tree, rows=base.pa.shape[0])
        else:
            self._links = links
            self._binary = wide.binary_refit_topology(*links, scene.num_prims)
        return base, prim_idx
    def _frame_arrays(self, vert_pos, vert_norm):
        """The scene tensors of one frame's geometry [V, 3]: the prims'
        corners gathered (with the sentinel row 0) and the shade table
        rebuilt from them."""
        idx = self._prim_idx

        def corner(arr, c):
            return torch.cat([arr.new_zeros((1, 3)), arr[idx[:, c]]])

        return dataclasses.replace(
            self._base,
            pa=corner(vert_pos, 0), pb=corner(vert_pos, 1), pc=corner(vert_pos, 2),
            na=corner(vert_norm, 0), nb=corner(vert_norm, 1), nc=corner(vert_norm, 2),
        ).rebuild_shade_table()

    def _build(self, arrays):
        """One frame's structure -> (accel, arrays to shade): the walk's
        tree rebuilt (a :class:`~rt_rs_tpu_torch.ops.wide_build.WideBuild`:
        on a card its buffers, the packed records rewritten in place; on
        the CPU the twin's tree) or refit (a
        :class:`~rt_rs_tpu_torch.bvh.wide.RefitWalk`: on a card the packed
        records rewritten in place with the map they were rewritten by, on
        the CPU the binary tree with new bounds), or the chunk table: the
        rebuild (sort, permute, chunk) or, with ``refit``, the table over
        the rest pose's order."""
        if self._walk and not self._refit:
            if self._rebuild is not None:
                wide_build.wide_build(arrays.pa, arrays.pb, arrays.pc, self._rebuild)
                return self._rebuild, arrays
            tree = wide_build.wide_build(arrays.pa, arrays.pb, arrays.pc)
            return wide_build.WideBuild(p=arrays.pa.shape[0] - 1, tree=tree, work={}), arrays
        if self._walk:
            if self._tree is not None:
                wide_refit.wide_refit(arrays.pa, arrays.pb, arrays.pc, self._tree, self._refit_map)
                return wide.RefitWalk(self._tree, self._refit_map), arrays
            node_min, node_max = wide_refit.binary_refit(arrays.pa, arrays.pb, arrays.pc, self._binary)
            binary = (node_min, node_max, *self._links, arrays.pa, arrays.pb, arrays.pc)
            return wide.RefitWalk(wide.WalkTree(binary=binary, payload=False), None), arrays
        tc = self._tri_chunk
        if self._refit:
            accel = device_chunks(
                arrays.pa, arrays.pb, arrays.pc, tri_chunk=tc,
                shade_rows=arrays.shade_table if self._use_rows else None,
            )
            return accel, arrays
        return build_accel_device(arrays, tri_chunk=tc, with_attrs=self._use_rows)

    def _step(self, vert_pos, vert_norm, pos, at) -> torch.Tensor:
        """One frame of the geometry ``vert_pos`` / ``vert_norm`` [V, 3]
        from the f32 camera tensors ``pos`` / ``at`` [3] -> [H, W, 3]."""
        accel, arrays = self._build(self._frame_arrays(vert_pos, vert_norm))
        cfg = self.config.compute
        if self._walk:
            return self._walk_frame(accel.tree, arrays, pos, at)
        win = dict(t_min=cfg.t_min, t_max=cfg.t_max, eps=cfg.eps)
        if not arrays.no_negative_materials:
            # A real negative-material prim: the flat path, whose shadow
            # test gathers the material.
            intersect = partial(pt.packet_closest_hit, accel, ray_tile=pt.TUNED_RAY_TILE, **win)
            return shade.render(
                arrays, intersect, cfg, pos, at, self.width, self.height, block=self._block
            )
        kern = partial(pt.packet_closest_hit_tiled, accel, **win)
        kern.supports_refine = self._refine
        rows_fn = anyhit_fn = None
        if self._use_rows:
            rows_fn = partial(kern, emit_rows=True)
            anyhit_fn = partial(kern, any_hit=True)
            rows_fn.supports_refine = anyhit_fn.supports_refine = self._refine
        return shade.render_tiled(
            arrays, kern, cfg, pos, at, self.width, self.height,
            ray_tile=pt.TUNED_RAY_TILE, block=self._block,
            intersect_rows_fn=rows_fn, intersect_anyhit_fn=anyhit_fn,
        )

    def _walk_frame(self, tree: wide.WalkTree, arrays, pos, at) -> torch.Tensor:
        """One frame through kernel G's entries on ``tree``, as the
        ``bvh`` handler's Renderer renders it: the emit branch (closest
        hits, any-hit shadows), the gather branch with ``force_rows=False``,
        or the flat path's closest hits for a negative-material scene."""
        cfg = self.config.compute
        closest = walk_tiled_fn(tree, cfg, "closest")
        if not arrays.no_negative_materials:
            return shade.render(
                arrays, tiled_as_flat(closest, TreeIntrs.block_lanes), cfg, pos, at,
                self.width, self.height, block=self._block,
            )
        rows_fn = anyhit_fn = None
        if self._use_rows:
            rows_fn = walk_tiled_fn(tree, cfg, "rows", arrays.shade_table)
            anyhit_fn = walk_tiled_fn(tree, cfg, "anyhit")
        return shade.render_tiled(
            arrays, closest, cfg, pos, at, self.width, self.height,
            ray_tile=TreeIntrs.block_lanes, block=self._block,
            intersect_rows_fn=rows_fn, intersect_anyhit_fn=anyhit_fn,
        )

    @property
    def stats(self) -> IntrsStats:
        """The structure's size: for the walked refit, the ``bvh``
        handler's 48-byte-a-node footprint, named ``BVH-refit``; for the
        walked rebuild, the bytes of its packed records (room for
        ``max(P - 1, 1)`` nodes of 128 bytes and P prims of 48), named
        ``BVH-rebuild``; for the chunk table, its device bytes (its
        shapes do not change from frame to frame), named
        ``LBVH-rebuild`` or ``LBVH-refit``."""
        if self._walk and not self._refit:
            p = self.scene.num_prims
            return IntrsStats(
                name="BVH-rebuild", size=max(p - 1, 1) * 4 * wide.NODE_WORDS + p * 4 * wide.PRIM_WORDS,
            )
        if self._walk:
            return IntrsStats(name="BVH-refit", size=self._footprint)
        if self._stats is None:
            base = self._base
            accel = device_chunks(
                base.pa, base.pb, base.pc, tri_chunk=self._tri_chunk,
                shade_rows=base.shade_table if self._use_rows else None,
            )
            self._stats = IntrsStats(
                name=f"LBVH-{'refit' if self._refit else 'rebuild'}",
                size=chunk_footprint(accel),
            )
        return self._stats

    def orbit(self, mult: float) -> None:
        """Advance the orbit camera by ``0.0314 * mult`` radians
        (camera.rs:177-189)."""
        self.camera = self.camera.orbited(mult)

    def _device_f32(self, x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.to(device=self.device, dtype=torch.float32)
        return _host_f32(x, self.device).to(self.device, non_blocking=True)

    def _check_inputs(self, vert_pos, vert_norm, norm_defaulted: bool) -> None:
        """With the chunk table's rows on, refuse non-finite vertex data: a NaN in the
        per-frame rows table would reach every ray that hits its prim's
        chunk in the JAX package's rows matmul, so both packages refuse
        it.  NumPy arrays are checked every frame; tensors (and the
        defaulted normals, the rest pose's) only on the first frame."""
        check_pos = isinstance(vert_pos, np.ndarray)
        check_norm = not norm_defaulted and isinstance(vert_norm, np.ndarray)
        if not (check_pos or check_norm or not self._inputs_checked):
            return
        first = not self._inputs_checked
        self._inputs_checked = True

        def finite(x) -> bool:
            if isinstance(x, torch.Tensor):
                return bool(torch.isfinite(x).all())
            return bool(np.isfinite(np.asarray(x)).all())

        pos_ok = finite(vert_pos) if (check_pos or first) else True
        norm_ok = finite(vert_norm) if (check_norm or (first and not norm_defaulted)) else True
        if not (pos_ok and norm_ok):
            raise ValueError(
                "non-finite vertex positions/normals with kernel-emitted rows "
                "enabled; pass force_rows=False to render degenerate geometry "
                "on the gather path"
            )

    def render_frame(self, vert_pos=None, vert_norm=None, block: bool = True) -> torch.Tensor:
        """Render one frame of the given geometry (NumPy arrays or
        tensors [V, 3]; None: the rest pose) -> [H, W, 3] float32 tensor
        on the device.  ``block`` waits for the device to finish it."""
        if vert_pos is None:
            vert_pos = self.scene.vert_pos
        norm_defaulted = vert_norm is None
        if norm_defaulted:
            vert_norm = self._rest_norm
        if self._refuse_nonfinite:
            self._check_inputs(vert_pos, vert_norm, norm_defaulted)
        tracing.begin(self.device, 1)
        out = self._step(
            self._device_f32(vert_pos),
            self._device_f32(vert_norm),
            self._device_f32(self.camera.pos),
            self._device_f32(self.camera.at),
        )
        if block:
            device_sync(out)
        return out

    def render_image(self, vert_pos=None, vert_norm=None) -> np.ndarray:
        """One frame as uint8 RGB (see :meth:`Renderer.render_image`)."""
        frame = self.render_frame(vert_pos, vert_norm, block=False).cpu().numpy()
        return np.round(np.clip(frame, 0.0, 1.0) * 255.0).astype(np.uint8)

    def animate(
        self,
        frames: int,
        orbit_mult: float = 1.0,
        on_frame: Callable[[int, torch.Tensor, float], None] | None = None,
        sync_every: int = 20,
        vertex_fn: Callable[[int], Any] | None = None,
        chain: int | None = None,
    ) -> list[float]:
        """Render ``frames`` orbit steps with a rebuild (or refit) per
        frame -> per-frame seconds, in :meth:`Renderer.animate`'s
        protocol.  ``vertex_fn(i)`` gives frame ``i``'s geometry as
        ``vert_pos`` or ``(vert_pos, vert_norm)`` (None: the rest pose;
        the table is rebuilt every frame all the same).

        ``chain`` (K > 1) renders K frames per dispatch, the contract of
        :meth:`Renderer.animate`: the K frames' vertex arrays are copied
        into the chains' fixed buffers [K, V, 3] (on a card through
        pinned host buffers, one upload a dispatch), and the
        K steps, rebuild included, run with the orbit advanced in f32
        between them; a last dispatch repeats the last frame's geometry
        and keeps the frames it needs (``vertex_fn`` is never called
        past ``frames - 1``).  On a CUDA device a dispatch is one replay
        of a CUDA graph captured at the first dispatch of its K; on the
        CPU the frames run eagerly."""
        if chain is not None and chain > 1:
            return self._animate_chained(frames, orbit_mult, on_frame, sync_every, chain, vertex_fn)

        def render_one(i: int) -> torch.Tensor:
            v = vertex_fn(i) if vertex_fn is not None else None
            vp, vn = v if isinstance(v, tuple) else (v, None)
            return self.render_frame(vp, vn, block=False)

        return _animate_loop(render_one, self.orbit, frames, orbit_mult, on_frame, sync_every)

    def _io(self, k: int) -> _DynamicIO:
        io = self._chain_io.get(k)
        if io is None:
            f32 = dict(dtype=torch.float32, device=self.device)
            v = np.asarray(self.scene.vert_pos).shape[0]
            staging = None
            if self.device.type == "cuda":
                staging = [
                    (torch.zeros((2, k, v, 3), dtype=torch.float32).pin_memory(), torch.cuda.Event())
                    for _ in range(2)
                ]
            io = _DynamicIO(
                pos=torch.zeros(3, **f32),
                at=torch.zeros(3, **f32),
                mult=torch.zeros((), **f32),
                frames=torch.zeros((k, self.height, self.width, 3), **f32),
                poses=torch.zeros((k, 3), **f32),
                verts=torch.zeros((2, k, v, 3), **f32),
                staging=staging,
            )
            self._chain_io[k] = io
        return io

    def _chain_frames(self, k: int, io: _DynamicIO) -> None:
        """The K frames of one dispatch from ``io``'s geometry and camera
        into ``io.frames`` / ``io.poses``: the body of a captured graph."""
        pos = io.pos
        for j in range(k):
            io.frames[j].copy_(self._step(io.vert_pos[j], io.vert_norm[j], pos, io.at))
            io.poses[j].copy_(pos)
            pos = orbit_f32(pos, io.at, io.mult)

    def _run_chain(self, k: int, orbit_mult: float, vert_pos, vert_norm):
        """One dispatch of K frames of the geometry ``vert_pos`` /
        ``vert_norm`` (stacked [K, V, 3], or K arrays [V, 3] each) from
        the host camera (which it does not move) -> (frames [K, H,
        W, 3], their f32 camera positions [K, 3]): the chains' fixed
        buffers, which the next dispatch of this K overwrites."""
        tracing.begin(self.device, k)
        with tracing.span("rt.dispatch"):
            with tracing.span("rt.prepare"):
                io = self._io(k)
                io.upload(vert_pos, vert_norm)
                self._fill_camera(io, orbit_mult)
            self._replay(
                k,
                lambda: self._step(io.vert_pos[0], io.vert_norm[0], io.pos, io.at),
                lambda: self._chain_frames(k, io),
            )
        return io.frames, io.poses

    def _animate_chained(self, frames, orbit_mult, on_frame, sync_every, k, vertex_fn) -> list[float]:
        rest_pos = np.asarray(self.scene.vert_pos, dtype=np.float32)
        rest_norm = np.asarray(self.scene.vert_norm, dtype=np.float32)

        def host(x, rest):
            if x is None:
                return rest
            if isinstance(x, torch.Tensor):
                x = x.detach().cpu()
            return np.asarray(x, dtype=np.float32)

        def frame_verts(i: int):
            v = vertex_fn(i) if vertex_fn is not None else None
            vp, vn = v if isinstance(v, tuple) else (v, None)
            return host(vp, rest_pos), host(vn, rest_norm)

        def dispatch(done: int) -> torch.Tensor:
            pairs = [frame_verts(min(done + i, frames - 1)) for i in range(k)]
            vp = [p[0] for p in pairs]
            vn = [p[1] for p in pairs]
            if self._refuse_nonfinite and not all(np.isfinite(a).all() for a in vp + vn):
                raise ValueError(
                    "non-finite vertex positions/normals with kernel-emitted rows "
                    "enabled; pass force_rows=False"
                )
            return self._run_chain(k, orbit_mult, vp, vn)[0]

        return _chained_loop(frames, k, orbit_mult, self.orbit, dispatch, on_frame, sync_every)


def _animate_loop(
    render_one: Callable[[int], torch.Tensor],
    orbit: Callable[[float], None],
    frames: int,
    orbit_mult: float,
    on_frame: Callable[[int, torch.Tensor, float], None] | None,
    sync_every: int,
) -> list[float]:
    """The shared animate/benchmark frame loop (eager frames; the
    spans ``rt.frame``, ``rt.sync``, ``rt.deliver`` and ``rt.orbit``
    while tracing is on)."""
    times: list[float] = []
    pending: list[torch.Tensor] = []
    t0 = time.perf_counter()
    for i in range(frames):
        with tracing.span("rt.frame"):
            frame = render_one(i)
        pending.append(frame)
        if len(pending) >= sync_every or i == frames - 1:
            with tracing.span("rt.sync"):
                device_sync(frame)
            dt = (time.perf_counter() - t0) / len(pending)
            times.extend([dt] * len(pending))
            if on_frame is not None:
                with tracing.span("rt.deliver"):
                    base = i + 1 - len(pending)
                    for j, f in enumerate(pending):
                        on_frame(base + j, f, dt)
            pending = []
            t0 = time.perf_counter()
        with tracing.span("rt.orbit"):
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

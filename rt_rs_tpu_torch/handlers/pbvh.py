"""Packet-BVH backend: the frame path's intersect kernels.

Counterpart of ``rt_rs_tpu/handlers/pbvh.py``.  ``build`` builds the
BVH (which fixes the leaf order), reorders the scene's prims into it,
and packs the chunk table on the scene's device.  Up to the JAX
package's resident cap (12,288 triangles) the table stays flat and the
intersect entries bind
:func:`rt_rs_tpu_torch.ops.packet_trace.packet_closest_hit_tiled` in its
closest-hit, emit-rows and any-hit modes.  Beyond it, as in the JAX
package, ``streaming_mode="segmented"`` (the default) splits the table
into segments traced by
:func:`~rt_rs_tpu_torch.ops.packet_trace.packet_closest_hit_segmented_tiled`
(gather branch by default; rows and any-hit on request), and
``streaming_mode="dma"`` keeps one table without shade rows, traced in
blocks by :func:`rt_rs_tpu_torch.ops.packet_stream.stream_closest_hit`
through the flat-ray adapter (128-ray tiles, gather branch only).

The JAX handler's knobs are taken with the same names and defaults
(``early_exit``, ``cull_block``, ``refine``, ``ray_tile``,
``tri_chunk``, ``data`` / ``path``); each changes the work, never the
frame.  The dual-granularity table (``tri_chunk_fine``) is not ported
yet (ROADMAP §1 item 5): it raises ``NotImplementedError``.
``interpret`` and ``collapse`` are not taken: the first picks the
Pallas interpreter, the second a Mosaic pipeline trick, and neither has
a visible effect to port.
"""

from __future__ import annotations

from functools import partial

from rt_rs_tpu_torch.bvh import BvhData, build_bvh
from rt_rs_tpu_torch.config import ComputeConfig
from rt_rs_tpu_torch.handlers.base import IntrsHandler, IntrsStats, tiled_as_flat
from rt_rs_tpu_torch.handlers.bvh import reorder_scene_arrays
from rt_rs_tpu_torch.ops import packet_stream
from rt_rs_tpu_torch.ops import packet_trace as pt
from rt_rs_tpu_torch.scene import Scene
from rt_rs_tpu_torch.scene.arrays import SceneArrays


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to rt_rs_tpu_torch yet (ROADMAP §1 item 5)"
    )


class PacketBvhIntrs(IntrsHandler):
    name = "Packet-BVH"

    def __init__(
        self,
        eps: float = 0.02,
        target_item_count: int = 2,
        data: BvhData | None = None,
        path: str | None = None,
        cull_block: int | None = None,
        ray_tile: int | None = None,
        tri_chunk: int | None = None,
        tri_chunk_fine: int | None = None,
        streaming_mode: str = "segmented",
        chain: bool = True,
        refine: str = "bounces",
        early_exit: bool = False,
        seg_order: tuple[int, ...] | None = None,
    ):
        """``eps`` / ``target_item_count`` drive the BVH build
        (handlers/bvh.rs:33, 82); ``data`` (a :class:`BvhData`) or
        ``path`` (its JSON checkpoint) replaces the build.
        ``streaming_mode`` picks the table beyond the resident cap;
        ``chain`` threads each segment's result into the next segment's
        cull (exact either way); ``seg_order`` fixes the segment visit
        order (None = scene order; ``Renderer(seg_order="auto")`` sets
        it per frame).  ``ray_tile`` sets the rays per tile (None: 256,
        or the streaming kernel's 128) and ``tri_chunk`` the triangles
        per chunk (None: 64).  The cull knobs pass to every tiled call
        (see ``packet_closest_hit_tiled``): ``refine`` ``"bounces"``
        (default) lets bounce and shadow batches take the per-ray cull,
        ``"all"`` every call, ``"off"`` none; ``cull_block`` (None: 1)
        culls blocks of chunks; ``early_exit`` walks front-to-back
        lists with the MT kernel's early-exit variant."""
        if tri_chunk_fine is not None:
            raise _not_ported("the dual-granularity table (tri_chunk_fine)")
        if streaming_mode not in ("segmented", "dma"):
            raise ValueError(f"unknown streaming_mode {streaming_mode!r}")
        if refine not in ("off", "bounces", "all"):
            raise ValueError(f"unknown refine mode {refine!r}")
        self.eps = eps
        self.target_item_count = target_item_count
        self._data = BvhData.load(path) if path is not None else data
        self.cull_block = cull_block
        self.ray_tile = ray_tile
        self.tri_chunk = tri_chunk
        self.streaming_mode = streaming_mode
        self.chain = chain
        self.refine = refine
        self.early_exit = early_exit
        self.seg_order = seg_order
        self.bvh_data: BvhData | None = self._data

    @property
    def block_lanes(self) -> int:
        """Rays per tile, one pixel block each: ``ray_tile`` (default
        256, 16x16), or 128 (8x16) for the streaming kernel's fixed
        tile."""
        if self.streaming_mode == "dma":
            return packet_stream.STREAM_LANES
        return pt.TUNED_RAY_TILE if self.ray_tile is None else self.ray_tile

    def build(self, scene: Scene, arrays: SceneArrays):
        if self._data is None:
            self.bvh_data = build_bvh(
                scene, eps=self.eps, target_item_count=self.target_item_count
            )
        else:
            self.bvh_data = self._data
        arrays = reorder_scene_arrays(arrays, self.bvh_data.indices)
        n_tris = arrays.pa.shape[0] - 1  # minus the null sentinel
        streaming = n_tris > pt.MAX_VMEM_CHUNKS * pt.TRI_CHUNK
        # Resident and segmented tables carry the shade rows; the
        # streamed table does not (kernel E has no rows mode).
        dma = streaming and self.streaming_mode == "dma"
        chunks = pt.build_tri_chunks(
            arrays.pa.cpu().numpy(),
            arrays.pb.cpu().numpy(),
            arrays.pc.cpu().numpy(),
            max_chunks=None,
            tri_chunk=pt.TUNED_TRI_CHUNK if self.tri_chunk is None else self.tri_chunk,
            shade_rows=None if dma else arrays.shade_table.cpu().numpy(),
            device=arrays.device,
        )
        if streaming and not dma:
            return pt.split_chunks(chunks), arrays
        return chunks, arrays

    def stats(self, accel) -> IntrsStats:
        """The table's device footprint: components and bounds of every
        segment, and the shared rows table once."""
        parts = self._segments(accel) or (accel,)
        tensors = [t for p in parts for t in (p.comp, p.bmin, p.bmax)]
        if parts[0].attr is not None:
            tensors.append(parts[0].attr)
        return IntrsStats(
            name=self.name, size=sum(t.numel() * t.element_size() for t in tensors)
        )

    @staticmethod
    def _segments(accel):
        return accel.segments if isinstance(accel, pt.SegmentedTriChunks) else None

    @staticmethod
    def _streamed(accel) -> bool:
        """A flat table beyond the resident cap: the DMA-streamed one."""
        return (
            isinstance(accel, pt.TriChunks)
            and accel.num_chunks * accel.tri_chunk > pt.MAX_VMEM_CHUNKS * pt.TRI_CHUNK
        )

    def _entry(self, accel, cfg: ComputeConfig, **mode):
        """The tiled entry for ``accel`` in one mode with the cull
        knobs, tagged with the ``refine`` policy (by default bounce and
        shadow batches take the per-ray cull, the coherent primaries
        the tile-interval cull)."""
        kw = dict(
            t_min=cfg.t_min, t_max=cfg.t_max, eps=cfg.eps,
            early_exit=self.early_exit, **mode,
        )
        if self.cull_block is not None:
            kw["cull_block"] = self.cull_block
        if self._segments(accel) is not None:
            fn = partial(
                pt.packet_closest_hit_segmented_tiled, accel,
                chain=self.chain, seg_order=self.seg_order, **kw,
            )
        else:
            fn = partial(pt.packet_closest_hit_tiled, accel, **kw)
        return pt.tag_refine(fn, self.refine)

    def intersect_fn(self, accel, arrays: SceneArrays, cfg: ComputeConfig):
        if self._streamed(accel):
            return partial(
                packet_stream.stream_closest_hit, accel,
                t_min=cfg.t_min, t_max=cfg.t_max, eps=cfg.eps,
            )
        return tiled_as_flat(self._entry(accel, cfg), self.block_lanes)

    def intersect_tiled_fn(self, accel, arrays: SceneArrays, cfg: ComputeConfig):
        if self._streamed(accel):
            # The streamed table has no tiled entry: adapt the flat one.
            return super().intersect_tiled_fn(accel, arrays, cfg)
        return self._entry(accel, cfg)

    def intersect_tiled_rows_fn(self, accel, arrays: SceneArrays, cfg: ComputeConfig):
        segs = self._segments(accel)
        if segs is not None:
            if segs[0].attr is None:
                return None
        elif accel.attr is None or not pt.resident_fits(accel, with_attrs=True):
            return None  # incl. the streamed table, which has no rows
        return self._entry(accel, cfg, emit_rows=True)

    def rows_default(self, accel, n_pixels: int) -> bool:
        """Segmented tables take the gather branch unless rows are
        forced: the JAX package measured per-segment rows slower on the
        TPU at every size."""
        return self._segments(accel) is None

    def intersect_tiled_anyhit_fn(self, accel, arrays: SceneArrays, cfg: ComputeConfig):
        if self._segments(accel) is None and not pt.resident_fits(accel):
            return None  # the streamed table has no any-hit entry
        return self._entry(accel, cfg, any_hit=True)

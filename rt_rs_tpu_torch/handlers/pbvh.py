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
``tri_chunk``, ``tri_chunk_fine``, ``data`` / ``path``); each changes
the work, never the frame.  ``tri_chunk_fine`` adds a second, finer
table over the same leaf order (:class:`~rt_rs_tpu_torch.ops.packet_trace.DualTriChunks`,
resident or segmented, not for ``"dma"``): primaries sweep the coarse
table, the per-ray-refined bounce and shadow batches the fine one, and
rows calls stay on the coarse table, the only one with shade rows.
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
        per chunk (None: 64); ``tri_chunk_fine`` (None: one table) the
        fine table's, for the refined batches.  The cull knobs pass to
        every tiled call (see ``packet_closest_hit_tiled``): ``refine``
        ``"bounces"`` (default) lets bounce and shadow batches take the
        per-ray cull, ``"all"`` every call, ``"off"`` none;
        ``cull_block`` (None: 1) culls blocks of chunks; ``early_exit``
        walks front-to-back lists with the MT kernel's early-exit
        variant."""
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
        self.tri_chunk_fine = tri_chunk_fine
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
        corners = [x.cpu().numpy() for x in (arrays.pa, arrays.pb, arrays.pc)]
        chunks = pt.build_tri_chunks(
            *corners,
            max_chunks=None,
            tri_chunk=pt.TUNED_TRI_CHUNK if self.tri_chunk is None else self.tri_chunk,
            shade_rows=None if dma else arrays.shade_table.cpu().numpy(),
            device=arrays.device,
        )
        # The fine table carries no rows table: rows calls stay on the
        # coarse one, and its segments are sized by the plain budget.
        fine = None
        if self.tri_chunk_fine is not None and not dma:
            fine = pt.build_tri_chunks(
                *corners, max_chunks=None, tri_chunk=self.tri_chunk_fine, device=arrays.device
            )
        if streaming and not dma:
            chunks = pt.split_chunks(chunks)
            fine = None if fine is None else pt.split_chunks(fine)
        if fine is not None:
            return pt.DualTriChunks(coarse=chunks, fine=fine), arrays
        return chunks, arrays

    def stats(self, accel) -> IntrsStats:
        """The table's device footprint: components and bounds of every
        segment, and the shared rows table once; a dual table counts
        both tables (the fine one has no rows table)."""
        tables = (accel.coarse, accel.fine) if isinstance(accel, pt.DualTriChunks) else (accel,)
        size = 0
        for table in tables:
            parts = self._segments(table) or (table,)
            tensors = [t for p in parts for t in (p.comp, p.bmin, p.bmax)]
            if parts[0].attr is not None:
                tensors.append(parts[0].attr)
            size += sum(t.numel() * t.element_size() for t in tensors)
        return IntrsStats(name=self.name, size=size)

    @staticmethod
    def _segments(accel):
        return accel.segments if isinstance(accel, pt.SegmentedTriChunks) else None

    @staticmethod
    def _coarse(accel):
        """The table that carries the rows: a dual table's coarse one."""
        return accel.coarse if isinstance(accel, pt.DualTriChunks) else accel

    @staticmethod
    def _streamed(accel) -> bool:
        """A flat table beyond the resident cap: the DMA-streamed one."""
        return (
            isinstance(accel, pt.TriChunks)
            and accel.num_chunks * accel.tri_chunk > pt.MAX_VMEM_CHUNKS * pt.TRI_CHUNK
        )

    def _table_entry(self, table, cfg: ComputeConfig, seg_order, **mode):
        """The tiled entry of one (flat or segmented) table in one mode
        with the cull knobs."""
        kw = dict(
            t_min=cfg.t_min, t_max=cfg.t_max, eps=cfg.eps,
            early_exit=self.early_exit, **mode,
        )
        if self.cull_block is not None:
            kw["cull_block"] = self.cull_block
        if self._segments(table) is not None:
            return partial(
                pt.packet_closest_hit_segmented_tiled, table,
                chain=self.chain, seg_order=seg_order, **kw,
            )
        return partial(pt.packet_closest_hit_tiled, table, **kw)

    def _dual_dispatch(self, accel: pt.DualTriChunks, cfg: ComputeConfig, **mode):
        """One entry over both tables of a dual table: calls with
        ``refine`` (the bounce and shadow batches) sweep the fine table,
        the others the coarse one.  ``seg_order`` orders the coarse
        table's segments; the fine table shares it only when its segment
        count is the same, and keeps build order otherwise (the order
        never changes a result)."""
        so = self.seg_order
        coarse = self._table_entry(accel.coarse, cfg, so, **mode)
        fine_segs = self._segments(accel.fine)
        if so is not None and (fine_segs is None or len(fine_segs) != len(so)):
            so = None
        fine = self._table_entry(accel.fine, cfg, so, **mode)

        def fn(payload, valid, t_cap=None, refine=False, **kw):
            table = fine if refine else coarse
            return table(payload, valid, t_cap, refine=refine, **kw)

        return fn

    def _entry(self, accel, cfg: ComputeConfig, **mode):
        """The tiled entry for ``accel`` in one mode with the cull
        knobs, tagged with the ``refine`` policy (by default bounce and
        shadow batches take the per-ray cull, the coherent primaries
        the tile-interval cull)."""
        if isinstance(accel, pt.DualTriChunks):
            fn = self._dual_dispatch(accel, cfg, **mode)
        else:
            fn = self._table_entry(accel, cfg, self.seg_order, **mode)
        return pt.tag_refine(fn, self.refine)

    def intersect_fn(self, accel, arrays: SceneArrays, cfg: ComputeConfig):
        """The flat entry (the negative-material path): the coarse table
        of a dual one; a segmented table through the flat segmented
        entry, the streamed one through kernel E."""
        accel = self._coarse(accel)
        win = dict(t_min=cfg.t_min, t_max=cfg.t_max, eps=cfg.eps)
        if self._streamed(accel):
            return partial(packet_stream.stream_closest_hit, accel, **win)
        if self._segments(accel) is not None:
            if self.cull_block is not None:
                win["cull_block"] = self.cull_block
            return partial(
                pt.packet_closest_hit_segmented, accel, ray_tile=self.block_lanes, **win
            )
        return tiled_as_flat(self._entry(accel, cfg), self.block_lanes)

    def intersect_tiled_fn(self, accel, arrays: SceneArrays, cfg: ComputeConfig):
        if self._streamed(accel):
            # The streamed table has no tiled entry: adapt the flat one.
            return super().intersect_tiled_fn(accel, arrays, cfg)
        return self._entry(accel, cfg)

    def intersect_tiled_rows_fn(self, accel, arrays: SceneArrays, cfg: ComputeConfig):
        accel = self._coarse(accel)
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
        return self._segments(self._coarse(accel)) is None

    def intersect_tiled_anyhit_fn(self, accel, arrays: SceneArrays, cfg: ComputeConfig):
        coarse = self._coarse(accel)
        if self._segments(coarse) is None and not pt.resident_fits(coarse):
            return None  # the streamed table has no any-hit entry
        return self._entry(accel, cfg, any_hit=True)

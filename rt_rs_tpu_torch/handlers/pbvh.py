"""Packet-BVH backend: the frame path's intersect kernels.

Counterpart of ``rt_rs_tpu/handlers/pbvh.py`` for resident chunk
tables.  ``build`` builds the BVH (which fixes the leaf order), reorders
the scene's prims into it, and packs the chunk table with its shade
rows on the scene's device; the intersect entries bind
:func:`rt_rs_tpu_torch.ops.packet_trace.packet_closest_hit_tiled` in
its closest-hit, emit-rows and any-hit modes.

Scenes beyond the JAX package's resident cap (its segmented and
DMA-streaming tables) and the dual-granularity table are not ported
yet (ROADMAP module item 10): they raise ``NotImplementedError``.
"""

from __future__ import annotations

from functools import partial

from rt_rs_tpu_torch.bvh import BvhData, build_bvh
from rt_rs_tpu_torch.config import ComputeConfig
from rt_rs_tpu_torch.handlers.base import IntrsHandler, IntrsStats
from rt_rs_tpu_torch.handlers.bvh import reorder_scene_arrays
from rt_rs_tpu_torch.ops.packet_trace import (
    MAX_VMEM_CHUNKS,
    TRI_CHUNK,
    TUNED_RAY_TILE,
    TUNED_TRI_CHUNK,
    TriChunks,
    build_tri_chunks,
    packet_closest_hit_tiled,
    resident_fits,
    tag_refine,
)
from rt_rs_tpu_torch.scene import Scene
from rt_rs_tpu_torch.scene.arrays import SceneArrays


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to rt_rs_tpu_torch yet (ROADMAP module item 10)"
    )


class PacketBvhIntrs(IntrsHandler):
    name = "Packet-BVH"
    block_lanes = TUNED_RAY_TILE  # one 16x16 pixel block per ray tile

    def __init__(
        self,
        eps: float = 0.02,
        target_item_count: int = 2,
        tri_chunk_fine: int | None = None,
        streaming_mode: str = "segmented",
    ):
        """``eps`` / ``target_item_count`` drive the BVH build
        (handlers/bvh.rs:33, 82).  The JAX package's other table
        layouts raise."""
        if tri_chunk_fine is not None:
            raise _not_ported("the dual-granularity table (tri_chunk_fine)")
        if streaming_mode not in ("segmented", "dma"):
            raise ValueError(f"unknown streaming_mode {streaming_mode!r}")
        if streaming_mode == "dma":
            raise _not_ported('streaming_mode="dma"')
        self.eps = eps
        self.target_item_count = target_item_count
        self.bvh_data: BvhData | None = None

    def build(self, scene: Scene, arrays: SceneArrays) -> tuple[TriChunks, SceneArrays]:
        self.bvh_data = build_bvh(
            scene, eps=self.eps, target_item_count=self.target_item_count
        )
        arrays = reorder_scene_arrays(arrays, self.bvh_data.indices)
        n_tris = arrays.pa.shape[0] - 1  # minus the null sentinel
        if n_tris > MAX_VMEM_CHUNKS * TRI_CHUNK:
            raise _not_ported(
                f"a {n_tris}-triangle scene (beyond the resident cap of "
                f"{MAX_VMEM_CHUNKS * TRI_CHUNK}; segmented tables)"
            )
        chunks = build_tri_chunks(
            arrays.pa.cpu().numpy(),
            arrays.pb.cpu().numpy(),
            arrays.pc.cpu().numpy(),
            max_chunks=None,
            tri_chunk=TUNED_TRI_CHUNK,
            shade_rows=arrays.shade_table.cpu().numpy(),
            device=arrays.device,
        )
        return chunks, arrays

    def stats(self, accel: TriChunks) -> IntrsStats:
        """The chunk table's device footprint: components, bounds and
        the rows table."""
        parts = [accel.comp, accel.bmin, accel.bmax]
        if accel.attr is not None:
            parts.append(accel.attr)
        return IntrsStats(
            name=self.name, size=sum(t.numel() * t.element_size() for t in parts)
        )

    def _entry(self, accel: TriChunks, cfg: ComputeConfig, **mode):
        # Bounce and shadow batches take the per-ray refine cull; the
        # coherent primaries keep the tile-interval cull.
        return tag_refine(
            partial(
                packet_closest_hit_tiled,
                accel,
                t_min=cfg.t_min,
                t_max=cfg.t_max,
                eps=cfg.eps,
                **mode,
            ),
            "bounces",
        )

    def intersect_tiled_fn(self, accel: TriChunks, arrays: SceneArrays, cfg: ComputeConfig):
        return self._entry(accel, cfg)

    def intersect_tiled_rows_fn(self, accel: TriChunks, arrays: SceneArrays, cfg: ComputeConfig):
        if accel.attr is None or not resident_fits(accel, with_attrs=True):
            return None
        return self._entry(accel, cfg, emit_rows=True)

    def intersect_tiled_anyhit_fn(self, accel: TriChunks, arrays: SceneArrays, cfg: ComputeConfig):
        if not resident_fits(accel):
            return None
        return self._entry(accel, cfg, any_hit=True)

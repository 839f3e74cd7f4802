"""RF-BVH backend: reduced-footprint 16-byte nodes.

Counterpart of ``rt_rs_tpu/handlers/rf.py`` (reference: ``RfBvhIntrs``,
``src/lib/handlers/rf.rs``): the BVH is built with ``target_item_count
= 4`` (rf.rs:64), packed into the 16-byte records of
:mod:`rt_rs_tpu_torch.bvh.rf` (f16 bounds, tagged interior and leaf
records, 8-slot u16 leaf payloads, interleaved), and ``stats`` reports
``16 B x records`` (rf.rs:216-219): the memory-against-speed trade the
reference study measures.

The records are the accel: one ``[R, 4]`` int32 tensor on the device
(:class:`~rt_rs_tpu_torch.ops.bvh_walk_rf.RfRecords`), and nothing else
of size.  The records walk (:mod:`rt_rs_tpu_torch.ops.bvh_walk_rf`:
``csrc/bvh_walk_rf.cu`` on the card, its plain twin on the CPU) reads
them where they lie, with the f16 bounds' precision loss part of the
measured backend, and the leaves' prims from the payload slots (0 =
empty), in the scene's own prim order, as the reference's RF handler
leaves ``scene.prims`` untouched; the corners come from the scene's
arrays at each call.  ``backend="auto"`` and ``"threaded"`` take it on
every device: the format's own cap of 2^15 records bounds the scene.
``backend="packet"`` takes the pbvh kernels over the scene arrays
reordered to leaf order (their hit ids are rows of the returned arrays,
as in ``handlers/bvh.py``), with the same records and footprint.
"""

from __future__ import annotations

import dataclasses

import torch

from rt_rs_tpu_torch.bvh import BvhData, build_bvh
from rt_rs_tpu_torch.bvh.rf import RfData, pack_rf
from rt_rs_tpu_torch.config import ComputeConfig
from rt_rs_tpu_torch.handlers.base import IntrsStats
from rt_rs_tpu_torch.handlers.bvh import TreeIntrs, check_modes, packet_chunks, reorder_scene_arrays
from rt_rs_tpu_torch.ops import bvh_walk_rf
from rt_rs_tpu_torch.ops import packet_trace as pt
from rt_rs_tpu_torch.ops.bvh_walk_rf import RfRecords
from rt_rs_tpu_torch.scene import Scene
from rt_rs_tpu_torch.scene.arrays import SceneArrays


@dataclasses.dataclass(frozen=True)
class RfAccel:
    """The records on the device, their byte footprint and, for
    ``backend="packet"``, the packet kernels' chunk table (else None)."""

    records: RfRecords
    footprint: int
    chunks: pt.TriChunks | None = None


class RfBvhIntrs(TreeIntrs):
    name = "RF-BVH"

    def __init__(
        self,
        eps: float = 0.02,
        target_item_count: int = 4,
        backend: str = "auto",
        refine: str = "bounces",
    ):
        """``RfBvhConfig`` parity: ``Eps(f32)`` or the default eps =
        0.02 (rf.rs:16-19, 30-37); the item count is fixed at 4 in the
        reference (rf.rs:64) and exposed here, as in the JAX package.
        ``backend``: ``"auto"`` / ``"threaded"`` (the records walk) or
        ``"packet"``; ``refine`` the packet backend's per-ray cull
        policy, as for ``BvhIntrs``."""
        check_modes(backend, refine)
        self.eps = eps
        self.target_item_count = target_item_count
        self.backend = backend
        self.refine = refine
        self.bvh_data: BvhData | None = None
        self.rf_data: RfData | None = None

    def build(self, scene: Scene, arrays: SceneArrays):
        data = build_bvh(scene, eps=self.eps, target_item_count=self.target_item_count)
        self.bvh_data = data
        rf = pack_rf(data, *data.cover_bounds(scene))
        self.rf_data = rf
        words = torch.from_numpy(rf.records.view("int32")).to(arrays.device)
        records = RfRecords(words=words, depth=data.max_depth())
        if self.backend == "packet":
            # Leaf order, internal to the packet path: the kernel's ids
            # are then the returned arrays' rows, with no remap.
            arrays = reorder_scene_arrays(arrays, data.indices)
            return RfAccel(records, rf.byte_size(), chunks=packet_chunks(arrays)), arrays
        if scene.num_prims == 0:
            # The unloaded pseudo-leaf's payload names prim 1: a copy of
            # the null row (see reorder_scene_arrays).
            arrays = reorder_scene_arrays(arrays, data.indices)
        return RfAccel(records, rf.byte_size()), arrays

    def stats(self, accel: RfAccel) -> IntrsStats:
        return IntrsStats(name="RF-BVH", size=accel.footprint)

    def intersect_tiled_fn(self, accel: RfAccel, arrays: SceneArrays, cfg: ComputeConfig):
        if accel.chunks is not None:
            return self._packet(accel, cfg)
        return records_fn(accel.records, arrays, cfg, "closest")

    def intersect_tiled_rows_fn(self, accel: RfAccel, arrays: SceneArrays, cfg: ComputeConfig):
        if accel.chunks is None:
            return records_fn(accel.records, arrays, cfg, "rows", arrays.shade_table.contiguous())
        if accel.chunks.attr is None or not pt.resident_fits(accel.chunks, with_attrs=True):
            return None
        return self._packet(accel, cfg, emit_rows=True)

    def intersect_tiled_anyhit_fn(self, accel: RfAccel, arrays: SceneArrays, cfg: ComputeConfig):
        if accel.chunks is not None:
            return self._packet(accel, cfg, any_hit=True)
        return records_fn(accel.records, arrays, cfg, "anyhit")


def records_fn(records: RfRecords, arrays: SceneArrays, cfg: ComputeConfig, mode: str, table=None):
    """The records walk in ``mode`` as a tiled intersect entry
    ``(payload, valid, t_cap=None)`` over the scene's corners; ``table``
    the shade table of the rows mode.  ``t_cap`` is accepted and
    ignored, as in the JAX walk: the any-hit mode reads each ray's cap
    from payload row 7."""
    pa, pb, pc = (x.contiguous() for x in (arrays.pa, arrays.pb, arrays.pc))

    def walk(payload, valid, t_cap=None):
        return bvh_walk_rf.bvh_walk_rf_tiled(
            payload.contiguous(), valid.contiguous(), records, pa, pb, pc,
            t_min=cfg.t_min, t_max=cfg.t_max, eps=cfg.eps, mode=mode, table=table,
        )

    return walk

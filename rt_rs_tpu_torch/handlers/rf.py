"""RF-BVH backend: reduced-footprint 16-byte nodes.

Counterpart of ``rt_rs_tpu/handlers/rf.py`` (reference: ``RfBvhIntrs``,
``src/lib/handlers/rf.rs``): the BVH is built with ``target_item_count
= 4`` (rf.rs:64), packed into the 16-byte records of
:mod:`rt_rs_tpu_torch.bvh.rf` (f16 bounds, tagged interior and leaf
records, 8-slot u16 leaf payloads, interleaved), and ``stats`` reports
``16 B x records`` (rf.rs:216-219): the memory-against-speed trade the
reference study measures.

The threaded walk (kernel G,
:func:`rt_rs_tpu_torch.ops.bvh_walk.bvh_walk`, over the records' tree
packed into wide records at build) runs on what the records hold: node
bounds unpacked from the f16 values (so their precision loss is part of
the measured backend) and leaf prims read from the payload
slots (0 = empty), in the scene's own prim order, as the reference's RF
handler leaves ``scene.prims`` untouched.  The packet backend reorders
the scene arrays to leaf order (its hit ids are rows of the returned
arrays, as in ``handlers/bvh.py``); the records and footprint are the
same.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from rt_rs_tpu_torch.bvh import BvhData, build_bvh
from rt_rs_tpu_torch.bvh.rf import RfData, pack_rf, unpack_rf
from rt_rs_tpu_torch.bvh.wide import WalkTree, walk_tree
from rt_rs_tpu_torch.handlers.base import IntrsStats
from rt_rs_tpu_torch.handlers.bvh import (
    TreeIntrs,
    check_modes,
    packet_chunks,
    reorder_scene_arrays,
    use_packet,
    walk_prims,
)
from rt_rs_tpu_torch.ops import packet_trace as pt
from rt_rs_tpu_torch.scene import Scene
from rt_rs_tpu_torch.scene.arrays import SceneArrays


@dataclasses.dataclass(frozen=True)
class RfArrays:
    node_min: torch.Tensor  # [N, 3] float32 (f16-roundtripped, conservative)
    node_max: torch.Tensor  # [N, 3]
    hit_link: torch.Tensor  # [N] int32
    miss_link: torch.Tensor  # [N] int32
    payload: torch.Tensor  # [N * 8] int32 prim ids (+1 space; 0 = empty)
    leaf_count: torch.Tensor  # [N] int32
    num_nodes: int
    footprint: int


@dataclasses.dataclass(frozen=True)
class RfAccel:
    """The records' walk tensors plus the packet backend's chunk table
    or the threaded walk's packed tree (the other None)."""

    records: RfArrays
    chunks: pt.TriChunks | None = None
    walk: WalkTree | None = None


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
        ``backend`` and ``refine`` as for ``BvhIntrs``."""
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

        # Unpack through the 16-byte format, so the walk sees exactly
        # the f16 bounds and payload ids the records hold; record rows
        # back to node space (payload rows skipped).
        un = unpack_rf(rf)
        node_rows = np.where(~un["is_payload"])[0]
        if node_rows.size != data.num_nodes:
            raise AssertionError(f"{node_rows.size} node records for {data.num_nodes} nodes")
        hit_link, miss_link = data.escape_links()
        dev = arrays.device

        def tensor(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        records = RfArrays(
            node_min=tensor(un["bmin"][node_rows]),
            node_max=tensor(un["bmax"][node_rows]),
            hit_link=tensor(hit_link),
            miss_link=tensor(miss_link),
            payload=tensor(un["leaf_prims"][node_rows].reshape(-1).astype(np.int32)),
            leaf_count=tensor(data.item_count.astype(np.int32)),
            num_nodes=data.num_nodes,
            footprint=rf.byte_size(),
        )
        if use_packet(self.backend, scene.num_prims, dev):
            # Leaf order, internal to the packet path: the kernel's ids
            # are then the returned arrays' rows, with no remap.
            arrays = reorder_scene_arrays(arrays, data.indices)
            return RfAccel(records=records, chunks=packet_chunks(arrays)), arrays
        if scene.num_prims == 0:
            # The unloaded pseudo-leaf's payload names prim 1: a copy of
            # the null row (see reorder_scene_arrays).
            arrays = reorder_scene_arrays(arrays, data.indices)
        tree = (
            records.node_min, records.node_max, records.hit_link, records.miss_link,
            records.leaf_count, records.payload, *walk_prims(arrays),
        )
        return RfAccel(records=records, walk=walk_tree(tree, payload=True)), arrays

    def stats(self, accel: RfAccel) -> IntrsStats:
        return IntrsStats(name="RF-BVH", size=accel.records.footprint)

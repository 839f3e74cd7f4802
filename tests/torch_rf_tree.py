"""rf_bvh's tree as the JAX package's ``_rf_intersect`` steps it: the
records unpacked to f32 node arrays with escape links and 8 payload
slots a node, which kernel G's payload leaves (``ops/bvh_walk.py``,
``wide.pack_walk(payload=True)``) walk.

The ``rf_bvh`` handler keeps only the records on its device and walks
them with ``ops/bvh_walk_rf.py``; the tests of kernel G's payload leaves
and of the pack build this tree from the handler's own build, as the
handler did before the records walk.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from rt_rs_tpu_torch.bvh.rf import unpack_rf
from rt_rs_tpu_torch.bvh.wide import WalkTree, walk_tree
from rt_rs_tpu_torch.handlers import get_handler
from rt_rs_tpu_torch.handlers.bvh import walk_prims


@dataclasses.dataclass(frozen=True)
class RfArrays:
    """The JAX package's ``RfArrays``: the records' nodes as f32 arrays."""

    node_min: torch.Tensor  # [N, 3] float32 (f16-roundtripped, conservative)
    node_max: torch.Tensor  # [N, 3]
    hit_link: torch.Tensor  # [N] int32
    miss_link: torch.Tensor  # [N] int32
    payload: torch.Tensor  # [N * 8] int32 prim ids (+1 space; 0 = empty)
    leaf_count: torch.Tensor  # [N] int32
    num_nodes: int
    footprint: int


@dataclasses.dataclass(frozen=True)
class RfWalkAccel:
    """The f32 arrays, kernel G's tree of them and the records'
    footprint (what ``RfBvhIntrs.stats`` reads)."""

    records: RfArrays
    walk: WalkTree
    footprint: int


def rf_walk_build(scene, device="cpu", **handler_kwargs):
    """Build ``rf_bvh`` on ``scene`` -> (RfWalkAccel, the arrays it
    shades with, the handler)."""
    h = get_handler("rf_bvh", backend="threaded", **handler_kwargs)
    accel, arrays = h.build(scene, scene.pack(device=device))
    data, rf = h.bvh_data, h.rf_data
    un = unpack_rf(rf)
    node_rows = np.where(~un["is_payload"])[0]
    assert node_rows.size == data.num_nodes
    hit_link, miss_link = data.escape_links()

    def tensor(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    records = RfArrays(
        node_min=tensor(un["bmin"][node_rows]),
        node_max=tensor(un["bmax"][node_rows]),
        hit_link=tensor(hit_link),
        miss_link=tensor(miss_link),
        payload=tensor(un["leaf_prims"][node_rows].reshape(-1).astype(np.int32)),
        leaf_count=tensor(data.item_count.astype(np.int32)),
        num_nodes=data.num_nodes,
        footprint=accel.footprint,
    )
    tree = (
        records.node_min, records.node_max, records.hit_link, records.miss_link,
        records.leaf_count, records.payload, *walk_prims(arrays),
    )
    return RfWalkAccel(records, walk_tree(tree, payload=True), accel.footprint), arrays, h

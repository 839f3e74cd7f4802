"""A one-prim-per-leaf LBVH built on the device, as a :class:`BvhData`.

Counterpart of ``rt_rs_tpu/bvh/device.py``.  The heavy phases run as
torch ops on the given device (:mod:`rt_rs_tpu_torch.ops.lbvh`: Morton
codes, the stable sort, Karras' hierarchy emit and the bounds refit);
only the preorder flatten, a pointer-chasing serialization, runs on the
host.  The result is an ordinary :class:`BvhData`: the ``bvh``,
``rf_bvh`` and ``pbvh`` handlers take it as ``data=``, and it saves to
the reference's checkpoint JSON.
"""

from __future__ import annotations

import numpy as np
import torch

from rt_rs_tpu_torch.bvh import BvhData
from rt_rs_tpu_torch.ops.lbvh import (
    centroid_codes,
    karras_hierarchy,
    morton_order,
    refit_bounds,
)


def device_phases(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor):
    """Triangle corners [P, 3] on a device -> (order, left, right,
    left_leaf, right_leaf, node_min, node_max, leaf_min, leaf_max), all
    on that device; leaves in Morton order."""
    codes = centroid_codes(a, b, c)
    order = morton_order(codes)
    o = order.long()
    codes_sorted = codes[o]
    left, right, left_leaf, right_leaf, _, _ = karras_hierarchy(codes_sorted)
    leaf_min = torch.minimum(torch.minimum(a, b), c)[o]
    leaf_max = torch.maximum(torch.maximum(a, b), c)[o]
    node_min, node_max = refit_bounds(left, right, left_leaf, right_leaf, leaf_min, leaf_max)
    return order, left, right, left_leaf, right_leaf, node_min, node_max, leaf_min, leaf_max


def build_bvh_device(scene, *, device: str | torch.device) -> BvhData:
    """Scene -> flattened one-prim-per-leaf LBVH, its device phases run
    on ``device``.  Raises ``ValueError`` for a scene with no prims."""
    idx = np.asarray(scene.prim_indices, dtype=np.int64)
    p = int(idx.shape[0])
    if p == 0:
        raise ValueError("cannot build a BVH for a scene with no prims")
    verts = torch.from_numpy(np.asarray(scene.vert_pos, dtype=np.float32)).to(device)
    it = torch.from_numpy(idx).to(device)
    a, b, c = verts[it[:, 0]], verts[it[:, 1]], verts[it[:, 2]]
    (order, left, right, left_leaf, right_leaf, node_min, node_max, leaf_min, leaf_max) = (
        x.cpu().numpy() for x in device_phases(a, b, c)
    )

    if p == 1:
        return BvhData(
            fst=np.zeros(1, np.uint32),
            snd=np.zeros(1, np.uint32),
            item_idx=np.zeros(1, np.uint32),
            item_count=np.ones(1, np.uint32),
            bounds_min=leaf_min.astype(np.float32),
            bounds_max=leaf_max.astype(np.float32),
            indices=order.astype(np.uint32),
        )

    # Preorder flatten (host): Karras internal node 0 is the root, the
    # leaves are the Morton-sorted prims.  Children are patched into
    # their parent's slot as in BvhData.from_tree, which keeps the
    # reference's invariant (children at larger indices) that the
    # escape links and the handlers rely on.
    n = 2 * p - 1
    fst = np.zeros(n, np.uint32)
    snd = np.zeros(n, np.uint32)
    item_idx = np.zeros(n, np.uint32)
    item_count = np.zeros(n, np.uint32)
    bmin = np.zeros((n, 3), np.float32)
    bmax = np.zeros((n, 3), np.float32)
    indices = np.zeros(p, np.uint32)
    cursor = emitted = 0

    def alloc(node: int, leaf: bool) -> int:
        nonlocal cursor, emitted
        slot = cursor
        cursor += 1
        if leaf:
            item_idx[slot] = emitted
            item_count[slot] = 1
            indices[emitted] = order[node]
            emitted += 1
            bmin[slot], bmax[slot] = leaf_min[node], leaf_max[node]
        else:
            bmin[slot], bmax[slot] = node_min[node], node_max[node]
        return slot

    root = alloc(0, False)
    stack = [
        (int(right[0]), bool(right_leaf[0]), root, snd),
        (int(left[0]), bool(left_leaf[0]), root, fst),
    ]
    while stack:
        node, leaf, parent, side = stack.pop()
        slot = alloc(node, leaf)
        side[parent] = slot
        if not leaf:
            stack.append((int(right[node]), bool(right_leaf[node]), slot, snd))
            stack.append((int(left[node]), bool(left_leaf[node]), slot, fst))

    assert cursor == n and emitted == p
    return BvhData(
        fst=fst, snd=snd, item_idx=item_idx, item_count=item_count,
        bounds_min=bmin, bounds_max=bmax, indices=indices,
    )

"""CPU BVH builder: recursive median spatial split.

Algorithm-exact port of ``src/lib/bvh/aabb.rs:149-281`` (same split
rules, same f32 arithmetic, same tie-breaking), vectorized with NumPy
instead of per-prim Rust loops:

* split the largest axis at the midpoint (aabb.rs:179-194; note the
  exact ``>=`` tie order: x wins over y wins over z);
* stop when ``len(items) <= target_item_count`` (aabb.rs:159-161) or
  the winning axis extent is ``< eps * 0.5`` (aabb.rs:180-192);
* partition prims by *centroid containment* in the first half-box
  (aabb.rs:196-219; centroid = mean of edge midpoints, f32);
* if one side is empty, shrink to the other half and re-split in place
  (aabb.rs:221-229);
* otherwise refit both children to their contents' vertex extrema
  (aabb.rs:232-241) and recurse.

Bit-compatibility matters: building ``teatime.json`` with
``eps=0.02, target=2`` must reproduce the shipped
``teatime.bvh.json`` checkpoint exactly (verified in
``tests/test_bvh.py``), so all arithmetic is float32 in reference
operation order.

Copied from ``rt_rs_tpu/bvh/builder.py`` (the JAX package's NumPy
oracle) so both packages build bit-identical trees.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Aabb:
    """Pointer-tree node (aabb.rs:120-125); flattened by BvhData."""

    bounds_min: np.ndarray  # [3] float32
    bounds_max: np.ndarray  # [3] float32
    items: np.ndarray  # [K] int64 prim indices (empty for interior)
    fst: "Aabb | None" = None
    snd: "Aabb | None" = None


def _extrema(
    pmin: np.ndarray, pmax: np.ndarray, items: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Vertex extrema of a prim subset (Bounds::new, aabb.rs:77-108)."""
    if items.size == 0:
        return (
            np.full(3, np.float32(np.finfo(np.float32).max)),
            np.full(3, np.float32(-np.finfo(np.float32).max)),
        )
    return pmin[items].min(axis=0), pmax[items].max(axis=0)


def build_aabb_tree(scene, eps: float, target_item_count: int) -> Aabb:
    """Scene -> Aabb tree (``Aabb::from_scene``, aabb.rs:259-281)."""
    p = scene.num_prims
    verts = scene.vert_pos.astype(np.float32)
    idx = scene.prim_indices.astype(np.int64)

    if p == 0:
        # from_scene_unloaded (aabb.rs:250-257): single pseudo-leaf.
        return Aabb(
            bounds_min=np.full(3, np.float32(np.finfo(np.float32).max)),
            bounds_max=np.full(3, np.float32(-np.finfo(np.float32).max)),
            items=np.array([0], dtype=np.int64),
        )

    a = verts[idx[:, 0]]
    b = verts[idx[:, 1]]
    c = verts[idx[:, 2]]

    # Per-prim vertex extrema (for Bounds::new refits).
    pmin = np.minimum(np.minimum(a, b), c)
    pmax = np.maximum(np.maximum(a, b), c)

    # Centroids in f32 reference order (aabb.rs:196-209):
    # ((a+b)/2 + (b+c)/2 + (c+a)/2) * (1/3)
    half = np.float32(0.5)
    third = np.float32(1.0) / np.float32(3.0)
    cent = (((a + b) * half + (b + c) * half) + (c + a) * half) * third

    eps_half = np.float32(eps) * np.float32(0.5)

    root = Aabb(
        bounds_min=pmin.min(axis=0),
        bounds_max=pmax.max(axis=0),
        items=np.arange(p, dtype=np.int64),
    )

    # Iterative DFS (the reference recurses; teatime is ~13 deep but
    # degenerate scenes can exceed Python's recursion limit).
    stack = [root]
    while stack:
        node = stack.pop()
        # The "re-split in place" loop (aabb.rs:221-229).
        while True:
            items = node.items
            if items.size <= target_item_count:
                break

            d = node.bounds_max - node.bounds_min  # f32

            if d[0] >= d[1] and d[0] >= d[2]:
                axis = 0
            elif d[1] >= d[2] and d[1] >= d[0]:
                axis = 1
            else:
                axis = 2
            if d[axis] < eps_half:
                break

            mid = node.bounds_min[axis] + d[axis] * half  # f32

            fst_min = node.bounds_min.copy()
            fst_max = node.bounds_max.copy()
            fst_max[axis] = mid
            snd_min = node.bounds_min.copy()
            snd_max = node.bounds_max.copy()
            snd_min[axis] = mid

            ci = cent[items]
            in_fst = np.all((ci >= fst_min) & (ci <= fst_max), axis=1)
            fst_items = items[in_fst]
            snd_items = items[~in_fst]

            if fst_items.size == 0:
                node.bounds_min, node.bounds_max = snd_min, snd_max
                continue
            if snd_items.size == 0:
                node.bounds_min, node.bounds_max = fst_min, fst_max
                continue

            f_min, f_max = _extrema(pmin, pmax, fst_items)
            s_min, s_max = _extrema(pmin, pmax, snd_items)
            node.fst = Aabb(bounds_min=f_min, bounds_max=f_max, items=fst_items)
            node.snd = Aabb(bounds_min=s_min, bounds_max=s_max, items=snd_items)
            node.items = np.empty(0, dtype=np.int64)  # items.clear()
            stack.append(node.fst)
            stack.append(node.snd)
            break

    return root

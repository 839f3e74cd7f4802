"""Flattened BVH data (the ``*.bvh.json`` checkpoint format).

Counterpart of ``rt_rs_tpu/bvh/__init__.py``: ``BvhData`` is the
reference's flattened tree (``src/lib/bvh/mod.rs:11-27``), a preorder
DFS array of nodes ``{fst, snd, item_idx, item_count, bounds}`` plus the
``indices`` permutation listing each leaf's prims contiguously.  The
pbvh handler uses only that permutation (the leaf order of its chunk
table).  The JAX package's native C++ builder is not ported:
:func:`build_bvh` runs the NumPy builder, which produces the same tree
bit for bit.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Mapping

import numpy as np

from rt_rs_tpu_torch.bvh.builder import Aabb, build_aabb_tree
from rt_rs_tpu_torch.geom import f32_json as _f32j


@dataclasses.dataclass
class BvhData:
    """SoA form of ``Vec<AabbUniform>`` + ``Vec<u32>`` (bvh/mod.rs:24-27)."""

    fst: np.ndarray  # [N] uint32
    snd: np.ndarray  # [N] uint32
    item_idx: np.ndarray  # [N] uint32 (offset into `indices`)
    item_count: np.ndarray  # [N] uint32 (0 = interior)
    bounds_min: np.ndarray  # [N, 3] float32
    bounds_max: np.ndarray  # [N, 3] float32
    indices: np.ndarray  # [I] uint32 (prim permutation, leaf-contiguous)

    @property
    def num_nodes(self) -> int:
        return int(self.fst.shape[0])

    @classmethod
    def from_tree(cls, root: Aabb) -> "BvhData":
        """Flatten (bvh/mod.rs:29-64): preorder DFS, children patched in.
        An explicit LIFO (snd pushed before fst) gives exactly the
        reference's recursive preorder without Python recursion."""
        fst: list[int] = []
        snd: list[int] = []
        item_idx: list[int] = []
        item_count: list[int] = []
        bmin: list[np.ndarray] = []
        bmax: list[np.ndarray] = []
        indices: list[int] = []

        def alloc(node: Aabb) -> int:
            uniform = len(fst)
            fst.append(0)
            snd.append(0)
            item_idx.append(len(indices))
            item_count.append(len(node.items))
            bmin.append(node.bounds_min)
            bmax.append(node.bounds_max)
            indices.extend(int(i) for i in node.items)
            return uniform

        stack: list[tuple[Aabb, int, str]] = []
        root_idx = alloc(root)
        if root.snd is not None:
            stack.append((root.snd, root_idx, "snd"))
        if root.fst is not None:
            stack.append((root.fst, root_idx, "fst"))
        while stack:
            node, parent, slot = stack.pop()
            idx = alloc(node)
            if slot == "fst":
                fst[parent] = idx
            else:
                snd[parent] = idx
            if node.snd is not None:
                stack.append((node.snd, idx, "snd"))
            if node.fst is not None:
                stack.append((node.fst, idx, "fst"))

        return cls(
            fst=np.array(fst, dtype=np.uint32),
            snd=np.array(snd, dtype=np.uint32),
            item_idx=np.array(item_idx, dtype=np.uint32),
            item_count=np.array(item_count, dtype=np.uint32),
            bounds_min=np.stack(bmin).astype(np.float32),
            bounds_max=np.stack(bmax).astype(np.float32),
            indices=np.array(indices, dtype=np.uint32),
        )

    # ------------------------------------------------------------------
    # JSON serde (bvh/mod.rs:21-27 derive; format of scenes/*.bvh.json)

    @classmethod
    def from_json(cls, data: Mapping[str, Any]) -> "BvhData":
        uniforms = data["uniforms"]
        n = len(uniforms)
        out = cls(
            fst=np.zeros(n, dtype=np.uint32),
            snd=np.zeros(n, dtype=np.uint32),
            item_idx=np.zeros(n, dtype=np.uint32),
            item_count=np.zeros(n, dtype=np.uint32),
            bounds_min=np.zeros((n, 3), dtype=np.float32),
            bounds_max=np.zeros((n, 3), dtype=np.float32),
            indices=np.array(data["indices"], dtype=np.uint32),
        )
        for i, u in enumerate(uniforms):
            out.fst[i] = u["fst"]
            out.snd[i] = u["snd"]
            out.item_idx[i] = u["item_idx"]
            out.item_count[i] = u["item_count"]
            out.bounds_min[i] = u["bounds"]["min"]
            out.bounds_max[i] = u["bounds"]["max"]
        return out

    def to_json(self) -> dict[str, Any]:
        return {
            "uniforms": [
                {
                    "fst": int(self.fst[i]),
                    "snd": int(self.snd[i]),
                    "item_idx": int(self.item_idx[i]),
                    "item_count": int(self.item_count[i]),
                    "bounds": {
                        "min": [_f32j(x) for x in self.bounds_min[i]],
                        "max": [_f32j(x) for x in self.bounds_max[i]],
                    },
                }
                for i in range(self.num_nodes)
            ],
            "indices": [int(i) for i in self.indices],
        }

    @classmethod
    def load(cls, path: str) -> "BvhData":
        with open(path, "r") as f:
            return cls.from_json(json.load(f))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f)


def build_bvh(
    scene,
    eps: float = 0.02,
    target_item_count: int = 2,
) -> BvhData:
    """Scene -> flattened BVH (reference ``Aabb::from_scene`` +
    ``BvhData::new``; defaults from handlers/bvh.rs:33, 82)."""
    root = build_aabb_tree(scene, eps=eps, target_item_count=target_item_count)
    return BvhData.from_tree(root)


__all__ = ["BvhData", "build_bvh", "Aabb", "build_aabb_tree"]

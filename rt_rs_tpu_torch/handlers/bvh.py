"""BVH leaf-order helpers.

Only :func:`reorder_scene_arrays` of ``rt_rs_tpu/handlers/bvh.py`` is
ported: the pbvh handler packs its chunk table in the BVH's leaf order.
The threaded-traversal ``bvh`` handler itself is not ported yet
(ROADMAP §1 item 4).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from rt_rs_tpu_torch.scene.arrays import SceneArrays


def reorder_scene_arrays(arrays: SceneArrays, indices: np.ndarray) -> SceneArrays:
    """Apply the leaf-contiguous prim permutation (bvh.rs:103-110),
    keeping the null sentinel at row 0 and accounting for its +1
    offset."""
    perm = np.concatenate([[0], np.asarray(indices, dtype=np.int64) + 1])
    perm_t = torch.from_numpy(perm).to(arrays.device)
    return dataclasses.replace(
        arrays,
        prim_mat=arrays.prim_mat[perm_t],
        pa=arrays.pa[perm_t],
        pb=arrays.pb[perm_t],
        pc=arrays.pc[perm_t],
        na=arrays.na[perm_t],
        nb=arrays.nb[perm_t],
        nc=arrays.nc[perm_t],
        shade_table=arrays.shade_table[perm_t],
    )

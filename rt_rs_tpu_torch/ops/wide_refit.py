"""The per-frame refit of the walk's trees: new boxes and prims from new
corners, the topology fixed.

``DynamicRenderer``'s walked path (``refit=True`` under the default
backend or ``"threaded"``) builds the ``bvh`` handler's binary tree once,
at the rest pose, and packs it once into kernel G's wide records
(:func:`rt_rs_tpu_torch.bvh.wide.pack_walk`).
Each frame then gathers the prims' corners from the frame's vertices and
rewrites, in place:

* each packed prim's 48-byte record ``{a, pid}, {b - a, last}, {c - a,
  0}`` from its row of the corners;
* each used child slot's box, the union of the prims under it (a
  contiguous range of packed prims, :func:`~rt_rs_tpu_torch.bvh.wide.refit_map`),
  with the walk's wobble applied as ``pack_walk`` rounds it: ``min - wob``
  and ``max + wob``, ``wob = 2e-6 + 1e-5 * max(|min|, |max|)``.

A union over a subset of prims lies inside the union over a superset in
f32 exactly, so the boxes nest as ``pack_walk``'s invariants require,
and the wide walk still enters the binary walk's leaves in its order.
The empty union is the inverted box ``(f32 max, -f32 max)`` of
``BvhData.cover_bounds``.  Min and max are NaN-propagating
(``torch.minimum``), and their order changes no bit but a zero's sign,
which the wobble's subtraction and addition drop.

:func:`wide_refit` runs the kernel ``csrc/wide_refit.cu`` on CUDA
tensors, reading nothing back, so a frame that calls it can be captured
in a CUDA graph; on CPU tensors its twin :func:`wide_refit_reference`.
While tracing is on, it counts the prim records and node slots it
writes (``tracing.py``: ``refit_prims``, ``refit_nodes``).

On the CPU nothing is packed: the twin walk steps through the binary
tree, whose covering bounds :func:`binary_refit` recomputes from the
corners as ``BvhData.cover_bounds`` does (a leaf the extrema of its
prims, an interior node the union of its children's).
"""

from __future__ import annotations

import numpy as np
import torch

from rt_rs_tpu_torch import tracing
from rt_rs_tpu_torch.bvh import wide
from rt_rs_tpu_torch.bvh.wide import BinaryRefit, RefitMap, WalkTree
from rt_rs_tpu_torch.ops import cuda

FMAX = float(np.finfo(np.float32).max)  # cover_bounds' empty box: (FMAX, -FMAX)


def corner_bounds(pa: torch.Tensor, pb: torch.Tensor, pc: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Each row's box [R, 3]: the corners' NaN-propagating min and max."""
    return torch.minimum(torch.minimum(pa, pb), pc), torch.maximum(torch.maximum(pa, pb), pc)


def _reduce(lo, hi, index, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Boxes ``lo`` / ``hi`` [E, 3] unioned into ``n`` boxes by
    ``index`` [E]; a box with no entry stays empty."""
    idx = index[:, None].expand(-1, 3)
    out_lo = torch.full((n, 3), FMAX, dtype=lo.dtype, device=lo.device)
    out_hi = torch.full((n, 3), -FMAX, dtype=hi.dtype, device=hi.device)
    return (
        out_lo.scatter_reduce(0, idx, lo, "amin", include_self=True),
        out_hi.scatter_reduce(0, idx, hi, "amax", include_self=True),
    )


def range_bounds(lo: torch.Tensor, hi: torch.Tensor, ranges: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The union of boxes ``lo`` / ``hi`` [Q, 3] over each ``[first,
    end)`` of ``ranges`` [U, 2] -> ([U, 3], [U, 3])."""
    first, end = ranges[:, 0].long(), ranges[:, 1].long()
    n = end - first
    slot = torch.repeat_interleave(torch.arange(ranges.shape[0], device=lo.device), n)
    pos = torch.arange(slot.shape[0], device=lo.device) - (torch.cumsum(n, 0) - n)[slot] + first[slot]
    return _reduce(lo[pos], hi[pos], slot, ranges.shape[0])


def wide_refit_reference(pa, pb, pc, tree: WalkTree, refit: RefitMap) -> None:
    """Plain-PyTorch twin of :func:`wide_refit`: ``tree.prims`` and the
    used slots' boxes of ``tree.nodes`` rewritten in place from the
    corners [P + 1, 3]."""
    meta = refit.prim_meta
    row = meta[:, 0].long()
    a, b, c = pa[row], pb[row], pc[row]
    i32 = torch.int32
    tree.prims.copy_(
        torch.cat(
            [
                a.view(i32), meta[:, 0:1], (b - a).view(i32), meta[:, 1:2], (c - a).view(i32),
                torch.zeros_like(meta[:, 0:1]),
            ],
            dim=1,
        )
    )
    lo, hi = wide.wobbled(*range_bounds(*corner_bounds(a, b, c), refit.slot_range))
    flat = tree.nodes.view(-1)
    word = refit.slot_word.long()
    for axis in range(3):
        flat[word + 2 * axis * wide.WIDTH] = lo[:, axis].contiguous().view(i32)
        flat[word + (2 * axis + 1) * wide.WIDTH] = hi[:, axis].contiguous().view(i32)


def wide_refit(pa: torch.Tensor, pb: torch.Tensor, pc: torch.Tensor, tree: WalkTree, refit: RefitMap) -> None:
    """Rewrite ``tree``'s packed prims and the used child slots' boxes
    in place from the frame's corners ``pa``, ``pb``, ``pc`` [P + 1, 3]
    f32 (the rows ``refit.prim_meta`` names; row 0 the null sentinel):
    the kernel on CUDA tensors (one launch), the twin on CPU tensors."""
    q, u = refit.prim_meta.shape[0], refit.slot_word.shape[0]
    dev = pa.device
    if not pa.is_cuda:
        wide_refit_reference(pa, pb, pc, tree, refit)
        if tracing.counting(dev):
            tracing.add(dev, "refit_prims", q)
            tracing.add(dev, "refit_nodes", u)
        return
    for name, x in (("pa", pa), ("pb", pb), ("pc", pc)):
        cuda.check(name, x, torch.float32, (refit.rows, 3), dev)
    cuda.check("nodes", tree.nodes, torch.int32, (tree.nodes.shape[0], wide.NODE_WORDS), dev)
    cuda.check("prims", tree.prims, torch.int32, (q, wide.PRIM_WORDS), dev)
    cuda.check("prim_meta", refit.prim_meta, torch.int32, (q, 2), dev)
    cuda.check("slot_word", refit.slot_word, torch.int32, (u,), dev)
    cuda.check("slot_range", refit.slot_range, torch.int32, (u, 2), dev)
    cuda.call(
        "wide_refit", "rt_wide_refit",
        pa.data_ptr(), pb.data_ptr(), pc.data_ptr(), refit.prim_meta.data_ptr(), q,
        refit.slot_word.data_ptr(), refit.slot_range.data_ptr(), u, refit.block_slots,
        tree.nodes.data_ptr(), tree.prims.data_ptr(),
        *tracing.kernel_args(dev, "refit_prims"),
    )


def binary_refit(pa, pb, pc, topo: BinaryRefit) -> tuple[torch.Tensor, torch.Tensor]:
    """The binary tree's covering bounds (node_min, node_max) [M, 3]
    from the corners [P + 1, 3], in torch ops: each leaf the union of
    its rows' boxes, then each depth's interior nodes, deepest first,
    the union of their children's (``BvhData.cover_bounds``)."""
    lo, hi = corner_bounds(pa[topo.rows], pb[topo.rows], pc[topo.rows])
    node_min, node_max = _reduce(lo, hi, topo.leaf, topo.num_nodes)
    for node, fst, snd in topo.levels:
        node_min[node] = torch.minimum(node_min[fst], node_min[snd])
        node_max[node] = torch.maximum(node_max[fst], node_max[snd])
    return node_min, node_max

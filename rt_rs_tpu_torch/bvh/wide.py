"""The threaded walk's tree as kernel G takes it: packed records of a
wide tree, built once per accel on a CUDA device.

The ``bvh`` handler's binary tree
(:class:`~rt_rs_tpu_torch.handlers.bvh.BvhArrays`; payload leaves take
the RF tree unpacked to the same arrays, which no handler builds since
``rf_bvh`` walks its records with ``ops/bvh_walk_rf.py``) is what the
JAX walk and its twin :func:`~rt_rs_tpu_torch.ops.bvh_walk.bvh_walk_reference` step
through over escape links, one box a step.  :func:`pack_walk` collapses
it into ``WIDTH``-wide nodes, each holding its children's boxes, and
packs the prims the leaves test in the order they test them:

* a **node** is ``NODE_WORDS`` int32 words (128 B), read as 16-byte
  vectors: the children's slab bounds ``lo.x``, ``hi.x``, ``lo.y``,
  ``hi.y``, ``lo.z``, ``hi.z`` (``WIDTH`` each, f32 bits, the walk's
  wobble already applied: ``min - wob`` and ``max + wob`` with ``wob =
  2e-6 + 1e-5 * max(|min|, |max|)``, the rounding of
  ``bvh_walk.node_slab``), then ``WIDTH`` child words: ``k > 0`` for
  wide node ``k``, ``~q`` (negative) for a leaf whose prims start at
  packed prim ``q``, 0 for an empty slot (node 0, the root, is never a
  child);
* a **prim** is ``PRIM_WORDS`` words (48 B): ``{a, pid}``, ``{b - a,
  last}``, ``{c - a, 0}``, with ``pid`` the id the walk reports (the
  scene row; in payload mode the slot's id, empty slots dropped) and
  ``last`` 1 on the final prim of its leaf.  The edges are the f32
  subtractions the prim test makes, so the test keeps its bits.

Children are kept in preorder (a collapse replaces an interior child by
its two children in place, largest surface area first), so a walk that
pushes a node's passing children in reverse and pops them in order
enters the binary walk's leaves in its order.  That it enters exactly
those leaves, with the same best t at each, rests on the invariants
:func:`pack_walk` checks and raises on (:class:`WideTreeError`):

* the links are a preorder binary tree: interior ``i``'s hit link is
  its first child ``i + 1``, its second child is that child's miss
  link, and a leaf's hit link is its escape (its miss link);
* bounds nest exactly: each child's box lies inside its parent's, in
  f32, and every leaf with a prim to test, but the root, has a box with
  ``min <= max`` (the root's box is tested as the binary walk tests it).

Every step of the slab test is a monotone f32 operation, so a box that
passes implies that each ancestor passed at its own, earlier visit
(ancestors have a lower near, a higher far, and a best t no smaller):
the wide walk tests none of the collapsed boxes and loses no leaf.
Subtrees with no prim to test are dropped.  A scene with no prims
packs as its one leaf, the root, whose box (inverted: min above max)
is tested as the binary walk tests it, and whose prim is a copy of the
null row that no ray hits (``handlers.bvh.reorder_scene_arrays``).

The stack a walk needs grows with the tree's depth (about one entry a
binary level on a chain).  ``stack`` records it; kernel G keeps up to
``LOCAL_STACK`` entries a thread in local memory and takes a deeper
stack in a scratch buffer the wrapper allocates.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

WIDTH = 4  # children per wide node (kWidth in csrc/bvh_walk.cu)
NODE_WORDS = 8 * WIDTH  # 6 bounds rows and the child words, padded to 32 B
PRIM_WORDS = 12
LOCAL_STACK = 64  # stack entries kept in local memory (kLocalStack in csrc/bvh_walk.cu)
SLOTS = 8  # payload slots per node (the RF leaf record)


class WideTreeError(ValueError):
    """The binary tree breaks an invariant the wide walk rests on."""


@dataclasses.dataclass(frozen=True)
class WalkTree:
    """One tree for the threaded walk: the binary tree and prims the
    twin steps through (``binary``: node_min, node_max, hit_link,
    miss_link, leaf_count, leaves, pa, pb, pc) and, where kernel G reads
    them, its packed records of the same tree (``nodes`` [K,
    NODE_WORDS], ``prims`` [Q, PRIM_WORDS], int32; None when not
    packed), with ``stack`` the most entries a ray's walk pushes."""

    binary: tuple[torch.Tensor, ...]
    payload: bool
    nodes: torch.Tensor | None = None
    prims: torch.Tensor | None = None
    stack: int = 0

    @property
    def device_bytes(self) -> int:
        """Bytes of the packed records (internal: ``Renderer.stats``
        reports the JAX package's footprints)."""
        return sum(t.numel() * t.element_size() for t in (self.nodes, self.prims) if t is not None)


def _first_bad(bad: np.ndarray, idx: np.ndarray | None = None) -> int | None:
    """The first node flagged in ``bad`` (of ``idx``, if given), or None."""
    if not bad.any():
        return None
    j = int(np.argmax(bad))
    return j if idx is None else int(idx[j])


def _children(hit: np.ndarray, miss: np.ndarray, leaf: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The preorder binary tree the links describe -> (fst, snd), -1 on
    leaves; raises where the links are not one.  With ``[i, miss[i])``
    node ``i``'s subtree, it checks that the root's is every node, that
    a leaf's is itself alone, and that an interior node's is itself,
    its first child's ``[i + 1, s)`` and its second child's ``[s,
    miss[i])``: by induction on their size, those are a tree."""
    m = hit.shape[0]
    i = np.arange(m)
    if miss[0] != m:
        raise WideTreeError(f"node 0: miss link {miss[0]}, its escape is {m}")
    if (k := _first_bad((miss <= i) | (miss > m))) is not None:
        raise WideTreeError(f"node {k}: miss link {miss[k]} outside ({k}, {m}]")
    if (k := _first_bad(leaf & (miss != i + 1))) is not None:
        raise WideTreeError(f"leaf {k}: miss link {miss[k]}, its escape is {k + 1}")
    if (k := _first_bad(leaf & (hit != miss))) is not None:
        raise WideTreeError(f"leaf {k}: hit link {hit[k]} is not its escape {miss[k]}")
    inner = np.nonzero(~leaf)[0]
    if (k := _first_bad(hit[inner] != inner + 1, inner)) is not None:
        raise WideTreeError(f"interior node {k}: hit link {hit[k]}, not its first child {k + 1}")
    if (k := _first_bad(miss[inner] <= inner + 1, inner)) is not None:
        raise WideTreeError(f"interior node {k}: its escape {miss[k]} leaves no room for its children")
    snd = miss[inner + 1]  # inner + 1 < miss[inner] <= m: a node
    if (k := _first_bad(snd >= miss[inner], inner)) is not None:
        raise WideTreeError(f"interior node {k}: second child {miss[k + 1]} is not before its escape {miss[k]}")
    if (k := _first_bad(miss[snd] != miss[inner], inner)) is not None:
        raise WideTreeError(f"node {miss[k + 1]}: miss link {miss[miss[k + 1]]}, its escape is {miss[k]}")
    fst_all = np.full(m, -1, dtype=np.int64)
    snd_all = np.full(m, -1, dtype=np.int64)
    fst_all[inner], snd_all[inner] = inner + 1, snd
    return fst_all, snd_all


def _leaf_prims(count: np.ndarray, leaves: np.ndarray, leaf: np.ndarray, p: int, payload: bool):
    """The prims each node's leaf tests, in the twin's order -> (ids
    [Q], the node of each, in node order): contiguous rows, or payload
    slots with the empty ones dropped."""
    m = count.shape[0]
    if payload:
        if (k := _first_bad(count > SLOTS)) is not None:
            raise WideTreeError(f"leaf {k}: {count[k]} prims in an {SLOTS}-slot payload")
        slots = leaves.reshape(m, SLOTS)
        take = leaf[:, None] & (np.arange(SLOTS)[None] < count[:, None]) & (slots != 0)
        ids, owner = slots[take], np.nonzero(take)[0]
    else:
        c = np.where(leaf, count, 0)
        owner = np.repeat(np.arange(m), c)
        first = np.cumsum(c) - c
        ids = leaves[owner] + np.arange(owner.size) - first[owner]
    if (k := _first_bad((ids < 1) | (ids >= p), owner)) is not None:
        raise WideTreeError(f"leaf {k}: prim ids outside [1, {p})")
    return ids, owner


def _collapse(fst, snd, leaf, has, area):
    """Wide nodes in preorder -> (each one's children as binary nodes,
    each one's (wide parent, slot), the most stack entries a walk
    needs: a node pushes all but the first of its children)."""
    fst, snd, leaf, has, area = (x.tolist() for x in (fst, snd, leaf, has, area))  # Python scalars: faster here
    frontiers: list[list[int]] = []
    parents: list[tuple[int, int]] = []  # (wide parent, slot); (-1, -1) for the root
    need = 0
    todo = [(-1, -1, 0, None)]  # (wide parent, slot, stack entries, binary node; None = root)
    while todo:
        parent, slot, held, b = todo.pop()
        k = len(frontiers)
        front = ([0] if has[0] else []) if b is None else [c for c in (fst[b], snd[b]) if has[c]]
        while len(front) < WIDTH:
            inner = [j for j, c in enumerate(front) if not leaf[c]]
            if not inner:
                break
            j = max(inner, key=lambda j: area[front[j]])  # first of the largest
            c = front[j]
            front[j : j + 1] = [x for x in (fst[c], snd[c]) if has[x]]
        frontiers.append(front)
        parents.append((parent, slot))
        pushed = max(len(front) - 1, 0)
        need = max(need, held + pushed)
        for s in range(len(front) - 1, -1, -1):
            if not leaf[front[s]]:
                todo.append((k, s, held + pushed - s, front[s]))
    return frontiers, np.array(parents, dtype=np.int64), need


def pack_walk(
    node_min: torch.Tensor,
    node_max: torch.Tensor,
    hit_link: torch.Tensor,
    miss_link: torch.Tensor,
    leaf_count: torch.Tensor,
    leaves: torch.Tensor,
    pa: torch.Tensor,
    pb: torch.Tensor,
    pc: torch.Tensor,
    *,
    payload: bool,
) -> WalkTree:
    """The binary tree the twin walks -> its :class:`WalkTree`, the
    packed records on the tree's device.  Raises :class:`WideTreeError`
    where an invariant fails (see the module's docstring)."""
    binary = (node_min, node_max, hit_link, miss_link, leaf_count, leaves, pa, pb, pc)
    bmin, bmax = node_min.cpu(), node_max.cpu()
    hit, miss, count, slots = (x.cpu().numpy().astype(np.int64) for x in (hit_link, miss_link, leaf_count, leaves))
    leaf = count > 0
    fst, snd = _children(hit, miss, leaf)

    lo, hi = bmin.numpy(), bmax.numpy()
    inner = np.nonzero(~leaf)[0]
    for child in (fst[inner], snd[inner]):
        inside = (lo[inner] <= lo[child]).all(axis=1) & (hi[inner] >= hi[child]).all(axis=1)
        if (k := _first_bad(~inside, inner)) is not None:
            raise WideTreeError(f"node {k}: a child's box is not inside its box")

    ids, owner = _leaf_prims(count, slots, leaf, pa.shape[0], payload)
    has = np.zeros(leaf.shape[0], dtype=bool)
    has[owner] = True
    bad = has & (lo > hi).any(axis=1)
    bad[0] = False  # the root's own box is tested as the binary walk tests it
    if (k := _first_bad(bad)) is not None:
        raise WideTreeError(f"leaf {k}: prims to test in an inverted box")
    for i in inner[::-1]:  # children follow their parent
        has[i] = has[fst[i]] | has[snd[i]]

    ext = hi.astype(np.float64) - lo.astype(np.float64)
    area = ext[:, 0] * ext[:, 1] + ext[:, 1] * ext[:, 2] + ext[:, 2] * ext[:, 0]
    frontiers, parents, need = _collapse(fst, snd, leaf, has, area)

    # Packed prims in leaf preorder (node order): where each leaf starts.
    sizes = np.bincount(owner, minlength=leaf.shape[0])
    start = np.cumsum(sizes) - sizes
    last = np.zeros(ids.size, dtype=np.int32)
    last[(start + sizes - 1)[sizes > 0]] = 1
    g = torch.from_numpy(ids)
    a, b, c = (x.cpu()[g] for x in (pa, pb, pc))
    prim_rec = torch.zeros((ids.size, PRIM_WORDS), dtype=torch.int32)
    prim_rec[:, 0:3] = a.view(torch.int32)
    prim_rec[:, 3] = g.to(torch.int32)
    prim_rec[:, 4:7] = (b - a).view(torch.int32)
    prim_rec[:, 7] = torch.from_numpy(last)
    prim_rec[:, 8:11] = (c - a).view(torch.int32)

    # Slab bounds with the wobble, as node_slab rounds them.
    wob = 2e-6 + 1e-5 * torch.maximum(bmin.abs(), bmax.abs())
    lo_w, hi_w = (x.view(torch.int32).numpy() for x in (bmin - wob, bmax + wob))
    kids = np.full((len(frontiers), WIDTH), -1, dtype=np.int64)
    for k, front in enumerate(frontiers):
        kids[k, : len(front)] = front
    used = kids >= 0
    safe = np.where(used, kids, 0)
    words = np.where(used & leaf[safe], ~start[safe], 0)
    words[parents[1:, 0], parents[1:, 1]] = np.arange(1, len(frontiers))
    node_rec = np.zeros((len(frontiers), NODE_WORDS), dtype=np.int32)
    for axis in range(3):
        node_rec[:, 2 * axis * WIDTH : (2 * axis + 1) * WIDTH] = np.where(used, lo_w[safe, axis], 0)
        node_rec[:, (2 * axis + 1) * WIDTH : (2 * axis + 2) * WIDTH] = np.where(used, hi_w[safe, axis], 0)
    node_rec[:, 6 * WIDTH : 7 * WIDTH] = words
    dev = node_min.device
    return WalkTree(
        binary=binary, payload=payload, nodes=torch.from_numpy(node_rec).to(dev), prims=prim_rec.to(dev),
        stack=need,
    )


def walk_tree(binary: tuple[torch.Tensor, ...], *, payload: bool) -> WalkTree:
    """The threaded walk's tree over ``binary`` (node_min, node_max,
    hit_link, miss_link, leaf_count, leaves, pa, pb, pc): packed
    (:func:`pack_walk`) on a CUDA device, where kernel G reads the
    records; on the CPU the wrapper runs the twin on ``binary`` and
    nothing is packed."""
    if binary[0].is_cuda:
        return pack_walk(*binary, payload=payload)
    return WalkTree(binary=binary, payload=payload)


__all__ = ["WalkTree", "WideTreeError", "pack_walk", "walk_tree", "WIDTH", "LOCAL_STACK"]

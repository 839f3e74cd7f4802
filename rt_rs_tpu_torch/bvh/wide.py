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
stack in a scratch buffer the wrapper allocates.  A tree built on the
device every frame (``ops/wide_build.py``) records the bound its
collapse keeps, ``LOCAL_STACK``, known before the tree is built.
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
# Child slots over more packed prims than this are refit by a whole
# block of csrc/wide_refit.cu, the others by one warp.
REFIT_BLOCK_RANGE = 256


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


def wobbled(lo: torch.Tensor, hi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Boxes [N, 3] with the walk's wobble applied, as
    ``bvh_walk.node_slab`` rounds it: ``lo - wob``, ``hi + wob``."""
    wob = 2e-6 + 1e-5 * torch.maximum(lo.abs(), hi.abs())
    return lo - wob, hi + wob


def surface_areas(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """Half the surface area of each box [M, 3] in f64: what a collapse
    ranks interior children by."""
    ext = hi.astype(np.float64) - lo.astype(np.float64)
    return ext[:, 0] * ext[:, 1] + ext[:, 1] * ext[:, 2] + ext[:, 2] * ext[:, 0]


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
    area: np.ndarray | None = None,
) -> WalkTree:
    """The binary tree the twin walks -> its :class:`WalkTree`, the
    packed records on the tree's device.  ``area`` [M] ranks the
    interior children a collapse expands (default: the surface areas of
    the given boxes); the boxes of a moved pose packed with the rest
    pose's areas keep the rest pose's wide topology.  Raises
    :class:`WideTreeError` where an invariant fails (see the module's
    docstring)."""
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

    if area is None:
        area = surface_areas(lo, hi)
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
    lo_w, hi_w = (x.view(torch.int32).numpy() for x in wobbled(bmin, bmax))
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


@dataclasses.dataclass(frozen=True)
class RefitMap:
    """What ``ops/wide_refit.py`` reads to rewrite a packed tree's boxes
    and prims from new corners, fixed at the pack (:func:`refit_map`):

    * ``prim_meta`` [Q, 2] int32: each packed prim's row of the corner
      arrays (its pid, word 3 of its record) and its ``last`` flag (word
      7);
    * ``slot_word`` [U] int32: each used child slot's word in the node
      records, ``node * NODE_WORDS + slot`` (the slot's ``lo.x``);
    * ``slot_range`` [U, 2] int32: the packed prims under that slot,
      ``[first, end)``; the slots longest range first, so that a kernel
      starts its longest reductions first.

    ``rows`` is the row count the corner arrays must have, and
    ``block_slots`` the leading slots of more than
    :data:`REFIT_BLOCK_RANGE` prims."""

    prim_meta: torch.Tensor
    slot_word: torch.Tensor
    slot_range: torch.Tensor
    rows: int
    block_slots: int


def refit_map(tree: WalkTree, rows: int) -> RefitMap:
    """The fixed map a per-frame refit of ``tree``'s packed records
    reads, on the records' device, for corner arrays of ``rows`` rows.

    A child slot's box is the union of the prims under it.  The prims
    are packed in leaf preorder, so each slot's prims should be one
    contiguous range of packed prims; this reads the ranges off the
    records and checks it, raising :class:`WideTreeError` where it
    fails: each leaf word ``~q`` owns the prims from ``q`` to the next
    one marked last, every packed prim lies in exactly one leaf, an
    interior child's prims are its node's slots' ranges, which must abut,
    and the root's are all of them."""
    if tree.nodes is None or tree.prims is None:
        raise ValueError("tree: no packed records (wide.pack_walk packs them)")
    nodes, prims = tree.nodes.cpu().numpy(), tree.prims.cpu().numpy()
    k_n, q = nodes.shape[0], prims.shape[0]
    words = nodes[:, 6 * WIDTH : 7 * WIDTH].astype(np.int64)
    if (k := _first_bad(((prims[:, 3] < 1) | (prims[:, 3] >= rows)))) is not None:
        raise WideTreeError(f"packed prim {k}: pid {prims[k, 3]} outside [1, {rows})")
    ends = np.flatnonzero(prims[:, 7] != 0) + 1
    if q == 0 or ends.size == 0 or ends[-1] != q:
        raise WideTreeError("packed prims: the last one is not marked last")
    first = np.concatenate([[0], ends[:-1]])
    leaf_first = ~words[words < 0]
    if leaf_first.size != first.size or not np.array_equal(np.sort(leaf_first), first):
        raise WideTreeError("leaf words do not own every packed prim exactly once")
    leaf_end = dict(zip(first.tolist(), ends.tolist()))
    span = np.zeros((k_n, 2), dtype=np.int64)
    rng = np.zeros((k_n, WIDTH, 2), dtype=np.int64)
    for k in range(k_n - 1, -1, -1):  # children follow their parent
        used = []
        for s in range(WIDTH):
            w = int(words[k, s])
            if w < 0:
                rng[k, s] = (~w, leaf_end[~w])
            elif w > 0:
                if w <= k:
                    raise WideTreeError(f"node {k}: child {w} does not follow it")
                rng[k, s] = span[w]
            else:
                continue
            used.append(rng[k, s])
        if not used:
            raise WideTreeError(f"node {k}: no child")
        part = sorted(tuple(r) for r in used)
        if any(a[1] != b[0] for a, b in zip(part, part[1:])):
            raise WideTreeError(f"node {k}: its children's prims are not one contiguous range")
        span[k] = (part[0][0], part[-1][1])
    if tuple(span[0]) != (0, q):
        raise WideTreeError(f"the root's prims are {tuple(span[0])}, not all {q}")
    k_idx, s_idx = np.nonzero(words != 0)
    ranges = rng[k_idx, s_idx]
    lengths = ranges[:, 1] - ranges[:, 0]
    order = np.argsort(-lengths, kind="stable")
    dev = tree.nodes.device

    def i32(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(dev)

    return RefitMap(
        prim_meta=i32(prims[:, [3, 7]]),
        slot_word=i32((k_idx * NODE_WORDS + s_idx)[order]),
        slot_range=i32(ranges[order]),
        rows=rows,
        block_slots=int((lengths > REFIT_BLOCK_RANGE).sum()),
    )


@dataclasses.dataclass(frozen=True)
class RefitWalk:
    """One frame's walked structure of ``DynamicRenderer``: the tree
    kernel G (or, on the CPU, the twin) walks, and the fixed map its
    refit read (None on the CPU, where the binary tree is refit)."""

    tree: WalkTree
    refit: RefitMap | None


@dataclasses.dataclass(frozen=True)
class BinaryRefit:
    """The binary tree's topology for refitting its covering bounds in
    torch ops (``ops/wide_refit.py::binary_refit``), fixed at the build:
    each bounded corner row and its leaf (``rows``, ``leaf`` [R] int64),
    and the interior nodes by depth, deepest first (``levels``: (node,
    first child, second child) int64 tensors per depth)."""

    rows: torch.Tensor
    leaf: torch.Tensor
    levels: tuple[tuple[torch.Tensor, torch.Tensor, torch.Tensor], ...]
    num_nodes: int


def binary_refit_topology(
    hit_link: torch.Tensor, miss_link: torch.Tensor, leaf_count: torch.Tensor, leaves: torch.Tensor,
    num_prims: int,
) -> BinaryRefit:
    """:class:`BinaryRefit` of the contiguous-leaf tree the links
    describe (:func:`_children` checks them), on ``leaves``' device.  A
    leaf bounds its rows ``leaves[i] ..`` that hold one of the scene's
    ``num_prims`` prims (1-based rows), as ``BvhData.cover_bounds``
    bounds the prims it holds."""
    hit, miss, count, start = (x.cpu().numpy().astype(np.int64) for x in (hit_link, miss_link, leaf_count, leaves))
    leaf = count > 0
    fst, snd = _children(hit, miss, leaf)
    c = np.where(leaf, count, 0)
    owner = np.repeat(np.arange(c.size), c)
    rows = start[owner] + np.arange(owner.size) - (np.cumsum(c) - c)[owner]
    keep = (rows >= 1) & (rows <= num_prims)
    depth = np.zeros(c.size, dtype=np.int64)
    for i in np.nonzero(~leaf)[0].tolist():  # parents before children
        depth[fst[i]] = depth[snd[i]] = depth[i] + 1
    inner = np.nonzero(~leaf)[0]
    dev = leaves.device

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int64)).to(dev)

    levels = tuple(
        (t(inner[sel]), t(fst[inner[sel]]), t(snd[inner[sel]]))
        for d in sorted(set(depth[inner].tolist()), reverse=True)
        if (sel := depth[inner] == d).any()
    )
    return BinaryRefit(rows=t(rows[keep]), leaf=t(owner[keep]), levels=levels, num_nodes=int(c.size))


__all__ = [
    "BinaryRefit", "RefitMap", "RefitWalk", "WalkTree", "WideTreeError", "binary_refit_topology", "pack_walk",
    "refit_map", "walk_tree", "WIDTH", "LOCAL_STACK",
]

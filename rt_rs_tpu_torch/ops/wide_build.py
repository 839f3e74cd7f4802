"""Kernel G's packed wide tree, built anew from each frame's corners.

``DynamicRenderer``'s walked rebuild (``refit=False`` under
``"threaded"``, and under ``"auto"`` past the chunk table's 12,288
triangles) builds the tree the walk reads every frame, reading nothing
back, so that a chained dispatch's CUDA graph captures the build with
the frame.  The phases:

1. Morton codes of the prims' centroids over the frame's box
   (:func:`~rt_rs_tpu_torch.ops.lbvh.centroid_codes`: 30 bits, x major);
2. a stable sort of the codes: equal codes keep their index order;
3. Karras' radix-tree emit over the sorted keys
   (:func:`~rt_rs_tpu_torch.ops.lbvh.karras_splits`): internal node
   ``i`` covers the sorted positions ``[first, last]``;
4. bottom-up bounds: each sorted prim's box (the corners' min and max),
   each internal node's the union of its children's, left then right;
5. the collapse into ``WIDTH``-wide nodes and the packing, in
   :mod:`rt_rs_tpu_torch.bvh.wide`'s layout.

**Leaves.**  A subtree of at most :data:`LEAF_PRIMS` prims is one leaf,
its prims tested one after another.  One prim a leaf walks fastest: on
an H100 a 1080p frame of the breathing ``torus_row(3)`` took 4.13,
4.18, 4.40 and 5.15 ms with leaves of at most 1, 2, 4 and 8 prims
(kernel G 2.42, 2.55, 2.86 and 3.59 ms of it; the build 0.28, 0.24,
0.21 and 0.18 ms), since a Morton-ordered run of prims is looser than a
wide node's four boxes.  An LBVH subtree's prims are contiguous in
Morton order, so packed prim ``q`` is sorted position ``q``, each leaf
is a range of packed prims, and prim ``q``'s record carries its scene
row ``order[q] + 1`` as ``pid``: the scene tensors stay in scene order.

**The collapse.**  A wide node's children start as its binary node's
two children; while it has fewer than ``WIDTH``, the interior child of
the largest surface area (the first of equals) is replaced in place by
its two, as ``wide.pack_walk`` does, so the children stay in preorder.
An expansion is taken only where every interior child keeps the stack
bound below; where the largest may not be expanded, the next largest
is tried.

**The stack bound.**  Kernel G keeps ``wide.LOCAL_STACK`` (64) entries
a thread in local memory, and the bound must be known before the tree
is: a tree built every frame on the device cannot report its own.  A
radix tree over distinct keys of ``L`` bits is at most ``L`` levels
deep, each internal node's split bit lying below its parent's; here
the key is the 30-bit code and, for equal codes, the sorted position's
``ceil(log2 P)`` bits (:func:`key_bits`: 45 at 18,962 prims), so an
internal node lies at most ``L - 1`` levels down.  A walk that enters
interior child ``s`` of ``n`` holds what it held at the parent plus
``n - 1 - s``.  The collapse keeps every interior node's held entries
within :func:`slack` of its binary depth, so the most a walk pushes,
at a node ``L - 1`` deep with ``WIDTH - 1`` children pushed, is
``(L - 1) + slack + (WIDTH - 1)`` = ``LOCAL_STACK`` at every size up
to 2^32 prims: kernel G always takes its local-memory stack.

**Numbering.**  Wide nodes are numbered in preorder, as ``pack_walk``
numbers them: by the first sorted position under them, an ancestor
before its descendants.  Node 0 is the root.  The node buffer has room
for ``max(P - 1, 1)`` nodes; rows past the wide node count are zero.
A tree of at most ``LEAF_PRIMS`` prims is one wide node whose one
child is the leaf of every prim.

:func:`wide_build` runs the kernels of ``csrc/wide_build.cu`` on CUDA
tensors into a :class:`WideBuild`'s buffers, which are fixed at
construction; on CPU tensors the twin :func:`wide_build_reference`
computes the same records, and the binary tree the CPU's twin walk
steps through.  While tracing is on, the build counts the prim records
and the wide nodes it writes (``tracing.py``: ``rebuild_prims``,
``rebuild_nodes``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from rt_rs_tpu_torch import tracing
from rt_rs_tpu_torch.bvh import wide
from rt_rs_tpu_torch.bvh.wide import LOCAL_STACK, NODE_WORDS, PRIM_WORDS, SLOTS, WIDTH, WalkTree
from rt_rs_tpu_torch.ops import cuda
from rt_rs_tpu_torch.ops.lbvh import centroid_codes, karras_splits, morton_order
from rt_rs_tpu_torch.ops.wide_refit import corner_bounds

LEAF_PRIMS = 1  # the most prims a leaf holds (the kernels take it as leaf_prims)
BUCKET_BITS = 14  # the sort's buckets: the codes' top bits (kBucketBits)


def key_bits(p: int) -> int:
    """Bits of the radix tree's keys over ``p`` prims: the 30-bit code
    and the sorted position's ``ceil(log2 p)``."""
    return 30 + max(p - 1, 0).bit_length()


def slack(p: int) -> int:
    """Entries an interior node's walk may hold beyond its binary depth
    (see the module's docstring)."""
    return LOCAL_STACK - (WIDTH - 1) - (key_bits(p) - 1)


@dataclasses.dataclass(frozen=True)
class Hierarchy:
    """The radix tree over ``p`` sorted prims, as numpy int64 arrays:
    internal node ``i`` covers ``[first[i], last[i]]``; its children
    ``left[i]`` / ``right[i]`` are internal nodes (``>= 0``) or sorted
    positions ``q`` as ``~q``; ``parent[i]`` is -1 at the root."""

    p: int
    first: np.ndarray
    last: np.ndarray
    left: np.ndarray
    right: np.ndarray
    parent: np.ndarray

    def interior(self, x: int) -> bool:
        """Whether element ``x`` (internal node, or ``~q``) is not a leaf."""
        return x >= 0 and self.last[x] - self.first[x] + 1 > LEAF_PRIMS

    @property
    def root(self) -> int:
        return 0 if self.p >= 2 else ~0


def hierarchy(codes_sorted: torch.Tensor) -> Hierarchy:
    """The :class:`Hierarchy` of sorted codes [P] (P >= 1)."""
    p = codes_sorted.shape[0]
    if p < 2:
        e = np.zeros(0, dtype=np.int64)
        return Hierarchy(p, e, e, e, e, e)
    i, j, gamma = (x.cpu().numpy() for x in karras_splits(codes_sorted))
    first, last = np.minimum(i, j), np.maximum(i, j)
    left = np.where(first == gamma, ~gamma, gamma)
    right = np.where(last == gamma + 1, ~(gamma + 1), gamma + 1)
    parent = np.full(p - 1, -1, dtype=np.int64)
    for child in (left, right):
        inner = child >= 0
        parent[child[inner]] = i[inner]
    return Hierarchy(p, first, last, left, right, parent)


@dataclasses.dataclass(frozen=True)
class Collapse:
    """The wide nodes of a :class:`Hierarchy`: ``fronts[k]`` the children
    of wide node ``k`` (elements as :class:`Hierarchy` gives them), in
    preorder; ``roots[k]`` its binary node (-1 for a one-leaf tree);
    ``held`` / ``depth`` each wide node's stack entries on entry and
    binary depth; ``need`` the most entries a walk holds."""

    fronts: list[list[int]]
    roots: list[int]
    held: list[int]
    depth: list[int]
    need: int


def collapse(h: Hierarchy, area: np.ndarray) -> Collapse:
    """The collapse of the module's docstring, wide nodes in preorder;
    ``area`` [P-1] ranks the interior nodes (f64 half surface areas)."""
    if not h.interior(h.root):
        return Collapse([[h.root]], [-1], [0], [0], 0)
    e = slack(h.p)
    out: dict[int, tuple[list[int], int, int]] = {}
    todo = [(0, 0, 0)]  # (binary node, held, depth)
    while todo:
        v, held, depth = todo.pop()
        front = [(int(h.left[v]), 1), (int(h.right[v]), 1)]
        while len(front) < WIDTH:
            tried: set[int] = set()
            while True:
                best = -1
                for s, (x, _) in enumerate(front):
                    if h.interior(x) and s not in tried and (best < 0 or area[x] > area[front[best][0]]):
                        best = s
                if best < 0:
                    break
                x, dx = front[best]
                grown = front[:best] + [(int(h.left[x]), dx + 1), (int(h.right[x]), dx + 1)] + front[best + 1 :]
                n = len(grown)
                if all(held + n - 1 - s - (depth + d) <= e for s, (y, d) in enumerate(grown) if h.interior(y)):
                    front = grown
                    break
                tried.add(best)
            if best < 0:
                break
        out[v] = ([x for x, _ in front], held, depth)
        n = len(front)
        todo.extend((x, held + n - 1 - s, depth + d) for s, (x, d) in enumerate(front) if h.interior(x))
    roots = sorted(out, key=lambda v: (h.first[v], -h.last[v]))  # preorder
    return Collapse(
        fronts=[out[v][0] for v in roots], roots=roots, held=[out[v][1] for v in roots],
        depth=[out[v][2] for v in roots], need=max(out[v][1] + len(out[v][0]) - 1 for v in roots),
    )


def _areas(lo: torch.Tensor, hi: torch.Tensor) -> np.ndarray:
    """Half the surface area of each box [N, 3], in f64 (the kernel's
    operation order)."""
    ext = hi.double() - lo.double()
    return (ext[:, 0] * ext[:, 1] + ext[:, 1] * ext[:, 2] + ext[:, 2] * ext[:, 0]).numpy()


@dataclasses.dataclass(frozen=True)
class TwinBuild:
    """What :func:`wide_build_reference` computes: the packed records
    (``nodes`` [max(P-1, 1), NODE_WORDS], ``prims`` [P, PRIM_WORDS],
    int32), the wide nodes written (``count``), the binary tree the
    twin walk steps through (``binary``, payload leaves: node_min,
    node_max, hit_link, miss_link, leaf_count, leaves, pa, pb, pc), and
    the sort, tree and collapse it came from."""

    nodes: torch.Tensor
    prims: torch.Tensor
    count: int
    binary: tuple[torch.Tensor, ...]
    order: torch.Tensor
    tree: Hierarchy
    collapsed: Collapse

    def walk_tree(self) -> WalkTree:
        """The :class:`WalkTree` of the CPU's frames: the twin walk steps
        through ``binary``; the mirror and the counters read the
        records."""
        return WalkTree(binary=self.binary, payload=True, nodes=self.nodes, prims=self.prims, stack=LOCAL_STACK)


def wide_build_reference(pa: torch.Tensor, pb: torch.Tensor, pc: torch.Tensor) -> TwinBuild:
    """Plain-PyTorch twin of :func:`wide_build` on the corners [P + 1, 3]
    f32 (row 0 the null sentinel), P >= 1."""
    p = pa.shape[0] - 1
    if p < 1:
        raise ValueError("a walked rebuild needs at least one prim")
    a, b, c = pa[1:], pb[1:], pc[1:]
    codes = centroid_codes(a, b, c)
    order = morton_order(codes).long()
    h = hierarchy(codes[order])
    row = order + 1
    leaf_lo, leaf_hi = corner_bounds(pa[row], pb[row], pc[row])

    # Bottom-up bounds, the deepest internal nodes first.
    n_int = p - 1
    levels = []
    if n_int:
        frontier = np.array([0])
        while frontier.size:
            levels.append(frontier)
            kids = np.concatenate([h.left[frontier], h.right[frontier]])
            frontier = kids[kids >= 0]
    lo = torch.zeros((n_int, 3), dtype=torch.float32)
    hi = torch.zeros((n_int, 3), dtype=torch.float32)
    for nodes in reversed(levels):
        (llo, lhi), (rlo, rhi) = (_boxes(x, lo, hi, leaf_lo, leaf_hi) for x in (h.left[nodes], h.right[nodes]))
        t = torch.from_numpy(nodes)
        lo[t] = torch.minimum(llo, rlo)
        hi[t] = torch.maximum(lhi, rhi)
    area = _areas(lo, hi) if n_int else np.zeros(0)
    col = collapse(h, area)

    # The records: each wide node's children, flattened.
    kids = [(k, s, x) for k, front in enumerate(col.fronts) for s, x in enumerate(front)]
    k_of, s_of, x = (np.array(c, dtype=np.int64) for c in zip(*kids))
    inner = _interior(h, x)
    first, last = _span(h, x)
    index = np.zeros(max(n_int, 1), dtype=np.int64)
    if n_int and col.roots[0] >= 0:
        index[col.roots] = np.arange(len(col.roots))
    lo_b, hi_b = _boxes(x, lo, hi, leaf_lo, leaf_hi)
    lo_w, hi_w = (t.view(torch.int32) for t in wide.wobbled(lo_b, hi_b))
    node_rec = torch.zeros((max(n_int, 1), NODE_WORDS), dtype=torch.int32)
    kt, st = torch.from_numpy(k_of), torch.from_numpy(s_of)
    for axis in range(3):
        node_rec[kt, 2 * axis * WIDTH + st] = lo_w[:, axis].contiguous()
        node_rec[kt, (2 * axis + 1) * WIDTH + st] = hi_w[:, axis].contiguous()
    words = np.where(inner, index[np.where(inner, x, 0)], ~first)
    node_rec[kt, 6 * WIDTH + st] = torch.from_numpy(words.astype(np.int32))
    is_last = np.zeros(p, dtype=np.int32)
    is_last[last[~inner]] = 1
    ra, rb, rc = pa[row], pb[row], pc[row]
    prim_rec = torch.zeros((p, PRIM_WORDS), dtype=torch.int32)
    prim_rec[:, 0:3] = ra.view(torch.int32)
    prim_rec[:, 3] = row.to(torch.int32)
    prim_rec[:, 4:7] = (rb - ra).view(torch.int32)
    prim_rec[:, 7] = torch.from_numpy(is_last)
    prim_rec[:, 8:11] = (rc - ra).view(torch.int32)

    binary = _binary(h, lo, hi, leaf_lo, leaf_hi, row, pa, pb, pc)
    return TwinBuild(
        nodes=node_rec, prims=prim_rec, count=len(col.fronts), binary=binary, order=order, tree=h, collapsed=col,
    )


def _interior(h: Hierarchy, x: np.ndarray) -> np.ndarray:
    """:meth:`Hierarchy.interior` of each element of ``x``."""
    safe = np.where(x >= 0, x, 0)
    return (x >= 0) & (h.last[safe] - h.first[safe] + 1 > LEAF_PRIMS) if h.p >= 2 else np.zeros(x.shape, bool)


def _span(h: Hierarchy, x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The sorted positions ``[first, last]`` under each element of ``x``."""
    if h.p < 2:
        return ~x, ~x
    safe = np.where(x >= 0, x, 0)
    return np.where(x >= 0, h.first[safe], ~x), np.where(x >= 0, h.last[safe], ~x)


def _boxes(x: np.ndarray, lo, hi, leaf_lo, leaf_hi) -> tuple[torch.Tensor, torch.Tensor]:
    """The boxes [N, 3] of elements ``x``: internal nodes' or prims'."""
    xt = torch.from_numpy(x)
    inner = (xt >= 0)[:, None]
    xi, q = torch.where(xt >= 0, xt, 0), torch.where(xt >= 0, 0, ~xt)
    if lo.shape[0] == 0:
        return leaf_lo[q], leaf_hi[q]
    return torch.where(inner, lo[xi], leaf_lo[q]), torch.where(inner, hi[xi], leaf_hi[q])


def _binary(h: Hierarchy, lo, hi, leaf_lo, leaf_hi, row, pa, pb, pc) -> tuple[torch.Tensor, ...]:
    """The collapsed binary tree in preorder with escape links and
    payload leaves (each leaf's prims' scene rows in sorted order), as
    the twin walk takes it (``ops/bvh_walk.py::bvh_walk_reference``).
    Preorder is the order of (first, -last): a node's subtree is the
    nodes after it up to the first whose range starts past its own."""
    if h.interior(h.root):
        inner = np.nonzero(_interior(h, np.arange(h.p - 1)))[0]
        kids = np.concatenate([h.left[inner], h.right[inner]])
        nodes = np.concatenate([inner, kids[~_interior(h, kids)]])
    else:
        nodes = np.array([h.root], dtype=np.int64)
    first, last = _span(h, nodes)
    pre = np.lexsort((-last, first))
    nodes, first, last = nodes[pre], first[pre], last[pre]
    m = nodes.shape[0]
    leaf = ~_interior(h, nodes)
    miss = np.searchsorted(first, last, side="right").astype(np.int32)
    hit = np.where(leaf, miss, np.arange(1, m + 1)).astype(np.int32)
    count = np.where(leaf, last - first + 1, 0).astype(np.int32)
    rows = row.numpy()
    slot = first[:, None] + np.arange(SLOTS)[None]
    used = leaf[:, None] & (slot <= last[:, None])
    slots = np.where(used, rows[np.minimum(slot, h.p - 1)], 0).astype(np.int32)
    node_min, node_max = _boxes(nodes, lo, hi, leaf_lo, leaf_hi)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a))

    return (node_min, node_max, t(hit), t(miss), t(count), t(slots.reshape(-1)), pa, pb, pc)


@dataclasses.dataclass(frozen=True)
class WideBuild:
    """The device buffers of one scene's per-frame build, sized from its
    prim count at construction (:func:`workspace`): ``tree`` the packed
    records kernel G walks (rewritten in place every frame), ``work`` the
    build's own buffers by name."""

    p: int
    tree: WalkTree
    work: dict[str, torch.Tensor]


def workspace(p: int, device) -> WideBuild:
    """The buffers of a build over ``p`` prims (P >= 1) on ``device``."""
    if p < 1:
        raise ValueError("a walked rebuild needs at least one prim")
    dev = torch.device(device)
    n_int, rows = max(p - 1, 1), max(p - 1, 1)

    def i32(*shape):
        return torch.zeros(shape, dtype=torch.int32, device=dev)

    def f32(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    work = {
        "box": f32(8),
        "codes": i32(p),
        "bucket": i32((1 << BUCKET_BITS) + 1),  # counts, then each bucket's start
        "cursor": i32(1 << BUCKET_BITS),
        "slot": i32(p),  # prims by bucket, unordered within one
        "order": i32(p),  # sorted position -> prim
        "sorted": i32(p),  # the sorted codes
        "inner": i32(n_int, 4),  # first, last, left, right
        "parent": i32(n_int),
        "leaf_parent": torch.full((p,), -1, dtype=torch.int32, device=dev),
        "flag": i32(n_int),
        "inner_box": f32(n_int, 8),  # lo xyz, pad, hi xyz, pad
        "leaf_box": f32(p, 8),
        "area": torch.zeros((n_int,), dtype=torch.float64, device=dev),
        "front": i32(n_int, WIDTH),
        "wide": i32(n_int, 4),  # count of children, held, depth, preorder index
        "queue": i32(n_int),
        "first_count": i32(p),
        "count": i32(4),
    }
    tree = WalkTree(
        binary=(), payload=False, nodes=i32(rows, NODE_WORDS), prims=i32(p, PRIM_WORDS), stack=LOCAL_STACK,
    )
    return WideBuild(p=p, tree=tree, work=work)


def wide_build(pa: torch.Tensor, pb: torch.Tensor, pc: torch.Tensor, build: WideBuild | None = None) -> WalkTree:
    """The walk's tree of the frame's corners ``pa``, ``pb``, ``pc`` [P +
    1, 3] f32 (row 0 the null sentinel): on CUDA tensors the kernels,
    into ``build``'s buffers (its ``tree``, rewritten in place); on CPU
    tensors the twin's tree (``build`` unused)."""
    p = pa.shape[0] - 1
    dev = pa.device
    if not pa.is_cuda:
        twin = wide_build_reference(pa, pb, pc)
        if tracing.counting(dev):
            tracing.add(dev, "rebuild_prims", p)
            tracing.add(dev, "rebuild_nodes", twin.count)
        return twin.walk_tree()
    if build is None or build.p != p:
        raise ValueError(f"build: a workspace for {p} prims is required on a CUDA device")
    for name, x in (("pa", pa), ("pb", pb), ("pc", pc)):
        cuda.check(name, x, torch.float32, (p + 1, 3), dev)
    w, tree = build.work, build.tree
    cuda.check("nodes", tree.nodes, torch.int32, (max(p - 1, 1), NODE_WORDS), dev)
    cuda.check("prims", tree.prims, torch.int32, (p, PRIM_WORDS), dev)
    cuda.call(
        "wide_build", "rt_wide_build",
        pa.data_ptr(), pb.data_ptr(), pc.data_ptr(), p,
        *(w[k].data_ptr() for k in WORK_ORDER),
        tree.nodes.data_ptr(), tree.prims.data_ptr(), LEAF_PRIMS,
        *tracing.kernel_args(dev, "rebuild_prims"),
    )
    return tree


# The workspace's buffers in the order rt_wide_build takes them.
WORK_ORDER = (
    "box", "codes", "bucket", "cursor", "slot", "order", "sorted", "inner", "parent", "leaf_parent", "flag",
    "inner_box", "leaf_box", "area", "front", "wide", "queue", "first_count", "count",
)


def check_tree(nodes: torch.Tensor, prims: torch.Tensor, count: int) -> None:
    """Raise :class:`~rt_rs_tpu_torch.bvh.wide.WideTreeError` where the
    records break what kernel G's walk rests on (``wide.refit_map``'s
    checks: leaves own every packed prim once, children follow their
    parent, each node's prims one contiguous range, the root's all of
    them), or where rows past ``count`` are not zero."""
    if bool(nodes[count:].ne(0).any()):
        raise wide.WideTreeError(f"rows past the {count} wide nodes are not zero")
    wide.refit_map(WalkTree(binary=(), payload=False, nodes=nodes[:count], prims=prims), rows=int(prims[:, 3].max()) + 1)

"""The threaded BVH walk: closest hit of each ray over escape links.

Counterpart of ``_bvh_intersect`` (``rt_rs_tpu/handlers/bvh.py:314``)
and ``_rf_intersect`` (``rt_rs_tpu/handlers/rf.py:271``).  Those are
XLA code, not Pallas: the whole ray batch steps in lockstep inside one
``lax.while_loop``.  Each step a ray does one unit of work: it tests one
prim of the leaf it last entered, or it tests its current node's box and
follows the hit or miss link.  The walk ends when every ray has passed
the END sentinel (``num_nodes``) with no prim left to test.

Two leaf modes share the walk:

* **contiguous** (``bvh``): the leaf's prims are the scene rows
  ``leaf_start[node] ..`` (the arrays are in leaf order), every one
  tested;
* **payload** (the JAX package's ``rf_bvh``): the leaf's prims are read
  from 8 slots per node, ``payload[node * 8 + k]``; a slot of 0 is empty
  and skipped.  The port's ``rf_bvh`` walks its records with a kernel
  of its own (:mod:`rt_rs_tpu_torch.ops.bvh_walk_rf`); the payload
  leaves remain the referee its tests hold that walk to
  (``tests/torch_rf_tree.py``).

:func:`bvh_walk_tiled` runs kernel G (``csrc/bvh_walk.cu``) on a CUDA
tensor over the tree's packed wide records
(:mod:`rt_rs_tpu_torch.bvh.wide`), on the frame path's component-major
ray tiles (payload [8, T, r], the ``bvh`` handler's tiled entries; its
flat path pads its rays into tiles): one thread a ray, a stack (in
local memory, or in a scratch buffer for a tree deeper than
``wide.LOCAL_STACK`` entries), the same leaves entered in the same order
with the same best t, so the same prim tests in the same order and the
loop's ``(t, pid)`` bit for bit (ties keep the first prim found).  It
has three modes (:data:`WALK_MODES`): the closest hit; the closest hit
with the winner's shade-table row, written as the [32, T, r] plane the
shading kernels read (the emit branch of ``ops/shade.py::trace_tiled``,
so no row is gathered); and any hit below each ray's cap (payload row
7), the shadow verdict.  The kernel reads nothing on the host, so a
frame that calls it can be captured in a CUDA graph.

:func:`bvh_walk_reference` is the lockstep loop in plain PyTorch (rays
that have finished are dropped from the batch, which changes no ray's
tests); :func:`walk_reference` calls it on a :class:`WalkTree`.  The
twin :func:`bvh_walk_tiled_reference`, which runs for CPU tensors, is
that loop on the tile's rays, ``table[pid]`` for the rows, and the
closest hit against the cap for any-hit.  :func:`bvh_walk_wide_reference`
is the plain mirror of the kernel's design (the wide nodes, the stack,
the packed prims), for the tests and the card's checks, never the main
path.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from rt_rs_tpu_torch import tracing
from rt_rs_tpu_torch.bvh import wide
from rt_rs_tpu_torch.bvh.wide import SLOTS, WalkTree
from rt_rs_tpu_torch.ops import cuda
from rt_rs_tpu_torch.ops.intersect import tri_intersect_edges, tri_intersect_pairs
from rt_rs_tpu_torch.ops.packet_trace import _f32


@dataclasses.dataclass
class WalkWork:
    """What one walk did, counted by :func:`bvh_walk_reference`: node
    steps (box tests), prim tests (excluded and empty slots skipped),
    and the distinct nodes stepped, leaves entered and prims tested."""

    node_steps: int = 0
    prim_tests: int = 0
    nodes_read: int = 0
    leaves_read: int = 0
    prims_read: int = 0


WALK_MODES = ("closest", "rows", "anyhit")  # the kernel's modes (MODE in csrc/bvh_walk.cu)


def walk_name(payload: bool, mode: str) -> str:
    """The launch counter of one leaf kind in one mode
    (``bvh_walk[bvh,rows]``)."""
    return f"bvh_walk[{'rf' if payload else 'bvh'},{mode}]"


def node_slab(o, inv_d, bmin, bmax):
    """Slab test of each ray against its node's box [N, 3] -> (near,
    far) [N] (``_node_slab``, handlers/bvh.py:298): the reference's
    absolute wobble ``2e-6`` plus a relative one, so large scenes lose no
    hit to f32 rounding.  NaN slab distances (``0 * inf`` on an
    axis-parallel ray, or NaN directions) resolve to an entered slab."""
    wob = 2e-6 + 1e-5 * torch.maximum(bmin.abs(), bmax.abs())
    t0 = (bmin - wob - o) * inv_d
    t1 = (bmax + wob - o) * inv_d
    lo = torch.minimum(t0, t1)
    hi = torch.maximum(t0, t1)
    lo = torch.where(torch.isnan(lo), -torch.inf, lo)
    hi = torch.where(torch.isnan(hi), torch.inf, hi)
    return lo.amax(dim=-1), hi.amin(dim=-1)


def bvh_walk_reference(
    o: torch.Tensor,  # [N, 3]
    d: torch.Tensor,  # [N, 3]
    excl: torch.Tensor,  # [N] int32
    valid: torch.Tensor,  # [N] bool
    node_min: torch.Tensor,  # [M, 3] f32 (covering bounds)
    node_max: torch.Tensor,  # [M, 3]
    hit_link: torch.Tensor,  # [M] int32
    miss_link: torch.Tensor,  # [M] int32 (M = END)
    leaf_count: torch.Tensor,  # [M] int32 (0 = interior)
    leaves: torch.Tensor,  # [M] int32 leaf_start, or [M * 8] int32 payload
    pa: torch.Tensor,  # [P, 3] (row 0 = null sentinel)
    pb: torch.Tensor,
    pc: torch.Tensor,
    *,
    payload: bool,
    t_min: float,
    t_max: float,
    eps: float,
    work: WalkWork | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The binary walk in plain PyTorch, the loop kernel G matches bit
    for bit (see :func:`bvh_walk_tiled`); ``work``, if given, gets the
    walk's counts."""
    dev = o.device
    n = o.shape[0]
    end = node_min.shape[0]
    miss_t = _f32(t_max + 1.0, dev)
    out_t = miss_t.expand(n).clone()
    out_id = torch.zeros((n,), dtype=torch.int32, device=dev)
    inv_d = _f32(1.0, dev) / d
    zero = torch.zeros((n,), dtype=torch.int32, device=dev)
    rows = torch.arange(n, device=dev)
    idx = torch.where(valid, 0, end).to(torch.int32)
    left, ptr = zero, zero
    best_t, best_id = out_t.clone(), out_id.clone()
    ex = excl.to(torch.int32)
    seen_nodes = torch.zeros((end,), dtype=torch.bool, device=dev)
    seen_leaves = torch.zeros((end,), dtype=torch.bool, device=dev)
    seen_prims = torch.zeros((pa.shape[0],), dtype=torch.bool, device=dev)
    while True:
        alive = (idx < end) | (left > 0)
        n_alive = int(alive.sum())
        if n_alive < rows.shape[0]:
            # Finished rays keep their result and leave the batch.
            done = ~alive
            out_t[rows[done]] = best_t[done]
            out_id[rows[done]] = best_id[done]
            state = (rows, o, d, inv_d, ex, idx, left, ptr, best_t, best_id)
            rows, o, d, inv_d, ex, idx, left, ptr, best_t, best_id = (x[alive] for x in state)
        if n_alive == 0:
            break

        # Leaf phase: rays inside a leaf test one prim.
        testing = left > 0
        if payload:
            pid = leaves[torch.where(testing, ptr, 0).long()]
            on = testing & (pid != ex) & (pid != 0)
        else:
            pid = ptr
            on = testing & (pid != ex)
        pid_safe = torch.where(on, pid, 0)
        g = pid_safe.long()
        t = tri_intersect_pairs(o, d, pa[g], pb[g], pc[g], t_min=t_min, t_max=t_max, eps=eps)
        better = on & (t > t_min) & (t < t_max) & (t < best_t)
        best_t = torch.where(better, t, best_t)
        best_id = torch.where(better, pid_safe, best_id)
        ptr = torch.where(testing, ptr + 1, ptr)
        left = torch.where(testing, left - 1, left)

        # Node phase: the other live rays test their node and move on.
        stepping = (~testing) & (idx < end)
        safe = torch.where(stepping, idx, 0).long()
        near, far = node_slab(o, inv_d, node_min[safe], node_max[safe])
        hit = stepping & (near <= far) & (far >= t_min) & (near <= best_t)
        count = leaf_count[safe]
        enter = hit & (count > 0)
        start = safe.to(torch.int32) * SLOTS if payload else leaves[safe]
        left = torch.where(enter, count, left)
        ptr = torch.where(enter, start, ptr)
        idx = torch.where(stepping, torch.where(hit, hit_link[safe], miss_link[safe]), idx)

        if work is not None:
            work.node_steps += int(stepping.sum())
            work.prim_tests += int(on.sum())
            seen_nodes[safe[stepping]] = True
            seen_leaves[safe[enter]] = True
            seen_prims[g[on]] = True
    if work is not None:
        work.nodes_read = int(seen_nodes.sum())
        work.leaves_read = int(seen_leaves.sum())
        work.prims_read = int(seen_prims.sum())
    return out_t, out_id


def walk_reference(o, d, excl, valid, tree: WalkTree, *, t_min: float, t_max: float, eps: float, work=None):
    """:func:`bvh_walk_reference` on ``tree``'s binary tree, rays as
    :func:`tile_rays` gives them."""
    return bvh_walk_reference(
        o, d, excl, valid, *tree.binary, payload=tree.payload, t_min=t_min, t_max=t_max,
        eps=eps, work=work,
    )


@dataclasses.dataclass
class WideWork:
    """What one wide walk did, counted by :func:`bvh_walk_wide_reference`:
    wide nodes loaded, prim tests (excluded prims skipped), the most
    stack entries any ray held, and, if ``order`` is a list, each ray's
    tested pids in order (``order[i]``, appended to)."""

    node_visits: int = 0
    prim_tests: int = 0
    max_stack: int = 0
    order: list | None = None


def bvh_walk_wide_reference(
    o: torch.Tensor,
    d: torch.Tensor,
    excl: torch.Tensor,
    valid: torch.Tensor,
    tree: WalkTree,
    *,
    t_min: float,
    t_max: float,
    eps: float,
    work: WideWork | None = None,
    cap: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor] | torch.Tensor:
    """Plain mirror of kernel G's design, rays in lockstep: each ray
    runs the kernel's loop over ``tree.nodes`` and ``tree.prims``.  At a
    wide node it tests every child's box (``near <= far``, ``far >=
    t_min``, ``near <= best_t``), takes the first that passes and pushes
    the others in reverse with their near; in a leaf it tests one prim
    a step until the one marked last; then it pops until an entry's
    near is still ``<= best_t``.  With ``cap`` [N] f32, the any-hit
    mode: best t starts at the ray's cap and a ray stops at the first
    prim that passes -> blocked [N] bool."""
    dev = o.device
    if tree.nodes is None or tree.prims is None:
        raise ValueError("tree: no packed records (wide.pack_walk packs them)")
    n, w = o.shape[0], wide.WIDTH
    miss_t = _f32(t_max + 1.0, dev)
    out_t = miss_t.expand(n).clone()
    out_id = torch.zeros((n,), dtype=torch.int32, device=dev)
    out_blocked = torch.zeros((n,), dtype=torch.bool, device=dev)
    box = tree.nodes[:, : 6 * w].view(torch.float32).reshape(-1, 3, 2, w)  # [K, axis, lo/hi, child]
    words = tree.nodes[:, 6 * w : 7 * w].long()
    prims = torch.cat([tree.prims, tree.prims.new_zeros((1, wide.PRIM_WORDS))])  # a spare row for rays not in a leaf
    corner = prims.view(torch.float32).reshape(-1, 3, 4)[:, :, :3]  # a, e1, e2
    prim_id = prims[:, 3]
    last = prims[:, 7] != 0

    rows = torch.nonzero(valid).flatten()
    o, d, ex = o[rows], d[rows], excl[rows].to(torch.int32)
    inv_d = _f32(1.0, dev) / d
    r = rows.shape[0]
    cur = torch.zeros((r,), dtype=torch.long, device=dev)  # wide node, or ~prim in a leaf
    sw = torch.zeros((r, max(tree.stack, 1)), dtype=torch.long, device=dev)
    sn = torch.zeros((r, max(tree.stack, 1)), dtype=torch.float32, device=dev)
    sp = torch.zeros((r,), dtype=torch.long, device=dev)
    best_t = miss_t.expand(r).clone() if cap is None else cap[rows].to(torch.float32)
    best_id = torch.zeros((r,), dtype=torch.int32, device=dev)
    ar = torch.arange(r, device=dev)
    while r:
        pop = torch.zeros((r,), dtype=torch.bool, device=dev)

        # Leaf phase: one prim each.
        leafing = cur < 0
        ptr = torch.where(leafing, ~cur, 0)
        pid = prim_id[ptr]
        on = leafing & (pid != ex)
        a, e1, e2 = (corner[ptr, k] for k in range(3))
        t = tri_intersect_edges(o, d, a, e1, e2, t_min=t_min, t_max=t_max, eps=eps)
        better = on & (t > t_min) & (t < t_max) & (t < best_t)
        # any-hit: the first prim that passes ends the ray's walk
        blocked = better if cap is not None else torch.zeros_like(better)
        best_t = torch.where(better, t, best_t)
        best_id = torch.where(better, pid, best_id)
        done_leaf = leafing & last[ptr] & ~blocked
        pop |= done_leaf
        cur = torch.where(leafing & ~done_leaf, cur - 1, cur)  # ~(ptr + 1)
        if work is not None:
            work.prim_tests += int(on.sum())
            if work.order is not None:
                for i, p in zip(rows[on].tolist(), pid[on].tolist()):
                    work.order[i].append(p)

        # Node phase: every child's box, the first that passes taken.
        at = ~leafing
        k = torch.where(at, cur, 0)
        lo_hi = box[k]  # [r, 3, 2, w]
        t0 = (lo_hi[:, :, 0] - o[:, :, None]) * inv_d[:, :, None]
        t1 = (lo_hi[:, :, 1] - o[:, :, None]) * inv_d[:, :, None]
        lo = torch.minimum(t0, t1)
        hi = torch.maximum(t0, t1)
        lo = torch.where(torch.isnan(lo), -torch.inf, lo).amax(dim=1)  # [r, w]
        hi = torch.where(torch.isnan(hi), torch.inf, hi).amin(dim=1)
        word = words[k]
        ok = at[:, None] & (word != 0) & (lo <= hi) & (hi >= t_min) & (lo <= best_t[:, None])
        nxt = torch.zeros((r,), dtype=torch.long, device=dev)  # 0: none yet
        nxt_near = torch.zeros((r,), dtype=torch.float32, device=dev)
        for c in range(w - 1, -1, -1):
            push = ok[:, c] & (nxt != 0)
            sw[ar[push], sp[push]] = nxt[push]
            sn[ar[push], sp[push]] = nxt_near[push]
            sp = sp + push.long()
            nxt = torch.where(ok[:, c], word[:, c], nxt)
            nxt_near = torch.where(ok[:, c], lo[:, c], nxt_near)
        cur = torch.where(at & (nxt != 0), nxt, cur)
        pop |= at & (nxt == 0)
        if work is not None:
            work.node_visits += int(at.sum())
            work.max_stack = max(work.max_stack, int(sp.max()))

        # Pop until an entry's near is still within best t.
        out_blocked[rows[blocked]] = True
        finished = blocked.clone()
        while bool(pop.any()):
            empty = pop & (sp == 0)
            finished |= empty
            pop &= ~empty
            sp = sp - pop.long()
            keep = pop & (sn[ar, sp] <= best_t)
            cur = torch.where(keep, sw[ar, sp], cur)
            pop &= ~keep

        if bool(finished.any()):
            out_t[rows[finished]] = best_t[finished]
            out_id[rows[finished]] = best_id[finished]
            alive = ~finished
            state = (rows, o, d, inv_d, ex, cur, sw, sn, sp, best_t, best_id)
            rows, o, d, inv_d, ex, cur, sw, sn, sp, best_t, best_id = (x[alive] for x in state)
            r = rows.shape[0]
            ar = torch.arange(r, device=dev)
    return (out_t, out_id) if cap is None else out_blocked


BLOCK = 128  # threads a block (kBlock in csrc/bvh_walk.cu)
SCRATCH_BYTES = 256 << 20  # the most a deep tree's scratch stacks take


def scratch_threads(n: int, stack: int) -> int:
    """Threads of the scratch kernel for ``n`` rays whose walk needs
    ``stack`` entries (8 bytes each): one a ray where
    ``SCRATCH_BYTES`` holds their stacks, else as many as it holds
    (each then walks several rays); a multiple of ``BLOCK``."""
    fit = SCRATCH_BYTES // (8 * stack) // BLOCK * BLOCK
    return max(BLOCK, min(-(-n // BLOCK) * BLOCK, fit))


def _walk_stacks(tree: WalkTree, n: int, dev) -> tuple[torch.Tensor | None, int]:
    """Check ``tree``'s packed records for a launch on ``dev`` -> the
    scratch kernel's ``[2, tree.stack, threads]`` int32 buffer and
    thread count for ``n`` rays, or (None, 0) where the local stack
    holds the walk."""
    if tree.nodes is None or tree.prims is None:
        raise ValueError("tree: no packed records (wide.walk_tree packs them on a CUDA device)")
    cuda.check("nodes", tree.nodes, torch.int32, (tree.nodes.shape[0], wide.NODE_WORDS), dev)
    cuda.check("prims", tree.prims, torch.int32, (tree.prims.shape[0], wide.PRIM_WORDS), dev)
    if tree.stack <= wide.LOCAL_STACK:
        return None, 0
    threads = scratch_threads(n, tree.stack)
    return torch.empty((2, tree.stack, threads), dtype=torch.int32, device=dev), threads


@functools.lru_cache(maxsize=4)
def _packed(tree: WalkTree) -> WalkTree:
    """``tree`` with its packed records, packed on its device if it has
    none (the CPU's trees, for the trace counters)."""
    return tree if tree.nodes is not None else wide.pack_walk(*tree.binary, payload=tree.payload)


def _count_walk(o, d, excl, valid, tree: WalkTree, cap=None, **kw) -> None:
    """Kernel G's counters for one CPU call: the wide walk's (with
    ``cap``, the any-hit mode's, which also counts its valid and
    blocked rays)."""
    work = WideWork()
    out = bvh_walk_wide_reference(o, d, excl, valid, _packed(tree), work=work, cap=cap, **kw)
    dev = o.device
    tracing.add(dev, "walk_rays", valid.sum())
    tracing.add(dev, "walk_nodes", work.node_visits)
    tracing.add(dev, "walk_prims", work.prim_tests)
    if cap is not None:
        tracing.add(dev, "walk_anyhit", valid.sum())
        tracing.add(dev, "walk_blocked", out.sum())


def tile_rays(payload: torch.Tensor, valid: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """The rays of component-major tiles (payload [8, T, r], valid
    [T, r]) as the twins take them -> (o [N, 3], d [N, 3], excl [N]
    int32, valid [N], cap [N]), N = T * r in slot order."""
    o = payload[0:3].reshape(3, -1).T.contiguous()
    d = payload[3:6].reshape(3, -1).T.contiguous()
    excl = payload[6].reshape(-1).to(torch.int32)
    return o, d, excl, valid.reshape(-1), payload[7].reshape(-1)


def bvh_walk_tiled_reference(
    payload: torch.Tensor,
    valid: torch.Tensor,
    tree: WalkTree,
    *,
    t_min: float,
    t_max: float,
    eps: float,
    mode: str = "closest",
    table: torch.Tensor | None = None,
):
    """Plain-PyTorch twin of :func:`bvh_walk_tiled`: the binary walk
    (:func:`walk_reference`) on the tiles' rays; ``rows`` mode adds
    ``table[pid]`` as [32, T, r]; ``anyhit`` mode is the closest hit's
    shadow verdict against the cap (``pid != 0``, ``t_min < t < t_max``,
    ``t < cap``: the gather branch's test in ``shade_post``)."""
    o, d, excl, flat_valid, cap = tile_rays(payload, valid)
    t, pid = walk_reference(o, d, excl, flat_valid, tree, t_min=t_min, t_max=t_max, eps=eps)
    if mode == "anyhit":
        return ((pid != 0) & (t > t_min) & (t < t_max) & (t < cap)).reshape(valid.shape)
    return _tile_results(t, pid, valid.shape, table)


def bvh_walk_tiled_wide_reference(
    payload: torch.Tensor,
    valid: torch.Tensor,
    tree: WalkTree,
    *,
    t_min: float,
    t_max: float,
    eps: float,
    mode: str = "closest",
    table: torch.Tensor | None = None,
    work: WideWork | None = None,
):
    """Plain mirror of the tiled kernel's design with
    :func:`bvh_walk_tiled`'s arguments and results:
    :func:`bvh_walk_wide_reference` on the tiles' rays, in the any-hit
    mode from each ray's cap (payload row 7), for the tests and the
    card's checks (``tree`` packed)."""
    o, d, excl, flat_valid, cap = tile_rays(payload, valid)
    kw = dict(t_min=t_min, t_max=t_max, eps=eps, work=work)
    if mode == "anyhit":
        return bvh_walk_wide_reference(o, d, excl, flat_valid, tree, cap=cap, **kw).reshape(valid.shape)
    return _tile_results(*bvh_walk_wide_reference(o, d, excl, flat_valid, tree, **kw), valid.shape, table)


def _tile_results(t, pid, shape, table):
    """Flat (t, pid) as tiles of ``shape`` -> (t, pid), with the
    winners' rows of ``table`` as [32, T, r] where one is given."""
    t, pid = t.reshape(shape), pid.reshape(shape)
    if table is None:
        return t, pid
    return t, pid, table[pid.reshape(-1).long()].T.reshape(32, *shape)


def bvh_walk_tiled(
    payload: torch.Tensor,
    valid: torch.Tensor,
    tree: WalkTree,
    *,
    t_min: float,
    t_max: float,
    eps: float,
    mode: str = "closest",
    table: torch.Tensor | None = None,
):
    """Kernel G on component-major ray tiles: payload [8, T, r] f32
    (rows 0-5 o and d, row 6 the f32 exclusion id, row 7 the cap) and
    valid [T, r] bool, over ``tree``, in ``mode``:

    * ``"closest"`` -> (t, pid) [T, r], the miss sentinel
      ``(t_max + 1, 0)`` where nothing is hit or the ray is invalid;
    * ``"rows"`` -> (t, pid, rows [32, T, r]), rows the winner's row of
      ``table`` (the scene's shade table [P, 32] f32, passed at each
      call and kept nowhere), row 0 for a miss or an invalid ray;
    * ``"anyhit"`` -> blocked [T, r] bool: some prim other than the
      exclusion lies in ``(t_min, min(t_max, cap))``, the closest
      walk's verdict ``pid != 0 and t < cap`` bit for bit.

    A tree whose walk needs more than ``wide.LOCAL_STACK`` stack entries
    takes the scratch kernel, with a ``[2, tree.stack,
    scratch_threads(T * r, tree.stack)]`` int32 buffer allocated here.
    On CPU tensors, the twin :func:`bvh_walk_tiled_reference`.  While
    tracing is on, the kernel counts its valid rays, wide-node visits
    and prim tests (``tracing.py``: ``walk_rays``, ``walk_nodes``,
    ``walk_prims``) and, in the any-hit mode, its valid and blocked rays
    (``walk_anyhit``, ``walk_blocked``); on the CPU the wide mirror
    counts them on the tree packed there."""
    if mode not in WALK_MODES:
        raise ValueError(f"unknown walk mode {mode!r}; expected one of {WALK_MODES}")
    if (mode == "rows") != (table is not None):
        raise ValueError("table: required in rows mode and taken in no other")
    kw = dict(t_min=t_min, t_max=t_max, eps=eps)
    if not payload.is_cuda:
        if tracing.counting(payload.device):
            o, d, excl, flat_valid, cap = tile_rays(payload, valid)
            _count_walk(o, d, excl, flat_valid, tree, cap=cap if mode == "anyhit" else None, **kw)
        return bvh_walk_tiled_reference(payload, valid, tree, mode=mode, table=table, **kw)
    t_tiles, r = valid.shape
    n, dev = t_tiles * r, payload.device
    cuda.check("payload", payload, torch.float32, (8, t_tiles, r), dev)
    cuda.check("valid", valid, torch.bool, (t_tiles, r), dev)
    if table is not None:
        cuda.check("table", table, torch.float32, (table.shape[0], 32), dev)
        if table.data_ptr() % 16:
            raise ValueError("table: must be 16-byte aligned (the kernel reads 16-byte vectors)")
    scratch, threads = _walk_stacks(tree, n, dev)
    t = pid = rows = blocked = None
    if mode == "anyhit":
        blocked = torch.empty((t_tiles, r), dtype=torch.bool, device=dev)
    else:
        t = torch.empty((t_tiles, r), dtype=torch.float32, device=dev)
        pid = torch.empty((t_tiles, r), dtype=torch.int32, device=dev)
    if mode == "rows":
        rows = torch.empty((32, t_tiles, r), dtype=torch.float32, device=dev)
    cuda.call(
        walk_name(tree.payload, mode), "rt_bvh_walk_tiled",
        payload.data_ptr(), valid.data_ptr(), tree.nodes.data_ptr(), tree.prims.data_ptr(),
        cuda.ptr(table), cuda.ptr(scratch), n, tree.stack, threads, WALK_MODES.index(mode),
        float(t_min), float(t_max), float(eps), float(np.float32(t_max + 1.0)),
        cuda.ptr(t), cuda.ptr(pid), cuda.ptr(rows), cuda.ptr(blocked),
        *tracing.kernel_args(dev, "walk_rays"),
    )
    if mode == "anyhit":
        return blocked
    return (t, pid) if mode == "closest" else (t, pid, rows)

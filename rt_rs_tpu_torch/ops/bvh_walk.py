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
* **payload** (``rf_bvh``): the leaf's prims are read from 8 slots per
  node, ``payload[node * 8 + k]``; a slot of 0 is empty and skipped.

:func:`bvh_walk` runs kernel G (``csrc/bvh_walk.cu``) on a CUDA tensor,
one thread per ray, each running the loop body alone: a ray takes the
same tests in the same order as in the lockstep loop, so its ``(t,
pid)`` is the loop's bit for bit (ties keep the first prim found).  The
kernel reads nothing on the host, so a frame that calls it can be
captured in a CUDA graph.  :func:`bvh_walk_reference` is the lockstep
loop in plain PyTorch (rays that have finished are dropped from the
batch, which changes no ray's tests); it runs for CPU tensors.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from rt_rs_tpu_torch.ops import cuda
from rt_rs_tpu_torch.ops.intersect import tri_intersect_pairs
from rt_rs_tpu_torch.ops.packet_trace import _f32

SLOTS = 8  # payload slots per node (the RF leaf record, rf.rs:105-117)


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


def walk_name(payload: bool) -> str:
    """The launch counter of one leaf mode."""
    return "bvh_walk[rf]" if payload else "bvh_walk[bvh]"


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
    """Plain-PyTorch twin of kernel G (see :func:`bvh_walk`); ``work``,
    if given, gets the walk's counts."""
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


def bvh_walk(
    o: torch.Tensor,
    d: torch.Tensor,
    excl: torch.Tensor,
    valid: torch.Tensor,
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
    t_min: float,
    t_max: float,
    eps: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel G (csrc/bvh_walk.cu): the threaded walk of rays ``o``,
    ``d`` [N, 3] (``excl`` [N] int32 prim to skip, ``valid`` [N] bool;
    an invalid ray walks nothing) over a tree of M nodes -> (t [N] f32,
    pid [N] int32), the miss sentinel ``(t_max + 1, 0)`` where nothing
    is hit.  ``leaves`` is ``leaf_start`` [M] (contiguous mode) or the
    payload slots [M * 8] (``payload=True``)."""
    if not o.is_cuda:
        return bvh_walk_reference(
            o, d, excl, valid, node_min, node_max, hit_link, miss_link, leaf_count,
            leaves, pa, pb, pc, payload=payload, t_min=t_min, t_max=t_max, eps=eps,
        )
    n, m, p = o.shape[0], node_min.shape[0], pa.shape[0]
    dev = o.device
    cuda.check("o", o, torch.float32, (n, 3), dev)
    cuda.check("d", d, torch.float32, (n, 3), dev)
    cuda.check("excl", excl, torch.int32, (n,), dev)
    cuda.check("valid", valid, torch.bool, (n,), dev)
    cuda.check("node_min", node_min, torch.float32, (m, 3), dev)
    cuda.check("node_max", node_max, torch.float32, (m, 3), dev)
    for name, x in (("hit_link", hit_link), ("miss_link", miss_link), ("leaf_count", leaf_count)):
        cuda.check(name, x, torch.int32, (m,), dev)
    cuda.check("leaves", leaves, torch.int32, (m * SLOTS if payload else m,), dev)
    for name, x in (("pa", pa), ("pb", pb), ("pc", pc)):
        cuda.check(name, x, torch.float32, (p, 3), dev)
    t = torch.empty((n,), dtype=torch.float32, device=dev)
    pid = torch.empty((n,), dtype=torch.int32, device=dev)
    cuda.call(
        walk_name(payload), "rt_bvh_walk",
        o.data_ptr(), d.data_ptr(), excl.data_ptr(), valid.data_ptr(),
        node_min.data_ptr(), node_max.data_ptr(), hit_link.data_ptr(), miss_link.data_ptr(),
        leaf_count.data_ptr(), leaves.data_ptr(), pa.data_ptr(), pb.data_ptr(), pc.data_ptr(),
        n, m, int(payload), float(t_min), float(t_max), float(eps),
        float(np.float32(t_max + 1.0)), t.data_ptr(), pid.data_ptr(),
    )
    return t, pid

"""The RF-BVH records walk: closest hit, shade rows or any hit of each
ray over the reduced-footprint 16-byte records where they lie.

Counterpart of ``_rf_intersect`` (``rt_rs_tpu/handlers/rf.py:271``),
which walks the RF tree unpacked to f32 arrays.  Here the walk reads
the records of :mod:`rt_rs_tpu_torch.bvh.rf` as the device holds them,
one ``[R, 4]`` int32 tensor (:class:`RfRecords`): per record three
words of (f16 min, f16 max) bounds and a tag, ``fst << 16 | snd`` for
an interior record, the top bit for a leaf, which a payload record of
8 u16 slots follows (0 empty, else a prim id + 1 in the scene's own
order).  A ray tests a record when it reaches it, with
:func:`~rt_rs_tpu_torch.ops.bvh_walk.node_slab` on the decoded bounds
(f16 to f32 is exact) and the cull ``near <= far``, ``far >= t_min``,
``near <= best_t``; it takes ``fst`` before ``snd`` (the records'
preorder, the binary walk's order); in a leaf it tests the slots in
order with the triangle test of
:func:`~rt_rs_tpu_torch.ops.intersect.tri_intersect_pairs` on the
scene's own ``pa``, ``pb``, ``pc``.  A hit replaces the best when
nearer, or as near with a smaller pid, so ``(t, pid)`` is the
brute-force closest hit's whatever the order of the tests.

:func:`bvh_walk_rf_tiled` is the only entry, with the arguments,
modes and outputs of kernel G's tiled entry
(:func:`~rt_rs_tpu_torch.ops.bvh_walk.bvh_walk_tiled`): closest,
rows (the winner's shade-table row written as the [32, T, r] plane)
and any-hit (from each ray's cap in payload row 7, stopping at the
first hit).  On a CUDA tensor it launches ``csrc/bvh_walk_rf.cu``; on
a CPU tensor it runs :func:`bvh_walk_rf_reference`, the plain-PyTorch
twin that decodes the same words with torch bit operations and steps
the same walk, rays in lockstep, which the kernel equals bit for bit.
The twin imports no kernel.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from rt_rs_tpu_torch import tracing
from rt_rs_tpu_torch.ops import cuda
from rt_rs_tpu_torch.ops.bvh_walk import WALK_MODES, _tile_results, node_slab, tile_rays
from rt_rs_tpu_torch.ops.intersect import tri_intersect_pairs
from rt_rs_tpu_torch.ops.packet_trace import _f32

BLOCK = 128  # threads a block (kBlock in csrc/bvh_walk_rf.cu)
LOCAL_STACK = 64  # stack entries in local memory (kLocalStack in csrc/bvh_walk_rf.cu)
SLOTS = 8  # u16 prim slots of a leaf's payload record
SCRATCH_BYTES = 256 << 20  # the most a deep tree's scratch stacks take


@dataclasses.dataclass(frozen=True)
class RfRecords:
    """The RF records on their device: ``words`` [R, 4] int32 (the
    packed uint32 words' bits) and ``depth``, the tree's levels, which
    bound the entries a walk's stack holds."""

    words: torch.Tensor
    depth: int


@dataclasses.dataclass
class RfWork:
    """What one records walk did: the valid rays walked, the node
    records whose box it tested, and the slots it tested (empty and
    excluded slots skipped; any-hit: up to the blocker)."""

    rays: int = 0
    records: int = 0
    prims: int = 0


def walk_name(mode: str) -> str:
    """The launch counter of one mode (``bvh_walk_rf[rows]``)."""
    return f"bvh_walk_rf[{mode}]"


def halves(words: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """int32 words -> their low and high 16 bits as int32 in [0, 2^16)."""
    return words & 0xFFFF, (words >> 16) & 0xFFFF


def f16_value(bits: torch.Tensor) -> torch.Tensor:
    """16-bit patterns (int32 in [0, 2^16)) -> their f16 values as f32."""
    signed = torch.where(bits >= 1 << 15, bits - (1 << 16), bits)
    return signed.to(torch.int16).view(torch.float16).to(torch.float32)


def decode_bounds(rec: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Records [N, 4] int32 -> (bmin, bmax) [N, 3] f32."""
    lo, hi = halves(rec[:, :3])
    return f16_value(lo), f16_value(hi)


def decode_slots(payload: torch.Tensor) -> torch.Tensor:
    """Payload records [N, 4] int32 -> their 8 u16 slots [N, 8] int32,
    slot 2j in word j's low half and 2j + 1 in its high half."""
    lo, hi = halves(payload)
    return torch.stack([lo, hi], dim=2).reshape(-1, SLOTS)


def bvh_walk_rf_reference(
    o: torch.Tensor,  # [N, 3]
    d: torch.Tensor,  # [N, 3]
    excl: torch.Tensor,  # [N] int32
    valid: torch.Tensor,  # [N] bool
    records: RfRecords,
    pa: torch.Tensor,  # [P, 3] (row 0 = null sentinel)
    pb: torch.Tensor,
    pc: torch.Tensor,
    *,
    t_min: float,
    t_max: float,
    eps: float,
    cap: torch.Tensor | None = None,
    work: RfWork | None = None,
):
    """Plain-PyTorch twin of the records walk, rays in lockstep: each
    step every live ray tests the record it has reached; an interior
    record that passes pushes ``snd`` and moves to ``fst``, a leaf that
    passes tests its 8 slots in order, and otherwise the ray pops its
    stack, ending when it is empty.  -> (t [N], pid [N] int32), the miss
    sentinel ``(t_max + 1, 0)`` where nothing is hit; with ``cap`` [N]
    f32, the any-hit mode: best t starts at the cap and a ray stops at
    the first prim that passes -> blocked [N] bool.  Rays that finish
    leave the batch, which changes no ray's tests."""
    dev = o.device
    n = o.shape[0]
    words = records.words
    miss_t = _f32(t_max + 1.0, dev)
    out_t = miss_t.expand(n).clone()
    out_id = torch.zeros((n,), dtype=torch.int32, device=dev)
    out_blocked = torch.zeros((n,), dtype=torch.bool, device=dev)
    rows = torch.nonzero(valid).flatten()
    o, d, ex = o[rows], d[rows], excl[rows].to(torch.int32)
    inv_d = _f32(1.0, dev) / d
    r = rows.shape[0]
    if work is not None:
        work.rays += r
    cur = torch.zeros((r,), dtype=torch.long, device=dev)
    stack = torch.zeros((r, max(records.depth, 1)), dtype=torch.long, device=dev)
    sp = torch.zeros((r,), dtype=torch.long, device=dev)
    best_t = miss_t.expand(r).clone() if cap is None else cap[rows].to(torch.float32)
    best_id = torch.zeros((r,), dtype=torch.int32, device=dev)
    ar = torch.arange(r, device=dev)
    while r:
        rec = words[cur]
        bmin, bmax = decode_bounds(rec)
        near, far = node_slab(o, inv_d, bmin, bmax)
        hit = (near <= far) & (far >= t_min) & (near <= best_t)
        tag = rec[:, 3]
        leaf = hit & (tag < 0)  # the top bit
        inner = hit & ~leaf
        blocked = torch.zeros((r,), dtype=torch.bool, device=dev)
        if work is not None:
            work.records += r

        # A leaf's slots, all in one batch: the closest mode keeps the
        # least (t, pid), which the kernel's tests in slot order reach
        # too; the any-hit mode stops at the first slot that passes.
        li = torch.nonzero(leaf).flatten()
        if li.numel():
            pid = decode_slots(words[cur[li] + 1])  # [m, 8]
            on = (pid != 0) & (pid != ex[li, None])
            g = torch.where(on, pid, 0).long().reshape(-1)
            rep = lambda x: x[li].repeat_interleave(SLOTS, dim=0)  # noqa: E731
            t = tri_intersect_pairs(rep(o), rep(d), pa[g], pb[g], pc[g], t_min=t_min, t_max=t_max, eps=eps)
            t = t.reshape(-1, SLOTS)
            ok = on & (t > t_min) & (t < t_max)
            if cap is not None:
                stop = ok & (t < best_t[li, None])
                hit_any = stop.any(dim=1)
                first = torch.where(hit_any, stop.int().argmax(dim=1), SLOTS - 1)
                upto = torch.arange(SLOTS, device=dev)[None, :] <= first[:, None]
                blocked[li] = hit_any
                tested = int((on & upto).sum())
            else:
                tt = torch.where(ok, t, torch.inf)
                lt = tt.amin(dim=1)
                lid = torch.where(ok & (tt == lt[:, None]), pid, torch.iinfo(torch.int32).max).amin(dim=1)
                bt, bi = best_t[li], best_id[li]
                better = (lt < bt) | ((lt == bt) & (lid < bi))
                best_t[li] = torch.where(better, lt, bt)
                best_id[li] = torch.where(better, lid, bi)
                tested = int(on.sum())
            if work is not None:
                work.prims += tested

        # An interior record that passes: snd on the stack, fst next;
        # every other ray pops.
        fst = ((tag >> 16) & 0x7FFF).long()
        snd = (tag & 0xFFFF).long()
        stack[ar[inner], sp[inner]] = snd[inner]
        sp = sp + inner.long()
        pop = ~inner & (sp > 0)
        sp = sp - pop.long()
        cur = torch.where(inner, fst, torch.where(pop, stack[ar, torch.clamp(sp, max=stack.shape[1] - 1)], cur))
        finished = blocked | (~inner & ~pop)

        if bool(finished.any()):
            out_t[rows[finished]] = best_t[finished]
            out_id[rows[finished]] = best_id[finished]
            out_blocked[rows[finished]] = blocked[finished]
            alive = ~finished
            state = (rows, o, d, inv_d, ex, cur, stack, sp, best_t, best_id)
            rows, o, d, inv_d, ex, cur, stack, sp, best_t, best_id = (x[alive] for x in state)
            r = rows.shape[0]
            ar = torch.arange(r, device=dev)
    return (out_t, out_id) if cap is None else out_blocked


def bvh_walk_rf_tiled_reference(
    payload: torch.Tensor,
    valid: torch.Tensor,
    records: RfRecords,
    pa: torch.Tensor,
    pb: torch.Tensor,
    pc: torch.Tensor,
    *,
    t_min: float,
    t_max: float,
    eps: float,
    mode: str = "closest",
    table: torch.Tensor | None = None,
    work: RfWork | None = None,
):
    """Plain-PyTorch twin of :func:`bvh_walk_rf_tiled`:
    :func:`bvh_walk_rf_reference` on the tiles' rays (slot order, as
    :func:`~rt_rs_tpu_torch.ops.bvh_walk.tile_rays` maps them); ``rows``
    mode adds ``table[pid]`` as [32, T, r]; ``anyhit`` mode walks from
    each ray's cap."""
    o, d, excl, flat_valid, cap = tile_rays(payload, valid)
    kw = dict(t_min=t_min, t_max=t_max, eps=eps, work=work)
    if mode == "anyhit":
        return bvh_walk_rf_reference(o, d, excl, flat_valid, records, pa, pb, pc, cap=cap, **kw).reshape(valid.shape)
    t, pid = bvh_walk_rf_reference(o, d, excl, flat_valid, records, pa, pb, pc, **kw)
    return _tile_results(t, pid, valid.shape, table)


def scratch_threads(n: int, depth: int) -> int:
    """Threads of the scratch kernel for ``n`` rays whose stacks hold
    ``depth`` entries (4 bytes each): one a ray where ``SCRATCH_BYTES``
    holds their stacks, else as many as it holds; a multiple of
    ``BLOCK``."""
    fit = SCRATCH_BYTES // (4 * depth) // BLOCK * BLOCK
    return max(BLOCK, min(-(-n // BLOCK) * BLOCK, fit))


def bvh_walk_rf_tiled(
    payload: torch.Tensor,
    valid: torch.Tensor,
    records: RfRecords,
    pa: torch.Tensor,
    pb: torch.Tensor,
    pc: torch.Tensor,
    *,
    t_min: float,
    t_max: float,
    eps: float,
    mode: str = "closest",
    table: torch.Tensor | None = None,
):
    """The records walk on component-major ray tiles: payload [8, T, r]
    f32 (rows 0-5 o and d, row 6 the f32 exclusion id, row 7 the cap)
    and valid [T, r] bool, over ``records`` and the scene's corners
    ``pa``, ``pb``, ``pc`` [P, 3] f32, in ``mode``:

    * ``"closest"`` -> (t, pid) [T, r];
    * ``"rows"`` -> (t, pid, rows [32, T, r]), rows the winner's row of
      ``table`` (the scene's shade table [P, 32] f32, passed at each
      call), row 0 for a miss or an invalid ray;
    * ``"anyhit"`` -> blocked [T, r] bool: some prim other than the
      exclusion lies in ``(t_min, min(t_max, cap))``.

    A tree deeper than ``LOCAL_STACK`` levels takes the scratch kernel,
    with a ``[depth, scratch_threads(N, depth)]`` int32 buffer allocated
    here.  On CPU tensors, the twin.  While tracing is on the kernel
    counts its valid rays, the records it tests and its prim tests
    (``tracing.py``: ``rf_rays``, ``rf_records``, ``rf_prims``); on the
    CPU the twin counts them."""
    if mode not in WALK_MODES:
        raise ValueError(f"unknown walk mode {mode!r}; expected one of {WALK_MODES}")
    if (mode == "rows") != (table is not None):
        raise ValueError("table: required in rows mode and taken in no other")
    kw = dict(t_min=t_min, t_max=t_max, eps=eps, mode=mode, table=table)
    if not payload.is_cuda:
        work = RfWork()
        out = bvh_walk_rf_tiled_reference(payload, valid, records, pa, pb, pc, work=work, **kw)
        if tracing.counting(payload.device):
            for name, value in (("rf_rays", work.rays), ("rf_records", work.records), ("rf_prims", work.prims)):
                tracing.add(payload.device, name, value)
        return out
    t_tiles, r = valid.shape
    n, dev = t_tiles * r, payload.device
    cuda.check("payload", payload, torch.float32, (8, t_tiles, r), dev)
    cuda.check("valid", valid, torch.bool, (t_tiles, r), dev)
    cuda.check("records", records.words, torch.int32, (records.words.shape[0], 4), dev)
    for name, x in (("pa", pa), ("pb", pb), ("pc", pc)):
        cuda.check(name, x, torch.float32, (pa.shape[0], 3), dev)
    if table is not None:
        cuda.check("table", table, torch.float32, (table.shape[0], 32), dev)
        if table.data_ptr() % 16:
            raise ValueError("table: must be 16-byte aligned (the kernel reads 16-byte vectors)")
    scratch, threads = None, 0
    if records.depth > LOCAL_STACK:
        threads = scratch_threads(n, records.depth)
        scratch = torch.empty((records.depth, threads), dtype=torch.int32, device=dev)
    t = pid = rows = blocked = None
    if mode == "anyhit":
        blocked = torch.empty((t_tiles, r), dtype=torch.bool, device=dev)
    else:
        t = torch.empty((t_tiles, r), dtype=torch.float32, device=dev)
        pid = torch.empty((t_tiles, r), dtype=torch.int32, device=dev)
    if mode == "rows":
        rows = torch.empty((32, t_tiles, r), dtype=torch.float32, device=dev)
    cuda.call(
        walk_name(mode), "rt_bvh_walk_rf_tiled",
        payload.data_ptr(), valid.data_ptr(), records.words.data_ptr(), pa.data_ptr(), pb.data_ptr(),
        pc.data_ptr(), cuda.ptr(table), cuda.ptr(scratch), n, records.depth, threads,
        WALK_MODES.index(mode), float(t_min), float(t_max), float(eps), float(np.float32(t_max + 1.0)),
        cuda.ptr(t), cuda.ptr(pid), cuda.ptr(rows), cuda.ptr(blocked),
        *tracing.kernel_args(dev, "rf_rays"),
    )
    if mode == "anyhit":
        return blocked
    return (t, pid) if mode == "closest" else (t, pid, rows)

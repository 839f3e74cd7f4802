"""Packet ray tracing: ray tiles against leaf-ordered triangle chunks.

Counterpart of ``rt_rs_tpu/ops/pallas/packet_trace.py`` on its default
path.  The host half is the same: prims in BVH leaf order are packed
into 64-triangle chunks (:func:`build_tri_chunks`); per call, a
conservative cull decides which chunks each 256-ray tile must test
(the tile-interval cull for primaries, the per-ray slab cull for
bounce and shadow batches), and a stable argsort compacts each tile's
chunk list.  Two hand-written CUDA kernels do the rest:

* :func:`refine_cull` — kernel A (csrc/refine_cull.cu), the per-ray
  cull, replacing ``_refine_kernel``;
* :func:`mt_trace` — kernel B (csrc/mt_trace.cu), the Möller–Trumbore
  trace in closest-hit, emit-rows and any-hit modes, replacing
  ``_mt_kernel`` + ``mt_chunk_test``: balanced work items (a tile and a
  few consecutive list entries) on a persistent grid, merged exactly
  per ray (:func:`mt_items`, :func:`hit_key`,
  :func:`mt_trace_split_reference` mirror it), with an early-exit
  variant of the first two over front-to-back lists (``early_exit``) on
  the same items: each tile's lead item, and its later items bounded by
  the lead's snapshot (:func:`mt_trace_exit_split_reference` mirrors
  it).

The cull's knobs (``refine`` granularity, ``cull_block``,
``early_exit``) are the JAX package's; each changes the work, never
the result on valid rays.

Each wrapper launches its kernel for CUDA tensors (or raises) and runs
its plain-PyTorch twin (``*_reference``, same module) only for CPU
tensors.  The twins are written op for op like the kernels, so on the
card the two agree bit for bit.

Layouts follow the JAX package: rays are component-major payloads
``[8, T, r]`` (ox, oy, oz, dx, dy, dz, excl, cap).  The chunk table is
compact on Hopper: ``comp [Nc, tc, 9]`` (a, e1 = b - a, e2 = c - a)
instead of the TPU's lane-padded ``[Nc, tc, 128]``, and the rows table
``attr [Nc * tc + 1, 32]`` is the reordered shade table with a zero
row 0 (the miss row) instead of the TPU's transposed ``attr_t``.

Tables beyond the JAX package's resident cap are split into segments
(:class:`SegmentedTriChunks`) exactly where the JAX package splits
them, and traced segment by segment with a prim-id base and a (t, pid)
merge (:func:`packet_closest_hit_segmented_tiled`).  Hopper has no
VMEM cap to honour: a segment is an API and merge layer whose result
equals one flat call on :func:`flatten_segments` bit for bit.  All
segments share the one global rows table.  Flat ray batches take
:func:`packet_closest_hit_segmented`, the same merge over flat calls.
A :class:`DualTriChunks` holds two tables over one leaf order at two
chunk heights (pbvh's ``tri_chunk_fine``); prim ids are the same in
both, so which one a call sweeps never shows in its result.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import numpy as np
import torch

from rt_rs_tpu_torch import tracing
from rt_rs_tpu_torch.ops import cuda

LANES = 128  # the JAX package's lane width (its VMEM budgets count in it)
TRI_CHUNK = 8  # the JAX package's unit of chunk-table size
TUNED_TRI_CHUNK = 64  # triangles per chunk (the reference default)
TUNED_RAY_TILE = 256  # rays per tile: one 16x16 pixel block
# Chunk counts are padded to a multiple of CHUNK_ALIGN; pad chunks have
# zero components (det = 0 -> always miss) and inverted bounds (culled).
CHUNK_ALIGN = 32
# The JAX package's resident-table cap (in 8-triangle units).  The port
# keeps it so that both packages take the same path for a scene.
MAX_VMEM_CHUNKS = 1536
TILE_GROUP = 32  # tile counts are padded to a multiple of this
MT_MODES = ("closest", "rows", "anyhit")
# Chunks per cull block (> 1: the cull and the compaction run at
# [T, Nc / CULL_BLOCK] and each listed block expands to its chunks).
CULL_BLOCK = 1
# early_exit: the tile's running worst best t is refreshed every this
# many list entries (a stale bound only delays the exit).
EXIT_CHECK = 8
# refine=True's granularity: 1 = the exact per-ray slab cull (kernel A);
# an integer n > 1 passed as ``refine`` runs the interval cull on n-ray
# subgroups instead.
REFINE_SUB = 1
# Sort key of the chunks a tile does not list (early_exit).
UNLISTED_KEY = 3.0e38
# Kernel B's work item per mode: a tile and at most this many consecutive
# entries of its list, and early exit's item (both modes).  The kernel's
# compile-time ITEM_* (csrc/mt_trace.cu, tuned on the card, PERF.md);
# here only the plain mirrors' defaults.
MT_ITEM_SIZES = {"closest": 2, "rows": 2, "anyhit": 1}
MT_EXIT_ITEM_SIZE = 4


@dataclasses.dataclass(frozen=True)
class TriChunks:
    """Leaf-ordered triangle soup in chunks of ``tc`` triangles.

    ``comp [Nc, tc, 9]`` float32: a, e1, e2 per triangle.  ``bmin`` /
    ``bmax`` ``[Nc, 3]``: chunk AABBs.  Triangle ``s`` of chunk ``c`` is
    prim ``1 + c * tc + s`` (reordered, null-prefixed id space), plus
    the table's prim-id base when it is a segment.  ``attr [P + 1,
    32]``: the winner-row table for the emit-rows mode (row 0 zero),
    indexed by global prim id, so segments share it; None when the
    shade table has a non-finite value."""

    comp: torch.Tensor
    bmin: torch.Tensor
    bmax: torch.Tensor
    num_chunks: int
    attr: torch.Tensor | None = None

    @property
    def tri_chunk(self) -> int:
        return int(self.comp.shape[1])


@dataclasses.dataclass(frozen=True)
class DualTriChunks:
    """Two chunk tables over the same leaf order at two chunk heights:
    ``coarse`` (the table the coherent primaries sweep) and ``fine`` (a
    smaller ``tc`` that the per-ray cull of divergent bounce and shadow
    batches prunes tighter).  Packing is dense, so a triangle's global
    prim id ``1 + c * tc + s`` is its leaf index plus 1 in both tables,
    and the per-(ray, triangle) arithmetic does not depend on ``tc``:
    which table a call sweeps never shows in its output.  Either table
    may be segmented; only ``coarse`` carries the rows table."""

    coarse: "TriChunks | SegmentedTriChunks"
    fine: "TriChunks | SegmentedTriChunks"


def resident_fits(chunks: TriChunks, with_attrs: bool = False) -> bool:
    """Whether the table is within the JAX package's resident budget
    (12,288 triangles, or 8,192 with the rows table, at tc = 64).
    Hopper has no such limit; the port keeps the rule so that a scene
    takes the same path in both packages."""
    tc = chunks.tri_chunk
    tris = chunks.num_chunks * tc
    per_tri = 512 + ((32 * LANES * 4) // tc if with_attrs else 0)
    budget = MAX_VMEM_CHUNKS * TRI_CHUNK * 512  # bytes
    return tris * per_tri <= budget


def rows_budget_ok(n_tris: int, tri_chunk: int) -> bool:
    """Whether an ``n_tris``-triangle table at this chunk height, padded
    to CHUNK_ALIGN chunks as the builders pad it, keeps its rows table
    within the resident budget: :func:`resident_fits` with the rows
    table, decided before the table is built (8,192 triangles at tc =
    64, 4,096 at tc = 16)."""
    nc = -(-max(1, n_tris) // tri_chunk)
    nc = -(-nc // CHUNK_ALIGN) * CHUNK_ALIGN
    per_chunk = tri_chunk * 512 + 32 * LANES * 4
    return nc * per_chunk <= MAX_VMEM_CHUNKS * TRI_CHUNK * 512


def build_tri_chunks(
    pa: np.ndarray,
    pb: np.ndarray,
    pc: np.ndarray,
    max_chunks: int | None = MAX_VMEM_CHUNKS,
    tri_chunk: int = TRI_CHUNK,
    shade_rows: np.ndarray | None = None,  # [P+1, 32] shade table
    *,
    device: str | torch.device,
) -> TriChunks:
    """Pack reordered prim corners (rows 1.. of the scene arrays; row 0
    is the null sentinel and is excluded) into chunks, in NumPy with
    the JAX package's arithmetic, then place them on ``device``."""
    pa = np.asarray(pa, dtype=np.float32)[1:]
    pb = np.asarray(pb, dtype=np.float32)[1:]
    pc = np.asarray(pc, dtype=np.float32)[1:]
    p = pa.shape[0]
    nc = max(1, -(-p // tri_chunk))
    nc = -(-nc // CHUNK_ALIGN) * CHUNK_ALIGN
    if max_chunks is not None and nc * tri_chunk > max_chunks * TRI_CHUNK:
        raise ValueError(
            f"scene has {p} triangles -> {nc} chunks x {tri_chunk}, "
            f"exceeding the resident-table limit (~{max_chunks * TRI_CHUNK} "
            "tris)"
        )
    pad = nc * tri_chunk - p

    def padz(x):
        return np.pad(x, ((0, pad), (0, 0)))

    pa_, pb_, pc_ = padz(pa), padz(pb), padz(pc)  # degenerate pads -> miss
    e1 = pb_ - pa_
    e2 = pc_ - pa_
    comp = np.concatenate([pa_, e1, e2], axis=1).reshape(nc, tri_chunk, 9)

    tri_min = np.minimum(np.minimum(pa_, pb_), pc_)
    tri_max = np.maximum(np.maximum(pa_, pb_), pc_)
    if pad:
        # Padded triangles must never enlarge chunk bounds.
        tri_min[p:] = np.float32(np.finfo(np.float32).max)
        tri_max[p:] = np.float32(-np.finfo(np.float32).max)
    bmin = tri_min.reshape(nc, tri_chunk, 3).min(axis=1)
    bmax = tri_max.reshape(nc, tri_chunk, 3).max(axis=1)

    attr = None
    if shade_rows is not None and not np.isfinite(shade_rows).all():
        # The JAX package's rule: degenerate geometry (NaN smooth
        # normals) keeps a scene off the emit-rows path, because its
        # TPU rows matmul would spread a NaN to every ray of a tile.
        from rt_rs_tpu_torch.utils.log import logger

        logger.info(
            "shade table has non-finite values (degenerate geometry); "
            "kernel-emitted rows disabled"
        )
        shade_rows = None
    if shade_rows is not None:
        attr = np.zeros((nc * tri_chunk + 1, 32), dtype=np.float32)
        attr[1 : p + 1] = np.asarray(shade_rows, dtype=np.float32)[1:]

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return TriChunks(
        comp=dev(comp),
        bmin=dev(bmin),
        bmax=dev(bmax),
        num_chunks=nc,
        attr=None if attr is None else dev(attr),
    )


def _f32(x: float, device: torch.device) -> torch.Tensor:
    """A float32 scalar on ``device``: keeps every constant of the
    twins in f32 and every division tensor-by-tensor (a CUDA tensor
    divided by a host scalar is computed as a reciprocal multiply).
    Filled on the device (``x`` rounded to f32 as ``torch.tensor``
    rounds it), so a frame makes no host-to-device copy and can be
    captured in a CUDA graph."""
    return torch.full((), x, dtype=torch.float32, device=device)


# ----------------------------------------------------------------------
# Tile-interval cull (primaries): plain PyTorch, as the JAX package's
# XLA glue.


def _interval_mul(u_lo, u_hi, i_lo, i_hi):
    """Interval product bounds; NaN (0 * inf) resolves conservatively."""
    cands = [u_lo * i_lo, u_lo * i_hi, u_hi * i_lo, u_hi * i_hi]
    lo = cands[0]
    hi = cands[0]
    for c in cands[1:]:
        lo = torch.minimum(lo, c)
        hi = torch.maximum(hi, c)
    lo = torch.where(torch.isnan(lo), -torch.inf, lo)
    hi = torch.where(torch.isnan(hi), torch.inf, hi)
    return lo, hi


def chunk_overlap_mask(
    o: torch.Tensor,  # [T, r, 3] ray-major origins
    inv_d: torch.Tensor,  # [T, r, 3]
    ray_valid: torch.Tensor,  # [T, r] bool
    bmin: torch.Tensor,
    bmax: torch.Tensor,
    *,
    t_min: float,
    t_max: float,
    t_cap: torch.Tensor | None = None,  # [T, r]
) -> torch.Tensor:
    """:func:`chunk_overlap_mask_cm` on ray-major tiles (the streaming
    path's layout) -> the same conservative [T, Nc] mask."""
    big = _f32(3.0e38, o.device)
    v = ray_valid[..., None]
    o_lo = torch.where(v, o, big).amin(dim=1)  # [T, 3]
    o_hi = torch.where(v, o, -big).amax(dim=1)
    i_lo = torch.where(v, inv_d, big).amin(dim=1)
    i_hi = torch.where(v, inv_d, -big).amax(dim=1)
    return _overlap_from_bounds(
        o_lo, o_hi, i_lo, i_hi, ray_valid, bmin, bmax,
        t_min=t_min, t_max=t_max, t_cap=t_cap,
    )


def chunk_overlap_mask_cm(
    o3: torch.Tensor,  # [3, T, r] component-major origins
    inv3: torch.Tensor,  # [3, T, r]
    ray_valid: torch.Tensor,  # [T, r] bool
    bmin: torch.Tensor,
    bmax: torch.Tensor,
    *,
    t_min: float,
    t_max: float,
    t_cap: torch.Tensor | None = None,  # [T, r]
    want_near: bool = False,
):
    """Conservative [T, Nc] mask: False only if NO valid ray of the tile
    can hit the chunk's AABB within the t-window (each tile's rays are
    wrapped in one origin / inverse-direction interval box).

    ``want_near`` also returns the per-(tile, chunk) entry-distance
    lower bound ``max(near_lb, t_min)`` [T, Nc], valid for every ray of
    the tile: early_exit's front-to-back sort key."""
    big = _f32(3.0e38, o3.device)
    v = ray_valid[None, :, :]
    o_lo = torch.where(v, o3, big).amin(dim=2).T  # [T, 3]
    o_hi = torch.where(v, o3, -big).amax(dim=2).T
    i_lo = torch.where(v, inv3, big).amin(dim=2).T
    i_hi = torch.where(v, inv3, -big).amax(dim=2).T
    return _overlap_from_bounds(
        o_lo, o_hi, i_lo, i_hi, ray_valid, bmin, bmax,
        t_min=t_min, t_max=t_max, t_cap=t_cap, want_near=want_near,
    )


def chunk_overlap_mask_subgroup_cm(
    o3: torch.Tensor,  # [3, T, r]
    inv3: torch.Tensor,  # [3, T, r]
    ray_valid: torch.Tensor,  # [T, r] bool
    bmin: torch.Tensor,
    bmax: torch.Tensor,
    *,
    t_min: float,
    t_max: float,
    t_cap: torch.Tensor | None = None,  # [T, r]
    sub: int = 8,
) -> torch.Tensor:
    """The interval cull on ``sub``-ray pseudo-tiles (consecutive rays:
    adjacent pixels of a block), OR-reduced back to tiles -> [T, Nc].
    Conservative for the same reason as :func:`chunk_overlap_mask_cm`,
    whose cull it is on smaller tiles."""
    t_tiles, r = ray_valid.shape
    if r % sub:
        raise ValueError(f"ray tile {r} not a multiple of refine subgroup {sub}")
    g = r // sub
    ov = chunk_overlap_mask_cm(
        o3.reshape(3, t_tiles * g, sub),
        inv3.reshape(3, t_tiles * g, sub),
        ray_valid.reshape(t_tiles * g, sub),
        bmin, bmax,
        t_min=t_min, t_max=t_max,
        t_cap=None if t_cap is None else t_cap.reshape(t_tiles * g, sub),
    )  # [T * g, Nc]
    return ov.reshape(t_tiles, g, -1).any(dim=1)


def _wobble(bmin: torch.Tensor, bmax: torch.Tensor) -> torch.Tensor:
    return 1e-5 * torch.maximum(bmin.abs(), bmax.abs()) + 2e-6


def _overlap_from_bounds(
    o_lo, o_hi, i_lo, i_hi,  # [T, 3] per-tile interval bounds
    ray_valid,  # [T, r] bool
    bmin, bmax,  # [Nc, 3]
    *,
    t_min: float,
    t_max: float,
    t_cap: torch.Tensor | None,
    want_near: bool = False,
):
    dev = bmin.device
    wob = _wobble(bmin, bmax)
    lo_b = bmin - wob
    hi_b = bmax + wob
    n_tiles = o_lo.shape[0]
    nc = bmin.shape[0]
    near_lb = torch.full((n_tiles, nc), -torch.inf, dtype=torch.float32, device=dev)
    far_ub = torch.full((n_tiles, nc), torch.inf, dtype=torch.float32, device=dev)
    for ax in range(3):
        a_lo = lo_b[None, :, ax] - o_hi[:, None, ax]  # [T, Nc]
        a_hi = lo_b[None, :, ax] - o_lo[:, None, ax]
        b_lo = hi_b[None, :, ax] - o_hi[:, None, ax]
        b_hi = hi_b[None, :, ax] - o_lo[:, None, ax]
        il = i_lo[:, None, ax]
        ih = i_hi[:, None, ax]
        p0_lo, p0_hi = _interval_mul(a_lo, a_hi, il, ih)  # t0 bounds
        p1_lo, p1_hi = _interval_mul(b_lo, b_hi, il, ih)  # t1 bounds
        near_lb = torch.maximum(near_lb, torch.minimum(p0_lo, p1_lo))
        far_ub = torch.minimum(far_ub, torch.maximum(p0_hi, p1_hi))
    any_ray = ray_valid.any(dim=1)[:, None]
    # Pad chunks carry inverted bounds (min > max); the interval test
    # alone would not reject them, so cull them explicitly.
    nonempty = (bmin <= bmax).all(dim=-1)[None, :]
    t_max_t = _f32(t_max, dev)
    if t_cap is None:
        cap = t_max_t
    else:
        # A chunk beyond every valid ray's cap cannot matter.
        cap = torch.minimum(
            torch.where(ray_valid, t_cap, -torch.inf).amax(dim=1), t_max_t
        )[:, None]
    t_min_t = _f32(t_min, dev)
    mask = (
        any_ray
        & nonempty
        & (near_lb <= far_ub)
        & (far_ub >= t_min_t)
        & (near_lb <= cap)
    )
    if want_near:
        return mask, torch.maximum(near_lb, t_min_t)
    return mask


# ----------------------------------------------------------------------
# Kernel A: the per-ray refine cull (bounce and shadow batches).


def refine_cull_reference(
    payload: torch.Tensor,  # [8, T, r]
    valid: torch.Tensor,  # [T, r] bool
    bounds: torch.Tensor,  # [Nc, 6] wobbled lo xyz, hi xyz
    capm: torch.Tensor,  # [T, r] min(cap, t_max)
    *,
    t_min: float,
) -> torch.Tensor:
    """Plain-PyTorch twin of kernel A -> [T, Nc] bool (any valid ray of
    the tile passes the slab test), in TILE_GROUP-tile blocks so the
    [B, r, Nc] temporaries stay small."""
    n_tiles, r = valid.shape
    nc = bounds.shape[0]
    dev = payload.device
    inv = torch.clamp(1.0 / payload[3:6], -1e30, 1e30)
    lo = bounds[:, 0:3].T  # [3, Nc]
    hi = bounds[:, 3:6].T
    t_min_t = _f32(t_min, dev)
    out = torch.zeros((n_tiles, nc), dtype=torch.bool, device=dev)
    for b0 in range(0, n_tiles, TILE_GROUP):
        sl = slice(b0, b0 + TILE_GROUP)
        near = torch.full((1, 1, 1), -torch.inf, device=dev)
        far = torch.full((1, 1, 1), torch.inf, device=dev)
        for ax in range(3):
            ob = payload[ax, sl][:, :, None]  # [B, r, 1]
            ib = inv[ax, sl][:, :, None]
            q0 = (lo[ax][None, None, :] - ob) * ib  # [B, r, Nc]
            q1 = (hi[ax][None, None, :] - ob) * ib
            near = torch.maximum(near, torch.minimum(q0, q1))
            far = torch.minimum(far, torch.maximum(q0, q1))
        ok = (
            valid[sl][:, :, None]
            & (near <= far)
            & (far >= t_min_t)
            & (near <= capm[sl][:, :, None])
        )
        out[sl] = ok.any(dim=1)
    return out


def refine_cull(
    payload: torch.Tensor,
    valid: torch.Tensor,
    bounds: torch.Tensor,
    capm: torch.Tensor,
    *,
    t_min: float,
) -> torch.Tensor:
    """Kernel A (csrc/refine_cull.cu) -> [T, Nc] bool.  CPU tensors run
    :func:`refine_cull_reference`; CUDA tensors launch the kernel."""
    if not payload.is_cuda:
        return refine_cull_reference(payload, valid, bounds, capm, t_min=t_min)
    n_tiles, r = valid.shape
    nc = bounds.shape[0]
    dev = payload.device
    cuda.check("payload", payload, torch.float32, (8, n_tiles, r), dev)
    cuda.check("valid", valid, torch.bool, (n_tiles, r), dev)
    cuda.check("bounds", bounds, torch.float32, (nc, 6), dev)
    cuda.check("capm", capm, torch.float32, (n_tiles, r), dev)
    if r % 32 or r > 1024:
        raise ValueError(f"ray tile {r} must be a multiple of 32 <= 1024")
    out = torch.empty((n_tiles, nc), dtype=torch.bool, device=dev)
    cuda.call(
        "refine_cull", "rt_refine_cull",
        payload.data_ptr(), valid.data_ptr(), capm.data_ptr(),
        bounds.data_ptr(), out.data_ptr(), n_tiles, r, nc, float(t_min),
    )
    return out


def refine_inputs(
    valid: torch.Tensor,
    bmin: torch.Tensor,
    bmax: torch.Tensor,
    *,
    t_max: float,
    t_cap: torch.Tensor | None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (bounds [Nc, 6], capm [T, r]): kernel A's chunk bounds
    widened by the cull's wobble and each ray's window end."""
    wob = _wobble(bmin, bmax)
    bounds = torch.cat([bmin - wob, bmax + wob], dim=1).contiguous()
    t_max_t = _f32(t_max, valid.device)
    if t_cap is None:
        capm = torch.full(valid.shape, t_max, dtype=torch.float32, device=valid.device)
    else:
        capm = torch.minimum(t_cap, t_max_t).contiguous()
    return bounds, capm


def chunk_overlap_mask_perray(
    payload: torch.Tensor,  # [8, T, r]
    valid: torch.Tensor,  # [T, r] bool
    bmin: torch.Tensor,
    bmax: torch.Tensor,
    *,
    t_min: float,
    t_max: float,
    t_cap: torch.Tensor | None,
) -> torch.Tensor:
    """Per-ray slab cull OR-reduced over each tile's valid rays ->
    [T, Nc] (``_perray_overlap_kernel_call`` of the JAX package): far
    tighter lists than the interval cull when a tile's rays diverge."""
    bounds, capm = refine_inputs(valid, bmin, bmax, t_max=t_max, t_cap=t_cap)
    out = refine_cull(payload, valid, bounds, capm, t_min=t_min)
    nonempty = (bmin <= bmax).all(dim=-1)
    return out & nonempty[None, :]


def compact(overlap: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[T, Nc] mask -> (ids [T, Nc] int32, counts [T] int32): each
    tile's overlapping chunk ids first, ascending (a stable argsort of
    an int32 key, so the order is the same on every device)."""
    key = (~overlap).to(torch.int32)
    ids = torch.argsort(key, dim=1, stable=True).to(torch.int32)
    counts = overlap.sum(dim=1, dtype=torch.int32)
    return ids.contiguous(), counts


# ----------------------------------------------------------------------
# Kernel B: the Möller–Trumbore trace.


def mt_chunk_test(tri, ox, oy, oz, dx, dy, dz, *, t_min, t_max, eps):
    """The Möller–Trumbore lattice in kernel B's operation order ->
    (ok, w).  ``tri`` holds the nine components (a, e1, e2), each
    broadcastable against the ray components."""
    ax, ay, az, e1x, e1y, e1z, e2x, e2y, e2z = tri
    # p = cross(d, e2)
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    # tvec = o - a
    tx = ox - ax
    ty = oy - ay
    tz = oz - az
    # q = cross(tvec, e1)
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    det = e1x * px + e1y * py + e1z * pz
    u = tx * px + ty * py + tz * pz
    v = dx * qx + dy * qy + dz * qz
    # Two-sided test folded by sign (x * +-1 is exact).
    sgn = torch.sign(det)
    adet = det.abs()
    su = u * sgn
    sv = v * sgn
    ok = (adet > eps) & (su >= 0.0) & (su <= adet) & (sv >= 0.0) & (su + sv <= adet)
    w = (e2x * qx + e2y * qy + e2z * qz) / torch.where(ok, det, torch.ones_like(det))
    ok = ok & (w > t_min) & (w < t_max)
    return ok, w


def twin_slices(tiles: torch.Tensor, per_tile: int):
    """Split a twin's tile selection into slices whose [S, per_tile]
    lattice stays within a fixed element budget (smaller on the CPU)."""
    budget = 2**22 if tiles.device.type == "cpu" else 2**25
    step = max(1, budget // per_tile)
    return [tiles[s0 : s0 + step] for s0 in range(0, tiles.numel(), step)]


def _mt_twin(
    comp, payload, ids, counts, attr, ed, *, t_min, t_max, eps, mode, pid_base=0,
    worst0=None, bound=None, k_base=None,
):
    """Kernel B's twin -> (its result, entries tested per tile [T]
    int64).  See :func:`mt_trace_reference`.  Early exit's items
    (:func:`mt_trace_exit_split_reference`) also pass each tile's
    starting ``worst0`` [T], a per-lane ``bound`` [T, r] that the
    refreshed worst takes the minimum with, and ``k_base`` [T], the
    global list position of entry 0 (the refresh cadence counts it)."""
    dev = payload.device
    n_tiles, r = payload.shape[1], payload.shape[2]
    tc = comp.shape[1]
    f = lambda x: _f32(x, dev)  # noqa: E731
    t_min_t, t_max_t, eps_t = f(t_min), f(t_max), f(eps)
    miss = f(float(np.float32(t_max + 1.0)))
    sub = torch.arange(tc, dtype=torch.int32, device=dev)[None, :, None]
    best_t = miss.expand(n_tiles, r).clone()
    best_id = torch.zeros((n_tiles, r), dtype=torch.int32, device=dev)
    blocked = torch.zeros((n_tiles, r), dtype=torch.bool, device=dev)
    tested = torch.zeros(n_tiles, dtype=torch.int64, device=dev)
    walking = torch.ones(n_tiles, dtype=torch.bool, device=dev)
    worst = miss.expand(n_tiles).clone() if worst0 is None else worst0.clone()
    k_base = torch.zeros(n_tiles, dtype=torch.int64, device=dev) if k_base is None else k_base
    kmax = int(counts.max()) if n_tiles else 0
    for k in range(kmax):
        reach = counts > k
        if ed is not None:
            # A tile stops at its first entry whose bound is not within
            # its worst best t (NaN keys too, as `ed <= worst` is False).
            walking &= ~(reach & ~(ed[:, k] <= worst))
            reach &= walking
        tested += reach
        for sel in twin_slices(reach.nonzero()[:, 0], tc * r):
            ox, oy, oz, dx, dy, dz, excl, cap = (payload[i, sel][:, None, :] for i in range(8))
            c = ids[sel, k].to(torch.int64)
            tri = comp[c]  # [S, tc, 9]
            ok, w = mt_chunk_test(
                [tri[:, :, i : i + 1] for i in range(9)], ox, oy, oz, dx, dy, dz,
                t_min=t_min_t, t_max=t_max_t, eps=eps_t,
            )  # [S, tc, r]
            pid0 = (1 + pid_base + c.to(torch.int32) * tc)[:, None]  # [S, 1]
            ok = ok & ((pid0[:, :, None] + sub).to(torch.float32) != excl)
            if mode == "anyhit":
                blocked[sel] |= (ok & (w < cap)).any(dim=1)
                continue
            wm = torch.where(ok, w, miss)
            cmin = wm.amin(dim=1)  # [S, r]
            s_first = torch.where(wm == cmin[:, None, :], sub, tc).amin(dim=1)
            cid = pid0 + s_first
            better = cmin < best_t[sel]
            if ed is not None:
                # (t, pid)-lexicographic: the walk is no longer in
                # ascending pid order.
                better |= (cmin == best_t[sel]) & (cid < best_id[sel])
            best_t[sel] = torch.where(better, cmin, best_t[sel])
            best_id[sel] = torch.where(better, cid, best_id[sel])
        if ed is not None:
            # Every lane counts (invalid and padding rays too).
            lanes = best_t if bound is None else torch.minimum(best_t, bound)
            refresh = reach & ((k_base + k) % EXIT_CHECK == EXIT_CHECK - 1)
            worst = torch.where(refresh, lanes.amax(dim=1), worst)
    if mode == "anyhit":
        return blocked, tested
    if mode == "rows":
        rows = attr[best_id.to(torch.int64)].permute(2, 0, 1).contiguous()
        return (best_t, best_id, rows), tested
    return (best_t, best_id), tested


def mt_trace_reference(
    comp: torch.Tensor,  # [Nc, tc, 9]
    payload: torch.Tensor,  # [8, T, r]
    ids: torch.Tensor,  # [T, Nc] int32
    counts: torch.Tensor,  # [T] int32
    attr: torch.Tensor | None = None,  # [>= pid_base + Nc*tc + 1, 32]
    ed: torch.Tensor | None = None,  # [T, Nc] f32 sorted entry bounds
    *,
    t_min: float,
    t_max: float,
    eps: float,
    mode: str,
    pid_base: int = 0,
):
    """Plain-PyTorch twin of kernel B, vectorised over the tiles whose
    list reaches position ``k``, looping over ``k < max(counts)``.  Per
    chunk, the best hit of each ray (min w, ties to the smallest
    triangle) replaces the running best only when strictly nearer: the
    same result as the kernel's ascending strict scan.

    With ``ed`` (early exit; closest and rows modes) the lists are
    front-to-back and a tile stops at the first entry ``k`` with
    ``ed[t, k] > worst``, where ``worst`` is the largest best t over
    the tile's rays, refreshed after every EXIT_CHECK-th entry; the
    merge is (t, pid)-lexicographic.  Exact: ``ed`` ascends and
    ``worst`` never rises, so every later entry's hits are farther
    than every ray's best."""
    out, _ = _mt_twin(
        comp, payload, ids, counts, attr, ed,
        t_min=t_min, t_max=t_max, eps=eps, mode=mode, pid_base=pid_base,
    )
    return out


def entries_tested(comp, payload, ids, counts, attr=None, ed=None, **kw) -> torch.Tensor:
    """[T] int64: the list entries each tile of an :func:`mt_trace` call
    tests (all of ``counts`` without ``ed``; fewer where early exit
    stops a tile).  Takes :func:`mt_trace_reference`'s arguments."""
    return _mt_twin(comp, payload, ids, counts, attr, ed, **kw)[1]


# ----------------------------------------------------------------------
# Kernel B's balanced design in plain PyTorch (csrc/mt_trace.cu): the
# work items and the exact (t, pid) merge, mirrored for the tests and
# the on-card checks.


def hit_key(t: torch.Tensor, pid: torch.Tensor) -> torch.Tensor:
    """int64 merge keys ordered like (t, pid) lexicographically (t as
    floats, -0.0 taken as +0.0; 0 <= pid < 2^31).  Kernel B's unsigned
    key ``ordered_bits(t) << 32 | pid`` minus 2^63, so that torch's
    signed int64 orders them alike."""
    t = torch.where(t == 0.0, torch.zeros_like(t), t)
    bits = t.contiguous().view(torch.int32).to(torch.int64)
    ordered = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    return ordered * (1 << 32) + pid.to(torch.int64)


def hit_key_decode(key: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`hit_key`'s inverse -> (t f32, pid int32)."""
    ordered = key >> 32
    bits = torch.where(ordered < 0, ordered ^ 0x7FFFFFFF, ordered).to(torch.int32)
    return bits.view(torch.float32), (key & 0xFFFFFFFF).to(torch.int32)


def mt_items(counts: torch.Tensor, per_item: int):
    """Kernel B's work items -> (tile, k0, n) int64 [I], in item order:
    tile t's list cut into ceil(counts[t] / per_item) slices of
    ``per_item`` consecutive entries from k0 (the last one shorter).
    Item i belongs to the last tile whose first item (the exclusive scan
    of the tiles' item counts) is at most i, as the kernel finds it."""
    n_items = (counts.to(torch.int64) + per_item - 1) // per_item
    offsets = torch.cumsum(n_items, 0) - n_items
    item = torch.arange(int(n_items.sum()), device=counts.device)
    tile = torch.searchsorted(offsets, item, right=True) - 1
    k0 = (item - offsets[tile]) * per_item
    n = torch.clamp(counts[tile].to(torch.int64) - k0, max=per_item)
    return tile, k0, n


def _merge_waves(tile: torch.Tensor, order: torch.Tensor | None) -> list[torch.Tensor]:
    """Items ``order`` (a permutation of the items of ``tile``; None =
    item order) as merge waves: wave w takes each tile's w-th item in
    ``order``, so that folding the waves in turn folds a tile's items one
    after another, in that order."""
    dev = tile.device
    order = torch.arange(tile.numel(), device=dev) if order is None else order.to(dev)
    by_tile = torch.sort(tile[order], stable=True)
    first = torch.searchsorted(by_tile.values, by_tile.values)
    rank = torch.empty_like(first)
    rank[by_tile.indices] = torch.arange(order.numel(), device=dev) - first
    return [order[rank == w] for w in range(int(rank.max()) + 1 if rank.numel() else 0)]


def item_positions(ids: torch.Tensor, k0: torch.Tensor, per_item: int) -> torch.Tensor:
    """[I, per_item]: the list positions of each work item (from ``k0``
    on, clamped at the lists' width; an item reads only its first ``n``),
    so that ``ids[tile[:, None], item_positions(...)]`` is its slice."""
    pos = torch.arange(per_item, device=ids.device)
    return torch.clamp(k0[:, None] + pos, max=ids.shape[1] - 1)


def split_closest(local, ids, counts, r: int, *, t_max: float, per_item: int, order=None):
    """The balanced designs' closest-hit merge (csrc/mt_items.cuh), for
    any twin: ``local(tile, ids, n)`` -> (t, pid) [I, r], the twin on each
    work item alone (:func:`mt_items`: the item's tile's rays against
    ``ids`` [I, per_item], its slice of the list, ``n`` entries), folded
    per ray in the item order ``order`` (a permutation of the items; None
    = item order): the minimum :func:`hit_key` of the items that hit.  A
    tile of one item takes that item's result as it is, as the kernels
    write it.  -> (t [T, r], pid [T, r] int32)."""
    dev = counts.device
    n_tiles = counts.shape[0]
    tile, k0, n = mt_items(counts, per_item)
    t_loc, pid_loc = local(tile, ids[tile[:, None], item_positions(ids, k0, per_item)], n.to(torch.int32))
    miss = _f32(float(np.float32(t_max + 1.0)), dev)
    key = hit_key(miss.expand(n_tiles, r), torch.zeros((n_tiles, r), dtype=torch.int32, device=dev))
    k_loc = torch.where(t_loc < miss, hit_key(t_loc, pid_loc), key[0])
    for items in _merge_waves(tile, order):
        key[tile[items]] = torch.minimum(key[tile[items]], k_loc[items])
    t, pid = hit_key_decode(key)
    single = (counts[tile] <= per_item).nonzero()[:, 0]
    t[tile[single]] = t_loc[single]
    pid[tile[single]] = pid_loc[single]
    return t, pid


def mt_trace_split_reference(
    comp, payload, ids, counts, attr=None, *, t_min, t_max, eps, mode, pid_base=0,
    per_item: int | None = None, order: torch.Tensor | None = None,
):
    """Kernel B's balanced design (:func:`mt_trace_reference`'s
    arguments, no early exit): the twin on each work item alone (the
    tile's rays against its slice of the list), merged per ray in the
    item order ``order`` (a permutation of :func:`mt_items`; None = item
    order): the minimum :func:`hit_key` of the items that hit
    (:func:`split_closest`), or the OR of the any-hit verdicts.
    ``per_item`` None takes the kernel's size for ``mode``
    (MT_ITEM_SIZES).  Equal to :func:`mt_trace_reference` bit for bit in
    every order."""
    per_item = MT_ITEM_SIZES[mode] if per_item is None else per_item
    n_tiles, r = payload.shape[1], payload.shape[2]
    kw = dict(t_min=t_min, t_max=t_max, eps=eps, pid_base=pid_base)
    if mode == "anyhit":
        tile, k0, n = mt_items(counts, per_item)
        local = mt_trace_reference(
            comp, payload[:, tile], ids[tile[:, None], item_positions(ids, k0, per_item)],
            n.to(torch.int32), mode="anyhit", **kw,
        )
        blocked = torch.zeros((n_tiles, r), dtype=torch.bool, device=payload.device)
        for items in _merge_waves(tile, order):
            blocked[tile[items]] |= local[items]
        return blocked
    t, pid = split_closest(
        lambda tile, item_ids, n: mt_trace_reference(comp, payload[:, tile], item_ids, n, mode="closest", **kw),
        ids, counts, r, t_max=t_max, per_item=per_item, order=order,
    )
    if mode == "rows":
        return t, pid, attr[pid.to(torch.int64)].permute(2, 0, 1).contiguous()
    return t, pid


def _exit_split(
    comp, payload, ids, counts, attr, ed, *, t_min, t_max, eps, mode, pid_base=0,
    per_item=None, order=None,
):
    """:func:`mt_trace_exit_split_reference` -> (its result, entries
    tested per tile [T] int64)."""
    per_item = MT_EXIT_ITEM_SIZE if per_item is None else per_item
    dev = payload.device
    kw = dict(t_min=t_min, t_max=t_max, eps=eps, mode="closest", pid_base=pid_base)
    # Each tile's lead: the twin's walk on its first per_item entries.
    (t, pid), tested = _mt_twin(
        comp, payload, ids, torch.clamp(counts, max=per_item), None, ed, **kw
    )
    # The later items: from the lead's worst, each lane bounded by the
    # lead's best t.
    rest = torch.clamp(counts - per_item, min=0)
    tile, k0, n = mt_items(rest, per_item)
    if tile.numel():
        k0 = k0 + per_item
        pos = item_positions(ids, k0, per_item)
        (t_loc, pid_loc), tested_loc = _mt_twin(
            comp, payload[:, tile], ids[tile[:, None], pos], n.to(torch.int32), None,
            ed[tile[:, None], pos], worst0=t.amax(dim=1)[tile], bound=t[tile], k_base=k0, **kw,
        )
        tested = tested.index_add(0, tile, tested_loc)
        miss = _f32(float(np.float32(t_max + 1.0)), dev)
        key = hit_key(t, pid)
        k_loc = torch.where(t_loc < miss, hit_key(t_loc, pid_loc), key[tile])
        for items in _merge_waves(tile, order):
            key[tile[items]] = torch.minimum(key[tile[items]], k_loc[items])
        t_key, pid_key = hit_key_decode(key)
        multi = (counts > per_item)[:, None]
        t, pid = torch.where(multi, t_key, t), torch.where(multi, pid_key, pid)
    if mode == "rows":
        return (t, pid, attr[pid.to(torch.int64)].permute(2, 0, 1).contiguous()), tested
    return (t, pid), tested


def mt_trace_exit_split_reference(
    comp, payload, ids, counts, attr=None, ed=None, *, t_min, t_max, eps, mode, pid_base=0,
    per_item: int | None = None, order: torch.Tensor | None = None,
):
    """Early exit's balanced design (csrc/mt_items.cuh; the closest and
    rows modes of :func:`mt_trace_reference` with ``ed``).  Each tile's
    lead item walks its first ``per_item`` entries with the twin's
    per-tile rule; a tile whose list fits takes that result as it is.
    Every later item (:func:`mt_items` of the remaining entries) walks
    with the same rule, starting from the largest of the lead's per-lane
    bests and refreshing to the largest over lanes of min(own best, the
    lead's best); their hits are folded into the lead's :func:`hit_key`
    per ray in the item order ``order`` (a permutation of the later
    items; None = item order).  Items read only
    the lead's snapshot, so the result is the same in every order, and
    on valid rays it equals :func:`mt_trace_reference` bit for bit (and
    so the default mode's result); on invalid rays of tiles with more
    than one item it may differ from the twin's, which depends on where
    the sequential walk stopped.  ``per_item`` None takes the kernel's
    size (MT_EXIT_ITEM_SIZE)."""
    if mode not in ("closest", "rows") or ed is None:
        raise ValueError("the early-exit mirror needs ed and the closest or rows mode")
    return _exit_split(
        comp, payload, ids, counts, attr, ed, t_min=t_min, t_max=t_max, eps=eps,
        mode=mode, pid_base=pid_base, per_item=per_item, order=order,
    )[0]


def exit_entries_tested(comp, payload, ids, counts, attr=None, ed=None, **kw) -> torch.Tensor:
    """[T] int64: the list entries each tile of an early-exit
    :func:`mt_trace` call tests on the card (the lead's and every rest
    item's, :func:`mt_trace_exit_split_reference`).  Takes its
    arguments."""
    return _exit_split(comp, payload, ids, counts, attr, ed, **kw)[1]


def mt_trace(
    comp: torch.Tensor,
    payload: torch.Tensor,
    ids: torch.Tensor,
    counts: torch.Tensor,
    attr: torch.Tensor | None = None,
    ed: torch.Tensor | None = None,
    *,
    t_min: float,
    t_max: float,
    eps: float,
    mode: str,
    pid_base: int = 0,
    counter: str | None = None,
):
    """Kernel B (csrc/mt_trace.cu).  ``mode`` "closest" -> (t [T, r],
    pid [T, r] int32); "rows" -> (t, pid, rows [32, T, r]); "anyhit" ->
    blocked [T, r] bool.  Prim ids are global: triangle ``s`` of chunk
    ``c`` is ``1 + pid_base + c * tc + s``, for the exclusion test, the
    returned pid and the row read from ``attr``.  ``ed`` [T, Nc] f32
    (the sorted entry bounds of front-to-back lists) selects the
    early-exit variant of the closest and rows modes, counted as
    ``mt_trace[<mode>,early_exit]``.  CPU tensors run
    :func:`mt_trace_reference`; CUDA tensors launch the kernel: balanced
    work items on a persistent grid with an exact (t, pid) merge, two
    launches.  Without ``ed``, MT_ITEM_SIZES entries an item (see
    :func:`mt_trace_split_reference`); with ``ed``, MT_EXIT_ITEM_SIZE
    entries an item, each tile's lead item and the later ones bounded by
    its snapshot (see :func:`mt_trace_exit_split_reference`: equal to the
    twin on valid rays).  ``counter``: the ``cull_entries`` counter that
    the sum of ``counts`` adds to while tracing is on (``tracing.py``);
    None counts nothing."""
    if mode not in MT_MODES:
        raise ValueError(f"unknown mode {mode!r}; expected one of {MT_MODES}")
    if mode == "rows" and attr is None:
        raise ValueError("rows mode needs the attr table")
    if mode == "anyhit" and ed is not None:
        raise ValueError("early exit (ed) has no any-hit variant")
    kw = dict(t_min=t_min, t_max=t_max, eps=eps, mode=mode, pid_base=pid_base)
    if not payload.is_cuda:
        if counter is not None and tracing.counting(payload.device):
            tracing.add(payload.device, counter, counts.sum())
        return mt_trace_reference(comp, payload, ids, counts, attr, ed, **kw)
    nc, tc = comp.shape[0], comp.shape[1]
    n_tiles, r = payload.shape[1], payload.shape[2]
    dev = payload.device
    cuda.check("comp", comp, torch.float32, (nc, tc, 9), dev)
    cuda.check("payload", payload, torch.float32, (8, n_tiles, r), dev)
    cuda.check("ids", ids, torch.int32, (n_tiles, nc), dev)
    cuda.check("counts", counts, torch.int32, (n_tiles,), dev)
    if ed is not None:
        cuda.check("ed", ed, torch.float32, (n_tiles, nc), dev)
    if mode == "rows":
        need = pid_base + nc * tc + 1
        cuda.check("attr", attr, torch.float32, (attr.shape[0], 32), dev)
        if attr.shape[0] < need:
            raise ValueError(f"attr: {attr.shape[0]} rows, need at least {need}")
    if r % 32 or r > 1024:
        raise ValueError(f"ray tile {r} must be a multiple of 32 <= 1024")
    out_t = out_pid = out_rows = out_blocked = None
    if mode == "anyhit":
        out_blocked = torch.empty((n_tiles, r), dtype=torch.bool, device=dev)
    else:
        out_t = torch.empty((n_tiles, r), dtype=torch.float32, device=dev)
        out_pid = torch.empty((n_tiles, r), dtype=torch.int32, device=dev)
    if mode == "rows":
        out_rows = torch.empty((32, n_tiles, r), dtype=torch.float32, device=dev)
    # The balanced design's scratch (csrc/mt_items.cuh): the item
    # counters, per-tile item offsets and finished-item counts, per-ray
    # merge keys and, for early exit, the leads' per-lane best t and
    # per-tile worst; the kernel initialises all of them.
    work = torch.empty((4 * n_tiles + 4,), dtype=torch.int32, device=dev)
    keys = lead = None
    if mode != "anyhit":
        keys = torch.empty((n_tiles, r), dtype=torch.int64, device=dev)
    if ed is not None:
        lead = torch.empty((n_tiles * (r + 1),), dtype=torch.float32, device=dev)
    cuda.call(
        mt_name(mode, ed is not None), "rt_mt_trace",
        payload.data_ptr(), comp.data_ptr(), ids.data_ptr(),
        counts.data_ptr(), cuda.ptr(attr if mode == "rows" else None),
        cuda.ptr(ed), cuda.ptr(out_t), cuda.ptr(out_pid), cuda.ptr(out_rows),
        cuda.ptr(out_blocked), cuda.ptr(keys), cuda.ptr(work), cuda.ptr(lead), n_tiles, r, nc, tc,
        int(pid_base), float(t_min), float(t_max), float(eps),
        float(np.float32(t_max + 1.0)), MT_MODES.index(mode), EXIT_CHECK,
        *tracing.kernel_args(dev, counter),
    )
    if mode == "anyhit":
        return out_blocked
    if mode == "rows":
        return out_t, out_pid, out_rows
    return out_t, out_pid


def mt_name(mode: str, early_exit: bool) -> str:
    """Kernel B's launch-counter name for one mode and variant."""
    return f"mt_trace[{mode},early_exit]" if early_exit else f"mt_trace[{mode}]"


def early_exit_lists(
    overlap: torch.Tensor,  # [T, Nc] the call's cull (any formulation)
    near: torch.Tensor,  # [T, Nc] the interval cull's entry bounds
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (ids [T, Nc] int32, counts [T] int32, ed [T, Nc] f32): each
    tile's listed chunks front to back by their entry bound, unlisted
    chunks after them (key UNLISTED_KEY), ties in ascending chunk id (a
    stable sort; NaN keys sort last, as in NumPy and JAX), and the
    sorted keys."""
    key = torch.where(overlap, near, _f32(UNLISTED_KEY, near.device))
    ed, order = torch.sort(key, dim=1, stable=True)
    counts = overlap.sum(dim=1, dtype=torch.int32)
    return order.to(torch.int32).contiguous(), counts, ed.contiguous()


def packet_closest_hit_tiled(
    chunks: TriChunks,
    payload: torch.Tensor,  # [8, T, r] f32 component-major ray tiles
    valid: torch.Tensor,  # [T, r] bool
    t_cap: torch.Tensor | None = None,  # [T, r]
    *,
    t_min: float,
    t_max: float,
    eps: float,
    cull_block: int = CULL_BLOCK,
    pid_base: int = 0,
    emit_rows: bool = False,
    any_hit: bool = False,
    refine: bool | int = False,
    early_exit: bool = False,
):
    """Closest hit over component-major ray tiles -> (t [T, r], pid
    [T, r] int32), plus the winners' shade rows [32, T, r] with
    ``emit_rows``; with ``any_hit``, blocked [T, r] bool: some prim
    other than the ray's exclusion lies in (t_min, payload row 7).

    Outputs are specified for valid rays only.  ``t_cap`` only tightens
    culling.  ``pid_base`` shifts the table's prim ids into a global id
    space (a segment of a larger table): the exclusion test, the
    returned ids and the rows read from ``chunks.attr`` are global;
    misses stay 0.  The knobs below change the work, never the result
    on valid rays:

    * ``refine``: False / 0 takes the tile-interval cull; True or 1 the
      per-ray slab cull (kernel A); an integer n > 1 the interval cull
      on n-ray subgroups (:func:`chunk_overlap_mask_subgroup_cm`).
    * ``cull_block``: the cull and the compaction run over blocks of
      this many consecutive chunks, each listed block expanding to its
      chunks in the kernel's list.
    * ``early_exit`` (closest and rows modes; ignored for any-hit;
      needs ``cull_block == 1``): lists sorted front to back by the
      interval cull's entry bound, and the kernel's early-exit variant
      skips the entries beyond its tiles' worst best t."""
    nc = chunks.num_chunks
    if cull_block < 1 or nc % cull_block:
        raise ValueError(
            f"chunk count {nc} not divisible by cull_block {cull_block} "
            f"(builders pad to CHUNK_ALIGN={CHUNK_ALIGN})"
        )
    # The JAX package carries prim ids as f32 and refuses ids at or
    # above 2^24; the port keeps the same bound (and exclusion ids are
    # still f32 in the payload).
    if pid_base + nc * chunks.tri_chunk + 1 >= 1 << 24:
        raise ValueError(
            "prim ids exceed f32 exact-integer range (2^24); scene too "
            "large for exact exclusion/hit ids"
        )
    t_tiles = valid.shape[0]
    if t_tiles % TILE_GROUP:
        raise ValueError(f"tile count {t_tiles} not a multiple of {TILE_GROUP}")
    if emit_rows and any_hit:
        raise ValueError("emit_rows and any_hit are mutually exclusive")
    if emit_rows and chunks.attr is None:
        raise ValueError("emit_rows requires a chunk table built with shade_rows")
    early_exit = early_exit and not any_hit
    if early_exit and cull_block != 1:
        raise ValueError("early_exit requires cull_block == 1")
    if cull_block > 1:
        nb = nc // cull_block
        blk_min = chunks.bmin.reshape(nb, cull_block, 3).amin(dim=1)
        blk_max = chunks.bmax.reshape(nb, cull_block, 3).amax(dim=1)
    else:
        blk_min, blk_max = chunks.bmin, chunks.bmax
    win = dict(t_min=t_min, t_max=t_max, t_cap=t_cap)
    inv3 = 1.0 / payload[3:6]
    near = None
    if refine:
        n_sub = REFINE_SUB if refine is True else int(refine)
        if n_sub == 1:
            overlap = chunk_overlap_mask_perray(payload, valid, blk_min, blk_max, **win)
        else:
            overlap = chunk_overlap_mask_subgroup_cm(
                payload[0:3], inv3, valid, blk_min, blk_max, sub=n_sub, **win
            )
        if early_exit:
            # The interval formulation's bound holds for every ray of
            # the tile, so it orders the refined list too.
            _, near = chunk_overlap_mask_cm(
                payload[0:3], inv3, valid, blk_min, blk_max, want_near=True, **win
            )
    elif early_exit:
        overlap, near = chunk_overlap_mask_cm(
            payload[0:3], inv3, valid, blk_min, blk_max, want_near=True, **win
        )
    else:
        overlap = chunk_overlap_mask_cm(payload[0:3], inv3, valid, blk_min, blk_max, **win)
    ed = None
    if early_exit:
        ids, counts, ed = early_exit_lists(overlap, near)
    else:
        ids, counts = compact(overlap)
    if cull_block > 1:
        ids = (
            ids[:, :, None] * cull_block
            + torch.arange(cull_block, dtype=torch.int32, device=ids.device)
        ).reshape(t_tiles, nc)
        counts = counts * cull_block
    mode = "anyhit" if any_hit else ("rows" if emit_rows else "closest")
    return mt_trace(
        chunks.comp, payload, ids, counts, chunks.attr if emit_rows else None, ed,
        t_min=t_min, t_max=t_max, eps=eps, mode=mode, pid_base=pid_base,
        counter=tracing.cull_counter(mode, refine),
    )


# ----------------------------------------------------------------------
# Segmented tables: the JAX package's beyond-VMEM split, kept so that
# segment boundaries, prim bases and seg_order tuples mean the same in
# both packages.


@dataclasses.dataclass(frozen=True)
class SegmentedTriChunks:
    """A chunk table split into segments; ``prim_base[i]`` is segment
    i's global prim-id offset.  Segments are slices of one table and
    share its rows table."""

    segments: tuple[TriChunks, ...]
    prim_base: tuple[int, ...]

    @property
    def num_chunks(self) -> int:
        return sum(s.num_chunks for s in self.segments)


def split_chunks_traced(
    chunks: TriChunks, max_seg_tris: int | None = None
) -> SegmentedTriChunks:
    """Split a chunk table into segments of views on it.

    Sized by the JAX package's byte model, not by the port's own
    ``[Nc, tc, 9]`` bytes: a triangle costs 512 B of lane-padded
    components plus ``32 * LANES * 4 / tc`` B of rows table when the
    table carries one, against the budget ``MAX_VMEM_CHUNKS * TRI_CHUNK
    * 512`` B; segments are whole multiples of CHUNK_ALIGN chunks (8,192
    triangles at tc = 64 with rows, 12,288 without)."""
    nc = chunks.num_chunks
    tc = chunks.tri_chunk
    if max_seg_tris is None:
        budget = MAX_VMEM_CHUNKS * TRI_CHUNK * 512
        per_tri = 512 + ((32 * LANES * 4) // tc if chunks.attr is not None else 0)
        max_seg_tris = budget // per_tri
    seg_chunks = max(CHUNK_ALIGN, (max_seg_tris // tc) // CHUNK_ALIGN * CHUNK_ALIGN)
    segments, bases = [], []
    for s0 in range(0, nc, seg_chunks):
        s1 = min(nc, s0 + seg_chunks)
        segments.append(
            TriChunks(
                comp=chunks.comp[s0:s1],
                bmin=chunks.bmin[s0:s1],
                bmax=chunks.bmax[s0:s1],
                num_chunks=s1 - s0,
                attr=chunks.attr,
            )
        )
        bases.append(s0 * tc)
    return SegmentedTriChunks(segments=tuple(segments), prim_base=tuple(bases))


def split_chunks(chunks: TriChunks, max_seg_tris: int | None = None) -> SegmentedTriChunks:
    """:func:`split_chunks_traced` with each segment's components and
    bounds in a buffer of its own (the shared rows table stays one)."""
    seg = split_chunks_traced(chunks, max_seg_tris)
    return SegmentedTriChunks(
        segments=tuple(
            dataclasses.replace(
                s, comp=s.comp.clone(), bmin=s.bmin.clone(), bmax=s.bmax.clone()
            )
            for s in seg.segments
        ),
        prim_base=seg.prim_base,
    )


def flatten_segments(accel, pad_multiple: int = 1) -> TriChunks:
    """The one flat chunk table behind a segmented (or flat) table.
    Segments were sliced from one table, so concatenating them
    reproduces it exactly.  ``pad_multiple`` appends never-hit chunks
    (zero components, inverted bounds, zero rows) so the chunk count
    divides it."""
    if isinstance(accel, TriChunks):
        parts = (accel,)
    elif isinstance(accel, SegmentedTriChunks):
        parts = accel.segments
    else:
        raise TypeError(f"no flat chunk table behind {type(accel).__name__}")
    if len(parts) == 1 and parts[0].num_chunks % pad_multiple == 0:
        return parts[0]
    comp = torch.cat([s.comp for s in parts])
    bmin = torch.cat([s.bmin for s in parts])
    bmax = torch.cat([s.bmax for s in parts])
    attr = parts[0].attr if all(s.attr is not None for s in parts) else None
    nc = sum(s.num_chunks for s in parts)
    nc_pad = -(-nc // pad_multiple) * pad_multiple
    if nc_pad != nc:
        extra = nc_pad - nc
        tc = comp.shape[1]
        fmax = float(np.finfo(np.float32).max)
        comp = torch.cat([comp, comp.new_zeros((extra, tc, 9))])
        bmin = torch.cat([bmin, bmin.new_full((extra, 3), fmax)])
        bmax = torch.cat([bmax, bmax.new_full((extra, 3), -fmax)])
        if attr is not None:
            attr = torch.cat([attr, attr.new_zeros((nc_pad * tc + 1 - attr.shape[0], 32))])
    return TriChunks(comp=comp, bmin=bmin, bmax=bmax, num_chunks=nc_pad, attr=attr)


def _check_total_prims_f32(seg: SegmentedTriChunks) -> None:
    """Global prim ids (and the exclusion ids compared with them) must
    stay exact in f32: below 2^24."""
    last = seg.segments[-1]
    total = seg.prim_base[-1] + last.num_chunks * last.tri_chunk
    if total + 1 >= 1 << 24:
        raise ValueError(
            "prim ids exceed f32 exact-integer range (2^24); scene too "
            "large for exact exclusion/hit ids"
        )


def packet_closest_hit_segmented_tiled(
    seg: SegmentedTriChunks,
    payload: torch.Tensor,  # [8, T, r]; the excl row holds global ids
    valid: torch.Tensor,  # [T, r]
    t_cap: torch.Tensor | None = None,
    *,
    t_min: float,
    t_max: float,
    eps: float,
    emit_rows: bool = False,
    any_hit: bool = False,
    chain: bool = True,
    refine: bool | int = False,
    cull_block: int = CULL_BLOCK,
    early_exit: bool = False,
    seg_order: tuple[int, ...] | None = None,
):
    """:func:`packet_closest_hit_tiled` over a segmented table: one call
    per segment with its ``pid_base``, merged.

    Closest hit merges (t, pid)-lexicographically (equal t keeps the
    smallest global prim id), so the result is the same for every visit
    order ``seg_order`` (a permutation of the segments; None = scene
    order) and equals one flat call bit for bit; with ``emit_rows`` the
    winner's rows are selected alongside.  Any-hit ORs the segments'
    verdicts, each masked by its call's validity (outputs for invalid
    rays are unspecified).  ``chain`` feeds each segment's result into
    the next call's cull: closest hit caps the next segment at
    ``min(t_cap, best so far)``, any-hit drops rays already blocked.
    Both are exact: a chunk culled by the cap could only lose the merge,
    and a blocked ray's verdict is final.  ``refine``, ``cull_block``
    and ``early_exit`` pass to every segment's call (early exit to the
    closest-hit calls only)."""
    if emit_rows and any_hit:
        raise ValueError("emit_rows and any_hit are mutually exclusive")
    _check_total_prims_f32(seg)
    n_seg = len(seg.segments)
    if seg_order is None:
        seg_order = tuple(range(n_seg))
    elif sorted(seg_order) != list(range(n_seg)):
        raise ValueError(
            f"seg_order {seg_order!r} is not a permutation of range({n_seg})"
        )
    kw = dict(t_min=t_min, t_max=t_max, eps=eps, refine=refine, cull_block=cull_block)
    visit = [(seg.prim_base[s], seg.segments[s]) for s in seg_order]
    if any_hit:
        blocked = None
        valid_s = valid
        for base, part in visit:
            b_s = packet_closest_hit_tiled(
                part, payload, valid_s, t_cap, pid_base=base, any_hit=True, **kw
            )
            b_s = b_s & valid_s
            blocked = b_s if blocked is None else (blocked | b_s)
            if chain:
                valid_s = valid & ~blocked
        return blocked
    best = None
    for base, part in visit:
        cap_s = t_cap
        if chain and best is not None:
            cap_s = best[0] if cap_s is None else torch.minimum(cap_s, best[0])
        out = packet_closest_hit_tiled(
            part, payload, valid, cap_s, pid_base=base, emit_rows=emit_rows,
            early_exit=early_exit, **kw,
        )
        if best is None:
            best = out
            continue
        t_s, id_s = out[0], out[1]
        better = (t_s < best[0]) | ((t_s == best[0]) & (id_s < best[1]))
        best = tuple(
            torch.where(better[None] if o.dim() == 3 else better, o, b)
            for o, b in zip(out, best)
        )
    return best


def packet_closest_hit_segmented(
    seg: SegmentedTriChunks,
    o: torch.Tensor,  # [N, 3]
    d: torch.Tensor,  # [N, 3]
    excl: torch.Tensor,  # [N] int32, global prim ids
    valid: torch.Tensor | None = None,  # [N] bool
    t_cap: torch.Tensor | None = None,  # [N] (culling only)
    *,
    t_min: float,
    t_max: float,
    eps: float,
    cull_block: int = CULL_BLOCK,
    ray_tile: int = LANES,
    refine: bool | int = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Closest hit of a flat ray batch over a segmented table -> (t [N],
    pid [N] int32): one :func:`packet_closest_hit` per segment in scene
    order, merged.

    Each call tests the exclusion in segment-local ids (a ray whose
    exclusion lies in another segment gets an id that matches nothing)
    and its hits are shifted back to global ids.  The running best caps
    the next segment's cull.  The merge keeps the smaller t, and on a
    tie the earlier segment, whose prim ids are the smaller: the result
    equals :func:`packet_closest_hit_segmented_tiled` in scene order on
    the same rays, bit for bit."""
    _check_total_prims_f32(seg)
    best_t = best_id = None
    for base, part in zip(seg.prim_base, seg.segments):
        cap_s = t_cap
        if best_t is not None:
            cap_s = best_t if cap_s is None else torch.minimum(cap_s, best_t)
        t_s, id_s = packet_closest_hit(
            part, o, d, excl - base, valid, cap_s,
            t_min=t_min, t_max=t_max, eps=eps, cull_block=cull_block,
            ray_tile=ray_tile, refine=refine,
        )
        id_s = torch.where(id_s > 0, id_s + base, 0).to(torch.int32)
        if best_t is None:
            best_t, best_id = t_s, id_s
        else:
            better = t_s < best_t
            best_t = torch.where(better, t_s, best_t)
            best_id = torch.where(better, id_s, best_id)
    return best_t, best_id


# ----------------------------------------------------------------------
# The flat entry: [N]-ray batches in the tiled layout.


def ray_tiler(n: int, ray_tile: int):
    """-> (T, tiles): ``tiles(x)`` zero-pads a flat [N, ...] batch to T
    tiles of ``ray_tile`` rays, T TILE_GROUP-aligned, as [T, r, ...]."""
    t_tiles = max(1, -(-n // ray_tile))
    t_tiles = -(-t_tiles // TILE_GROUP) * TILE_GROUP

    def tiles(x):
        fill = x.new_zeros((t_tiles * ray_tile - n, *x.shape[1:]))
        return torch.cat([x, fill]).reshape(t_tiles, ray_tile, *x.shape[1:])

    return t_tiles, tiles


def flat_call(tiled_fn, ray_tile: int, o, d, excl, valid=None, t_cap=None):
    """A tiled closest-hit entry ``tiled_fn(payload, valid, t_cap)`` on a
    flat batch (``o``, ``d`` [N, 3], ``excl`` [N] int, ``valid`` [N]
    bool or None, ``t_cap`` [N] or None) -> (t [N], pid [N]): the rays
    are zero-padded into ``ray_tile``-ray tiles, TILE_GROUP-aligned, in
    the component-major payload (excl as f32 in row 6), and the results
    cut back to N."""
    n = o.shape[0]
    t_tiles, tiles = ray_tiler(n, ray_tile)
    if valid is None:
        valid = torch.ones((n,), dtype=torch.bool, device=o.device)
    payload = torch.cat(
        [
            tiles(o).permute(2, 0, 1),
            tiles(d).permute(2, 0, 1),
            tiles(excl)[None].to(torch.float32),
            o.new_zeros((1, t_tiles, ray_tile)),
        ]
    ).contiguous()
    cap = None if t_cap is None else tiles(t_cap)
    t, pid = tiled_fn(payload, tiles(valid), cap)
    return t.reshape(-1)[:n], pid.reshape(-1)[:n]


def packet_closest_hit(
    chunks: TriChunks,
    o: torch.Tensor,  # [N, 3]
    d: torch.Tensor,  # [N, 3]
    excl: torch.Tensor,  # [N] int32
    valid: torch.Tensor | None = None,  # [N] bool
    t_cap: torch.Tensor | None = None,  # [N] (culling only)
    *,
    t_min: float,
    t_max: float,
    eps: float,
    cull_block: int = CULL_BLOCK,
    ray_tile: int = LANES,
    refine: bool | int = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Closest hit of a flat ray batch over the chunk table -> (t [N],
    pid [N] int32): :func:`packet_closest_hit_tiled` on the rays padded
    into ``ray_tile``-ray tiles (default 128, the JAX package's).  The
    result does not depend on the tiling."""
    tiled = partial(
        packet_closest_hit_tiled, chunks,
        t_min=t_min, t_max=t_max, eps=eps, cull_block=cull_block, refine=refine,
    )
    return flat_call(tiled, ray_tile, o, d, excl, valid, t_cap)


def tag_refine(fn, mode: str):
    """Mark a tiled-entry callable with the refine policy so
    :func:`rt_rs_tpu_torch.ops.shade.trace_tiled` can opt bounce and
    shadow batches into the per-ray cull: ``"all"`` bakes
    ``refine=True`` into every call, ``"bounces"`` only advertises
    support."""
    if mode not in ("off", "bounces", "all"):
        raise ValueError(f"unknown refine mode {mode!r}")
    if mode == "all":
        fn = partial(fn, refine=True)
    fn.supports_refine = mode != "off"
    return fn

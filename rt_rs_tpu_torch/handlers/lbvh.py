"""LBVH backend: the chunk table built on the device.

Counterpart of ``rt_rs_tpu/handlers/lbvh.py``.  The prims are sorted
by Morton code and packed into the packet kernels' chunk table with
torch ops on the scene's device, so the "build" is a few device ops
that a frame can repeat:

* a static scene builds once in :meth:`LbvhIntrs.build`;
* a dynamic scene on the packet kernels calls :func:`build_accel_device`
  (or :func:`device_chunks` over a frozen order) inside each frame step
  (:class:`rt_rs_tpu_torch.renderer.DynamicRenderer`), which on a card
  a CUDA graph can capture: no step reads the host.  Its other per-frame
  rebuild, kernel G's wide tree built from an LBVH on the device
  (``ops/wide_build.py``), takes scenes past this table's bound.

Morton-adjacent prims are spatially local, so 64-triangle chunks in
that order are local too, if looser than chunks of a BVH's leaf order
(PERF.md §6).  The table runs through the same hand-written
kernels as pbvh's (``packet_closest_hit_tiled`` in closest-hit,
emit-rows and any-hit modes).  ``interpret`` is not taken, as in pbvh.

The table is bounded by the JAX package's resident cap,
``MAX_VMEM_CHUNKS * TRI_CHUNK`` = 12,288 triangles: a larger scene
raises ``ValueError``, as it does there (``DynamicRenderer`` walks such
a scene instead, unless told ``backend="packet"``).  The rows table needs
:func:`~rt_rs_tpu_torch.ops.packet_trace.rows_budget_ok` at the actual
chunk height (8,192 triangles at tc = 64).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import torch

from rt_rs_tpu_torch.config import ComputeConfig
from rt_rs_tpu_torch.handlers.base import IntrsHandler, IntrsStats, tiled_as_flat
from rt_rs_tpu_torch.ops import packet_trace as pt
from rt_rs_tpu_torch.ops.lbvh import BIG, centroid_codes, morton_order
from rt_rs_tpu_torch.scene import Scene
from rt_rs_tpu_torch.scene.arrays import SceneArrays


# The chunk table's bound, the JAX package's resident cap (12,288 triangles).
TABLE_CAP = pt.MAX_VMEM_CHUNKS * pt.TRI_CHUNK


def table_chunks(p: int, tri_chunk: int) -> int:
    """The chunks of a table of ``p`` triangles, padded to CHUNK_ALIGN."""
    nc = max(1, -(-p // tri_chunk))
    return -(-nc // pt.CHUNK_ALIGN) * pt.CHUNK_ALIGN


def chunk_table_fits(p: int, tri_chunk: int) -> bool:
    """Whether ``p`` triangles fit the device table at ``tri_chunk``
    (:data:`TABLE_CAP`), as :func:`device_chunks` decides."""
    return table_chunks(p, tri_chunk) * tri_chunk <= TABLE_CAP


def device_chunks(
    pa: torch.Tensor,
    pb: torch.Tensor,
    pc: torch.Tensor,
    tri_chunk: int = pt.TUNED_TRI_CHUNK,
    shade_rows: torch.Tensor | None = None,
) -> pt.TriChunks:
    """:func:`~rt_rs_tpu_torch.ops.packet_trace.build_tri_chunks` in
    torch ops on the corners' device.

    The inputs are the reordered per-prim corners [P + 1, 3], the null
    sentinel row 0 included (and left out here, as in the host builder).
    ``shade_rows`` ([P + 1, 32], the reordered shade table) also builds
    the rows table.  The table equals the host builder's, but for the
    bounds of the chunks that hold no triangle: inverted either way,
    ±3e38 here as in the JAX package's device builder.  Nothing here
    checks the values (the host builder drops a non-finite rows table):
    callers decide before the build, so that it reads nothing back.
    Raises ``ValueError`` beyond 12,288 triangles, the JAX package's
    bound."""
    pa, pb, pc = pa[1:], pb[1:], pc[1:]
    p = pa.shape[0]
    nc = table_chunks(p, tri_chunk)
    if not chunk_table_fits(p, tri_chunk):
        raise ValueError(
            f"{p} triangles -> {nc} chunks x {tri_chunk} exceed the on-device LBVH "
            f"table's bound of {TABLE_CAP} triangles (the JAX package's resident cap); "
            "scenes beyond it render through the static 'bvh' or 'pbvh' handlers, "
            "or animated through DynamicRenderer on its default backend, which walks "
            "kernel G's tree at any size: built on the device every frame, or with "
            "refit=True built once and refit every frame"
        )
    pad = nc * tri_chunk - p

    def padz(x):
        return torch.cat([x, x.new_zeros((pad, x.shape[1]))])

    pa_, pb_, pc_ = padz(pa), padz(pb), padz(pc)
    comp = torch.cat([pa_, pb_ - pa_, pc_ - pa_], dim=1).reshape(nc, tri_chunk, 9)
    tri_min = torch.minimum(torch.minimum(pa_, pb_), pc_)
    tri_max = torch.maximum(torch.maximum(pa_, pb_), pc_)
    if pad:
        real = (torch.arange(nc * tri_chunk, device=pa.device) < p)[:, None]
        big = pt._f32(BIG, pa.device)
        tri_min = torch.where(real, tri_min, big)
        tri_max = torch.where(real, tri_max, -big)
    bmin = tri_min.reshape(nc, tri_chunk, 3).amin(dim=1)
    bmax = tri_max.reshape(nc, tri_chunk, 3).amax(dim=1)
    attr = None
    if shade_rows is not None:
        attr = torch.cat([shade_rows.new_zeros((1, 32)), padz(shade_rows[1:])])
    return pt.TriChunks(comp=comp, bmin=bmin, bmax=bmax, num_chunks=nc, attr=attr)


def chunk_footprint(accel: pt.TriChunks) -> int:
    """The chunk table's device bytes (components, bounds and the rows
    table if any): the ``IntrsStats`` size of the ``lbvh`` handler and
    of ``DynamicRenderer``."""
    tensors = [accel.comp, accel.bmin, accel.bmax]
    if accel.attr is not None:
        tensors.append(accel.attr)
    return sum(t.numel() * t.element_size() for t in tensors)


def build_accel_device(
    arrays: SceneArrays,
    tri_chunk: int = pt.TUNED_TRI_CHUNK,
    with_attrs: bool = False,
) -> tuple[pt.TriChunks, SceneArrays]:
    """The on-device build: Morton-sort the prims, permute the scene
    tensors into that order, chunk them (``with_attrs``: with the rows
    table of the permuted shade table).  Torch ops only, none reading
    the device back: a dynamic frame runs it every step."""
    order = morton_order(centroid_codes(arrays.pa[1:], arrays.pb[1:], arrays.pc[1:]))
    perm = torch.cat([order.new_zeros(1), order + 1]).long()
    arrays = dataclasses.replace(
        arrays,
        prim_mat=arrays.prim_mat[perm],
        pa=arrays.pa[perm],
        pb=arrays.pb[perm],
        pc=arrays.pc[perm],
        na=arrays.na[perm],
        nb=arrays.nb[perm],
        nc=arrays.nc[perm],
        shade_table=arrays.shade_table[perm],
    )
    chunks = device_chunks(
        arrays.pa, arrays.pb, arrays.pc, tri_chunk=tri_chunk,
        shade_rows=arrays.shade_table if with_attrs else None,
    )
    return chunks, arrays


class LbvhIntrs(IntrsHandler):
    """Static-scene LBVH handler: the device-built chunk table (64
    triangles a chunk, with the rows table where it fits) behind the
    same tiled, rows and any-hit entries as pbvh's."""

    name = "LBVH"

    def __init__(
        self,
        tri_chunk: int | None = None,
        ray_tile: int | None = None,
        refine: str = "bounces",
    ):
        """``tri_chunk`` (None: 64) and ``ray_tile`` (None: 256) as in
        pbvh; ``refine`` is pbvh's cull policy ("off", "bounces", "all")."""
        if refine not in ("off", "bounces", "all"):
            raise ValueError(f"unknown refine mode {refine!r}")
        self.tri_chunk = pt.TUNED_TRI_CHUNK if tri_chunk is None else tri_chunk
        self.ray_tile = pt.TUNED_RAY_TILE if ray_tile is None else ray_tile
        self.refine = refine

    @property
    def block_lanes(self) -> int:
        """Rays per tile, one pixel block each."""
        return self.ray_tile

    def build(self, scene: Scene, arrays: SceneArrays):
        """The table on the scene's device.  It carries the rows table
        when that fits the budget at this chunk height and the shade
        table is finite (a host check, here at build time: NaN smooth
        normals of degenerate geometry keep a scene on the gather
        branch, as in the JAX package)."""
        tris = arrays.pa.shape[0] - 1
        with_attrs = pt.rows_budget_ok(tris, self.tri_chunk) and bool(
            torch.isfinite(arrays.shade_table).all()
        )
        return build_accel_device(arrays, tri_chunk=self.tri_chunk, with_attrs=with_attrs)

    def stats(self, accel: pt.TriChunks) -> IntrsStats:
        return IntrsStats(name="LBVH", size=chunk_footprint(accel))

    def _entry(self, accel, cfg: ComputeConfig, **mode):
        fn = partial(
            pt.packet_closest_hit_tiled, accel,
            t_min=cfg.t_min, t_max=cfg.t_max, eps=cfg.eps, **mode,
        )
        return pt.tag_refine(fn, self.refine)

    def intersect_fn(self, accel, arrays: SceneArrays, cfg: ComputeConfig):
        return tiled_as_flat(self._entry(accel, cfg), self.ray_tile)

    def intersect_tiled_fn(self, accel, arrays: SceneArrays, cfg: ComputeConfig):
        return self._entry(accel, cfg)

    def intersect_tiled_rows_fn(self, accel, arrays: SceneArrays, cfg: ComputeConfig):
        if accel.attr is None or not pt.resident_fits(accel, with_attrs=True):
            return None
        return self._entry(accel, cfg, emit_rows=True)

    def intersect_tiled_anyhit_fn(self, accel, arrays: SceneArrays, cfg: ComputeConfig):
        return self._entry(accel, cfg, any_hit=True)

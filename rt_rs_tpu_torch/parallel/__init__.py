"""Multi-device rendering: image bands x scene shards over ranks.

Counterpart of ``rt_rs_tpu/parallel/__init__.py``.  The JAX package
runs SPMD over a ``jax.sharding.Mesh`` from one process; here every
device is a rank of a ``torch.distributed`` group
(:func:`rt_rs_tpu_torch.parallel.launch.run_ranks` starts them), and a
:class:`Mesh` names each rank's place on up to two axes:

* the **ray/image axis** (``"rays"``) is the data-parallel one: each
  band of ranks renders a horizontal band of the frame (its camera
  rays are generated per band, so no ray moves between ranks), and the
  bands are gathered in band order at the end of the frame;
* the **scene axis** (``"scene"``, optional) splits the flat triangle
  chunk table evenly: each shard intersects its band's rays against its
  slice only, and each intersect call ends in ``all_reduce`` merges
  over the shard group: MIN of t, then MIN of the global prim id among
  the shards whose t equals it (the sequential first-strictly-smaller
  rule), MAX-select of the winner's kernel-emitted rows (the rows
  entry, which picks the emit branch; no frame calls it, the shading
  kernels read the winner's row from the whole shade table), SUM for
  any-hit.  The shard index is a plain int on each rank, so a shard's
  kernels compute global prim ids themselves (``pid_base``), and every
  shard keeps the whole rows table, which is indexed by global id;
* metering: each band's mean luminance, summed over the band group and
  divided by the band count (JAX's ``pmean``).

Every rank of the mesh calls the render function and gets the whole
frame and the same luminance, the view a JAX global array gives.  The
kernels are those of the single-device frame (the MT trace, refine cull
and shading kernels, and kernel G for the ``bvh`` handler's bands); only
the merges are new, so every frame equals the single-device
``Renderer``'s bit for bit.
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from rt_rs_tpu_torch.config import ComputeConfig, Resolution
from rt_rs_tpu_torch.handlers.base import IntrsHandler
from rt_rs_tpu_torch.ops import packet_trace as pt
from rt_rs_tpu_torch.ops import shade
from rt_rs_tpu_torch.parallel.launch import rank_device
from rt_rs_tpu_torch.scene.arrays import SceneArrays

RAY_AXIS = "rays"
SCENE_AXIS = "scene"
_INT32_MAX = int(np.iinfo(np.int32).max)
_LUMA = (0.2126, 0.7152, 0.0722)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place on a device mesh: the axis names and sizes,
    its coordinates on them, its device, and per axis the process group
    of the ranks that differ from it along that axis only, ordered by
    their coordinate there."""

    axis_names: tuple[str, ...]
    shape: tuple[int, ...]
    coords: tuple[int, ...]
    device: torch.device
    groups: tuple[Any, ...]

    @property
    def axis_sizes(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.shape))

    def index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        return self.coords[self.axis_names.index(axis)]

    def group(self, axis: str):
        """The process group along ``axis``."""
        return self.groups[self.axis_names.index(axis)]


def _make_mesh(names: tuple[str, ...], shape: tuple[int, ...]) -> Mesh | None:
    """The mesh over the first ``prod(shape)`` ranks of the world in
    row-major order (JAX's ``np.array(devices).reshape(shape)``) -> this
    rank's :class:`Mesh`, or None for a rank outside it.  Collective:
    every rank of the world calls it, and creates every axis group in
    the same order."""
    world = dist.get_world_size()
    n = math.prod(shape)
    if n > world:
        raise ValueError(f"need {n} devices, have {world}")
    ranks = np.arange(n).reshape(shape)
    me = dist.get_rank()
    coords = tuple(int(c) for c in np.argwhere(ranks == me)[0]) if me < n else None
    groups = []
    for axis in range(len(shape)):
        mine = None
        lines = np.moveaxis(ranks, axis, -1).reshape(-1, shape[axis])
        for line in lines:
            g = dist.new_group([int(r) for r in line])
            if me in line:
                mine = g
        groups.append(mine)
    if coords is None:
        return None
    return Mesh(names, tuple(shape), coords, rank_device(), tuple(groups))


def image_mesh(n_devices: int | None = None) -> Mesh | None:
    """A 1-D mesh over the ray/image axis: the first ``n_devices``
    ranks (default: all).  Collective over the world; None on a rank
    outside it."""
    n = dist.get_world_size() if n_devices is None else n_devices
    return _make_mesh((RAY_AXIS,), (n,))


def hybrid_mesh(n_bands: int, n_shards: int) -> Mesh | None:
    """A 2-D (image bands x scene shards) mesh: rank ``b * n_shards +
    s`` renders band ``b`` against scene shard ``s``.  Collective over
    the world; None on a rank outside it."""
    return _make_mesh((RAY_AXIS, SCENE_AXIS), (n_bands, n_shards))


def _f32_on(v, device: torch.device) -> torch.Tensor:
    """A camera vector (array or tensor) as an f32 tensor on ``device``."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(v, dtype=np.float32)).to(device)


def _all_reduce(x: torch.Tensor, op, group) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, op=op, group=group)
    return out


def _make_scene_parallel_fns(
    local: pt.TriChunks,
    cfg: ComputeConfig,
    pid_base: int,
    group,
    *,
    refine_mode: str,
    chain: bool,
    cull_block: int | None,
    want_rows: bool,
):
    """This shard's intersect entries, each followed by its cross-shard
    merge -> (closest, rows or None, any-hit), tagged with the refine
    policy.

    ``local`` is this shard's slice of the flat chunk table, with the
    whole rows table; ``pid_base`` is its first global prim id minus 1,
    so the kernels compare exclusion ids and return hit ids and rows in
    the global id space.  A slice within the resident budget takes one
    tiled call, a larger one the segmented entry over its own segments
    (their bases shifted by ``pid_base``).  The merges reproduce
    :func:`~rt_rs_tpu_torch.ops.packet_trace.packet_closest_hit_segmented_tiled`:
    min t wins, equal t keeps the smallest global prim id; any-hit ORs
    the shards' verdicts; rows come from the winning shard.  Outputs for
    invalid rays are unspecified, so they are set to a miss before any
    collective (no NaN enters a MIN)."""
    kw: dict[str, Any] = dict(t_min=cfg.t_min, t_max=cfg.t_max, eps=cfg.eps)
    if cull_block is not None:
        kw["cull_block"] = cull_block
    has_attr = local.attr is not None
    if pt.resident_fits(local, with_attrs=has_attr and want_rows):
        base = partial(pt.packet_closest_hit_tiled, local, pid_base=pid_base, **kw)
    else:
        seg = pt.split_chunks_traced(local)
        seg = pt.SegmentedTriChunks(
            segments=seg.segments, prim_base=tuple(b + pid_base for b in seg.prim_base)
        )
        base = partial(pt.packet_closest_hit_segmented_tiled, seg, chain=chain, **kw)
    miss = float(np.float32(cfg.t_max + 1.0))

    def merge_closest(t, pid, valid):
        t = torch.where(valid, t, miss)
        pid = torch.where(valid, pid, 0)
        t_g = _all_reduce(t, dist.ReduceOp.MIN, group)
        cand = torch.where((t == t_g) & (pid > 0), pid, _INT32_MAX)
        pid_w = _all_reduce(cand, dist.ReduceOp.MIN, group)
        pid_out = torch.where(pid_w == _INT32_MAX, 0, pid_w)
        return t, pid, t_g, pid_out

    def closest(payload, valid, t_cap=None, refine=False):
        t, pid = base(payload, valid, t_cap, refine=refine)
        _, _, t_g, pid_out = merge_closest(t, pid, valid)
        return t_g, pid_out

    def anyhit(payload, valid, t_cap=None, refine=False):
        b = base(payload, valid, t_cap, any_hit=True, refine=refine) & valid
        return _all_reduce(b.to(torch.int32), dist.ReduceOp.SUM, group) > 0

    def rows(payload, valid, t_cap=None, refine=False):
        t, pid, rws = base(payload, valid, t_cap, emit_rows=True, refine=refine)
        t, pid, t_g, pid_out = merge_closest(t, pid, valid)
        win = (t == t_g) & (pid == pid_out) & (pid_out > 0)
        merged = _all_reduce(
            torch.where(win[None], rws, -math.inf), dist.ReduceOp.MAX, group
        )
        return t_g, pid_out, torch.where(pid_out[None] > 0, merged, 0.0)

    with_rows = want_rows and has_attr
    return (
        pt.tag_refine(closest, refine_mode),
        pt.tag_refine(rows, refine_mode) if with_rows else None,
        pt.tag_refine(anyhit, refine_mode) if with_rows else None,
    )


def make_sharded_render(
    handler: IntrsHandler,
    accel: Any,
    arrays: SceneArrays,
    cfg: ComputeConfig,
    width: int,
    height: int,
    mesh: Mesh,
    with_metering: bool = True,
    resolution: Resolution | None = None,
    force_rows: bool | None = None,
):
    """Build this rank's render step on ``mesh`` (``accel`` and
    ``arrays`` from ``handler.build`` on ``mesh.device``).

    Returns ``fn(camera_pos, camera_at) -> (frame [H, W, 3], mean
    luminance [])``, to be called by every rank of the mesh; each gets
    the whole frame and the same luminance (0 without
    ``with_metering``).

    Per band the step takes the same branches as ``Renderer``:
    kernel-emitted rows and any-hit shadows per the handler's
    ``rows_default`` on the band's pixel count (``force_rows``
    overrides); the flat path for scenes with negative materials.
    ``resolution`` supplies the pixel-block hint (default wg = 16).

    A mesh with a ``"scene"`` axis also shards the chunk table across
    it (see the module docstring): the handler's accel must flatten to
    one chunk table (pbvh, lbvh), and the scene must have no negative
    materials.  Per shard, kernel-emitted rows when the shard's slice
    fits the resident budget with its rows, else the gather branch;
    ``force_rows`` overrides."""
    if mesh is None:
        raise ValueError("this rank is outside the mesh")
    sizes = mesh.axis_sizes
    if RAY_AXIS not in sizes:
        raise ValueError(f"mesh must carry a {RAY_AXIS!r} axis")
    n_dev = sizes[RAY_AXIS]
    n_shards = sizes.get(SCENE_AXIS, 1)
    if height % n_dev != 0:
        raise ValueError(f"image height {height} must divide over {n_dev} band devices")
    rows_per_dev = height // n_dev
    use_tiled = arrays.no_negative_materials
    ray_tile = getattr(handler, "block_lanes", 128)

    intersect = i_fn = r_fn = a_fn = None
    if n_shards > 1:
        if not use_tiled:
            raise ValueError(
                "scene-parallel rendering requires the tiled frame path "
                "(no negative materials)"
            )
        # Padded with never-hit chunks so every shard gets an equal
        # slice, each a cull_block multiple.
        cb = getattr(handler, "cull_block", None) or 1
        flat = pt.flatten_segments(accel, pad_multiple=n_shards * cb)
        nc_local = flat.num_chunks // n_shards
        tris_per_shard = nc_local * flat.tri_chunk
        if tris_per_shard * n_shards + 1 >= 1 << 24:
            raise ValueError("prim ids exceed f32 exact-integer range (2^24)")
        shard = mesh.index(SCENE_AXIS)
        c0, c1 = shard * nc_local, (shard + 1) * nc_local
        local = pt.TriChunks(
            comp=flat.comp[c0:c1], bmin=flat.bmin[c0:c1], bmax=flat.bmax[c0:c1],
            num_chunks=nc_local, attr=flat.attr,
        )
        use_rows = (
            flat.attr is not None and pt.resident_fits(local, with_attrs=True)
            if force_rows is None
            else force_rows
        )
        i_fn, r_fn, a_fn = _make_scene_parallel_fns(
            local, cfg, shard * tris_per_shard, mesh.group(SCENE_AXIS),
            refine_mode=getattr(handler, "refine", "off"),
            chain=getattr(handler, "chain", True),
            cull_block=getattr(handler, "cull_block", None),
            want_rows=use_rows,
        )
    elif use_tiled:
        i_fn = handler.intersect_tiled_fn(accel, arrays, cfg)
        use_rows = (
            handler.rows_default(accel, width * rows_per_dev)
            if force_rows is None
            else force_rows
        )
        if use_rows:
            r_fn = handler.intersect_tiled_rows_fn(accel, arrays, cfg)
            if r_fn is not None:
                a_fn = handler.intersect_tiled_anyhit_fn(accel, arrays, cfg)
    else:
        intersect = handler.intersect_fn(accel, arrays, cfg)

    blk = (resolution or Resolution()).block(ray_tile)
    row0 = mesh.index(RAY_AXIS) * rows_per_dev
    rays_group = mesh.group(RAY_AXIS)
    luma = torch.tensor(_LUMA, dtype=torch.float32, device=mesh.device)

    def band_render(pos: torch.Tensor, at: torch.Tensor) -> torch.Tensor:
        if use_tiled:
            payload, valid, n_pixels = shade.camera_ray_tiles(
                pos, at, width, height, ray_tile,
                y_offset=row0, rows=rows_per_dev, block=blk,
            )
            color = shade.trace_tiled(
                arrays, i_fn, cfg, payload, valid, pos,
                intersect_rows_fn=r_fn, intersect_anyhit_fn=a_fn,
            )
            flat_color = color.reshape(3, -1)[:, :n_pixels].T
        else:
            o, d = shade.camera_rays(
                pos, at, width, height, y_offset=row0, rows=rows_per_dev, block=blk
            )
            flat_color = shade.trace(arrays, intersect, cfg, o, d)
        return shade.unblock_colors(flat_color, width, rows_per_dev, blk).contiguous()

    def render(camera_pos, camera_at) -> tuple[torch.Tensor, torch.Tensor]:
        band = band_render(_f32_on(camera_pos, mesh.device), _f32_on(camera_at, mesh.device))
        if with_metering:
            lum = _all_reduce((band @ luma).mean(), dist.ReduceOp.SUM, rays_group) / n_dev
        else:
            lum = torch.zeros((), dtype=torch.float32, device=mesh.device)
        bands = [torch.empty_like(band) for _ in range(n_dev)]
        dist.all_gather(bands, band, group=rays_group)
        return torch.cat(bands), lum

    return render


def sharded_render_scene(
    scene,
    handler: IntrsHandler,
    cfg: ComputeConfig,
    width: int,
    height: int,
    mesh: Mesh | None = None,
):
    """Convenience: pack + build + sharded render of one frame on this
    rank (every rank of the mesh calls it)."""
    mesh = mesh or image_mesh()
    arrays = scene.pack(device=mesh.device)
    accel, arrays = handler.build(scene, arrays)
    fn = make_sharded_render(handler, accel, arrays, cfg, width, height, mesh)
    return fn(scene.camera.pos, scene.camera.at)


__all__ = [
    "RAY_AXIS", "SCENE_AXIS", "Mesh", "image_mesh", "hybrid_mesh",
    "make_sharded_render", "sharded_render_scene",
]

"""Camera rays, the XLA reference bounce loop and the tiled one.

Counterpart of ``rt_rs_tpu/ops/shade.py``, both of its frame paths:

* the flat path (``render`` -> ``camera_rays`` + ``trace``): rays as
  ``[N, 3]`` arrays, one fused closest-hit call of (K+1)·N rays per
  bounce through a handler's flat ``intersect_fn``, shading in plain
  torch.  It is the reference path of the JAX package, the one that
  renders scenes with a real ``material = -1`` prim (such a prim blocks
  camera rays and casts no shadow: the shadow test gathers
  ``prim_mat``), and the one the ``naive`` and ``blank`` handlers are
  checked against;
* the tiled pbvh path (``render_tiled`` -> ``camera_ray_tiles`` +
  ``trace_tiled``): rays as component-major ``[8, T, r]`` tiles end to
  end (ox, oy, oz, dx, dy, dz, excl, cap); each bounce is one or two
  intersect calls (see :func:`trace_tiled`) and the two shading kernels
  of :mod:`rt_rs_tpu_torch.ops.shade_tile`.

The semantics are the reference shader's bounce loop
(compute.wgsl:219-280; headlight first, then the scene lights).  Both
layouts take their primary rays from the same per-component arithmetic,
so a ray is the same bits in either.

``trace_tiled``'s emit-rows branch (resident tables, and the threaded
walks' trees, with any-hit shadows) and gather branch (segmented and
streamed tables, and resident tables too large for the rows table) are
ported, with all of its knobs: the fused bounce kernel
(``fuse_bounce``), the zero-contribution shadow cull (``shadow_cull``),
live-tile compaction (``retile``) and split tiles (``narrow``).  On
either branch the intersect calls return (t, pid) and the shading
kernels read each hit's row from the scene's shade table by its pid.
"""

from __future__ import annotations

from typing import Callable

import torch

from rt_rs_tpu_torch.config import ComputeConfig
from rt_rs_tpu_torch.ops import shade_tile
from rt_rs_tpu_torch.ops.packet_trace import TILE_GROUP, _f32
from rt_rs_tpu_torch.scene.arrays import SceneArrays

# fn(payload [8,T,r], valid [T,r], t_cap=None [T,r], **kw)
#   -> (t [T,r], pid [T,r]) / (t, pid, rows [32,T,r]) / blocked [T,r]
TiledIntersectFn = Callable[..., object]
# fn(o [N,3], d [N,3], excl [N] int32, valid [N] bool, *, t_cap=None [N])
#   -> (t [N], pid [N] int32); outputs are specified for valid rays, and
#   t_cap (shadow rays: the light distance) only narrows culling.
IntersectFn = Callable[..., tuple[torch.Tensor, torch.Tensor]]


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sum of the componentwise product along the last axis, in
    component order (x + y) + z."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


# IEEE 1 / sqrt on every device, shared with the shading twins.
_rsqrt = shade_tile._rsqrt


def _normalize(v: torch.Tensor) -> torch.Tensor:
    """v / |v| along the last axis, as ``v * rsqrt(sum(v^2))``."""
    return v * _rsqrt(_dot(v, v))[..., None]


def _reflect(e: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """WGSL ``reflect(e, n) = e - 2 * dot(e, n) * n``."""
    return e - (2.0 * _dot(e, n))[..., None] * n


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack(
        [
            a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0],
        ]
    )


def padded_block_dims(
    width: int, rows: int, block: tuple[int, int]
) -> tuple[int, int]:
    """(rows, width) padded up to multiples of the block shape."""
    bh, bw = block
    return -(-rows // bh) * bh, -(-width // bw) * bw


def _blockify(grid: torch.Tensor, block: tuple[int, int]) -> torch.Tensor:
    """Flatten a padded [Rp, Wp] grid in (block-row, block-col,
    in-block-row, in-block-col) order."""
    bh, bw = block
    rp, wp = grid.shape
    return (
        grid.reshape(rp // bh, bh, wp // bw, bw)
        .permute(0, 2, 1, 3)
        .reshape(-1)
    )


def unblock_colors(
    color: torch.Tensor,  # [Rp*Wp, 3] in block order
    width: int,
    rows: int,
    block: tuple[int, int],
) -> torch.Tensor:
    """Invert the block ordering -> [rows, width, 3] raster image."""
    bh, bw = block
    rp, wp = padded_block_dims(width, rows, block)
    img = (
        color.reshape(rp // bh, wp // bw, bh, bw, 3)
        .permute(0, 2, 1, 3, 4)
        .reshape(rp, wp, 3)
    )
    return img[:rows, :width]


def _pixel_grid(
    width: int,
    height: int,
    rows: int,
    y_offset: int,
    block: tuple[int, int] | None,
    device: torch.device,
) -> tuple[torch.Tensor, torch.Tensor, int]:
    """Normalized pixel coordinates of image rows ``y_offset ..
    y_offset + rows`` -> (norm_x [N], norm_y [N], n_pixels), in raster
    order (``block`` None) or pixel-block order.  Block padding
    duplicates clamped border pixels; ``unblock_colors`` crops them
    away."""
    f32 = torch.float32
    xs = torch.arange(width, dtype=f32, device=device) / _f32(width, device) - 0.5
    ys = torch.arange(rows, dtype=f32, device=device)
    if y_offset:
        ys = ys + _f32(y_offset, device)
    ys = ys / _f32(height, device) - 0.5
    if block is None:
        # expand, not repeat_interleave: its size is known without a
        # device read, so the frame stays capturable in a CUDA graph
        return xs.repeat(rows), ys[:, None].expand(rows, width).reshape(-1), rows * width
    rp, wp = padded_block_dims(width, rows, block)
    xi = torch.clamp(torch.arange(wp, device=device), max=width - 1)
    yi = torch.clamp(torch.arange(rp, device=device), max=rows - 1)
    norm_x = _blockify(xs[xi][None, :].expand(rp, wp), block)
    norm_y = _blockify(ys[yi][:, None].expand(rp, wp), block)
    return norm_x, norm_y, rp * wp


def _primary_dirs(
    camera_pos: torch.Tensor, camera_at: torch.Tensor, norm_x, norm_y
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Unit primary-ray directions (pinhole, up = +Y,
    compute.wgsl:103-118) per component, on [N]-shaped pixel
    coordinates: ``pt - pos``, then ``v * rsqrt(sum v^2)``.  Both ray
    layouts take their rays from here, so a ray is the same bits in
    either."""
    dev = camera_pos.device
    dir_ = _normalize((camera_at - camera_pos)[None, :])[0]
    up = torch.eye(3, dtype=torch.float32, device=dev)[1]  # (0, 1, 0), made on the device
    right = _cross(dir_, up)
    px = right[0] * norm_x + up[0] * norm_y + camera_pos[0] + dir_[0]
    py = right[1] * norm_x + up[1] * norm_y + camera_pos[1] + dir_[1]
    pz = right[2] * norm_x + up[2] * norm_y + camera_pos[2] + dir_[2]
    vx = px - camera_pos[0]
    vy = py - camera_pos[1]
    vz = pz - camera_pos[2]
    rinv = _rsqrt(vx * vx + vy * vy + vz * vz)
    return vx * rinv, vy * rinv, vz * rinv


def camera_rays(
    camera_pos: torch.Tensor,  # [3]
    camera_at: torch.Tensor,  # [3]
    width: int,
    height: int,
    y_offset: int = 0,
    rows: int | None = None,
    block: tuple[int, int] | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Primary rays for every pixel -> (origins [R*W, 3], dirs [R*W, 3]),
    ray ``y * width + x`` for pixel (x, y) in raster order
    (compute.wgsl:284-293), or in pixel-block order with ``block=(bh,
    bw)`` (undo with :func:`unblock_colors`; edges padded with clamped
    rays).  ``y_offset`` / ``rows`` select a horizontal band of the
    image; the defaults cover the full frame."""
    if rows is None:
        rows = height
    norm_x, norm_y, _ = _pixel_grid(
        width, height, rows, y_offset, block, camera_pos.device
    )
    d = torch.stack(_primary_dirs(camera_pos, camera_at, norm_x, norm_y), dim=1)
    return camera_pos[None, :].expand(d.shape), d


def camera_ray_tiles(
    camera_pos: torch.Tensor,  # [3]
    camera_at: torch.Tensor,  # [3]
    width: int,
    height: int,
    ray_tile: int,
    y_offset: int = 0,
    rows: int | None = None,
    block: tuple[int, int] | None = None,
) -> tuple[torch.Tensor, torch.Tensor, int]:
    """Primary rays (:func:`camera_rays`' rays, bit for bit) as
    component-major tiles -> (payload [8, T, r], valid [T, r],
    n_pixels), ``T`` padded to a multiple of TILE_GROUP.  ``y_offset`` /
    ``rows`` select a horizontal band of the image, as in
    :func:`camera_rays`; the defaults cover the full frame."""
    if rows is None:
        rows = height
    dev = camera_pos.device
    norm_x, norm_y, n_pixels = _pixel_grid(width, height, rows, y_offset, block, dev)
    t_tiles = -(-n_pixels // ray_tile)
    t_tiles = -(-t_tiles // TILE_GROUP) * TILE_GROUP
    n_pad = t_tiles * ray_tile
    norm_x = torch.nn.functional.pad(norm_x, (0, n_pad - n_pixels))
    norm_y = torch.nn.functional.pad(norm_y, (0, n_pad - n_pixels))
    dx, dy, dz = _primary_dirs(camera_pos, camera_at, norm_x, norm_y)
    shape = (t_tiles, ray_tile)
    zeros = torch.zeros(shape, dtype=torch.float32, device=dev)
    payload = torch.stack(
        [
            camera_pos[0].expand(shape),
            camera_pos[1].expand(shape),
            camera_pos[2].expand(shape),
            dx.reshape(shape),
            dy.reshape(shape),
            dz.reshape(shape),
            zeros,  # excl
            zeros,
        ]
    )
    valid = (torch.arange(n_pad, device=dev) < n_pixels).reshape(shape)
    return payload, valid, n_pixels


# ----------------------------------------------------------------------
# The flat path: [N, 3] rays, shading in plain torch.


def hit_surface(
    scene: SceneArrays,
    prim_id: torch.Tensor,  # [N]
    o: torch.Tensor,  # [N, 3]
    d: torch.Tensor,  # [N, 3]
    t: torch.Tensor,  # [N]
) -> tuple[torch.Tensor, torch.Tensor]:
    """Reference ``hit()`` -> (at [N, 3], unit normal [N, 3]), with the
    corner rotation of compute.wgsl:122-126, from one shade-table row
    gather."""
    return _hit_from_rows(scene.shade_table[prim_id.to(torch.int64)], o, d, t)


def _hit_from_rows(
    row: torch.Tensor,  # [N, 32] gathered shade-table rows
    o: torch.Tensor,
    d: torch.Tensor,
    t: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`hit_surface` on gathered rows (the table's column order
    holds the rotation: b = cols 0-2, c = 3-5, a = 6-8)."""
    at = o + d * t[:, None]
    b, c, a = row[:, 0:3], row[:, 3:6], row[:, 6:9]
    v0 = b - a
    v1 = c - a
    v2 = at - a
    d00 = _dot(v0, v0)
    d01 = _dot(v0, v1)
    d11 = _dot(v1, v1)
    d20 = _dot(v2, v0)
    d21 = _dot(v2, v1)
    denom = d00 * d11 - d01 * d01
    denom = torch.where(denom == 0.0, torch.ones_like(denom), denom)
    v = (d11 * d20 - d01 * d21) / denom
    w = (d00 * d21 - d01 * d20) / denom
    u = 1.0 - v - w
    normal = (
        row[:, 9:12] * v[:, None]
        + row[:, 12:15] * w[:, None]
        + row[:, 15:18] * u[:, None]
    )
    return at, _normalize(normal)


def _light_terms(
    light_pos: torch.Tensor,  # [N, 3] (already broadcast per ray)
    strength: torch.Tensor,  # [N]
    at: torch.Tensor,  # [N, 3]
    normal: torch.Tensor,  # [N, 3]
    ray_dir: torch.Tensor,  # [N, 3] current ray direction
    spec_pow: torch.Tensor,  # [N]
) -> tuple[torch.Tensor, torch.Tensor]:
    """(diffuse, spec) intensities (compute.wgsl:160-175)."""
    light_dir = _normalize(light_pos - at)
    diffuse = strength * torch.clamp(_dot(light_dir, normal), min=0.0)
    refl = _reflect(-light_dir, normal)
    spec = _dot(-refl, ray_dir)
    spec = torch.pow(torch.clamp(spec, min=0.0), spec_pow) * strength
    return diffuse, spec


def compacting(intersect_fn: IntersectFn) -> IntersectFn:
    """``intersect_fn`` with the live rays packed first: a stable
    partition by validity (neighbouring live rays stay neighbours), the
    call on the packed batch, the results scattered back.  Off by
    default (``trace(compact=False)``), as in the JAX package, which
    measured the sort costing more than the coherence it buys."""

    def wrapped(o, d, excl, valid, t_cap=None):
        order = torch.argsort((~valid).to(torch.int8), stable=True)
        inv = _invert_perm(order)
        t, pid = intersect_fn(
            o[order], d[order], excl[order], valid[order],
            t_cap=None if t_cap is None else t_cap[order],
        )
        return t[inv], pid[inv]

    return wrapped


def render(
    scene: SceneArrays,
    intersect_fn: IntersectFn,
    cfg: ComputeConfig,
    camera_pos: torch.Tensor,  # [3]
    camera_at: torch.Tensor,  # [3]
    width: int,
    height: int,
    compact: bool = False,
    block: tuple[int, int] | None = None,
) -> torch.Tensor:
    """Full frame through the flat path -> color [H, W, 3] float32
    (unclamped, the rgba8unorm store input of compute.wgsl:291).
    ``block`` traces rays in pixel-block order; the image is the same
    either way."""
    o, d = camera_rays(camera_pos, camera_at, width, height, block=block)
    color = trace(scene, intersect_fn, cfg, o, d, compact=compact)
    if block is not None:
        return unblock_colors(color, width, height, block)
    return color.reshape(height, width, 3)


def trace(
    scene: SceneArrays,
    intersect_fn: IntersectFn,
    cfg: ComputeConfig,
    o: torch.Tensor,  # [N, 3]
    d: torch.Tensor,  # [N, 3]
    compact: bool = False,
) -> torch.Tensor:
    """The ``lighting`` bounce loop (compute.wgsl:219-280) over a flat
    ray batch -> color [N, 3].

    Wavefront order: a bounce's shadow rays (all lights, light-major)
    and the next bounce's reflection rays depend only on the current
    hit, so they go to ``intersect_fn`` in one call of (K+1)·N rays.
    A shadow hit counts only if its prim is real: ``pid != 0`` when the
    scene has no negative materials, else a ``prim_mat`` gather (a
    ``material = -1`` prim passes light).  ``compact`` packs live rays
    before every secondary call (:func:`compacting`)."""
    n = o.shape[0]
    dev = o.device
    secondary_fn = compacting(intersect_fn) if compact else intersect_fn
    color = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    active = torch.ones((n,), dtype=torch.bool, device=dev)
    camera_origin = o  # headlight position (compute.wgsl:237)
    ray_o, ray_d = o, d
    zero_excl = torch.zeros((n,), dtype=torch.int32, device=dev)

    t, prim_id = intersect_fn(ray_o, ray_d, zero_excl, active)
    for bounce in range(cfg.bounces):
        prim_id = torch.where(active, prim_id, 0)
        # One [N, 32] row gather gives corners, normals and material.
        row = scene.shade_table[prim_id.to(torch.int64)]
        active = active & (row[:, 25] != -1.0) & (t < cfg.t_max) & (t > cfg.t_min)
        mat_color = row[:, 18:21]
        mat_albedo = row[:, 21:24]
        mat_spec = row[:, 24]
        at, normal = _hit_from_rows(row, ray_o, ray_d, t)
        cur_d = ray_d

        # The lights: the headlight first, then the scene's.
        light_positions, light_strengths = [], []
        if cfg.camera_light_source > 0.0:
            light_positions.append(camera_origin)
            light_strengths.append(
                torch.full((n,), cfg.camera_light_source, dtype=torch.float32, device=dev)
            )
        for j in range(scene.num_lights):
            light_positions.append(scene.light_pos[j][None, :].expand(n, 3))
            light_strengths.append(scene.light_strength[j].expand(n))
        k = len(light_positions)

        if k:  # shadow rays (compute.wgsl:189-212)
            lp = torch.stack(light_positions)  # [K, N, 3]
            ls = torch.stack(light_strengths)  # [K, N]
            delta = lp - at[None]
            light_dist = torch.sqrt(_dot(delta, delta))  # [K, N]
            light_dir = _normalize(delta)
            side = _dot(light_dir, normal[None])
            s_off = torch.where(side[..., None] < 0.0, -0.001, 0.001) * normal[None]
            shadow_o = (at[None] + s_off).reshape(k * n, 3)
            shadow_d = light_dir.reshape(k * n, 3)
            shadow_excl = prim_id[None].expand(k, n).reshape(k * n)
            shadow_valid = active[None].expand(k, n).reshape(k * n)
            shadow_cap = light_dist.reshape(k * n)

        last = bounce + 1 >= cfg.bounces
        if not last:  # mirror continuation (compute.wgsl:267-276)
            refl_dir = _normalize(_reflect(cur_d, normal))
            r_side = _dot(refl_dir, normal)
            next_o = at + torch.where(r_side[:, None] < 0.0, -0.001, 0.001) * normal
            next_d = refl_dir

        if k and not last:
            st, sid = secondary_fn(
                torch.cat([shadow_o, next_o]),
                torch.cat([shadow_d, next_d]),
                torch.cat([shadow_excl, zero_excl]),
                torch.cat([shadow_valid, active]),
                t_cap=torch.cat(
                    [shadow_cap, torch.full((n,), cfg.t_max, dtype=torch.float32, device=dev)]
                ),
            )
            sh_t, sh_id = st[: k * n], sid[: k * n]
            t, prim_id = st[k * n :], sid[k * n :]
            ray_o, ray_d = next_o, next_d
        elif k:
            sh_t, sh_id = secondary_fn(
                shadow_o, shadow_d, shadow_excl, shadow_valid, t_cap=shadow_cap
            )
        elif not last:
            t, prim_id = secondary_fn(next_o, next_d, zero_excl, active)
            ray_o, ray_d = next_o, next_d

        diffuse = torch.zeros((n,), dtype=torch.float32, device=dev)
        spec = torch.zeros((n,), dtype=torch.float32, device=dev)
        if k:
            if scene.no_negative_materials:
                real = sh_id != 0
            else:
                real = scene.prim_mat[sh_id.to(torch.int64)] != -1
            sh_valid = real & (sh_t < cfg.t_max) & (sh_t > cfg.t_min)
            # |shadow_hit.at - origin| == t (compute.wgsl:206).
            shadowed = sh_valid.reshape(k, n) & (sh_t.reshape(k, n) < light_dist)
            for ki in range(k):
                diff_k, spec_k = _light_terms(lp[ki], ls[ki], at, normal, cur_d, mat_spec)
                lit = ~shadowed[ki] & (ls[ki] > 0.0)
                diffuse = diffuse + torch.where(lit, diff_k, 0.0)
                spec = spec + torch.where(lit, spec_k, 0.0)

        contrib = (
            mat_color * (diffuse * mat_albedo[:, 0])[:, None]
            + (spec * mat_albedo[:, 1])[:, None]
        )
        if bounce:
            contrib = contrib * mat_albedo[:, 2][:, None]
        color = color + torch.where(active[:, None], contrib, 0.0)
    return color


def _invert_perm(perm: torch.Tensor) -> torch.Tensor:
    """Inverse of a permutation [T] via one scatter."""
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.numel(), dtype=perm.dtype, device=perm.device)
    return inv


def _narrowed(fn: TiledIntersectFn | None, r: int, narrow: int | None):
    """``fn`` on laneways-split tiles (``narrow``): inputs [.., T', r]
    become [.., T' * m, narrow] (tile t -> m consecutive sub-tiles; ray
    order unchanged) and outputs reshape back.  Only the per-tile culls
    see the narrower tiles, so the results are the same."""
    if fn is None or narrow is None or r <= narrow:
        return fn
    if r % narrow:
        raise ValueError(f"narrow={narrow} must divide ray_tile={r}")
    m = r // narrow

    def split(x):
        if x is None:
            return None
        if x.dim() == 2:
            return x.reshape(x.shape[0] * m, narrow)
        return x.reshape(x.shape[0], x.shape[1] * m, narrow)

    def unsplit(x):
        if x.dim() == 2:
            return x.reshape(x.shape[0] // m, r)
        return x.reshape(x.shape[0], x.shape[1] // m, r)

    def fn2(payload, valid, t_cap=None, **kw):
        out = fn(split(payload), split(valid), t_cap=split(t_cap), **kw)
        if isinstance(out, tuple):
            return tuple(unsplit(o) for o in out)
        return unsplit(out)

    fn2.supports_refine = getattr(fn, "supports_refine", False)
    return fn2


def trace_tiled(
    scene: SceneArrays,
    intersect_fn: TiledIntersectFn,
    cfg: ComputeConfig,
    payload: torch.Tensor,  # [8, T, r] primary rays
    valid: torch.Tensor,  # [T, r]
    camera_pos: torch.Tensor,  # [3] (headlight position)
    intersect_rows_fn: TiledIntersectFn | None = None,
    intersect_anyhit_fn: TiledIntersectFn | None = None,
    fuse_bounce: bool = False,
    shadow_cull: bool = True,
    retile: bool = False,
    narrow: int | None = None,
) -> torch.Tensor:
    """The bounce loop over component-major ray tiles -> color [3, T, r].

    With ``intersect_rows_fn`` offered (the emit branch, the JAX
    package's kernel-emitted rows) each bounce makes its own
    closest-hit call, and the shadow rays of all lights go in one batch
    to ``intersect_anyhit_fn`` (the occlusion bound rides payload row
    7), or to ``intersect_fn`` in closest-hit mode when there is no
    any-hit entry.  Without it (the gather branch) each bounce makes one
    closest-hit call over the light-major shadow rays with the next
    bounce's rays appended (caps ``t_max``).  On both branches every
    closest-hit call is ``intersect_fn``'s, returning (t, pid) only: the
    shading kernels read each hit's row from the scene's resident shade
    table at ``table[pid]``, so no call emits or gathers a [32, T, r]
    plane of rows, and ``intersect_rows_fn`` itself is never called.
    Bounce and shadow batches opt into the per-ray cull when the entry
    advertises ``supports_refine``.

    The knobs are the JAX package's; each is output-exact (the frame is
    the default frame bit for bit), and all default off:

    * ``fuse_bounce``: shade_post of bounce b and shade_pre of bounce
      b + 1 run as one kernel (``shade_tile.shade_bounce``); bounce 0's
      shade_pre and the last bounce's shade_post stay standalone.
    * ``shadow_cull`` (default on): shadow rays whose light cannot
      change the colour whatever the verdict (shade_pre's mask) are
      dropped from the batch.
    * ``retile``: after each bounce's liveness update, whole tiles are
      permuted so tiles with a live ray come first (a stable argsort);
      tile membership is unchanged, so every cull is too, and each
      bounce's colour is gathered back through the composed permutation.
      Incompatible with ``fuse_bounce`` (the fused kernel spans the
      permutation).
    * ``narrow`` (a lane count dividing the tile, e.g. 128): bounce and
      shadow calls run on tiles split into ``r / narrow`` sub-tiles
      (primaries never)."""
    if retile and fuse_bounce:
        raise ValueError(
            "retile is incompatible with fuse_bounce (the fused kernel "
            "spans the compaction point)"
        )
    if not scene.no_negative_materials:
        # The shading kernels test validity as pid != 0, which would
        # treat negative-material prims as occluders.
        raise ValueError(
            "trace_tiled requires scene.no_negative_materials; use the "
            "flat trace() path for scenes with negative materials"
        )
    dev = payload.device
    t_tiles, r = valid.shape
    light_rows = []
    if cfg.camera_light_source > 0.0:
        light_rows.append(
            torch.cat(
                [
                    camera_pos.to(torch.float32),
                    _f32(cfg.camera_light_source, dev)[None],
                ]
            )
        )
    for j in range(scene.num_lights):
        light_rows.append(
            torch.cat([scene.light_pos[j], scene.light_strength[j : j + 1]])
        )
    k = len(light_rows)
    color = torch.zeros((3, t_tiles, r), dtype=torch.float32, device=dev)
    if k == 0:
        # No light sources: every bounce contributes zero.
        return color
    lights = torch.stack(light_rows).contiguous()  # [k, 4]
    sub = shade_tile.SUBGROUP
    emit = intersect_rows_fn is not None
    table = scene.shade_table.contiguous()
    # Bounce and shadow calls may run on split tiles; primaries never.
    n_intersect_fn = _narrowed(intersect_fn, r, narrow)
    n_anyhit_fn = _narrowed(intersect_anyhit_fn, r, narrow)

    def refine_kw(fn):
        # Secondary and shadow batches take the per-ray cull (their
        # rays diverge within a tile); primaries keep the interval cull.
        return {"refine": True} if getattr(fn, "supports_refine", False) else {}

    def liveness(t, pid, active, pay, o2c):
        """Validity update and the ``retile`` permutation.  A dead ray's
        pid becomes 0, so the shading kernels read row 0 for it: every
        consumer masks dead rays."""
        pid = torch.where(active, pid, 0)
        valid_b = (pid != 0) & (t < cfg.t_max) & (t > cfg.t_min)
        active = active & valid_b
        if retile:
            perm = torch.argsort((~active.any(dim=1)).to(torch.int32), stable=True)
            inv = _invert_perm(perm)
            o2c = inv if o2c is None else inv[o2c]
            t, pid, active, pay = t[perm], pid[perm], active[perm], pay[:, perm]
        live_sg = active.reshape(t_tiles // sub, sub * r).any(dim=1).to(torch.int32)
        return t.contiguous(), pid.contiguous(), active, live_sg, pay, o2c

    def add_color(color, contrib, o2c):
        """A bounce's contribution, in its own tile order, added to the
        image in the original order (a retiled bounce's tile j of the
        original order sits at o2c[j])."""
        return color + (contrib if o2c is None else contrib[:, o2c])

    def shadow_valid(active, cmasks):
        """Per-light shadow-ray validity [k * T, r]: live and, with
        ``shadow_cull``, the light can contribute."""
        sh = active[None].expand(k, t_tiles, r)
        if shadow_cull:
            sh = sh & (cmasks > 0.0)
        return sh.reshape(k * t_tiles, r)

    t, pid = intersect_fn(payload, valid)
    t, pid, active, live_sg, payload, o2c = liveness(t, pid, valid, payload, None)
    sh_pay, caps, cmasks, nxt = shade_tile.shade_pre(
        table, pid, payload, t, live_sg, lights, emit_next=cfg.bounces > 1
    )

    for bounce in range(cfg.bounces):
        last = bounce + 1 >= cfg.bounces
        sh_valid = shadow_valid(active, cmasks)
        sh_caps = caps.reshape(k * t_tiles, r)
        blocked_mode = emit and intersect_anyhit_fn is not None
        if blocked_mode:
            blocked = n_anyhit_fn(
                sh_pay, sh_valid, t_cap=sh_caps, **refine_kw(n_anyhit_fn)
            )
            sh_t = sh_id = blocked.reshape(k, t_tiles, r).to(torch.float32)
        elif emit:
            st, sid = n_intersect_fn(
                sh_pay, sh_valid, t_cap=sh_caps, **refine_kw(n_intersect_fn)
            )
            sh_t, sh_id = st.reshape(k, t_tiles, r), sid.reshape(k, t_tiles, r)
        else:
            # One call: light-major shadow rays, then the next bounce's.
            if not last:
                sh_pay = torch.cat([sh_pay, nxt], dim=1)
                sh_valid = torch.cat([sh_valid, active])
                sh_caps = torch.cat([sh_caps, torch.full_like(t, cfg.t_max)])
            st, sid = n_intersect_fn(
                sh_pay, sh_valid, t_cap=sh_caps, **refine_kw(n_intersect_fn)
            )
            n_sh = k * t_tiles
            sh_t = st[:n_sh].reshape(k, t_tiles, r)
            sh_id = sid[:n_sh].reshape(k, t_tiles, r)
            if not last:
                t2, pid2 = st[n_sh:], sid[n_sh:]
        if emit and not last:
            t2, pid2 = n_intersect_fn(nxt, active, **refine_kw(n_intersect_fn))
        post = (
            table, pid, payload, t, active.to(torch.float32), sh_t.contiguous(),
            sh_id.to(torch.float32).contiguous(), caps,
        )
        post_kw = dict(
            first_bounce=bounce == 0, t_min=cfg.t_min, t_max=cfg.t_max,
            blocked_mode=blocked_mode, bounce=bounce,
        )
        if last:
            color = add_color(
                color, shade_tile.shade_post(*post, live_sg, lights, **post_kw), o2c
            )
            break
        # liveness may retile the next bounce's state; this bounce's
        # shade_post still runs in the current order (o2c), the new
        # order (o2c2) takes over after it.
        t2, pid2, active2, live_sg2, nxt, o2c2 = liveness(t2, pid2, active, nxt, o2c)
        emit_next = bounce + 2 < cfg.bounces
        if fuse_bounce:
            contrib, sh_pay, caps, cmasks, nxt2 = shade_tile.shade_bounce(
                *post, pid2, nxt, t2, torch.stack([live_sg, live_sg2]), lights,
                emit_next=emit_next, **post_kw,
            )
            color = color + contrib
        else:
            color = add_color(
                color, shade_tile.shade_post(*post, live_sg, lights, **post_kw), o2c
            )
            sh_pay, caps, cmasks, nxt2 = shade_tile.shade_pre(
                table, pid2, nxt, t2, live_sg2, lights, emit_next=emit_next
            )
        payload, t, pid = nxt, t2, pid2
        active, live_sg, nxt, o2c = active2, live_sg2, nxt2, o2c2

    return color


def render_tiled(
    scene: SceneArrays,
    intersect_fn: TiledIntersectFn,
    cfg: ComputeConfig,
    camera_pos: torch.Tensor,
    camera_at: torch.Tensor,
    width: int,
    height: int,
    ray_tile: int,
    block: tuple[int, int] | None = None,
    intersect_rows_fn: TiledIntersectFn | None = None,
    intersect_anyhit_fn: TiledIntersectFn | None = None,
    fuse_bounce: bool = False,
    shadow_cull: bool = True,
    retile: bool = False,
    narrow: int | None = None,
) -> torch.Tensor:
    """Full frame via the tiled path -> color [H, W, 3] float32.  The
    knobs are :func:`trace_tiled`'s."""
    payload, valid, n_pixels = camera_ray_tiles(
        camera_pos, camera_at, width, height, ray_tile, block=block
    )
    color = trace_tiled(
        scene, intersect_fn, cfg, payload, valid, camera_pos,
        intersect_rows_fn=intersect_rows_fn,
        intersect_anyhit_fn=intersect_anyhit_fn,
        fuse_bounce=fuse_bounce, shadow_cull=shadow_cull, retile=retile,
        narrow=narrow,
    )
    flat = color.reshape(3, -1)[:, :n_pixels].T  # [n_pixels, 3]
    if block is not None:
        return unblock_colors(flat, width, height, block)
    return flat.reshape(height, width, 3)

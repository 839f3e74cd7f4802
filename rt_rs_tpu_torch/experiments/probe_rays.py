"""The closest-hit probes' shared prelude: flat rays into ray-major tiles,
the tile-interval cull and the compacted chunk lists.

Both probes of the JAX package (``mxu_mt.py:131-173``,
``tpose_table.py:137-173``) pad the rays into TILE_GROUP-aligned tiles,
cull each tile against the chunk bounds with the interval cull, compact
each tile's list with a stable argsort and hand the kernel tile-major
rays ``[T, 8, r]`` (ox, oy, oz, dx, dy, dz, excl, 0).
"""

from __future__ import annotations

import dataclasses

import torch

from rt_rs_tpu_torch.ops import packet_trace as pt


@dataclasses.dataclass(frozen=True)
class ProbeRays:
    rays: torch.Tensor  # [T, 8, r] f32 tile-major
    ids: torch.Tensor  # [T, Nc] int32: listed chunks first, ascending
    counts: torch.Tensor  # [T] int32
    n: int  # rays before padding


def probe_rays(
    o: torch.Tensor,  # [N, 3]
    d: torch.Tensor,  # [N, 3]
    excl: torch.Tensor,  # [N] int
    valid: torch.Tensor | None,  # [N] bool
    t_cap: torch.Tensor | None,  # [N]
    bmin: torch.Tensor,  # [Nc, 3]
    bmax: torch.Tensor,
    *,
    t_min: float,
    t_max: float,
    ray_tile: int,
) -> ProbeRays:
    n = o.shape[0]
    t_tiles, tiles = pt.ray_tiler(n, ray_tile)
    if valid is None:
        valid = torch.ones((n,), dtype=torch.bool, device=o.device)
    o_p, d_p = tiles(o), tiles(d)
    overlap = pt.chunk_overlap_mask(
        o_p, 1.0 / d_p, tiles(valid), bmin, bmax,
        t_min=t_min, t_max=t_max, t_cap=None if t_cap is None else tiles(t_cap),
    )
    ids, counts = pt.compact(overlap)
    rays = torch.cat(
        [
            o_p.transpose(1, 2),
            d_p.transpose(1, 2),
            tiles(excl)[:, None, :].to(torch.float32),
            o.new_zeros((t_tiles, 1, ray_tile)),
        ],
        dim=1,
    ).contiguous()
    return ProbeRays(rays=rays, ids=ids, counts=counts, n=n)

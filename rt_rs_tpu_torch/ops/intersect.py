"""Ray-triangle and ray-AABB intersection over ray batches.

Counterpart of ``rt_rs_tpu/ops/intersect.py``, which is XLA code (no
Pallas kernel), so plain torch is its port:

* Möller–Trumbore with the two-sided determinant branches and the
  ``eps`` dead zone (``src/lib/handlers/basic.rs:43-79``);
* the intended slab test with the reference's ``EPS = 2e-6`` bound
  wobble (``src/lib/handlers/bvh.rs:248-268``);
* a miss is encoded as in ``intrs_empty`` (compute.wgsl:185-187):
  ``t = t_max + 1`` and prim id 0 (the null sentinel).

Everything is batched: rays ``[N, 3]`` against triangle chunks
``[C, 3]`` give ``[N, C]`` lattices, with validity as masks.
"""

from __future__ import annotations

import torch

# Reference slab-test wobble (handlers/bvh.rs:246).
SLAB_EPS = 0.000002
# Lattice elements per brute-force step: rays are taken in slices of
# BUDGET // chunk, so a [slice, chunk] lattice stays bounded.
BUDGET = {"cpu": 2**20, "cuda": 2**24}


def _dot(ax, ay, az, bx, by, bz):
    return ax * bx + ay * by + az * bz


def _cross(ax, ay, az, bx, by, bz):
    return ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx


def _two_sided(det, u, v, *, eps: float):
    """The sign-branched barycentric test of basic.rs:43-79."""
    pos = det > eps
    neg = det < -eps
    return (pos & (u >= 0.0) & (u <= det) & (v >= 0.0) & (u + v <= det)) | (
        neg & (u <= 0.0) & (u >= det) & (v <= 0.0) & (u + v >= det)
    )


def tri_intersect(
    o: torch.Tensor,  # [N, 3] ray origins
    d: torch.Tensor,  # [N, 3] ray directions
    pa: torch.Tensor,  # [C, 3] triangle corner a
    pb: torch.Tensor,  # [C, 3] corner b
    pc: torch.Tensor,  # [C, 3] corner c
    *,
    t_min: float,
    t_max: float,
    eps: float,
) -> torch.Tensor:
    """All-pairs Möller–Trumbore -> t [N, C], misses ``t_max + 1``
    (two-sided, non-strict u / v bounds in each determinant branch, the
    w window non-strict)."""
    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]  # [N, 1]
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    ax, ay, az = pa[:, 0][None, :], pa[:, 1][None, :], pa[:, 2][None, :]  # [1, C]
    e1x = pb[:, 0][None, :] - ax
    e1y = pb[:, 1][None, :] - ay
    e1z = pb[:, 2][None, :] - az
    e2x = pc[:, 0][None, :] - ax
    e2y = pc[:, 1][None, :] - ay
    e2z = pc[:, 2][None, :] - az

    px, py, pz = _cross(dx, dy, dz, e2x, e2y, e2z)  # p = cross(dir, e2)
    tx, ty, tz = ox - ax, oy - ay, oz - az  # t = origin - a
    qx, qy, qz = _cross(tx, ty, tz, e1x, e1y, e1z)  # q = cross(t, e1)
    det = _dot(e1x, e1y, e1z, px, py, pz)
    u = _dot(tx, ty, tz, px, py, pz)
    v = _dot(dx, dy, dz, qx, qy, qz)
    ok = _two_sided(det, u, v, eps=eps)
    w = _dot(e2x, e2y, e2z, qx, qy, qz) / torch.where(ok, det, torch.ones_like(det))
    ok = ok & (w <= t_max) & (w >= t_min)
    return torch.where(ok, w, t_max + 1.0)


def tri_intersect_pairs(
    o: torch.Tensor,  # [N, 3]
    d: torch.Tensor,  # [N, 3]
    pa: torch.Tensor,  # [N, 3] per-ray triangle corners
    pb: torch.Tensor,
    pc: torch.Tensor,
    *,
    t_min: float,
    t_max: float,
    eps: float,
) -> torch.Tensor:
    """Elementwise Möller–Trumbore: ray i against triangle i -> t [N],
    with :func:`tri_intersect`'s semantics."""
    return tri_intersect_edges(o, d, pa, pb - pa, pc - pa, t_min=t_min, t_max=t_max, eps=eps)


def tri_intersect_edges(
    o: torch.Tensor,  # [N, 3]
    d: torch.Tensor,  # [N, 3]
    a: torch.Tensor,  # [N, 3] corner a
    e1: torch.Tensor,  # [N, 3] b - a
    e2: torch.Tensor,  # [N, 3] c - a
    *,
    t_min: float,
    t_max: float,
    eps: float,
) -> torch.Tensor:
    """:func:`tri_intersect_pairs` from the triangles' edges."""
    c = lambda x: (x[:, 0], x[:, 1], x[:, 2])  # noqa: E731
    p = _cross(*c(d), *c(e2))
    tvec = c(o - a)
    q = _cross(*tvec, *c(e1))
    det = _dot(*c(e1), *p)
    u = _dot(*tvec, *p)
    v = _dot(*c(d), *q)
    ok = _two_sided(det, u, v, eps=eps)
    w = _dot(*c(e2), *q) / torch.where(ok, det, torch.ones_like(det))
    ok = ok & (w <= t_max) & (w >= t_min)
    return torch.where(ok, w, t_max + 1.0)


def closest_hit_bruteforce(
    o: torch.Tensor,  # [N, 3]
    d: torch.Tensor,  # [N, 3]
    pa: torch.Tensor,  # [P, 3] (row 0 = null sentinel)
    pb: torch.Tensor,
    pc: torch.Tensor,
    excl: torch.Tensor,  # [N] int32 prim id to exclude (0 = none)
    *,
    t_min: float,
    t_max: float,
    eps: float,
    chunk: int = 128,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Closest hit over every prim (``BasicIntrs``, basic.rs:81-106) ->
    (t [N], prim_id [N] int32) with the miss encoding.

    Prims are scanned in chunks of ``chunk`` (zero-padded: a degenerate
    triangle never hits); prim 0 (the null sentinel), the pad and each
    ray's ``excl`` prim are skipped.  A chunk's best (the first minimum)
    replaces the running best only when strictly nearer, in the open
    (t_min, t_max) window (basic.rs:95-101).  Rays go in slices, so the
    [slice, chunk] lattice stays within ``BUDGET``."""
    n, p = o.shape[0], pa.shape[0]
    pad = -(-p // chunk) * chunk - p

    def pad3(a):
        return torch.cat([a, a.new_zeros((pad, 3))])

    pa_, pb_, pc_ = pad3(pa), pad3(pb), pad3(pc)
    miss = torch.full((), t_max + 1.0, dtype=torch.float32, device=o.device)
    best_t = miss.expand(n).clone()
    best_id = torch.zeros((n,), dtype=torch.int32, device=o.device)
    iota = torch.arange(chunk, dtype=torch.int32, device=o.device)[None, :]
    step = max(1, BUDGET.get(o.device.type, BUDGET["cuda"]) // chunk)
    for r0 in range(0, n, step):
        rs = slice(r0, r0 + step)
        o_s, d_s, ex = o[rs], d[rs], excl[rs][:, None]
        for c0 in range(0, p + pad, chunk):
            cs = slice(c0, c0 + chunk)
            t = tri_intersect(o_s, d_s, pa_[cs], pb_[cs], pc_[cs], t_min=t_min, t_max=t_max, eps=eps)
            ids = c0 + iota
            live = (ids >= 1) & (ids < p) & (ids != ex)
            t = torch.where(live & (t > t_min) & (t < t_max), t, miss)
            c_t, c_arg = torch.min(t, dim=1)
            better = c_t < best_t[rs]
            best_t[rs] = torch.where(better, c_t, best_t[rs])
            best_id[rs] = torch.where(better, (c0 + c_arg).to(torch.int32), best_id[rs])
    best_id = torch.where(best_t <= t_max, best_id, 0)
    return best_t, best_id


def slab_test(
    o: torch.Tensor,  # [N, 3]
    inv_d: torch.Tensor,  # [N, 3] 1/d (+-inf where d == 0)
    bmin: torch.Tensor,  # [3] node bounds
    bmax: torch.Tensor,  # [3]
) -> torch.Tensor:
    """The intended ray-AABB slab test with the reference's ``EPS``
    wobble -> bool [N].  NaN slab distances (0 * inf: an origin exactly
    on a slab of a flat box) resolve conservatively to a hit."""
    t0 = (bmin[None, :] - SLAB_EPS - o) * inv_d  # [N, 3]
    t1 = (bmax[None, :] + SLAB_EPS - o) * inv_d
    lo = torch.minimum(t0, t1)
    hi = torch.maximum(t0, t1)
    lo = torch.where(torch.isnan(lo), -torch.inf, lo)
    hi = torch.where(torch.isnan(hi), torch.inf, hi)
    return lo.amax(dim=1) <= hi.amin(dim=1)

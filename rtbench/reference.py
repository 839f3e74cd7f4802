"""The plain reference: the study's frame, ray by ray, in plain PyTorch.

A frozen rewrite, batched over rays, of the repository's scalar oracle
(``tests/oracle.py``, itself a transcription of the reference shader
``compute.wgsl`` and the naive intersector ``basic.rs:43-106``): brute
force Möller–Trumbore over every triangle, a closest hit per bounce,
one shadow ray per light, Blinn/Phong-style terms, mirror bounces.  It
imports torch and NumPy only, nothing of the program, and takes only
the scene's arrays (:class:`rtbench.scenes.SceneData`) and the numbers
of the configuration file.  It runs in blocks of rays and triangles so
that it fits beside nothing else on the card, and in any floating type:
the configuration's float32 is the reference, a lower type is the
control.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# The shader's offset of a bounce or shadow ray's origin off the surface.
SURFACE_OFFSET = 0.001
# Ray-triangle pairs per block: [rays, triangles] temporaries of this
# many elements, a few dozen of them alive at once.
PAIRS_PER_BLOCK = 1 << 24


def orbit_camera(pos, at, angle: float) -> tuple[float, float, float]:
    """``pos`` rotated by ``angle`` radians about the vertical axis
    through ``at``, in float64 (the study's orbit, camera.rs:177-189)."""
    x = pos[0] - at[0]
    z = pos[2] - at[2]
    theta = math.atan2(z, x) + angle
    r = math.sqrt(x * x + z * z)
    return (at[0] + r * math.cos(theta), pos[1], at[2] + r * math.sin(theta))


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _normalize(v: torch.Tensor) -> torch.Tensor:
    return v / torch.sqrt(_dot(v, v))[..., None]


def _reflect(e: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    return e - (2.0 * _dot(e, n))[..., None] * n


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack(
        [
            a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
        ],
        dim=-1,
    )


class Reference:
    """The frame's colours at given pixels of given cameras, computed
    in ``dtype`` on ``device``."""

    def __init__(self, scene, compute: dict, device, dtype=torch.float32):
        self.device = torch.device(device)
        self.dtype = dtype
        self.t_min = float(compute["t_min"])
        self.t_max = float(compute["t_max"])
        self.eps = float(compute["eps"])
        self.bounces = int(compute["bounces"])
        self.camera_light = float(compute["camera_light_source"])

        def dev(a, dt=dtype):
            return torch.as_tensor(np.ascontiguousarray(a)).to(self.device, dt)

        idx = np.asarray(scene.prim_indices, np.int64)
        vp = np.asarray(scene.vert_pos, np.float32)
        vn = np.asarray(scene.vert_norm, np.float32)
        self.pa, self.pb, self.pc = (dev(vp[idx[:, c]]) for c in range(3))
        self.na, self.nb, self.nc = (dev(vn[idx[:, c]]) for c in range(3))
        self.e1 = self.pb - self.pa
        self.e2 = self.pc - self.pa
        # Self-exclusion is by vertex-index triple (basic.rs:87-91): every
        # triangle with the excluded one's exact triple is skipped.
        _, group = np.unique(idx, axis=0, return_inverse=True)
        self.group = dev(group.reshape(-1), torch.int64)
        mat = np.asarray(scene.prim_material, np.int64)
        if (mat < 0).any():
            raise ValueError("the reference renders scenes without material -1 prims only")
        self.mat_color = dev(np.asarray(scene.mat_color)[mat])
        self.mat_albedo = dev(np.asarray(scene.mat_albedo)[mat])
        self.mat_spec = dev(np.asarray(scene.mat_spec)[mat])
        self.lights = [
            (dev(p), float(s))
            for p, s in zip(np.asarray(scene.light_pos), np.asarray(scene.light_strength))
            if s > 0.0
        ]

    # -- the naive closest hit (basic.rs:44-106) -------------------------
    def closest(self, o: torch.Tensor, d: torch.Tensor, excl: torch.Tensor | None):
        """Closest valid hit of each ray [R, 3] over every triangle ->
        (t [R], triangle [R], -1 for a miss).  ``excl`` [R] names a
        triangle whose triple each ray skips (None: none).  Ties go to
        the lower triangle index."""
        n_rays, n_tris = o.shape[0], self.pa.shape[0]
        t_best = torch.full((n_rays,), math.inf, dtype=self.dtype, device=self.device)
        s_best = torch.full((n_rays,), -1, dtype=torch.int64, device=self.device)
        if n_rays == 0 or n_tris == 0:
            return t_best, s_best
        tri_block = min(n_tris, max(1024, PAIRS_PER_BLOCK // max(n_rays, 1)))
        ray_block = max(1, PAIRS_PER_BLOCK // tri_block)
        excl_group = None if excl is None else self.group[excl.clamp(min=0)]
        for r0 in range(0, n_rays, ray_block):
            r1 = min(n_rays, r0 + ray_block)
            ox, oy, oz = (o[r0:r1, k : k + 1] for k in range(3))
            dx, dy, dz = (d[r0:r1, k : k + 1] for k in range(3))
            for t0 in range(0, n_tris, tri_block):
                t1 = min(n_tris, t0 + tri_block)
                ax, ay, az = (self.pa[None, t0:t1, k] for k in range(3))
                e1x, e1y, e1z = (self.e1[None, t0:t1, k] for k in range(3))
                e2x, e2y, e2z = (self.e2[None, t0:t1, k] for k in range(3))
                px = dy * e2z - dz * e2y
                py = dz * e2x - dx * e2z
                pz = dx * e2y - dy * e2x
                det = e1x * px + e1y * py + e1z * pz
                tx, ty, tz = ox - ax, oy - ay, oz - az
                u = tx * px + ty * py + tz * pz
                qx = ty * e1z - tz * e1y
                qy = tz * e1x - tx * e1z
                qz = tx * e1y - ty * e1x
                v = dx * qx + dy * qy + dz * qz
                w = (e2x * qx + e2y * qy + e2z * qz) / det
                uv = u + v
                front = (det > self.eps) & (u >= 0.0) & (u <= det) & (v >= 0.0) & (uv <= det)
                back = (det < -self.eps) & (u <= 0.0) & (u >= det) & (v <= 0.0) & (uv >= det)
                ok = (front | back) & (w > self.t_min) & (w < self.t_max)
                if excl_group is not None:
                    own = excl_group[r0:r1, None] == self.group[None, t0:t1]
                    ok &= ~(own & (excl[r0:r1, None] >= 0))
                w = torch.where(ok, w, torch.full_like(w, math.inf))
                t_blk, s_blk = w.min(dim=1)  # the first of equal minima
                better = t_blk < t_best[r0:r1]
                t_best[r0:r1] = torch.where(better, t_blk, t_best[r0:r1])
                s_best[r0:r1] = torch.where(better, s_blk + t0, s_best[r0:r1])
        return t_best, torch.where(torch.isfinite(t_best), s_best, torch.full_like(s_best, -1))

    # -- hit (compute.wgsl:120-151) --------------------------------------
    def hit(self, o, d, t, s):
        at = o + d * t[:, None]
        b, c, a = self.pa[s], self.pb[s], self.pc[s]
        v0, v1, v2 = b - a, c - a, at - a
        d00, d01, d11 = _dot(v0, v0), _dot(v0, v1), _dot(v1, v1)
        d20, d21 = _dot(v2, v0), _dot(v2, v1)
        denom = d00 * d11 - d01 * d01
        bv = (d11 * d20 - d01 * d21) / denom
        bw = (d00 * d21 - d01 * d20) / denom
        bu = 1.0 - bv - bw
        normal = self.na[s] * bv[:, None] + self.nb[s] * bw[:, None] + self.nc[s] * bu[:, None]
        return at, _normalize(normal)

    def _off_surface(self, at, normal, direction):
        below = (_dot(direction, normal) < 0.0)[:, None]
        return torch.where(below, at - normal * SURFACE_OFFSET, at + normal * SURFACE_OFFSET)

    # -- shadowed (compute.wgsl:189-212) ---------------------------------
    def shadowed(self, lpos, at, normal, s):
        """Whether the light at ``lpos`` [R, 3] is hidden from each hit
        ``at`` [R, 3] (compute.wgsl:189-212) -> (blocked [R], the unit
        direction to the light [R, 3])."""
        to_light = lpos - at
        light_dir = _normalize(to_light)
        light_dist = torch.sqrt(_dot(to_light, to_light))
        origin = self._off_surface(at, normal, light_dir)
        t, hs = self.closest(origin, light_dir, s)
        hit = hs >= 0
        t = torch.where(hit, t, torch.zeros_like(t))
        step = light_dir * t[:, None]
        return hit & (torch.sqrt(_dot(step, step)) < light_dist), light_dir

    # -- lighting (compute.wgsl:219-280) ---------------------------------
    def lighting(self, o: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
        """Colours [R, 3] of rays from ``o`` along ``d`` [R, 3]."""
        color = torch.zeros(o.shape, dtype=self.dtype, device=self.device)
        live = torch.arange(o.shape[0], device=self.device)
        camera_origin = o
        ray_o, ray_d = o, d
        for i in range(self.bounces):
            t, s = self.closest(ray_o, ray_d, None)
            keep = s >= 0
            live, ray_o, ray_d = live[keep], ray_o[keep], ray_d[keep]
            t, s, camera_origin = t[keep], s[keep], camera_origin[keep]
            if live.numel() == 0:
                break
            m_color, m_albedo, m_spec = self.mat_color[s], self.mat_albedo[s], self.mat_spec[s]
            at, normal = self.hit(ray_o, ray_d, t, s)
            diffuse = torch.zeros_like(t)
            spec = torch.zeros_like(t)
            lights = [(p[None, :].expand_as(at), k) for p, k in self.lights]
            if self.camera_light > 0.0:
                lights.insert(0, (camera_origin, self.camera_light))
            for lpos, strength in lights:
                blocked, light_dir = self.shadowed(lpos, at, normal, s)
                lit = ~blocked
                diffuse = diffuse + torch.where(
                    lit, strength * torch.clamp(_dot(light_dir, normal), min=0.0), torch.zeros_like(t)
                )
                refl = _reflect(-light_dir, normal)
                sp = torch.clamp(_dot(-refl, ray_d), min=0.0)
                spec = spec + torch.where(lit, torch.pow(sp, m_spec) * strength, torch.zeros_like(t))
            term = m_color * (diffuse * m_albedo[:, 0])[:, None] + (spec * m_albedo[:, 1])[:, None]
            if i > 0:
                term = term * m_albedo[:, 2:3]
            color = color.index_add(0, live, term)
            refl_dir = _normalize(_reflect(ray_d, normal))
            ray_o = self._off_surface(at, normal, refl_dir)
            ray_d = refl_dir
        return color

    # -- camera_ray + main_cs (compute.wgsl:103-118, 284-293) ------------
    def camera_rays(self, cam_pos, cam_at, xs, ys, width: int, height: int):
        """Primary rays (origins, unit directions) [R, 3] through pixels
        (``xs``, ``ys``) [R] of a ``width`` x ``height`` frame seen from
        ``cam_pos`` to ``cam_at`` (3 floats each, rounded to float32 as
        the frame's camera is)."""
        f32 = np.float32
        pos = torch.tensor([f32(v) for v in cam_pos], dtype=torch.float32).to(self.device, self.dtype)
        at = torch.tensor([f32(v) for v in cam_at], dtype=torch.float32).to(self.device, self.dtype)
        dir_ = _normalize(at - pos)
        up = torch.tensor([0.0, 1.0, 0.0], dtype=self.dtype, device=self.device)
        right = _cross(dir_, up)
        xs = torch.as_tensor(np.asarray(xs), device=self.device).to(self.dtype)
        ys = torch.as_tensor(np.asarray(ys), device=self.device).to(self.dtype)
        norm_x = (xs / width - 0.5)[:, None]
        norm_y = (ys / height - 0.5)[:, None]
        pt = right[None, :] * norm_x + up[None, :] * norm_y + pos[None, :] + dir_[None, :]
        d = _normalize(pt - pos[None, :])
        return pos[None, :].expand_as(d), d

    def frames(self, views, width: int, height: int) -> list[np.ndarray]:
        """Colours (float32 [R_i, 3] NumPy) of each view (camera
        position, camera target, pixel indices ``y * width + x``) of a
        ``width`` x ``height`` frame, all traced together."""
        rays = [
            self.camera_rays(pos, at, np.asarray(pix) % width, np.asarray(pix) // width, width, height)
            for pos, at, pix in views
        ]
        if not rays:
            return []
        o = torch.cat([r[0] for r in rays])
        d = torch.cat([r[1] for r in rays])
        colors = self.lighting(o, d).to(torch.float32).cpu().numpy()
        cuts = np.cumsum([len(pix) for _, _, pix in views])[:-1]
        return np.split(colors, cuts)

"""Scalar NumPy oracle: a direct, loop-based transcription of the
reference compute shader (``src/lib/shaders/compute.wgsl``) plus the
naive intersector (``src/lib/handlers/basic.rs:43-106``).

Deliberately slow and simple — per-pixel Python loops — so the batched
JAX implementation can be validated against an independent rendering of
the same math.  Fixes applied relative to the reference (documented in
PARITY.md): leaf indexing accounts for the null prim correctly; the
oracle has no BVH (it is exact brute force).
"""

from __future__ import annotations

import numpy as np


def normalize(v):
    n = np.sqrt(np.dot(v, v))
    return v / n if n > 0 else v


def reflect(e, n):
    return e - 2.0 * np.dot(e, n) * n


class Oracle:
    def __init__(self, scene, cfg):
        """scene: rt_rs_tpu.scene.Scene; cfg: ComputeConfig."""
        self.cfg = cfg
        p = scene.num_prims
        # GPU layout: null sentinel at index 0 (scene/mod.rs:161-166).
        self.prim_idx = np.zeros((p + 1, 3), dtype=np.int64)
        self.prim_mat = np.full((p + 1,), -1, dtype=np.int64)
        if p:
            self.prim_idx[1:] = scene.prim_indices
            self.prim_mat[1:] = scene.prim_material
        self.vp = scene.vert_pos.astype(np.float32)
        self.vn = scene.vert_norm.astype(np.float32)
        self.light_pos = scene.light_pos.astype(np.float32)
        self.light_strength = scene.light_strength.astype(np.float32)
        self.mat_color = scene.mat_color.astype(np.float32)
        self.mat_albedo = scene.mat_albedo.astype(np.float32)
        self.mat_spec = scene.mat_spec.astype(np.float32)

    # -- intrs_tri (basic.rs:44-79) ------------------------------------
    def intrs_tri(self, o, d, s):
        cfg = self.cfg
        ia, ib, ic = self.prim_idx[s]
        va, vb, vc = self.vp[ia], self.vp[ib], self.vp[ic]
        e1 = vb - va
        e2 = vc - va
        p = np.cross(d, e2)
        t = o - va
        q = np.cross(t, e1)
        det = np.dot(e1, p)
        if det > cfg.eps:
            u = np.dot(t, p)
            if u < 0.0 or u > det:
                return None
            v = np.dot(d, q)
            if v < 0.0 or u + v > det:
                return None
        elif det < -cfg.eps:
            u = np.dot(t, p)
            if u > 0.0 or u < det:
                return None
            v = np.dot(d, q)
            if v > 0.0 or u + v < det:
                return None
        else:
            return None
        w = np.dot(e2, q) / det
        if w > cfg.t_max or w < cfg.t_min:
            return None
        return w

    # -- naive intrs (basic.rs:81-106) ---------------------------------
    def intrs(self, o, d, excl):
        cfg = self.cfg
        best_t = cfg.t_max + 1.0
        best_s = 0
        for s in range(1, self.prim_idx.shape[0]):
            # Reference self-exclusion is by VERTEX-INDEX TRIPLE, not
            # prim id (basic.rs:87-91: the candidate is tested only if
            # ANY of a/b/c differs from the excluded prim's) — an exact
            # duplicate triangle is excluded together with its twin.
            if (self.prim_idx[s] == self.prim_idx[excl]).all():
                continue
            w = self.intrs_tri(o, d, s)
            if w is None:
                continue
            if w < best_t and cfg.t_min < w < cfg.t_max:
                best_t = w
                best_s = s
        return best_t, best_s

    def intrs_valid(self, t, s):
        return (
            self.prim_mat[s] != -1
            and t < self.cfg.t_max
            and t > self.cfg.t_min
        )

    # -- hit (compute.wgsl:120-151) ------------------------------------
    def hit(self, o, d, t, s):
        at = o + d * t
        ia, ib, ic = self.prim_idx[s]
        b = self.vp[ia]
        c = self.vp[ib]
        a = self.vp[ic]
        v0, v1, v2 = b - a, c - a, at - a
        d00 = np.dot(v0, v0)
        d01 = np.dot(v0, v1)
        d11 = np.dot(v1, v1)
        d20 = np.dot(v2, v0)
        d21 = np.dot(v2, v1)
        denom = d00 * d11 - d01 * d01
        v = (d11 * d20 - d01 * d21) / denom
        w = (d00 * d21 - d01 * d20) / denom
        u = 1.0 - v - w
        normal = self.vn[ia] * v + self.vn[ib] * w + self.vn[ic] * u
        return at, normalize(normal)

    # -- shadowed (compute.wgsl:189-212) -------------------------------
    def shadowed(self, light_pos, at, normal, s):
        light_dir = normalize(light_pos - at)
        light_dist = np.sqrt(np.dot(light_pos - at, light_pos - at))
        if np.dot(light_dir, normal) < 0.0:
            origin = at - normal * 0.001
        else:
            origin = at + normal * 0.001
        t, hs = self.intrs(origin, light_dir, s)
        if self.intrs_valid(t, hs):
            hit_at, _ = self.hit(origin, light_dir, t, hs)
            if np.sqrt(np.dot(hit_at - origin, hit_at - origin)) < light_dist:
                return True
        return False

    # -- lighting (compute.wgsl:219-280) -------------------------------
    def lighting(self, o, d):
        cfg = self.cfg
        ray_o, ray_d = o.copy(), d.copy()
        camera_origin = o.copy()
        color = np.zeros(3, dtype=np.float64)
        for i in range(cfg.bounces):
            t, s = self.intrs(ray_o, ray_d, 0)
            if not self.intrs_valid(t, s):
                break
            mat = self.prim_mat[s]
            m_color = self.mat_color[mat]
            m_albedo = self.mat_albedo[mat]
            m_spec = self.mat_spec[mat]
            at, normal = self.hit(ray_o, ray_d, t, s)

            diffuse = 0.0
            spec = 0.0
            lights = []
            if cfg.camera_light_source > 0.0:
                lights.append((camera_origin, cfg.camera_light_source))
            for j in range(self.light_pos.shape[0]):
                if self.light_strength[j] > 0.0:
                    lights.append((self.light_pos[j], self.light_strength[j]))
                else:
                    lights.append(None)
            for entry in lights:
                if entry is None:
                    continue
                lpos, lstr = entry
                if self.shadowed(lpos, at, normal, s):
                    continue
                light_dir = normalize(lpos - at)
                diffuse += lstr * max(0.0, np.dot(light_dir, normal))
                refl = reflect(-light_dir, normal)
                sp = np.dot(-refl, ray_d)
                spec += (max(0.0, sp) ** m_spec) * lstr

            color_temp = (
                m_color * diffuse * m_albedo[0]
                + np.ones(3) * spec * m_albedo[1]
            )
            if i == 0:
                color += color_temp
            else:
                color += color_temp * m_albedo[2]

            refl_dir = normalize(reflect(ray_d, normal))
            if np.dot(refl_dir, normal) < 0.0:
                ray_o = at - normal * 0.001
            else:
                ray_o = at + normal * 0.001
            ray_d = refl_dir
        return color

    # -- camera_ray + main_cs ------------------------------------------
    def camera_ray(self, x, y, width, height, cam_pos, cam_at):
        cam_pos = np.asarray(cam_pos, dtype=np.float32)
        cam_at = np.asarray(cam_at, dtype=np.float32)
        dir_ = normalize(cam_at - cam_pos)
        up = np.array([0.0, 1.0, 0.0], dtype=np.float32)
        right = np.cross(dir_, up)
        norm_x = (x / width) - 0.5
        norm_y = (y / height) - 0.5
        pt = right * norm_x + up * norm_y + cam_pos + dir_
        return cam_pos, normalize(pt - cam_pos)

    def render(self, width, height, cam_pos, cam_at):
        out = np.zeros((height, width, 3), dtype=np.float64)
        for y in range(height):
            for x in range(width):
                o, d = self.camera_ray(x, y, width, height, cam_pos, cam_at)
                out[y, x] = self.lighting(o.astype(np.float64), d.astype(np.float64))
        return out


class FastOracle(Oracle):
    """The same oracle with ``intrs`` vectorized over prims.

    Per-prim arithmetic mirrors the scalar loop (float64 promotion at
    the same points, same comparison set, strict ``w < best`` selection
    = first-occurrence argmin).  NOT bit-identical: ``np.dot`` on
    3-vectors contracts with FMA inside BLAS while the vectorized
    ``einsum`` does not, so ``t`` can drift by a few ULP (measured
    ~2e-15 relative on ~2% of rays, hit ids unchanged).  Pinned within
    that tolerance by
    ``tests/test_render.py::test_fast_oracle_matches_scalar``.  Exists
    so the oracle can verify real geometry (teatime, 6,320 prims) at
    image sizes where the scalar loop is hours-slow.
    """

    def __init__(self, scene, cfg):
        super().__init__(scene, cfg)
        ia = self.prim_idx[:, 0]
        ib = self.prim_idx[:, 1]
        ic = self.prim_idx[:, 2]
        self._va = self.vp[ia]  # [P+1, 3] float32
        self._e1 = self.vp[ib] - self._va
        self._e2 = self.vp[ic] - self._va

    def intrs(self, o, d, excl):
        cfg = self.cfg
        va, e1, e2 = self._va, self._e1, self._e2
        o = np.asarray(o, dtype=np.float64)
        d = np.asarray(d, dtype=np.float64)
        p = np.cross(np.broadcast_to(d, e2.shape), e2)  # f64 [P+1, 3]
        t = o[None, :] - va
        q = np.cross(t, e1)
        det = np.einsum("ij,ij->i", e1.astype(np.float64), p)
        u = np.einsum("ij,ij->i", t, p)
        v = np.einsum("ij,ij->i", d[None, :].astype(np.float64), q)
        pos = det > cfg.eps
        neg = det < -cfg.eps
        ok = (pos & (u >= 0.0) & (u <= det) & (v >= 0.0) & (u + v <= det)) | (
            neg & (u <= 0.0) & (u >= det) & (v <= 0.0) & (u + v >= det)
        )
        with np.errstate(divide="ignore", invalid="ignore"):
            w = np.einsum("ij,ij->i", e2.astype(np.float64), q) / det
        ok &= (w > cfg.t_min) & (w < cfg.t_max)
        ok[0] = False  # null sentinel (loop starts at s=1)
        # Triple-based self-exclusion (basic.rs:87-91), as in the
        # scalar loop above: every prim sharing the excluded prim's
        # exact vertex-index triple is skipped, not just `excl` itself.
        ok &= ~np.all(self.prim_idx == self.prim_idx[excl], axis=1)
        if not ok.any():
            return cfg.t_max + 1.0, 0
        w = np.where(ok, w, np.inf)
        s = int(np.argmin(w))  # first occurrence == loop's strict <
        return float(w[s]), s

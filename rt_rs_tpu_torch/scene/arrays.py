"""Device-resident scene arrays (the bind-group(2) equivalent).

Counterpart of ``rt_rs_tpu/scene/arrays.py``: the same structure-of-
arrays layout, built by the same NumPy code (so every value is
bit-identical to the JAX package's), held as torch tensors on an
explicit device.

* Per-primitive corner data is pre-gathered: ``pa/pb/pc`` (positions)
  and ``na/nb/nc`` (normals) are contiguous ``[P, 3]`` tensors.
* The null/miss sentinel prim (material ``-1``) occupies row 0
  (``scene/mod.rs:161-166``), so "prim id 0" always means miss.
* ``shade_table`` is the combined ``[P + 1, 32]`` per-prim shading row.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def intersect_indices(prim_indices: np.ndarray) -> np.ndarray:
    """Vertex-index triples as seen by the intersection path: each later
    exact duplicate of an earlier ordered triple is collapsed to a
    zero-area ``(a, a, a)`` triangle.

    This reproduces the reference's triple-based self-exclusion
    (``handlers/basic.rs:87-91``) with zero kernel cost: the collapsed
    copy never hits (Möller–Trumbore ``det == 0``), so the lower prim
    id wins every tie and excluding it by id excludes its twins.  Same
    code as ``rt_rs_tpu.scene.arrays.intersect_indices``; identity (the
    same object) when there are no duplicates."""
    idx = np.asarray(prim_indices)
    if idx.shape[0] < 2:
        return idx
    _, first = np.unique(idx, axis=0, return_index=True)
    if first.shape[0] == idx.shape[0]:
        return idx
    canon = np.zeros(idx.shape[0], dtype=bool)
    canon[first] = True
    out = idx.copy()
    out[~canon, 1] = out[~canon, 0]
    out[~canon, 2] = out[~canon, 0]
    return out


@dataclasses.dataclass(frozen=True)
class SceneArrays:
    # Per-prim (row 0 = null sentinel): material id, corner positions,
    # corner normals.  [P, 3] float32 / [P] int32.
    prim_mat: torch.Tensor
    pa: torch.Tensor
    pb: torch.Tensor
    pc: torch.Tensor
    na: torch.Tensor
    nb: torch.Tensor
    nc: torch.Tensor
    # Lights: [L, 3] / [L]
    light_pos: torch.Tensor
    light_strength: torch.Tensor
    # Materials: [M, 3] / [M, 3] / [M]  (M >= 1; padded with a dummy)
    mat_color: torch.Tensor
    mat_albedo: torch.Tensor
    mat_spec: torch.Tensor
    # [P, 32] float32: pa pb pc na nb nc mat_color mat_albedo (3 each) |
    # mat_spec | prim_mat | pad.
    shade_table: torch.Tensor
    # True if no *real* prim carries material -1: validity checks may
    # then use `prim_id != 0` instead of a gather.
    no_negative_materials: bool = True

    @property
    def device(self) -> torch.device:
        return self.shade_table.device

    @property
    def num_prims(self) -> int:
        """Prim count *including* the null sentinel at row 0."""
        return int(self.prim_mat.shape[0])

    @property
    def num_lights(self) -> int:
        return int(self.light_strength.shape[0])

    @classmethod
    def from_scene(cls, scene, device: str | torch.device) -> "SceneArrays":
        p = scene.num_prims
        idx = intersect_indices(scene.prim_indices).astype(np.int64)
        vp = scene.vert_pos.astype(np.float32)
        vn = scene.vert_norm.astype(np.float32)

        def corner(arr: np.ndarray, c: int) -> np.ndarray:
            out = np.zeros((p + 1, 3), dtype=np.float32)
            if p:
                out[1:] = arr[idx[:, c]]
            return out

        prim_mat = np.full((p + 1,), -1, dtype=np.int32)
        if p:
            prim_mat[1:] = scene.prim_material

        m = scene.mat_color.shape[0]
        mat_color = scene.mat_color.astype(np.float32)
        mat_albedo = scene.mat_albedo.astype(np.float32)
        mat_spec = scene.mat_spec.astype(np.float32)
        if m == 0:
            mat_color = np.zeros((1, 3), dtype=np.float32)
            mat_albedo = np.zeros((1, 3), dtype=np.float32)
            mat_spec = np.zeros((1,), dtype=np.float32)

        pa_, pb_, pc_ = corner(vp, 0), corner(vp, 1), corner(vp, 2)
        na_, nb_, nc_ = corner(vn, 0), corner(vn, 1), corner(vn, 2)
        mat_id = np.maximum(prim_mat, 0)
        table = np.zeros((p + 1, 32), dtype=np.float32)
        table[:, 0:3] = pa_
        table[:, 3:6] = pb_
        table[:, 6:9] = pc_
        table[:, 9:12] = na_
        table[:, 12:15] = nb_
        table[:, 15:18] = nc_
        table[:, 18:21] = mat_color[mat_id]
        table[:, 21:24] = mat_albedo[mat_id]
        table[:, 24] = mat_spec[mat_id]
        table[:, 25] = prim_mat.astype(np.float32)

        def dev(a: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        return cls(
            prim_mat=dev(prim_mat),
            pa=dev(pa_),
            pb=dev(pb_),
            pc=dev(pc_),
            na=dev(na_),
            nb=dev(nb_),
            nc=dev(nc_),
            light_pos=dev(scene.light_pos.astype(np.float32).reshape(-1, 3)),
            light_strength=dev(scene.light_strength.astype(np.float32)),
            mat_color=dev(mat_color),
            mat_albedo=dev(mat_albedo),
            mat_spec=dev(mat_spec),
            shade_table=dev(table),
            no_negative_materials=bool((prim_mat[1:] >= 0).all()) if p else True,
        )

    def rebuild_shade_table(self) -> "SceneArrays":
        """Recompute ``shade_table`` from the (possibly updated) per-prim
        tensors on their device, as ``from_scene`` lays it out: the
        dynamic path's per-frame table."""
        mat_id = torch.clamp_min(self.prim_mat, 0).long()
        p1 = self.prim_mat.shape[0]
        table = torch.cat(
            [
                self.pa, self.pb, self.pc,
                self.na, self.nb, self.nc,
                self.mat_color[mat_id],
                self.mat_albedo[mat_id],
                self.mat_spec[mat_id][:, None],
                self.prim_mat.to(torch.float32)[:, None],
                self.pa.new_zeros((p1, 6)),
            ],
            dim=1,
        )
        return dataclasses.replace(self, shade_table=table)

    def byte_size(self) -> int:
        """The bytes of every tensor field (geometry, lights, materials,
        shade table), for ``IntrsStats``-style reporting."""
        return sum(
            t.numel() * t.element_size()
            for t in (getattr(self, f.name) for f in dataclasses.fields(self))
            if isinstance(t, torch.Tensor)
        )

"""Möller–Trumbore as one matrix product per (ray tile, chunk).

Counterpart of ``experiments/mxu_mt.py`` (TPU kernel 8,
``_mxu_kernel``).  det, u, v and wnum (w = wnum / det) are bilinear in a
ray's features and a triangle's coefficients:

    det  = d . (e2 x e1)
    u    = (o x d) . e2  - d . (e2 x a)
    v    = -(o x d) . e1 - d . (a x e1)
    wnum = o . n - e2 . (a x e1)

Ray features ``B [16, r]``: rows 0-2 d, 3-5 o, 6-8 o x d, 9 one, 10-15
zero.  The table (:func:`build_mxu_table`) holds per chunk ``A [16,
4 tc]`` with quantity-major columns ``[det | u | v | wnum]``; kernel I
(``csrc/mt_mxu.cu``, :func:`mt_mxu`) computes ``C = A^T B`` in its own
body and runs the JAX kernel's epilogue on it, on balanced work items
with an exact (t, pid) merge (:func:`mt_mxu_split_reference` mirrors
it).  ``precision`` maps as XLA maps it on a GPU: ``"highest"`` f32 on
the CUDA cores (bit-equal to the twin), ``"high"`` three TF32
tensor-core products (3xTF32), ``"default"`` one; for those two each
call first makes the table's TF32 words (:func:`tf32_table` is that
launch's plain version).
"""

from __future__ import annotations

import numpy as np
import torch

from rt_rs_tpu_torch.experiments.probe_rays import probe_rays
from rt_rs_tpu_torch.ops import cuda
from rt_rs_tpu_torch.ops import packet_trace as pt

F = 16  # padded feature dim
# Features a ray's B can make non-zero (d, o, o x d, one): "highest"
# sums these, in order.  Rows 10-15 would add a zero product to each sum
# (build_mxu_table leaves them zero), which could only turn a -0.0 sum
# into +0.0: the same verdict, and the same w where t_min >= 0.
F_USED = 10
# List entries per work item of kernel I's balanced design, per precision:
# the kernel's compile-time ITEM_MXU and ITEM_MXU_TC (csrc/mt_mxu.cu),
# swept on the card (experiments/item_sizes.py).
MXU_ITEM_SIZES = {"highest": 2, "high": 8, "default": 8}
PRECISIONS = ("highest", "high", "default")
TC_RAYS = 128  # the tensor-core variants' ray tile
# precision -> (least share of rays whose pid agrees with "highest",
# largest relative t error where they agree on a hit): TF32 keeps 10
# mantissa bits of each input, and the o x d and constant terms cancel
# (even "highest" is 4.6e-5 from the Möller–Trumbore t at torus 1080p).
# chip_smoke.py holds the card's tensor-core results to these bounds
# (measured there at torus_scene's 1080p primaries: high 1.0 and
# 4.1e-5, default 0.996 and 4.4e-2), tests/test_torch_probes.py the
# twins' emulation.
TF32_BOUNDS = {"high": (0.9999, 2e-4), "default": (0.99, 1e-1)}
# The share of rays by which a tensor-core kernel's pid agreement with
# "highest" may fall short of its twin's emulation's on the same rays:
# both round the inputs alike and differ only in the order of the f32
# sums (on an H100 at torus_scene's 1080p primaries by at most one ray
# in a million).  chip_smoke.py holds the kernels to it on every call,
# also on tiles where TF32 loses more pids than TF32_BOUNDS allows an
# image.
TF32_TWIN_MARGIN = 1e-4


def tf32_agreement(t, pid, t_ref, pid_ref) -> tuple[float, float]:
    """(share of rays whose pid agrees, largest relative t error where
    they agree on a hit) of a result against ``highest``'s, the two
    quantities TF32_BOUNDS bounds."""
    same = pid == pid_ref
    hit = same & (pid_ref != 0)
    rel = ((t[hit] - t_ref[hit]).abs() / t_ref[hit].abs()).max() if bool(hit.any()) else t.new_zeros(())
    return float(same.float().mean()), float(rel)


def build_mxu_table(chunks: pt.TriChunks) -> torch.Tensor:
    """-> ``[Nc, 16, 4 tc]`` f32 coefficient table of a chunk table, on
    its device: computed in f64 from the f32 components, then rounded,
    with the JAX package's NumPy arithmetic (so the two tables are equal
    bit for bit)."""
    comp = chunks.comp.cpu().numpy()  # [Nc, tc, 9]: a, e1, e2
    nc, tc, _ = comp.shape
    a = comp[:, :, 0:3].reshape(-1, 3).astype(np.float64)
    e1 = comp[:, :, 3:6].reshape(-1, 3).astype(np.float64)
    e2 = comp[:, :, 6:9].reshape(-1, 3).astype(np.float64)
    n = np.cross(e1, e2)
    A = np.zeros((nc * tc, 4, F), dtype=np.float32)
    A[:, 0, 0:3] = np.cross(e2, e1)  # det: d-coeff
    A[:, 1, 0:3] = -np.cross(e2, a)  # u: d-coeff
    A[:, 1, 6:9] = e2  # u: oxd-coeff
    A[:, 2, 0:3] = -np.cross(a, e1)  # v: d-coeff
    A[:, 2, 6:9] = -e1  # v: oxd-coeff
    A[:, 3, 3:6] = n  # wnum: o-coeff
    A[:, 3, 9] = -np.einsum("ij,ij->i", e2, np.cross(a, e1))  # const
    A = A.reshape(nc, tc, 4, F).transpose(0, 3, 2, 1).reshape(nc, F, 4 * tc)
    return torch.from_numpy(np.ascontiguousarray(A)).to(chunks.comp.device)


def ray_features(rays: torch.Tensor) -> torch.Tensor:
    """Tile-major rays [S, 8, r] -> features B [S, 16, r], in
    ``mxu_mt.py:69-76``'s op order."""
    ox, oy, oz, dx, dy, dz = (rays[:, i] for i in range(6))
    cx = oy * dz - oz * dy
    cy = oz * dx - ox * dz
    cz = ox * dy - oy * dx
    one = torch.ones_like(ox)
    zero = torch.zeros_like(ox)
    return torch.stack([dx, dy, dz, ox, oy, oz, cx, cy, cz, one] + [zero] * 6, dim=1)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """Round f32 to TF32 (10 mantissa bits) to nearest, ties away from
    zero: PTX ``cvt.rna.tf32.f32``, the tensor cores' input rounding."""
    bits = (x.view(torch.int32) + 0x1000) & -0x2000
    return torch.where(torch.isnan(x), x, bits.view(torch.float32))


def _split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    hi = tf32(x)
    return hi, tf32(x - hi)


def tf32_table(table: torch.Tensor, precision: str) -> torch.Tensor:
    """The tensor-core variants' table: ``table``'s words rounded to TF32
    as ``cvt.rna`` rounds them (:func:`tf32`; ``"default"``: [Nc, 16,
    4 tc]), or split into hi + lo (:func:`_split`; ``"high"``: [Nc, 2, 16,
    4 tc], each chunk's hi then its lo), on the table's device: the
    plain version of the words kernel I makes at the start of each
    call and stages, so that no warp converts an operand."""
    if precision == "default":
        return tf32(table)
    if precision == "high":
        return torch.stack(_split(table), dim=1)
    raise ValueError(f"no TF32 table for precision {precision!r}")


def product(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """``C [S, M, r] = A^T B`` for A [S, 16, M], B [S, 16, r]: the sum
    over the features in order, each product and sum rounded to f32.
    ``"highest"`` is kernel I's CUDA-core arithmetic op for op, over the
    F_USED features; ``"high"`` (hi·lo + lo·hi + hi·hi of the TF32
    splits) and ``"default"`` (one TF32 product) emulate the tensor
    cores' input rounding, with f32 accumulation over the 16 features in
    order where the hardware's order is its own."""
    features = F
    if precision == "highest":
        terms = [(a, b)]
        features = F_USED
    elif precision == "high":
        (ah, al), (bh, bl) = _split(a), _split(b)
        terms = [(ah, bl), (al, bh), (ah, bh)]
    elif precision == "default":
        terms = [(tf32(a), tf32(b))]
    else:
        raise ValueError(f"unknown precision {precision!r}; expected one of {PRECISIONS}")
    acc = None
    for x, y in terms:
        for f in range(features):
            p = x[:, f, :, None] * y[:, f, None, :]
            acc = p if acc is None else acc + p
    return acc


def mt_mxu_reference(
    table: torch.Tensor,  # [Nc, 16, 4 tc]
    rays: torch.Tensor,  # [T, 8, r] tile-major
    ids: torch.Tensor,  # [T, Nc] int32
    counts: torch.Tensor,  # [T] int32
    *,
    t_min: float,
    t_max: float,
    eps: float,
    precision: str = "highest",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain-PyTorch twin of kernel I, vectorised over the tiles whose
    list reaches position ``k``: per chunk the product
    (:func:`product`), the epilogue of ``mxu_mt.py:92-107`` (sign fold,
    barycentric bounds, w = wnum / det, the window, pid != excl), each
    ray's best in the chunk (min w, ties to the smallest triangle), kept
    only when strictly nearer than the running best."""
    dev = rays.device
    n_tiles, r = rays.shape[0], rays.shape[2]
    tc = table.shape[2] // 4
    f = lambda x: pt._f32(x, dev)  # noqa: E731
    t_min_t, t_max_t, eps_t = f(t_min), f(t_max), f(eps)
    miss = f(float(np.float32(t_max + 1.0)))
    one = f(1.0)
    sub = torch.arange(tc, dtype=torch.int32, device=dev)[None, :, None]
    best_t = miss.expand(n_tiles, r).clone()
    best_id = torch.zeros((n_tiles, r), dtype=torch.int32, device=dev)
    kmax = int(counts.max()) if n_tiles else 0
    for k in range(kmax):
        for sel in pt.twin_slices((counts > k).nonzero()[:, 0], 4 * tc * r):
            c = ids[sel, k].to(torch.int64)
            q = product(table[c], ray_features(rays[sel]), precision)
            det, u, v, wnum = q.reshape(-1, 4, tc, r).unbind(1)  # [S, tc, r]
            sgn = torch.where(det > 0.0, one, torch.where(det < 0.0, -one, 0.0 * one))
            adet = det.abs()
            su = u * sgn
            sv = v * sgn
            ok = (adet > eps_t) & (su >= 0.0) & (su <= adet) & (sv >= 0.0) & (su + sv <= adet)
            w = wnum / torch.where(ok, det, one)
            ok = ok & (w > t_min_t) & (w < t_max_t)
            pid0 = (1 + c.to(torch.int32) * tc)[:, None]  # [S, 1]
            ok = ok & ((pid0[:, :, None] + sub).to(torch.float32) != rays[sel, 6][:, None, :])
            wm = torch.where(ok, w, miss)
            cmin = wm.amin(dim=1)  # [S, r]
            cid = pid0 + torch.where(wm == cmin[:, None, :], sub, tc).amin(dim=1)
            better = cmin < best_t[sel]
            best_t[sel] = torch.where(better, cmin, best_t[sel])
            best_id[sel] = torch.where(better, cid, best_id[sel])
    return best_t, best_id


def mt_mxu_split_reference(
    table: torch.Tensor,
    rays: torch.Tensor,
    ids: torch.Tensor,
    counts: torch.Tensor,
    *,
    t_min: float,
    t_max: float,
    eps: float,
    precision: str = "highest",
    per_item: int | None = None,
    order: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel I's balanced design (:func:`mt_mxu_reference`'s
    arguments): every list cut into work items of ``per_item`` entries
    (None: MXU_ITEM_SIZES[precision], the kernel's),
    :func:`mt_mxu_reference` on each item alone (its (t, pid)
    lexicographic best), merged per ray by
    minimum key in the item order ``order``
    (``packet_trace.split_closest``).  Equal to the twin bit for bit in
    every order and at every precision."""
    kw = dict(t_min=t_min, t_max=t_max, eps=eps, precision=precision)
    return pt.split_closest(
        lambda tile, item_ids, n: mt_mxu_reference(table, rays[tile], item_ids, n, **kw),
        ids, counts, rays.shape[2], t_max=t_max,
        per_item=MXU_ITEM_SIZES[precision] if per_item is None else per_item, order=order,
    )


def mt_mxu(
    table: torch.Tensor,
    rays: torch.Tensor,
    ids: torch.Tensor,
    counts: torch.Tensor,
    *,
    t_min: float,
    t_max: float,
    eps: float,
    precision: str = "highest",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel I (csrc/mt_mxu.cu) -> (t [T, r], pid [T, r] int32), counted
    as ``mt_mxu[<precision>]``.  The tensor-core variants need 128-ray
    tiles and ``tc`` a multiple of 16.  CPU tensors run
    :func:`mt_mxu_reference`; CUDA tensors launch the kernel: balanced
    work items of MXU_ITEM_SIZES[precision] entries with an exact (t,
    pid) merge, two launches (see :func:`mt_mxu_split_reference`);
    ``"high"`` and ``"default"`` make the table's TF32 words
    (:func:`tf32_table`) in a third launch before them."""
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}; expected one of {PRECISIONS}")
    kw = dict(t_min=t_min, t_max=t_max, eps=eps, precision=precision)
    if not rays.is_cuda:
        return mt_mxu_reference(table, rays, ids, counts, **kw)
    nc, m = table.shape[0], table.shape[2]
    tc = m // 4
    n_tiles, r = rays.shape[0], rays.shape[2]
    dev = rays.device
    cuda.check("table", table, torch.float32, (nc, F, 4 * tc), dev)
    cuda.check("rays", rays, torch.float32, (n_tiles, 8, r), dev)
    cuda.check("ids", ids, torch.int32, (n_tiles, nc), dev)
    cuda.check("counts", counts, torch.int32, (n_tiles,), dev)
    if r % 32 or r > 1024:
        raise ValueError(f"ray tile {r} must be a multiple of 32 <= 1024")
    if precision != "highest" and (r != TC_RAYS or tc % 16):
        raise ValueError(
            f"precision {precision!r} needs {TC_RAYS}-ray tiles and tc a multiple "
            f"of 16 (got r={r}, tc={tc})"
        )
    words = None
    if precision != "highest":
        parts = (2,) if precision == "high" else ()
        words = torch.empty((nc, *parts, F, 4 * tc), dtype=torch.float32, device=dev)
    out_t = torch.empty((n_tiles, r), dtype=torch.float32, device=dev)
    out_pid = torch.empty((n_tiles, r), dtype=torch.int32, device=dev)
    # The balanced design's scratch (csrc/mt_items.cuh), set by the kernel.
    keys = torch.empty((n_tiles, r), dtype=torch.int64, device=dev)
    work = torch.empty((4 * n_tiles + 4,), dtype=torch.int32, device=dev)
    cuda.call(
        f"mt_mxu[{precision}]", "rt_mt_mxu",
        rays.data_ptr(), table.data_ptr(), cuda.ptr(words), ids.data_ptr(), counts.data_ptr(),
        out_t.data_ptr(), out_pid.data_ptr(), keys.data_ptr(), work.data_ptr(),
        n_tiles, r, nc, tc, float(t_min), float(t_max), float(eps),
        float(np.float32(t_max + 1.0)), PRECISIONS.index(precision),
    )
    return out_t, out_pid


def packet_closest_hit_mxu(
    chunks: pt.TriChunks,
    table: torch.Tensor,  # build_mxu_table(chunks)
    o: torch.Tensor,  # [N, 3]
    d: torch.Tensor,  # [N, 3]
    excl: torch.Tensor,  # [N] int32
    valid: torch.Tensor | None = None,  # [N] bool
    t_cap: torch.Tensor | None = None,  # [N] (culling only)
    *,
    t_min: float,
    t_max: float,
    eps: float,
    ray_tile: int = TC_RAYS,
    precision: str = "highest",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Closest hit of a flat ray batch through kernel I -> (t [N], pid
    [N] int32), the flat intersect contract; the chunk lists are the
    interval cull's over ``chunks``' bounds."""
    s = probe_rays(
        o, d, excl, valid, t_cap, chunks.bmin, chunks.bmax,
        t_min=t_min, t_max=t_max, ray_tile=ray_tile,
    )
    t, pid = mt_mxu(
        table, s.rays, s.ids, s.counts, t_min=t_min, t_max=t_max, eps=eps, precision=precision
    )
    return t.reshape(-1)[: s.n], pid.reshape(-1)[: s.n]

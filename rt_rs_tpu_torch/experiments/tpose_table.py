"""The transposed chunk table: components on rows, triangles contiguous.

Counterpart of ``experiments/tpose_table.py`` (TPU kernel 9,
``_mt_kernel_t``).  The table is ``[Nc, 16, tc]`` f32: component i (a,
e1 = b - a, e2 = c - a; xyz) of triangle s of chunk c at ``[c, i, s]``,
rows 9-15 zero.  :func:`packet_closest_hit_t` is the probe's flat
closest hit: the interval cull and the compacted chunk lists of
:mod:`~rt_rs_tpu_torch.experiments.probe_rays`, then kernel H
(``csrc/mt_tpose.cu``, :func:`mt_tpose`): kernel B's closest-hit design
on balanced work items (:func:`mt_tpose_split_reference` mirrors it),
staging each listed chunk's nine component rows with coalesced loads
and running ``mt_chunk_test``'s arithmetic in its op order.  Over the
same lists it equals kernel B's closest-hit mode (``mt_trace[closest]``)
bit for bit; only the table's layout differs.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from rt_rs_tpu_torch.experiments.probe_rays import probe_rays
from rt_rs_tpu_torch.ops import cuda
from rt_rs_tpu_torch.ops import packet_trace as pt

# List entries per work item of kernel H's balanced design: the kernel's
# compile-time ITEM_TPOSE (csrc/mt_tpose.cu), kernel B's closest mode.
TPOSE_ITEM_SIZE = 2


class TposeTables(NamedTuple):
    comp: torch.Tensor  # [Nc, 16, tc] f32
    bmin: torch.Tensor  # [Nc, 3]
    bmax: torch.Tensor  # [Nc, 3]
    num_chunks: int


def _np(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def build_tri_chunks_t(pa, pb, pc, tri_chunk: int = 128, *, device) -> TposeTables:
    """Reordered prim corners (row 0, the null sentinel, is dropped) ->
    the transposed table, in NumPy with the JAX package's arithmetic.
    Pad triangles are zero (never hit) with inverted bounds (culled);
    the chunk count is aligned to CHUNK_ALIGN."""
    pa = _np(pa).astype(np.float32)[1:]
    pb = _np(pb).astype(np.float32)[1:]
    pc = _np(pc).astype(np.float32)[1:]
    p = pa.shape[0]
    nc = max(1, -(-p // tri_chunk))
    nc = -(-nc // pt.CHUNK_ALIGN) * pt.CHUNK_ALIGN
    pad = nc * tri_chunk - p

    def padz(x):
        return np.pad(x, ((0, pad), (0, 0)))

    pa_, pb_, pc_ = padz(pa), padz(pb), padz(pc)
    comp9 = np.concatenate([pa_, pb_ - pa_, pc_ - pa_], axis=1)  # [P_pad, 9]
    comp = np.zeros((nc, 16, tri_chunk), np.float32)
    comp[:, :9, :] = comp9.reshape(nc, tri_chunk, 9).transpose(0, 2, 1)
    tri_min = np.minimum(np.minimum(pa_, pb_), pc_)
    tri_max = np.maximum(np.maximum(pa_, pb_), pc_)
    if pad:
        tri_min[p:] = np.float32(np.finfo(np.float32).max)
        tri_max[p:] = np.float32(-np.finfo(np.float32).max)
    bmin = tri_min.reshape(nc, tri_chunk, 3).min(axis=1)
    bmax = tri_max.reshape(nc, tri_chunk, 3).max(axis=1)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return TposeTables(dev(comp), dev(bmin), dev(bmax), nc)


def mt_tpose_reference(
    table: torch.Tensor,  # [Nc, 16, tc]
    rays: torch.Tensor,  # [T, 8, r] tile-major
    ids: torch.Tensor,  # [T, Nc] int32
    counts: torch.Tensor,  # [T] int32
    *,
    t_min: float,
    t_max: float,
    eps: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain-PyTorch twin of kernel H: kernel B's closest-hit twin on the
    table read as ``[Nc, tc, 9]`` and the rays as a component-major
    payload."""
    return pt.mt_trace_reference(
        table[:, :9, :].transpose(1, 2), rays.permute(1, 0, 2), ids, counts,
        t_min=t_min, t_max=t_max, eps=eps, mode="closest",
    )


def mt_tpose_split_reference(
    table: torch.Tensor,
    rays: torch.Tensor,
    ids: torch.Tensor,
    counts: torch.Tensor,
    *,
    t_min: float,
    t_max: float,
    eps: float,
    per_item: int | None = None,
    order: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel H's balanced design (:func:`mt_tpose_reference`'s
    arguments): every list cut into work items of ``per_item`` entries
    (None: TPOSE_ITEM_SIZE, the kernel's), each item's (t, pid)
    lexicographic best, merged per ray by minimum key in the item order
    ``order`` (``packet_trace.mt_trace_split_reference`` on the table
    read as ``[Nc, tc, 9]``).  Equal to the twin bit for bit in every
    order."""
    return pt.mt_trace_split_reference(
        table[:, :9, :].transpose(1, 2), rays.permute(1, 0, 2), ids, counts,
        t_min=t_min, t_max=t_max, eps=eps, mode="closest",
        per_item=TPOSE_ITEM_SIZE if per_item is None else per_item, order=order,
    )


def mt_tpose(
    table: torch.Tensor,
    rays: torch.Tensor,
    ids: torch.Tensor,
    counts: torch.Tensor,
    *,
    t_min: float,
    t_max: float,
    eps: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel H (csrc/mt_tpose.cu) -> (t [T, r], pid [T, r] int32): the
    closest hit of each ray over its tile's listed chunks, ties to the
    smallest pid; misses (t_max + 1, 0).  CPU tensors run
    :func:`mt_tpose_reference`; CUDA tensors launch the kernel: balanced
    work items of TPOSE_ITEM_SIZE entries with an exact (t, pid) merge,
    two launches (see :func:`mt_tpose_split_reference`)."""
    kw = dict(t_min=t_min, t_max=t_max, eps=eps)
    if not rays.is_cuda:
        return mt_tpose_reference(table, rays, ids, counts, **kw)
    nc, tc = table.shape[0], table.shape[2]
    n_tiles, r = rays.shape[0], rays.shape[2]
    dev = rays.device
    cuda.check("table", table, torch.float32, (nc, 16, tc), dev)
    cuda.check("rays", rays, torch.float32, (n_tiles, 8, r), dev)
    cuda.check("ids", ids, torch.int32, (n_tiles, nc), dev)
    cuda.check("counts", counts, torch.int32, (n_tiles,), dev)
    if r % 32 or r > 1024:
        raise ValueError(f"ray tile {r} must be a multiple of 32 <= 1024")
    out_t = torch.empty((n_tiles, r), dtype=torch.float32, device=dev)
    out_pid = torch.empty((n_tiles, r), dtype=torch.int32, device=dev)
    # The balanced design's scratch (csrc/mt_items.cuh), set by the kernel.
    keys = torch.empty((n_tiles, r), dtype=torch.int64, device=dev)
    work = torch.empty((4 * n_tiles + 4,), dtype=torch.int32, device=dev)
    cuda.call(
        "mt_tpose", "rt_mt_tpose",
        rays.data_ptr(), table.data_ptr(), ids.data_ptr(), counts.data_ptr(),
        out_t.data_ptr(), out_pid.data_ptr(), keys.data_ptr(), work.data_ptr(),
        n_tiles, r, nc, tc, float(t_min), float(t_max), float(eps),
        float(np.float32(t_max + 1.0)),
    )
    return out_t, out_pid


def packet_closest_hit_t(
    tables: TposeTables,
    o: torch.Tensor,  # [N, 3]
    d: torch.Tensor,  # [N, 3]
    excl: torch.Tensor,  # [N] int32
    valid: torch.Tensor | None = None,  # [N] bool
    t_cap: torch.Tensor | None = None,  # [N] (culling only)
    *,
    t_min: float,
    t_max: float,
    eps: float,
    ray_tile: int = 256,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Closest hit of a flat ray batch over the transposed table -> (t
    [N], pid [N] int32), the flat intersect contract."""
    comp, bmin, bmax, _ = tables
    s = probe_rays(
        o, d, excl, valid, t_cap, bmin, bmax, t_min=t_min, t_max=t_max, ray_tile=ray_tile
    )
    t, pid = mt_tpose(comp, s.rays, s.ids, s.counts, t_min=t_min, t_max=t_max, eps=eps)
    return t.reshape(-1)[: s.n], pid.reshape(-1)[: s.n]

"""BVH backend: flat-array bounding volume hierarchy.

Counterpart of ``rt_rs_tpu/handlers/bvh.py`` (reference: ``BvhIntrs``,
``src/lib/handlers/bvh.rs``):

* the configuration mirrors ``BvhConfig``: a precomputed checkpoint
  (``data`` / ``path``), a runtime ``eps``, or the defaults ``eps =
  0.02``, ``target_item_count = 2`` (``bvh.rs:12-16, 31-39, 82``);
* the scene's prims are reordered so every leaf's triangles are
  contiguous (``bvh.rs:103-110``; :func:`reorder_scene_arrays`);
* ``stats`` reports the 48-byte-per-node footprint (``bvh.rs:160-163``).

Traversal is the JAX package's stackless threaded walk over the
preorder escape links (:meth:`~rt_rs_tpu_torch.bvh.BvhData.escape_links`)
on the recomputed covering bounds (``cover_bounds``); kernel G
(:func:`rt_rs_tpu_torch.ops.bvh_walk.bvh_walk_tiled`) walks the same
tree packed once at build into wide records
(:mod:`rt_rs_tpu_torch.bvh.wide`) and returns the same hits, on ray
tiles in closest-hit, emit-rows and any-hit modes; the flat path pads
its rays into tiles and takes the closest mode.  ``backend="packet"``
routes intersection through the pbvh packet kernels over the same
leaf-ordered prims instead (the same hits, ids included).  ``"auto"``
walks on every device (:func:`use_packet`): on the card the walk is the
faster of the two at every scene size measured, and the packet kernels
stay reachable through ``backend="packet"`` and the ``pbvh`` handler.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import numpy as np
import torch

from rt_rs_tpu_torch.bvh import BvhData, build_bvh
from rt_rs_tpu_torch.bvh.wide import WalkTree, walk_tree
from rt_rs_tpu_torch.config import ComputeConfig
from rt_rs_tpu_torch.handlers.base import IntrsHandler, IntrsStats, tiled_as_flat
from rt_rs_tpu_torch.ops import bvh_walk
from rt_rs_tpu_torch.ops import packet_trace as pt
from rt_rs_tpu_torch.scene import Scene
from rt_rs_tpu_torch.scene.arrays import SceneArrays

BACKENDS = ("auto", "threaded", "packet")
REFINE_MODES = ("off", "bounces", "all")


def check_modes(backend: str, refine: str) -> None:
    """Reject a ``backend`` or ``refine`` value no tree handler takes."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of {BACKENDS}")
    if refine not in REFINE_MODES:
        raise ValueError(f"unknown refine mode {refine!r}")


def reorder_scene_arrays(arrays: SceneArrays, indices: np.ndarray) -> SceneArrays:
    """Apply the leaf-contiguous prim permutation (bvh.rs:103-110),
    keeping the null sentinel at row 0 and accounting for its +1
    offset.  Rows past the last clamp to it, as the JAX package's
    gathers do: a scene with no prims has an unloaded pseudo-leaf that
    names a prim 0 it does not have, and takes a copy of the null row
    (a degenerate triangle no ray hits)."""
    perm = np.concatenate([[0], np.asarray(indices, dtype=np.int64) + 1])
    perm = np.minimum(perm, arrays.pa.shape[0] - 1)
    perm_t = torch.from_numpy(perm).to(arrays.device)
    return dataclasses.replace(
        arrays,
        prim_mat=arrays.prim_mat[perm_t],
        pa=arrays.pa[perm_t],
        pb=arrays.pb[perm_t],
        pc=arrays.pc[perm_t],
        na=arrays.na[perm_t],
        nb=arrays.nb[perm_t],
        nc=arrays.nc[perm_t],
        shade_table=arrays.shade_table[perm_t],
    )


@dataclasses.dataclass(frozen=True)
class BvhArrays:
    """Device-resident flattened BVH (the group(3) bind equivalent)."""

    node_min: torch.Tensor  # [N, 3] float32 (covering bounds)
    node_max: torch.Tensor  # [N, 3]
    hit_link: torch.Tensor  # [N] int32 (leaf -> escape, interior -> fst)
    miss_link: torch.Tensor  # [N] int32 (escape; num_nodes = END)
    leaf_start: torch.Tensor  # [N] int32 first prim id (reordered, +1 for null)
    leaf_count: torch.Tensor  # [N] int32 (0 = interior)
    num_nodes: int
    footprint: int


def accel_from_bvh_data(data: BvhData, scene: Scene, device: torch.device) -> BvhArrays:
    """The walk's tensors on ``device``.  Traversal uses the recomputed
    covering bounds, never the stored ones: the reference's in-place
    shrink leaves stored bounds that do not cover their subtree
    (``BvhData.cover_bounds``)."""
    hit_link, miss_link = data.escape_links()
    cover_min, cover_max = data.cover_bounds(scene)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return BvhArrays(
        node_min=dev(cover_min),
        node_max=dev(cover_max),
        hit_link=dev(hit_link),
        miss_link=dev(miss_link),
        leaf_start=dev(data.item_idx.astype(np.int32) + 1),
        leaf_count=dev(data.item_count.astype(np.int32)),
        num_nodes=data.num_nodes,
        footprint=data.byte_size(),
    )


@dataclasses.dataclass(frozen=True)
class BvhAccel:
    """The node structure plus the packet backend's chunk table or the
    threaded walk's packed tree (the other None); kept here, not on the
    handler, so one handler can serve several Renderers."""

    nodes: BvhArrays
    chunks: pt.TriChunks | None = None
    walk: WalkTree | None = None


def use_packet(backend: str, num_prims: int, device: torch.device) -> bool:
    """The ``backend`` rule of ``bvh``: the packet kernels for
    ``"packet"`` alone; ``"auto"`` and ``"threaded"`` take kernel G's
    walk whatever the scene's size and the device.  The JAX package's
    rule (``handlers/bvh.py:162-173``) takes the packet kernels on its
    accelerator within 12,288 triangles, a cap set by the TPU's VMEM
    byte model that says nothing of this card; on the H100 the walk
    renders the teatime scene (6,322 triangles) chained in a quarter of
    the packet kernels' frame time at 1920x1080 and in less at 384x288,
    with the same bits.  ``num_prims`` and ``device`` are the rule's
    inputs in both packages; neither changes this one's answer.
    (``rf_bvh`` has a rule of its own: ``handlers/rf.py``.)"""
    return backend == "packet"


class TreeIntrs(IntrsHandler):
    """``bvh``'s intersect entries, in closest-hit, emit-rows and any-hit
    modes (``rf_bvh`` overrides the tiled ones and reuses the packet
    ones): where ``accel.walk`` holds the threaded walk's tree, kernel
    G's tiled entry in its three modes (the rows read from the scene's
    shade table, passed at each call, so the accel holds no copy of it);
    where ``accel.chunks`` holds the packet backend's resident table
    (built in leaf order), the pbvh kernels, tagged with the ``refine``
    policy.  Either way a frame takes the emit branch of ``trace_tiled``
    unless ``force_rows=False``.  The flat path of a walked accel (both
    handlers) takes the tiled closest entry on its rays padded into
    tiles."""

    block_lanes = pt.TUNED_RAY_TILE  # rays per tile (the walk is order-free)
    refine: str

    def intersect_fn(self, accel, arrays: SceneArrays, cfg: ComputeConfig):
        if accel.chunks is not None:
            return partial(
                pt.packet_closest_hit, accel.chunks,
                t_min=cfg.t_min, t_max=cfg.t_max, eps=cfg.eps, ray_tile=pt.TUNED_RAY_TILE,
            )
        return tiled_as_flat(self.intersect_tiled_fn(accel, arrays, cfg), self.block_lanes)

    def _packet(self, accel, cfg: ComputeConfig, **mode):
        fn = partial(
            pt.packet_closest_hit_tiled, accel.chunks,
            t_min=cfg.t_min, t_max=cfg.t_max, eps=cfg.eps, **mode,
        )
        return pt.tag_refine(fn, self.refine)

    def intersect_tiled_fn(self, accel, arrays: SceneArrays, cfg: ComputeConfig):
        if accel.chunks is not None:
            return self._packet(accel, cfg)
        return walk_tiled_fn(accel.walk, cfg, "closest")

    def intersect_tiled_rows_fn(self, accel, arrays: SceneArrays, cfg: ComputeConfig):
        if accel.walk is not None:
            return walk_tiled_fn(accel.walk, cfg, "rows", arrays.shade_table.contiguous())
        chunks = accel.chunks
        if chunks is None or chunks.attr is None or not pt.resident_fits(chunks, with_attrs=True):
            return None
        return self._packet(accel, cfg, emit_rows=True)

    def intersect_tiled_anyhit_fn(self, accel, arrays: SceneArrays, cfg: ComputeConfig):
        if accel.walk is not None:
            return walk_tiled_fn(accel.walk, cfg, "anyhit")
        if accel.chunks is None:
            return None
        return self._packet(accel, cfg, any_hit=True)


def packet_chunks(arrays: SceneArrays) -> pt.TriChunks:
    """The packet backend's resident chunk table (with shade rows) over
    leaf-ordered ``arrays``; raises past the resident cap, as the JAX
    package's ``build_tri_chunks`` does."""
    return pt.build_tri_chunks(
        arrays.pa.cpu().numpy(), arrays.pb.cpu().numpy(), arrays.pc.cpu().numpy(),
        tri_chunk=pt.TUNED_TRI_CHUNK,
        shade_rows=arrays.shade_table.cpu().numpy(),
        device=arrays.device,
    )


class BvhIntrs(TreeIntrs):
    name = "BVH"

    def __init__(
        self,
        eps: float = 0.02,
        target_item_count: int = 2,
        data: BvhData | None = None,
        path: str | None = None,
        backend: str = "auto",
        refine: str = "bounces",
    ):
        """``BvhConfig`` parity: ``path`` / ``data`` = ``Bytes`` (a
        precomputed checkpoint, bvh.rs:54-64), ``eps`` = ``Runtime``,
        neither = ``Default``.  ``backend``: ``"threaded"`` (kernel G's
        walk), ``"packet"`` (the pbvh kernels over the same leaf-ordered
        prims; the BVH still fixes the order) or ``"auto"``, the walk on
        every device (:func:`use_packet`; the JAX package's packet cap
        is its TPU's VMEM model, not this card's).  ``refine``: the
        packet backend's per-ray cull policy (see ``PacketBvhIntrs``)."""
        check_modes(backend, refine)
        self.eps = eps
        self.target_item_count = target_item_count
        self._data = BvhData.load(path) if path is not None else data
        self.bvh_data: BvhData | None = self._data
        self.backend = backend
        self.refine = refine

    def build(self, scene: Scene, arrays: SceneArrays):
        data = self._data
        if data is None:
            data = build_bvh(scene, eps=self.eps, target_item_count=self.target_item_count)
        self.bvh_data = data
        nodes = accel_from_bvh_data(data, scene, arrays.device)
        arrays = reorder_scene_arrays(arrays, data.indices)
        if use_packet(self.backend, scene.num_prims, arrays.device):
            return BvhAccel(nodes=nodes, chunks=packet_chunks(arrays)), arrays
        tree = (
            nodes.node_min, nodes.node_max, nodes.hit_link, nodes.miss_link, nodes.leaf_count,
            nodes.leaf_start, *walk_prims(arrays),
        )
        return BvhAccel(nodes=nodes, walk=walk_tree(tree, payload=False)), arrays

    def stats(self, accel: BvhAccel) -> IntrsStats:
        return IntrsStats(name="BVH", size=accel.nodes.footprint)


def walk_prims(arrays: SceneArrays) -> tuple[torch.Tensor, ...]:
    """The corners (pa, pb, pc) the threaded walk tests, contiguous."""
    return tuple(x.contiguous() for x in (arrays.pa, arrays.pb, arrays.pc))


def walk_tiled_fn(tree: WalkTree, cfg: ComputeConfig, mode: str, table: torch.Tensor | None = None):
    """Kernel G's tiled entry in ``mode`` (``bvh_walk.WALK_MODES``) as a
    tiled intersect entry ``(payload, valid, t_cap=None)``; ``table``
    the shade table of the rows mode.  ``t_cap`` is accepted and
    ignored, as in the JAX walk: the any-hit mode reads each ray's cap
    from payload row 7."""

    def walk(payload, valid, t_cap=None):
        return bvh_walk.bvh_walk_tiled(
            payload.contiguous(), valid.contiguous(), tree, t_min=cfg.t_min, t_max=cfg.t_max,
            eps=cfg.eps, mode=mode, table=table,
        )

    return walk

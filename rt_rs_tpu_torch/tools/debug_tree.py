"""``debug_tree``: recursive BVH / RF-BVH tree dumps and checks
(counterpart of ``rt_rs_tpu/tools/debug_tree.py``).

The analogue of the reference's manual-inspection printers
``debug_aabb`` / ``debug_rf_aabb`` (``src/lib/handlers/rf.rs:246-344``):
an indented preorder walk printing ``Node [min] [max]`` for interior
nodes and ``Leaf [min] [max]: [items]`` for leaves, in the same
``{:.3}`` float format.  The RF dump decodes the packed 16-byte records
(f16 bounds, tagged children, 8-slot leaf payloads) so the packed tree
can be eyeballed against the plain one.

Usage::

    python -m rt_rs_tpu_torch.tools.debug_tree --scene scenes/teatime.json
    python -m rt_rs_tpu_torch.tools.debug_tree --bvh scenes/teatime.bvh.json
    python -m rt_rs_tpu_torch.tools.debug_tree --scene ... --rf   # packed form
    python -m rt_rs_tpu_torch.tools.debug_tree --bvh ... --check  # invariants
"""

from __future__ import annotations

import argparse
import sys
from typing import TextIO

import numpy as np

from rt_rs_tpu_torch.bvh import BvhData, build_bvh
from rt_rs_tpu_torch.bvh.rf import pack_rf, unpack_rf
from rt_rs_tpu_torch.geom import v3
from rt_rs_tpu_torch.scene import Scene


def _fmt(vals) -> str:
    return "[{:.3f}, {:.3f}, {:.3f}]".format(*(float(v) for v in vals))


def _walk_preorder(emit, fst, snd) -> None:
    """Explicit-stack preorder walk (the visit order of the reference's
    recursion, rf.rs:247-290): device-built trees can be deeper than
    CPython's stack survives."""
    stack = [(0, 0)]
    while stack:
        curr, indent = stack.pop()
        if emit(curr, indent):
            # snd first, so that fst prints first
            stack.append((int(snd[curr]), indent + 1))
            stack.append((int(fst[curr]), indent + 1))


def debug_aabb(data: BvhData, out: TextIO | None = None) -> None:
    """Print a flattened plain BVH (``debug_aabb``, rf.rs:247-290) to
    ``out`` (None: the current ``sys.stdout``)."""
    out = out or sys.stdout

    def emit(curr: int, indent: int) -> bool:
        lo, hi = _fmt(data.bounds_min[curr]), _fmt(data.bounds_max[curr])
        count = int(data.item_count[curr])
        if count > 0:
            i0 = int(data.item_idx[curr])
            items = [int(x) for x in data.indices[i0 : i0 + count]]
            out.write(f"{' ' * indent} Leaf {lo} {hi}: {items}\n")
            return False
        out.write(f"{' ' * indent} Node {lo} {hi}\n")
        return True

    _walk_preorder(emit, data.fst, data.snd)


def debug_rf_aabb(rf, out: TextIO | None = None) -> None:
    """Print a packed RF-BVH (``debug_rf_aabb``, rf.rs:292-344)."""
    out = out or sys.stdout
    d = unpack_rf(rf)

    def emit(curr: int, indent: int) -> bool:
        lo, hi = _fmt(d["bmin"][curr]), _fmt(d["bmax"][curr])
        if d["is_leaf"][curr]:
            items = [int(x) for x in d["leaf_prims"][curr] if x != 0]
            out.write(f"{' ' * indent} Leaf {lo} {hi}: {items}\n")
            return False
        out.write(f"{' ' * indent} Node {lo} {hi}\n")
        return True

    _walk_preorder(emit, d["fst"], d["snd"])


def check_tree(data: BvhData, scene: Scene | None = None, out: TextIO | None = None) -> int:
    """Structural invariant checks over a flattened BVH -> violation
    count (0 = healthy):

    * every primitive appears in exactly one leaf (the leaves' ranges
      tile the indices, which are a permutation of the prim ids);
    * (with ``scene``) every child's covering bounds lie inside its
      parent's (the stored bounds need not: the reference's in-place
      shrink never refits, :meth:`BvhData.cover_bounds`), and geometry
      stats through :mod:`rt_rs_tpu_torch.geom.v3`: zero-area faces
      (NaN smooth normals) and the smallest interior angle.

    The report goes to ``out`` (None: the current ``sys.stdout``)."""
    out = out or sys.stdout
    bad = 0
    n = data.bounds_min.shape[0]
    if scene is not None:
        cover_min, cover_max = data.cover_bounds(scene)
        for curr in range(n):
            if int(data.item_count[curr]) > 0:
                continue
            for child in (int(data.fst[curr]), int(data.snd[curr])):
                if not (
                    (cover_min[curr] <= cover_min[child]).all()
                    and (cover_max[child] <= cover_max[curr]).all()
                ):
                    out.write(f"VIOLATION: child {child} cover bounds exceed parent {curr}\n")
                    bad += 1
    spans = sorted(
        (int(data.item_idx[curr]), int(data.item_count[curr]))
        for curr in range(n)
        if int(data.item_count[curr]) > 0
    )
    pos = 0
    for i0, count in spans:
        if i0 != pos:
            out.write(f"VIOLATION: leaf range gap/overlap at {i0}\n")
            bad += 1
        pos = i0 + count
    total = len(data.indices)
    if pos != total:
        out.write(f"VIOLATION: leaves cover {pos} of {total} slots\n")
        bad += 1
    ids = np.sort(np.asarray(data.indices))
    if not np.array_equal(ids, np.arange(total, dtype=ids.dtype)):
        out.write("VIOLATION: indices are not a permutation of prims\n")
        bad += 1

    if scene is not None:
        degenerate = 0
        min_angle = float("inf")
        for a, b, c in scene.prim_indices:
            pa = scene.vert_pos[int(a)].astype(float)
            pb = scene.vert_pos[int(b)].astype(float)
            pc = scene.vert_pos[int(c)].astype(float)
            if v3.mag(v3.cross(pb - pa, pc - pa)) == 0.0:
                degenerate += 1
                continue
            min_angle = min(
                min_angle, v3.angle(pa, pb, pc), v3.angle(pb, pc, pa), v3.angle(pc, pa, pb)
            )
        out.write(
            f"geometry: {degenerate} degenerate (zero-area) faces; min interior angle "
            f"{min_angle if min_angle != float('inf') else 0.0:.4f} rad\n"
        )
    out.write(f"check: {bad} violations\n")
    return bad


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="rt_rs_tpu_torch.tools.debug_tree")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--scene", help="scene JSON: build the BVH, then dump")
    src.add_argument("--bvh", help="precomputed *.bvh.json checkpoint")
    p.add_argument(
        "--rf", action="store_true",
        help="dump the packed RF record tree instead of the plain one",
    )
    p.add_argument(
        "--check", action="store_true",
        help="validate tree invariants instead of dumping; exit code = number of violations",
    )
    p.add_argument("--eps", type=float, default=0.02)
    p.add_argument(
        "--item-count", type=int, default=None,
        help="leaf target of the BVH build (default: 2 plain / 4 RF, like the reference handlers)",
    )
    args = p.parse_args(argv)

    scene = None
    if args.bvh:
        data = BvhData.load(args.bvh)
    else:
        scene = Scene.load(args.scene)
        target = args.item_count or (4 if args.rf else 2)
        data = build_bvh(scene, eps=args.eps, target_item_count=target)

    if args.check:
        return check_tree(data, scene)
    if args.rf:
        # With the scene at hand, pack truly covering bounds, as the rf
        # handler does (the stored shrunk bounds are a reference defect).
        cover = data.cover_bounds(scene) if scene is not None else (None, None)
        debug_rf_aabb(pack_rf(data, *cover))
    else:
        debug_aabb(data)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

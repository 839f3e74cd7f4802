"""Rank functions of tests/test_torch_parallel.py.

A rank started by ``rt_rs_tpu_torch.parallel.launch.run_ranks`` imports
its function by module name, so the functions live here and not in the
test file (which imports the JAX package).  This module imports the
port only.
"""

from __future__ import annotations

import sys

# name -> (mesh shape, scene, handler, handler kwargs, width, height,
# make_sharded_render kwargs, resident cap inside the rank or None)
CASES = {
    "naive image4": ((4,), "torus", "naive", {}, 32, 24, {}, None),
    "pbvh image4": ((4,), "torus", "pbvh", {}, 64, 64, {}, None),
    "pbvh image4 rows fixed16": (
        (4,), "torus", "pbvh", {}, 64, 64, {"force_rows": True, "fixed_wg": 16}, None,
    ),
    "naive image2": ((2,), "torus", "naive", {}, 16, 8, {}, None),
    "pbvh hybrid2x2 rows": ((2, 2), "torus", "pbvh", {"tri_chunk": 8}, 64, 32, {}, None),
    "pbvh hybrid2x2 gather": (
        (2, 2), "torus", "pbvh", {"tri_chunk": 8}, 64, 32, {"force_rows": False}, None,
    ),
    "pbvh hybrid1x3 padded": ((1, 3), "torus", "pbvh", {"tri_chunk": 8}, 32, 16, {}, None),
    "pbvh hybrid1x2 local segments": ((1, 2), "soup", "pbvh", {"tri_chunk": 8}, 32, 16, {}, 16),
    "flat image4": ((4,), "ghost", "pbvh", {}, 32, 16, {}, None),
    "bvh image4": ((4,), "torus", "bvh", {}, 32, 24, {}, None),
}
BOUNCES = 2
WORLD = 4


def make_scene(name: str):
    """A small scene built in code (the port's presets)."""
    from rt_rs_tpu_torch.scene import presets

    if name == "torus":
        return presets.torus_scene(segments=(12, 6))
    if name == "soup":
        return presets.random_soup(7, 600)
    if name == "ghost":
        return presets.torus_ghost()
    raise KeyError(name)


def resolution(width: int, height: int, kw: dict):
    from rt_rs_tpu_torch.config import Resolution

    wg = kw.get("fixed_wg")
    return Resolution.fixed(width, height, wg) if wg else Resolution.sized(width, height)


def _mesh(shape):
    from rt_rs_tpu_torch.parallel import hybrid_mesh, image_mesh

    return image_mesh(shape[0]) if len(shape) == 1 else hybrid_mesh(*shape)


def _frame(spec, meshes: dict):
    """One case on this rank -> (frame, luminance), or None outside
    its mesh."""
    from rt_rs_tpu_torch.config import ComputeConfig
    from rt_rs_tpu_torch.handlers import get_handler
    from rt_rs_tpu_torch.ops import packet_trace as pt
    from rt_rs_tpu_torch.parallel import make_sharded_render

    shape, scene_name, hname, hkw, w, h, kw, cap = spec
    if shape not in meshes:
        meshes[shape] = _mesh(shape)
    mesh = meshes[shape]
    if mesh is None:
        return None
    scene = make_scene(scene_name)
    handler = get_handler(hname, **hkw)
    accel, arrays = handler.build(scene, scene.pack(device=mesh.device))
    saved = pt.MAX_VMEM_CHUNKS
    if cap is not None:
        # A shard past the resident budget: its slice runs segmented.
        pt.MAX_VMEM_CHUNKS = cap
    try:
        fn = make_sharded_render(
            handler, accel, arrays, ComputeConfig(bounces=BOUNCES), w, h, mesh,
            resolution=resolution(w, h, kw), force_rows=kw.get("force_rows"),
        )
        frame, lum = fn(scene.camera.pos, scene.camera.at)
    finally:
        pt.MAX_VMEM_CHUNKS = saved
    return frame.numpy(), float(lum)


def _errors(meshes: dict) -> dict[str, str]:
    """The error cases -> name: the type raised (or "none")."""
    import torch

    from rt_rs_tpu_torch.config import ComputeConfig
    from rt_rs_tpu_torch.handlers import get_handler
    from rt_rs_tpu_torch.ops import packet_trace as pt
    from rt_rs_tpu_torch.parallel import (
        SCENE_AXIS,
        Mesh,
        hybrid_mesh,
        image_mesh,
        make_sharded_render,
    )

    cfg = ComputeConfig()
    torus = make_scene("torus")
    naive = get_handler("naive")
    n_accel, n_arrays = naive.build(torus, torus.pack(device="cpu"))
    image4, hybrid = meshes[(4,)], meshes[(2, 2)]
    ghost = make_scene("ghost")
    pbvh = get_handler("pbvh")
    g_accel, g_arrays = pbvh.build(ghost, ghost.pack(device="cpu"))
    scene_only = Mesh((SCENE_AXIS,), (4,), (image4.coords[0],), image4.device, image4.groups)
    huge = pt.TriChunks(
        comp=torch.zeros((1, 1, 9)).expand(1 << 24, 1, 9),
        bmin=torch.zeros((1, 3)).expand(1 << 24, 3),
        bmax=torch.zeros((1, 3)).expand(1 << 24, 3),
        num_chunks=1 << 24,
    )
    calls = {
        "height must divide": lambda: make_sharded_render(
            naive, n_accel, n_arrays, cfg, 16, 9, image4),
        "no rays axis": lambda: make_sharded_render(
            naive, n_accel, n_arrays, cfg, 16, 8, scene_only),
        "naive with shards": lambda: make_sharded_render(
            naive, n_accel, n_arrays, cfg, 16, 8, hybrid),
        "negative materials with shards": lambda: make_sharded_render(
            pbvh, g_accel, g_arrays, cfg, 16, 8, hybrid),
        "prim ids past 2^24": lambda: make_sharded_render(
            pbvh, huge, n_arrays, cfg, 16, 8, hybrid),
        "hybrid mesh larger than the world": lambda: hybrid_mesh(4, 2),
        "image mesh larger than the world": lambda: image_mesh(WORLD + 1),
    }
    out = {}
    for name, call in calls.items():
        try:
            call()
            out[name] = "none"
        except Exception as e:  # the type is the result
            out[name] = type(e).__name__
    return out


def render_cases(rank: int, names: list[str]) -> dict:
    """Every case of ``names`` on this rank, then the error cases ->
    {"frames": {name: (frame, lum)}, "errors": {...}, "modules": [...]}:
    the JAX modules this rank's interpreter holds (there must be
    none)."""
    meshes: dict = {}
    frames = {}
    for name in names:
        out = _frame(CASES[name], meshes)
        if out is not None:
            frames[name] = out
    for shape in ((4,), (2, 2)):
        if shape not in meshes:
            meshes[shape] = _mesh(shape)
    errors = _errors(meshes)
    modules = sorted(
        m for m in sys.modules
        if m in ("jax", "rt_rs_tpu") or m.startswith(("jax.", "rt_rs_tpu."))
    )
    return {"frames": frames, "errors": errors, "modules": modules, "rank": rank}


def fail_or_hang(rank: int, mode: str) -> int:
    """Rank 0 returns; rank 1 raises (``mode="raise"``) or sleeps past
    any test's timeout (``mode="hang"``)."""
    import time

    if rank == 1:
        if mode == "raise":
            raise ValueError("rank 1 fails on purpose")
        time.sleep(600)
    return rank

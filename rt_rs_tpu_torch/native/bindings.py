"""ctypes bindings for the native library.

Counterpart of ``rt_rs_tpu/native/bindings.py``.  The library is built
at first use (:mod:`rt_rs_tpu_torch.native.build`); a build that fails
raises, naming ``RT_NATIVE=0``, which selects the NumPy builder and the
Python OBJ parser instead (there is no silent fallback).
"""

from __future__ import annotations

import ctypes
import functools
import os

import numpy as np

from rt_rs_tpu_torch.native import build as _build


def available() -> bool:
    """Whether the native paths are selected: ``RT_NATIVE`` is not
    ``"0"``.  The library itself is built when first used."""
    return os.environ.get("RT_NATIVE", "1") != "0"


@functools.cache
def _load() -> ctypes.CDLL:
    """The loaded library (built at first call)."""
    lib = ctypes.CDLL(str(_build.build()))

    i64 = ctypes.c_int64
    p_i64 = ctypes.POINTER(i64)
    lib.rt_bvh_build.restype = ctypes.c_void_p
    lib.rt_bvh_build.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, i64, i64, ctypes.c_float, i64,
        p_i64, p_i64,
    ]
    lib.rt_bvh_read.restype = None
    lib.rt_bvh_read.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 7
    lib.rt_bvh_free.restype = None
    lib.rt_bvh_free.argtypes = [ctypes.c_void_p]

    lib.rt_obj_load.restype = ctypes.c_void_p
    lib.rt_obj_load.argtypes = [ctypes.c_char_p, p_i64, p_i64, p_i64]
    lib.rt_obj_read.restype = None
    lib.rt_obj_read.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 4
    lib.rt_obj_free.restype = None
    lib.rt_obj_free.argtypes = [ctypes.c_void_p]
    return lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def bvh_build_native(
    vert_pos: np.ndarray,  # [V, 3] float32
    prim_indices: np.ndarray,  # [P, 3] uint32
    eps: float,
    target_item_count: int,
) -> dict[str, np.ndarray]:
    """Native median-split build -> dict of flattened arrays (the exact
    ``BvhData`` fields)."""
    lib = _load()
    verts = np.ascontiguousarray(vert_pos, dtype=np.float32).reshape(-1, 3)
    idx = np.ascontiguousarray(prim_indices, dtype=np.uint32).reshape(-1, 3)
    if idx.size and int(idx.max()) >= verts.shape[0]:
        raise ValueError(
            f"prim index {int(idx.max())} out of range for {verts.shape[0]} vertices"
        )
    n_nodes = ctypes.c_int64()
    n_indices = ctypes.c_int64()
    handle = lib.rt_bvh_build(
        _ptr(verts), _ptr(idx),
        ctypes.c_int64(verts.shape[0]), ctypes.c_int64(idx.shape[0]),
        ctypes.c_float(eps), ctypes.c_int64(target_item_count),
        ctypes.byref(n_nodes), ctypes.byref(n_indices),
    )
    try:
        n = n_nodes.value
        k = n_indices.value
        fst = np.empty(n, dtype=np.uint32)
        snd = np.empty(n, dtype=np.uint32)
        item_idx = np.empty(n, dtype=np.uint32)
        item_count = np.empty(n, dtype=np.uint32)
        bmin = np.empty((n, 3), dtype=np.float32)
        bmax = np.empty((n, 3), dtype=np.float32)
        indices = np.empty(k, dtype=np.uint32)
        lib.rt_bvh_read(
            handle, _ptr(fst), _ptr(snd), _ptr(item_idx), _ptr(item_count),
            _ptr(bmin), _ptr(bmax), _ptr(indices),
        )
    finally:
        lib.rt_bvh_free(handle)
    return dict(
        fst=fst, snd=snd, item_idx=item_idx, item_count=item_count,
        bounds_min=bmin, bounds_max=bmax, indices=indices,
    )


def obj_load_native(path: str):
    """Native OBJ parse -> (positions [V,3] f64, normals [N,3] f64,
    tri_pos [T,3] i64, tri_norm [T,3] i64): faces fan-triangulated,
    -1 for a corner without a normal."""
    lib = _load()
    n_pos = ctypes.c_int64()
    n_norm = ctypes.c_int64()
    n_tris = ctypes.c_int64()
    handle = lib.rt_obj_load(
        os.fsencode(path), ctypes.byref(n_pos), ctypes.byref(n_norm), ctypes.byref(n_tris),
    )
    if not handle:
        raise FileNotFoundError(path)
    try:
        pos = np.empty((n_pos.value, 3), dtype=np.float64)
        norm = np.empty((max(n_norm.value, 1), 3), dtype=np.float64)
        tri_pos = np.empty((n_tris.value, 3), dtype=np.int64)
        tri_norm = np.empty((n_tris.value, 3), dtype=np.int64)
        lib.rt_obj_read(handle, _ptr(pos), _ptr(norm), _ptr(tri_pos), _ptr(tri_norm))
    finally:
        lib.rt_obj_free(handle)
    return pos, norm[: n_norm.value], tri_pos, tri_norm

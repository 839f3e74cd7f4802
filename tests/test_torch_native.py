"""rt_rs_tpu_torch.native: the C++ BVH builder and OBJ parser against
the NumPy builder and the Python parser.

The port builds its own copy of ``rt_native.cpp`` at first use (into
the gitignored ``rt_rs_tpu_torch/build/``); the JAX package's library
is never built or loaded here.  The native tree equals the port's NumPy
builder and the JAX package's NumPy oracle (``build_aabb_tree`` +
``BvhData.from_tree``) bit for bit, at the (eps, target) pairs of
tests/test_native.py.  The native OBJ parse equals the Python parser on
OBJ files written here.  ``RT_NATIVE=0`` selects the NumPy builder and
the Python parser; two processes that build at once end with one
working library.
"""

from __future__ import annotations

import pathlib
import subprocess
import sys

import numpy as np
import pytest

import rt_rs_tpu
from rt_rs_tpu.bvh import BvhData as JaxBvhData
from rt_rs_tpu.bvh import build_aabb_tree as jax_build_aabb_tree
from rt_rs_tpu_torch.bvh import BvhData, build_aabb_tree, build_bvh
from rt_rs_tpu_torch.native import bindings
from rt_rs_tpu_torch.native import build as native_build
from rt_rs_tpu_torch.scene import Scene
from rt_rs_tpu_torch.scene import obj as obj_mod
from rt_rs_tpu_torch.scene.presets import (
    deep_chain,
    random_soup,
    tiled_copies,
    torus_canyon,
    torus_scene,
)

ROOT = pathlib.Path(__file__).resolve().parent.parent
PARAMS = [(0.02, 2), (1.95, 2), (0.02, 4)]
FIELDS = ("fst", "snd", "item_idx", "item_count", "bounds_min", "bounds_max", "indices")

SCENES = {
    "torus": torus_scene,
    "canyon": torus_canyon,
    "soup 0": lambda: random_soup(0, 500),
    "soup 3": lambda: random_soup(3, 97, scale=0.5),
    "deep_chain": deep_chain,
    "coincident": lambda: tiled_copies(torus_scene(segments=(16, 8)), [(0.0, 0.0, 0.0)] * 3),
}


@pytest.fixture(scope="module", params=list(SCENES))
def scene(request) -> Scene:
    return SCENES[request.param]()


@pytest.mark.parametrize("eps, target", PARAMS)
def test_native_bvh_equals_numpy_builders(scene, eps, target):
    native = bindings.bvh_build_native(scene.vert_pos, scene.prim_indices, eps, target)
    ours = BvhData.from_tree(build_aabb_tree(scene, eps=eps, target_item_count=target))
    jscene = rt_rs_tpu.Scene.from_json(scene.to_json())
    ref = JaxBvhData.from_tree(jax_build_aabb_tree(jscene, eps=eps, target_item_count=target))
    for f in FIELDS:
        assert native[f].dtype == getattr(ours, f).dtype, f
        np.testing.assert_array_equal(native[f], getattr(ours, f), err_msg=f)
        np.testing.assert_array_equal(native[f], getattr(ref, f), err_msg=f)


OBJ_TEXT = {
    "positions only": """# a quad and a triangle
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
v 0.5 0.5 1.25
f 1 2 3 4
f 1 2 5
""",
    "with normals": """v -1.0 -1.0 0.5
v 1.0 -1.0 0.5
v 1.0 1.0 0.5
v -1.0 1.0 0.5
v 0.0 0.0 2.0
vn 0 0 -1
vn 0.0 0.70710678 0.70710678
vt 0.5 0.5
f 1//1 2//1 3//1 4//1
f 1/1/2 2/1/2 5/1/2
f 3/1 4/1 5/1
f -3//-1 -2//-2 -1//-1
""",
    "pentagon, tabs, blank lines": """
v\t0.1 0.2 0.3
v 1e-3 2.5E+1 -7.25
v 3.0000001 -0.0 4
v 5 6 7
v 8 9 10

vn 1 0 0
f 1 2 3 4 5
f\t5//1 4//1 3//1
""",
}


@pytest.mark.parametrize("name", list(OBJ_TEXT))
def test_native_obj_equals_python(tmp_path, name):
    path = tmp_path / "mesh.obj"
    path.write_text(OBJ_TEXT[name])
    py = obj_mod._load_obj_py(str(path))
    native = obj_mod.load_obj(str(path))
    np.testing.assert_array_equal(native.positions, py.positions)
    np.testing.assert_array_equal(native.normals, py.normals)
    py_tris = list(py.triangles())
    na_tris = list(native.triangles())
    assert len(na_tris) == len(py_tris) > 0
    for (pi, pn), (ni, nn) in zip(py_tris, na_tris):
        assert pi == ni
        for a, b in zip(pn, nn):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a, b)
    s_native, s_py = Scene.empty(), Scene.empty()
    s_native.add_mesh(native, 0)
    s_py.add_mesh(py, 0)
    np.testing.assert_array_equal(s_native.prim_indices, s_py.prim_indices)
    np.testing.assert_array_equal(s_native.vert_pos, s_py.vert_pos)
    np.testing.assert_array_equal(s_native.vert_norm, s_py.vert_norm)


def test_native_obj_missing_file(tmp_path):
    with pytest.raises(FileNotFoundError):
        bindings.obj_load_native(str(tmp_path / "absent.obj"))


def test_rt_native_0_takes_numpy_paths(tmp_path, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("native path taken")

    scene = torus_scene(segments=(12, 6))
    native = build_bvh(scene)
    monkeypatch.setattr(bindings, "bvh_build_native", refuse)
    monkeypatch.setattr(bindings, "obj_load_native", refuse)
    with pytest.raises(AssertionError):
        build_bvh(scene)
    monkeypatch.setenv("RT_NATIVE", "0")
    assert not bindings.available()
    numpy_built = build_bvh(scene)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(native, f), getattr(numpy_built, f))
    path = tmp_path / "m.obj"
    path.write_text(OBJ_TEXT["positions only"])
    assert obj_mod.load_obj(str(path)).faces == obj_mod._load_obj_py(str(path)).faces


def test_empty_scene_takes_numpy_path(monkeypatch):
    monkeypatch.setattr(bindings, "bvh_build_native", None)  # never called
    data = build_bvh(Scene.empty())
    assert data.num_nodes == 1


def test_failed_build_names_rt_native(tmp_path, monkeypatch):
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native_build, "SRC", bad)
    monkeypatch.setattr(native_build, "BUILD", tmp_path / "build")
    with pytest.raises(native_build.NativeBuildError, match="RT_NATIVE=0"):
        native_build.build()


CONCURRENT = """
import ctypes, pathlib, sys
from rt_rs_tpu_torch.native import build
build.BUILD = pathlib.Path(sys.argv[1])
lib = ctypes.CDLL(str(build.build()))
lib.rt_bvh_free.argtypes = [ctypes.c_void_p]
print(build.lib_path())
"""


def test_two_processes_build_one_library(tmp_path):
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", CONCURRENT, str(tmp_path)],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for _ in range(2)
    ]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [o[1] for o in outs]
    paths = {o[0].strip() for o in outs}
    assert len(paths) == 1
    lib = pathlib.Path(paths.pop())
    assert lib.exists() and lib.parent.parent == tmp_path
    assert [p.name for p in lib.parent.iterdir()] == [native_build.LIB_NAME]

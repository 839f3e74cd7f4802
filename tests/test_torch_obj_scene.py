"""rt_rs_tpu_torch's OBJ import (``scene/obj.py``, ``Scene.add_mesh``)
and the unloaded placeholder scene against the JAX package's.

The OBJ files are written by the tests (the bundled meshes live in the
absent reference checkout): a tetrahedron with and without normals, a
quad and a pentagon (fan triangulation), negative indices, corners with
and without normals in one face, and a degenerate face whose corner
angles are NaN.  Parsing and ``add_mesh`` are host arithmetic in the
reference's f32 operation order in both packages: every array is
bit-equal (NaN where the other is NaN).  ``load_obj`` takes the native
parser unless ``RT_NATIVE=0``; both of its paths are held to the JAX
package's Python parser.
"""

from __future__ import annotations

import os
import warnings

import numpy as np
import pytest
import torch

import rt_rs_tpu
from rt_rs_tpu.scene import obj as jobj
from rt_rs_tpu_torch import ComputeConfig, Config, Renderer, Resolution, Scene
from rt_rs_tpu_torch.geom import SceneFormatError
from rt_rs_tpu_torch.scene import obj
from rt_rs_tpu_torch.scene.camera import CameraController, CameraUniform
from rt_rs_tpu_torch.scene.presets import torus_scene

torch.set_num_threads(
    max(1, (os.cpu_count() or 1) // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))
)

OBJS = {
    "tetra": """
# a tetrahedron, no normals
v 0 0 0
v 1 0 0
v 0 1 0
v 0 0 1
f 1 3 2
f 1 2 4
f 1 4 3
f 2 3 4
""",
    "tetra_normals": """
v 0.0 0.0 0.0
v 1.5 0.0 0.0
v 0.0 1.25 0.0
v 0.0 0.0 0.75
vt 0 0
vt 1 0
vn 0 0 -1
vn 0 -1 0
vn -1 0 0
vn 0.577350 0.577350 0.577350

f 1//1 3//1 2//1
f 1/1/2 2/2/2 4/1/2
f 1//3 4//3 3//3
f 2/1/4 3/2/4 4/1/4
""",
    "fans": """
v 0 0 0
v 2 0 0
v 2 1.5 0
v 0 1.5 0.25
v 3 0 1
v 4 1 1
v 3.5 2 1.5
v 2.5 2 1
v 2 1 0.7
f 1 2 3 4
f 5/1 6/2 7/3 8/4 9/5
f 1 2
""",
    "negative": """
v -1 -1 0.5
v 1 -1 0.5
v 1 1 0.25
v -1 1 0
f -4 -3 -2
vn 0 0 1
f -4//-1 -2//-1 -1
v 0.1 0.2 3.3
f -5 -1 -3
""",
    "degenerate": """
v 0 0 0
v 1 0 0
v 2 0 0
v 0 1 0
f 1 2 3
f 1 1 4
f 1 2 4
""",
}


@pytest.fixture(params=sorted(OBJS))
def obj_path(request, tmp_path):
    path = tmp_path / f"{request.param}.obj"
    path.write_text(OBJS[request.param])
    return str(path)


def test_load_obj_matches_jax(obj_path, monkeypatch):
    """``load_obj`` against the JAX package's Python parser, on both of
    its paths: the native parser (the default), whose faces are the
    fan triangles, as the JAX package's native path lists them, and
    ``RT_NATIVE=0``'s Python parser, whose faces are the file's."""
    ref = jobj._load_obj_py(obj_path)
    native = obj.load_obj(obj_path)
    monkeypatch.setenv("RT_NATIVE", "0")
    py = obj.load_obj(obj_path)
    assert py.faces == ref.faces
    fans = [[face[0], face[k], face[k + 1]] for face in ref.faces for k in range(1, len(face) - 1)]
    assert native.faces == fans
    want = list(ref.triangles())
    for ours in (native, py):
        for f in ("positions", "normals"):
            a, b = getattr(ours, f), getattr(ref, f)
            assert a.dtype == b.dtype == np.float64 and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
        got = list(ours.triangles())
        assert [i for i, _ in got] == [i for i, _ in want] and got
        for (_, n1), (_, n2) in zip(got, want, strict=True):
            for a, b in zip(n1, n2, strict=True):
                assert (a is None and b is None) or np.array_equal(a, b)


def _scenes():
    """A port scene and the JAX package's, both holding torus_scene's
    vertices first (so add_mesh appends at a non-zero base)."""
    base = torus_scene()
    return base, rt_rs_tpu.Scene.from_json(base.to_json())


FIELDS = ("vert_pos", "vert_norm", "prim_indices", "prim_material")


def test_add_mesh_matches_jax(obj_path):
    ours, ref = _scenes()
    ours.add_mesh(obj.load_obj(obj_path), 2)
    ref.add_mesh(jobj._load_obj_py(obj_path), 2)
    for f in FIELDS:
        a, b = getattr(ours, f), getattr(ref, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def test_add_mesh_fan_and_normals(tmp_path):
    """The fan's triangle count, the appended indices' base, given
    normals taken unscaled and renormalized, NaN only from a degenerate
    corner."""
    paths = {}
    for name in ("fans", "tetra_normals", "degenerate"):
        paths[name] = str(tmp_path / f"{name}.obj")
        (tmp_path / f"{name}.obj").write_text(OBJS[name])
    scene = Scene.empty()
    scene.add_mesh(obj.load_obj(paths["fans"]), 0)
    assert scene.num_prims == 2 + 3 and scene.num_vertices == 9  # quad 2, pentagon 3
    np.testing.assert_array_equal(scene.prim_indices[:2], [[0, 1, 2], [0, 2, 3]])
    n = np.linalg.norm(scene.vert_norm, axis=1)
    np.testing.assert_allclose(n, 1.0, rtol=1e-6)
    scene.add_mesh(obj.load_obj(paths["tetra_normals"]), 1)
    assert scene.prim_indices.min(initial=99) == 0 and (scene.prim_indices[5:] >= 9).all()
    assert (scene.prim_material[5:] == 1).all()
    # Vertex 1 is in faces with the given normals 1, 2 and 3: their sum, renormalized.
    np.testing.assert_allclose(scene.vert_norm[9], np.full(3, -1.0 / np.sqrt(3.0)), rtol=1e-6)
    bad = Scene.empty()
    bad.add_mesh(obj.load_obj(paths["degenerate"]), 0)
    assert np.isnan(bad.vert_norm).any() and np.isfinite(bad.vert_pos).all()


def test_parse_index():
    assert obj._parse_index("3", 10) == jobj._parse_index("3", 10) == 2
    assert obj._parse_index("-1", 10) == jobj._parse_index("-1", 10) == 9


def _config(width: int, height: int) -> Config:
    return Config(compute=ComputeConfig(), resolution=Resolution.sized(width, height))


def test_unloaded_scene_matches_jax_and_renders_black(tmp_path):
    ours, ref = Scene.unloaded(), rt_rs_tpu.Scene.unloaded()
    assert ours.is_unloaded and ref.is_unloaded and not Scene.empty().is_unloaded
    for f in FIELDS + ("light_pos", "light_strength", "mat_color", "mat_albedo", "mat_spec"):
        a, b = getattr(ours, f), getattr(ref, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert ours.camera.pos == ours.camera.at  # the placeholder's NaN rays
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # no pos == at warning for the placeholder
        frames = [
            Renderer(ours, config=_config(16, 8), handler=h, device="cpu").render_frame()
            for h in ("bvh", "rf_bvh", "pbvh", "naive")
        ]
    for f in frames:
        assert f.shape == (8, 16, 3) and not f.any()
    with pytest.raises(SceneFormatError, match="unloaded"):
        ours.to_json()
    with pytest.raises(SceneFormatError):
        ours.save(str(tmp_path / "unloaded.json"))


def test_pos_at_warning_kept_for_loaded_scenes():
    scene = Scene.empty(camera=CameraUniform((1.0, 2.0, 3.0), (1.0, 2.0, 3.0)),
                        camera_controller=CameraController("Fixed"))
    scene.add_mesh(obj.ObjMesh(np.eye(3), np.zeros((0, 3)), [[(0, -1), (1, -1), (2, -1)]]), 0)
    scene.mat_color = np.ones((1, 3), np.float32)
    scene.mat_albedo = np.ones((1, 3), np.float32)
    scene.mat_spec = np.zeros(1, np.float32)
    with pytest.warns(UserWarning, match="pos == at"):
        Renderer(scene, config=_config(8, 8), device="cpu")


def test_obj_scene_frame_matches_jax(tmp_path):
    """A scene built from an OBJ (a quad and a pentagon over the torus
    floor) renders the JAX package's frame, through both packages'
    default handler."""
    path = tmp_path / "fans.obj"
    path.write_text(OBJS["fans"])
    ours, ref = _scenes()
    ours.add_mesh(obj.load_obj(str(path)), 1)
    ref.add_mesh(jobj._load_obj_py(str(path)), 1)
    frame = Renderer(ours, config=_config(24, 16), device="cpu").render_frame().numpy()
    jr = rt_rs_tpu.Renderer(ref, config=rt_rs_tpu.Config(resolution=rt_rs_tpu.Resolution.sized(24, 16)))
    np.testing.assert_allclose(frame, np.asarray(jr.render_frame()), rtol=0, atol=2e-5)
    assert frame.mean() > 0.05

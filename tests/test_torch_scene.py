"""rt_rs_tpu_torch's host data layer against the JAX package's.

The port copies the JAX package's NumPy code (scene packing, the BVH
build, the leaf reorder, the chunk table), so every array must be
byte-equal.  Scenes are built in code (scene/presets.py) and reach the
JAX package through their JSON.
"""

from __future__ import annotations

import dataclasses
import inspect
import json
import os

import numpy as np
import pytest
import torch

import rt_rs_tpu
from rt_rs_tpu.bvh import build_bvh as jax_build_bvh
from rt_rs_tpu.handlers.bvh import reorder_scene_arrays as jax_reorder
from rt_rs_tpu.ops.pallas import packet_trace as jpt
from rt_rs_tpu.scene.arrays import intersect_indices as jax_intersect_indices
from rt_rs_tpu_torch import Config, Resolution, Scene, convert
from rt_rs_tpu_torch.bvh import BvhData, build_bvh
from rt_rs_tpu_torch.handlers.bvh import reorder_scene_arrays
from rt_rs_tpu_torch.handlers.pbvh import PacketBvhIntrs
from rt_rs_tpu_torch.ops import packet_trace as pt
from rt_rs_tpu_torch.scene.arrays import SceneArrays, intersect_indices
from rt_rs_tpu_torch.scene.presets import random_soup, torus_scene

# pytest-xdist runs several test processes at once; torch's default of
# one OpenMP thread per core in each of them oversubscribes the CPUs,
# and the spinning threads slowed these tests about tenfold.
torch.set_num_threads(
    max(1, (os.cpu_count() or 1) // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))
)

SCENES = {
    "torus": torus_scene,
    "soup": lambda: random_soup(11, 300),
    "small_torus": lambda: torus_scene(segments=(12, 6)),
}


def both(name: str):
    ours = SCENES[name]()
    return ours, rt_rs_tpu.Scene.from_json(ours.to_json())


def assert_arrays_equal(ours: SceneArrays, ref) -> None:
    for f in dataclasses.fields(SceneArrays):
        a, b = getattr(ours, f.name), getattr(ref, f.name)
        if f.name == "no_negative_materials":
            assert a == b
            continue
        a, b = a.cpu().numpy(), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, f.name
        assert a.tobytes() == b.tobytes(), f.name


@pytest.mark.parametrize("name", sorted(SCENES))
def test_pack_byte_equal(name):
    ours, ref = both(name)
    assert_arrays_equal(ours.pack(device="cpu"), ref.pack())


def test_torus_size():
    scene = torus_scene()
    assert scene.num_prims == 6_322  # teatime's 6,320 + the floor
    assert scene.light_pos.shape == (2, 3)
    assert scene.camera_controller.to_json() == "Orbit"


def test_duplicate_triples_collapse_like_jax():
    idx = np.array([[0, 1, 2], [3, 4, 5], [0, 1, 2], [2, 1, 0], [3, 4, 5]], np.uint32)
    np.testing.assert_array_equal(intersect_indices(idx), jax_intersect_indices(idx))
    no_dup = idx[:2]
    assert intersect_indices(no_dup) is no_dup  # identity without duplicates
    scene = random_soup(2, 6)
    scene.prim_indices = np.concatenate([scene.prim_indices, scene.prim_indices[:2]])
    scene.prim_material = np.zeros(scene.num_prims, np.int32)
    ref = rt_rs_tpu.Scene.from_json(scene.to_json())
    assert_arrays_equal(scene.pack(device="cpu"), ref.pack())


@pytest.mark.parametrize("name", sorted(SCENES))
def test_bvh_and_reorder_identical(name):
    ours, ref = both(name)
    data, jdata = build_bvh(ours), jax_build_bvh(ref)
    for f in dataclasses.fields(BvhData):
        a, b = getattr(data, f.name), getattr(jdata, f.name)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f.name
    assert_arrays_equal(
        reorder_scene_arrays(ours.pack(device="cpu"), data.indices),
        jax_reorder(ref.pack(), jdata.indices),
    )


def test_bvh_json_round_trip(tmp_path):
    data = build_bvh(torus_scene(segments=(12, 6)))
    path = tmp_path / "t.bvh.json"
    data.save(str(path))
    back = BvhData.load(str(path))
    jback = rt_rs_tpu.bvh.BvhData.load(str(path))
    for f in dataclasses.fields(BvhData):
        assert getattr(back, f.name).tobytes() == getattr(data, f.name).tobytes()
        assert getattr(jback, f.name).tobytes() == getattr(data, f.name).tobytes()


@pytest.mark.parametrize("name", ["torus", "soup"])
def test_tri_chunks_byte_equal_through_convert(name):
    ours, ref = both(name)
    _, arrays = PacketBvhIntrs().build(ours, ours.pack(device="cpu"))
    table = arrays.shade_table.numpy()
    corners = [arrays.pa.numpy(), arrays.pb.numpy(), arrays.pc.numpy()]
    mine = pt.build_tri_chunks(
        *corners, max_chunks=None, tri_chunk=64, shade_rows=table, device="cpu"
    )
    jc = jpt.build_tri_chunks(*corners, max_chunks=None, tri_chunk=64, shade_rows=table)
    theirs = convert.tri_chunks(
        jc.comp, jc.bmin, jc.bmax, jc.num_chunks, attr_t=jc.attr_t, device="cpu"
    )
    assert mine.num_chunks == theirs.num_chunks == jc.num_chunks
    assert mine.num_chunks % pt.CHUNK_ALIGN == 0
    for f in ("comp", "bmin", "bmax", "attr"):
        a, b = getattr(mine, f).numpy(), getattr(theirs, f).numpy()
        assert a.shape == b.shape and a.tobytes() == b.tobytes(), f
    # The port's rows table is the reordered shade table (zero row 0).
    np.testing.assert_array_equal(mine.attr[1 : table.shape[0]].numpy(), table[1:])
    assert not mine.attr[0].any()
    assert pt.resident_fits(mine, with_attrs=True) == jpt.resident_fits(jc, with_attrs=True)
    assert pt.resident_fits(mine) == jpt.resident_fits(jc)


def test_tri_chunks_drop_rows_for_non_finite_table():
    scene = random_soup(5, 20)
    arrays = scene.pack(device="cpu")
    table = arrays.shade_table.numpy().copy()
    table[3, 10] = np.nan
    corners = [arrays.pa.numpy(), arrays.pb.numpy(), arrays.pc.numpy()]
    ours = pt.build_tri_chunks(*corners, tri_chunk=64, shade_rows=table, device="cpu")
    assert ours.attr is None
    assert jpt.build_tri_chunks(*corners, tri_chunk=64, shade_rows=table).attr_t is None


@pytest.mark.parametrize(
    "fn",
    [Scene.pack, pt.build_tri_chunks, convert.scene_arrays, convert.tri_chunks,
     convert.segmented_chunks],
    ids=lambda f: f.__qualname__,
)
def test_device_is_a_required_keyword(fn):
    """Packing and conversion name their device: no CPU default."""
    p = inspect.signature(fn).parameters["device"]
    assert p.kind is inspect.Parameter.KEYWORD_ONLY and p.default is inspect.Parameter.empty


def test_convert_scene_arrays():
    _, ref = both("soup")
    assert_arrays_equal(convert.scene_arrays(ref.pack(), device="cpu"), ref.pack())


def test_json_round_trip_both_packages(tmp_path):
    scene = torus_scene(segments=(12, 6))
    path = tmp_path / "torus.json"
    scene.save(str(path))
    ours, ref = Scene.load(str(path)), rt_rs_tpu.Scene.load(str(path))
    assert_arrays_equal(ours.pack(device="cpu"), ref.pack())
    assert_arrays_equal(ours.pack(device="cpu"), scene.pack(device="cpu"))
    # And back: the JAX package's JSON loads in the port unchanged.
    again = Scene.from_json(json.loads(json.dumps(ref.to_json())))
    assert_arrays_equal(again.pack(device="cpu"), ref.pack())
    assert ours.camera == scene.camera


def test_config_and_block_parity():
    for res in (Resolution.sized(384, 288), Resolution.sized(1920, 1080), Resolution()):
        jres = rt_rs_tpu.Resolution(res.width, res.height, res.wg_hint)
        assert res.wg() == jres.wg()
        assert res.block(256) == jres.block(256) and res.block(128) == jres.block(128)
    data = {"compute": {"bounces": 2, "t_max": 50.0}, "resolution": 8}
    ours, ref = Config.from_json(data), rt_rs_tpu.Config.from_json(data)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)

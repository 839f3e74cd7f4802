"""The on-device LBVH of rt_rs_tpu_torch (``ops/lbvh.py``,
``bvh/device.py``, ``handlers/lbvh.py``) against the JAX package's.

The build is plain arithmetic on both sides (XLA code there, torch ops
here, no Pallas kernel): Morton codes, the stable sort, Karras'
hierarchy, the bounds refit, the preorder flatten and the chunk table
are bit-equal.  The centroid is ``(a + b + c) * f32(1/3)`` and the
quantization ``((c - lo) / max(hi - lo, 1e-30)) * 1024``: no product is
followed by a sum, so XLA:CPU has nothing to contract into an FMA.
Scenes: ``torus_scene`` (6,322 triangles), a soup with coincident
copies (equal codes: the stable sort and Karras' index tie-break), and
1, 2 and 3 triangles (the degenerate trees).

Frames of the ``lbvh`` handler against the JAX package's at atol 2e-5,
live (Pallas in interpret mode) at 32x24 and 37x23, and stored:
``tests/data/torch_port_lbvh_torus_96x72.npz`` holds its 96x72 frame of
``torus_scene``, rendered with XLA:CPU held to SSE4.2 (no FMA to
contract into, as for the other stored frames); ``chip_smoke.py`` holds
the card's frame to it.  Regenerate it with ``JAX_PLATFORMS=cpu
PYTHONPATH=. python tests/test_torch_lbvh.py``.
"""

from __future__ import annotations

import dataclasses
import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rt_rs_tpu
from rt_rs_tpu.bvh.device import build_bvh_device as jax_build_bvh_device
from rt_rs_tpu.handlers import lbvh as jlbvh
from rt_rs_tpu.ops import lbvh as jops
from rt_rs_tpu.ops.pallas import packet_trace as jpt
from rt_rs_tpu_torch import Config, Renderer, Resolution, convert
from rt_rs_tpu_torch.bvh.device import build_bvh_device
from rt_rs_tpu_torch.handlers import get_handler
from rt_rs_tpu_torch.handlers.lbvh import (
    LbvhIntrs,
    build_accel_device,
    chunk_footprint,
    device_chunks,
)
from rt_rs_tpu_torch.ops import lbvh
from rt_rs_tpu_torch.ops import packet_trace as pt
from rt_rs_tpu_torch.ops.lbvh import BIG
from rt_rs_tpu_torch.scene.presets import random_soup, torus_scene

torch.set_num_threads(
    max(1, (os.cpu_count() or 1) // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))
)

ROOT = pathlib.Path(__file__).resolve().parent.parent
LBVH_FRAME = ROOT / "tests" / "data" / "torch_port_lbvh_torus_96x72.npz"
ATOL = 2e-5
NAIVE_ATOL = 1e-5  # the JAX package's device-built tree vs naive (tests/test_lbvh.py)


def coincident_soup():
    """40 random triangles, then exact copies of the first 20 under new
    vertex indices (distinct prims with equal codes), then 4 copies of
    triangle 0 shrunk about its centroid (equal codes again)."""
    s = random_soup(5, 40)
    vp = s.vert_pos.reshape(40, 3, 3)
    cent = vp[:4].mean(axis=1, keepdims=True)
    shrunk = (cent + 0.5 * (vp[:1] - cent[:1])).astype(np.float32)
    s.vert_pos = np.concatenate([vp, vp[:20], np.repeat(shrunk, 4, axis=0)]).reshape(-1, 3)
    n = s.vert_pos.shape[0] // 3
    s.vert_norm = np.tile(np.array([[0, 1, 0]], np.float32), (n * 3, 1))
    s.prim_indices = np.arange(n * 3, dtype=np.uint32).reshape(-1, 3)
    s.prim_material = np.zeros(n, dtype=np.int32)
    return s


SCENES = {
    "torus": torus_scene,
    "coincident": coincident_soup,
    "n1": lambda: random_soup(11, 1),
    "n2": lambda: random_soup(12, 2),
    "n3": lambda: random_soup(13, 3),
}


def corners(scene):
    a = scene.pack(device="cpu")
    return a.pa[1:], a.pb[1:], a.pc[1:]


def jax_codes(a, b, c):
    """The JAX package's build prologue (handlers/lbvh.py, bvh/device.py)."""
    a, b, c = (jnp.asarray(x.numpy()) for x in (a, b, c))
    cent = (a + b + c) * jnp.float32(1.0 / 3.0)
    lo = jnp.min(jnp.minimum(jnp.minimum(a, b), c), axis=0)
    hi = jnp.max(jnp.maximum(jnp.maximum(a, b), c), axis=0)
    return jops.morton_codes(cent, lo, hi)


def same(ours: torch.Tensor, ref) -> None:
    ref = np.asarray(ref)
    got = ours.numpy()
    assert got.shape == ref.shape
    if ref.dtype == np.bool_:
        np.testing.assert_array_equal(got, ref)
    elif np.issubdtype(ref.dtype, np.integer):
        np.testing.assert_array_equal(got.astype(np.int64), ref.astype(np.int64))
    else:
        assert got.dtype == ref.dtype and got.tobytes() == ref.tobytes()


@pytest.mark.parametrize("name", SCENES)
def test_ops_bit_equal_to_jax(name):
    a, b, c = corners(SCENES[name]())
    codes = lbvh.centroid_codes(a, b, c)
    jcodes = jax_codes(a, b, c)
    same(codes, jcodes)
    order = lbvh.morton_order(codes)
    jorder = jops.morton_order(jcodes)
    same(order, jorder)
    o = order.long()
    if name == "coincident":
        sorted_codes = codes[o]
        assert (sorted_codes[1:] == sorted_codes[:-1]).sum() >= 20  # ties to break
    ours = lbvh.karras_hierarchy(codes[o])
    ref = jops.karras_hierarchy(jcodes[jorder])
    for x, y in zip(ours, ref, strict=True):
        same(x, y)
    lo = torch.minimum(torch.minimum(a, b), c)[o]
    hi = torch.maximum(torch.maximum(a, b), c)[o]
    for x, y in zip(
        lbvh.refit_bounds(*ours[:4], lo, hi),
        jops.refit_bounds(*ref[:4], jnp.asarray(lo.numpy()), jnp.asarray(hi.numpy())),
        strict=True,
    ):
        same(x, y)


def test_morton_codes_pin_nan_and_the_basics():
    """A NaN centroid component (a non-finite vertex) quantizes to 0, as
    XLA:CPU's float-to-uint32 conversion gives, and so does every
    component of an axis whose box is NaN; infinities clip."""
    cent = np.array(
        [[np.nan, 0.5, 0.5], [0.2, np.nan, 0.9], [np.inf, -np.inf, 0.3],
         [0, 0, 0], [1, 1, 1], [0.999, 0, 0], [0, 0.999, 0], [0, 0, 0.999]],
        dtype=np.float32,
    )
    for lo in (np.zeros(3, np.float32), np.array([np.nan, 0, 0], np.float32)):
        hi = np.ones(3, np.float32)
        ours = lbvh.morton_codes(*(torch.from_numpy(x) for x in (cent, lo, hi)))
        ref = jops.morton_codes(*(jnp.asarray(x) for x in (cent, lo, hi)))
        same(ours, ref)
        same(ours, jax.jit(jops.morton_codes)(*(jnp.asarray(x) for x in (cent, lo, hi))))
    codes = lbvh.morton_codes(torch.from_numpy(cent), torch.zeros(3), torch.ones(3)).tolist()
    assert codes[0] == lbvh.morton_codes(torch.tensor([[0.0, 0.5, 0.5]]), torch.zeros(3), torch.ones(3)).item()
    assert codes[3] == 0 and codes[4] == 0x3FFFFFFF and codes[5] > codes[6] > codes[7]


@pytest.mark.parametrize("name", SCENES)
def test_build_bvh_device_bit_equal_to_jax(name):
    scene = SCENES[name]()
    ours = build_bvh_device(scene, device="cpu")
    ref = jax_build_bvh_device(rt_rs_tpu.Scene.from_json(scene.to_json()))
    for f in dataclasses.fields(ours):
        x, y = getattr(ours, f.name), np.asarray(getattr(ref, f.name))
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), f.name
    assert ours.num_nodes == 2 * scene.num_prims - 1


def test_build_bvh_device_refuses_no_prims():
    empty = random_soup(1, 1)
    empty.prim_indices = empty.prim_indices[:0]
    empty.prim_material = empty.prim_material[:0]
    with pytest.raises(ValueError, match="no prims"):
        build_bvh_device(empty, device="cpu")
    with pytest.raises(ValueError, match="no prims"):
        jax_build_bvh_device(empty)


def test_device_built_tree_renders_through_both_tree_handlers():
    """The device-built torus tree drives the threaded ``bvh`` walk and
    pbvh to one frame, within the JAX package's bound of naive (at 16x12:
    the naive handler tests every triangle for every ray)."""
    scene = torus_scene()
    data = build_bvh_device(scene, device="cpu")
    cfg = Config(resolution=Resolution.sized(16, 12))
    walk = Renderer(scene, cfg, "bvh", {"data": data, "backend": "threaded"}, device="cpu").render_frame()
    packet = Renderer(scene, cfg, "pbvh", {"data": data}, device="cpu").render_frame()
    naive = Renderer(scene, cfg, "naive", device="cpu").render_frame()
    assert torch.equal(walk, packet)
    np.testing.assert_allclose(walk.numpy(), naive.numpy(), rtol=0, atol=NAIVE_ATOL)


@pytest.mark.parametrize("tc", [64, 32, 16])
def test_device_chunks_equal_host_builder(tc):
    """The device builder's table is the host builder's (components,
    rows table, bounds of every chunk holding a triangle); the chunks
    that hold none are inverted in both, at ±3e38 here (the JAX
    package's device builder) and at the f32 maximum there."""
    scene = torus_scene()
    arrays = scene.pack(device="cpu")
    ours = device_chunks(arrays.pa, arrays.pb, arrays.pc, tri_chunk=tc, shade_rows=arrays.shade_table)
    host = pt.build_tri_chunks(
        arrays.pa.numpy(), arrays.pb.numpy(), arrays.pc.numpy(), max_chunks=None,
        tri_chunk=tc, shade_rows=arrays.shade_table.numpy(), device="cpu",
    )
    assert ours.num_chunks == host.num_chunks
    assert torch.equal(ours.comp, host.comp) and torch.equal(ours.attr, host.attr)
    real = -(-(scene.num_prims) // tc)
    assert torch.equal(ours.bmin[:real], host.bmin[:real])
    assert torch.equal(ours.bmax[:real], host.bmax[:real])
    assert (ours.bmin[real:] == BIG).all() and (ours.bmax[real:] == -BIG).all()
    assert (host.bmin[real:] > host.bmax[real:]).all()


def test_build_accel_device_bit_equal_to_jax():
    scene = torus_scene()
    arrays = scene.pack(device="cpu")
    ours, permuted = build_accel_device(arrays, with_attrs=True)
    jarrays = rt_rs_tpu.Scene.from_json(scene.to_json()).pack()
    jchunks, jpermuted = jlbvh.build_accel_device(jarrays, with_attrs=True)
    ref = convert.tri_chunks(
        jchunks.comp, jchunks.bmin, jchunks.bmax, jchunks.num_chunks, attr_t=jchunks.attr_t,
        device="cpu",
    )
    for f in ("comp", "bmin", "bmax", "attr"):
        assert torch.equal(getattr(ours, f), getattr(ref, f)), f
    ref_arrays = convert.scene_arrays(jpermuted, device="cpu")
    for f in dataclasses.fields(permuted):
        x, y = getattr(permuted, f.name), getattr(ref_arrays, f.name)
        assert (x == y) if isinstance(x, bool) else torch.equal(x, y), f.name
    assert chunk_footprint(ours) == sum(
        t.numel() * 4 for t in (ours.comp, ours.bmin, ours.bmax, ours.attr)
    )


def _config(width: int, height: int) -> Config:
    return Config(resolution=Resolution.sized(width, height))


def port_frame(width: int, height: int) -> np.ndarray:
    return Renderer(torus_scene(), config=_config(width, height), handler="lbvh", device="cpu").render_frame().numpy()


def jax_renderer(width: int, height: int):
    return rt_rs_tpu.Renderer(
        rt_rs_tpu.Scene.from_json(torus_scene().to_json()),
        config=rt_rs_tpu.Config(resolution=rt_rs_tpu.Resolution.sized(width, height)),
        handler="lbvh",
    )


@pytest.mark.parametrize("size", [(32, 24), (37, 23)])
def test_lbvh_frame_matches_jax(size):
    ours = port_frame(*size)
    assert np.isfinite(ours).all() and ours.mean() > 0.05
    np.testing.assert_allclose(ours, np.asarray(jax_renderer(*size).render_frame()), rtol=0, atol=ATOL)


def test_lbvh_frame_matches_stored_jax_frame():
    np.testing.assert_allclose(port_frame(96, 72), np.load(LBVH_FRAME)["frame"], rtol=0, atol=ATOL)


def test_lbvh_entries_and_caps():
    """Rows where the JAX package builds its attribute table: at tc = 64
    (cap 8,192 triangles) but not at tc = 16 (cap 4,096), nor for a
    non-finite shade table; beyond 12,288 triangles the build raises in
    both packages."""
    scene = torus_scene()
    cfg = Config().compute
    for tc, rows in ((64, True), (16, False)):
        h = get_handler("lbvh", tri_chunk=tc)
        accel, arrays = h.build(scene, scene.pack(device="cpu"))
        jaccel, _ = jlbvh.LbvhIntrs(interpret=True, tri_chunk=tc).build(None, rt_rs_tpu.Scene.from_json(scene.to_json()).pack())
        assert (accel.attr is not None) == rows == (jaccel.attr_t is not None)
        assert (h.intersect_tiled_rows_fn(accel, arrays, cfg) is not None) == rows
        assert h.intersect_tiled_anyhit_fn(accel, arrays, cfg).supports_refine
        assert h.block_lanes == 256 and accel.tri_chunk == tc
        assert h.stats(accel).name == "LBVH" and h.stats(accel).size == chunk_footprint(accel)
    bad = torus_scene()
    bad.vert_norm = bad.vert_norm.copy()
    bad.vert_norm[3] = np.nan
    accel, _ = LbvhIntrs().build(bad, bad.pack(device="cpu"))
    assert accel.attr is None
    big = random_soup(3, 12_289)
    with pytest.raises(ValueError, match="12288"):
        LbvhIntrs().build(big, big.pack(device="cpu"))
    with pytest.raises(ValueError, match="12288"):
        jlbvh.LbvhIntrs(interpret=True).build(None, rt_rs_tpu.Scene.from_json(big.to_json()).pack())
    with pytest.raises(ValueError, match="refine"):
        LbvhIntrs(refine="some")
    assert pt.rows_budget_ok(8192, 64) and not pt.rows_budget_ok(8193, 64)
    for n, tc in ((8192, 64), (8193, 64), (4096, 16), (4097, 16), (2457, 8), (1, 64)):
        assert pt.rows_budget_ok(n, tc) == jpt.rows_budget_ok(n, tc), (n, tc)


if __name__ == "__main__":
    # Read when the first computation starts the CPU backend.
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " --xla_cpu_max_isa=SSE4_2").strip()
    jax.config.update("jax_platforms", "cpu")
    frame = np.asarray(jax_renderer(96, 72).render_frame())
    np.savez_compressed(LBVH_FRAME, frame=frame)
    print(f"wrote {LBVH_FRAME}: mean {frame.mean():.6f}")

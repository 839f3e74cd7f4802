"""``DynamicRenderer`` of rt_rs_tpu_torch against the JAX package's.

Each frame gathers the prims' corners from new vertex positions,
rebuilds the chunk table on the device (a Morton sort, or with
``refit=True`` new bounds over the rest pose's order) and traces it
(``backend="packet"``; the walked refit, the default with
``refit=True``, is tests/test_torch_dynamic_walk.py's).
The geometry moves by :func:`wave`, the deformation ``chip_smoke.py``
drives on the card: each vertex rises by ``WAVE_AMP * 4u(1 - u)``, u the
fractional part of ``WAVE_FREQ * x + WAVE_STEP * frame``, computed in
f64 with floor, products and sums only (the same bits on every machine)
and rounded to f32.  It changes the torus' Morton order from frame to
frame.

Tolerances: frames against the JAX package's, live (Pallas in
interpret mode) and stored, at atol 2e-5, the repo's frame rule; refit
against rebuild and the moved frame against a ``naive`` render of the
moved scene at 1e-5, the JAX package's own bounds
(tests/test_lbvh.py); the rows branch against the gather branch at
2e-6, as there.  Chained frames: a dispatch's frame 0 equals the loop's
frame bit for bit, the later ones advance the orbit in f32 and are held
within 1e-3 (tests/test_torch_chain.py's rule).

``tests/data/torch_port_dynamic_torus_96x72.npz`` holds the JAX
package's rebuild and refit frames of ``torus_scene`` at 96x72, at the
rest pose and at frame 3 of the wave, rendered with XLA:CPU held to
SSE4.2 (no FMA to contract into, as for the other stored frames);
``chip_smoke.py`` holds the card's frames to it.  Regenerate it with
``JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_dynamic.py``.
"""

from __future__ import annotations

import copy
import os
import pathlib

import numpy as np
import pytest
import torch

import rt_rs_tpu
from rt_rs_tpu.renderer import DynamicRenderer as JaxDynamicRenderer
from rt_rs_tpu_torch import ComputeConfig, Config, DynamicRenderer, Renderer, Resolution
from rt_rs_tpu_torch import renderer as rmod
from rt_rs_tpu_torch.handlers.lbvh import chunk_footprint, device_chunks
from rt_rs_tpu_torch.ops import lbvh
from rt_rs_tpu_torch.scene.presets import random_soup, torus_ghost, torus_scene

torch.set_num_threads(
    max(1, (os.cpu_count() or 1) // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))
)

ROOT = pathlib.Path(__file__).resolve().parent.parent
DYNAMIC_FRAMES = ROOT / "tests" / "data" / "torch_port_dynamic_torus_96x72.npz"
FRAME_ATOL = 2e-5
SELF_ATOL = 1e-5
ROWS_ATOL = 2e-6
CHAIN_ATOL = 1e-3
SIZE = (32, 24)
MOVED = 3  # the moved pose: frame 3 of the wave
MODES = ("rebuild", "refit")
# chip_smoke.py's WAVE_AMP, WAVE_FREQ, WAVE_STEP
WAVE_AMP, WAVE_FREQ, WAVE_STEP = 0.3, 0.5, 0.125


def wave(scene, i: int):
    """Frame ``i`` of the deformation -> (vert_pos, vert_norm) f32 arrays
    (the normals stay the rest pose's)."""
    vp = np.asarray(scene.vert_pos, dtype=np.float64)
    u = WAVE_FREQ * vp[:, 0] + WAVE_STEP * i
    u = u - np.floor(u)
    out = vp.copy()
    out[:, 1] += WAVE_AMP * 4.0 * u * (1.0 - u)
    return out.astype(np.float32), np.asarray(scene.vert_norm, dtype=np.float32)


def _config(width: int, height: int, bounces: int = 4) -> Config:
    return Config(compute=ComputeConfig(bounces=bounces), resolution=Resolution.sized(width, height))


def port(mode: str = "rebuild", size=SIZE, scene=None, bounces: int = 4, **kw) -> DynamicRenderer:
    """A DynamicRenderer on the CPU, on the chunk table
    (``backend="packet"``: ``"auto"`` walks with ``refit=True``,
    tests/test_torch_dynamic_walk.py).  Tests of the renderer's mechanics
    (chains, caches, checks) take one bounce: a CPU frame's cost is its
    bounces' packet traces, whatever the image size below 8,192 rays."""
    return DynamicRenderer(
        torus_scene() if scene is None else scene, config=_config(*size, bounces),
        refit=mode == "refit", device="cpu", backend="packet", **kw,
    )


def jax_dynamic(mode: str, size, **kw):
    return JaxDynamicRenderer(
        rt_rs_tpu.Scene.from_json(torus_scene().to_json()),
        config=rt_rs_tpu.Config(resolution=rt_rs_tpu.Resolution.sized(*size)),
        refit=mode == "refit",
        **kw,
    )


def frames_of(r, render) -> dict:
    """The rest-pose and moved frames of a renderer as NumPy arrays."""
    scene = torus_scene()
    return {
        "rest": np.asarray(render(r)),
        "moved": np.asarray(render(r, *wave(scene, MOVED))),
    }


@pytest.fixture(scope="module")
def ours() -> dict:
    return {m: frames_of(port(m), lambda r, *v: r.render_frame(*v).numpy()) for m in MODES}


@pytest.mark.parametrize("mode", MODES)
def test_frame_matches_jax(ours, mode):
    """The moved pose against the live JAX frame (the rest pose against
    the stored ones below)."""
    f = ours[mode]["moved"]
    assert f.shape == (SIZE[1], SIZE[0], 3) and np.isfinite(f).all() and f.mean() > 0.05
    ref = np.asarray(jax_dynamic(mode, SIZE).render_frame(*wave(torus_scene(), MOVED)))
    np.testing.assert_allclose(f, ref, rtol=0, atol=FRAME_ATOL)


@pytest.mark.parametrize("mode", MODES)
def test_frame_matches_stored_jax_frame(mode):
    stored = np.load(DYNAMIC_FRAMES)
    got = frames_of(port(mode, (96, 72)), lambda r, *v: r.render_frame(*v).numpy())
    for pose, key in (("rest", "rest"), ("moved", f"frame{MOVED}")):
        np.testing.assert_allclose(got[pose], stored[f"{mode}_{key}"], rtol=0, atol=FRAME_ATOL)


def test_refit_matches_rebuild_and_the_order_moves(ours):
    """A stale order only loosens the chunks' bounds: the refit frame of
    the moved pose is the rebuild's (at the rest pose the two build one
    table).  The wave does move the order."""
    np.testing.assert_array_equal(ours["refit"]["rest"], ours["rebuild"]["rest"])
    np.testing.assert_allclose(ours["refit"]["moved"], ours["rebuild"]["moved"], rtol=0, atol=SELF_ATOL)
    scene = torus_scene()
    orders = []
    for i in (0, MOVED):
        r = port()
        vp, vn = (torch.from_numpy(x) for x in wave(scene, i))
        a = r._frame_arrays(vp, vn)
        orders.append(lbvh.morton_order(lbvh.centroid_codes(a.pa[1:], a.pb[1:], a.pc[1:])))
    assert not torch.equal(*orders)


def test_moved_frame_matches_naive_render_of_moved_scene():
    """The rebuilt frame of the moved pose is a brute-force render of the
    moved scene (one bounce at 16x12: the naive handler tests every
    triangle for every ray)."""
    scene = torus_scene()
    moved = copy.deepcopy(scene)
    moved.vert_pos = wave(scene, MOVED)[0]
    cfg = _config(16, 12, bounces=1)
    ref = Renderer(moved, config=cfg, handler="naive", device="cpu").render_frame().numpy()
    ours = port(size=(16, 12), bounces=1).render_frame(*wave(scene, MOVED)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=SELF_ATOL)


@pytest.mark.parametrize("mode", MODES)
def test_rows_branch_matches_gather_branch(ours, mode):
    gather = port(mode, force_rows=False)
    assert not gather._use_rows and port(mode)._use_rows
    np.testing.assert_allclose(
        gather.render_frame(*wave(torus_scene(), MOVED)).numpy(), ours[mode]["moved"],
        rtol=0, atol=ROWS_ATOL,
    )


def test_rows_gate_like_jax():
    """Rows need a finite rest pose, no negative material and the rows
    budget at the chunk height (8,192 triangles at tc = 64, 4,096 at
    16): the same gate as the JAX package's."""
    cases = [({}, True), ({"tri_chunk": 16}, False), ({"force_rows": False}, False)]
    for kw, rows in cases:
        assert port(**kw)._use_rows == rows == jax_dynamic("rebuild", SIZE, **kw)._use_rows
    bad = torus_scene()
    bad.vert_norm = bad.vert_norm.copy()
    bad.vert_norm[0] = np.nan
    assert not port(scene=bad)._use_rows
    assert not port(scene=torus_ghost())._use_rows


def test_nonfinite_inputs():
    """With rows on, non-finite vertex data raises (NumPy arrays every
    frame, tensors on the first frame, the chained stack every
    dispatch); the gather branch renders it as the JAX package does:
    NaN normals and a NaN position, whose NaN centroid quantizes to 0
    (and the NaN box of its axis sends that axis' bits of every code to
    0), which moves the Morton order."""
    scene = torus_scene()
    vp, vn = wave(scene, 1)
    bad_norm = vn.copy()
    bad_norm[0] = np.nan
    bad_pos = vp.copy()
    bad_pos[100, 1] = np.nan
    with pytest.raises(ValueError, match="non-finite"):
        port(bounces=1).render_frame(vp, bad_norm)
    with pytest.raises(ValueError, match="non-finite"):
        port(bounces=1).render_frame(torch.from_numpy(bad_pos))
    first = port(size=(16, 16), bounces=1)
    first.render_frame(torch.from_numpy(vp))  # the first frame is checked...
    first.render_frame(torch.from_numpy(bad_pos))  # ...later tensors are not
    with pytest.raises(ValueError, match="non-finite"):
        port(bounces=1).animate(2, chain=2, vertex_fn=lambda i: (vp, bad_norm))
    gather = port(force_rows=False)
    jax_gather = jax_dynamic("rebuild", SIZE, force_rows=False)
    for v in ((vp, bad_norm), (bad_pos, vn)):
        ours = gather.render_frame(*v).numpy()
        assert np.nan_to_num(ours).mean() > 0.05
        # NaN where the JAX frame has NaN
        np.testing.assert_allclose(ours, np.asarray(jax_gather.render_frame(*v)), rtol=0, atol=FRAME_ATOL)


def collect(r, frames: int, chain: int | None, vertex_fn, **kw) -> dict[int, np.ndarray]:
    got, order = {}, []

    def on_frame(i, f, dt):
        assert isinstance(f, torch.Tensor) and dt > 0
        order.append(i)
        got[i] = f.numpy()

    r.animate(frames, on_frame=on_frame, sync_every=3, chain=chain, vertex_fn=vertex_fn, **kw)
    assert order == list(range(frames))
    return got


@pytest.mark.parametrize("mode", MODES)
def test_chain_matches_loop_with_a_partial_last_chain(mode):
    """``animate(3, chain=2)``: two dispatches, the last keeping one of
    its two frames, whose second slot repeats frame 2's geometry;
    ``vertex_fn`` is never called past frame 2.  The host camera ends
    where the loop's does."""
    scene = torus_scene()
    calls = []

    def vertex_fn(i):
        calls.append(i)
        return wave(scene, i)

    loop_r, chain_r = port(mode, (16, 16), bounces=1), port(mode, (16, 16), bounces=1)
    loop = collect(loop_r, 3, None, vertex_fn)
    calls.clear()
    chained = collect(chain_r, 3, 2, vertex_fn)
    assert calls == [0, 1, 2, 2]
    assert not np.array_equal(loop[0], loop[1])
    for i in loop:
        if i % 2 == 0:
            np.testing.assert_array_equal(chained[i], loop[i], err_msg=f"frame {i}")
        else:
            assert np.abs(chained[i] - loop[i]).max() < CHAIN_ATOL, i
    assert loop_r.camera == chain_r.camera
    expect = scene.camera
    for _ in range(3):
        expect = expect.orbited(1.0)
    assert chain_r.camera == expect


def test_chain_frames_equal_eager_steps_at_the_graph_cameras():
    """Each frame of a dispatch is the eager step of its geometry at the
    f32 camera the dispatch wrote out, bit for bit (what chip_smoke.py
    holds the card's graphs to)."""
    r = port("rebuild", (16, 16), bounces=1)
    scene = torus_scene()
    vs = [wave(scene, i) for i in range(3)]
    frames, poses = r._run_chain(
        3, 1.5, np.stack([v[0] for v in vs]), np.stack([v[1] for v in vs])
    )
    frames, poses = frames.clone(), poses.clone()
    at = torch.tensor(scene.camera.at, dtype=torch.float32)
    for j, (vp, vn) in enumerate(vs):
        eager = r._step(torch.from_numpy(vp), torch.from_numpy(vn), poses[j], at)
        assert torch.equal(frames[j], eager), j


def test_chain_cache_is_an_lru(monkeypatch):
    """At most CHAIN_CACHE_LIMIT chains, the least recently used evicted
    (the frames themselves are not rendered here)."""
    monkeypatch.setattr(rmod, "CHAIN_CACHE_LIMIT", 2)
    r = port("refit", (16, 16))
    monkeypatch.setattr(r, "_chain_frames", lambda k, io: None)
    for k in (2, 3, 2, 4):
        r.animate(k, chain=k)
    assert r._chains.keys() == [2, 4]  # K = 3 evicted
    assert sorted(r._chain_io) == [2, 3, 4]


def test_stats_and_negative_materials():
    """``stats`` names the mode as the JAX package does and counts the
    port's table bytes; a negative-material scene renders through the
    flat path, equal to the lbvh Renderer's frame at the rest pose (the
    same Morton order)."""
    for mode in MODES:
        st = port(mode).stats
        assert st.name == jax_dynamic(mode, SIZE).stats.name == f"LBVH-{mode}"
        base = port(mode)._base
        assert st.size == chunk_footprint(
            device_chunks(base.pa, base.pb, base.pc, shade_rows=base.shade_table)
        )
    ghost = torus_ghost()
    frame = port(scene=ghost, bounces=1).render_frame().numpy()
    ref = Renderer(ghost, config=_config(*SIZE, 1), handler="lbvh", device="cpu").render_frame().numpy()
    np.testing.assert_array_equal(frame, ref)
    assert np.nan_to_num(frame).mean() > 0.05


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_walked_rebuild_matches_jax_below_the_cap(seed):
    """The port's walked rebuild (``backend="threaded"``: kernel G's tree
    built from each frame's corners, ``ops/wide_build.py``) of a seeded
    300-triangle soup at 64x48, at its rest pose and moved, against the
    JAX package's rebuild (a chunk table) at atol 2e-5, the repo's frame
    rule: the closest hits are the same triangles whatever the
    structure."""
    scene = random_soup(seed, 300)
    cfg = _config(64, 48)
    r = DynamicRenderer(scene, config=cfg, device="cpu", backend="threaded")
    assert r._walk and r.stats.name == "BVH-rebuild"
    jr = JaxDynamicRenderer(
        rt_rs_tpu.Scene.from_json(scene.to_json()),
        config=rt_rs_tpu.Config(resolution=rt_rs_tpu.Resolution.sized(64, 48)),
    )
    moved = (np.asarray(scene.vert_pos, np.float64) * 1.01).astype(np.float32)
    for verts in (None, moved):
        got = r.render_frame(verts).numpy()
        want = np.asarray(jr.render_frame(verts))
        np.testing.assert_allclose(got, want, rtol=0, atol=FRAME_ATOL)
    assert got.mean() > 0.05


def test_table_bound_raises_like_jax():
    """Beyond 12,288 triangles the table raises at the first frame, in
    both packages (the port's default backend walks such a scene)."""
    big = random_soup(3, 12_289)
    with pytest.raises(ValueError, match="12288"):
        DynamicRenderer(big, config=_config(16, 16), device="cpu", backend="packet").render_frame()
    jr = JaxDynamicRenderer(
        rt_rs_tpu.Scene.from_json(big.to_json()),
        config=rt_rs_tpu.Config(resolution=rt_rs_tpu.Resolution.sized(16, 16)),
    )
    with pytest.raises(ValueError, match="12288"):
        jr.render_frame()


if __name__ == "__main__":
    import jax

    # Read when the first computation starts the CPU backend.
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " --xla_cpu_max_isa=SSE4_2").strip()
    jax.config.update("jax_platforms", "cpu")
    scene = torus_scene()
    frames = {}
    for mode in MODES:
        jd = jax_dynamic(mode, (96, 72))
        frames[f"{mode}_rest"] = np.asarray(jd.render_frame())
        frames[f"{mode}_frame{MOVED}"] = np.asarray(jd.render_frame(*wave(scene, MOVED)))
    np.savez_compressed(DYNAMIC_FRAMES, **frames)
    print(f"wrote {DYNAMIC_FRAMES}: " + ", ".join(f"{k} mean {f.mean():.6f}" for k, f in frames.items()))

"""``Renderer.animate(chain=K)`` of rt_rs_tpu_torch against its own loop
and the JAX package's chained animate.

The contract is the JAX package's (rt_rs_tpu/renderer.py:382-492,
tests/test_chain.py, which needs the reference scenes): K frames per
dispatch; frame 0 of a dispatch is the unchained frame at the host
camera; frames 1..K-1 advance the orbit in f32 and track the host's f64
loop within 1e-3; the host camera stays canonical (bit-identical to the
loop's after any number of frames, a partial last chain included);
``on_frame`` sees every frame once, in order; ``seg_order="auto"`` is
taken once per dispatch.  On the CPU the chain runs eagerly; on a card
each dispatch replays a captured CUDA graph (``chip_smoke.py``'s chain
phase holds that).  Scenes are built in code.

Tolerances: the port's f32 orbit against the JAX package's
``_orbit_f32``: the angle and the radius are bit-equal, ``cos`` and
``sin`` differ by at most one ULP between torch's and XLA:CPU's libm, so
each position component is held within 2 ULP of the radius plus 1 ULP of
itself (measured: at most 0.94 of that).  Frames against the JAX
package's at atol 2e-5 (the repo's frame rule), later frames of a chain
within 1e-3 (tests/test_chain.py's bound).
"""

from __future__ import annotations

import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rt_rs_tpu
from rt_rs_tpu.ops.pallas import packet_trace as jpt
from rt_rs_tpu.renderer import _orbit_f32 as jax_orbit_f32
from rt_rs_tpu_torch import ComputeConfig, Config, Renderer, Resolution
from rt_rs_tpu_torch import renderer as rmod
from rt_rs_tpu_torch.ops import cuda
from rt_rs_tpu_torch.ops import packet_trace as pt
from rt_rs_tpu_torch.scene.camera import ORBIT_RATE, orbit_f32
from rt_rs_tpu_torch.scene.presets import torus_ghost, torus_scene

torch.set_num_threads(
    max(1, (os.cpu_count() or 1) // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))
)

FRAME_ATOL = 2e-5
CHAIN_ATOL = 1e-3
FORCED_CAP = 16  # MAX_VMEM_CHUNKS that splits torus_scene into 4 segments
# Against the live JAX Renderer, whose XLA:CPU contracts the hit
# arithmetic into FMAs and so resolves a ray that grazes a triangle edge
# its own way: torus_scene at 64x48 is held at the frame rule by
# tests/test_torch_render.py (max 1.1e-5), where 62x46 (the size
# tests/test_torch_flat.py chose for the ghost scenes) puts one value of
# the first frame 5.1e-5 away.  Later cameras of the orbit are not
# picked, so they are held at CHAIN_ATOL.
JAX_SIZE = (64, 48)


def _config(width: int, height: int, **compute) -> Config:
    return Config(compute=ComputeConfig(**compute), resolution=Resolution.sized(width, height))


def collect(r, frames: int, chain: int | None, **kw) -> dict[int, np.ndarray]:
    """``r.animate``'s frames by index, checking that ``on_frame`` sees
    each once, in order, as a tensor on the Renderer's device."""
    got, order = {}, []

    def on_frame(i, f, dt):
        assert isinstance(f, torch.Tensor) and f.device == r.device and dt > 0
        order.append(i)
        got[i] = f.numpy()

    r.animate(frames, on_frame=on_frame, sync_every=3, chain=chain, **kw)
    assert order == list(range(frames))
    return got


def assert_chain_frames(chained: dict, loop: dict, k: int) -> None:
    """A dispatch's frame 0 is the loop's frame bit for bit; the others
    within CHAIN_ATOL."""
    for i in loop:
        if i % k == 0:
            np.testing.assert_array_equal(chained[i], loop[i], err_msg=f"frame {i}")
        else:
            assert np.abs(chained[i] - loop[i]).max() < CHAIN_ATOL, i


@pytest.mark.parametrize("mult", [1.0, -2.5, 27.8])
def test_orbit_f32_matches_jax(mult):
    rng = np.random.default_rng(6)
    for i in range(100):
        pos = (rng.normal(size=3) * 10.0 ** rng.uniform(-2, 2)).astype(np.float32)
        at = (rng.normal(size=3) * rng.uniform(0, 5)).astype(np.float32)
        if i == 0:
            pos[[0, 2]] = at[[0, 2]]  # on the axis: atan2(0, 0), radius 0
        ours = orbit_f32(
            torch.from_numpy(pos), torch.from_numpy(at), torch.tensor(np.float32(mult))
        ).numpy()
        ref = np.asarray(jax_orbit_f32(jnp.asarray(pos), jnp.asarray(at), jnp.float32(mult)))
        x, z = pos[0] - at[0], pos[2] - at[2]
        r = np.sqrt(x * x + z * z)
        assert ours.dtype == np.float32 and ours[1] == ref[1] == pos[1]
        assert (np.abs(ours - ref) <= 2 * np.spacing(r) + np.spacing(np.abs(ref))).all(), (pos, at)
        if i == 0:
            np.testing.assert_array_equal(ours, [at[0], pos[1], at[2]])
        # one step of the host's f64 orbit, to f32 precision
        host = rt_rs_tpu.CameraUniform(tuple(map(float, pos)), tuple(map(float, at))).orbited(mult)
        np.testing.assert_allclose(ours, host.pos, rtol=0, atol=1e-5 * (1.0 + float(r)))


def test_chain_matches_loop():
    make = lambda: Renderer(torus_scene(), config=_config(32, 24), handler="pbvh", device="cpu")  # noqa: E731
    loop = collect(make(), 5, None)
    chained = collect(make(), 5, 2)
    assert not np.array_equal(loop[0], loop[1])  # the orbit moved
    assert_chain_frames(chained, loop, 2)


def test_host_camera_canonical_after_partial_chain():
    make = lambda: Renderer(torus_scene(), config=_config(16, 16), handler="pbvh", device="cpu")  # noqa: E731
    a, b = make(), make()
    a.animate(5, sync_every=2)
    times = b.animate(5, sync_every=2, chain=3)  # 5 % 3 != 0: the last chain is partial
    assert len(times) == 5 and all(t > 0 for t in times)
    assert np.array(a.camera.pos).tobytes() == np.array(b.camera.pos).tobytes()
    assert a.camera == b.camera
    expect = torus_scene().camera
    for _ in range(5):
        expect = expect.orbited(1.0)
    assert b.camera == expect


@pytest.fixture(scope="module")
def jax_chained():
    """The JAX package's pbvh ``animate(5, chain=2)`` frames (Pallas in
    interpret mode) of ``torus_scene`` at JAX_SIZE."""
    jr = rt_rs_tpu.Renderer(
        rt_rs_tpu.Scene.from_json(torus_scene().to_json()),
        config=rt_rs_tpu.Config(resolution=rt_rs_tpu.Resolution.sized(*JAX_SIZE)),
        handler="pbvh",
    )
    got = {}
    jr.animate(5, sync_every=3, chain=2, on_frame=lambda i, f, dt: got.__setitem__(i, np.asarray(f)))
    return got


def test_chain_matches_jax_chain(jax_chained):
    ours = collect(Renderer(torus_scene(), config=_config(*JAX_SIZE), handler="pbvh", device="cpu"), 5, 2)
    assert sorted(jax_chained) == list(range(5))
    np.testing.assert_allclose(ours[0], jax_chained[0], rtol=0, atol=FRAME_ATOL)
    for i in range(1, 5):
        assert np.abs(ours[i] - jax_chained[i]).max() < CHAIN_ATOL, i
    assert float(ours[0].mean()) > 0.05


def test_segmented_auto_order_taken_per_dispatch(monkeypatch):
    """With ``seg_order="auto"`` every frame of a dispatch takes the
    order of its first camera, where the loop re-resolves it each frame:
    an orbit of 45 degrees a step crosses a snap bin inside each chain.
    The frames are the loop's all the same (the merge is exact in every
    order)."""
    monkeypatch.setattr(pt, "MAX_VMEM_CHUNKS", FORCED_CAP)
    monkeypatch.setattr(jpt, "MAX_VMEM_CHUNKS", FORCED_CAP)
    mult = (math.pi / 4) / ORBIT_RATE

    def run(chain):
        r = Renderer(torus_scene(), config=_config(32, 16, bounces=2), handler="pbvh", device="cpu")
        assert r._seg_centers is not None and len(r.accel.segments) == 4
        orders, render = [], r._render

        def spy(h, pos, at):
            orders.append(h.seg_order)
            return render(h, pos, at)

        r._render = spy
        return collect(r, 4, chain, orbit_mult=mult), orders

    loop, loop_orders = run(None)
    chained, chain_orders = run(2)
    assert loop_orders[0] != loop_orders[1]
    assert chain_orders == [loop_orders[0]] * 2 + [loop_orders[2]] * 2
    assert_chain_frames(chained, loop, 2)


def _dma_renderer(monkeypatch):
    monkeypatch.setattr(pt, "MAX_VMEM_CHUNKS", FORCED_CAP)
    r = Renderer(
        torus_scene(), config=_config(32, 24), handler_kwargs={"streaming_mode": "dma"},
        handler="pbvh", device="cpu",
    )
    assert r.handler._streamed(r.accel)
    return r


PATHS = {
    "flat torus_ghost": lambda mp: Renderer(torus_ghost(), config=_config(32, 24), handler="pbvh", device="cpu"),
    "blank": lambda mp: Renderer(torus_scene(), config=_config(32, 24), handler="blank", device="cpu"),
    "naive": lambda mp: Renderer(torus_scene(), config=_config(32, 24), handler="naive", device="cpu"),
    "dma": _dma_renderer,
    "fuse_bounce": lambda mp: Renderer(
        torus_scene(), config=_config(32, 24), fuse_bounce=True, handler="pbvh", device="cpu"
    ),
}


@pytest.mark.parametrize("path", sorted(PATHS))
def test_every_frame_path_chains(path, monkeypatch):
    """One chained run on each frame path: frame 0 is ``render_frame``'s
    frame bit for bit, and the later frames are finite."""
    r = PATHS[path](monkeypatch)
    first = r.render_frame().numpy()
    got = collect(r, 3, 2)
    np.testing.assert_array_equal(got[0], first)
    assert all(np.isfinite(f).all() and f.shape == (24, 32, 3) for f in got.values())
    if path == "blank":
        assert not any(f.any() for f in got.values())
    else:
        assert float(first.mean()) > 0.01


def test_lru_cache():
    c = rmod.LruCache(2)
    made = []

    def make(v):
        return lambda: made.append(v) or v

    assert c.get("a", make(1)) == 1 and c.get("b", make(2)) == 2
    assert c.get("a", make(9)) == 1  # a hit moves "a" to the most recent
    assert c.get("c", make(3)) == 3  # evicts "b", the least recently used
    assert c.keys() == ["a", "c"] and len(c) == 2 and made == [1, 2, 3]
    c.clear()
    assert len(c) == 0
    with pytest.raises(ValueError, match="limit"):
        rmod.LruCache(0)


def test_chain_cache_evicts_and_update_config_clears(monkeypatch):
    monkeypatch.setattr(rmod, "CHAIN_CACHE_LIMIT", 2)
    r = Renderer(torus_scene(), config=_config(16, 16, bounces=1), handler="pbvh", device="cpu")
    for k in (2, 3, 2, 4):
        r.animate(k, chain=k)
    assert [key[0] for key in r._chains.keys()] == [2, 4]  # K = 3 evicted
    r.update_config(ComputeConfig(bounces=2))
    assert len(r._chains) == 0
    r.animate(2, chain=2)
    (key,) = r._chains.keys()
    assert key[0] == 2 and key[2] == ComputeConfig(bounces=2)


def test_captured_launches_are_left_to_the_replays():
    """A capture's wrapper calls launch nothing: their counts are handed
    back (each replay adds them) and ``LAUNCHES`` is left as it was, also
    when the capture raises."""
    saved = cuda.LAUNCHES.copy()
    try:
        cuda.LAUNCHES.clear()
        cuda.LAUNCHES["shade_pre"] = 1

        def capture():
            cuda.LAUNCHES["shade_pre"] += 2
            cuda.LAUNCHES["mt_trace[rows]"] += 1

        assert cuda.captured_launches(capture) == {"shade_pre": 2, "mt_trace[rows]": 1}
        assert cuda.LAUNCHES == {"shade_pre": 1}

        def failing():
            cuda.LAUNCHES["refine_cull"] += 1
            raise RuntimeError("capture invalidated")

        with pytest.raises(RuntimeError, match="invalidated"):
            cuda.captured_launches(failing)
        assert cuda.LAUNCHES == {"shade_pre": 1}
    finally:
        cuda.LAUNCHES.clear()
        cuda.LAUNCHES.update(saved)

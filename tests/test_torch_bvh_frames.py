"""Threaded ``bvh`` and ``rf_bvh`` frames of rt_rs_tpu_torch against the
JAX package's, and the default handler.

On the CPU both packages take the threaded walk (``backend="auto"``):
the JAX package its ``lax.while_loop`` through the gather branch with
closest-hit shadows, the port the walk's plain twin through the emit
branch (the tiled entry's rows and any-hit modes; its frames equal the
gather branch's bit for bit, ``tests/test_torch_walk_modes.py``).
Frames at atol 2e-5 (the bound the JAX package holds between its own
two frame paths); the JAX walk's FMA-contracted hit distances move the
colour by less.

``tests/data/torch_port_bvh_torus_96x72.npz`` holds the JAX package's
threaded ``bvh`` and ``rf_bvh`` frames of ``torus_scene`` at 96x72,
rendered with XLA:CPU held to SSE4.2 (no FMA to contract into, as for
tests/data/torch_port_torus_96x72.npz); ``chip_smoke.py`` holds the
card's frames to it.  Regenerate it with ``JAX_PLATFORMS=cpu
PYTHONPATH=. python tests/test_torch_bvh_frames.py``.
"""

from __future__ import annotations

import os
import pathlib

import numpy as np
import pytest
import torch

import rt_rs_tpu
from rt_rs_tpu_torch import ComputeConfig, Config, Renderer, Resolution
from rt_rs_tpu_torch.scene.presets import torus_scene

torch.set_num_threads(
    max(1, (os.cpu_count() or 1) // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))
)

ROOT = pathlib.Path(__file__).resolve().parent.parent
BVH_FRAMES = ROOT / "tests" / "data" / "torch_port_bvh_torus_96x72.npz"
ATOL = 2e-5
HANDLERS = ("bvh", "rf_bvh")


def _config(width: int, height: int) -> Config:
    return Config(compute=ComputeConfig(), resolution=Resolution.sized(width, height))


def jax_renderer(width: int, height: int, handler: str):
    return rt_rs_tpu.Renderer(
        rt_rs_tpu.Scene.from_json(torus_scene().to_json()),
        config=rt_rs_tpu.Config(resolution=rt_rs_tpu.Resolution.sized(width, height)),
        handler=handler,
        handler_kwargs={"backend": "threaded"},
    )


def port_frame(width: int, height: int, handler: str) -> np.ndarray:
    r = Renderer(
        torus_scene(), config=_config(width, height), handler=handler,
        handler_kwargs={"backend": "threaded"}, device="cpu",
    )
    return r.render_frame().numpy()


@pytest.mark.parametrize("handler", HANDLERS)
@pytest.mark.parametrize("size", [(32, 24), (37, 23)])
def test_threaded_frame_matches_jax(handler, size):
    ours = port_frame(*size, handler)
    ref = np.asarray(jax_renderer(*size, handler).render_frame())
    assert ours.shape == ref.shape == (size[1], size[0], 3)
    assert np.isfinite(ours).all() and ours.mean() > 0.05
    np.testing.assert_allclose(ours, ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("handler", HANDLERS)
def test_threaded_frame_matches_stored_jax_frame(handler):
    ref = np.load(BVH_FRAMES)[handler]
    np.testing.assert_allclose(port_frame(96, 72, handler), ref, rtol=0, atol=ATOL)


def test_threaded_frames_equal_pbvh():
    """Both walks and the packet kernels find the same hits on this
    frame: the three frames are one."""
    pbvh = Renderer(torus_scene(), config=_config(48, 32), handler="pbvh", device="cpu")
    ref = pbvh.render_frame().numpy()
    for handler in HANDLERS:
        np.testing.assert_array_equal(port_frame(48, 32, handler), ref)


def test_default_renderer_is_bvh_like_jax():
    """Renderer(scene) builds bvh, as the JAX package's does: the same
    stats ("BVH", 48 B a node); on the CPU "auto" takes the walk."""
    r = Renderer(torus_scene(), config=_config(16, 16), device="cpu")
    jr = rt_rs_tpu.Renderer(
        rt_rs_tpu.Scene.from_json(torus_scene().to_json()),
        config=rt_rs_tpu.Config(resolution=rt_rs_tpu.Resolution.sized(16, 16)),
    )
    assert (r.stats.name, r.stats.size) == (jr.stats.name, jr.stats.size) == ("BVH", 366672)
    assert r.accel.chunks is None and r.block == (16, 16)


if __name__ == "__main__":
    import jax

    # Read when the first computation starts the CPU backend.
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " --xla_cpu_max_isa=SSE4_2").strip()
    jax.config.update("jax_platforms", "cpu")
    frames = {h: np.asarray(jax_renderer(96, 72, h).render_frame()) for h in HANDLERS}
    np.savez_compressed(BVH_FRAMES, **frames)
    print(f"wrote {BVH_FRAMES}: " + ", ".join(f"{h} mean {f.mean():.6f}" for h, f in frames.items()))

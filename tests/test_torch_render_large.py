"""rt_rs_tpu_torch frames of scenes beyond the resident chunk table
against the JAX package's.

Segmentation is forced as in the JAX package's tests: ``MAX_VMEM_CHUNKS``
= 16 in both packages splits ``torus_scene`` into 4 segments (or, with
``streaming_mode="dma"``, tests/test_torch_stream.py).
``gather_band_torus`` (10,002 triangles) keeps one table but exceeds
the rows table's cap, so it takes the gather branch.  Frames are held at
atol 2e-5, the bound the JAX package holds between its own two frame
paths (tests/test_shade_tiled.py).

The port's branches are held to each other bit for bit: the resident
table's rows + any-hit frame, its gather frame, and the segmented and
streamed tables' frames of the same scene (the JAX package calls its
two branches identical, rt_rs_tpu/handlers/base.py:111-112).

Two frames are stored, each the JAX package's default pbvh frame
rendered with XLA:CPU held to SSE4.2 (``--xla_cpu_max_isa=SSE4_2``) so
that XLA contracts no FMA: ``tests/data/torch_port_torus_row2_96x72.npz``
(``torus_row(2)``, 12,642 triangles: 2 segments, the gather branch) and
``tests/data/torch_port_gather_band_32x16.npz`` (``gather_band_torus``).
The gather band needs the stored frame: under default XLA:CPU the JAX
frame's FMA-contracted hit distances flip one pixel's outcome at 32x16
(0.506 away at pixel (10, 16)), while the SSE4.2 frame is 6e-8 from the
port's.  Regenerate both with
``PYTHONPATH=. python tests/test_torch_render_large.py``.
"""

from __future__ import annotations

import os
import pathlib

import numpy as np
import pytest
import torch

import rt_rs_tpu
from rt_rs_tpu.ops.pallas import packet_trace as jpt
from rt_rs_tpu_torch import Config, ComputeConfig, Renderer, Resolution
from rt_rs_tpu_torch.ops import packet_trace as pt
from rt_rs_tpu_torch.scene.presets import gather_band_torus, torus_row, torus_scene

# pytest-xdist runs several test processes at once; torch's default of
# one OpenMP thread per core in each of them oversubscribes the CPUs.
torch.set_num_threads(
    max(1, (os.cpu_count() or 1) // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))
)

ROOT = pathlib.Path(__file__).resolve().parent.parent
DATA = ROOT / "tests" / "data"
# stored frame -> (scene, width, height)
STORED = {
    "torch_port_torus_row2_96x72.npz": (lambda: torus_row(2), 96, 72),
    "torch_port_gather_band_32x16.npz": (gather_band_torus, 32, 16),
}
ATOL = 2e-5
FORCED_CAP = 16


def jax_frame(scene, width: int, height: int, bounces: int = 4) -> np.ndarray:
    """The JAX package's default pbvh frame of a port scene."""
    jr = rt_rs_tpu.Renderer(
        rt_rs_tpu.Scene.from_json(scene.to_json()),
        config=rt_rs_tpu.Config(
            compute=rt_rs_tpu.ComputeConfig(bounces=bounces),
            resolution=rt_rs_tpu.Resolution.sized(width, height),
        ),
        handler="pbvh",
    )
    return np.asarray(jr.render_frame())


def port_renderer(scene, width: int, height: int, bounces: int = 4, **kw) -> Renderer:
    cfg = Config(compute=ComputeConfig(bounces=bounces), resolution=Resolution.sized(width, height))
    return Renderer(scene, config=cfg, handler="pbvh", device="cpu", **kw)


@pytest.fixture
def forced(monkeypatch):
    monkeypatch.setattr(pt, "MAX_VMEM_CHUNKS", FORCED_CAP)
    monkeypatch.setattr(jpt, "MAX_VMEM_CHUNKS", FORCED_CAP)


@pytest.mark.parametrize("size,bounces", [((32, 16), 4), ((64, 48), 2)])
def test_segmented_frames_match_jax(forced, size, bounces):
    """Forced-segmented torus_scene, seg_order "auto" and "scene",
    against the JAX package's frame (its default, "auto")."""
    scene = torus_scene()
    ref = jax_frame(scene, *size, bounces=bounces)
    frames = {}
    for order in ("auto", "scene"):
        r = port_renderer(scene, *size, bounces=bounces, seg_order=order)
        assert isinstance(r.accel, pt.SegmentedTriChunks) and len(r.accel.segments) == 4
        frames[order] = r.render_frame().numpy()
        assert np.isfinite(frames[order]).all() and frames[order].mean() > 0.05
        np.testing.assert_allclose(frames[order], ref, rtol=0, atol=ATOL, err_msg=order)
    np.testing.assert_array_equal(frames["auto"], frames["scene"])


def test_gather_band_frame_matches_stored_jax_frame():
    r = port_renderer(gather_band_torus(), 32, 16)
    assert isinstance(r.accel, pt.TriChunks) and not pt.resident_fits(r.accel, with_attrs=True)
    _, rows_fn, anyhit_fn = r._bound(r._frame_handler())
    assert rows_fn is None and anyhit_fn is None  # the gather branch
    frame = r.render_frame().numpy()
    assert np.isfinite(frame).all() and frame.mean() > 0.05
    ref = np.load(DATA / "torch_port_gather_band_32x16.npz")["frame"]
    np.testing.assert_allclose(frame, ref, rtol=0, atol=ATOL)


def test_branches_bit_equal(monkeypatch):
    """One scene, five ways: the resident table's rows + any-hit frame
    and its gather frame (force_rows=False), and, under the forced cap,
    the segmented table's gather frame and rows + any-hit frame
    (force_rows=True) and the streamed table's frame."""
    scene = torus_scene()
    frames = {
        "resident rows": port_renderer(scene, 32, 16),
        "resident gather": port_renderer(scene, 32, 16, force_rows=False),
    }
    monkeypatch.setattr(pt, "MAX_VMEM_CHUNKS", FORCED_CAP)
    frames["segmented gather"] = port_renderer(scene, 32, 16)
    frames["segmented rows"] = port_renderer(scene, 32, 16, force_rows=True)
    frames["streamed"] = port_renderer(
        scene, 32, 16, handler_kwargs={"streaming_mode": "dma"}
    )
    kinds = {k: type(r.accel).__name__ for k, r in frames.items()}
    assert kinds["segmented gather"] == "SegmentedTriChunks"
    assert kinds["streamed"] == "TriChunks" and frames["streamed"].accel.attr is None
    frames = {k: r.render_frame().numpy() for k, r in frames.items()}
    base = frames.pop("resident rows")
    assert base.mean() > 0.05
    for name, f in frames.items():
        np.testing.assert_array_equal(f, base, err_msg=name)


def test_torus_row2_matches_stored_jax_frame():
    ref = np.load(DATA / "torch_port_torus_row2_96x72.npz")["frame"]
    r = port_renderer(torus_row(2), 96, 72)
    assert isinstance(r.accel, pt.SegmentedTriChunks) and len(r.accel.segments) == 2
    frame = r.render_frame().numpy()
    assert frame.mean() > 0.05
    np.testing.assert_allclose(frame, ref, rtol=0, atol=ATOL)


if __name__ == "__main__":
    import jax

    # Read when the first computation starts the CPU backend.
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "") + " --xla_cpu_max_isa=SSE4_2"
    ).strip()
    jax.config.update("jax_platforms", "cpu")
    for name, (make, width, height) in STORED.items():
        frame = jax_frame(make(), width, height)
        np.savez_compressed(DATA / name, frame=frame)
        print(f"wrote {DATA / name}: {frame.shape}, mean {frame.mean():.6f}")

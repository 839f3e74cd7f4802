"""rt_rs_tpu_torch frames with the pbvh frame knobs on.

Every knob of the JAX package's tiled frame path is output-exact
(rt_rs_tpu/ops/shade.py:580-622, rt_rs_tpu/ops/pallas/packet_trace.py:
1058-1070 and :990-995), so each knob's frame must equal the port's
default frame bit for bit, on the emit-rows and the gather branch where
the knob touches both.  One frame with the fused bounce kernel and early
exit is also held to the JAX package's frame with the same knobs at
atol 2e-5, the bound of tests/test_torch_render.py.
"""

from __future__ import annotations

import os
import warnings

import numpy as np
import pytest
import torch

import rt_rs_tpu
from rt_rs_tpu_torch import Config, ComputeConfig, Renderer, Resolution
from rt_rs_tpu_torch.bvh import build_bvh
from rt_rs_tpu_torch.ops import shade
from rt_rs_tpu_torch.renderer import retile_default
from rt_rs_tpu_torch.scene.presets import torus_row, torus_scene

# pytest-xdist runs several test processes at once; torch's default of
# one OpenMP thread per core in each of them oversubscribes the CPUs.
torch.set_num_threads(
    max(1, (os.cpu_count() or 1) // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))
)

SIZE = (48, 32)
ATOL = 2e-5


def render(scene=None, bounces: int = 4, size=SIZE, handler_kwargs=None, **kw) -> np.ndarray:
    cfg = Config(compute=ComputeConfig(bounces=bounces), resolution=Resolution.sized(*size))
    r = Renderer(
        torus_scene() if scene is None else scene, config=cfg, handler="pbvh", device="cpu",
        handler_kwargs=handler_kwargs, **kw,
    )
    return r.render_frame().numpy()


_DEFAULTS: dict = {}


def default_frame(bounces: int = 4, force_rows: bool | None = None) -> np.ndarray:
    """The default torus_scene frame (cached per bounces and branch)."""
    key = (bounces, force_rows)
    if key not in _DEFAULTS:
        _DEFAULTS[key] = render(bounces=bounces, force_rows=force_rows)
    return _DEFAULTS[key]


# name -> (bounces, branch: None = emit rows, False = gather, knobs)
CASES = {
    **{
        f"fuse_bounce-b{b}-{branch}": (b, fr, dict(fuse_bounce=True))
        for b in (1, 2, 4)
        for branch, fr in (("rows", None), ("gather", False))
    },
    "retile-rows": (4, None, dict(retile=True)),
    "retile-gather": (4, False, dict(retile=True)),
    "narrow-rows": (4, None, dict(narrow=128)),
    "narrow-gather": (4, False, dict(narrow=128)),
    "shadow_cull_off": (4, None, dict(shadow_cull=False)),
    "early_exit": (4, None, dict(handler_kwargs={"early_exit": True})),
    "early_exit-gather": (4, False, dict(handler_kwargs={"early_exit": True})),
    "refine_all": (4, None, dict(handler_kwargs={"refine": "all"})),
    "refine_off": (4, None, dict(handler_kwargs={"refine": "off"})),
    "cull_block_4": (4, None, dict(handler_kwargs={"cull_block": 4})),
    "block_none": (4, None, dict(block=None)),
    "ray_tile_128": (4, None, dict(handler_kwargs={"ray_tile": 128})),
    "tri_chunk_32": (4, None, dict(handler_kwargs={"tri_chunk": 32})),
}


@pytest.mark.parametrize("case", list(CASES))
def test_knob_frame_bit_equal_to_default(case):
    bounces, force_rows, kw = CASES[case]
    ours = render(bounces=bounces, force_rows=force_rows, **kw)
    ref = default_frame(bounces, force_rows)
    assert ours.mean() > 0.02
    np.testing.assert_array_equal(ours, ref)


def test_default_branches_agree():
    """The emit-rows and gather defaults the cases compare against are
    the same frame (bit for bit), so every knob is held to one frame."""
    np.testing.assert_array_equal(default_frame(), default_frame(force_rows=False))


def test_segmented_row2_frame_with_fuse_bounce_and_early_exit():
    """torus_row(2) (2 segments, gather branch) with the fused bounce
    kernel and early exit equals its default frame."""
    scene = torus_row(2)
    ours = render(scene, fuse_bounce=True, handler_kwargs={"early_exit": True})
    np.testing.assert_array_equal(ours, render(scene))


def test_camera_at_pos_early_exit_frame():
    """pos == at gives NaN ray directions; the early-exit frame equals
    the default frame (NaN where it is NaN)."""
    scene = torus_scene()
    scene.camera = type(scene.camera)((1.0, 1.0, 1.0), (1.0, 1.0, 1.0))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        ours = render(scene, size=(32, 16), handler_kwargs={"early_exit": True})
        ref = render(scene, size=(32, 16))
    np.testing.assert_array_equal(ours, ref)


def test_bvh_data_and_path(tmp_path):
    """A BvhData (or its JSON checkpoint) replaces the build."""
    scene = torus_scene()
    data = build_bvh(scene)
    path = tmp_path / "torus.bvh.json"
    data.save(str(path))
    np.testing.assert_array_equal(render(handler_kwargs={"data": data}), default_frame())
    np.testing.assert_array_equal(render(handler_kwargs={"path": str(path)}), default_frame())


def test_frame_with_knobs_matches_jax():
    """torus_scene at 64x48 with fuse_bounce and early_exit against the
    JAX package's Renderer with the same knobs."""
    scene = torus_scene()
    kw = dict(fuse_bounce=True, handler_kwargs={"early_exit": True})
    ours = render(scene, size=(64, 48), **kw)
    jr = rt_rs_tpu.Renderer(
        rt_rs_tpu.Scene.from_json(scene.to_json()),
        config=rt_rs_tpu.Config(resolution=rt_rs_tpu.Resolution.sized(64, 48)),
        handler="pbvh", **kw,
    )
    ref = np.asarray(jr.render_frame())
    assert ours.mean() > 0.05
    np.testing.assert_allclose(ours, ref, rtol=0, atol=ATOL)


def test_knob_errors():
    """Each refused combination raises ValueError naming its knob; the
    defaults are the JAX package's."""
    with pytest.raises(ValueError, match="retile"):
        render(retile=True, fuse_bounce=True)
    with pytest.raises(ValueError, match="narrow"):
        render(narrow=100)
    with pytest.raises(ValueError, match="early_exit"):
        render(handler_kwargs={"early_exit": True, "cull_block": 4})
    with pytest.raises(ValueError, match="refine"):
        render(handler_kwargs={"refine": "sometimes"})
    r = Renderer(torus_scene(), config=Config(resolution=Resolution.sized(16, 16)), handler="pbvh", device="cpu")
    assert (r.fuse_bounce, r.shadow_cull, r.retile, r.narrow) == (False, True, None, None)
    assert retile_default(1920 * 1080) is False and r.block == (16, 16)
    h = r.handler
    assert (h.early_exit, h.cull_block, h.refine, h.ray_tile, h.tri_chunk) == (
        False, None, "bounces", None, None,
    )
    # trace_tiled refuses retile with fuse_bounce before any work.
    with pytest.raises(ValueError, match="fuse_bounce"):
        shade.trace_tiled(
            r.arrays, None, r.config.compute, torch.zeros(8, 32, 256),
            torch.zeros(32, 256, dtype=torch.bool), torch.zeros(3),
            retile=True, fuse_bounce=True,
        )

"""rt_rs_tpu_torch.parallel: image bands x scene shards over CPU ranks.

One ``run_ranks`` call of four CPU ranks (gloo) renders every case of
``tests/torch_parallel_ranks.py``, the cases of ``tests/test_parallel.py``
on small scenes built in code: ``image_mesh(4)`` through ``naive`` and
pbvh (also with forced rows and a fixed wg of 16), ``image_mesh(2)``,
``hybrid_mesh(2, 2)`` at tri_chunk 8 (rows, and the gather branch),
``hybrid_mesh(1, 3)`` (a padded table), ``hybrid_mesh(1, 2)`` with the
resident cap lowered to 16 chunks inside the ranks (each shard runs its
slice segmented), the flat path (``torus_ghost()``) and the ``bvh``
handler's bands.  Each frame is held three ways: bit-equal to the
port's single-device ``Renderer`` frame; within atol 2e-5 (the repo's
frame rule) of the JAX package's ``make_sharded_render`` frame on the
same mesh shape, on the 8 virtual CPU devices of tests/conftest.py; and
its luminance equal on every rank, within rel 1e-4 of the single
frame's mean.  The error cases run inside the ranks and raise the JAX
package's types; the ranks' interpreters hold no JAX module.
"""

from __future__ import annotations

import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rt_rs_tpu
from rt_rs_tpu.config import ComputeConfig as JaxComputeConfig
from rt_rs_tpu.config import Resolution as JaxResolution
from rt_rs_tpu.handlers import get_handler as jax_handler
from rt_rs_tpu.ops.pallas import packet_trace as jpt
from rt_rs_tpu.parallel import hybrid_mesh as jax_hybrid_mesh
from rt_rs_tpu.parallel import image_mesh as jax_image_mesh
from rt_rs_tpu.parallel import make_sharded_render as jax_make_sharded_render
from rt_rs_tpu_torch import ComputeConfig, Config, Renderer
from rt_rs_tpu_torch.native import build as native_build
from rt_rs_tpu_torch.parallel.launch import backend_for, run_ranks
from rt_rs_tpu_torch.tools import load
from tests import torch_parallel_ranks as ranks

# pytest-xdist runs several test processes at once (see
# tests/test_torch_render.py); the ranks divide the host's cores again.
torch.set_num_threads(
    max(1, (os.cpu_count() or 1) // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))
)

ATOL = 2e-5
LUMA = np.array([0.2126, 0.7152, 0.0722], np.float32)
NAMES = list(ranks.CASES)


@pytest.fixture(scope="module")
def sharded() -> list[dict]:
    native_build.build()  # before the spawn: the ranks only load it
    return run_ranks(ranks.render_cases, ["cpu"] * ranks.WORLD, NAMES)


def single_frame(name: str) -> np.ndarray:
    shape, scene, hname, hkw, w, h, kw, _ = ranks.CASES[name]
    r = Renderer(
        ranks.make_scene(scene),
        config=Config(
            compute=ComputeConfig(bounces=ranks.BOUNCES), resolution=ranks.resolution(w, h, {})
        ),
        handler=hname, handler_kwargs=hkw or None, device="cpu",
    )
    return r.render_frame().numpy()


def jax_sharded_frame(name: str, monkeypatch) -> np.ndarray:
    shape, scene, hname, hkw, w, h, kw, cap = ranks.CASES[name]
    js = rt_rs_tpu.Scene.from_json(ranks.make_scene(scene).to_json())
    handler = jax_handler(hname, **hkw)
    accel, arrays = handler.build(js, js.pack())
    if cap is not None:
        monkeypatch.setattr(jpt, "MAX_VMEM_CHUNKS", cap)
    mesh = jax_image_mesh(shape[0]) if len(shape) == 1 else jax_hybrid_mesh(*shape)
    wg = kw.get("fixed_wg")
    fn = jax_make_sharded_render(
        handler, accel, arrays, JaxComputeConfig(bounces=ranks.BOUNCES), w, h, mesh,
        resolution=JaxResolution.fixed(w, h, wg) if wg else JaxResolution.sized(w, h),
        force_rows=kw.get("force_rows"),
    )
    frame, _ = fn(
        jnp.asarray(js.camera.pos, jnp.float32), jnp.asarray(js.camera.at, jnp.float32)
    )
    return np.asarray(frame)


def rank_frames(sharded, name: str) -> list[tuple[np.ndarray, float]]:
    """The case's (frame, luminance) from every rank of its mesh."""
    got = [r["frames"][name] for r in sharded if name in r["frames"]]
    assert len(got) == math.prod(ranks.CASES[name][0])
    return got


@pytest.mark.parametrize("name", NAMES)
def test_sharded_frame_equals_single(sharded, name):
    single = single_frame(name)
    got = rank_frames(sharded, name)
    for frame, _ in got:
        assert frame.shape == single.shape
        np.testing.assert_array_equal(frame, single)
    lums = {lum for _, lum in got}
    assert len(lums) == 1, lums
    assert lums.pop() == pytest.approx(float((single @ LUMA).mean()), rel=1e-4)


@pytest.mark.parametrize("name", NAMES)
def test_sharded_frame_near_jax(sharded, name, monkeypatch):
    ref = jax_sharded_frame(name, monkeypatch)
    frame, _ = rank_frames(sharded, name)[0]
    np.testing.assert_allclose(frame, ref, rtol=0, atol=ATOL)


def test_errors_raise_jax_types(sharded):
    expect = {
        "height must divide": "ValueError",
        "no rays axis": "ValueError",
        "naive with shards": "TypeError",
        "negative materials with shards": "ValueError",
        "prim ids past 2^24": "ValueError",
        "hybrid mesh larger than the world": "ValueError",
        "image mesh larger than the world": "ValueError",
    }
    for r in sharded:
        assert r["errors"] == expect, r["rank"]


def test_ranks_import_no_jax(sharded):
    assert [r["rank"] for r in sharded] == list(range(ranks.WORLD))
    for r in sharded:
        assert r["modules"] == [], r["rank"]


def test_load_bands_shards_cpu_png(tmp_path, capfd):
    """``load --bands 2 --shards 2 --device cpu`` writes the PNG that
    the one-device ``load`` writes."""
    scene = tmp_path / "torus.json"
    ranks.make_scene("torus").save(str(scene))
    common = [
        "--path", str(scene), "--handler-pbvh", "--width", "32", "--height", "24",
        "--frames", "2", "--bounces", "2", "--device", "cpu",
    ]
    assert load.main([*common, "--out", str(tmp_path / "one.png")]) == 0
    assert load.main(
        [*common, "--bands", "2", "--shards", "2", "--out", str(tmp_path / "four.png")]
    ) == 0
    out = capfd.readouterr().out
    assert "on mesh {'rays': 2, 'scene': 2}" in out and "ms/frame" in out
    assert (tmp_path / "four.png").read_bytes() == (tmp_path / "one.png").read_bytes()


def test_load_bands_on_cuda_needs_the_cards(tmp_path, capfd):
    """``load --bands 2 --device cuda`` on a host with fewer cards exits
    naming the count, and renders nothing."""
    scene = tmp_path / "torus.json"
    ranks.make_scene("torus").save(str(scene))
    have = torch.cuda.device_count()
    with pytest.raises(SystemExit) as e:
        load.main([
            "--path", str(scene), "--handler-pbvh", "--bands", str(have + 1),
            "--device", "cuda", "--out", str(tmp_path / "x.png"),
        ])
    assert f"needs {have + 1} devices; torch sees {have} CUDA device(s)" in str(e.value.code)
    assert not (tmp_path / "x.png").exists()
    assert "[ranks]" not in capfd.readouterr().out


@pytest.mark.parametrize(
    "mode, error, timeout", [("raise", RuntimeError, 300.0), ("hang", TimeoutError, 8.0)]
)
def test_run_ranks_raises_on_a_failed_rank(mode, error, timeout):
    with pytest.raises(error, match="rank 1 raised" if mode == "raise" else "did not finish"):
        run_ranks(ranks.fail_or_hang, ["cpu", "cpu"], mode, timeout=timeout)


def test_backend_rule():
    assert backend_for(["cuda:0", "cuda:1"]) == "nccl"
    assert backend_for(["cuda:0"]) == "nccl"
    assert backend_for(["cuda:0", "cuda:0"]) == "gloo"
    assert backend_for(["cpu"] * 4) == "gloo"
    assert backend_for(["cuda:0", "cpu"]) == "gloo"

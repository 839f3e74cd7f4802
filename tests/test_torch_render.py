"""rt_rs_tpu_torch frames against the JAX package's pbvh frames.

Both packages render the same file-free scene (the port's
``torus_scene``, loaded by the JAX package through its JSON); the JAX
package runs its Pallas kernels in interpret mode on the CPU, the port
runs its kernels' plain-PyTorch twins on the CPU.  The frame tolerance
is atol 2e-5, the bound the JAX package holds between its own two frame
paths (tests/test_shade_tiled.py).  The JAX frames come from XLA:CPU,
which contracts the Möller–Trumbore arithmetic into FMAs (hit distances
move by up to ~2.6e-6 relative) where the port rounds every op
separately; barycentric normal interpolation and four bounces carry
that into the colour (measured max 1.1e-5 at 64x48, 9.2e-6 at 37x23).

``tests/data/torch_port_torus_96x72.npz`` is the JAX package's frame of
``torus_scene`` at 96x72; ``chip_smoke.py`` holds the port's CUDA frame
to it.  It is rendered with XLA:CPU held to SSE4.2
(``--xla_cpu_max_isa=SSE4_2``), which leaves XLA no FMA to contract
into, so the JAX frame rounds op by op like the port (measured max
1.1e-6 against the port's CPU frame; 3.9e-5 without the cap).
Regenerate it with ``PYTHONPATH=. python tests/test_torch_render.py``.
"""

from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import rt_rs_tpu
from rt_rs_tpu_torch import (
    Config,
    ComputeConfig,
    DynamicRenderer,
    Renderer,
    Resolution,
    Scene,
    run_headless,
)
from rt_rs_tpu_torch.handlers import get_handler
from rt_rs_tpu_torch.ops import shade
from rt_rs_tpu_torch.scene.presets import random_soup, torus_scene

# pytest-xdist runs several test processes at once; torch's default of
# one OpenMP thread per core in each of them oversubscribes the CPUs,
# and the spinning threads slowed these tests about tenfold.
torch.set_num_threads(
    max(1, (os.cpu_count() or 1) // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))
)

ROOT = pathlib.Path(__file__).resolve().parent.parent
REF_FRAME = ROOT / "tests" / "data" / "torch_port_torus_96x72.npz"
ATOL = 2e-5


def _config(width: int, height: int, **compute) -> Config:
    return Config(
        compute=ComputeConfig(**compute), resolution=Resolution.sized(width, height)
    )


def jax_frame(scene: Scene, width: int, height: int) -> np.ndarray:
    """The JAX package's default pbvh frame of a port scene."""
    jr = rt_rs_tpu.Renderer(
        rt_rs_tpu.Scene.from_json(scene.to_json()),
        config=rt_rs_tpu.Config(resolution=rt_rs_tpu.Resolution.sized(width, height)),
        handler="pbvh",
    )
    return np.asarray(jr.render_frame())


def port_frame(scene: Scene, width: int, height: int) -> np.ndarray:
    return Renderer(scene, config=_config(width, height), handler="pbvh", device="cpu").render_frame().numpy()


@pytest.mark.parametrize("size", [(64, 48), (37, 23)])
def test_frame_matches_jax(size):
    scene = torus_scene()
    ours, ref = port_frame(scene, *size), jax_frame(scene, *size)
    assert ours.shape == ref.shape == (size[1], size[0], 3)
    assert np.isfinite(ours).all() and ours.mean() > 0.05
    np.testing.assert_allclose(ours, ref, rtol=0, atol=ATOL)


def test_frame_matches_stored_jax_frame():
    ref = np.load(REF_FRAME)["frame"]
    ours = port_frame(torus_scene(), 96, 72)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=ATOL)


def test_run_headless_writes_png(tmp_path):
    from rt_rs_tpu_torch.utils.image import read_png

    path = tmp_path / "soup.json"
    random_soup(3, 40).save(str(path))
    out = tmp_path / "soup.png"
    r = run_headless(str(path), size=(32, 24), frames=2, out_path=str(out), device="cpu")
    img = read_png(str(out))
    assert img.shape == (24, 32, 3) and img.dtype == np.uint8
    assert img.max() > 0
    # The default handler is bvh, as in the JAX package: 48 B a node.
    assert r.stats.name == "BVH" and r.stats.size == 48 * r.handler.bvh_data.num_nodes > 0
    # Two frames rendered, each followed by an orbit step.
    assert r.camera == Scene.load(str(path)).camera.orbited(1.0).orbited(1.0)


def test_render_image_is_the_u8_store_of_the_frame():
    r = Renderer(random_soup(5, 30), config=_config(24, 16), handler="pbvh", device="cpu")
    frame = r.render_frame().numpy()
    expect = np.round(np.clip(frame, 0.0, 1.0) * 255.0).astype(np.uint8)
    np.testing.assert_array_equal(r.render_image(), expect)


def test_animate_orbits_and_times():
    r = Renderer(random_soup(7, 20), config=_config(16, 16), handler="pbvh", device="cpu")
    seen = []
    times = r.animate(3, sync_every=2, on_frame=lambda i, f, dt: seen.append(i))
    assert len(times) == 3 and all(t > 0 for t in times) and seen == [0, 1, 2]
    # K frames per dispatch: the same protocol (tests/test_torch_chain.py).
    seen = []
    times = r.animate(3, sync_every=2, chain=2, on_frame=lambda i, f, dt: seen.append(i))
    assert len(times) == 3 and all(t > 0 for t in times) and seen == [0, 1, 2]


def test_update_config_rebinds_bounces():
    r = Renderer(torus_scene(), config=_config(16, 16), handler="pbvh", device="cpu")
    four = r.render_frame().numpy()
    r.update_config(ComputeConfig(bounces=1))
    one = r.render_frame().numpy()
    assert not np.array_equal(four, one)
    expect = Renderer(torus_scene(), config=_config(16, 16, bounces=1), handler="pbvh", device="cpu")
    np.testing.assert_array_equal(one, expect.render_frame().numpy())


def test_unported_paths_raise():
    # The lbvh handler, pbvh's dual tables and DynamicRenderer are ported
    # (tests/test_torch_lbvh.py, test_torch_dual.py, test_torch_dynamic.py).
    assert get_handler("lbvh").name == "LBVH"
    r = Renderer(
        random_soup(3, 10), config=_config(16, 16), handler="pbvh",
        handler_kwargs={"tri_chunk_fine": 16}, device="cpu",
    )
    assert r.accel.fine.tri_chunk == 16 and r.render_frame().shape == (16, 16, 3)
    assert DynamicRenderer(random_soup(3, 10), config=_config(16, 16), device="cpu").render_frame().shape == (16, 16, 3)
    neg = random_soup(1, 10)
    neg.prim_material[0] = -1
    # Negative materials take the flat path; the tiled one refuses them,
    # as the JAX package's does.
    with pytest.raises(ValueError, match="negative"):
        shade.trace_tiled(
            neg.pack(device="cpu"), None, ComputeConfig(), torch.zeros(8, 32, 256),
            torch.zeros(32, 256, dtype=torch.bool), torch.zeros(3),
        )
    # animate(chain=K) is ported: its first frame is render_frame's.
    r = Renderer(random_soup(2, 10), config=_config(16, 16), handler="pbvh", device="cpu")
    frame = r.render_frame()
    got = []
    r.animate(2, chain=2, on_frame=lambda i, f, dt: got.append(f))
    assert len(got) == 2 and torch.equal(got[0], frame)


def test_camera_at_pos_warns():
    scene = random_soup(4, 10)
    scene.camera = type(scene.camera)((1.0, 1.0, 1.0), (1.0, 1.0, 1.0))
    with pytest.warns(UserWarning, match="pos == at"):
        Renderer(scene, config=_config(16, 16), handler="pbvh", device="cpu")


def test_port_never_imports_jax():
    code = (
        "import sys\n"
        "from rt_rs_tpu_torch import Config, Renderer, Resolution\n"
        "from rt_rs_tpu_torch.scene.presets import torus_scene\n"
        "cfg = Config(resolution=Resolution.sized(16, 16))\n"
        "img = Renderer(torus_scene(), config=cfg, device='cpu').render_image()\n"
        "assert img.shape == (16, 16, 3) and img.max() > 0\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'rt_rs_tpu'))\n"
        "print(bad)\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


if __name__ == "__main__":
    import os

    import jax

    # Read when the first computation starts the CPU backend.
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "") + " --xla_cpu_max_isa=SSE4_2"
    ).strip()
    jax.config.update("jax_platforms", "cpu")
    REF_FRAME.parent.mkdir(parents=True, exist_ok=True)
    frame = jax_frame(torus_scene(), 96, 72)
    np.savez_compressed(REF_FRAME, frame=frame)
    print(f"wrote {REF_FRAME}: {frame.shape}, mean {frame.mean():.6f}")

"""Orbit-animation writer (counterpart of ``rt_rs_tpu/utils/animation.py``).

The reference's visual output is a live window / browser canvas; the
headless equivalent is an animated GIF of the orbit, the artifact the
study's "5 orbit rotations" protocol produces when you want to *see*
the benchmark run.  GIF encoding needs PIL, imported where it is used.
"""

from __future__ import annotations

import math
import time
from pathlib import Path

import numpy as np

from rt_rs_tpu_torch.scene.camera import ORBIT_RATE


def write_gif(path: str, frames: list[np.ndarray], fps: int = 20) -> None:
    """Write uint8 RGB frames as an animated GIF."""
    from PIL import Image

    if not frames:
        raise ValueError("no frames to write")
    images = [Image.fromarray(f, mode="RGB") for f in frames]
    images[0].save(
        path,
        save_all=True,
        append_images=images[1:],
        duration=int(1000 / fps),
        loop=0,
    )


def render_orbit_gif(
    renderer,
    path: str,
    frames: int = 60,
    rotations: float = 1.0,
    fps: int = 20,
) -> list[float]:
    """Render ``rotations`` camera orbits in ``frames`` frames to a GIF
    -> per-frame seconds (each frame's ``render_image``, its copy to the
    host included)."""
    mult = (rotations * 2.0 * math.pi) / frames / ORBIT_RATE
    collected: list[np.ndarray] = []
    times: list[float] = []
    for _ in range(frames):
        t0 = time.perf_counter()
        image = renderer.render_image()
        times.append(time.perf_counter() - t0)
        collected.append(image)
        renderer.orbit(mult)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    write_gif(path, collected, fps=fps)
    return times

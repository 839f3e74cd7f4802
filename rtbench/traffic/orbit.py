"""Traffic kind ``orbit``: the camera orbits and ``Renderer.animate``
renders the frames.

A mix of this kind gives ``chain``, the frames of a dispatch
(``animate(chain=)``: one CUDA graph replay a dispatch; 1 renders each
frame eagerly); ``mult``, the orbit step a frame; ``frames_per_sync``,
the frames of one ``animate`` call, which syncs the device at its end;
``warmup_syncs``, the calls made before the window; and
``trace_seconds``, the length of the profiled window.  The seed picks
the starting angle; frame ``i`` of a window is ``i`` steps on from it.

A kind module gives :func:`strata`, :func:`cameras`, :func:`warm_up`
and :func:`loop`, and may give ``geometry`` (see ``breathe.py``);
``rtbench/drive.py`` calls them.
"""

from __future__ import annotations

import time

import torch

from rtbench import sampling
from rtbench.reference import orbit_camera


def strata(mix: dict) -> int:
    """The sampler's strata: one per position in a chained dispatch."""
    return int(mix["chain"])


def cameras(mix: dict, seed: int, scene, frame_ids) -> list[tuple[tuple, tuple]]:
    """(position, target) of each frame of a window, worked out from the
    configuration's camera, the seed's starting angle and the steps."""
    a0 = sampling.start_angle(seed)
    step = sampling.ORBIT_RATE * float(mix["mult"])
    at = scene.camera_at
    return [(orbit_camera(scene.camera_pos, at, a0 + step * int(i)), at) for i in frame_ids]


def warm_up(runner, seed: int) -> None:
    """The window's calls, ``warmup_syncs`` of them: the chain's graph
    captured and replayed, and the sampler's gathers."""
    for _ in range(int(runner.mix["warmup_syncs"])):
        loop(runner, 0.0, runner.sampler(seed))


def loop(runner, seconds: float, sampler=None, series=None) -> tuple[int, float]:
    """``animate`` calls of ``frames_per_sync`` frames, through
    ``runner.animate`` (which hands the program a kind's geometry), until
    ``seconds`` have passed at the end of one -> (frames, wall seconds).  Offers
    each frame to ``sampler``; appends each call's seconds a frame to
    ``series["frame, by sync"]``."""
    mix = runner.mix
    batch = int(mix["frames_per_sync"])
    index = {}
    if sampler is not None:
        index = {k: torch.as_tensor(p, device=runner.device) for k, p in enumerate(sampler.pixel_sets)}
    done = 0

    def on_frame(i, frame, dt):
        if sampler is not None:
            sampler.offer(done + i, lambda k: frame.reshape(-1, 3)[index[k]])

    t0 = tb = time.perf_counter()
    while True:
        runner.animate(
            batch, done, orbit_mult=float(mix["mult"]), sync_every=batch, on_frame=on_frame, chain=int(mix["chain"])
        )
        done += batch
        now = time.perf_counter()
        if series is not None:
            series.setdefault("frame, by sync", []).append((now - tb) / batch)
        tb = now
        if now - t0 >= seconds:
            break
    return done, time.perf_counter() - t0

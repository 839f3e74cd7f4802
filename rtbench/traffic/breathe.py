"""Traffic kind ``breathe``: the camera orbits as in ``orbit`` while the
whole scene breathes, every frame, by a uniform scale about the origin.

The loop, the warm-up, the strata and the cameras are ``orbit``'s
(``chain``, ``mult``, ``frames_per_sync``, ``warmup_syncs``,
``trace_seconds``).  :func:`geometry` gives each frame's vertex arrays;
``drive.Runner.animate`` hands them to the program as
``animate(vertex_fn=...)``, made on the host for each frame as the
program asks for it, which the program stacks and uploads with each
dispatch; ``harness.judge`` hands the same function's arrays to the
reference.

The mix's ``breathe`` gives ``amp`` and ``rate``.  Frame ``i`` scales
every vertex of the rest pose (the floor's too) by::

    s(i) = 1 + amp * sin(rate * (i + i0))

and keeps the rest pose's normals, which a uniform scale leaves as they
are; the seed picks the phase ``i0`` in ``[0, ceil(2 pi / rate))``.  This
is the animated teapot of ``BASELINE.json`` configs[4] as the
repository's ``experiments/baseline_configs.py`` (config 5) drives it:
``amp`` 0.01, ``rate`` 0.3, the "1% breathing wobble".  The scale is
worked out in float64 from the rest pose's float32 arrays and rounded
to float32, so frame ``i``'s arrays are a pure function of the mix, the
seed and ``i``; every seed's window runs the same cycle of scales from
another phase.
"""

from __future__ import annotations

import math

import numpy as np

from rtbench import sampling, spec

_orbit = spec.kind("orbit")
strata, cameras, warm_up, loop = _orbit.strata, _orbit.cameras, _orbit.warm_up, _orbit.loop


def phase(mix: dict, seed: int) -> int:
    """The seed's phase ``i0``, in frames: one cycle of the sine."""
    cycle = math.ceil(2.0 * math.pi / float(mix["breathe"]["rate"]))
    return int(sampling.rng(seed, sampling.STREAM_KIND).integers(0, cycle))


def geometry(mix: dict, seed: int, scene, frame_ids) -> list[tuple[np.ndarray, np.ndarray]]:
    """(vert_pos, vert_norm), float32 [V, 3] each, of each frame of a
    window."""
    amp, rate, i0 = float(mix["breathe"]["amp"]), float(mix["breathe"]["rate"]), phase(mix, seed)
    pos = np.asarray(scene.vert_pos, np.float64)
    return [
        ((pos * (1.0 + amp * math.sin(rate * (int(i) + i0)))).astype(np.float32),
         np.array(scene.vert_norm, np.float32, copy=True))
        for i in frame_ids
    ]

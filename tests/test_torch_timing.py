"""rt_rs_tpu_torch's timing layer (``timing/``) against the JAX package's.

``BenchScheduler`` of both packages, fed the same seeded frame times,
keeps the same per-frame times, chart points and running average (the
10-frame cadence and ``finish()``'s rule against a duplicate last
point included), and writes its chart.  ``run_benchmark_protocol``
records one time per frame and leaves the camera where the JAX
protocol leaves it (10 frames: the JAX side's Pallas kernels run in
interpret mode here).
"""

from __future__ import annotations

import os
import time

import numpy as np
import pytest
import torch

import rt_rs_tpu
from rt_rs_tpu import timing as jtiming
from rt_rs_tpu.handlers.base import IntrsStats as JaxIntrsStats
from rt_rs_tpu_torch import Config, Renderer, Resolution, timing
from rt_rs_tpu_torch.handlers.base import IntrsStats
from rt_rs_tpu_torch.scene.presets import torus_scene

torch.set_num_threads(
    max(1, (os.cpu_count() or 1) // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))
)


def test_default_scheduler_paces():
    s = timing.DefaultScheduler(fps=50)  # 20 ms period
    s.frame_done()
    assert not s.ready()
    time.sleep(0.025)
    assert s.ready()
    s.record(0.5)
    s.finish()


@pytest.mark.parametrize("frames", [20, 25])
def test_bench_scheduler_matches_jax(tmp_path, frames):
    """25 frames: points at 10, 20 and a last one at 25; 20 frames: the
    point at 20 is the last (no duplicate)."""
    dts = np.random.default_rng(frames).uniform(0.001, 0.05, frames).tolist()
    ours = timing.BenchScheduler(IntrsStats("X", 123), out_path=str(tmp_path / "ours.png"))
    theirs = jtiming.BenchScheduler(JaxIntrsStats("X", 123), out_path=str(tmp_path / "jax.png"))
    for dt in dts:
        ours.record(dt)
        theirs.record(dt)
    ours.finish()
    theirs.finish()
    assert ours.times_ms == theirs.times_ms == [dt * 1e3 for dt in dts]
    assert ours.averages == theirs.averages
    assert len(ours.averages) == -(-frames // timing.GRAPH_ENTRY_INTERVAL)
    assert ours.running_average_ms == theirs.running_average_ms
    assert (tmp_path / "ours.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def test_bench_scheduler_empty_and_interval(tmp_path):
    s = timing.BenchScheduler(IntrsStats("X", 1), out_path=str(tmp_path / "c.png"), interval=5)
    assert s.running_average_ms == 0.0
    s.finish()  # nothing recorded: no chart
    assert not (tmp_path / "c.png").exists()
    for _ in range(10):
        s.record(0.010)
    s.finish()
    assert abs(s.running_average_ms - 10.0) < 1e-6
    assert len(s.averages) == 2
    assert (tmp_path / "c.png").exists()


def test_protocol_matches_jax_camera(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    scene = torus_scene(segments=(24, 12))
    config = Config(resolution=Resolution.sized(32, 24))
    r = Renderer(scene, config=config, handler="pbvh", device="cpu")
    sched, mean_ms = timing.run_benchmark_protocol(r, frames=10)
    assert len(sched.times_ms) == 10
    assert all(np.isfinite(t) and t > 0 for t in sched.times_ms)
    assert mean_ms == sched.running_average_ms
    assert (tmp_path / "benchmark.png").exists()

    jscene = rt_rs_tpu.Scene.from_json(scene.to_json())
    jr = rt_rs_tpu.Renderer(
        jscene, config=rt_rs_tpu.Config(resolution=rt_rs_tpu.Resolution.sized(32, 24)),
        handler="pbvh",
    )
    jsched, _ = jtiming.run_benchmark_protocol(jr, frames=10)
    assert len(jsched.times_ms) == 10
    np.testing.assert_allclose(r.camera.pos, jr.camera.pos, rtol=0, atol=1e-6)
    np.testing.assert_allclose(r.camera.at, jr.camera.at, rtol=0, atol=1e-6)

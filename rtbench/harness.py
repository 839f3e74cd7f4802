"""One run of one cell: set-up, warm-up, the window, the trace, the
comparison, and the result's line.

:func:`run` is the whole run but the look for a card, which
``rtbench/run.py`` makes first; the tests call it on the CPU at small
sizes, also with the timed path broken underneath (``rtbench/faults.py``).
"""

from __future__ import annotations

import dataclasses
import gc
import time

import numpy as np
import torch

from rtbench import accel, check, guard, scenes, spec
from rtbench.drive import Runner
from rtbench.reference import Reference


@dataclasses.dataclass
class Cell:
    """A cell's files: its configuration, traffic mix and limits, and
    the scene they give."""

    name: str
    config: dict
    traffic: dict
    limits: dict
    scene: scenes.SceneData

    @classmethod
    def load(cls, bench: dict, name: str, traffic: dict | None = None) -> "Cell":
        w = spec.workload(bench, name)
        config = spec.config(bench, w["config"])
        return cls(
            name, config, traffic or spec.traffic(w["traffic"]), spec.limits(name), scenes.build(config)
        )


def reference_frames(cell: Cell, seed: int, ids, views, device, dtype=torch.float32) -> list[np.ndarray]:
    """The reference's colours of each view (camera position, target,
    pixel indices) of window frames ``ids``, computed in ``dtype``.  Where
    the cell's traffic kind gives geometry (``geometry``), each frame is
    traced in its own scene: the configuration's, with that frame's
    vertex arrays."""
    t = cell.traffic
    width, height = int(t["width"]), int(t["height"])
    compute = cell.config["compute"]
    geometry = getattr(spec.kind(t["kind"]), "geometry", None)
    if geometry is None:
        return Reference(cell.scene, compute, device, dtype).frames(views, width, height)
    return [
        Reference(dataclasses.replace(cell.scene, vert_pos=vp, vert_norm=vn), compute, device, dtype).frames(
            [view], width, height
        )[0]
        for (vp, vn), view in zip(geometry(t, seed, cell.scene, ids), views)
    ]


def judge(cell: Cell, seed: int, samples, device, control_dtype=None) -> tuple[bool, dict, list[float]]:
    """Compare the window's sampled pixels with the reference ->
    (correct, the numbers beside their limits, each frame's share off).
    ``control_dtype``: put the reference computed in that type in the
    program's place (the control)."""
    t = cell.traffic
    ids = [i for i, _, _ in samples]
    cams = spec.kind(t["kind"]).cameras(t, seed, cell.scene, ids)
    views = [(pos, at, pix) for (pos, at), (_, pix, _) in zip(cams, samples)]
    want = reference_frames(cell, seed, ids, views, device)
    if control_dtype is None:
        got = [np.asarray(px) for _, _, px in samples]
    else:
        got = reference_frames(cell, seed, ids, views, device, control_dtype)
    values, per_frame = check.numbers(list(zip(got, want)))
    ok, checks = check.verdict(values, cell.limits)
    return ok, checks, per_frame


def device_info(device: torch.device, chips: int) -> dict:
    if device.type == "cuda":
        return {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(device),
            "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device)),
        }
    return {"platform": "cpu", "kind": "cpu", "count": chips, "memory_peak_bytes": 0}


def run(
    bench: dict, name: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
    traffic: dict | None = None, log=print,
) -> dict:
    """One run of cell ``name`` -> the result's line (a dict).  ``log``
    takes the lines for standard error; ``traffic`` replaces the cell's
    mix (tests)."""
    cell = Cell.load(bench, name, traffic)
    w = spec.workload(bench, name)
    dev = torch.device(device)
    runner = Runner(cell.scene, cell.config, cell.traffic, device)
    accel_bytes = accel.tensor_bytes(runner.structure(), dev)
    stats = f"{type(runner.r).__name__}.stats {runner.r.stats}"
    runner.warm_up(seed)
    setup_s = guard.process_age_s()
    win = runner.window(seed, seconds)
    traced = runner.traced(seed, float(cell.traffic["trace_seconds"])) if trace else None
    runner.sync()
    win.setup_s, win.accel_bytes = setup_s, accel_bytes
    win.device = info = device_info(dev, int(w["chips"]))
    samples = [(i, pix, px.cpu().numpy() if torch.is_tensor(px) else px) for i, pix, px in win.sampler.samples()]
    runner.close()
    del runner
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    ok, checks, per_frame = judge(cell, seed, samples, dev)
    log(f"reference: {time.perf_counter() - t_ref:.3f} s")
    failed = sum(1 for s in per_frame if s > checks["worst_frame"]["limit"])

    log(f"window: {win.frames} frames in {win.wall_s:.6f} s; setup {setup_s:.6f} s")
    log(f"accel_bytes {accel_bytes} (the port's structure on the card); {stats}")
    for what, xs in win.series.items():
        q = np.percentile(np.asarray(xs) * 1e3, [0, 25, 50, 75, 100])
        log(f"ms per {what}, min / quartiles / max: {' / '.join(f'{v:.4f}' for v in q)} over {len(xs)}")
    # --trace 0 reports the cell's end-to-end metrics, read from the
    # window; --trace 1 its per-layer metrics, read from the trace
    section, source = ("per_layer", traced) if trace else ("end_to_end", win)
    metrics = {}
    for m in spec.metrics_of(bench, section, name):
        value = spec.metric_reader(m["name"]).read(source)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    if trace:
        info["busy_s"] = traced.busy_s()
        info["window_s"] = traced.window_s
        log(f"traced window: {traced.frames} frames in {traced.window_s:.6f} s, busy {info['busy_s']:.6f} s")
    result = {
        "correct": ok,
        "attempted": win.frames,
        "failed": failed,
        "metrics": metrics,
        "device": info,
    }
    if trace:
        result["breakdown"] = traced.breakdown()
    log(f"compared {len(samples)} frames, {sum(len(p) for _, p, _ in samples)} pixels")
    for n, c in checks.items():
        log(f"check {n} {c['value']!r} limit {c['limit']!r}")
    result["checks"] = checks
    return result

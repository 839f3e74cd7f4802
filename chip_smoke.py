#!/usr/bin/env python3
"""On-card smoke run of rt_rs_tpu_torch's frame path (one NVIDIA GPU).

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (each prints its own lines; any failure raises and the script
exits nonzero without printing a result):

1. Device: asserts CUDA; prints torch / CUDA / nvcc versions and the
   card's name and power limit.
2. Build: compiles the hand-written kernels (rt_rs_tpu_torch/csrc) with
   nvcc and prints the build time and each kernel's register use.
3. Kernels vs twins on the card: records every kernel call of one
   ``torus_scene`` frame at 384x288 (primary rows call, per-bounce
   refine culls, any-hit shadow batches and rows calls, shade_pre and
   shade_post of every bounce) and replays each through the kernel and
   through its plain-PyTorch twin.  Intersection and refine outputs
   (t, pid, rows, blocked, overlap mask, compacted ids and counts) must
   be bit-equal; shading outputs within 4 ULP (the twins use torch's
   rsqrt / pow, whose CUDA builds may round differently from the
   kernels' rsqrtf / powf; measured bit-equal so far).
4. Frames: ``Renderer(torus_scene(), handler="pbvh", device="cuda")`` at
   96x72 (held to the JAX package's stored frame within atol 2e-5,
   tests/data/torch_port_torus_96x72.npz), 384x288 and 1920x1080
   (finite, the right shape, not black).
5. Timing (CUDA events): a 60-frame orbit at 384x288 and a 12-frame one
   at 1080p (bench.py's protocol), then every kernel against its twin at
   the 384x288 shapes.  Launch counters are reset right before phase 4
   and read right after the orbits: every kernel of the path must have
   launched.

The second-to-last lines are one JSON object of per-kernel results and
the ``nvidia-smi`` name / power-limit line; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

REF_FRAME = ROOT / "tests" / "data" / "torch_port_torus_96x72.npz"
# The bound the JAX package holds between its own two frame paths
# (tests/test_shade_tiled.py).  The stored frame was rendered with
# XLA:CPU held to SSE4.2, so no FMA contraction (see
# tests/test_torch_render.py); it rounds op by op like the port.
REF_ATOL = 2e-5
SHADE_MAX_ULP = 4
SIZES = {"384x288": (384, 288, 60), "1920x1080": (1920, 1080, 12)}

# name -> (source, the TPU kernel it replaces)
KERNELS = {
    "refine_cull": (
        "rt_rs_tpu_torch/csrc/refine_cull.cu",
        "rt_rs_tpu/ops/pallas/packet_trace.py:497",
    ),
    "mt_trace[rows]": (
        "rt_rs_tpu_torch/csrc/mt_trace.cu",
        "rt_rs_tpu/ops/pallas/packet_trace.py:746",
    ),
    "mt_trace[anyhit]": (
        "rt_rs_tpu_torch/csrc/mt_trace.cu",
        "rt_rs_tpu/ops/pallas/packet_trace.py:746",
    ),
    "shade_pre": (
        "rt_rs_tpu_torch/csrc/shade_pre.cu",
        "rt_rs_tpu/ops/pallas/shade_tile.py:195",
    ),
    "shade_post": (
        "rt_rs_tpu_torch/csrc/shade_post.cu",
        "rt_rs_tpu/ops/pallas/shade_tile.py:226",
    ),
}


def say(*parts) -> None:
    print(*parts, flush=True)


def sh(cmd: list[str]) -> str:
    return subprocess.run(cmd, capture_output=True, text=True, check=True).stdout


def card_line() -> str:
    return sh(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]
    ).strip().splitlines()[0]


# ----------------------------------------------------------------------
# comparisons


def _ordered(x):
    """f32 bits mapped to integers that are ordered like the floats."""
    import torch

    i = x.contiguous().view(torch.int32).to(torch.int64)
    return torch.where(i < 0, -(i & 0x7FFFFFFF), i)


def max_ulp(a, b) -> int:
    """Largest distance in units of the last place (NaN == NaN)."""
    import torch

    d = (_ordered(a) - _ordered(b)).abs()
    d = torch.where(torch.isnan(a) & torch.isnan(b), 0, d)
    return int(d.max()) if d.numel() else 0


def max_abs(a, b) -> float:
    import torch

    if a.dtype == torch.bool:
        return float((a != b).any())
    d = (a.double() - b.double()).abs()
    d = torch.where(torch.isnan(a) & torch.isnan(b), 0, d)
    return float(torch.nan_to_num(d, nan=math.inf).max()) if d.numel() else 0.0


def outputs(x) -> list:
    return [o for o in (x if isinstance(x, tuple) else (x,)) if o is not None]


def check_equal(what: str, kern, twin) -> float:
    """Bit-equal (NaN == NaN) -> max abs error (0.0)."""
    err = 0.0
    for i, (a, b) in enumerate(zip(outputs(kern), outputs(twin), strict=True)):
        if a.dtype.is_floating_point and max_ulp(a, b) != 0:
            raise AssertionError(
                f"{what} output {i}: kernel != twin (max {max_ulp(a, b)} ULP)"
            )
        if not a.dtype.is_floating_point and not bool((a == b).all()):
            raise AssertionError(
                f"{what} output {i}: kernel != twin "
                f"({int((a != b).sum())} mismatches)"
            )
        err = max(err, max_abs(a, b))
    return err


def check_ulp(what: str, kern, twin) -> tuple[float, int]:
    """Within SHADE_MAX_ULP -> (max abs error, max ULP)."""
    err, ulp = 0.0, 0
    for i, (a, b) in enumerate(zip(outputs(kern), outputs(twin), strict=True)):
        u = max_ulp(a, b)
        if u > SHADE_MAX_ULP:
            raise AssertionError(
                f"{what} output {i}: {u} ULP apart (limit {SHADE_MAX_ULP})"
            )
        err, ulp = max(err, max_abs(a, b)), max(ulp, u)
    return err, ulp


# ----------------------------------------------------------------------
# phases


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    from rt_rs_tpu_torch.ops import cuda

    nvcc = [
        ln for ln in sh([cuda.nvcc_path(), "--version"]).splitlines()
        if "release" in ln
    ]
    say(f"[device] torch {torch.__version__} cuda {torch.version.cuda}")
    say(f"[device] nvcc: {nvcc[0].strip() if nvcc else '?'}")
    say(f"[device] card: {card_line()}")
    say(f"[device] count: {torch.cuda.device_count()}")


def phase_build():
    from rt_rs_tpu_torch.ops import cuda

    t0 = time.perf_counter()
    lib_path = cuda.build()
    cuda.library()
    say(f"[build] {lib_path.relative_to(ROOT)} in {time.perf_counter() - t0:.1f} s")
    for ln in (lib_path.parent / "build.log").read_text().splitlines():
        if "Compiling entry function" in ln or "registers" in ln:
            say(f"[build] {ln.strip()}")


class Recorder:
    """Wraps the four kernel wrappers for one frame and keeps each
    call's arguments (the frame path calls them through these module
    attributes)."""

    def __init__(self):
        from rt_rs_tpu_torch.ops import packet_trace, shade_tile

        self.targets = [
            (packet_trace, "refine_cull"),
            (packet_trace, "mt_trace"),
            (shade_tile, "shade_pre"),
            (shade_tile, "shade_post"),
        ]
        self.calls: dict[str, list] = {name: [] for _, name in self.targets}

    def __enter__(self):
        self.saved = []
        for mod, name in self.targets:
            fn = getattr(mod, name)
            self.saved.append((mod, name, fn))

            def rec(*args, _fn=fn, _name=name, **kw):
                self.calls[_name].append((args, kw))
                return _fn(*args, **kw)

            setattr(mod, name, rec)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


def renderer(width: int, height: int):
    from rt_rs_tpu_torch import Config, Renderer, Resolution
    from rt_rs_tpu_torch.scene.presets import torus_scene

    return Renderer(
        torus_scene(),
        config=Config(resolution=Resolution.sized(width, height)),
        handler="pbvh",
        device="cuda",
    )


def phase_compare():
    """Every kernel call of one 384x288 frame, kernel vs twin."""
    import torch

    from rt_rs_tpu_torch.ops import packet_trace as pt
    from rt_rs_tpu_torch.ops import shade_tile as st

    r = renderer(384, 288)
    with Recorder() as rec:
        r.render_frame()
    calls = rec.calls
    errs = {name: 0.0 for name in KERNELS}
    for i, (a, kw) in enumerate(calls["refine_cull"]):
        kern, twin = pt.refine_cull(*a, **kw), pt.refine_cull_reference(*a, **kw)
        errs["refine_cull"] = max(
            errs["refine_cull"],
            check_equal(f"refine_cull#{i}", kern, twin),
        )
        check_equal(f"compact#{i}", pt.compact(kern), pt.compact(twin))
    modes_seen = set()
    for i, (a, kw) in enumerate(calls["mt_trace"]):
        mode = kw["mode"]
        modes_seen.add(mode)
        kern, twin = pt.mt_trace(*a, **kw), pt.mt_trace_reference(*a, **kw)
        name = f"mt_trace[{mode}]"
        errs[name] = max(errs[name], check_equal(f"{name}#{i}", kern, twin))
        if i == 0:  # the primary call, also in closest-hit mode
            kw0 = dict(kw, mode="closest")
            a0 = a[:4]
            check_equal(
                "mt_trace[closest]#0",
                pt.mt_trace(*a0, **kw0),
                pt.mt_trace_reference(*a0, **kw0),
            )
    ulps = {}
    for name, kern_fn, twin_fn in (
        ("shade_pre", st.shade_pre, st.shade_pre_reference),
        ("shade_post", st.shade_post, st.shade_post_reference),
    ):
        for i, (a, kw) in enumerate(calls[name]):
            err, ulp = check_ulp(f"{name}#{i}", kern_fn(*a, **kw), twin_fn(*a, **kw))
            errs[name] = max(errs[name], err)
            ulps[name] = max(ulps.get(name, 0), ulp)
    torch.cuda.synchronize()
    n = {k: len(v) for k, v in calls.items()}
    say(
        f"[compare] 384x288 frame calls {n}, mt modes {sorted(modes_seen)}: "
        f"intersection + refine bit-equal, shading max ULP {ulps}"
    )
    return errs, calls


def reset_counts() -> None:
    from rt_rs_tpu_torch.ops import cuda

    cuda.LAUNCHES.clear()


def read_counts() -> dict[str, int]:
    from rt_rs_tpu_torch.ops import cuda

    return {name: cuda.LAUNCHES[name] for name in KERNELS}


def check_frame(name: str, frame, width: int, height: int) -> None:
    import torch

    if tuple(frame.shape) != (height, width, 3):
        raise AssertionError(f"{name}: shape {tuple(frame.shape)}")
    if not bool(torch.isfinite(frame).all()):
        raise AssertionError(f"{name}: non-finite values")
    mean = float(frame.mean())
    if not mean > 0.01:
        raise AssertionError(f"{name}: black frame (mean {mean})")
    say(f"[frame] {name}: finite, mean {mean:.6f}, max {float(frame.max()):.6f}")


def phase_frames_and_orbits(card: str) -> tuple[dict[str, int], dict[str, float]]:
    import numpy as np
    import torch

    reset_counts()
    ref = np.load(REF_FRAME)["frame"]
    frame = renderer(96, 72).render_frame().cpu().numpy()
    diff = np.abs(frame - ref)
    err = float(diff.max())
    if not err <= REF_ATOL:
        raise AssertionError(f"96x72 frame vs the JAX package's: max {err}")
    say(f"[frame] 96x72 vs JAX package frame: max abs {err:.3g} (atol {REF_ATOL})")

    frame_ms = {}
    for name, (w, h, frames) in SIZES.items():
        r = renderer(w, h)
        check_frame(name, r.render_frame(), w, h)  # also the warm-up
        mult = 2.0 * math.pi / frames / 0.0314  # one full orbit
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0 = time.perf_counter()
        start.record()
        for _ in range(frames):
            out = r.render_frame(block=False)
            r.orbit(mult)
        end.record()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) / frames * 1e3
        frame_ms[name] = start.elapsed_time(end) / frames
        check_frame(f"{name} orbit end", out, w, h)
        say(
            f"[orbit] {name}: {frame_ms[name]:.3f} ms/frame (CUDA events), "
            f"{host_ms:.3f} ms host, {frames} frames; {card}"
        )
    counts = read_counts()
    missing = [k for k, v in counts.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the frame path: {missing}")
    say(f"[launches] {counts}")
    return counts, frame_ms


def time_ms(fn, reps: int) -> float:
    import torch

    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_kernel_times(calls, card: str) -> dict[str, tuple[float, float]]:
    """Kernel vs twin at the 384x288 frame's shapes: the primary rows
    call, bounce 0's shadow batch and its refine cull, bounce 0's
    shading."""
    from rt_rs_tpu_torch.ops import packet_trace as pt
    from rt_rs_tpu_torch.ops import shade_tile as st

    mt = calls["mt_trace"]
    picks = {
        "refine_cull": (pt.refine_cull, pt.refine_cull_reference, calls["refine_cull"][0]),
        "mt_trace[rows]": (
            pt.mt_trace, pt.mt_trace_reference,
            next(c for c in mt if c[1]["mode"] == "rows"),
        ),
        "mt_trace[anyhit]": (
            pt.mt_trace, pt.mt_trace_reference,
            next(c for c in mt if c[1]["mode"] == "anyhit"),
        ),
        "shade_pre": (st.shade_pre, st.shade_pre_reference, calls["shade_pre"][0]),
        "shade_post": (st.shade_post, st.shade_post_reference, calls["shade_post"][0]),
    }
    times = {}
    for name, (kern, twin, (a, kw)) in picks.items():
        k_ms = time_ms(lambda: kern(*a, **kw), 50)
        t_ms = time_ms(lambda: twin(*a, **kw), 5)
        times[name] = (k_ms, t_ms)
        work = ""
        if name.startswith("mt_trace"):
            # list entries: (tile, chunk) pairs, each tc x r ray-triangle tests
            entries = int(a[3].sum())
            work = f", {entries} entries, {k_ms * 1e3 / entries:.4f} us/entry"
        say(f"[time] {name}: kernel {k_ms:.4f} ms, twin {t_ms:.4f} ms{work}; {card}")
    return times


def main(full: bool = True) -> None:
    import torch

    phase_device()
    card = card_line()
    phase_build()
    errs, calls = phase_compare()
    if not full:
        return
    counts, frame_ms = phase_frames_and_orbits(card)
    times = phase_kernel_times(calls, card)
    kernels = [
        {
            "name": name,
            "route": "cuda",
            "source": src,
            "replaces": rep,
            "launches": counts[name],
            "max_abs_err": errs[name],
            "ms": times[name][0],
            "plain_ms": times[name][1],
        }
        for name, (src, rep) in KERNELS.items()
    ]
    say(json.dumps({"frame_ms": frame_ms, "card": card}))
    say(json.dumps({"kernels": kernels}))
    say(card)
    say(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": "gpu",
                    "kind": torch.cuda.get_device_name(0),
                    "count": torch.cuda.device_count(),
                },
            }
        )
    )


if __name__ == "__main__":
    main()

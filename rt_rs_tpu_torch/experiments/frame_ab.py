"""Eager frame and kernel call times of two checkouts of the port on one card, in turns.

    python3 -m rt_rs_tpu_torch.experiments.frame_ab OTHER_ROOT [--order ABBAAB]

Checkout A holds this file; B is the checkout at ``OTHER_ROOT`` (for
example an unpacked ``git archive`` of another commit).  Each turn is a
fresh process that imports ``rt_rs_tpu_torch`` from its checkout
(building that checkout's kernels there at first use) and renders the
CASES' orbits eagerly: ``Renderer.render_frame`` and ``orbit`` per frame,
one sync at the end, CUDA events around the orbit after one warm-up
frame.  Then it records the CALLS (intersection kernel calls that
chip_smoke.py's phase 6 times) with its checkout's ``chip_smoke`` and
times each as phase 6 does (torch.profiler device time, the L2 cache
overwritten before each call).  The turns interleave the two
(``--order``), so that both see the same host; the result is one JSON
line of ms/frame by case and device ms by call and checkout, then the
card's name and power limit.  Needs one card.
"""

from __future__ import annotations

import argparse
import json
import math
import pathlib
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parents[2]
# case -> (scene preset, width, height, orbit frames, handler kwargs)
CASES = {
    "torus 384x288": ("torus_scene", 384, 288, 30, {}),
    "blank 384x288": ("torus_scene", 384, 288, 30, {"handler": "blank"}),
    "canyon segmented 640x480": ("torus_canyon", 640, 480, 16, {}),
    "torus 1920x1080": ("torus_scene", 1920, 1080, 12, {}),
    "canyon dma 640x480": ("torus_canyon", 640, 480, 16, {"handler_kwargs": {"streaming_mode": "dma"}}),
    "early_exit torus 1920x1080": ("torus_scene", 1920, 1080, 12, {"handler_kwargs": {"early_exit": True}}),
    "early_exit canyon segmented 640x480": (
        "torus_canyon", 640, 480, 16, {"handler_kwargs": {"early_exit": True}},
    ),
}
# call -> (its frame: a chip_smoke.py factory, its arguments and early
# exit on or off; the wrapper; the mode, None for mt_stream).  The call
# taken is the frame's busiest in that mode (most list entries; mt_stream:
# most tiles) where the name says so, else its first.
CALLS = {
    "mt_trace[closest] canyon 640x480, busiest": (("canyon", (640, 480, "segmented"), False), "mt_trace", "closest"),
    "mt_trace[rows] torus 384x288 primary": (("renderer", (384, 288), False), "mt_trace", "rows"),
    "mt_trace[anyhit] torus 384x288 shadows": (("renderer", (384, 288), False), "mt_trace", "anyhit"),
    "mt_trace[rows] torus 1920x1080 primary": (("renderer", (1920, 1080), False), "mt_trace", "rows"),
    "mt_trace[closest] torus_ghost 1920x1080, busiest": (("ghost", (1920, 1080), False), "mt_trace", "closest"),
    "mt_stream canyon dma 640x480, busiest": (("canyon", (640, 480, "dma"), False), "mt_stream", None),
    "mt_trace[closest,early_exit] canyon 640x480, busiest": (
        ("canyon", (640, 480, "segmented"), True), "mt_trace", "closest",
    ),
    "mt_trace[rows,early_exit] torus 1920x1080 primary": (
        ("renderer", (1920, 1080), True), "mt_trace", "rows",
    ),
}


def call_times() -> dict[str, float]:
    """The CALLS' device ms, recorded and timed with the checkout's own
    chip_smoke.py (its Recorder and profiled)."""
    import chip_smoke as cs

    from rt_rs_tpu_torch.ops import packet_stream, packet_trace

    wrappers = {"mt_trace": packet_trace.mt_trace, "mt_stream": packet_stream.mt_stream}
    recorded: dict[tuple, dict] = {}
    ms = {}
    for name, (frame, wrapper, mode) in CALLS.items():
        if frame not in recorded:
            make, a, early_exit = frame
            with cs.Recorder() as rec:
                getattr(cs, make)(*a, **({"early_exit": True} if early_exit else {})).render_frame()
            recorded[frame] = rec.calls
        calls = recorded[frame][wrapper]
        if mode is None:
            call = max(calls, key=lambda c: c[0][0].shape[1])
        else:
            calls = [c for c in calls if c[1]["mode"] == mode]
            call = max(calls, key=lambda c: int(c[0][3].sum())) if "busiest" in name else calls[0]
        a, kw, _ = call
        ms[name] = cs.profiled(lambda: wrappers[wrapper](*a, **kw))[1]
    return ms


def child(root: str) -> None:
    """One turn: the CASES' eager orbits with the port of ``root``."""
    sys.path.insert(0, root)
    import torch

    from rt_rs_tpu_torch import Config, Renderer, Resolution
    from rt_rs_tpu_torch.scene import presets

    ms = {}
    for name, (preset, w, h, frames, kw) in CASES.items():
        r = Renderer(
            getattr(presets, preset)(), config=Config(resolution=Resolution.sized(w, h)),
            device="cuda", **kw,
        )
        r.render_frame()  # warm-up
        mult = 2.0 * math.pi / frames / 0.0314
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(frames):
            r.render_frame(block=False)
            r.orbit(mult)
        end.record()
        torch.cuda.synchronize()
        ms[name] = start.elapsed_time(end) / frames
    print(json.dumps({"root": root, "ms": ms, "call_ms": call_times()}), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", nargs="?")
    ap.add_argument("--order", default="ABBAAB")
    ap.add_argument("--child")
    args = ap.parse_args()
    if args.child:
        child(args.child)
        return
    roots = {"A": str(HERE), "B": str(pathlib.Path(args.other).resolve())}
    ms: dict[str, dict[str, list[float]]] = {c: {"A": [], "B": []} for c in CASES}
    call_ms: dict[str, dict[str, list[float]]] = {c: {"A": [], "B": []} for c in CALLS}
    for turn in args.order:
        # Run by path, so that the child imports the port of its root only.
        out = subprocess.run(
            [sys.executable, __file__, "--child", roots[turn]],
            cwd=roots[turn], stdout=subprocess.PIPE, text=True, check=True,
        ).stdout
        res = json.loads(out.strip().splitlines()[-1])
        for name, v in res["ms"].items():
            ms[name][turn].append(v)
        for name, v in res["call_ms"].items():
            call_ms[name][turn].append(v)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(
        json.dumps(
            {
                "A": roots["A"], "B": roots["B"], "order": args.order, "ms": ms,
                "call_ms": call_ms, "card": card,
            }
        )
    )
    print(card)


if __name__ == "__main__":
    main()

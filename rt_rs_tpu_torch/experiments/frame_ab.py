"""Eager and chained frame times and kernel call times of two checkouts of the port on one card, in turns.

    python3 -m rt_rs_tpu_torch.experiments.frame_ab OTHER_ROOT [--order ABBAAB] [--match TEXT ...]

Checkout A holds this file; B is the checkout at ``OTHER_ROOT`` (for
example an unpacked ``git archive`` of another commit).  Each turn is a
fresh process that imports ``rt_rs_tpu_torch`` from its checkout
(building that checkout's kernels there at first use) and renders the
CASES' orbits eagerly: ``Renderer.render_frame`` and ``orbit`` per frame,
one sync at the end, CUDA events around the orbit after one warm-up
frame, then the transposed-table canyon's (TPOSE_CASE, chip_smoke's
``TposeCanyon``) alike.  Then it records the CALLS (intersection kernel
calls that chip_smoke.py's phase 6 times, every ``bvh_walk`` call of
the threaded frames together, and kernel D's bounce-0 calls of the
torus frames) with its checkout's ``chip_smoke``, makes the PROBE_CALLS
(the probes' kernel calls on torus_scene's 1080p primaries, as
chip_smoke's phase 3 makes them) and times each as phase 6 does
(torch.profiler device time, the L2 cache overwritten before each
call); then the IN_FRAME kernels' device ms a frame over profiled eager
frames (inputs L2-hot, as phase 7).  The CHAINED orbits
(``animate(chain=K)``) run in a second process of the turn, which never
runs torch.profiler, as phase 8.  ``--match`` keeps the cases and calls
whose names hold one of the texts (``--match bvh``: the threaded ``bvh``
/ ``rf_bvh`` frames and the walk's calls; ``--match shade_post
chain=16``: kernel D's calls and in-frame times and the chained torus
orbits).  The turns interleave the two (``--order``), so that both see
the same host; the result is one JSON line of ms/frame by case and
device ms by call and checkout, then the card's name and power limit.
Needs one card.
"""

from __future__ import annotations

import argparse
import json
import math
import pathlib
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parents[2]
THREADED = {"handler_kwargs": {"backend": "threaded"}}
# case -> (scene preset, width, height, orbit frames, Renderer kwargs;
# the handler pbvh unless named)
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
    "bvh threaded torus 384x288": ("torus_scene", 384, 288, 30, {"handler": "bvh", **THREADED}),
    "bvh threaded torus 1920x1080": ("torus_scene", 1920, 1080, 12, {"handler": "bvh", **THREADED}),
    "rf_bvh threaded torus 1920x1080": ("torus_scene", 1920, 1080, 12, {"handler": "rf_bvh", **THREADED}),
    "bvh threaded canyon 640x480": ("torus_canyon", 640, 480, 16, {"handler": "bvh", **THREADED}),
}
# call -> (its frame: a chip_smoke.py factory, its arguments and early
# exit on or off, or "threaded" and (scene preset, width, height,
# handler); the wrapper; the mode, None for mt_stream, "primary" or
# "frame" for bvh_walk).  The call taken is the frame's busiest in that
# mode (most list entries; mt_stream: most tiles) where the name says so,
# else its first; bvh_walk "frame" times all of the frame's calls (of the
# tiled entry, where the frame walks through it).
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
    "bvh_walk[bvh] torus 384x288 primary": (("threaded", ("torus_scene", 384, 288, "bvh"), False), "bvh_walk", "primary"),
    "bvh_walk[bvh] canyon 640x480 primary": (("threaded", ("torus_canyon", 640, 480, "bvh"), False), "bvh_walk", "primary"),
    "bvh_walk[bvh] torus 1920x1080, the frame's calls": (
        ("threaded", ("torus_scene", 1920, 1080, "bvh"), False), "bvh_walk", "frame",
    ),
    "bvh_walk[bvh] canyon 640x480, the frame's calls": (
        ("threaded", ("torus_canyon", 640, 480, "bvh"), False), "bvh_walk", "frame",
    ),
    "shade_post torus 384x288 bounce 0": (("renderer", (384, 288), False), "shade_post", "first"),
    "shade_post torus 1920x1080 bounce 0": (("renderer", (1920, 1080), False), "shade_post", "first"),
}
# in-frame kernel time -> (torus_scene width, height, eager frames
# profiled, the fragment of the kernels' names): device ms a frame of the
# kernels whose names hold the fragment, their inputs L2-hot as a frame
# leaves them (torch.profiler over the frames, as chip_smoke's phase 7).
IN_FRAME = {
    "shade_post in torus 384x288 frames": (384, 288, 4, "shade_post_kernel"),
    "shade_post in torus 1920x1080 frames": (1920, 1080, 4, "shade_post_kernel"),
}
# chained orbit -> (torus_scene width, height, K, orbit frames): ms/frame
# of ``animate(chain=K)`` (chip_smoke's chain_orbit after one warm-up
# orbit that captures the graphs), in a process of its own that never
# runs torch.profiler, as chip_smoke's phase 8.
CHAINED = {
    "torus 384x288 chain=16": (384, 288, 16, 32),
    "torus 1920x1080 chain=16": (1920, 1080, 16, 16),
}
# The transposed-table canyon frame (torus_canyon() in one tc = 64
# transposed table, through shade.render): name, width, height, orbit
# frames.
TPOSE_CASE = ("tpose canyon 640x480", 640, 480, 20)
# probe call -> (wrapper, tc or precision).  mt_tpose: 256-ray tiles over
# the tc-triangle transposed table; mt_trace[closest] on mt_tpose's tc =
# 64 lists (the time mt_tpose should match); mt_mxu: 128-ray tiles over
# the 64-triangle coefficient table.
PROBE_CALLS = {
    "mt_tpose tc=64 torus 1920x1080 primaries": ("mt_tpose", 64),
    "mt_tpose tc=128 torus 1920x1080 primaries": ("mt_tpose", 128),
    "mt_trace[closest] on mt_tpose's tc=64 lists": ("mt_trace", 64),
    "mt_mxu[highest] torus 1920x1080 primaries": ("mt_mxu", "highest"),
    "mt_mxu[high] torus 1920x1080 primaries": ("mt_mxu", "high"),
    "mt_mxu[default] torus 1920x1080 primaries": ("mt_mxu", "default"),
}


def probe_times(matches) -> dict[str, float]:
    """The PROBE_CALLS' device ms (those whose names hold one of ``matches``),
    made from the checkout's own chip_smoke.probe_inputs and timed with
    its profiled."""
    import chip_smoke as cs

    from rt_rs_tpu_torch.experiments import mxu_mt, tpose_table
    from rt_rs_tpu_torch.experiments.probe_rays import probe_rays
    from rt_rs_tpu_torch.ops import packet_trace

    if not any(hits(name, matches) for name in PROBE_CALLS):
        return {}
    p = cs.probe_inputs()
    win = p["win"]
    kw = dict(eps=p["eps"], **win)
    lists = {}
    o, d, excl = p["rays"][(16, 16)]
    for tc in (64, 128):
        tables = tpose_table.build_tri_chunks_t(*p["corners"], tri_chunk=tc, device="cuda")
        s = probe_rays(o, d, excl, None, None, tables.bmin, tables.bmax, ray_tile=256, **win)
        lists[tc] = (tables.comp, s)
    o, d, excl = p["rays"][(8, 16)]
    chunks = p["chunks"][64]
    mxu = probe_rays(o, d, excl, None, None, chunks.bmin, chunks.bmax, ray_tile=mxu_mt.TC_RAYS, **win)
    table = mxu_mt.build_mxu_table(chunks)
    ms = {}
    for name, (wrapper, arg) in PROBE_CALLS.items():
        if not hits(name, matches):
            continue
        if wrapper == "mt_tpose":
            comp, s = lists[arg]
            call = lambda: tpose_table.mt_tpose(comp, s.rays, s.ids, s.counts, **kw)  # noqa: E731
        elif wrapper == "mt_trace":
            s = lists[arg][1]
            payload = s.rays.permute(1, 0, 2).contiguous()
            comp = p["chunks"][arg].comp
            call = lambda: packet_trace.mt_trace(comp, payload, s.ids, s.counts, mode="closest", **kw)  # noqa: E731
        else:
            call = lambda: mxu_mt.mt_mxu(table, mxu.rays, mxu.ids, mxu.counts, precision=arg, **kw)  # noqa: E731
        ms[name] = cs.profiled(call)[1]
    return ms


def orbit_ms(r, frames: int) -> float:
    """ms/frame of an eager orbit of ``frames`` steps after one warm-up
    frame (CUDA events, one sync at the end)."""
    import torch

    r.render_frame()  # warm-up
    mult = 2.0 * math.pi / frames / 0.0314
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(frames):
        r.render_frame(block=False)
        r.orbit(mult)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / frames


def frame_of(cs, make: str, a: tuple, early_exit: bool):
    """A CALLS frame's Renderer, made with the checkout's chip_smoke."""
    if make == "threaded":
        from rt_rs_tpu_torch.scene import presets

        preset, w, h, handler = a
        return cs.renderer(w, h, getattr(presets, preset)(), handler=handler, backend="threaded")
    return getattr(cs, make)(*a, **({"early_exit": True} if early_exit else {}))


def call_times(matches) -> dict[str, float]:
    """The CALLS' device ms (those whose names hold one of ``matches``), recorded
    and timed with the checkout's own chip_smoke.py (its Recorder and
    profiled)."""
    import chip_smoke as cs

    from rt_rs_tpu_torch.ops import bvh_walk, packet_stream, packet_trace, shade_tile

    wrappers = {
        "mt_trace": packet_trace.mt_trace, "mt_stream": packet_stream.mt_stream,
        "bvh_walk": bvh_walk.bvh_walk, "shade_post": shade_tile.shade_post,
    }
    recorded: dict[tuple, dict] = {}
    ms = {}
    for name, (frame, wrapper, mode) in CALLS.items():
        if not hits(name, matches):
            continue
        if frame not in recorded:
            with cs.Recorder() as rec:
                frame_of(cs, *frame).render_frame()
            recorded[frame] = rec.calls
        calls = recorded[frame][wrapper]
        if wrapper == "bvh_walk":
            # a checkout whose frames walk through the tiled entry
            # (kernel G's modes) records its calls instead
            fn = wrappers[wrapper]
            if not calls and recorded[frame].get("bvh_walk_tiled"):
                calls, fn = recorded[frame]["bvh_walk_tiled"], bvh_walk.bvh_walk_tiled
            chosen = calls[:1] if mode == "primary" else calls
            ms[name] = cs.profiled(lambda: [fn(*a, **kw) for a, kw, _ in chosen])[1]
            continue
        if mode == "first":
            call = calls[0]
        elif mode is None:
            call = max(calls, key=lambda c: c[0][0].shape[1])
        else:
            calls = [c for c in calls if c[1]["mode"] == mode]
            call = max(calls, key=lambda c: int(c[0][3].sum())) if "busiest" in name else calls[0]
        a, kw, _ = call
        ms[name] = cs.profiled(lambda: wrappers[wrapper](*a, **kw))[1]
    return ms


def in_frame_times(cs, matches) -> dict[str, float]:
    """The IN_FRAME kernels' device ms a frame (those whose names hold
    one of ``matches``)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    ms = {}
    for name, (w, h, frames, frag) in IN_FRAME.items():
        if not hits(name, matches):
            continue
        r = cs.renderer(w, h)
        r.render_frame()  # warm-up
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(frames):
                r.render_frame(block=False)
                r.orbit(1.0)
            torch.cuda.synchronize()
        us = [
            e.time_range.elapsed_us() for e in prof.events()
            if e.device_type != DeviceType.CPU and frag in e.name
        ]
        if not us:
            raise RuntimeError(f"{name}: no kernel named like {frag!r} in the trace")
        ms[name] = sum(us) / 1e3 / frames
    return ms


def chained(root: str, matches) -> None:
    """One turn's CHAINED orbits with the port of ``root``."""
    sys.path.insert(0, root)
    import chip_smoke as cs

    from rt_rs_tpu_torch.scene.camera import ORBIT_RATE

    ms = {}
    for name, (w, h, k, frames) in CHAINED.items():
        if not hits(name, matches):
            continue
        r = cs.renderer(w, h)
        start, mult = r.camera, 2.0 * math.pi / frames / ORBIT_RATE
        cs.chain_orbit(r, frames, mult, k, start)  # warm-up: captures the graphs
        ms[name] = cs.chain_orbit(r, frames, mult, k, start)[0]
    print(json.dumps({"root": root, "ms": ms, "call_ms": {}}), flush=True)


def child(root: str, matches) -> None:
    """One turn: the CASES' eager orbits with the port of ``root``, then
    the calls and the in-frame kernel times."""
    sys.path.insert(0, root)
    import chip_smoke as cs

    from rt_rs_tpu_torch import Config, Renderer, Resolution
    from rt_rs_tpu_torch.scene import presets

    ms = {}
    for name, (preset, w, h, frames, kw) in CASES.items():
        if not hits(name, matches):
            continue
        r = Renderer(
            getattr(presets, preset)(), config=Config(resolution=Resolution.sized(w, h)),
            device="cuda", **{"handler": "pbvh", **kw},
        )
        ms[name] = orbit_ms(r, frames)
    name, w, h, frames = TPOSE_CASE
    if hits(name, matches):
        ms[name] = orbit_ms(cs.TposeCanyon(w, h), frames)
    call_ms = {**call_times(matches), **probe_times(matches), **in_frame_times(cs, matches)}
    print(json.dumps({"root": root, "ms": ms, "call_ms": call_ms}), flush=True)


def hits(name: str, matches) -> bool:
    return any(m in name for m in matches)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", nargs="?")
    ap.add_argument("--order", default="ABBAAB")
    ap.add_argument("--match", nargs="+", default=[""])
    ap.add_argument("--child")
    ap.add_argument("--chained", action="store_true")
    args = ap.parse_args()
    if args.child:
        (chained if args.chained else child)(args.child, args.match)
        return
    roots = {"A": str(HERE), "B": str(pathlib.Path(args.other).resolve())}
    keep = lambda names: [c for c in names if hits(c, args.match)]  # noqa: E731
    orbits = keep((*CASES, TPOSE_CASE[0], *CHAINED))
    ms: dict[str, dict[str, list[float]]] = {c: {"A": [], "B": []} for c in orbits}
    calls = keep((*CALLS, *PROBE_CALLS, *IN_FRAME))
    call_ms: dict[str, dict[str, list[float]]] = {c: {"A": [], "B": []} for c in calls}
    kinds = [[]] if len(orbits) + len(calls) > len(keep(CHAINED)) else []
    if keep(CHAINED):
        kinds.append(["--chained"])
    for turn in args.order:
        for kind in kinds:
            # Run by path, so that the child imports the port of its root only.
            out = subprocess.run(
                [sys.executable, __file__, "--child", roots[turn], *kind, "--match", *args.match],
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
                "A": roots["A"], "B": roots["B"], "order": args.order, "match": args.match, "ms": ms,
                "call_ms": call_ms, "card": card,
            }
        )
    )
    print(card)


if __name__ == "__main__":
    main()

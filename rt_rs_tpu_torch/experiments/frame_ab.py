"""Eager frame times of two checkouts of the port on one card, in turns.

    python3 -m rt_rs_tpu_torch.experiments.frame_ab OTHER_ROOT [--order ABBAAB]

Checkout A holds this file; B is the checkout at ``OTHER_ROOT`` (for
example an unpacked ``git archive`` of another commit).  Each turn is a
fresh process that imports ``rt_rs_tpu_torch`` from its checkout
(building that checkout's kernels there at first use) and renders the
CASES' orbits eagerly: ``Renderer.render_frame`` and ``orbit`` per frame,
one sync at the end, CUDA events around the orbit after one warm-up
frame.  The turns interleave the two (``--order``), so that both see the
same host; the result is one JSON line of ms/frame by case and checkout,
then the card's name and power limit.  Needs one card.
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
}


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
    print(json.dumps({"root": root, "ms": ms}), flush=True)


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
    for turn in args.order:
        # Run by path, so that the child imports the port of its root only.
        out = subprocess.run(
            [sys.executable, __file__, "--child", roots[turn]],
            cwd=roots[turn], stdout=subprocess.PIPE, text=True, check=True,
        ).stdout
        for name, v in json.loads(out.strip().splitlines()[-1])["ms"].items():
            ms[name][turn].append(v)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(json.dumps({"A": roots["A"], "B": roots["B"], "order": args.order, "ms": ms, "card": card}))


if __name__ == "__main__":
    main()

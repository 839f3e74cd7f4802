"""Kernel D's ablation on one card: where a block stages its operands, its size, when it reads liveness.

    python3 experiments/post_ablation/post_ablation.py [--parent ROOT] [--stage 0 1 2]
        [--rays 128 256] [--flag-first 1 0] [--min-blocks 0 8] [--rpt 1 2 4]

Run from the root of a checkout (it imports ``chip_smoke`` and the
port).  It stays outside the package: no frame path and no test needs
it.  The candidates, each a kernel library built from a copy of csrc/
under ``rt_rs_tpu_torch/build/post_ablation/``:

* ``shipped``: the checkout's kernel D (csrc/shade_post.cu);
* ``parent``: with ``--parent``, the csrc/ of the checkout at ROOT (an
  unpacked ``git archive`` of another commit) as it is;
* the variants of ``shade_post_variants.cu`` beside this script, built
  in place of csrc/shade_post.cu, for each combination of
  ``POST_STAGE`` (0: 1-D bulk copies (TMA) into shared memory against
  one mbarrier; 1: registers, one ray a thread, every load before any
  arithmetic; 2: shared memory filled with 16-byte loads by every
  thread; 3: registers as 1, the kernel specialised on the light count
  and ``blocked_mode``, ``POST_RPT`` rays a thread loaded as vectors),
  ``POST_RAYS`` (rays of a block, which never spans two 8-tile
  subgroups), ``POST_FLAG_FIRST`` (1: the liveness word before any
  data, a dead block reads nothing else; 0: with the data) and
  ``POST_MIN_BLOCKS`` (``__launch_bounds__``' blocks per SM, a cap on
  the registers; 0: none).

Each candidate is first checked bit for bit against kernel D's twin on
every call below and on post_cases' synthetic cases, then the calls are
timed in two rounds of opposite order: cold, as chip_smoke.py's phase 6
does (torch.profiler device time, the L2 cache overwritten before each
call), and hot (back-to-back calls on the same inputs, which then sit in
L2, as a frame's do: the trace and shade_pre wrote them just before).
The calls are the torus frames' at 384x288 and 1920x1080, bounce 0
(nearly every subgroup live) and bounce 3 (the last: the most dead
subgroups), each beside the candidate's launch floor (chip_smoke's empty
kernel on the candidate's grid; the parent's grid is one thread a ray in
blocks of 256).  Prints one JSON line of device ms by call, candidate
and temperature, then the card's name and power limit.  Needs one card.
"""

from __future__ import annotations

import argparse
import itertools
import json
import pathlib
import re
import shutil
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
HERE = pathlib.Path(__file__).resolve().parent


def variant_library(cuda, name: str, csrc_from: pathlib.Path, source: pathlib.Path | None, consts: dict):
    """The kernel library built from a copy of ``csrc_from`` with
    shade_post.cu replaced by ``source`` (if given) and its ``consts``
    set -> its loaded ctypes handle."""
    root = cuda.BUILD / "post_ablation" / re.sub(r"[^A-Za-z0-9=,_-]", "", name)
    csrc = root / "csrc"
    shutil.rmtree(csrc, ignore_errors=True)
    shutil.copytree(csrc_from, csrc)
    path = csrc / "shade_post.cu"
    src = (source or path).read_text()
    for const, value in consts.items():
        src, n = re.subn(rf"{const} = \d+;", f"{const} = {value};", src)
        if n != 1:
            raise RuntimeError(f"{const} not found once in {path.name}")
    path.write_text(src)
    saved = cuda.CSRC, cuda.BUILD
    cuda.CSRC, cuda.BUILD = csrc, root / "build"
    try:
        cuda.library.cache_clear()
        lib = cuda.library()
    finally:
        cuda.CSRC, cuda.BUILD = saved
        cuda.library.cache_clear()
    log = next((root / "build").glob("*/build.log")).read_text().splitlines()
    at = next(i for i, ln in enumerate(log) if "Compiling entry function" in ln and "shade_post_kernel" in ln)
    print(f"[post_ablation] {name}: ptxas " + "; ".join(ln.strip() for ln in log[at + 1 : at + 4]), flush=True)
    return lib


def hot_ms(fn, reps: int = 20) -> float:
    """Device ms of one call among ``reps`` back-to-back calls on the
    same inputs (torch.profiler): the inputs sit in L2."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events() if e.device_type != DeviceType.CPU]
    if len(us) != reps:
        raise RuntimeError(f"hot_ms: {len(us)} kernels traced for {reps} calls")
    return sum(us) / reps / 1e3


def record_calls(cs) -> dict:
    """call label -> (args, kwargs) of the torus frames' shade_post calls."""
    calls = {}
    for w, h in ((384, 288), (1920, 1080)):
        with cs.Recorder() as rec:
            cs.renderer(w, h).render_frame()
        post = rec.calls["shade_post"]
        for bounce in (0, len(post) - 1):
            a, kw, _ = post[bounce]
            live = int((a[7] != 0).sum())
            calls[f"torus {w}x{h} bounce {bounce} ({live} of {a[7].numel()} subgroups live)"] = (a, kw)
    return calls


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent")
    parser.add_argument("--stage", type=int, nargs="+", default=[0, 1, 2])
    parser.add_argument("--rays", type=int, nargs="+", default=[128, 256])
    parser.add_argument("--flag-first", type=int, nargs="+", default=[1])
    parser.add_argument("--min-blocks", type=int, nargs="+", default=[0])
    parser.add_argument("--rpt", type=int, nargs="+", default=[1])
    args = parser.parse_args()
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import torch

    from rt_rs_tpu_torch.experiments import post_cases
    from rt_rs_tpu_torch.ops import cuda
    from rt_rs_tpu_torch.ops import shade_tile as st

    if not torch.cuda.is_available():
        raise SystemExit("post_ablation: no CUDA device")
    card = cs.card_line()
    calls = record_calls(cs)  # with the checkout's own library
    floor = cs.floor_launcher()
    # name -> (library, rays of a block: the floor's grid)
    libs = {"shipped": (variant_library(cuda, "shipped", cuda.CSRC, None, {}), st.POST_RAYS)}
    if args.parent:
        csrc = pathlib.Path(args.parent).resolve() / "rt_rs_tpu_torch" / "csrc"
        libs["parent"] = (variant_library(cuda, "parent", csrc, None, {}), 256)
    for stage, rays, flag, blocks, rpt in itertools.product(
        args.stage, args.rays, args.flag_first, args.min_blocks, args.rpt
    ):
        consts = {
            "POST_STAGE": stage, "POST_RAYS": rays, "POST_FLAG_FIRST": flag, "POST_MIN_BLOCKS": blocks,
            "POST_RPT": rpt,
        }
        name = ",".join(f"{k}={v}" for k, v in consts.items())
        libs[name] = (variant_library(cuda, name, cuda.CSRC, HERE / "shade_post_variants.cu", consts), rays)
    synthetic = [post_cases.post_args(c, "cuda") for c in post_cases.cases(tiles=(8, 8 * 45))]
    default_library = cuda.library
    ms: dict[str, dict[str, dict[str, list[float]]]] = {label: {} for label in calls}
    try:
        for turn in range(2):
            order = list(libs.items()) if turn == 0 else list(libs.items())[::-1]
            for name, (lib, rays) in order:
                cuda.library = lambda lib=lib: lib
                if turn == 0:
                    checks = [*calls.items(), *((f"synthetic {i}", x) for i, x in enumerate(synthetic))]
                    for label, (a, kw) in checks:
                        cs.check_equal(f"{label} at {name}", st.shade_post(*a, **kw), st.shade_post_reference(*a, **kw))
                for label, (a, kw) in calls.items():
                    row = ms[label].setdefault(name, {"cold": [], "hot": [], "floor": []})
                    row["cold"].append(cs.profiled(lambda: st.shade_post(*a, **kw))[1])
                    row["hot"].append(hot_ms(lambda: st.shade_post(*a, **kw)))
                    row["floor"].append(cs.profiled(lambda: floor(a[2], rays))[1])
                    cs.say(
                        f"[post_ablation] {label}: {name}: cold {row['cold'][-1]:.4f} ms, hot "
                        f"{row['hot'][-1]:.4f} ms, floor {row['floor'][-1]:.4f} ms; {card}"
                    )
    finally:
        cuda.library = default_library
    print(json.dumps({"ms": ms, "card": card}), flush=True)
    print(card, flush=True)


if __name__ == "__main__":
    main()

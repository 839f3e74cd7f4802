"""Item sizes of the balanced designs of kernel E, early exit and the probes' kernels H and I, on one card.

    python3 -m rt_rs_tpu_torch.experiments.item_sizes [--stream 2 4 8 16] [--exit 4 8 16 32]
        [--tpose 1 2 4 8] [--mxu 1 2 4 8] [--mxu-tc 2 4 8 16]

Run from the root of a checkout (it imports ``chip_smoke``).  The item
size of each design is a compile-time constant: ``ITEM_STREAM`` in
csrc/mt_stream.cu, ``ITEM_EXIT`` in csrc/mt_trace.cu, ``ITEM_TPOSE`` in
csrc/mt_tpose.cu, ``ITEM_MXU`` (highest) and ``ITEM_MXU_TC`` (the
tensor-core variants) in csrc/mt_mxu.cu.  For each candidate
this builds the kernel library from a copy of csrc/ with that constant
set (under ``rt_rs_tpu_torch/build/item_sizes/``), checks the calls
below against the design's plain mirror at that size, bit for bit
(early exit: on every ray; mt_mxu: as chip_smoke.check_mxu checks it,
the TF32 variants against "highest"), and times them as chip_smoke.py's
phase 6 does (torch.profiler device time, the L2 cache overwritten
before each call), candidates in two interleaved rounds, early-exit
calls beside the default mode on the same lists.  The calls are phase
6's: the canyon ``"dma"`` 640x480 frame's busiest ``mt_stream`` call,
the canyon early-exit 640x480 frame's busiest closest-hit call, the
torus 1080p early-exit frame's primary rows call, and the probes' calls
on torus_scene's 1080p primaries (mt_tpose at tc 64, mt_mxu at each
precision).  Prints one JSON line of device ms by call and candidate,
then the card's name and power limit.  Needs one card.
"""

from __future__ import annotations

import argparse
import collections
import json
import pathlib
import re
import shutil
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]

# constant -> its source file
SOURCES = {
    "ITEM_STREAM": "mt_stream.cu", "ITEM_EXIT": "mt_trace.cu",
    "ITEM_TPOSE": "mt_tpose.cu", "ITEM_MXU": "mt_mxu.cu", "ITEM_MXU_TC": "mt_mxu.cu",
}


def variant_library(cuda, const: str, value: int):
    """The kernel library built from csrc/ with ``const`` set to
    ``value`` -> its loaded ctypes handle."""
    root = cuda.BUILD / "item_sizes" / f"{const}={value}"
    csrc = root / "csrc"
    shutil.rmtree(csrc, ignore_errors=True)
    shutil.copytree(cuda.CSRC, csrc)
    path = csrc / SOURCES[const]
    src, n = re.subn(rf"{const} = \d+", f"{const} = {value}", path.read_text())
    if n != 1:
        raise RuntimeError(f"{const} not found once in {path.name}")
    path.write_text(src)
    saved = cuda.CSRC, cuda.BUILD
    cuda.CSRC, cuda.BUILD = csrc, root / "build"
    try:
        cuda.library.cache_clear()
        return cuda.library()
    finally:
        cuda.CSRC, cuda.BUILD = saved
        cuda.library.cache_clear()


def record_calls(cs) -> dict:
    """call label -> (wrapper, check, recorded (args, kwargs), constant):
    ``check(size, args, kwargs)`` raises unless the wrapper's result is
    its design's at that item size."""
    from rt_rs_tpu_torch.experiments import mxu_mt, tpose_table
    from rt_rs_tpu_torch.ops import packet_stream as ps
    from rt_rs_tpu_torch.ops import packet_trace as pt

    entries = lambda c: int(c[0][3].sum())  # noqa: E731
    with cs.Recorder() as rec:
        cs.canyon(640, 480, "dma").render_frame()
    dma = max(rec.calls["mt_stream"], key=lambda c: c[0][0].shape[1])
    with cs.Recorder() as rec:
        cs.canyon(640, 480, "segmented", early_exit=True).render_frame()
    ee = max((c for c in rec.calls["mt_trace"] if c[1]["mode"] == "closest"), key=entries)
    with cs.Recorder() as rec:
        cs.renderer(1920, 1080, early_exit=True).render_frame()
    rows = rec.calls["mt_trace"][0]

    def mirror_check(fn, mirror):
        def check(per_item, a, kw):
            cs.check_equal(f"{fn.__name__} at item size {per_item}", fn(*a, **kw), mirror(per_item, a, kw))

        return check

    def exit_mirror(per_item, a, kw):
        return pt.mt_trace_exit_split_reference(**cs.bind(pt.mt_trace_reference, a, kw), per_item=per_item)

    def stream_mirror(per_item, a, kw):
        return ps.mt_stream_split_reference(*a, **kw, per_item=per_item)

    def tpose_mirror(per_item, a, kw):
        return tpose_table.mt_tpose_split_reference(*a, **kw, per_item=per_item)

    def mxu_check(per_item, a, kw):
        cs.check_mxu(f"mt_mxu at item size {per_item}", a, kw, collections.defaultdict(float))

    calls = {
        "mt_stream canyon dma 640x480, busiest call": (
            ps.mt_stream, mirror_check(ps.mt_stream, stream_mirror), dma[:2], "ITEM_STREAM",
        ),
        "mt_trace[closest,early_exit] canyon 640x480, busiest call": (
            pt.mt_trace, mirror_check(pt.mt_trace, exit_mirror), ee[:2], "ITEM_EXIT",
        ),
        "mt_trace[rows,early_exit] torus 1920x1080 primary": (
            pt.mt_trace, mirror_check(pt.mt_trace, exit_mirror), rows[:2], "ITEM_EXIT",
        ),
    }
    probes, _ = cs.compare_probes(collections.defaultdict(float))
    _, _, a, kw = probes["mt_tpose"]
    calls["mt_tpose tc=64 torus 1920x1080 primaries"] = (
        tpose_table.mt_tpose, mirror_check(tpose_table.mt_tpose, tpose_mirror), (a, kw), "ITEM_TPOSE",
    )
    for precision in mxu_mt.PRECISIONS:
        _, _, a, kw = probes[f"mt_mxu[{precision}]"]
        const = "ITEM_MXU" if precision == "highest" else "ITEM_MXU_TC"
        calls[f"mt_mxu[{precision}] torus 1920x1080 primaries"] = (mxu_mt.mt_mxu, mxu_check, (a, kw), const)
    return calls


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--stream", type=int, nargs="+", default=[2, 4, 8, 16])
    parser.add_argument("--exit", type=int, nargs="+", default=[4, 8, 16, 32])
    parser.add_argument("--tpose", type=int, nargs="+", default=[1, 2, 4, 8])
    parser.add_argument("--mxu", type=int, nargs="+", default=[1, 2, 4, 8])
    parser.add_argument("--mxu-tc", type=int, nargs="+", default=[2, 4, 8, 16])
    args = parser.parse_args()
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import torch

    from rt_rs_tpu_torch.ops import cuda

    if not torch.cuda.is_available():
        raise SystemExit("item_sizes: no CUDA device")
    card = cs.card_line()
    calls = record_calls(cs)  # with the checkout's own library
    candidates = {
        "ITEM_STREAM": args.stream, "ITEM_EXIT": args.exit, "ITEM_TPOSE": args.tpose,
        "ITEM_MXU": args.mxu, "ITEM_MXU_TC": args.mxu_tc,
    }
    libs = {(c, v): variant_library(cuda, c, v) for c, vs in candidates.items() for v in vs}
    default_library = cuda.library
    ms: dict[str, dict[int | str, list[float]]] = {label: {} for label in calls}
    try:
        for turn in range(2):
            cuda.library = default_library
            for label, (fn, _, (a, kw), const) in calls.items():
                if const == "ITEM_EXIT":  # the default mode on the same lists
                    b = cs.without_early_exit(a, kw)
                    t = cs.profiled(lambda: fn(**b))[1]
                    ms[label].setdefault("default mode", []).append(t)
                    cs.say(f"[item_sizes] {label}: the default mode: {t:.4f} ms; {card}")
            for (const, value), lib in (list(libs.items()) if turn == 0 else list(libs.items())[::-1]):
                cuda.library = lambda lib=lib: lib
                for label, (fn, check, (a, kw), c) in calls.items():
                    if c != const:
                        continue
                    if turn == 0:
                        check(value, a, kw)
                    t = cs.profiled(lambda: fn(*a, **kw))[1]
                    ms[label].setdefault(value, []).append(t)
                    cs.say(f"[item_sizes] {label}: {const} = {value}: {t:.4f} ms; {card}")
    finally:
        cuda.library = default_library
    print(json.dumps({"ms": ms, "card": card}), flush=True)
    print(card, flush=True)


if __name__ == "__main__":
    main()

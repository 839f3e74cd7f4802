"""The readings that a cell's limits are set from, on the card.

    python3 rtbench/calibrate.py --workload <name> --seeds 1,2,... \
        [--control 3] [--faults stale_state,half_batch,altered] [--seconds 3]

In one process: the program's numbers compared (``rtbench/check.py``)
over a window of ``--seconds`` for each seed (the lower reading is the
largest); the control's, the reference computed in bfloat16 and put in
the program's place at the same frames and pixels, for the first
``--control`` seeds (the upper reading is the smallest); and each
planted fault's (``rtbench/faults.py``) on three seeds.  One JSON line
per reading, then a summary line.  Not part of a benchmark run.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--control", type=int, default=3, help="seeds of the control")
    p.add_argument("--faults", default="", help="comma-separated names of rtbench/faults.py")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    import torch

    from rtbench import faults, harness, spec
    from rtbench.drive import Runner

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(args.device)
    cell = harness.Cell.load(spec.benchmark(), args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    readings: dict[str, list[dict]] = {}

    def record(who: str, seed: int, frames: int, checks: dict) -> None:
        line = {"who": who, "seed": seed, "frames": frames, **{n: c["value"] for n, c in checks.items()}}
        readings.setdefault(who, []).append(line)
        print(json.dumps(line), flush=True)

    def windows(who: str, seeds_, control: int = 0) -> None:
        runner = Runner(cell.scene, cell.config, cell.traffic, args.device)
        runner.warm_up(seeds_[0])
        for j, seed in enumerate(seeds_):
            win = runner.window(seed, args.seconds)
            samples = [
                (i, pix, px.cpu().numpy() if torch.is_tensor(px) else px)
                for i, pix, px in win.sampler.samples()
            ]
            t0 = time.perf_counter()
            record(who, seed, win.frames, harness.judge(cell, seed, samples, dev)[1])
            print(f"reference {time.perf_counter() - t0:.3f} s", file=sys.stderr, flush=True)
            if j < control:
                checks = harness.judge(cell, seed, samples, dev, control_dtype=torch.bfloat16)[1]
                record("control", seed, win.frames, checks)
        runner.close()

    windows("program", seeds, args.control)
    for name in [f for f in args.faults.split(",") if f]:
        undo = faults.FAULTS[name]()
        try:
            windows(f"fault:{name}", seeds[:3])
        finally:
            undo()

    summary = {}
    for who, lines in readings.items():
        pick = max if who == "program" else min
        summary[who] = {n: pick(line[n] for line in lines) for n in ("bad_px", "worst_frame")}
    print(json.dumps({"summary": summary, "workload": args.workload, "card": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

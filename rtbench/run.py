"""Run one cell of the port's benchmark once.

    python3 rtbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with the cards the cell asks
for.  Prints the numbers compared and notes on standard error, and the
result as one JSON line, the last of standard output.  Exits 2, with
no result, when the card is missing or a forbidden module (JAX or the
JAX package) was loaded in the process.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from rtbench import guard, harness, spec

    def log(line: str) -> None:
        print(line, file=sys.stderr, flush=True)

    bench = spec.benchmark()
    try:
        guard.require_cards(int(spec.workload(bench, args.workload)["chips"]))
        import torch

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        result = harness.run(bench, args.workload, args.seed, args.seconds, bool(args.trace), log=log)
        guard.require_no_jax()
    except guard.RunRefused as e:
        log(f"refused: {e}")
        return 2
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

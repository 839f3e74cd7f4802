"""Ahead-of-time BVH construction (counterpart of
``rt_rs_tpu/tools/precompute.py``; the reference's
``src/tools/precompute.rs``): scene JSON -> ``*.bvh.json`` checkpoint
("reducing start up time", pdf p.24 §B.3), consumed by
``load --handler-bvh <path>``.

    python -m rt_rs_tpu_torch.tools.precompute --scene scenes/teatime.json \
        --item-count 2 --out teatime.bvh.json

``--device`` builds the LBVH on the device that ``--torch-device``
names (default ``cuda``); the checkpoint format is the same.
"""

from __future__ import annotations

import argparse

from rt_rs_tpu_torch.bvh import build_bvh
from rt_rs_tpu_torch.scene import Scene


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="precompute", description=__doc__)
    p.add_argument("--out", required=True)
    p.add_argument("--scene", required=True)
    p.add_argument("--eps", type=float, default=0.02)  # BvhIntrs default
    p.add_argument("--item-count", type=int, default=None)
    p.add_argument(
        "--device",
        action="store_true",
        help="build on the device (Morton sort, Karras hierarchy, parallel "
        "refit; one prim per leaf, so --eps / --item-count do not apply); "
        "the checkpoint format is the same",
    )
    p.add_argument(
        "--torch-device", choices=("cuda", "cpu"), default="cuda",
        help="the device --device builds on (default: cuda)",
    )
    args = p.parse_args(argv)

    scene = Scene.load(args.scene)
    if args.device:
        from rt_rs_tpu_torch.bvh.device import build_bvh_device

        data = build_bvh_device(scene, device=args.torch_device)
    else:
        if args.item_count is None:
            p.error("--item-count is required (unless --device)")
        data = build_bvh(scene, eps=args.eps, target_item_count=args.item_count)
    data.save(args.out)  # compact JSON, like serde_json::to_string
    print(
        f"{args.out}: {data.num_nodes} nodes, {data.indices.size} indices, "
        f"{data.byte_size()} B on-device"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

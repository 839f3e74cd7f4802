"""What the threaded walk's pack adds to an accel's build, on the host.

    python3 -m rt_rs_tpu_torch.experiments.pack_cost [--device cuda] [--copies 4]

``BvhIntrs(backend="threaded").build`` on a CUDA device packs the tree
into kernel G's wide records (``bvh/wide.py::pack_walk``); a CPU build
packs nothing.  For the canyon (``torus_canyon``, 50,562 triangles) and
a larger scene (``--copies`` canyons side by side, 100 apart), this
times, with ``time.perf_counter`` around each call and the device
synchronized: the build on the CPU (the builder, links, bounds, no
pack), the build on ``--device`` (the same plus the upload and the
pack), and ``pack_walk`` alone on the device's tree, each the median of
``--reps``.  Prints one line a scene and one JSON line, then the card's
name and power limit when the device is a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from rt_rs_tpu_torch.bvh import wide
from rt_rs_tpu_torch.handlers import get_handler
from rt_rs_tpu_torch.scene.presets import tiled_copies, torus_canyon


def timed(fn, device: torch.device, reps: int):
    """(the median seconds of ``reps`` calls of ``fn``, its last result)."""
    times, out = [], None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        times.append(time.perf_counter() - t0)
    return sorted(times)[len(times) // 2], out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--copies", type=int, default=4)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    dev = torch.device(args.device)
    canyon = torus_canyon()
    offsets = [(100.0 * (i % 2), 0.0, 100.0 * (i // 2)) for i in range(args.copies)]
    scenes = {"canyon": canyon, f"canyon x{args.copies}": tiled_copies(canyon, offsets)}
    out = {}
    for name, scene in scenes.items():
        h = get_handler("bvh", backend="threaded")
        cpu_s, _ = timed(lambda: h.build(scene, scene.pack(device="cpu")), torch.device("cpu"), args.reps)
        arrays = scene.pack(device=dev)
        dev_s, (accel, _) = timed(lambda: h.build(scene, arrays), dev, args.reps)
        tree = accel.walk
        pack_s, packed = timed(lambda: wide.pack_walk(*tree.binary, payload=False), dev, args.reps)
        row = {
            "tris": scene.num_prims, "nodes": int(tree.binary[0].shape[0]),
            "wide_nodes": int(packed.nodes.shape[0]), "stack": packed.stack,
            "packed_bytes": packed.device_bytes, "build_cpu_s": cpu_s, "build_device_s": dev_s,
            "pack_s": pack_s,
        }
        out[name] = row
        print(
            f"[pack_cost] {name}: {row['tris']} tris, {row['nodes']} nodes -> {row['wide_nodes']} wide "
            f"({row['packed_bytes']} B, stack {row['stack']}); build {cpu_s:.3f} s on the CPU, "
            f"{dev_s:.3f} s on {dev}; pack {pack_s:.3f} s", flush=True,
        )
    print(json.dumps({"device": str(dev), "pack_cost": out}), flush=True)
    if dev.type == "cuda":
        cmd = ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]
        print(subprocess.run(cmd, capture_output=True, text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()

"""Scene authoring CLI (counterpart of ``rt_rs_tpu/tools/construct.py``;
the reference's ``src/tools/construct.rs``).

    python -m rt_rs_tpu_torch.tools.construct --out scene.json \
        --model meshes/teapot.obj default \
        --light 50 0 0 1.8 --camera-pos 50 10 0 0 0 0 --camera-orbit

Quirk kept for parity: a specified material index is stored as
``idx + 1`` unconditionally (construct.rs:177-180) — correct when the
default red material was inserted at slot 0 (which happens when any
model uses ``default`` or no ``--material`` was given,
construct.rs:129-137), off-by-one otherwise, exactly like the
reference.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from rt_rs_tpu_torch.scene import Scene
from rt_rs_tpu_torch.scene.camera import CameraController, CameraUniform
from rt_rs_tpu_torch.scene.obj import load_obj


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="construct", description=__doc__)
    p.add_argument("--out", required=True)
    p.add_argument(
        "--light", nargs=4, type=float, action="append", default=[],
        metavar=("X", "Y", "Z", "STRENGTH"),
    )
    p.add_argument(
        "--model", nargs=2, action="append", required=True,
        metavar=("OBJ", "MATERIAL"),
        help="OBJ path + material index (or 'default')",
    )
    p.add_argument("--camera-pos", nargs=6, type=float, required=True,
                   metavar=("PX", "PY", "PZ", "AX", "AY", "AZ"))
    g = p.add_mutually_exclusive_group(required=True)
    g.add_argument("--camera-fixed", action="store_true")
    g.add_argument("--camera-orbit", action="store_true")
    p.add_argument(
        "--material", nargs=7, type=float, action="append", default=[],
        metavar=("R", "G", "B", "A0", "A1", "A2", "SPEC"),
    )
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)

    lights = [(l[:3], l[3]) for l in args.light]
    if not lights:
        lights = [([0.0, 0.0, 0.0], 0.0)]  # dummy (construct.rs:71-78)

    materials = [{"color": m[:3], "albedo": m[3:6], "spec": m[6]} for m in args.material]

    models = []
    for path, mat in args.model:
        if mat == "default":
            models.append((path, None))
        else:
            try:
                models.append((path, int(mat)))
            except ValueError:
                print(
                    "--model expects: [0] OBJ path, [1] material index or 'default'",
                    file=sys.stderr,
                )
                return 1

    # Default red material (construct.rs:129-137).
    if not materials or any(m is None for _, m in models):
        materials.insert(0, {"color": [0.5, 0.1, 0.1], "albedo": [0.9, 0.1, 0.0], "spec": 10.0})

    cp = args.camera_pos
    scene = Scene.empty(
        camera=CameraUniform(tuple(cp[:3]), tuple(cp[3:])),
        camera_controller=CameraController("Orbit" if args.camera_orbit else "Fixed"),
    )
    scene.light_pos = np.array([l[0] for l in lights], dtype=np.float32)
    scene.light_strength = np.array([l[1] for l in lights], dtype=np.float32)
    scene.mat_color = np.array([m["color"] for m in materials], dtype=np.float32)
    scene.mat_albedo = np.array([m["albedo"] for m in materials], dtype=np.float32)
    scene.mat_spec = np.array([m["spec"] for m in materials], dtype=np.float32)

    for path, mat in models:
        idx = (mat + 1) if mat is not None else 0  # construct.rs:177-180
        scene.add_mesh(load_obj(path), idx)

    scene.save(args.out, pretty=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

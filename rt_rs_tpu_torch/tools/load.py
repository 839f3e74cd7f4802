"""Full-featured runner (counterpart of ``rt_rs_tpu/tools/load.py``; the
reference's ``src/tools/load.rs``).

Handler flags mirror the reference (load.rs:148-192):

* ``--handler-naive``
* ``--handler-bvh [EPS | PATH]`` — bare = defaults; a float = runtime
  eps; anything else = path to a precomputed ``*.bvh.json``
* ``--handler-bvh-rf [EPS]``
* *no handler flag* = the Blank (no-op) baseline, like the reference
* ``--handler-pbvh [EPS]`` — the packet-table backend (an addition)

Headless additions: ``--frames N`` renders N orbit-stepped frames,
``--out`` writes the last frame as PNG, ``--benchmark`` runs the
study's protocol and writes ``benchmark.png`` in the working directory,
``--gif`` writes an orbit GIF, ``--profile DIR`` writes a
torch.profiler Chrome trace of the run into DIR and then prints the
port's tracing snapshot (``rt_rs_tpu_torch.tracing.snapshot()``: the
rays each bounce shaded of the slots launched, the chunk-list entries
each cull kept, kernel G's rays, node visits and prim tests, the frames
counted, the set-up seconds and the kernel launches; the trace holds
the renderer's ``rt.`` spans).  ``--device`` names
the torch device (default ``cuda``).  ``--bands N`` / ``--shards M``
render over N x M ranks (:mod:`rt_rs_tpu_torch.parallel`): N image
bands, each over M scene shards of the chunk table; on ``cuda`` one
rank per card (the run exits when there are fewer cards), on ``cpu``
N x M CPU ranks over gloo.

    python -m rt_rs_tpu_torch.tools.load --path scene.json --handler-pbvh \
        --width 384 --height 288 --frames 3 --out frame.png [--device cpu]
    python -m rt_rs_tpu_torch.tools.load --path scene.json --handler-pbvh \
        --width 64 --height 48 --bands 2 --shards 2 --device cpu --out f.png
"""

from __future__ import annotations

import argparse
import json
import os

from rt_rs_tpu_torch.config import ComputeConfig, Config, Resolution


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="load", description=__doc__)
    p.add_argument("--path", default="scenes/default.json")
    p.add_argument("--handler-naive", action="store_true")
    p.add_argument("--handler-bvh", nargs="*", default=None, metavar="EPS|PATH")
    p.add_argument("--handler-bvh-rf", nargs="*", type=float, default=None, metavar="EPS")
    p.add_argument("--handler-pbvh", nargs="*", default=None, metavar="EPS")
    p.add_argument("--benchmark", action="store_true")
    p.add_argument("--width", "-w", type=int)
    p.add_argument("--height", type=int)
    p.add_argument("--workgroup-size", type=int)
    p.add_argument("--fps", type=int)
    p.add_argument("--bounces", type=int)
    p.add_argument("--camera-light-strength", type=float)
    p.add_argument("--ambience", type=float)
    # Headless extensions
    p.add_argument("--frames", type=int, default=1)
    p.add_argument("--out", default=None, help="PNG path for the last frame")
    p.add_argument("--bench-frames", type=int, default=200)
    p.add_argument(
        "--gif", default=None, metavar="PATH",
        help="render one full camera orbit as an animated GIF",
    )
    p.add_argument(
        "--profile", default=None, metavar="DIR",
        help="write a torch.profiler Chrome trace of the run (host and "
        "device activity) into DIR",
    )
    p.add_argument(
        "--device", default="cuda",
        help="torch device every tensor lives on and every kernel runs on "
        "(default: cuda; cpu runs the kernels' plain-PyTorch twins)",
    )
    # Multi-device rendering (rt_rs_tpu_torch.parallel).
    p.add_argument(
        "--bands", type=int, default=None, metavar="N",
        help="shard the image over N devices (horizontal bands)",
    )
    p.add_argument(
        "--shards", type=int, default=None, metavar="M",
        help="shard the triangle chunk table over M devices per band",
    )
    # Dynamic geometry (DynamicRenderer).
    p.add_argument(
        "--dynamic", action="store_true",
        help="per-frame on-device accel REBUILD of animated geometry "
        "(1%%-amplitude vertex wobble over the orbit)",
    )
    p.add_argument(
        "--refit", action="store_true",
        help="like --dynamic but refit-only: the walk's tree built at the rest "
        "pose, per-frame bounds recompute (implies --dynamic)",
    )
    p.add_argument(
        "--seg-order", choices=("auto", "scene"), default="auto",
        help="segment visit order for scenes beyond the resident table: "
        "'auto' (default) = camera front-to-back per frame (output-exact), "
        "'scene' = build order",
    )
    return p


def pick_handler(args) -> tuple[str, dict]:
    if args.handler_naive:
        return "naive", {}
    if args.handler_bvh is not None:
        if len(args.handler_bvh) == 0:
            return "bvh", {}
        arg = args.handler_bvh[0]
        try:
            return "bvh", {"eps": float(arg)}
        except ValueError:
            if os.path.exists(arg):
                return "bvh", {"path": arg}
            raise SystemExit(
                "--handler-bvh requires either:\n"
                "  - The path to a precomputed BVH file\n"
                "  - An epsilon value (f32)"
            )
    if args.handler_bvh_rf is not None:
        if len(args.handler_bvh_rf) == 0:
            return "rf_bvh", {}
        return "rf_bvh", {"eps": args.handler_bvh_rf[0]}
    if args.handler_pbvh is not None:
        if len(args.handler_pbvh) == 0:
            return "pbvh", {}
        try:
            return "pbvh", {"eps": float(args.handler_pbvh[0])}
        except ValueError:
            raise SystemExit("--handler-pbvh takes an optional epsilon value (f32)")
    return "blank", {}  # reference default (load.rs:189-192)


def make_dynamic(args, config):
    """--dynamic / --refit: the per-frame rebuild / refit engine."""
    from rt_rs_tpu_torch.renderer import DynamicRenderer
    from rt_rs_tpu_torch.scene import Scene

    return DynamicRenderer(
        Scene.load(args.path), config=config, refit=args.refit, device=args.device
    )


def dynamic_wobble(scene):
    """1%-amplitude breathing of the rest pose: frame ``i``'s vertex
    positions."""
    import math

    import numpy as np

    rest = scene.vert_pos.astype(np.float32)

    def fn(i: int):
        return rest * np.float32(1.0 + 0.01 * math.sin(i * 0.3))

    return fn


def config_from_args(args) -> Config:
    """The Config of the resolution and compute flags; the resolution
    forms of load.rs:117-128."""
    if args.width and args.height and args.workgroup_size:
        res = Resolution.fixed(args.width, args.height, args.workgroup_size)
    elif args.width and args.height:
        res = Resolution.sized(args.width, args.height)
    elif args.workgroup_size:
        res = Resolution.dynamic(args.workgroup_size)
    else:
        res = Resolution()
    defaults = ComputeConfig()
    compute = ComputeConfig(
        bounces=args.bounces if args.bounces is not None else defaults.bounces,
        camera_light_source=(
            args.camera_light_strength
            if args.camera_light_strength is not None
            else defaults.camera_light_source
        ),
        ambience=args.ambience if args.ambience is not None else defaults.ambience,
    )
    return Config(compute=compute, resolution=res, fps=args.fps if args.fps else 60)


def make_renderer(args):
    """The renderer a run of ``args`` drives: a DynamicRenderer for
    ``--dynamic`` / ``--refit``, else a Renderer of the picked handler."""
    from rt_rs_tpu_torch.renderer import Renderer
    from rt_rs_tpu_torch.scene import Scene

    config = config_from_args(args)
    handler, kwargs = pick_handler(args)
    if args.dynamic or args.refit:
        return make_dynamic(args, config)
    return Renderer(
        Scene.load(args.path), config=config, handler=handler,
        handler_kwargs=kwargs, seg_order=args.seg_order, device=args.device,
    )


def run(args, renderer) -> int:
    """The run itself: the benchmark protocol, an orbit GIF, or
    ``--frames`` orbit steps with the last frame written to ``--out``."""
    import numpy as np

    from rt_rs_tpu_torch.utils.image import write_png

    if args.benchmark:
        from rt_rs_tpu_torch.timing import run_benchmark_protocol

        _, mean_ms = run_benchmark_protocol(renderer, frames=args.bench_frames)
        print(f"avg frame time over {args.bench_frames} frames: {mean_ms:.3f} ms")
        print("chart: benchmark.png")
        return 0

    if args.gif:
        from rt_rs_tpu_torch.utils.animation import render_orbit_gif

        times = render_orbit_gif(renderer, args.gif, frames=max(args.frames, 24))
        print(f"wrote {args.gif} ({len(times)} frames, avg {np.mean(times) * 1e3:.1f} ms)")
        return 0

    image = None
    vfn = dynamic_wobble(renderer.scene) if (args.dynamic or args.refit) else None
    for i in range(args.frames):
        image = renderer.render_image(vfn(i)) if vfn else renderer.render_image()
        renderer.orbit(1.0)
    if args.out and image is not None:
        write_png(args.out, image)
        print(f"wrote {args.out}")
    return 0


def run_sharded(args, config: Config, handler_name: str, handler_kwargs: dict) -> int:
    """--bands / --shards: the frames over ``bands x shards`` ranks
    (:func:`rt_rs_tpu_torch.parallel.make_sharded_render`; bands =
    data-parallel image rows, shards = slices of the chunk table), one
    rank per card on ``cuda`` and CPU ranks on ``cpu``.  Rank 0 prints
    and writes ``--out``."""
    import torch

    from rt_rs_tpu_torch.native import bindings
    from rt_rs_tpu_torch.native import build as native_build
    from rt_rs_tpu_torch.ops import cuda
    from rt_rs_tpu_torch.parallel.launch import run_ranks

    bands = args.bands or 1
    shards = args.shards or 1
    n = bands * shards
    device = torch.device(args.device)
    if device.type == "cuda":
        have = torch.cuda.device_count()
        if n > have:
            raise SystemExit(
                f"--bands {bands} x --shards {shards} needs {n} devices; torch sees "
                f"{have} CUDA device(s) (--device cpu renders on {n} CPU ranks)"
            )
        devices = [f"cuda:{i}" for i in range(n)]
        cuda.build()  # once, before the ranks load it
    else:
        devices = [str(device)] * n
    if bindings.available():
        native_build.build()
    run_ranks(_sharded_rank, devices, args, config, handler_name, handler_kwargs, bands, shards)
    return 0


def _sharded_rank(rank, args, config, handler_name, handler_kwargs, bands, shards) -> None:
    """One rank of :func:`run_sharded`."""
    import time

    import numpy as np

    from rt_rs_tpu_torch.handlers import get_handler
    from rt_rs_tpu_torch.parallel import hybrid_mesh, image_mesh, make_sharded_render
    from rt_rs_tpu_torch.renderer import device_sync
    from rt_rs_tpu_torch.scene import Scene
    from rt_rs_tpu_torch.utils.image import write_png

    mesh = hybrid_mesh(bands, shards) if shards > 1 else image_mesh(bands)
    scene = Scene.load(args.path)
    width, height = config.resolution.size()
    handler = get_handler(handler_name, **handler_kwargs)
    accel, arrays = handler.build(scene, scene.pack(device=mesh.device))
    stats = handler.stats(accel)
    if rank == 0:
        print(f"handler: {stats.name} ({stats.size} B) on mesh {mesh.axis_sizes}", flush=True)
    fn = make_sharded_render(
        handler, accel, arrays, config.compute, width, height, mesh,
        resolution=config.resolution,
    )
    camera = scene.camera
    frame = lum = None
    t0 = time.perf_counter()
    for _ in range(args.frames):
        frame, lum = fn(camera.pos, camera.at)
        camera = camera.orbited(1.0)
    device_sync(frame)
    dt = (time.perf_counter() - t0) / max(args.frames, 1) * 1e3
    if rank != 0:
        return
    print(f"{args.frames} frames, {dt:.2f} ms/frame, mean luminance {float(lum):.4f}", flush=True)
    if args.out and frame is not None:
        img = np.round(np.clip(frame.cpu().numpy(), 0.0, 1.0) * 255.0)
        write_png(args.out, img.astype(np.uint8))
        print(f"wrote {args.out}", flush=True)


def main(argv: list[str] | None = None) -> int:
    from rt_rs_tpu_torch.utils.log import init_logging

    init_logging()
    args = build_parser().parse_args(argv)
    if args.bands or args.shards:
        handler, kwargs = pick_handler(args)
        return run_sharded(args, config_from_args(args), handler, kwargs)
    renderer = make_renderer(args)
    print(f"handler: {renderer.stats.name} ({renderer.stats.size} B)")

    if not args.profile:
        return run(args, renderer)
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if renderer.device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        rc = run(args, renderer)
    os.makedirs(args.profile, exist_ok=True)
    trace = os.path.join(args.profile, "trace.json")
    prof.export_chrome_trace(trace)
    print(f"trace: {trace}")
    from rt_rs_tpu_torch import tracing

    print(f"tracing: {json.dumps(tracing.snapshot())}")
    return rc


if __name__ == "__main__":
    raise SystemExit(main())

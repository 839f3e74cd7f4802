"""``python -m rt_rs_tpu_torch.web --path scenes/default.json [--device cpu]``

``--unloaded --scene-dir DIR`` starts without a scene (the reference
wasm app's ``Scene::Unloaded`` start state): a black placeholder frame
until a scene button is pressed.
"""

import argparse
import os

from rt_rs_tpu_torch.web import serve


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="rt_rs_tpu_torch.web")
    p.add_argument("--path", default=None, help="scene JSON (required unless --unloaded)")
    p.add_argument(
        "--unloaded", action="store_true",
        help="start with no scene loaded (pick one in the browser)",
    )
    p.add_argument(
        "--scene-dir", default=None,
        help="directory of scene JSONs (default: --path's directory)",
    )
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--handler", default="pbvh")
    p.add_argument("--width", type=int, default=320)
    p.add_argument("--height", type=int, default=240)
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = p.parse_args(argv)
    if args.path is None and not (args.unloaded and args.scene_dir):
        p.error("--path is required (or --unloaded with --scene-dir)")
    scene_dir = args.scene_dir
    if args.unloaded and scene_dir is None:
        scene_dir = os.path.dirname(args.path)
    serve(
        None if args.unloaded else args.path,
        scene_dir=scene_dir,
        host=args.host, port=args.port, handler=args.handler,
        size=(args.width, args.height), device=args.device,
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Minimal demo (counterpart of ``rt_rs_tpu/tools/demo.py``; the
reference's ``src/demo.rs``): a scene through the naive handler at
640x480, a few orbit frames, the last written to ``demo.png``.

    python -m rt_rs_tpu_torch.tools.demo --path scenes/default.json [--device cpu]
"""

from __future__ import annotations

import argparse

from rt_rs_tpu_torch.config import Config, Resolution
from rt_rs_tpu_torch.renderer import Renderer
from rt_rs_tpu_torch.scene import Scene
from rt_rs_tpu_torch.utils.image import write_png


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="demo", description=__doc__)
    p.add_argument("--path", required=True, help="scene JSON")
    p.add_argument("--out", default="demo.png")
    p.add_argument("--frames", type=int, default=3)
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = p.parse_args(argv)

    renderer = Renderer(
        Scene.load(args.path),
        config=Config(resolution=Resolution.sized(640, 480)),
        handler="naive",
        device=args.device,
    )
    image = None
    for _ in range(args.frames):
        image = renderer.render_image()
        renderer.orbit(1.0)
    write_png(args.out, image)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

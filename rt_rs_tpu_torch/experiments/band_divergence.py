"""Where the gather-band frame first differs between the card and the CPU.

``gather_band_torus()`` at 32x16 (the gather branch on one table) flips
one pixel on a CUDA card against the port's CPU frame and the JAX
package's stored frame (ROADMAP §3).  This script renders the frame on
both devices with every kernel call recorded in call order, and prints
the first call whose inputs or outputs differ in any bit: once with the
glue as it is (``shade._rsqrt``: IEEE ``1 / sqrt``) and once with
``torch.rsqrt`` in its place (the approximate ``rsqrtf`` on CUDA).  It
also prints how often the glue's rounding-sensitive torch ops differ
between the devices on 4M seeded values.  Needs one CUDA card:

    python3 -m rt_rs_tpu_torch.experiments.band_divergence
"""

from __future__ import annotations

import inspect
import pathlib

import numpy as np
import torch

from rt_rs_tpu_torch import Config, Renderer, Resolution
from rt_rs_tpu_torch.ops import packet_trace, shade, shade_tile
from rt_rs_tpu_torch.scene.presets import gather_band_torus

BAND_FRAME = (
    pathlib.Path(__file__).resolve().parents[2] / "tests" / "data" / "torch_port_gather_band_32x16.npz"
)
SIZE = (32, 16)
ATOL = 2e-5
TARGETS = (
    (packet_trace, "refine_cull"),
    (packet_trace, "mt_trace"),
    (shade_tile, "shade_pre"),
    (shade_tile, "shade_post"),
)


def recorded_frame(device: str) -> tuple[np.ndarray, list]:
    """The frame on ``device`` and its kernel calls in call order ->
    (frame, [(name, bound arguments, outputs)])."""
    calls, saved = [], []
    for mod, name in TARGETS:
        fn = getattr(mod, name)
        saved.append((mod, name, fn))

        def rec(*a, _fn=fn, _name=name, **kw):
            out = _fn(*a, **kw)
            args = inspect.signature(_fn).bind(*a, **kw).arguments
            calls.append((_name, args, out if isinstance(out, tuple) else (out,)))
            return out

        setattr(mod, name, rec)
    try:
        r = Renderer(
            gather_band_torus(), config=Config(resolution=Resolution.sized(*SIZE)), handler="pbvh", device=device
        )
        frame = r.render_frame().cpu().numpy()
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    return frame, calls


def _differ(x: torch.Tensor, y: torch.Tensor) -> tuple[int, int]:
    """(values that differ, largest distance in ULP); NaN equals NaN
    whatever its bits (the card's NaN is 0x7fffffff, the CPU's
    0xffc00000)."""
    x = x.cpu()
    if not x.dtype.is_floating_point:
        return int((x != y).sum()), 0
    a, b = (v.contiguous().view(torch.int32).to(torch.int64) for v in (x, y))
    d = (torch.where(a < 0, -(a & 0x7FFFFFFF), a) - torch.where(b < 0, -(b & 0x7FFFFFFF), b)).abs()
    d = torch.where(torch.isnan(x) & torch.isnan(y), 0, d)
    return int((d != 0).sum()), int(d.max()) if d.numel() else 0


def first_divergence(card: list, cpu: list) -> str:
    for i, ((name, args, out), (name2, args2, out2)) in enumerate(zip(card, cpu)):
        if name != name2:
            return f"call #{i}: {name} on the card, {name2} on the CPU"
        pairs = [(f"input {k}", v, args2[k]) for k, v in args.items() if isinstance(v, torch.Tensor)]
        pairs += [(f"output {j}", x, y) for j, (x, y) in enumerate(zip(out, out2)) if x is not None]
        for what, x, y in pairs:
            n, ulp = _differ(x, y)
            if n:
                return f"call #{i} {name} {what}: {n} of {y.numel()} values differ (max {ulp} ULP)"
    return f"none of {len(card)} calls: inputs and results are the same bits"


def op_differences() -> str:
    """How often torch's rsqrt, sqrt, pow and ``shade._rsqrt`` give other
    bits on the card than on the CPU."""
    g = torch.Generator().manual_seed(0)
    x = torch.rand(1 << 22, generator=g) * 100.0 + 1e-3
    e = torch.rand(1 << 22, generator=g) * 64.0
    base = torch.rand(1 << 22, generator=g)
    parts = []
    for name, fn, args in (
        ("torch.rsqrt", torch.rsqrt, (x,)),
        ("torch.sqrt", torch.sqrt, (x,)),
        ("shade._rsqrt", shade._rsqrt, (x,)),
        ("torch.pow", torch.pow, (base, e)),
    ):
        on_card = fn(*(t.cuda() for t in args)).cpu()
        parts.append(f"{name} {int((on_card != fn(*args)).sum())}")
    return f"card != CPU in {', '.join(parts)} of {x.numel()} values"


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("band_divergence: needs a CUDA card")
    print(f"[band] {op_differences()}", flush=True)
    on_cpu, calls_cpu = recorded_frame("cpu")
    ref = np.load(BAND_FRAME)["frame"]
    glue = shade._rsqrt
    for label, rsqrt in (("torch.rsqrt glue", torch.rsqrt), ("the glue as it is", glue)):
        shade._rsqrt = rsqrt
        try:
            frame, calls = recorded_frame("cuda")
        finally:
            shade._rsqrt = glue
        for what, other in (("the JAX package's stored frame", ref), ("the port's CPU frame", on_cpu)):
            d = np.abs(frame - other)
            far = np.argwhere(d > ATOL)
            print(
                f"[band] gather band 32x16 ({label}) vs {what}: max abs {d.max():.3g}, "
                f"{len(far)} of {d.size} values beyond {ATOL} at (row, col) "
                f"{sorted({(int(i), int(j)) for i, j, _ in far})}",
                flush=True,
            )
        print(f"[band] first card/CPU divergence ({label}): {first_divergence(calls, calls_cpu)}", flush=True)


if __name__ == "__main__":
    main()

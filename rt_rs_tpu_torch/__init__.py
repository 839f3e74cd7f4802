"""rt_rs_tpu_torch — the PyTorch + CUDA port of rt_rs_tpu.

A second package beside the JAX reference ``rt_rs_tpu``: the same scene
formats (scene JSON, OBJ, ``*.bvh.json``), the same handlers (``bvh``,
the default, with its threaded walk; ``rf_bvh`` walking its 16-byte
records where they lie; ``pbvh`` with
packet chunk culling, the Möller–Trumbore packet trace with
kernel-emitted rows, any-hit shadows and the per-ray refine cull;
``lbvh`` over a chunk table built on the device; ``naive``,
``blank``), ``Renderer`` and ``DynamicRenderer`` (animated geometry,
rebuilt on the device every frame) and their frame paths, with every
TPU kernel of those paths, and the threaded walk, written by hand as
CUDA kernels for Hopper (``sm_90a``, ``csrc/``).  Each kernel has a plain-PyTorch twin, which
runs for CPU tensors.  Around them: the CLI tools (``tools/``), the
study's benchmark protocol (``timing/``), the web viewer (``web/``),
the image and orbit-GIF helpers (``utils/``), multi-device rendering
over ``torch.distributed`` ranks (``parallel/``) and the native C++ BVH
builder and OBJ parser (``native/``).

This package imports ``torch`` and never ``jax`` or ``rt_rs_tpu``.
"""

from rt_rs_tpu_torch.config import ComputeConfig, Config, Resolution
from rt_rs_tpu_torch.renderer import DynamicRenderer, Renderer, run_headless
from rt_rs_tpu_torch.scene import Scene
from rt_rs_tpu_torch.scene.camera import CameraController, CameraUniform

__version__ = "0.1.0"

__all__ = [
    "ComputeConfig",
    "Config",
    "Resolution",
    "Scene",
    "CameraUniform",
    "CameraController",
    "Renderer",
    "DynamicRenderer",
    "run_headless",
]

"""Kernel G's ablation on one card: its packed records alone, its wide tree, the width and the grid.

    python3 experiments/walk_ablation/walk_ablation.py

Run from the root of a checkout (it imports ``chip_smoke`` and the
port).  It stays outside the package: no frame path and no test needs
it.  Variants of
kernel G (``csrc/bvh_walk.cu``) on the same recorded calls, each first
checked bit for bit against the checkout's kernel on every recorded
call, then timed as chip_smoke.py's phase 6 does (torch.profiler device
time, the L2 cache overwritten before each call), in two rounds of
opposite order:

* ``binary``: the packed records alone (the design's step 1): 32-byte
  binary nodes and kernel G's 48-byte prims, walked over the escape
  links one unit of work a step as the parent design did
  (``bvh_walk_binary.cu`` beside this script, built on its own);
* ``wide``: the checkout's kernel G (4-wide nodes, the stack, nodes
  then prims: steps 1 to 3);
* ``wide, width 8``: kernel G built with ``kWidth = 8``, the tree packed
  8 wide (``pack_wide``: ``bvh/wide.py``'s packer with its width set
  to 8 for the call);
* ``wide, persistent``: kernel G on a persistent grid (as many blocks as
  fit on the card) whose warps take 32-ray batches from an atomic
  counter, reset on the stream before each launch.

The calls: the frames' walks (kernel G's tiled calls) as the flat
entry's closest-hit calls on the same rays: the primary call (the
first) of the threaded ``bvh`` and ``rf_bvh`` torus 384x288 frames, of
the ``bvh`` canyon 640x480 frame and of the ``bvh`` torus 1080p frame;
and every call of the torus 1080p and canyon 640x480 frames together
(their first call reads from HBM, the others find what it left in L2).  Prints one JSON line of device ms by
call and variant, then the card's name and power limit.  Needs one card.
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import shutil
import subprocess
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[2]
BINARY_SRC = pathlib.Path(__file__).resolve().parent / "bvh_walk_binary.cu"
VARIANTS = ("binary", "wide", "wide, width 8", "wide, persistent")
# (text, replacement) pairs that turn kernel G's flat entry into the
# persistent grid (the tiled kernels share its loop, but the ablation
# launches the flat entry alone).
PERSISTENT = (
    (
        "  const int i = blockIdx.x * kBlock + threadIdx.x;\n  WalkCount count;\n  if (i < n) {\n"
        "    LocalStack stack;\n    walk_ray<MODE>(i, rays, stack, nodes, prims, t_min, t_max, eps, miss_t,\n"
        "                   out, count);\n  }\n  count_walks<MODE>(",
        "  WalkCount count;\n  LocalStack stack;\n  for (;;) {\n  int base = 0;\n"
        "  if ((threadIdx.x & 31) == 0) base = atomicAdd(&g_next, 32);\n"
        "  base = __shfl_sync(0xffffffffu, base, 0);\n  if (base >= n) break;\n"
        "  const int i = base + (threadIdx.x & 31);\n  if (i < n) {\n"
        "    walk_ray<MODE>(i, rays, stack, nodes, prims, t_min, t_max, eps, miss_t,\n"
        "                   out, count);\n  }\n  }\n  count_walks<MODE>(",
    ),
    ("struct Ray {", "__device__ int g_next;\n\nstruct Ray {"),
    (
        "    if (depth > kLocalStack) return (int)cudaErrorInvalidValue;\n"
        "    const unsigned blocks = (unsigned)((n + kBlock - 1) / kBlock);\n",
        "    if (depth > kLocalStack) return (int)cudaErrorInvalidValue;\n"
        "    void* counter;\n    cudaGetSymbolAddress(&counter, g_next);\n"
        "    cudaMemsetAsync(counter, 0, sizeof(int), stream);\n"
        "    int per_sm = 0, sms = 0, dev = 0;\n    cudaGetDevice(&dev);\n"
        "    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);\n"
        "    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, bvh_walk_kernel, kBlock, 0);\n"
        "    const unsigned full = (unsigned)((n + kBlock - 1) / kBlock);\n"
        "    const unsigned blocks = full < (unsigned)(per_sm * sms) ? full : (unsigned)(per_sm * sms);\n",
    ),
)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def variant_library(cuda, name: str, patches) -> ctypes.CDLL:
    """Kernel G built from a copy of csrc/ with ``patches`` applied to
    bvh_walk.cu (each text must occur once) -> the loaded library."""
    root = cuda.BUILD / "walk_ablation" / name.replace(", ", "_").replace(" ", "_")
    csrc = root / "csrc"
    shutil.rmtree(csrc, ignore_errors=True)
    shutil.copytree(cuda.CSRC, csrc)
    path = csrc / "bvh_walk.cu"
    src = path.read_text()
    for old, new in patches:
        if src.count(old) != 1:
            raise RuntimeError(f"{old!r} not found once in bvh_walk.cu")
        src = src.replace(old, new)
    path.write_text(src)
    saved = cuda.CSRC, cuda.BUILD
    cuda.CSRC, cuda.BUILD = csrc, root / "build"
    try:
        cuda.library.cache_clear()
        return cuda.library()
    finally:
        cuda.CSRC, cuda.BUILD = saved
        cuda.library.cache_clear()


def binary_library(cuda) -> ctypes.CDLL:
    """bvh_walk_binary.cu built alone with the port's
    flags -> the loaded library."""
    out = cuda.BUILD / "walk_ablation" / "binary"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / "libbvh_walk_binary.so"
    cmd = [cuda.nvcc_path(), *cuda.NVCC_FLAGS, "-I", str(cuda.CSRC), "-shared", "-o", str(lib), str(BINARY_SRC)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError("nvcc failed:\n" + proc.stdout + proc.stderr)
    handle = ctypes.CDLL(str(lib))
    handle.rt_bvh_walk_binary.argtypes = [_P] * 6 + [_I, _I, _F, _F, _F, _F, _P, _P, _P]
    handle.rt_bvh_walk_binary.restype = _I
    return handle


def binary_records(tree):
    """A WalkTree's binary tree as the ``binary`` variant's 32-byte
    nodes [M, 8] int32 on its device: {lo.xyz, miss link}, {hi.xyz,
    leaf word}, the slab bounds with the walk's wobble, the leaf word ~q
    for a leaf whose prims start at packed prim q (kernel G's prims) and
    0 for other nodes."""
    import torch

    node_min, node_max, _, miss, count, leaves = tree.binary[:6]
    bmin, bmax = node_min.cpu(), node_max.cpu()
    wob = 2e-6 + 1e-5 * torch.maximum(bmin.abs(), bmax.abs())
    cnt = count.cpu().numpy()
    m = cnt.shape[0]
    if tree.payload:
        slots = leaves.cpu().numpy().reshape(m, -1)
        has = ((slots != 0) & (np.arange(slots.shape[1])[None] < cnt[:, None])).any(axis=1)
    else:
        has = cnt > 0
    last = np.nonzero(tree.prims[:, 7].cpu().numpy())[0]
    word = np.zeros(m, dtype=np.int64)
    word[np.nonzero(has)[0]] = ~np.concatenate([[0], last[:-1] + 1])
    rec = np.zeros((m, 8), dtype=np.int32)
    rec[:, 0:3] = (bmin - wob).view(torch.int32).numpy()
    rec[:, 3] = miss.cpu().numpy()
    rec[:, 4:7] = (bmax + wob).view(torch.int32).numpy()
    rec[:, 7] = word
    return torch.from_numpy(rec).to(node_min.device)


def pack_wide(tree, width: int):
    """``tree``'s binary tree packed ``width`` wide: ``wide.pack_walk``
    with the module's width and node size set for the call."""
    from rt_rs_tpu_torch.bvh import wide

    saved = wide.WIDTH, wide.NODE_WORDS
    wide.WIDTH, wide.NODE_WORDS = width, 8 * width
    try:
        return wide.pack_walk(*tree.binary, payload=tree.payload)
    finally:
        wide.WIDTH, wide.NODE_WORDS = saved


def main() -> None:
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import torch

    from rt_rs_tpu_torch.bvh import wide
    from rt_rs_tpu_torch.ops import bvh_walk, cuda
    from rt_rs_tpu_torch.scene.presets import torus_canyon, torus_scene

    if not torch.cuda.is_available():
        raise SystemExit("walk_ablation: no CUDA device")
    card = cs.card_line()
    frames = {
        "bvh torus 384x288": (torus_scene, 384, 288, "bvh"),
        "rf_bvh torus 384x288": (torus_scene, 384, 288, "rf_bvh"),
        "bvh canyon 640x480": (torus_canyon, 640, 480, "bvh"),
        "bvh torus 1920x1080": (torus_scene, 1920, 1080, "bvh"),
    }
    recorded = {}
    for label, (scene, w, h, handler) in frames.items():
        r = cs.renderer(w, h, scene(), handler=handler, backend="threaded")
        with cs.Recorder() as rec:
            r.render_frame()
        # the frame's walks through the tiled entry, as the flat entry's
        # closest-hit calls on the same rays
        flat = [cs.flat_walk(c) for c in rec.calls["bvh_walk_tiled"]]
        recorded[label] = [(a, kw, bvh_walk.bvh_walk(*a, **kw)) for a, kw, _ in flat]
    calls = {f"{label} primary": recorded[label][:1] for label in frames}
    calls["bvh torus 1920x1080, the frame's calls"] = recorded["bvh torus 1920x1080"]
    calls["bvh canyon 640x480, the frame's calls"] = recorded["bvh canyon 640x480"]

    libs = {
        "binary": binary_library(cuda),
        "wide": cuda.library(),
        "wide, width 8": variant_library(cuda, "wide, width 8", [("constexpr int kWidth = 4;", "constexpr int kWidth = 8;")]),
        "wide, persistent": variant_library(cuda, "wide, persistent", PERSISTENT),
    }
    packed: dict[tuple[str, int], tuple] = {}

    def records(variant: str, tree):
        """The (nodes, prims, node count) a variant walks for ``tree``."""
        key = (variant, id(tree))
        if key not in packed:
            if variant == "binary":
                packed[key] = (binary_records(tree), tree.prims)
            elif variant == "wide, width 8":
                t8 = pack_wide(tree, 8)
                packed[key] = (t8.nodes, t8.prims)
            else:
                packed[key] = (tree.nodes, tree.prims)
        return packed[key]

    def run(variant: str, a, kw):
        o, d, excl, valid, tree = a
        nodes, prims = records(variant, tree)
        n = o.shape[0]
        t = torch.empty((n,), dtype=torch.float32, device=o.device)
        pid = torch.empty((n,), dtype=torch.int32, device=o.device)
        window = (kw["t_min"], kw["t_max"], kw["eps"], float(np.float32(kw["t_max"] + 1.0)))
        ptrs = [x.data_ptr() for x in (o, d, excl, valid, nodes, prims)]
        stream = torch.cuda.current_stream().cuda_stream
        if variant == "binary":
            err = libs[variant].rt_bvh_walk_binary(*ptrs, n, nodes.shape[0], *window, t.data_ptr(), pid.data_ptr(), stream)
        else:
            err = libs[variant].rt_bvh_walk(
                *ptrs, None, n, tree.stack, 0, *window, t.data_ptr(), pid.data_ptr(), None, 0, stream
            )
        if err != 0:
            raise RuntimeError(f"{variant}: CUDA launch failed with error {err}")
        return t, pid

    for variant in VARIANTS:
        for label, cl in calls.items():
            for i, (a, kw, out) in enumerate(cl):
                cs.check_equal(f"{variant} {label}#{i}", run(variant, a, kw), out)
    ms: dict[str, dict[str, list[float]]] = {label: {v: [] for v in VARIANTS} for label in calls}
    for turn in range(2):
        for variant in VARIANTS if turn == 0 else VARIANTS[::-1]:
            for label, cl in calls.items():
                t = cs.profiled(lambda: [run(variant, a, kw) for a, kw, _ in cl])[1]
                ms[label][variant].append(t)
                cs.say(f"[walk_ablation] {label}: {variant}: {t:.4f} ms; {card}")
    print(json.dumps({"ms": ms, "card": card}), flush=True)
    print(card, flush=True)


if __name__ == "__main__":
    main()

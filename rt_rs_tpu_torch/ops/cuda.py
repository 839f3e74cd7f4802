"""Build, load and call the port's hand-written CUDA kernels.

The kernels live in ``rt_rs_tpu_torch/csrc/*.cu`` and are compiled for
Hopper (``sm_90a``) by ``nvcc`` into one shared library with a plain C
interface, loaded through ``ctypes``.  The build runs at first use, from
the sources in this checkout only, into ``rt_rs_tpu_torch/build/<hash>``
where the hash covers the sources and the flags, so an edited source
rebuilds and an unchanged one loads the cached library.

The flags pin the arithmetic: no FMA contraction (``-fmad=false``),
IEEE division and square root, denormals kept, never
``--use_fast_math``.  The kernels must equal their plain-PyTorch twins
op for op (see csrc/common.cuh).

Nothing here runs at import: the CPU tests import every module, and
a CPU-only host may have no ``nvcc``.  A CUDA tensor handed to a kernel
wrapper either launches the kernel or raises; there is no fallback.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
from typing import Callable

import torch

from rt_rs_tpu_torch import tracing

PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG / "build"
LIB_NAME = "librt_rs_tpu_torch_kernels.so"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *ARCH,
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-fmad=false", "-prec-div=true", "-prec-sqrt=true", "-ftz=false",
    "-Xptxas=-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points -> argument types (pointers and the stream as c_void_p).
# The counting kernels take the trace buffer and a counter's index
# (tracing.kernel_args) just before the stream.
SIGNATURES = {
    "rt_refine_cull": [_P, _P, _P, _P, _P, _I, _I, _I, _F, _P],
    "rt_mt_trace": [_P] * 13 + [_I, _I, _I, _I, _I, _F, _F, _F, _F, _I, _I, _P, _I, _P],
    "rt_mt_stream": [_P] * 11 + [_I, _I, _I, _I, _F, _F, _F, _F, _P],
    "rt_shade_pre": [_P] * 6 + [_I, _I, _I, _I] + [_P] * 4 + [_P],
    "rt_shade_post": [_P] * 10 + [_I, _I, _I, _I, _I, _F, _F, _P, _P, _I, _P],
    "rt_shade_bounce": [_P] * 13 + [_I] * 6 + [_F, _F] + [_P] * 5 + [_P, _I, _P],
    "rt_fma_peak": [_P, _P, _I, _I, _I, _P],
    "rt_mt_tpose": [_P] * 8 + [_I, _I, _I, _I, _F, _F, _F, _F, _P],
    "rt_mt_mxu": [_P] * 9 + [_I, _I, _I, _I, _F, _F, _F, _F, _I, _P],
    "rt_bvh_walk_tiled": [_P] * 6 + [_I] * 4 + [_F] * 4 + [_P] * 4 + [_P, _I, _P],
    "rt_bvh_walk_rf_tiled": [_P] * 8 + [_I] * 4 + [_F] * 4 + [_P] * 4 + [_P, _I, _P],
    "rt_wide_refit": [_P] * 4 + [_I] + [_P] * 2 + [_I, _I] + [_P] * 2 + [_P, _I, _P],
    "rt_wide_build": [_P] * 3 + [_I] + [_P] * 21 + [_I] + [_P, _I, _P],
}


def sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and PATH); the CUDA "
            "kernels cannot be built"
        )
    return found


def build_key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> pathlib.Path:
    """Compile the kernels (once per source hash) -> the library path.
    Each source compiles in its own ``nvcc``, all started together, then
    one ``nvcc -shared`` links them.  The compilers' reports
    (``-Xptxas=-v``: registers, shared memory, spills per kernel) are
    kept beside the library as ``build.log``."""
    out_dir = BUILD / build_key()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tracing.count_setup("library_built")
    nvcc = nvcc_path()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        tmp = pathlib.Path(tmp)
        jobs = []
        for src in (s for s in sources() if s.suffix == ".cu"):
            obj = tmp / f"{src.stem}.o"
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", str(obj), str(src)]
            proc = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )
            jobs.append((cmd, obj, proc))
        log, failed = [], []
        for cmd, _, proc in jobs:
            out, _ = proc.communicate()
            log.append(" ".join(cmd) + "\n" + out)
            if proc.returncode != 0:
                failed.append(out)
        tmp_lib = tmp / LIB_NAME
        if not failed:
            cmd = [nvcc, *ARCH, "-shared", "-o", str(tmp_lib), *(str(o) for _, o, _ in jobs)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            log.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
            if proc.returncode != 0:
                failed.append(proc.stdout + proc.stderr)
        (out_dir / "build.log").write_text("\n".join(log))
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        os.replace(tmp_lib, lib)
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first call), under the
    set-up span ``rt.library`` (its seconds: ``library_s``)."""
    with tracing.setup("rt.library", "library_s"):
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


# Kernel launches by wrapper name (mt_trace by mode, e.g. "mt_trace[rows]"),
# counted by `call` once per launched kernel: a run shows from these that
# it went through the kernels.  `LAUNCHES.clear()` resets them.  A CUDA
# graph's launches are counted at each replay (`captured_launches`).
LAUNCHES: collections.Counter[str] = collections.Counter()


def captured_launches(capture: Callable[[], None]) -> collections.Counter[str]:
    """Run ``capture``, a CUDA graph capture, whose wrapper calls record
    their kernels in the graph and launch nothing -> the launches they
    recorded, which each replay of the graph makes.  ``LAUNCHES`` is
    left as it was before the capture."""
    before = LAUNCHES.copy()
    try:
        capture()
    finally:
        recorded = LAUNCHES - before
        LAUNCHES.clear()
        LAUNCHES.update(before)
    return recorded


def call(counter: str, name: str, *args) -> None:
    """Launch C entry point ``name`` on the current stream, raise on a
    launch error (a refused launch never runs, and a later synchronize
    would not report it), and count it under ``counter``."""
    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(library(), name)(*args, stream)
    if err == CUDA_INVALID_CONFIGURATION:
        raise RuntimeError(
            f"{name}: CUDA launch failed with error {err} (invalid configuration): no "
            "block fits on an SM; its shared memory (a ring of two chunks: see the "
            "kernel's staging policy) or its threads exceed the card's limit "
            "(227 KiB and 1024 on an H100)"
        )
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
    LAUNCHES[counter] += 1


# cudaErrorInvalidConfiguration, which a launcher also returns when its
# occupancy query finds no block that fits.
CUDA_INVALID_CONFIGURATION = 9


def ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def check(
    name: str,
    t: torch.Tensor,
    dtype: torch.dtype,
    shape: tuple[int, ...],
    device: torch.device,
) -> None:
    """Validate one kernel argument before its pointer is passed on."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")

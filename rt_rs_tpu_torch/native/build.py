"""Build the native library (``rt_native.cpp``) at first use.

Counterpart of ``rt_rs_tpu/native/build.py``, with its compiler and
flags: ``g++ -O2 -march=native -shared -fPIC -std=c++17
-ffp-contract=off -fno-fast-math`` (f32 semantics must match NumPy
exactly: no FMA contraction, no fast-math reassociation).  The library
goes into ``rt_rs_tpu_torch/build/native-<hash>/`` (gitignored), the
hash covering the source, the flags and the host CPU that
``-march=native`` compiles for, so an edited source or another host
builds anew.  The build is atomic: it compiles in a temporary directory
beside the target and renames the result into place, so processes that
build at once each end with a complete library.

    python -m rt_rs_tpu_torch.native.build
"""

from __future__ import annotations

import functools
import hashlib
import os
import pathlib
import subprocess
import tempfile

HERE = pathlib.Path(__file__).resolve().parent
SRC = HERE / "rt_native.cpp"
BUILD = HERE.parent / "build"
LIB_NAME = "librt_native.so"
CXX = "g++"
FLAGS = (
    "-O2", "-march=native", "-shared", "-fPIC", "-std=c++17",
    "-ffp-contract=off", "-fno-fast-math",
)


class NativeBuildError(RuntimeError):
    """The native library could not be built."""


def _fail(what: str) -> NativeBuildError:
    return NativeBuildError(
        f"native library build failed ({what}); set RT_NATIVE=0 to use the "
        "NumPy BVH builder and the Python OBJ parser instead"
    )


@functools.cache
def _target() -> str:
    """What ``-march=native`` means on this host: g++'s target options."""
    try:
        proc = subprocess.run(
            [CXX, "-march=native", "-Q", "--help=target"],
            capture_output=True, text=True, check=False,
        )
    except FileNotFoundError:
        raise _fail(f"{CXX} not found") from None
    if proc.returncode != 0:
        raise _fail(proc.stderr.strip() or f"{CXX} exit code {proc.returncode}")
    return proc.stdout


def lib_path() -> pathlib.Path:
    """Where this host's build of the current source lives."""
    h = hashlib.sha256(" ".join((CXX, *FLAGS)).encode())
    h.update(_target().encode())
    h.update(SRC.read_bytes())
    return BUILD / f"native-{h.hexdigest()[:16]}" / LIB_NAME


def build() -> pathlib.Path:
    """Compile the library unless this host's build of the current
    source exists -> its path.  Raises :class:`NativeBuildError`."""
    lib = lib_path()
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=lib.parent) as tmp:
        out = pathlib.Path(tmp) / LIB_NAME
        proc = subprocess.run(
            [CXX, *FLAGS, str(SRC), "-o", str(out)], capture_output=True, text=True
        )
        if proc.returncode != 0:
            raise _fail(proc.stderr.strip())
        os.replace(out, lib)
    return lib


if __name__ == "__main__":
    print(f"built {build()}")

"""Builds the package's hand-written CUDA kernels with ``nvcc`` and loads
them with ``ctypes``.

Each ``csrc/<name>.cu`` has a plain ``extern "C"`` interface and is
compiled on first use into ``build/kernels/`` at the repository root, for
``sm_90a`` (Hopper). The library's file name carries a hash of the source
and the flags, so an edited source is rebuilt and a built one is reused.
Nothing here runs at import time: machines without ``nvcc`` import the
package and run the plain torch versions on CPU tensors.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = CSRC.parents[1] / "build" / "kernels"
# no --use_fast_math: the kernels' drive and norms need the full-precision
# cos and sqrt
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_loaded: dict = {}


def nvcc() -> str:
    """Path of ``nvcc``: on PATH, else under CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin and "
        "/usr/local/cuda/bin); the CUDA kernels need the CUDA toolkit")


def library_path(name: str) -> pathlib.Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(name: str) -> pathlib.Path:
    """Compile ``csrc/<name>.cu`` unless the same source was built before.
    Raises with the compiler's output if ``nvcc`` fails."""
    so = library_path(name)
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing
    return so


def load(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        _loaded[name] = lib
    return lib

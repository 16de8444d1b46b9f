"""Builds the package's hand-written CUDA kernels with ``nvcc`` and loads
them with ``ctypes``.

Each ``csrc/<name>.cu`` of ``SOURCES`` has a plain ``extern "C"``
interface and is compiled on first use into ``build/kernels/`` at the
repository root, for ``sm_90a`` (Hopper); ``build`` compiles several
sources at once, one ``nvcc`` each, started together. The library's file
name carries a hash of the source,
the shared headers ``csrc/*.cuh`` and the flags, so an edited source or
header is rebuilt and a built one is reused.
Nothing here runs at import time: machines without ``nvcc`` import the
package and run the plain torch versions on CPU tensors. The wrappers
of K1, K2, K4 and K9 call :func:`refuse_grad` before a launch (K6-K8
launch inside custom operators with their own backward).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

import torch

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
# the step kernel K1, the loop kernel K2 (with the steps K3 and K5), the
# chain step kernel K4, the per-trajectory dense chain kernel K9, the
# adjoint kernels K6, K7 and K8
SOURCES = ("fused_rk_step", "fused_loop", "chain_expmv", "dense_chains",
           "adjoint")
BUILD_DIR = CSRC.parents[1] / "build" / "kernels"
# no --use_fast_math: the kernels' drive and norms need the full-precision
# cos and sqrt; -Xptxas -v leaves each kernel's registers and spills in
# the build log beside the library (build_log)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict = {}


def refuse_grad(kernel: str, *tensors) -> None:
    """Raise ``TypeError`` where autograd would record a launch of
    ``kernel``: its outputs come back through raw pointers with no
    ``grad_fn``, so an input that requires grad would get a zero gradient
    and no error."""
    if torch.is_grad_enabled() and any(
            isinstance(a, torch.Tensor) and a.requires_grad for a in tensors):
        raise TypeError(
            f"{kernel}: an input requires grad, and this CUDA kernel has no "
            "backward; for gradients run the stepper's torch version on CPU "
            "tensors (method='scan' through the driver, diff.solve_for_grad) "
            "or the reversible adjoint of diff.py")


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
    """Where ``csrc/<name>.cu`` builds to: the name carries a hash of the
    source, of every shared header in ``csrc/`` it may include, and of the
    flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build_log(name: str) -> pathlib.Path:
    """The compiler's output for the library ``library_path(name)``."""
    return library_path(name).with_suffix(".log")


def build(*names: str) -> dict:
    """Compile each ``csrc/<name>.cu`` that was not built from the same
    sources before, one ``nvcc`` per source, all started together.
    Returns {name: seconds until its library was ready} (0.0 for one
    built before). Raises with the compiler's output if ``nvcc`` fails."""
    started = time.perf_counter()
    running, ready = {}, {}
    for name in names:
        so = library_path(name)
        if so.exists():
            ready[name] = 0.0
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        # the compiler's output goes to a file: a pipe nobody reads while
        # the others compile could fill and stall it
        log = tmp.with_suffix(".log")
        with open(log, "w") as out:
            proc = subprocess.Popen(cmd, stdout=out, stderr=subprocess.STDOUT)
        running[name] = (proc, cmd, tmp, log, so)
    try:
        while running:
            for name, (proc, cmd, tmp, log, so) in list(running.items()):
                if proc.poll() is None:
                    continue
                del running[name]
                if proc.returncode != 0:
                    out = log.read_text()
                    log.unlink()
                    raise RuntimeError(
                        f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                        f"{out}")
                os.replace(log, build_log(name))
                # atomic: a concurrent loader sees all or nothing
                os.replace(tmp, so)
                ready[name] = time.perf_counter() - started
            time.sleep(0.05)
    finally:
        for proc, *_ in running.values():
            proc.kill()
            proc.wait()
    return ready


def load(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build(name)
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib

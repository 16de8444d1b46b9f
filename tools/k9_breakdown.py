"""Where K9's time goes: variants of ``csrc/dense_chains.cu`` made by text
substitution, each built beside the others and timed in turns on one CUDA
card, on the generic path's own samples.

    python -m tools.k9_breakdown [--only REGEX]

Run from the repository root on a machine with one CUDA card and nvcc. Each
variant is the kernel's source with a few lines replaced:

* ``as is``: the source unchanged;
* knock-outs, whose results are wrong and only their times read: ``no
  Taylor actions`` (the matrix-vector products of the actions route
  removed, its barriers kept), ``no commutator`` (the commutator's
  products removed), and both;
* design choices: ``one block an SM in f32`` (launch bounds that leave
  255 registers a thread), ``rows_product inlined``, ``index loop unrolled
  2`` / ``8`` (panel_fma), ``formation 8 rows at a time`` (FU), ``16 rows
  a thread in f32, chunks of 128`` (RM_F32, MAX_RC).

All variants are built with the package's nvcc flags into
``build/k9_breakdown/``, loaded through K9's own wrapper (the wrapper's
library swapped), and timed at 4096 and 256 trajectories of the Magnus-4
pair step in f32 (two rounds, the second in reverse order; CUDA events),
each line with the variant's ptxas registers and spills and the card's
name and power limit. ``--only`` builds and times the variants whose name
matches REGEX, beside ``as is``.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import statistics
import subprocess

import torch

import chip_smoke as cs
from vec_ode_tpu_torch.exp import dense_fast
from vec_ode_tpu_torch.exp import magnus as tmagnus
from vec_ode_tpu_torch.ops import _build, dense_chains

SRC = _build.CSRC / "dense_chains.cu"
OUT = _build.BUILD_DIR.parent / "k9_breakdown"
MATVEC = "              matvec<T, CLUSTER>(sm.W, p, own, r_lo, tin, tout, j);\n"
COMM = "          rows_product<T, true>(Mp, Mq, Mq, Mp, D, r_lo, r_hi, p, sm.ring,"
UNROLL = "#pragma unroll 4\n  for (int j = 0; j < jn; ++j) {"
VARIANTS = {
    "as is": [],
    "no Taylor actions": [(MATVEC, "")],
    "no commutator": [(COMM, "if (false) " + COMM.lstrip())],
    "no Taylor actions, no commutator": [(MATVEC, ""),
                                         (COMM, "if (false) " + COMM.lstrip())],
    "one block an SM in f32": [("return sizeof(T) == 4 ? 2 : 1;",
                                "return 1;")],
    "rows_product inlined": [("__device__ __noinline__ void rows_product(",
                              "__device__ void rows_product(")],
    "index loop unrolled 2": [(UNROLL, UNROLL.replace("4", "2", 1))],
    "index loop unrolled 8": [(UNROLL, UNROLL.replace("4", "8", 1))],
    "formation 8 rows at a time": [("constexpr int FU = 4;",
                                    "constexpr int FU = 8;")],
    "16 rows a thread in f32, chunks of 128": [
        ("constexpr int RM_F32 = 8, RM_F64 = 4;",
         "constexpr int RM_F32 = 16, RM_F64 = 4;"),
        ("constexpr int MAX_RC = 64;", "constexpr int MAX_RC = 128;")],
}


def build(names) -> dict:
    """Each variant's library, built together, with K9's argument types."""
    text, procs = SRC.read_text(), {}
    for i, name in enumerate(names):
        d = OUT / f"v{i}"
        d.mkdir(parents=True, exist_ok=True)
        for header in _build.CSRC.glob("*.cuh"):
            shutil.copy(header, d / header.name)
        src = text
        for old, new in VARIANTS[name]:
            if old not in src:
                raise RuntimeError(f"variant {name!r}: the source has no "
                                   f"{old!r}")
            src = src.replace(old, new)
        (d / "dense_chains.cu").write_text(src)
        log = open(d / "build.log", "w")
        procs[name] = (subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o",
             str(d / "libdense_chains.so"), str(d / "dense_chains.cu")],
            stdout=log, stderr=subprocess.STDOUT), d, log)
    libs = {}
    for name, (proc, d, log) in procs.items():
        rc = proc.wait()
        log.close()
        text = (d / "build.log").read_text()
        if rc != 0:
            raise RuntimeError(f"nvcc failed on variant {name!r}:\n{text}")
        regs = re.findall(r"Used (\d+) registers", text)
        spills = re.findall(r"(\d+) bytes spill stores", text)
        lib = ctypes.CDLL(str(d / "libdense_chains.so"))
        load = _build.load
        _build.load = lambda _n, lib=lib: lib   # the wrapper sets argtypes
        try:
            libs[name] = (dense_chains._kernel_lib.__wrapped__(),
                          f"registers {'/'.join(regs)}, spill stores "
                          f"{'/'.join(spills)} B")
        finally:
            _build.load = load
    return libs


def use(lib) -> None:
    dense_chains._kernel_lib = lambda lib=lib: lib
    dense_chains._kernel_plan.cache_clear()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", default=None,
                    help="time only the variants whose name matches")
    args = ap.parse_args()
    card = cs.device_phase()
    names = [n for n in VARIANTS if n == "as is" or args.only is None
             or re.search(args.only, n)]
    libs = build(names)
    saved = dense_chains._kernel_lib
    table = tmagnus.magnus4_table(pair=True)
    m, theta = dense_fast.ps_params(torch.float32)
    try:
        for B in (cs.GEN_TRAJ, cs.GEN_SMALL):
            node_ops, dt, xw = cs.model_dense_inputs(B)

            def step():
                return dense_chains.fused_dense_chain_apply(
                    table, node_ops, dt, xw, m=m, theta=theta,
                    max_squarings=cs.GEN_MAX_SQUARINGS)

            runs = {n: [] for n in libs}
            for order in (list(libs), list(libs)[::-1]):
                for n in order:
                    use(libs[n][0])
                    step()
                    torch.cuda.synchronize()
                    runs[n].append(cs.timed_ms(
                        step, reps=1, inner=10 if B > cs.GEN_SMALL else 50))
            for n, r in runs.items():
                print(f"[k9 breakdown] B={B} {n}: "
                      f"{statistics.median(r):.4f} ms "
                      f"{[round(v, 4) for v in r]}; {libs[n][1]} ({card})",
                      flush=True)
    finally:
        dense_chains._kernel_lib = saved
        dense_chains._kernel_plan.cache_clear()
    print(card, flush=True)


if __name__ == "__main__":
    main()

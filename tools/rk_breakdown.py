"""Where the RK step's time goes: variants of the RK step kernel K1
(``csrc/fused_rk_step.cu``) and of the loop kernel K2 (``csrc/
fused_loop.cu``, whose RK step K3 is) with their headers, made by text
substitution, this checkout's and (with ``--parent``) another
checkout's, each built beside the others and timed in turns on one CUDA
card on chip_smoke.py's inputs.

    python -m tools.rk_breakdown [--parent DIR] [--only REGEX]

Run from the repository root on a machine with one CUDA card and nvcc.
Each variant is the two kernel sources with a few lines of them or of
their headers replaced:

* this checkout: ``as is``; knock-outs, whose results are wrong and only
  their times read: ``no products`` (the stage products removed, the
  stage inputs, their publication and the barriers kept), ``no error
  measure`` (chain_err_measure removed), ``no drive`` (u = 1 for the
  cosine), ``no publish`` (the stage inputs never written to the term
  buffers), ``no stage values`` (K_i neither kept nor summed into the
  next stage input); design
  choices: ``operator streamed`` (the operator through the ring of panels
  where the plan keeps it resident, K1 and K2), ``K1 one block a tile``
  (the operator resident, but a block per tile, each loading it, where
  the plan runs one persistent block an SM), ``K1 2 rows a thread`` (K1's
  f32 microtile 2 x 4 with its six stages in registers);
* with ``--parent DIR`` (a checkout whose K1 and K2 have the same C entry
  points, e.g. ``git archive <commit> vec_ode_tpu_torch/csrc | tar -x -C
  build/parent``): ``parent as is``; ``parent, operator from shared
  memory`` (its per-stage loads of [M0^T | M1^T] read from a 16 KB panel
  of its stage slots instead of __ldg: wrong numbers, the same traffic
  from shared memory), ``parent, one barrier a stage`` (two of its three
  block barriers a stage removed), ``parent, K1 4 rows a thread`` (32-row
  tiles, 98 KB a block: two blocks an SM) and ``parent, K2 8 rows a
  block`` (MAX_ROWS 8 where it is 16).

All variants are built with the package's nvcc flags into
``build/rk_breakdown/``, loaded through the wrappers (their libraries
swapped) and timed in two rounds, the second in reverse order (CUDA
events): K1 per launch on one RKF45 step at 16 384 x 64c f32, K2 per
solve at the loop path (2048 x 64c, nine saves) and at 16 384 x 64c
without saves (f32, persistent, at most 5000 iterations), each line with
the variant's ptxas registers and spills and the card's name and power
limit. The knock-outs whose numbers are wrong are timed on K1 alone (a
loop on wrong numbers takes other steps). ``--only`` builds and times
the variants whose name matches REGEX.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import pathlib
import re
import statistics
import subprocess

import torch

import chip_smoke as cs
from vec_ode_tpu_torch import driver
from vec_ode_tpu_torch.ops import _build, fused_loop, fused_rk
from vec_ode_tpu_torch.ops.fused_loop import (RKStep, fused_loop_chunk,
                                              init_carries)

OUT = _build.BUILD_DIR.parent / "rk_breakdown"
K1, K2, RK, GEMM = "fused_rk_step.cu", "fused_loop.cu", "rk_step.cuh", \
    "gemm_tile.cuh"
MODULES = {"fused_rk_step": fused_rk, "fused_loop": fused_loop}
VARIANTS = {
    "as is": [],
    "no products": [
        (RK, "      if (th.active)\n        tile_fma_n<",
         "      if (false)\n        tile_fma_n<"),
        (RK, "          if (th.active)\n            tile_fma<",
         "          if (false)\n            tile_fma<")],
    "no error measure": [
        (RK, "  chain_err_measure(term, x, x_out, err_out, rows, D, en);\n", "")],
    "no drive": [
        (RK, "rk_drive(dr, t_rows[lr], dt_rows[lr], tab.c[i], i)", "T(1)")],
    "no publish": [
        (RK, "      publish(xin, cur ^ 1);\n", ""),
        (RK, "      publish(xin, 0);\n", "")],
    "no stage values": [
        (RK, "      stage_switch<KS>(i, tail);", "      ;")],
    "operator streamed": [
        (K1, "const bool res = smem_of(tile, true) <= max_smem;",
         "const bool res = false;"),
        (K2, "const bool r = loop_smem<T>(res, tile, D, true) <= (size_t)max_smem;",
         "const bool r = false;")],
    "K1 one block a tile": [
        (K1, "res ? (n_tiles < n_sm ? n_tiles : n_sm) : n_tiles", "n_tiles")],
    "K1 2 rows a thread": [
        (K1, "constexpr int RK_RM_REG = 4;", "constexpr int RK_RM_REG = 2;")],
}
# the knock-outs with wrong numbers: timed on K1 only
WRONG = ("no products", "no error measure", "no drive", "no publish",
         "no stage values", "parent, operator from shared memory",
         "parent, one barrier a stage")
PARENT_VARIANTS = {
    "parent as is": [],
    "parent, operator from shared memory": [
        (RK, "const T* mrow = mt + (size_t)j * 2 * D;",
         "const T* mrow = ks + (size_t)(j & 15) * 2 * D;"),
        (RK, "__ldg(mrow + col)", "mrow[col]"),
        (RK, "__ldg(mrow + D + col)", "mrow[D + col]")],
    "parent, one barrier a stage": [
        (RK, "    __syncthreads();  // every read of slot i is done\n", ""),
        (RK, "    __syncthreads();\n  }\n\n  // advance", "  }\n\n  // advance")],
    "parent, K1 4 rows a thread": [
        (K1, "constexpr int RT = 8;", "constexpr int RT = 4;")],
    "parent, K2 8 rows a block": [
        (K2, "constexpr int MAX_ROWS = 16;", "constexpr int MAX_ROWS = 8;")],
}


def build(variants: dict) -> dict:
    """Each variant's two libraries, built together (one nvcc per source):
    {name: ({module: lib}, ptxas)}; ``variants`` maps a name to (csrc
    directory, substitutions)."""
    procs = []
    dirs = {}
    for i, (name, (csrc, subs)) in enumerate(variants.items()):
        d = OUT / f"v{i}"
        d.mkdir(parents=True, exist_ok=True)
        files = {p.name: p.read_text() for p in csrc.glob("*.cu*")}
        for fname, old, new in subs:
            if old not in files[fname]:
                raise RuntimeError(f"variant {name!r}: {fname} has no "
                                   f"{old!r}")
            files[fname] = files[fname].replace(old, new)
        for fname, text in files.items():
            (d / fname).write_text(text)
        dirs[name] = d
    for name, d in dirs.items():
        for mod in MODULES:
            log = open(d / f"{mod}.log", "w")
            procs.append((name, mod, subprocess.Popen(
                [_build.nvcc(), *_build.NVCC_FLAGS, "-o",
                 str(d / f"lib{mod}.so"), str(d / f"{mod}.cu")],
                stdout=log, stderr=subprocess.STDOUT), log))
    try:
        for name, mod, proc, log in procs:
            rc = proc.wait()
            log.close()
            if rc != 0:
                raise RuntimeError(f"nvcc failed on variant {name!r}, {mod}:"
                                   "\n" + (dirs[name] / f"{mod}.log").read_text())
    finally:
        for *_, proc, log in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    libs = {}
    for name, d in dirs.items():
        loaded, ptxas = {}, []
        for mod, module in MODULES.items():
            lib = ctypes.CDLL(str(d / f"lib{mod}.so"))
            load = _build.load
            _build.load = lambda _n, lib=lib: lib  # the wrapper sets argtypes
            try:
                loaded[mod] = module._kernel_lib.__wrapped__()
            finally:
                _build.load = load
            ptxas += ptxas_lines((d / f"{mod}.log").read_text(),
                                 "K1" if mod == "fused_rk_step" else "K2")
        libs[name] = (loaded, ", ".join(ptxas))
    return libs


def ptxas_lines(text: str, kernel: str) -> list:
    """Registers and spill stores of each RK instantiation in ptxas's
    report: the type and the template's integer arguments."""
    out, inst, spill = [], None, "?"
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            inst, spill = m.group(1), "?"
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if inst and m:
            spill = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if inst and m:
            if "Chain" not in inst:
                ty = re.search(r"_kernelI([fd])", inst)
                args = ",".join(re.findall(r"Li(\d+)E", inst))
                out.append(f"{kernel} {'f32' if ty and ty.group(1) == 'f' else 'f64'}"
                           f"{' <' + args + '>' if args else ''} "
                           f"{m.group(1)} regs/{spill} B")
            inst = None
    return out


class Using:
    """Runs K1's and K2's wrappers on a variant's libraries."""

    def __init__(self, libs):
        self.libs = libs

    def __enter__(self):
        self.saved = {n: m._kernel_lib for n, m in MODULES.items()}
        for n, m in MODULES.items():
            m._kernel_lib = (lambda lib=self.libs[n]: lib)

    def __exit__(self, *exc):
        for n, m in MODULES.items():
            m._kernel_lib = self.saved[n]


def cases() -> dict:
    """{label: (fn, inner)}: K1 on one step, K2 on two solves."""
    sk, t, dt, xw = cs.step_inputs(cs.N_TRAJ, cs.DIM, torch.float32)
    out = {f"K1 one RKF45 step {cs.N_TRAJ}x{cs.DIM}c": (
        lambda: fused_rk.fused_rk_step(t, dt, xw, sk.M0, sk.M1, w=sk.w), 20)}
    for B, save_at in ((cs.LOOP_TRAJ, cs.SAVE_AT), (cs.N_TRAJ, None)):
        st, y0 = cs.main_inputs(B)
        grid = driver.make_grid(0.0, cs.TF, save_at, dtype=torch.float32,
                                device="cuda")
        step = RKStep(M0=st.M0, M1=st.M1, w=st.w)
        carries = init_carries(grid, torch.cat([y0.re, y0.im], 1), cs.H0)
        label = (f"K2 loop {B}x{cs.DIM}c, "
                 f"{len(save_at) if save_at else 'no'} saves")
        ctl = dataclasses.replace(cs.CTL, max_steps=5000)
        out[label] = (lambda c=carries, s=step: fused_loop_chunk(
            *c[:4], c[4].clone(), s, ctl=ctl), 1)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=pathlib.Path, default=None)
    ap.add_argument("--only", default=None,
                    help="build and time only the variants whose name "
                         "matches")
    args = ap.parse_args()
    card = cs.device_phase()
    variants = {n: (_build.CSRC, v) for n, v in VARIANTS.items()}
    if args.parent is not None:
        csrc = args.parent.resolve() / "vec_ode_tpu_torch" / "csrc"
        variants.update({n: (csrc, v) for n, v in PARENT_VARIANTS.items()})
    variants = {n: v for n, v in variants.items()
                if args.only is None or re.search(args.only, n)}
    libs = build(variants)
    for label, (fn, inner) in cases().items():
        names = [n for n in libs if label.startswith("K1") or n not in WRONG]
        runs = {n: [] for n in names}
        for order in (names, names[::-1]):
            for n in order:
                with Using(libs[n][0]):
                    fn()
                    torch.cuda.synchronize()
                    runs[n].append(cs.timed_ms(fn, reps=1, inner=inner))
        for n, r in runs.items():
            print(f"[rk breakdown] {label} {n}: {statistics.median(r):.4f} "
                  f"ms {[round(v, 4) for v in r]}; {libs[n][1]} ({card})",
                  flush=True)
    print(card, flush=True)


if __name__ == "__main__":
    main()

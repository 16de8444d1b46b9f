"""Where K6's time goes: variants of ``csrc/adjoint.cu`` and its header
``csrc/adjoint_row.cuh`` made by text substitution, this checkout's and
(with ``--parent``) another checkout's, each built beside the others and
timed in turns on one CUDA card, on the adaptive adjoint's own rows.

    python -m tools.k6_breakdown [--parent DIR] [--only REGEX]

Run from the repository root on a machine with one CUDA card and nvcc.
Each variant is a kernel source with a few lines replaced:

* this checkout: ``as is``; knock-outs, whose results are wrong and only
  their times read: ``no pairing`` (the pairing vectors and the inner
  products removed), ``no products`` (the basis actions removed, the
  ring's copies and barriers kept), ``no remote publish`` (on the
  cluster route each block writes a new term into its own buffer only),
  ``block barrier for the cluster's`` (each term's cluster barrier a
  block barrier); design choices: ``tiled at every batch`` (the cluster
  route never taken), ``basis ringed`` (the basis streamed where it
  would stay resident), ``cluster 2 rows a thread`` and ``cluster 4
  columns a thread`` (the cluster route's microtile);
* with ``--parent DIR`` (a checkout whose K6 has the same C entry point,
  e.g. ``git archive <commit> vec_ode_tpu_torch/csrc | tar -x -C
  build/parent``): ``parent as is`` and ``parent, one trajectory a
  block`` (its tile forced to 1: each trajectory streams the basis alone).

All variants are built with the package's nvcc flags into
``build/k6_breakdown/``, loaded through K6's own wrapper (its library
swapped), and timed at 256 and 4096 lanes as the adaptive Magnus-4
adjoint runs K6 (one replay of its recorded iterations in reverse, per
launch its mean; two rounds, the second in reverse order; CUDA events),
each line with the variant's ptxas registers, spills and stack frames and
the card's name and power limit. ``--only`` builds and times the variants
whose name matches REGEX, beside ``as is``.
"""

from __future__ import annotations

import argparse
import ctypes
import pathlib
import re
import statistics
import subprocess

import torch

import chip_smoke as cs
from vec_ode_tpu_torch.ops import _build
from vec_ode_tpu_torch.ops import adjoint as tadj

OUT = _build.BUILD_DIR.parent / "k6_breakdown"
ROW, ADJ = "adjoint_row.cuh", "adjoint.cu"
VARIANTS = {
    "as is": [],
    "no pairing": [(ROW, "      if (pairs) {\n", "      if (false) {\n"),
                   (ROW, "if (pairs && pair[q]) {", "if (false) {")],
    "no remote publish": [(ROW, "for (int blk = 0; blk < nblk; ++blk) {",
                           "for (int blk = rank; blk <= rank; ++blk) {")],
    "tiled at every batch": [(ADJ, "if ((B + L - 1) / L >= n_sm || n < 2)",
                              "if (true)")],
    "basis ringed": [(ROW, "resident = ring_resident<T>(D_, kp_, width);",
                      "resident = false;")],
    "cluster 2 rows a thread": [(ROW, "ROW_CLUSTER_RM = 1,",
                                 "ROW_CLUSTER_RM = 2,")],
    "cluster 4 columns a thread": [(ROW, "ROW_CLUSTER_CN = 2;",
                                    "ROW_CLUSTER_CN = 4;")],
    "no products": [(ROW, "          tile_fma_n<T, RM, CN, N>(tm, r2,",
                     "          if (false) tile_fma_n<T, RM, CN, N>(tm, r2,"),
                    (ROW, "            if (work)\n              tile_fma<",
                     "            if (false)\n              tile_fma<")],
    "block barrier for the cluster's": [(ROW, """    if constexpr (CLUSTER)
      cg::this_cluster().sync();
    else
      __syncthreads();""", "    __syncthreads();")],
}
PARENT_VARIANTS = {
    "parent as is": [],
    "parent, one trajectory a block": [(ROW, "int tile = ADJ_MAX_TILE;",
                                        "int tile = 1;")],
}


def load_k6(so: pathlib.Path):
    """A built library with the argument types of K6's entry points."""
    lib = ctypes.CDLL(str(so))
    vp, ci, cd = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    for t in ("f32", "f64"):
        fn = getattr(lib, f"vec_ode_adjoint_bwd_{t}")
        fn.restype = ci
        fn.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, ci, ci, ci,
                       ctypes.POINTER(cd), ci, cd, ci, vp]
    return lib


def build(variants: dict) -> dict:
    """Each variant's library, built together: {name: (lib, ptxas)};
    ``variants`` maps a name to (csrc directory, substitutions)."""
    procs = {}
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
        log = open(d / "build.log", "w")
        procs[name] = (subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(d / "libadjoint.so"),
             str(d / ADJ)], stdout=log, stderr=subprocess.STDOUT), d, log)
    libs = {}
    for name, (proc, d, log) in procs.items():
        rc = proc.wait()
        log.close()
        text = (d / "build.log").read_text()
        if rc != 0:
            raise RuntimeError(f"nvcc failed on variant {name!r}:\n{text}")
        # K6's instantiations: the entries of adjoint_row_kernel (this
        # checkout) or adjoint_bwd_kernel (the parent) in ptxas's report
        k6 = re.findall(r"entry function '\S*adjoint_(?:row|bwd)_kernelIf"
                        r"[^']*'.*?\n(?:.*\n)*?.*?(\d+) bytes stack frame, "
                        r"(\d+) bytes spill stores.*\n.*?Used (\d+) "
                        r"registers", text)
        libs[name] = (load_k6(d / "libadjoint.so"), "f32 " + ", ".join(
            f"{r} registers / {sp} B spilled / {fr} B stack"
            for fr, sp, r in k6))
    return libs


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=pathlib.Path, default=None)
    ap.add_argument("--only", default=None,
                    help="time only the variants whose name matches")
    args = ap.parse_args()
    card = cs.device_phase()
    variants = {n: (_build.CSRC, v) for n, v in VARIANTS.items()}
    if args.parent is not None:
        csrc = args.parent.resolve() / "vec_ode_tpu_torch" / "csrc"
        variants.update({n: (csrc, v) for n, v in PARENT_VARIANTS.items()})
    variants = {n: v for n, v in variants.items() if n == "as is"
                or args.only is None or re.search(args.only, n)}
    libs = build(variants)
    pc, y0, _, theta = cs.adjoint_inputs(torch.float32)
    basis = pc.basis_pair(torch.float32)
    ts = cs.recorded_times(basis, pc, y0, theta, order=4)
    saved = tadj._kernel_lib
    try:
        for B in (cs.ADJ_B, cs.ADJ_BIG):
            x, a, c_lane, _, (mt, ms, norms, m, th) = cs.k6_rows(B, ts, basis)
            run = cs.k6_replay(lambda c, xr, ar: tadj.adjoint_bwd(
                c, xr, ar, mt, ms, norms, m=m, theta=th, max_squarings=16),
                c_lane, x, a)
            n_it = c_lane.shape[0]
            runs = {n: [] for n in libs}
            for order in (list(libs), list(libs)[::-1]):
                for n in order:
                    tadj._kernel_lib = lambda lib=libs[n][0]: lib
                    run()
                    torch.cuda.synchronize()
                    runs[n].append(cs.timed_ms(run, reps=1) / n_it)
            for n, r in runs.items():
                print(f"[k6 breakdown] B={B} {n}: "
                      f"{statistics.median(r):.4f} ms per launch "
                      f"{[round(v, 4) for v in r]} ({n_it} launches a "
                      f"replay); {libs[n][1]} ({card})", flush=True)
    finally:
        tadj._kernel_lib = saved
    print(card, flush=True)


if __name__ == "__main__":
    main()

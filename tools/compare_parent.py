"""This checkout's RK step, loop, chain, dense chain, reverse-row and sweep
kernels (K1, K2 + K3, K4, K2 + K5, K9, K6, K7, K8) against another
checkout's, on one CUDA card, in turns, on chip_smoke.py's inputs.

    python -m tools.compare_parent PARENT_DIR [--only REGEX]

Run from the repository root on a machine with one CUDA card and nvcc.
PARENT_DIR holds another checkout of the repository whose
``vec_ode_tpu_torch/csrc/fused_rk_step.cu`` (K1), ``chain_expmv.cu`` (K4),
``fused_loop.cu`` (K2 with its RK step K3 and chain step K5),
``dense_chains.cu`` (K9) and ``adjoint.cu`` (K6, K7, K8) keep the same C
entry points, for example one unpacked by ``git archive <commit> | tar -x
-C build/parent`` (K1's and K2's RK entries take the declared drive, an
8-value array and a series pointer, in place of the cos frequency w: a
parent older than that change runs only the other cases, ``--only``). Its five libraries are built with this checkout's nvcc
flags into ``build/parent_kernels/``; this checkout's are built as usual.
Then each case runs on both, in turns (parent, this, this, parent; each
run the median of CUDA-event times), through this checkout's wrappers,
and prints, beside the card's name and power limit, both times and
whether the two gave the same bits, or, for K6 and the RK step, whose
redesigns change the rounding, whether they agree within the tolerance:

* K1 per launch: one RKF45 step at 16 384 x 64c in f32 and f64 on
  chip_smoke's step inputs; the largest state deviation and, per row,
  the error measures within ``chip_smoke.err_norm_limit`` of the
  parent's (f32: 1e-4 of each norm plus four times the plain f32 step's
  own distance from the f64 step, the rounding level of these inputs;
  f64: 1e-9 of each norm), the states within 1e-5 of their largest entry
  in f32 (bench.py's kernel-vs-XLA limit) and 1e-12 in f64;
* K2 + K3 per solve, f32: the RK loop at 16 384 x 64c without saves and
  at the loop path's 2048 with nine saves; the largest state and save
  deviation and the counters' agreement per trajectory, within
  chip_smoke's f32 loop check (rtol 1e-8 sits at f32 rounding, so a
  marginal accept may flip: counters within 2, states within 1e-4);

* K4 per launch, f32: the Magnus-4 pair, Magnus-6 and CFM-4 steps on
  DrivenDense(64) at 256 and 16 384 trajectories, the I/Q drive (K' = 6)
  and the eight-term drive (K' = 36) at 16 384;
* K2 + K5 per solve, f32: the Magnus-4, Magnus-6 and CFM-4 loop paths,
  the I/Q and the black-box DrivenDense (ChebForm) loops at 16 384, the
  Magnus-4 loop with chip_smoke's events and with dense output, and the
  16 384 fixed-step Landau-Zener sweeps;
* the adaptive Magnus-6 value-and-grad of PulseControl at 256 (K4 per
  forward iteration; K6 is this checkout's in both);
* K9 per launch, f32: the Magnus-4 pair step on the generic path's own
  samples at 4096 and 256 trajectories, and the generic path's solve at
  4096 (K9 per driver iteration);
* K6 per launch, f32: the adaptive Magnus-4 adjoint's own rows at 256 and
  4096 lanes (one replay of its recorded iterations in reverse, per
  launch its mean, as ``chip_smoke.adj_timing_at``), held within the f32
  tolerance (``chip_smoke.adj_tolerances``: states 1e-4, cbar 1e-3 of
  their largest entry);
* K7 and K8 per launch, f32: the fixed-step PulseControl adjoint's 256
  Magnus-4 rows (K' = 3) at 256 and 4096 trajectories, the same bits.

``--only`` runs the cases whose label matches REGEX. It exits non-zero if
any case's bits differ (K6, K1, K2 + K3: if any case disagrees).
"""

from __future__ import annotations

import argparse
import ctypes
import pathlib
import re
import statistics
import subprocess
import sys
import time

import torch

import chip_smoke as cs
from vec_ode_tpu_torch import diff as tdiff
from vec_ode_tpu_torch import driver
from vec_ode_tpu_torch.exp import MagnusModulated4
from vec_ode_tpu_torch.exp import dense_fast
from vec_ode_tpu_torch.exp import magnus as tmagnus
from vec_ode_tpu_torch.ops import (_build, dense_chains, expmv, fused_loop,
                                   fused_rk)
from vec_ode_tpu_torch.ops import adjoint as tadj
from vec_ode_tpu_torch.ops.cplx import Cplx
from vec_ode_tpu_torch.ops.fused_loop import (ChainStep, RKStep,
                                              fused_loop_chunk,
                                              fused_loop_integrate,
                                              init_carries)

MODULES = {"fused_rk_step": fused_rk, "chain_expmv": expmv,
           "fused_loop": fused_loop, "dense_chains": dense_chains}
OUT = _build.BUILD_DIR.parent / "parent_kernels"


def build_parent(parent: pathlib.Path) -> dict:
    """The parent's K4, K2, K9 and adjoint libraries, built together,
    loaded with the argument types this checkout's wrappers set."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in (*MODULES, "adjoint"):
        src = parent / "vec_ode_tpu_torch" / "csrc" / f"{name}.cu"
        so = OUT / f"lib{name}.so"
        log = open(OUT / f"{name}.log", "w")
        procs[name] = (subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(src)],
            stdout=log, stderr=subprocess.STDOUT), so, log)
    libs = {}
    for name, (proc, so, log) in procs.items():
        rc = proc.wait()
        log.close()
        if rc != 0:
            raise RuntimeError(f"nvcc failed on the parent's {name}.cu:\n"
                               + (OUT / f"{name}.log").read_text())
        lib = ctypes.CDLL(str(so))
        load = _build.load
        _build.load = lambda _n, lib=lib: lib   # the wrapper sets argtypes
        try:
            libs[name] = (tadj if name == "adjoint" else MODULES[name]
                          )._kernel_lib.__wrapped__()
        finally:
            _build.load = load
    return libs


class K6Using:
    """Runs K6's wrapper on the parent's library (None: this checkout's)."""

    def __init__(self, lib):
        self.lib = lib

    def __enter__(self):
        self.saved = tadj._kernel_lib
        if self.lib is not None:
            tadj._kernel_lib = lambda lib=self.lib: lib

    def __exit__(self, *exc):
        tadj._kernel_lib = self.saved


class Using:
    """Runs the wrappers on the given libraries (None: this checkout's)."""

    def __init__(self, libs):
        self.libs = libs

    def __enter__(self):
        self.saved = {n: m._kernel_lib for n, m in MODULES.items()}
        if self.libs is not None:
            for n, m in MODULES.items():
                m._kernel_lib = (lambda lib=self.libs[n]: lib)
        dense_chains._kernel_plan.cache_clear()

    def __exit__(self, *exc):
        for n, m in MODULES.items():
            m._kernel_lib = self.saved[n]
        dense_chains._kernel_plan.cache_clear()


def flat(out) -> list:
    """The tensors of a result, in order (Solutions, carries, tuples)."""
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, Cplx):
        return [out.re, out.im]
    if out is None or isinstance(out, (int, float, str)):
        return []
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in flat(o)]
    return [t for v in vars(out).values() for t in flat(v)]


def same_bits(a, b) -> bool:
    fa, fb = flat(a), flat(b)
    return len(fa) == len(fb) and all(
        x.shape == y.shape and torch.equal(torch.nan_to_num(x, 7.0),
                                           torch.nan_to_num(y, 7.0))
        and bool((torch.isnan(x) == torch.isnan(y)).all())
        for x, y in zip(fa, fb))


def k6_close(ref, new) -> tuple:
    """K6's results within the f32 tolerance (chip_smoke.adj_tolerances):
    the replay's states and one launch's x_n, a_n within 1e-4 of their
    largest entry, its cbar within 1e-3."""
    tol, cb_tol = cs.adj_tolerances(torch.float32)
    d = [cs.rel(a, b) for a, b in zip(new, ref)]
    ok = max(d[:-1]) <= tol and d[-1] <= cb_tol
    return ok, (f"max rel |diff| states {max(d[:-1]):.2e} (<= {tol:g}), "
                f"cbar {d[-1]:.2e} (<= {cb_tol:g})")


def k1_close(case):
    """A check of K1's results against the parent's (the module note)."""
    st, t, dt, xw = case

    def check(ref, new):
        (xp, ep), (xn, en) = ref, new
        lim, _ = cs.err_norm_limit(st, t, dt, xw, ep)
        x_tol = (1e-5 * max(float(xp.abs().max()), 1.0)
                 if xw.dtype == torch.float32 else 1e-12)
        dx = float((xn - xp).abs().max())
        de = float(((en - ep).abs() / lim).max())
        ok = dx <= x_tol and de <= 1.0
        return ok, (f"max|dx| {dx:.3e} (<= {x_tol:.1e}), max|derr|/limit "
                    f"{de:.3f} (<= 1)")
    return check


def k2_close(ref, new):
    """K2's final carries against the parent's: counters per trajectory
    within 2, states and saves within 1e-4 (the module note)."""
    cols = cs.INT_COLS
    dcount = (new[1][:, cols] - ref[1][:, cols]).abs().max(dim=1).values
    dx = float((new[2] - ref[2]).abs().max())
    ds = (float((new[3] - ref[3]).abs().max()) if ref[3].numel() else 0.0)
    ok = int(dcount.max()) <= 2 and dx <= 1e-4 and ds <= 1e-4
    return ok, (f"counters equal on {int((dcount == 0).sum())}/"
                f"{dcount.shape[0]} trajectories, max|dcount| "
                f"{int(dcount.max())} (<= 2), max|dx| {dx:.3e}, max|dsaves| "
                f"{ds:.3e} (<= 1e-4)")


def compare(label, fn, parent, card, inner=1, only=None, k6=False,
            per=1, check=None, adjoint=False) -> bool:
    """fn on the parent's libraries and on this checkout's (``adjoint``:
    the adjoint library's): the results' bits (``k6``: their agreement,
    k6_close; ``check(ref, new)``: its verdict and text), then the times
    in turns (parent, this, this, parent), divided by ``per`` (the
    launches a call makes, where a time per launch is read). A case whose
    label ``only`` does not match is skipped (True)."""
    if only is not None and not re.search(only, label):
        return True
    fn = fn()

    def using(who):
        if k6 or adjoint:
            return K6Using(parent["adjoint"] if who == "parent" else None)
        return Using(parent if who == "parent" else None)

    with using("parent"):
        ref = fn()
    with using("this"):
        new = fn()
    torch.cuda.synchronize()
    if k6:
        ok, text = k6_close(ref, new)
        text = f"within the f32 tolerance: {ok}, {text}"
    elif check is not None:
        ok, text = check(ref, new)
        text = f"within the tolerance: {ok}, {text}"
    else:
        ok = same_bits(ref, new)
        text = f"the same bits: {ok}"
    runs = {"parent": [], "this": []}
    for who in ("parent", "this", "this", "parent"):
        with using(who):
            runs[who].append(cs.timed_ms(fn, reps=1, inner=inner) / per)
    p, t = (statistics.median(runs[w]) for w in ("parent", "this"))
    print(f"[parent] {label}: parent {p:.4f} ms "
          f"{[round(v, 4) for v in runs['parent']]}, this {t:.4f} ms "
          f"{[round(v, 4) for v in runs['this']]}, this / parent "
          f"{t / p:.3f}; {text} ({card})", flush=True)
    return ok


def k9_case(B):
    """One Magnus-4 pair step on the generic path's samples."""
    table = tmagnus.magnus4_table(pair=True)
    node_ops, dt, xw = cs.model_dense_inputs(B)
    m, theta = dense_fast.ps_params(torch.float32)
    return lambda: dense_fast.fused_dense_chain_apply(
        table, node_ops, dt, xw, m=m, theta=theta,
        max_squarings=cs.GEN_MAX_SQUARINGS)


def generic_case():
    _, y0 = cs.main_inputs(cs.GEN_TRAJ)
    return lambda: cs.generic_solve(y0)


def k4_case(st, B):
    samples, dt, xw = cs.chain_inputs(st, B, torch.float32)
    mt, norms, m, theta = cs.chain_operands(st, torch.float32)
    kw = dict(recipe=st._recipe, C=st._chains, m=m, theta=theta,
              table=st._table)
    return lambda: expmv.fused_chain_apply(samples, dt, xw, mt, norms, **kw)


def loop_case(st, y0, **extra):
    mt, norms, m, theta = cs.chain_operands(st, torch.float32)
    step = ChainStep(mt=mt, norms=norms, form=st.op.form, recipe=st._recipe,
                     C=st._chains, m=m, theta=theta, table=st._table)
    x0 = torch.cat([y0.re, y0.im], 1)
    if not extra:
        grid = driver.make_grid(0.0, cs.TF, dtype=torch.float32,
                                device="cuda")
        carries = init_carries(grid, x0, cs.H0)
        return lambda: fused_loop_chunk(*carries, step, ctl=cs.MAG_CTL,
                                        adaptive=st._adaptive)
    full = driver.make_grid(0.0, cs.TF, cs.SAVE_AT, dtype=torch.float32,
                            device="cuda")
    if "dense" in extra:
        extra = dict(dense_times=full[1:-1])
    return lambda: fused_loop_integrate(full[[0, -1]], x0, cs.H0, step,
                                        ctl=cs.MAG_CTL, persistent=True,
                                        **extra)


def rk_loop_case(B, save_at):
    """The RK loop (RKF45, rtol 1e-8) on the main path's states, one
    persistent launch."""
    st, y0 = cs.main_inputs(B)
    grid = driver.make_grid(0.0, cs.TF, save_at, dtype=torch.float32,
                            device="cuda")
    step = RKStep(M0=st.M0, M1=st.M1, w=st.w)
    carries = init_carries(grid, torch.cat([y0.re, y0.im], 1), cs.H0)
    return lambda: fused_loop_chunk(*carries[:4], carries[4].clone(), step,
                                    ctl=cs.CTL)


def adaptive_times():
    """The recorded times of the adaptive Magnus-4 adjoint's forward at
    256x64c f32 (K4 per iteration), whose rows K6 replays."""
    pc, y0, _, theta = cs.adjoint_inputs(torch.float32)
    return cs.recorded_times(pc.basis_pair(torch.float32), pc, y0, theta,
                             order=4)


def k6_case(B, ts):
    """One replay of K6 over the adaptive rows at B lanes (its final x, a)
    and one launch on the replay's first row (x_n, a_n, cbar); the K6 in
    force (K6Using) is looked up at each call."""
    pc = cs.adjoint_inputs(torch.float32)[0]
    x, a, c_lane, _, (mt, ms, norms, m, th) = cs.k6_rows(
        B, ts, pc.basis_pair(torch.float32))

    def row(c, xr, ar):
        return tadj.adjoint_bwd(c, xr, ar, mt, ms, norms, m=m, theta=th,
                                max_squarings=16)

    replay = cs.k6_replay(row, c_lane, x, a)
    return lambda: (*replay(), *row(c_lane[-1], x, a))


def sweep_case(name, B):
    """K7 (y) or K8 (a0, cbar) on the fixed-step PulseControl adjoint's
    f32 rows at B trajectories; the library in force (K6Using) is looked
    up at each call."""
    pc, y0, _, theta = cs.adjoint_inputs(torch.float32, B)
    core, c_all = cs.model_rows(pc, theta, cs.ADJ_STEPS, torch.float32)
    x, a = torch.cat([y0.re, y0.im], -1), cs.cotangents(B, torch.float32)
    mt, ms, norms, m, th = core.operands(x)
    kw = dict(m=m, theta=th, max_squarings=16)
    if name == "K7":
        return lambda: tadj.adjoint_sweep_fwd(c_all, x, mt, norms, **kw)
    return lambda: tadj.adjoint_sweep_bwd(c_all, x, a, mt, ms, norms, **kw)


def value_and_grad_case():
    pc, y0, tg, theta = cs.adjoint_inputs(torch.float32)
    basis = pc.basis_pair(torch.float32)

    def run():
        th = theta.clone().requires_grad_(True)
        yr, yi = (v.clone().requires_grad_(True) for v in (y0.re, y0.im))
        yf = tdiff.adjoint_solve_adaptive(
            basis, pc.coeff_fn, th, Cplx(yr, yi), 0.0, 1.0, ctl=cs.ADJ_CTL,
            h0=cs.ADJ_H0, order=6)
        value = 1.0 - torch.sum(pc.fidelity(yf, tg))
        return (value.detach(), *torch.autograd.grad(value, (th, yr, yi)))

    return run


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent", type=pathlib.Path)
    ap.add_argument("--only", default=None,
                    help="run only the cases whose label matches")
    args = ap.parse_args()
    t0 = time.perf_counter()
    card = cs.device_phase()
    _build.build(*MODULES, "adjoint")
    parent = build_parent(args.parent.resolve())
    print(f"[parent] built {sorted(parent)} from {args.parent} and this "
          f"checkout's in {time.perf_counter() - t0:.1f} s", flush=True)
    ok, only = [], args.only
    for dtype in (torch.float32, torch.float64):
        case = cs.step_inputs(cs.N_TRAJ, cs.DIM, dtype)
        st, t, dt, xw = case
        ok.append(compare(
            f"K1 one RKF45 step {cs.N_TRAJ}x{cs.DIM}c {str(dtype)[6:]}",
            lambda st=st, t=t, dt=dt, xw=xw: (
                lambda: fused_rk.fused_rk_step(t, dt, xw, st.M0, st.M1,
                                               w=st.w)),
            parent, card, inner=20, only=only, check=k1_close(case)))
    for B, save_at in ((cs.N_TRAJ, None), (cs.LOOP_TRAJ, cs.SAVE_AT)):
        ok.append(compare(
            f"K2 + K3 RK loop {B}x{cs.DIM}c f32, "
            f"{len(save_at) if save_at else 'no'} saves",
            lambda B=B, save_at=save_at: rk_loop_case(B, save_at), parent,
            card, only=only, check=k2_close))
    for kind in ("magnus4", "magnus6", "cfm4"):
        st, _ = cs.r_inputs(kind)
        for B in (cs.REC_B, cs.N_TRAJ):
            ok.append(compare(f"K4 {cs.LABELS[kind]} {B}x{cs.DIM}c f32",
                              lambda st=st, B=B: k4_case(st, B), parent,
                              card, inner=20 if B > cs.REC_B else 100,
                              only=only))
    ok.append(compare("K4 I/Q Magnus-4 pair (K' = 6) 16384x64c f32",
                      lambda: k4_case(MagnusModulated4(
                          cs.iq_op(fit_cols=False)), cs.N_TRAJ), parent,
                      card, inner=20, only=only))
    ok.append(compare("K4 eight-term Magnus-4 pair (K' = 36) 16384x64c f32",
                      lambda: k4_case(MagnusModulated4(
                          cs.multi_op(8, torch.float32)), cs.N_TRAJ),
                      parent, card, inner=2, only=only))
    y0 = cs.unit_states(cs.N_TRAJ, cs.DIM, torch.float32, 42)
    for kind in ("magnus4", "magnus6", "cfm4"):
        ok.append(compare(f"K2 + K5 {cs.LABELS[kind]} loop {cs.N_TRAJ}x"
                          f"{cs.DIM}c f32",
                          lambda kind=kind: loop_case(*cs.r_inputs(kind)),
                          parent, card, only=only))
    ok.append(compare("K2 + K5 I/Q loop 16384x64c f32",
                      lambda: loop_case(MagnusModulated4(cs.iq_op()), y0),
                      parent, card, only=only))
    ok.append(compare("K2 + K5 black-box DrivenDense (ChebForm) loop "
                      "16384x64c f32",
                      lambda: loop_case(MagnusModulated4(cs.auto_drive_op()),
                                        y0), parent, card, only=only))
    spec = cs.drive_events().kernel_spec(cs.DIM, 2)
    ok.append(compare("K2 + K5 Magnus-4 loop with events 16384x64c f32",
                      lambda: loop_case(*cs.r_inputs("magnus4"),
                                        events=spec), parent, card,
                      only=only))
    ok.append(compare("K2 + K5 Magnus-4 loop with dense output 16384x64c "
                      "f32", lambda: loop_case(*cs.r_inputs("magnus4"),
                                               dense=True), parent, card,
                      only=only))

    def lz():
        st_lz, y_lz = cs.lz_inputs()
        return lambda: cs.lz_solve(st_lz, y_lz)

    ok.append(compare(f"K2 + K5 Landau-Zener {cs.N_TRAJ} sweeps, fixed "
                      "steps", lz, parent, card, only=only))
    ok.append(compare("adaptive Magnus-6 value-and-grad 256x64c f32 (K4 + "
                      "K6)", value_and_grad_case, parent, card, only=only))
    for B in (cs.GEN_TRAJ, cs.GEN_SMALL):
        ok.append(compare(f"K9 Magnus-4 pair {B}x{cs.DIM}c f32",
                          lambda B=B: k9_case(B), parent, card,
                          inner=10 if B > cs.GEN_SMALL else 50,
                          only=only))
    ok.append(compare(f"K9 generic path solve {cs.GEN_TRAJ}x{cs.DIM}c f32 "
                      "(K9 per iteration)", generic_case, parent, card,
                      only=only))
    ts = None
    for B in (cs.ADJ_B, cs.ADJ_BIG):
        if only is not None and not re.search(only, f"K6 {B}"):
            continue
        if ts is None:
            ts = adaptive_times()
        ok.append(compare(f"K6 {B}x{cs.DIM}c f32, the adaptive Magnus-4 "
                          f"adjoint's rows (a replay of {ts.shape[0] - 1} "
                          "launches and one more; ms per launch)",
                          lambda B=B: k6_case(B, ts), parent, card,
                          only=only, k6=True, per=ts.shape[0]))
    for name in ("K7", "K8"):
        for B in (cs.ADJ_B, cs.ADJ_BIG):
            ok.append(compare(f"{name} {B}x{cs.DIM}c f32, PulseControl's "
                              f"{cs.ADJ_STEPS} fixed-step rows (K' = 3)",
                              lambda name=name, B=B: sweep_case(name, B),
                              parent, card, only=only, adjoint=True))
    print(f"[parent] {sum(ok)}/{len(ok)} cases with the parent's bits "
          f"(K6, K1, K2 + K3: within the tolerance), "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    print(card, flush=True)
    if not all(ok):
        sys.exit(1)


if __name__ == "__main__":
    main()

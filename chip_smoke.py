"""GPU smoke run of the PyTorch / CUDA port (vec_ode_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (nvcc). It builds the port's
kernels from the sources in this checkout (one nvcc per source, started
together), holds each kernel against its plain torch version on the card,
drives the port's paths once at full width through
``vec_ode_tpu_torch.parallel.ensemble_solve`` and checks them:

* the RK main path: adaptive RKF45 over 16 384 trajectories of a 64-dim
  complex driven system, a driver iteration per step and one launch of
  the step kernel ``fused_rk_step`` (K1) in each;
* the RK loop path: the same model and controller over 2 048
  trajectories with nine interior saves, the whole adaptive loop in one
  launch of ``fused_loop`` (K2 with its RK step K3);
* the Magnus loop path, this slice's main path: adaptive Magnus-4
  (``exp.MagnusModulated4``) on the same model over 16 384 trajectories,
  the whole loop in one launch of ``fused_loop`` with its chain step K5;
* the Magnus per-step path: the same solve on an operator without a
  declared coefficient form, a launch of the chain kernel
  ``fused_chain_apply`` (K4) per driver iteration;
* the Landau-Zener path: 16 384 fixed-step exponential-midpoint sweeps of
  a 2-level avoided crossing in the loop kernel's fixed-step mode, held
  against the closed-form transition probability;
* the generic dense path: adaptive Magnus-4 (``exp.Magnus4`` over
  ``DenseCplxSplit``) with a black-box operator callback over 4 096
  trajectories of the same model, every trajectory with its own dense
  operator samples, a launch of the dense chain kernel
  ``fused_dense_chain_apply`` (K9) per driver iteration; the same solve
  with each step by a stacked batched ``expm`` (the library reference) and
  against the Magnus loop path.

Then it times the paths and each kernel against its plain version, its
bound and, for K4 and K9, a library yardstick. Every phase raises on failure, so
any failure exits non-zero; without a CUDA card it exits non-zero before
any result.

Output: progress lines, then the card's name and power limit as
nvidia-smi reports them, then one JSON line describing each kernel, and
last one JSON line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import re
import statistics
import subprocess
import time

import numpy as np
import torch

from vec_ode_tpu_torch import diff as tdiff
from vec_ode_tpu_torch import (DONE, DOPRI5, ERR_MAX_STEPS, ERR_STALLED,
                               RKF45, StepControl, driver, lc)
from vec_ode_tpu_torch import tableaus as ttab
from vec_ode_tpu_torch import exp as texp
from vec_ode_tpu_torch.exp import MagnusModulated4, MidpointModulated
from vec_ode_tpu_torch.exp import cfm as tcfm
from vec_ode_tpu_torch.exp import dense_fast
from vec_ode_tpu_torch.exp import magnus as tmagnus
from vec_ode_tpu_torch.exp import split_solvers as tsplit
from vec_ode_tpu_torch.exp.modulated import _taylor_params
from vec_ode_tpu_torch.models import DrivenDense, LandauZener, PulseControl
from vec_ode_tpu_torch.ops import adjoint as tadj
from vec_ode_tpu_torch.ops import (_build, dense_chains, expmv, fused_loop,
                                   fused_rk)
from vec_ode_tpu_torch.ops.cplx import Cplx, embed, from_complex
from vec_ode_tpu_torch.ops.dense_chains import (chain_products,
                                                fused_dense_chain_apply,
                                                torch_dense_chains)
from vec_ode_tpu_torch.ops.expmv import (fused_chain_apply, node_times,
                                         torch_chain_step)
from vec_ode_tpu_torch.ops.fused_loop import (ChainStep, RKStep,
                                              fused_loop_chunk,
                                              fused_loop_integrate,
                                              init_carries, torch_fused_loop)
from vec_ode_tpu_torch.ops.fused_rk import (FusedModulatedLinearRK,
                                            fused_rk_step, torch_rk_step)
from vec_ode_tpu_torch.parallel import ensemble_solve

N_TRAJ, DIM = 16384, 64
LOOP_TRAJ = 2048             # fused_loop.LOOP_MAX_BATCH
SAVE_AT = tuple(round(0.1 * k, 10) for k in range(1, 10))
CTL = StepControl(rtol=1e-8, min_dt=1e-6, max_dt=0.25)
H0, TF = 1e-3, 1.0
# K1-K9: the CUDA source of each and the TPU kernel it replaces. K3 and K5
# are the steps inside K2 (device functions compiled into fused_loop.cu);
# their rows carry the loop kernel's numbers on the path each step drives
KERNELS = {
    "fused_rk_step": ("vec_ode_tpu_torch/csrc/fused_rk_step.cu",
                      "vec_ode_tpu/ops/pallas_rk.py:134"),
    "fused_loop": ("vec_ode_tpu_torch/csrc/fused_loop.cu",
                   "vec_ode_tpu/ops/pallas_loop.py:1135"),
    "rk_step_tile": ("vec_ode_tpu_torch/csrc/rk_step.cuh",
                     "vec_ode_tpu/ops/pallas_loop.py:890"),
    "fused_chain_apply": ("vec_ode_tpu_torch/csrc/chain_expmv.cu",
                          "vec_ode_tpu/ops/pallas_expmv.py:172"),
    "chain_step_tile": ("vec_ode_tpu_torch/csrc/chain_step.cuh",
                        "vec_ode_tpu/ops/pallas_loop.py:680"),
    "fused_dense_chain_apply": ("vec_ode_tpu_torch/csrc/dense_chains.cu",
                                "vec_ode_tpu/ops/pallas_dense.py:121"),
    "adjoint_bwd": ("vec_ode_tpu_torch/csrc/adjoint.cu",
                    "vec_ode_tpu/ops/pallas_expmv.py:420"),
    "adjoint_sweep_fwd": ("vec_ode_tpu_torch/csrc/adjoint.cu",
                          "vec_ode_tpu/ops/pallas_expmv.py:507"),
    "adjoint_sweep_bwd": ("vec_ode_tpu_torch/csrc/adjoint.cu",
                          "vec_ode_tpu/ops/pallas_expmv.py:582"),
}
# the card's published peaks (H100 SXM, dense, at 700 W): FP32 outside
# the tensor cores (no TF32 may enter an error estimate), and HBM
FP32_FLOP_S, HBM_BYTE_S = 67e12, 3.35e12


def device_phase() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs only "
                         "on a GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    # plain fp32 products everywhere: TF32 would drown the error estimate
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[device] {torch.cuda.get_device_name(0)}; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    return card


def ptxas_summary(name: str) -> str:
    """Registers and spill stores of each instantiation (f32, f64; the RK or
    chain step and its KP) of the kernel, from ptxas's report in its build
    log."""
    log = _build.build_log(name)
    if not log.exists():   # a library built before logs were kept
        return "no build log"
    out, inst = [], None
    for line in log.read_text().splitlines():
        m = re.search(r"Compiling entry function "
                      r"'\S*?([a-z_]+?)_kernelI([fd])(\S*)'", line)
        if m:
            inst, spill = {"f": "f32", "d": "f64"}[m.group(2)], "?"
            if name == "adjoint":  # three kernels, narrow and wide blocks
                inst = f"{m.group(1)} {inst}" + (" wide" if "Lb1E" in
                                                 m.group(3) else "")
            kp = re.match(r"(?:\w*ChainLoopStepI[fd])?Li(\d+)E", m.group(3))
            if "RKLoopStep" in m.group(3):
                inst += " rk"
            elif kp:
                inst += f" KP={kp.group(1)}"
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if inst and m:
            spill = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if inst and m:
            out.append(f"{inst} {m.group(1)} registers, {spill} B spilled")
            inst = None
    return "; ".join(out)


def build_phase(card: str) -> None:
    cached = {n: _build.library_path(n).exists() for n in _build.SOURCES}
    ready = _build.build(*_build.SOURCES)
    fused_rk._kernel_lib()
    fused_loop._kernel_lib()
    expmv._kernel_lib()
    dense_chains._kernel_lib()
    tadj._kernel_lib()
    for name in _build.SOURCES:
        print(f"[build] {name} {'(cached) ' if cached[name] else ''}"
              f"{ready[name]:.2f} s, nvcc per source started together; "
              f"ptxas: {ptxas_summary(name)} ({card})", flush=True)


def bound(flop: float, nbytes: float):
    """The least time the card could take (ms) and what bounds it."""
    ops_ms, bytes_ms = flop / FP32_FLOP_S * 1e3, nbytes / HBM_BYTE_S * 1e3
    return (max(ops_ms, bytes_ms),
            "operations" if ops_ms >= bytes_ms else "bytes")


def step_inputs(B, d, dtype, seed=7, dt_range=(1e-3, 5e-2)):
    """The step-parity inputs of bench.py's on-device check: states of
    scale 0.1, t in [0, 1), dt in [1e-3, 5e-2) unless ``dt_range`` says
    otherwise."""
    model = DrivenDense.make(d=d, seed=0)
    st = FusedModulatedLinearRK.from_driven_dense(model, dtype, device="cuda")
    rng = np.random.default_rng(seed)
    xw = torch.as_tensor(rng.standard_normal((B, 2 * d)) * 0.1, dtype=dtype,
                         device="cuda")
    t = torch.as_tensor(rng.uniform(0, 1, B), dtype=dtype, device="cuda")
    dt = torch.as_tensor(rng.uniform(*dt_range, B), dtype=dtype,
                         device="cuda")
    return st, t, dt, xw


def plain_step(st, t, dt, xw, tab=RKF45, advance_lower=True, wnorm=None):
    return torch_rk_step(t, dt, xw, st.M0, st.M1,
                         u_fn=lambda ti: torch.cos(st.w * ti), tab=tab,
                         advance_lower=advance_lower, wnorm=wnorm)


def err_norm_limit(st, t, dt, xw, ep, tab=RKF45, advance_lower=True,
                   wnorm=None):
    """Per-row limit on |err_kernel - err_plain| for the plain step's error
    norms ``ep``; returns (limit (B,), floor).

    f64: 1e-9 of each row's norm plus 1e-18; only the summation order
    differs. f32: the embedded error dt * sum_j (b_j - b_err_j) K_j is a
    cancelling sum whose last digits follow the summation order, and for
    short steps the norm is mostly rounding. So the limit is 1e-4 of each
    row's norm plus a floor: four times the plain f32 step's own largest
    deviation from the f64 step on the same inputs, the f32 rounding level
    of these inputs. A kernel returning err = 0, or a norm 10% off, fails
    on every row whose norm stands well above that floor."""
    if ep.dtype == torch.float64:
        return 1e-9 * ep.abs() + 1e-18, 1e-18
    _, e64 = torch_rk_step(*(a.double() for a in (t, dt, xw, st.M0, st.M1)),
                           u_fn=lambda ti: torch.cos(st.w * ti), tab=tab,
                           advance_lower=advance_lower, wnorm=wnorm)
    floor = 4 * float((ep.double() - e64).abs().max())
    return (1e-4 * ep.abs() + floor).to(ep.dtype), floor


def weighted(kind: str, d: int, weights: bool = True):
    """A declared WeightedNorm's kernel parts over the widened layout, with
    a ramp of weights in [0.5, 2] or none."""
    w = tuple(np.linspace(0.5, 2.0, d)) if weights else None
    return lc.WeightedNorm(kind, w).kernel_parts(d, 2)


def compare_step(B, d, dtype, tab=RKF45, advance_lower=True,
                 dt_range=(1e-3, 5e-2), wnorm=None, label=""):
    """Kernel vs plain step on the card; returns (max |dx|, rows on which
    the error-norm check would catch a norm 10% off). The f32 state limit
    is bench.py's on-device limit; f64 differs only by summation order."""
    st, t, dt, xw = step_inputs(B, d, dtype, dt_range=dt_range)
    xk, ek = fused_rk_step(t, dt, xw, st.M0, st.M1, w=st.w, tab=tab,
                           advance_lower=advance_lower, wnorm=wnorm)
    xp, ep = plain_step(st, t, dt, xw, tab, advance_lower, wnorm)
    e_lim, floor = err_norm_limit(st, t, dt, xw, ep, tab, advance_lower,
                                  wnorm)
    torch.cuda.synchronize()
    dx = float((xk - xp).abs().max())
    de = (ek - ep).abs()
    x_lim = 1e-5 * max(float(xp.abs().max()), 1.0) if dtype == torch.float32 \
        else 1e-12
    sensitive = int((0.1 * ep > e_lim).sum())
    ok = (dx <= x_lim and bool((de <= e_lim).all())
          and bool(torch.isfinite(xk).all()) and bool(torch.isfinite(ek).all()))
    print(f"[step] {tab.name} {str(dtype)[6:]} B={B} d={d}{label} dt in "
          f"[{dt_range[0]:g}, {dt_range[1]:g}) advance_lower={advance_lower}: "
          f"max|dx|={dx:.3e} (<= {x_lim:.1e}); max|derr|={float(de.max()):.3e}"
          f", max|derr|/limit={float((de / e_lim).max()):.3f} (<= 1; limit "
          f"1e-4*|err| + {floor:.2e}, err up to {float(ep.max()):.2e}); a "
          f"norm 10% off fails on {sensitive}/{B} rows; "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"kernel disagrees with the plain step: "
                             f"{tab.name} {dtype} B={B} d={d}{label}")
    return dx, sensitive


def step_phase() -> float:
    compare_step(1024, DIM, torch.float32)
    compare_step(1024, DIM, torch.float32, tab=DOPRI5)
    compare_step(1024, DIM, torch.float32, advance_lower=False)
    compare_step(1024, DIM, torch.float64)
    compare_step(1024, DIM, torch.float64, tab=DOPRI5)
    compare_step(1000, DIM, torch.float32)       # ragged last tile
    compare_step(1000, 5, torch.float32)         # odd width
    compare_step(1000, 5, torch.float64, tab=DOPRI5)
    # the main path's shape; long steps, where every row's f32 error norm
    # stands above rounding, hold the norm tightly on every row
    _, sensitive = compare_step(N_TRAJ, DIM, torch.float32,
                                dt_range=(0.15, 0.25))
    if sensitive != N_TRAJ:
        raise AssertionError(
            f"the long-step check holds only {sensitive}/{N_TRAJ} error "
            f"norms to 10%")
    return compare_step(N_TRAJ, DIM, torch.float32)[0]


def norm_phase() -> None:
    """K1 with a declared WeightedNorm (weight row, l2 or max, post)."""
    for dtype in (torch.float32, torch.float64):
        for kind, weights in (("l2", True), ("max", True), ("rms", False)):
            compare_step(1000, DIM, dtype, wnorm=weighted(kind, DIM, weights),
                         label=f" {kind}{' weighted' if weights else ''}")
    compare_step(1000, 5, torch.float32, wnorm=weighted("max", 5),
                 label=" max weighted")
    _, sensitive = compare_step(N_TRAJ, DIM, torch.float32,
                                dt_range=(0.15, 0.25),
                                wnorm=weighted("l2", DIM),
                                label=" l2 weighted")
    if sensitive != N_TRAJ:
        raise AssertionError(
            f"the weighted long-step check holds only {sensitive}/{N_TRAJ} "
            "error norms to 10%")


# The kernel-vs-twin cases of the loop kernel (the CPU tests hold the twin
# to the JAX loop kernel on the same list). max_steps bounds every case.
LOOP_BASE = dict(rtol=1e-8, min_dt=1e-6, max_dt=0.25, max_steps=3000)
LOOP_CASES = {
    "plain": {},
    "save_grid": dict(grid=(0.0, 0.075, 0.15, 0.225, 0.3)),
    "pi": dict(ctl=dict(pi=True)),
    "scaled_error": dict(ctl=dict(scaled_error=True, rtol=1e-6, atol=1e-9)),
    "strict_end_test": dict(ctl=dict(strict_end_test=True),
                            grid=(0.0, 0.1, 0.3)),
    "plain_time": dict(ctl=dict(time_compensated=False),
                       grid=(0.0, 0.1, 0.3)),
    "weighted_l2": dict(norm=("l2", True)),
    "weighted_max": dict(norm=("max", False)),
    "dopri5": dict(tab="dopri5"),
    "advance_higher": dict(advance_lower=False),
    "h0_per_row": dict(h0="per_row"),
    "max_steps": dict(ctl=dict(max_steps=6)),
    "stalled": dict(ctl=dict(max_reject_streak=2, rtol=1e-12), h0=0.2),
    # the loop path's grid, t in [0, 1] with nine interior saves
    "loop_path": dict(grid=(0.0, *SAVE_AT, TF)),
}
LOOP_STATUS = {"max_steps": ERR_MAX_STEPS, "stalled": ERR_STALLED}
# ist columns compared: all but the event column, which follows the tiling
# (a row that stopped before its tile's last iteration reads EVT_NONE)
INT_COLS = [0, 1, 3, 4, 5, 6, 7]


def unit_states(B, d, dtype, seed):
    rng = np.random.default_rng(seed)
    psi = rng.standard_normal((B, d)) + 1j * rng.standard_normal((B, d))
    psi /= np.linalg.norm(psi, axis=-1, keepdims=True)
    return from_complex(psi, dtype, device="cuda")


def loop_case(name, B, d, dtype, seed=11):
    """(carries, step, ctl, expected status) of a LOOP_CASES entry: the
    model DrivenDense(d, seed 0), unit states, t in [0, 0.3]."""
    case = LOOP_CASES[name]
    ctl = StepControl(**{**LOOP_BASE, **case.get("ctl", {})})
    st = FusedModulatedLinearRK.from_driven_dense(
        DrivenDense.make(d=d, seed=0), dtype, device="cuda")
    y0 = unit_states(B, d, dtype, seed)
    h0 = case.get("h0", H0)
    if h0 == "per_row":
        h0 = 10.0 ** np.random.default_rng(seed).uniform(-4, -1, B)
    norm = case.get("norm")
    step = RKStep(M0=st.M0, M1=st.M1, w=st.w,
                  tableau=ttab.TABLEAUS[case.get("tab", "rkf45")],
                  advance_lower=case.get("advance_lower", True),
                  scaled=(ctl.atol, ctl.rtol) if ctl.scaled_error else None,
                  wnorm=None if norm is None else weighted(norm[0], d,
                                                            norm[1]))
    grid = torch.tensor(case.get("grid", (0.0, 0.3)), dtype=torch.float64)
    carries = init_carries(grid, torch.cat([y0.re, y0.im], 1),
                           torch.as_tensor(h0, dtype=torch.float64))
    return carries, step, ctl, LOOP_STATUS.get(name, DONE)


def run_loop_pair(name, B, d, dtype, chunk=None):
    """The loop kernel and its twin on the same carries; returns both
    final carries (fs, ist, x, saves) and the expected status."""
    carries, step, ctl, status = loop_case(name, B, d, dtype)
    saves_k = carries[4].clone()
    got = fused_loop_chunk(*carries[:4], saves_k, step, ctl=ctl, chunk=chunk)
    while chunk is not None and bool((got[1][:, 1] == 0).any()):
        got = fused_loop_chunk(carries[0], *got, step, ctl=ctl, chunk=chunk)
    want = torch_fused_loop(*carries, step, ctl=ctl)
    torch.cuda.synchronize()
    return got, want, status


def check_loop_pair(name, B, d, dtype) -> float:
    """K2 against torch_fused_loop. f64: status and counters equal per
    trajectory, states and saves within 1e-10 of the states' scale (only
    the summation order differs). f32 (rtol 1e-8 sits at f32 rounding, so
    marginal accepts may flip): counters within 2, states within 1e-4, the
    main path's bounds. Returns max |dx|."""
    got, want, status = run_loop_pair(name, B, d, dtype)
    dcount = int((got[1][:, INT_COLS] - want[1][:, INT_COLS]).abs().max())
    scale = max(float(want[2].abs().max()), 1.0)
    dx = float((got[2] - want[2]).abs().max())
    ds = float((got[3] - want[3]).abs().max()) if got[3].numel() else 0.0
    n_status = int((got[1][:, 1] == status).sum())
    f64 = dtype == torch.float64
    lim_c, lim_x = (0, 1e-10 * scale) if f64 else (2, 1e-4)
    ok = (dcount <= lim_c and dx <= lim_x and ds <= lim_x and n_status == B
          and bool(torch.isfinite(got[2]).all()))
    print(f"[loop] {name} {str(dtype)[6:]} B={B} d={d}: status {status} on "
          f"{n_status}/{B}, max|dcount|={dcount} (<= {lim_c}), "
          f"max|dx|={dx:.3e}, max|dsaves|={ds:.3e} (<= {lim_x:.1e}), "
          f"iterations up to {int(got[1][:, 5].max())}; "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"loop kernel disagrees with its twin: {name} "
                             f"{dtype} B={B} d={d}")
    return dx


def check_persistent_is_chunked(name, B, d, dtype) -> None:
    p, _, _ = run_loop_pair(name, B, d, dtype)
    c, _, _ = run_loop_pair(name, B, d, dtype, chunk=5)
    same = [bool(torch.equal(a, b)) for a, b in zip(p, c)]
    print(f"[loop] persistent vs chunks of 5, {name} {str(dtype)[6:]} B={B} "
          f"d={d}: fs/ist/x/saves bitwise equal {same}", flush=True)
    if not all(same):
        raise AssertionError("persistent and chunked loop kernels differ")


def loop_kernel_phase() -> float:
    for d in (DIM, 5):
        for name in list(LOOP_CASES)[:-1]:
            check_loop_pair(name, 1000, d, torch.float64)   # ragged tiles
    for name in ("plain", "save_grid", "pi"):
        check_loop_pair(name, LOOP_TRAJ, DIM, torch.float32)
    check_persistent_is_chunked("save_grid", 1000, DIM, torch.float64)
    check_persistent_is_chunked("pi", LOOP_TRAJ, DIM, torch.float32)
    return check_loop_pair("loop_path", LOOP_TRAJ, DIM, torch.float32)


def main_inputs(n: int = N_TRAJ):
    model = DrivenDense.make(d=DIM, seed=0)
    rng = np.random.default_rng(42)
    psi0 = (rng.standard_normal((n, DIM))
            + 1j * rng.standard_normal((n, DIM)))
    psi0 /= np.linalg.norm(psi0, axis=-1, keepdims=True)
    y0 = from_complex(psi0, torch.float32, device="cuda")
    st = FusedModulatedLinearRK.from_driven_dense(model, torch.float32,
                                                  device="cuda")
    return st, y0


def solve(st, y0, save_at=None):
    return ensemble_solve(None, y0, 0.0, TF, stepper=st, ctl=CTL, h0=H0,
                          adaptive=True, save_at=save_at,
                          time_dtype=torch.float32)


def reset_counts() -> None:
    """Every kernel wrapper's launch count to 0."""
    fused_rk_step.launches = 0
    fused_loop_chunk.launches = 0
    fused_chain_apply.launches = 0
    fused_dense_chain_apply.launches = 0
    tadj.adjoint_bwd.launches = 0
    tadj.adjoint_sweep_fwd.launches = 0
    tadj.adjoint_sweep_bwd.launches = 0


def counts() -> tuple:
    """The launch counts of K1, K2 and K4."""
    return (fused_rk_step.launches, fused_loop_chunk.launches,
            fused_chain_apply.launches)


def main_path_phase(card: str) -> int:
    st, y0 = main_inputs()
    reset_counts()
    sol = solve(st, y0)
    torch.cuda.synchronize()
    launches, loop_launches, chain_launches = counts()

    n_iters = int(sol.n_iters.max())
    assert sol.y_final.re.shape == (N_TRAJ, DIM), sol.y_final.re.shape
    assert bool(torch.isfinite(sol.y_final.re).all()
                & torch.isfinite(sol.y_final.im).all()), "non-finite state"
    n_done = int((sol.status == DONE).sum())
    assert n_done == N_TRAJ, f"{N_TRAJ - n_done} trajectories not DONE"
    norm = torch.sqrt((sol.y_final.re ** 2 + sol.y_final.im ** 2).sum(-1))
    norm_dev = float((norm - 1).abs().max())
    assert norm_dev <= 1e-4, f"|psi| drifted by {norm_dev}"
    assert sol.path == "torch-driver+cuda-step", sol.path
    assert launches == n_iters, (launches, n_iters)
    assert (loop_launches, chain_launches) == (0, 0), (loop_launches,
                                                       chain_launches)
    print(f"[main] {N_TRAJ}x{DIM}c RKF45 rtol={CTL.rtol:g}: all DONE, "
          f"max||psi|-1|={norm_dev:.3e}, path={sol.path}, "
          f"kernel launches={launches} == max n_iters={n_iters} (loop "
          f"kernel {loop_launches}), "
          f"n_accept {int(sol.n_accept.min())}..{int(sol.n_accept.max())}, "
          f"n_reject {int(sol.n_reject.min())}..{int(sol.n_reject.max())}",
          flush=True)

    # the first 1024 trajectories again, through the same driver over the
    # plain step on the card; rtol=1e-8 sits at f32 rounding level, so the
    # step sequences may differ by a step or two
    nb = 1024
    M0, M1, w = st.M0, st.M1, st.w

    def plain(t, x, dt):
        xw = torch.cat([x.re, x.im], dim=-1)
        ox, oe = torch_rk_step(t, dt, xw, M0, M1,
                               u_fn=lambda ti: torch.cos(w * ti))
        return Cplx(ox[:, :DIM], ox[:, DIM:]), oe

    sub = Cplx(y0.re[:nb], y0.im[:nb])
    grid = driver.make_grid(0.0, TF, dtype=torch.float32, device="cuda")
    ref = driver.integrate(plain, sub, grid, H0, ctl=CTL,
                           error_norm=lambda e: e, batch_shape=(nb,))
    dy = float(torch.maximum((ref.y_final.re - sol.y_final.re[:nb]).abs(),
                             (ref.y_final.im - sol.y_final.im[:nb]).abs())
               .max())
    dcount = max(int((ref.n_accept - sol.n_accept[:nb]).abs().max()),
                 int((ref.n_reject - sol.n_reject[:nb]).abs().max()))
    assert int((ref.status == DONE).sum()) == nb, "plain run not all DONE"
    assert dy <= 1e-4 and dcount <= 2, (dy, dcount)
    print(f"[main] first {nb} trajectories vs the plain step on the card: "
          f"max|dy|={dy:.3e} (<= 1e-4), max|dcount|={dcount} (<= 2)",
          flush=True)
    return launches


def per_step_solve(st, y0, save_at=SAVE_AT):
    """The per-step path on the same inputs: the host driver over the
    stepper's step, a launch of K1 per iteration."""
    grid = driver.make_grid(0.0, TF, save_at, dtype=torch.float32,
                            device="cuda")
    return driver.integrate(st.make_step_fn(), y0, grid, H0, ctl=CTL,
                            error_norm=st.error_norm,
                            batch_shape=(y0.re.shape[0],))


def loop_path_phase(card: str) -> int:
    st, y0 = main_inputs(LOOP_TRAJ)
    reset_counts()
    sol = solve(st, y0, SAVE_AT)
    torch.cuda.synchronize()
    step_launches, launches, chain_launches = counts()

    assert sol.path == "cuda-loop-persistent", sol.path
    assert (step_launches, launches, chain_launches) == (0, 1, 0), (
        step_launches, launches, chain_launches)
    n_done = int((sol.status == DONE).sum())
    assert n_done == LOOP_TRAJ, f"{LOOP_TRAJ - n_done} trajectories not DONE"
    ys = torch.complex(sol.ys.re, sol.ys.im)           # (B, 11, d)
    assert ys.shape == (LOOP_TRAJ, len(SAVE_AT) + 2, DIM), ys.shape
    assert bool(torch.isfinite(ys.real).all() & torch.isfinite(ys.imag).all())
    assert torch.equal(sol.ys.re[:, 0], y0.re)
    assert torch.equal(sol.ys.re[:, -1], sol.y_final.re)
    norm_dev = float((ys.abs().pow(2).sum(-1).sqrt() - 1).abs().max())
    assert norm_dev <= 1e-4, f"|psi| drifted by {norm_dev}"
    ref = per_step_solve(st, y0)
    dcount = max(int((ref.n_accept - sol.n_accept).abs().max()),
                 int((ref.n_reject - sol.n_reject).abs().max()),
                 int((ref.n_iters - sol.n_iters).abs().max()))
    dy = float(torch.maximum((ref.ys.re - sol.ys.re).abs(),
                             (ref.ys.im - sol.ys.im).abs()).max())
    assert int((ref.status == DONE).sum()) == LOOP_TRAJ
    assert dy <= 1e-4 and dcount <= 2, (dy, dcount)
    print(f"[loop-path] {LOOP_TRAJ}x{DIM}c RKF45 rtol={CTL.rtol:g}, "
          f"{len(SAVE_AT)} interior saves: all DONE, path={sol.path}, loop "
          f"kernel launches={launches} (step kernel {step_launches}), "
          f"max||psi|-1| over saves and end={norm_dev:.3e}, n_iters up to "
          f"{int(sol.n_iters.max())}; vs the per-step path on the card: "
          f"max|dy| over saves and end={dy:.3e} (<= 1e-4), "
          f"max|dcount|={dcount} (<= 2)", flush=True)
    return launches


def timed_ms(fn, reps: int = 3, inner: int = 1) -> float:
    """Median over ``reps`` of the CUDA-event time of ``inner`` calls."""
    return statistics.median(timed_runs(fn, reps, inner))


def timed_runs(fn, reps: int = 3, inner: int = 1) -> list:
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b) / inner)
    return out


def timed_solve(fn, label: str, card: str):
    """Median of 3 CUDA-event timed solves after one warm solve, with
    accepted steps per second and peak device memory. Returns (ms, the
    first timed solution)."""
    fn()
    torch.cuda.reset_peak_memory_stats()
    sols = []
    walls = timed_runs(lambda: sols.append(fn()))
    peak = torch.cuda.max_memory_allocated()
    wall_ms = statistics.median(walls)
    accepted = int(sols[0].n_accept.sum())
    print(f"[time] {label}: median wall {wall_ms:.3f} ms of "
          f"{[round(w, 3) for w in walls]}, {int(sols[0].n_iters.max())} "
          f"iterations at most, {accepted} accepted steps, "
          f"{accepted / (wall_ms / 1e3):.4e} accepted steps/s, peak memory "
          f"{peak / 2**20:.1f} MiB ({card})", flush=True)
    return wall_ms, sols[0]


def k1_flop_bytes(B, D, stages, nbytes):
    """One K1 launch: the stage products, and x in and out, t, dt, err and
    [M0^T | M1^T] moved once."""
    return (2 * stages * B * D * 2 * D,
            nbytes * (2 * B * D + 3 * B + 2 * D * D))


def timing_phase(card: str):
    st, y0 = main_inputs()
    timed_solve(lambda: solve(st, y0),
                f"main path {N_TRAJ}x{DIM}c f32, per-step (K1)", card)

    sk, t, dt, xw = step_inputs(N_TRAJ, DIM, torch.float32)
    for _ in range(3):  # warm both
        fused_rk_step(t, dt, xw, sk.M0, sk.M1, w=sk.w)
        plain_step(sk, t, dt, xw)
    k_runs, p_runs = [], []
    for _ in range(3):  # in turns: kernel, plain
        k_runs.append(timed_ms(
            lambda: fused_rk_step(t, dt, xw, sk.M0, sk.M1, w=sk.w),
            reps=1, inner=20))
        p_runs.append(timed_ms(lambda: plain_step(sk, t, dt, xw),
                               reps=1, inner=20))
    k_ms, p_ms = statistics.median(k_runs), statistics.median(p_runs)
    flop, nbytes = k1_flop_bytes(N_TRAJ, 2 * DIM, RKF45.stages, 4)
    b_ms, b_by = bound(flop, nbytes)
    print(f"[time] K1 one RKF45 step at B={N_TRAJ}, d={DIM}, f32: kernel "
          f"{k_ms:.4f} ms ({flop / k_ms / 1e9:.2f} TFLOP/s), plain torch "
          f"{p_ms:.4f} ms ({flop / p_ms / 1e9:.2f} TFLOP/s); runs "
          f"kernel {[round(v, 4) for v in k_runs]}, plain "
          f"{[round(v, 4) for v in p_runs]}; bound {b_ms:.4f} ms by {b_by} "
          f"({flop / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB), kernel at "
          f"{b_ms / k_ms:.1%} of it ({card})", flush=True)
    return k_ms, p_ms, b_ms, b_by


def k2_bound(ist, B, D, stages, n_grid, nbytes):
    """The loop's least time: the stage products of every step the data
    needs (accepted and rejected, Sum over rows), and the carries, the
    state, the saves and the operators moved once."""
    steps = int((ist[:, 3] + ist[:, 4]).sum())
    flop = steps * 2 * stages * D * 2 * D
    moved = (nbytes * (2 * B * (5 + D) + (n_grid - 2) * B * D + 2 * D * D
                       + n_grid) + 2 * 4 * B * 8)
    return bound(flop, moved), steps


def loop_timing_phase(card: str):
    st, y0 = main_inputs(LOOP_TRAJ)
    loop_ms, _ = timed_solve(
        lambda: solve(st, y0, SAVE_AT),
        f"loop path {LOOP_TRAJ}x{DIM}c f32, {len(SAVE_AT)} saves, one K2 "
        "launch", card)
    step_ms, _ = timed_solve(
        lambda: per_step_solve(st, y0),
        f"per-step path on the same {LOOP_TRAJ} inputs and saves (K1)", card)

    # the kernel alone and its twin, on the loop path's carries
    grid = driver.make_grid(0.0, TF, SAVE_AT, dtype=torch.float32,
                            device="cuda")
    step = RKStep(M0=st.M0, M1=st.M1, w=st.w)
    carries = init_carries(grid, torch.cat([y0.re, y0.im], 1), H0)
    out = fused_loop_chunk(*carries, step, ctl=CTL)
    k_runs, p_runs = [], []
    for _ in range(3):  # in turns: kernel, plain
        k_runs.append(timed_ms(lambda: fused_loop_chunk(*carries, step,
                                                        ctl=CTL), reps=1))
        p_runs.append(timed_ms(lambda: torch_fused_loop(
            *carries[:4], carries[4].clone(), step, ctl=CTL), reps=1))
    k_ms, p_ms = statistics.median(k_runs), statistics.median(p_runs)
    (b_ms, b_by), steps = k2_bound(out[1], LOOP_TRAJ, 2 * DIM, RKF45.stages,
                                   grid.shape[0], 4)
    print(f"[time] K2 at the loop path ({LOOP_TRAJ}x{DIM}c, "
          f"{len(SAVE_AT)} saves, f32): kernel {k_ms:.4f} ms (runs "
          f"{[round(v, 4) for v in k_runs]}), plain twin {p_ms:.4f} ms "
          f"(runs {[round(v, 4) for v in p_runs]}); bound {b_ms:.4f} ms by "
          f"{b_by} ({steps} steps), kernel at {b_ms / k_ms:.1%} of it; loop "
          f"path {loop_ms:.3f} ms vs per-step path {step_ms:.3f} ms "
          f"({card})", flush=True)

    # the loop kernel below the 2048 gate, at the main path's 16 384
    st, y0 = main_inputs()
    x0 = torch.cat([y0.re, y0.im], 1)
    grid = driver.make_grid(0.0, TF, dtype=torch.float32, device="cuda")
    big, sols = [], []

    def run():
        sols.append(fused_loop_integrate(grid, x0, H0, step, ctl=CTL,
                                         persistent=True))

    run()
    torch.cuda.reset_peak_memory_stats()
    big = timed_runs(run)
    peak = torch.cuda.max_memory_allocated()
    fs, ist, x, _ = sols[-1]
    assert int((ist[:, 1] == DONE).sum()) == N_TRAJ
    xc = torch.complex(x[:, :DIM], x[:, DIM:])
    norm_dev = float((xc.abs().pow(2).sum(-1).sqrt() - 1).abs().max())
    assert norm_dev <= 1e-4, norm_dev
    big_ms = statistics.median(big)
    accepted = int(ist[:, 3].sum())
    (bb_ms, bb_by), bsteps = k2_bound(ist, N_TRAJ, 2 * DIM, RKF45.stages, 2,
                                      4)
    print(f"[time] K2 through fused_loop_integrate at {N_TRAJ}x{DIM}c f32, "
          f"no saves: median {big_ms:.3f} ms of "
          f"{[round(v, 3) for v in big]}, all DONE, max||psi|-1|="
          f"{norm_dev:.3e}, {int(ist[:, 5].max())} iterations at most, "
          f"{accepted} accepted steps, {accepted / (big_ms / 1e3):.4e} "
          f"accepted steps/s, peak memory {peak / 2**20:.1f} MiB; bound "
          f"{bb_ms:.4f} ms by {bb_by} ({bsteps} steps), kernel at "
          f"{bb_ms / big_ms:.1%} of it ({card})", flush=True)
    return k_ms, p_ms, b_ms, b_by


# -- the modulated exponential path (K4, K5, the loop kernel's fixed steps) --

MAG_CTL = StepControl(rtol=1e-5, min_dt=1e-5, max_dt=0.2)   # bench.py:581
LZ = dict(v=2.0, delta=0.4)
LZ_T, LZ_H = 20.0, 0.01


def chain_stepper(dtype, d=DIM, fast_error=False, midpoint=False, norm=None,
                  lz=False):
    """A Magnus-4 (or midpoint) stepper on DrivenDense(d, seed 0), or on the
    Landau-Zener operator, on the card."""
    model = LandauZener(**LZ) if lz else DrivenDense.make(d=d, seed=0)
    op = model.modulated(dtype, device="cuda")
    if midpoint:
        return MidpointModulated(op)
    return MagnusModulated4(op, fast_error=fast_error, norm=norm)


def chain_operands(st, dtype):
    mt, norms = st._operands(torch.device("cuda"), dtype)
    m, theta = _taylor_params(dtype)
    return mt, norms, m, theta


def chain_inputs(st, B, dtype, seed=7, dt_range=(1e-3, 5e-2)):
    """The step inputs of step_inputs (states of scale 0.1, t in [0, 1), dt
    in dt_range) for a chain stepper, with the node samples of its
    coefficient function."""
    D = st._basis_w.shape[-1]
    rng = np.random.default_rng(seed)
    xw = torch.as_tensor(rng.standard_normal((B, D)) * 0.1, dtype=dtype,
                         device="cuda")
    t = torch.as_tensor(rng.uniform(0, 1, B), dtype=dtype, device="cuda")
    dt = torch.as_tensor(rng.uniform(*dt_range, B), dtype=dtype,
                         device="cuda")
    samples = [st.op.coeff_fn(tn).contiguous()
               for tn in node_times(st._recipe, t, dt)]
    return samples, dt, xw


def chain_pair(st, samples, dt, xw, wnorm=None, kernel=True):
    """K4 and its twin on the same inputs: ((y, err), (y, err)); without
    ``kernel`` the twin's alone."""
    mt, norms, m, theta = chain_operands(st, xw.dtype)
    kw = dict(recipe=st._recipe, C=st._chains, m=m, theta=theta,
              wnorm=wnorm)
    want = torch_chain_step(samples, dt, xw, mt, norms, **kw)
    if not kernel:
        return want
    return fused_chain_apply(samples, dt, xw, mt, norms, **kw), want


def check_chain_step(B, dtype, label, dt_range=(1e-3, 5e-2), wnorm=None,
                     **stkw) -> tuple:
    """K4 against torch_chain_step on the card. The state: f64 to 1e-12 of
    its scale (only the products' summation order differs), f32 to
    bench.py's on-device limit 1e-5. The error norm per row: f64 within
    1e-9 of it plus 1e-18; f32 within 1e-4 of it plus a floor of four
    times the plain f32 step's largest deviation from the plain f64 step
    on the same inputs (the pair's error is a difference of two chains).
    Returns (max |dy|, rows on which a norm 10% off would fail)."""
    st = chain_stepper(dtype, **stkw)
    samples, dt, xw = chain_inputs(st, B, dtype, dt_range=dt_range)
    (yk, ek), (yp, ep) = chain_pair(st, samples, dt, xw, wnorm)
    torch.cuda.synchronize()
    has_err = ep is not None
    if not has_err:
        ep = torch.zeros_like(ek)
    if dtype == torch.float64:
        x_lim, e_lim, floor = 1e-12 * max(float(yp.abs().max()), 1.0), \
            1e-9 * ep.abs() + 1e-18, 1e-18
    else:
        st64 = chain_stepper(torch.float64, **stkw)
        _, e64 = chain_pair(st64, [g.double() for g in samples],
                            dt.double(), xw.double(), wnorm, kernel=False)
        floor = 4 * float((ep.double() - e64).abs().max()) if has_err else 0
        x_lim = 1e-5 * max(float(yp.abs().max()), 1.0)
        e_lim = (1e-4 * ep.abs() + floor).to(ep.dtype)
    dy = float((yk - yp).abs().max())
    de = (ek - ep).abs()
    sensitive = int((0.1 * ep > e_lim).sum()) if has_err else 0
    ok = (dy <= x_lim and bool((de <= e_lim).all())
          and bool(torch.isfinite(yk).all()) and bool(torch.isfinite(ek).all()))
    print(f"[chain-step] {label} {str(dtype)[6:]} B={B} D={xw.shape[1]} dt in "
          f"[{dt_range[0]:g}, {dt_range[1]:g}): max|dy|={dy:.3e} (<= "
          f"{x_lim:.1e}); "
          + (f"max|derr|={float(de.max()):.3e}, max|derr|/limit="
             f"{float((de / e_lim).max()):.3f} (<= 1; floor {floor:.2e}, err "
             f"up to {float(ep.max()):.2e}); a norm 10% off fails on "
             f"{sensitive}/{B} rows" if has_err else
             f"no error estimate, err == 0: {bool((ek == 0).all())}")
          + f"; {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"K4 disagrees with its twin: {label} {dtype}")
    return dy, sensitive


def chain_step_phase() -> float:
    """K4 against its twin: f64 at B=1000 (a ragged last tile) for every
    recipe and norm, D=4 (Landau-Zener) in both types, and the main path's
    16384x64c in f32, where long steps hold every row's norm tightly."""
    f64 = torch.float64
    check_chain_step(1000, f64, "magnus4 pair")
    check_chain_step(1000, f64, "magnus4 fast_error", fast_error=True)
    check_chain_step(1000, f64, "magnus4 pair l2 weighted",
                     wnorm=weighted("l2", DIM))
    check_chain_step(1000, f64, "magnus4 pair max", wnorm=weighted("max", DIM,
                                                                   False))
    check_chain_step(1000, f64, "midpoint", midpoint=True)
    for dtype in (torch.float32, f64):
        check_chain_step(1000, dtype, "LZ magnus4 pair", lz=True)
        check_chain_step(1000, dtype, "LZ midpoint", lz=True, midpoint=True,
                         dt_range=(1e-3, 0.5))
    check_chain_step(N_TRAJ, torch.float32, "magnus4 fast_error",
                     fast_error=True)
    for label, kw in (("magnus4 pair", {}),
                      ("magnus4 fast_error", dict(fast_error=True))):
        _, sensitive = check_chain_step(N_TRAJ, torch.float32, label,
                                        dt_range=(0.1, 0.2), **kw)
        if sensitive != N_TRAJ:
            raise AssertionError(
                f"the long-step check holds only {sensitive}/{N_TRAJ} error "
                "norms to 10%")
    return check_chain_step(N_TRAJ, torch.float32, "magnus4 pair")[0]


# The kernel-vs-twin cases of the chain loop (the CPU tests hold the twin
# to the JAX package on the same controller settings). max_steps bounds
# every case and the steps stay short enough that s <= 4.
CHAIN_BASE = dict(rtol=1e-5, min_dt=1e-5, max_dt=0.2, max_steps=3000)
CHAIN_CASES = {
    "plain": {},
    "save_grid": dict(grid=(0.0, 0.075, 0.15, 0.225, 0.3)),
    "pi": dict(ctl=dict(pi=True)),
    "scaled_error": dict(ctl=dict(scaled_error=True, rtol=1e-6, atol=1e-9)),
    "weighted_l2": dict(norm=("l2", True)),
    "weighted_max": dict(norm=("max", False)),
    "fast_error": dict(fast_error=True),
    "h0_per_row": dict(h0="per_row"),
    "max_steps": dict(ctl=dict(max_steps=6)),
    "stalled": dict(ctl=dict(max_reject_streak=2, rtol=1e-14), h0=0.2),
    "lz_magnus4": dict(lz=True, grid=(-2.0, 2.0)),
    # fixed steps: the loop kernel's fixed-step mode
    "lz_midpoint": dict(lz=True, midpoint=True, grid=(-2.0, 0.5, 2.0),
                        h0=0.01),
    # the Landau-Zener path's inputs (lz_inputs) and fixed steps: 4002
    # iterations
    "lz_path": dict(lz=True, midpoint=True, grid=(-LZ_T, LZ_T), h0=LZ_H,
                    y0="lz", ctl=dict(max_steps=5000)),
    # the main path's settings, t in [0, 1]
    "magnus_path": dict(grid=(0.0, TF)),
}
# the cases run at their path's batch (the tiling the path runs) alone
CHAIN_PATHS = ("lz_path", "magnus_path")


def chain_loop_case(name, B, dtype, seed=11):
    """(carries, step, ctl, adaptive, expected status) of a CHAIN_CASES
    entry: unit states, t in [0, 0.3] unless the case says otherwise."""
    case = CHAIN_CASES[name]
    ctl = StepControl(**{**CHAIN_BASE, **case.get("ctl", {})})
    norm = case.get("norm")
    st = chain_stepper(
        dtype, fast_error=case.get("fast_error", False),
        midpoint=case.get("midpoint", False), lz=case.get("lz", False),
        norm=None if norm is None else lc.WeightedNorm(
            norm[0], tuple(np.linspace(0.5, 2.0, DIM)) if norm[1] else None))
    d = 2 if case.get("lz") else DIM
    y0 = (lz_inputs(B, dtype)[1] if case.get("y0") == "lz"
          else unit_states(B, d, dtype, seed))
    h0 = case.get("h0", H0)
    if h0 == "per_row":
        h0 = 10.0 ** np.random.default_rng(seed).uniform(-4, -1, B)
    mt, norms, m, theta = chain_operands(st, dtype)
    step = ChainStep(mt=mt, norms=norms, form=st.op.form, recipe=st._recipe,
                     C=st._chains, m=m, theta=theta,
                     scaled=(ctl.atol, ctl.rtol) if ctl.scaled_error
                     else None,
                     wnorm=None if norm is None else st._wnorm_of(y0))
    grid = torch.tensor(case.get("grid", (0.0, 0.3)), dtype=torch.float64)
    carries = init_carries(grid, torch.cat([y0.re, y0.im], 1),
                           torch.as_tensor(h0, dtype=torch.float64))
    status = {"max_steps": ERR_MAX_STEPS, "stalled": ERR_STALLED}.get(name,
                                                                      DONE)
    return carries, step, ctl, st._adaptive, status


def run_chain_loop_pair(name, B, dtype, chunk=None):
    """The loop kernel with the chain step and its twin on the same
    carries; returns both final carries, the expected status and whether
    the steps were adaptive."""
    carries, step, ctl, adaptive, status = chain_loop_case(name, B, dtype)
    saves_k = carries[4].clone()
    got = fused_loop_chunk(*carries[:4], saves_k, step, ctl=ctl, chunk=chunk,
                           adaptive=adaptive)
    while chunk is not None and bool((got[1][:, 1] == 0).any()):
        got = fused_loop_chunk(carries[0], *got, step, ctl=ctl, chunk=chunk,
                               adaptive=adaptive)
    want = torch_fused_loop(*carries, step, ctl=ctl, adaptive=adaptive)
    torch.cuda.synchronize()
    return got, want, status, adaptive


def check_chain_loop_pair(name, B, dtype) -> float:
    """The loop kernel with the chain step (K5) against torch_fused_loop.
    f64: status and every counter equal per trajectory, states and saves
    within 1e-12. f32: states within 1e-4; counters equal for fixed steps
    (every step accepts), within 2 for adaptive ones (marginal accepts
    may flip at f32 rounding). Returns max |dx|."""
    got, want, status, adaptive = run_chain_loop_pair(name, B, dtype)
    dcount = int((got[1][:, INT_COLS] - want[1][:, INT_COLS]).abs().max())
    dx = float((got[2] - want[2]).abs().max())
    ds = float((got[3] - want[3]).abs().max()) if got[3].numel() else 0.0
    n_status = int((got[1][:, 1] == status).sum())
    f64 = dtype == torch.float64
    lim_c = 0 if f64 or not adaptive else 2
    lim_x = 1e-12 if f64 else 1e-4
    ok = (dcount <= lim_c and dx <= lim_x and ds <= lim_x and n_status == B
          and bool(torch.isfinite(got[2]).all()))
    print(f"[chain-loop] {name} {str(dtype)[6:]} B={B} D={got[2].shape[1]}: "
          f"status {status} on {n_status}/{B}, max|dcount|={dcount} (<= "
          f"{lim_c}), max|dx|={dx:.3e}, max|dsaves|={ds:.3e} (<= "
          f"{lim_x:.1e}), iterations up to {int(got[1][:, 5].max())}; "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"the chain loop disagrees with its twin: "
                             f"{name} {dtype} B={B}")
    return dx


def check_chain_persistent_is_chunked(name, B, dtype) -> None:
    p = run_chain_loop_pair(name, B, dtype)[0]
    c = run_chain_loop_pair(name, B, dtype, chunk=5)[0]
    same = [bool(torch.equal(a, b)) for a, b in zip(p, c)]
    print(f"[chain-loop] persistent vs chunks of 5, {name} {str(dtype)[6:]} "
          f"B={B}: fs/ist/x/saves bitwise equal {same}", flush=True)
    if not all(same):
        raise AssertionError("persistent and chunked chain loops differ")


def chain_loop_kernel_phase() -> float:
    for name in CHAIN_CASES:
        if name not in CHAIN_PATHS:
            check_chain_loop_pair(name, 1000, torch.float64)   # ragged tiles
    for name in ("plain", "save_grid", "pi", "lz_magnus4", "lz_midpoint"):
        check_chain_loop_pair(name, LOOP_TRAJ, torch.float32)
    check_chain_persistent_is_chunked("save_grid", 1000, torch.float64)
    check_chain_persistent_is_chunked("lz_midpoint", LOOP_TRAJ,
                                      torch.float32)
    # both paths' own inputs at their batch, so at the tiles they run
    check_chain_loop_pair("lz_path", N_TRAJ, torch.float32)
    return check_chain_loop_pair("magnus_path", N_TRAJ, torch.float32)


def magnus_inputs(n=N_TRAJ, form=True):
    """The Magnus path's inputs: the main path's unit states and
    DrivenDense(64, seed 0) as a modulated operator, with its declared
    coefficient form or (form=False) only its coefficient function."""
    op = DrivenDense.make(d=DIM, seed=0).modulated(torch.float32,
                                                   device="cuda")
    if not form:
        op = dataclasses.replace(op, form=None)
    _, y0 = main_inputs(n)
    return MagnusModulated4(op), y0


def magnus_solve(st, y0):
    return ensemble_solve(None, y0, 0.0, TF, stepper=st, ctl=MAG_CTL, h0=H0,
                          time_dtype=torch.float32)


def magnus_loop_path_phase():
    """The slice's main path: 16384x64c Magnus-4 in one loop launch."""
    st, y0 = magnus_inputs()
    reset_counts()
    sol = magnus_solve(st, y0)
    torch.cuda.synchronize()
    k1, k2, k4 = counts()
    assert sol.path == "cuda-loop-persistent", sol.path
    assert (k1, k2, k4) == (0, 1, 0), (k1, k2, k4)
    n_done = int((sol.status == DONE).sum())
    assert n_done == N_TRAJ, f"{N_TRAJ - n_done} trajectories not DONE"
    y = torch.complex(sol.y_final.re, sol.y_final.im)
    assert y.shape == (N_TRAJ, DIM) and bool(torch.isfinite(y.real).all()
                                             & torch.isfinite(y.imag).all())
    norm_dev = float((y.abs().pow(2).sum(-1).sqrt() - 1).abs().max())
    assert norm_dev <= 1e-4, f"|psi| drifted by {norm_dev}"
    print(f"[magnus-loop] {N_TRAJ}x{DIM}c MagnusModulated4 rtol="
          f"{MAG_CTL.rtol:g}: all DONE, max||psi|-1|={norm_dev:.3e}, path="
          f"{sol.path}, launches K1/K2/K4 = {k1}/{k2}/{k4}, n_accept "
          f"{int(sol.n_accept.min())}..{int(sol.n_accept.max())}, n_reject "
          f"{int(sol.n_reject.min())}..{int(sol.n_reject.max())}, n_iters up "
          f"to {int(sol.n_iters.max())}", flush=True)
    return k2, sol


def magnus_step_path_phase(loop_sol):
    """The same solve with only a coefficient function: the host driver and
    a K4 launch per iteration; counters within 1 of the loop path's."""
    st, y0 = magnus_inputs(form=False)
    reset_counts()
    sol = magnus_solve(st, y0)
    torch.cuda.synchronize()
    k1, k2, k4 = counts()
    n_iters = int(sol.n_iters.max())
    assert sol.path == "torch-driver+cuda-step", sol.path
    assert (k1, k2) == (0, 0) and k4 == n_iters, (k1, k2, k4, n_iters)
    assert int((sol.status == DONE).sum()) == N_TRAJ
    dcount = max(int((getattr(sol, k) - getattr(loop_sol, k)).abs().max())
                 for k in ("n_accept", "n_reject", "n_iters"))
    dy = float(torch.maximum((sol.y_final.re - loop_sol.y_final.re).abs(),
                             (sol.y_final.im - loop_sol.y_final.im).abs())
               .max())
    assert dcount <= 1 and dy <= 1e-4, (dcount, dy)
    print(f"[magnus-step] {N_TRAJ}x{DIM}c, operator without a declared form: "
          f"path={sol.path}, K4 launches={k4} == max n_iters={n_iters} "
          f"(K1/K2 {k1}/{k2}); vs the loop path: max|dcount|={dcount} (<= 1), "
          f"max|dy|={dy:.3e} (<= 1e-4)", flush=True)
    return k4


def lz_inputs(n=N_TRAJ, dtype=torch.float32):
    """Half the sweeps start in |0>, the rest at random unit states."""
    rng = np.random.default_rng(42)
    psi = rng.standard_normal((n, 2)) + 1j * rng.standard_normal((n, 2))
    psi /= np.linalg.norm(psi, axis=-1, keepdims=True)
    psi[: n // 2] = [1.0, 0.0]
    st = MidpointModulated(LandauZener(**LZ).modulated(dtype, device="cuda"))
    return st, from_complex(psi, dtype, device="cuda")


def lz_solve(st, y0):
    return ensemble_solve(None, y0, -LZ_T, LZ_T, stepper=st, h0=LZ_H,
                          adaptive=False, time_dtype=torch.float32)


def lz_path_phase():
    """16384 fixed-step Landau-Zener sweeps in the loop kernel's fixed-step
    mode: the |0> rows within 0.02 of the closed-form transition
    probability (the JAX package's tolerance for a finite sweep), every
    row at |psi| = 1 within 1e-4."""
    st, y0 = lz_inputs()
    reset_counts()
    sol = lz_solve(st, y0)
    torch.cuda.synchronize()
    k1, k2, k4 = counts()
    assert sol.path == "cuda-loop-persistent", sol.path
    assert (k1, k2, k4) == (0, 1, 0), (k1, k2, k4)
    n_steps = round(2 * LZ_T / LZ_H)
    assert int((sol.status == DONE).sum()) == N_TRAJ
    assert bool((sol.n_accept == n_steps).all()), sol.n_accept.unique()
    assert int(sol.n_reject.max()) == 0
    psi = torch.complex(sol.y_final.re, sol.y_final.im)
    p_stay = psi[: N_TRAJ // 2, 0].abs().pow(2)
    p = LandauZener(**LZ).p_transition
    dp = float((p_stay - p).abs().max())
    norm_dev = float((psi.abs().pow(2).sum(-1).sqrt() - 1).abs().max())
    assert dp <= 0.02 and norm_dev <= 1e-4, (dp, norm_dev)
    print(f"[lz] {N_TRAJ} Landau-Zener sweeps (v={LZ['v']}, delta="
          f"{LZ['delta']}), t in [-{LZ_T:g}, {LZ_T:g}], {n_steps} fixed "
          f"midpoint steps: path={sol.path}, launches K1/K2/K4 = "
          f"{k1}/{k2}/{k4}; |0> rows: P_stay {float(p_stay.min()):.5f}.."
          f"{float(p_stay.max()):.5f} vs P_LZ {p:.5f}, max|dP|={dp:.4f} "
          f"(<= 0.02); max||psi|-1|={norm_dev:.3e} (<= 1e-4)", flush=True)
    return k2


def chain_flops(passes, D: int, m: int, recipe: str, K0: int,
                fast_rows: int = 0, zero_columns: bool = False) -> float:
    """Operations of passes[c] Taylor passes of chain c (each m terms: a
    (D, K_c D) product, the K_c-term weighted sum, the division and the
    running sum) and of fast_rows fast-error products over the commutator
    columns. K_c counts the basis terms chain c's row can hold nonzero:
    the Magnus-4 pair's comparison chain (c = 1) has zero commutator
    columns, which the kernels multiply all the same (so that a non-finite
    state reaches the error) and which only ``zero_columns`` counts."""
    Kp = expmv.n_working_terms(recipe, K0)
    flop = 0
    for c, n in enumerate(passes):
        k = K0 if c == 1 and not zero_columns else Kp
        flop += n * m * (2 * D * k * D + 2 * k * D + 2 * D)
    return flop + fast_rows * 2 * D * (Kp - K0) * D


def passes_needed(st, samples, dt) -> list:
    """The Taylor passes these inputs need per chain, summed over rows (the
    twin's scaling rule)."""
    mt, norms, m, theta = chain_operands(st, dt.dtype)
    rows = expmv.chain_rows(st._recipe, samples, dt, st._chains)
    _, n_pass = expmv.scale_rows(rows, norms, theta, st.max_squarings)
    return n_pass.sum(0).tolist()


def k4_timing_phase(card: str):
    """K4 per launch at the main path's 16384x64c f32 Magnus-4 pair (CUDA
    events over 20 launches), its twin, and the library yardstick:
    torch.linalg.matrix_exp of the assembled (2B, D, D) exponents of both
    chains and bmm applying them, in batches of 4096 exponents (16 calls;
    the error norm is not in it), checked against K4's advanced state."""
    st = chain_stepper(torch.float32)
    samples, dt, xw = chain_inputs(st, N_TRAJ, torch.float32)
    mt, norms, m, theta = chain_operands(st, torch.float32)
    kw = dict(recipe=st._recipe, C=st._chains, m=m, theta=theta)
    for _ in range(3):
        fused_chain_apply(samples, dt, xw, mt, norms, **kw)
        torch_chain_step(samples, dt, xw, mt, norms, **kw)
    rows = expmv.chain_rows(st._recipe, samples, dt, st._chains)
    A = torch.einsum("bck,kij->bcij", rows,
                     st._basis_w.to(rows)).reshape(-1, 2 * DIM, 2 * DIM)
    xs = xw.repeat_interleave(st._chains, 0)[:, :, None]
    # in batches of 4096 exponents: one matrix_exp over all 32 768 faulted
    # with an illegal memory access on the H100 (torch 2.11.0+cu128)
    n_lib = 4096

    def library():
        return torch.cat([torch.bmm(torch.linalg.matrix_exp(a), x)
                          for a, x in zip(A.split(n_lib), xs.split(n_lib))])

    y_lib = library()[:, :, 0].reshape(N_TRAJ, st._chains, 2 * DIM)
    y_k4, _ = fused_chain_apply(samples, dt, xw, mt, norms, **kw)
    torch.cuda.synchronize()
    d_lib = float((y_lib[:, 0] - y_k4).abs().max())
    assert d_lib <= 1e-5, f"the library yardstick disagrees with K4: {d_lib}"
    k_runs, p_runs, l_runs = [], [], []
    for _ in range(3):  # in turns: kernel, plain, library
        k_runs.append(timed_ms(lambda: fused_chain_apply(
            samples, dt, xw, mt, norms, **kw), reps=1, inner=20))
        p_runs.append(timed_ms(lambda: torch_chain_step(
            samples, dt, xw, mt, norms, **kw), reps=1, inner=5))
        l_runs.append(timed_ms(library, reps=1, inner=5))
    k_ms, p_ms, l_ms = (statistics.median(r) for r in (k_runs, p_runs,
                                                        l_runs))
    passes = passes_needed(st, samples, dt)
    D, Kp, K0 = 2 * DIM, mt.shape[1] // (2 * DIM), samples[0].shape[1]
    flop = chain_flops(passes, D, m, st._recipe, K0)
    nbytes = 4 * (2 * N_TRAJ * D + 2 * N_TRAJ * 2 + 2 * N_TRAJ
                  + Kp * D * D)
    b_ms, b_by = bound(flop, nbytes)
    b0_ms, _ = bound(chain_flops(passes, D, m, st._recipe, K0,
                                 zero_columns=True), nbytes)
    print(f"[time] K4 one Magnus-4 pair step at B={N_TRAJ}, d={DIM}, f32 "
          f"(Taylor passes over rows, per chain {passes}): kernel "
          f"{k_ms:.4f} ms ({flop / k_ms / 1e9:.2f} TFLOP/s), plain twin "
          f"{p_ms:.4f} ms, library (matrix_exp + bmm of both chains) "
          f"{l_ms:.4f} ms (max|y_lib - y_K4|={d_lib:.2e}); runs kernel "
          f"{[round(v, 4) for v in k_runs]}, plain "
          f"{[round(v, 4) for v in p_runs]}, library "
          f"{[round(v, 4) for v in l_runs]}; bound {b_ms:.4f} ms by {b_by} "
          f"({flop / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB; "
          f"{b0_ms:.4f} ms with the comparison chain's zero columns), "
          f"kernel at {b_ms / k_ms:.1%} of it ({card})", flush=True)
    return k_ms, p_ms, b_ms, b_by, l_ms


class PassCounter:
    """A ChainStep's twin that also counts the Taylor passes its stepping
    rows take per chain, for the loop's bound."""

    def __init__(self, step):
        self.step, self.passes, self.fast_rows = step, [0] * step.C, 0
        self.has_err, self.scaled, self.wnorm = (step.has_err, step.scaled,
                                                 step.wnorm)

    def plain(self, t, dt, xw):
        st = self.step
        samples = [st.form.sample(tn) for tn in node_times(st.recipe, t, dt)]
        rows = expmv.chain_rows(st.recipe, samples, dt, st.C)
        _, n_pass = expmv.scale_rows(rows, st.norms, st.theta,
                                     st.max_squarings)
        stepping = (dt != 0)[:, None]
        self.passes = [a + b for a, b in zip(
            self.passes, (n_pass * stepping).sum(0).tolist())]
        if st.recipe == "magnus4_fast":
            self.fast_rows += int(stepping.sum())
        return st.plain(t, dt, xw)


def k5_timing_phase(card: str):
    """The Magnus path's solve (one loop launch) and the per-step path's,
    and the loop kernel with the chain step alone against its twin per
    solve, beside the bound of the Taylor passes the twin takes."""
    st, y0 = magnus_inputs()
    loop_ms, _ = timed_solve(
        lambda: magnus_solve(st, y0),
        f"Magnus loop path {N_TRAJ}x{DIM}c f32, one loop launch (K5)", card)
    st_step, _ = magnus_inputs(form=False)
    step_ms, _ = timed_solve(
        lambda: magnus_solve(st_step, y0),
        f"Magnus per-step path on the same {N_TRAJ} inputs (K4)", card)
    grid = driver.make_grid(0.0, TF, dtype=torch.float32, device="cuda")
    mt, norms, m, theta = chain_operands(st, torch.float32)
    step = ChainStep(mt=mt, norms=norms, form=st.op.form, recipe=st._recipe,
                     C=st._chains, m=m, theta=theta)
    carries = init_carries(grid, torch.cat([y0.re, y0.im], 1), H0)
    out = fused_loop_chunk(*carries, step, ctl=MAG_CTL)
    k_runs, p_runs = [], []
    counter = PassCounter(step)
    for i in range(3):  # in turns: kernel, plain
        k_runs.append(timed_ms(lambda: fused_loop_chunk(
            *carries, step, ctl=MAG_CTL), reps=1))
        p_runs.append(timed_ms(lambda: torch_fused_loop(
            *carries[:4], carries[4].clone(), counter if i == 0 else step,
            ctl=MAG_CTL), reps=1))
    k_ms, p_ms = statistics.median(k_runs), statistics.median(p_runs)
    D, Kp, K0 = 2 * DIM, mt.shape[1] // (2 * DIM), step.form.n_terms
    steps = int((out[1][:, 3] + out[1][:, 4]).sum())
    flop = chain_flops(counter.passes, D, m, step.recipe, K0,
                       counter.fast_rows)
    nbytes = 4 * (2 * N_TRAJ * (5 + D) + Kp * D * D + 2) + 2 * 4 * N_TRAJ * 8
    b_ms, b_by = bound(flop, nbytes)
    b0_ms, _ = bound(chain_flops(counter.passes, D, m, step.recipe, K0,
                                 counter.fast_rows, zero_columns=True),
                     nbytes)
    print(f"[time] K2 with the chain step (K5) at the Magnus path "
          f"({N_TRAJ}x{DIM}c, f32): kernel {k_ms:.4f} ms (runs "
          f"{[round(v, 4) for v in k_runs]}), plain twin {p_ms:.4f} ms (runs "
          f"{[round(v, 4) for v in p_runs]}); bound {b_ms:.4f} ms by {b_by} "
          f"({steps} steps, Taylor passes per chain {counter.passes}, "
          f"{flop / 1e9:.1f} GFLOP; {b0_ms:.4f} ms with the comparison "
          f"chain's zero columns), kernel at {b_ms / k_ms:.1%} of it; loop "
          f"path {loop_ms:.3f} ms vs per-step path {step_ms:.3f} ms ({card})",
          flush=True)
    st_lz, y_lz = lz_inputs()
    lz_ms, _ = timed_solve(lambda: lz_solve(st_lz, y_lz),
                           f"Landau-Zener path {N_TRAJ} sweeps, "
                           f"{round(2 * LZ_T / LZ_H)} fixed steps, one loop "
                           "launch", card)
    lz_b_ms, lz_b_by, lz_flop, lz_passes = lz_bound(st_lz)
    print(f"[time] Landau-Zener path's bound: {lz_b_ms:.4f} ms by {lz_b_by} "
          f"({lz_flop / 1e9:.2f} GFLOP: {lz_passes} Taylor passes per sweep "
          f"over its {round(2 * LZ_T / LZ_H)} steps, D = 4), the solve at "
          f"{lz_b_ms / lz_ms:.2%} of it: the path is bound by latency, a "
          f"step is {lz_ms / round(2 * LZ_T / LZ_H) * 1e3:.1f} us of "
          f"dependent block barriers ({card})", flush=True)
    return k_ms, p_ms, b_ms, b_by


def lz_bound(st):
    """The Landau-Zener path's least time: every sweep takes the same fixed
    steps, so the Taylor passes per sweep come from the coefficient rows of
    the steps' midpoints (the twin's scaling rule); the state and the
    carries moved once."""
    n_steps = round(2 * LZ_T / LZ_H)
    mt, norms, m, theta = chain_operands(st, torch.float32)
    t = -LZ_T + LZ_H * torch.arange(n_steps, dtype=torch.float32,
                                    device="cuda")
    dt = torch.full_like(t, LZ_H)
    samples = [st.op.form.sample(tn) for tn in node_times(st._recipe, t, dt)]
    rows = expmv.chain_rows(st._recipe, samples, dt, st._chains)
    _, n_pass = expmv.scale_rows(rows, norms, theta, st.max_squarings)
    passes = int(n_pass.sum())
    flop = chain_flops([N_TRAJ * passes], 4, m, st._recipe,
                       st.op.form.n_terms)
    nbytes = 4 * (2 * N_TRAJ * (5 + 4) + mt.numel() + 2) + 2 * 4 * N_TRAJ * 8
    b_ms, b_by = bound(flop, nbytes)
    return b_ms, b_by, flop, passes


# -- the generic dense exponential path (K9) ---------------------------------

GEN_TRAJ = 4096              # the generic path's batch on the card
GEN_SMALL = 256              # and the batch of the JAX package's record
GEN_CTL = StepControl(rtol=1e-5, min_dt=1e-5, max_dt=0.25)
GEN_H0 = 1e-2
# checks bound the squarings: a row gone wrong cannot hold a block for long
GEN_MAX_SQUARINGS = 16


def dense_tables() -> dict:
    """Every stepper's chain table."""
    return {
        "midpoint": tmagnus.midpoint_table(),
        "magnus4 pair": tmagnus.magnus4_table(pair=True),
        "magnus4 one chain (fast_error, non-adaptive)":
            tmagnus.magnus4_table(pair=False),
        "magnus6": tmagnus.magnus6_table(adaptive=True),
        "cfm4": tcfm.cfm_table(ttab.CFM_R4_J2_GL, ttab.CFM_R2_J1_GL),
        "cfm4_blanes17 (4 + 1 exponents)": tcfm.cfm_table(
            ttab.BLANES17_R4_J4, [[5 / 18, 4 / 9, 5 / 18]]),
        "split midpoint": tsplit.split_midpoint_table(False),
        "split midpoint strict": tsplit.split_midpoint_table(True),
        "split cfm": tsplit.split_cfm_table(
            ((0.5, 0.5),), ((0.5, 0.0), (0.0, 0.5))),
    }


def dense_inputs(table, B, D, dtype, seed=5, big_row=None, nan_row=None):
    """Random per-trajectory samples of 1-norm about sqrt(D), dt in
    [1e-3, 5e-2) and states of scale 0.1; ``big_row`` gets dt = 0.7 (past
    theta, so only it squares in f32), ``nan_row`` a NaN sample."""
    rng = np.random.default_rng(seed)
    ops = rng.standard_normal((table.n_nodes, B, D, D)) / D ** 0.5
    dt = rng.uniform(1e-3, 5e-2, B)
    if big_row is not None:
        dt[big_row] = 0.7
    if nan_row is not None:
        ops[0, nan_row, 0, 0] = np.nan
    xw = rng.standard_normal((B, D)) * 0.1
    return (torch.as_tensor(a, dtype=dtype, device="cuda")
            for a in (ops, dt, xw))


def check_dense(label, table, node_ops, dt, xw, nan_row=None,
                wnorm=None) -> float:
    """K9 against its twin on the card. f64: only the order of the sums
    differs, 1e-11 on states of scale <= 1 and 1e-9 of each error norm.
    f32: 2e-5 of the largest state entry; the error norm is a difference
    of two propagated states, so its limit is 1e-3 of the norm plus four
    times the f32 twin's own distance from the f64 twin on these inputs.
    ``wnorm``: a declared error norm, which both execute."""
    dtype = xw.dtype
    m, theta = dense_fast.ps_params(dtype)
    kw = dict(m=m, theta=theta, max_squarings=GEN_MAX_SQUARINGS, wnorm=wnorm)
    counts_s = []
    yk, ek = fused_dense_chain_apply(table, node_ops, dt, xw, **kw)
    yp, ep = torch_dense_chains(table, node_ops, dt, xw, counts=counts_s,
                                **kw)
    torch.cuda.synchronize()
    e64 = None
    if ep is not None and dtype == torch.float32:
        _, e64 = torch_dense_chains(table, node_ops.double(), dt.double(),
                                    xw.double(), **kw)
    ok = True
    if nan_row is not None:
        keep = torch.ones(xw.shape[0], dtype=torch.bool, device="cuda")
        keep[nan_row] = False
        ok = bool(torch.isnan(yk[nan_row]).all())
        if ep is not None:
            ok = ok and bool(torch.isnan(ek[nan_row]))
        yk, yp, ek = yk[keep], yp[keep], ek[keep]
        ep = None if ep is None else ep[keep]
        e64 = None if e64 is None else e64[keep]
    ok = ok and bool(torch.isfinite(yk).all() & torch.isfinite(ek).all())
    dy = float((yk - yp).abs().max())
    if dtype == torch.float64:
        y_lim = 1e-11
    else:
        y_lim = 2e-5 * max(float(yp.abs().max()), 1.0)
    if ep is None:
        de_txt = f"one chain, err == 0: {bool((ek == 0).all())}"
        ok = ok and bool((ek == 0).all())
    else:
        if dtype == torch.float64:
            e_lim = 1e-9 * ep.abs() + 1e-15
        else:
            floor = 4 * float((ep.double() - e64).abs().max())
            e_lim = 1e-3 * ep.abs() + floor
        de = (ek - ep).abs()
        ok = ok and bool((de <= e_lim).all())
        de_txt = (f"max|derr|={float(de.max()):.3e}, max|derr|/limit="
                  f"{float((de / e_lim).max()):.3f} (<= 1), err up to "
                  f"{float(ep.max()):.2e}")
    s_all = torch.stack(counts_s)
    ok = ok and dy <= y_lim
    print(f"[dense] {label} {str(dtype)[6:]} B={xw.shape[0]} D={xw.shape[1]} "
          f"({table.n_nodes} nodes, chains of "
          f"{[len(c) for c in table.chains]}): max|dy|={dy:.3e} (<= "
          f"{y_lim:.1e}); {de_txt}; squarings up to {int(s_all.max())}, "
          f"{int(s_all.amax(0).gt(0).sum())} row(s) square"
          f"{'' if nan_row is None else f'; NaN stays in row {nan_row}'}"
          f"; {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"K9 disagrees with its twin: {label} {dtype}")
    return dy


def generic_op_fn(dtype=torch.float32):
    model = DrivenDense.make(d=DIM, seed=0)
    return lambda t: model.op_pair(t, dtype)


def model_dense_inputs(B, seed=7):
    """The generic path's own samples: the Magnus-4 pair's two nodes of
    DrivenDense(64, seed 0) at t in [0, 1), dt in [1e-3, 5e-2), f32."""
    rng = np.random.default_rng(seed)
    t = torch.as_tensor(rng.uniform(0, 1, B), dtype=torch.float32,
                        device="cuda")
    dt = torch.as_tensor(rng.uniform(1e-3, 5e-2, B), dtype=torch.float32,
                         device="cuda")
    xw = torch.as_tensor(rng.standard_normal((B, 2 * DIM)) * 0.1,
                         dtype=torch.float32, device="cuda")
    tv = torch.cat(tmagnus.gl2_times(t, dt))
    E = embed(torch.func.vmap(generic_op_fn())(tv))
    return E.reshape(2, B, 2 * DIM, 2 * DIM), dt, xw


def dense_chain_phase() -> float:
    """K9 against its twin: every table in f64 at D = 8 and D = 128, with
    a row past theta and a NaN row; the Magnus-4 pair under each declared
    norm in f64 and f32; the main path's table in f32 at D = 4 and at
    4096 x 128, on random samples and on the path's own."""
    for name, table in dense_tables().items():
        for B, D in ((1500, 8), (300, 128)):
            check_dense(name, table,
                        *dense_inputs(table, B, D, torch.float64, big_row=3,
                                      nan_row=5), nan_row=5)
    pair = tmagnus.magnus4_table(pair=True)
    for kind, weights in (("l2", True), ("rms", False), ("max", True)):
        label = (f"magnus4 pair, norm {kind}"
                 f"{' weighted' if weights else ''}")
        for B, D, dtype in ((1500, 8, torch.float64),
                            (300, 128, torch.float64),
                            (1000, 128, torch.float32)):
            check_dense(label, pair,
                        *dense_inputs(pair, B, D, dtype, big_row=3,
                                      nan_row=5), nan_row=5,
                        wnorm=weighted(kind, D // 2, weights))
    # samples at an offset and with a stride of their own over the nodes
    ops, dt, xw = dense_inputs(pair, 300, 128, torch.float32)
    store = torch.zeros(2, 301, 128, 128, device="cuda")
    store[:, 1:] = ops
    check_dense("magnus4 pair, samples as a strided view", pair,
                store[:, 1:], dt, xw)
    check_dense("magnus4 pair", pair,
                *dense_inputs(pair, 1000, 4, torch.float32, big_row=3))
    check_dense("magnus4 pair", pair,
                *dense_inputs(pair, GEN_TRAJ, 2 * DIM, torch.float32,
                              big_row=3, nan_row=5), nan_row=5)
    return check_dense("magnus4 pair, the generic path's samples", pair,
                       *model_dense_inputs(GEN_TRAJ))


def generic_solve(y0):
    return ensemble_solve(
        generic_op_fn(), y0, 0.0, TF,
        stepper=texp.Magnus4(texp.DenseCplxSplit()),
        adaptive=True, ctl=GEN_CTL, h0=GEN_H0, time_dtype=torch.float32)


def stacked_generic_solve(y0):
    """The generic solve through the same host driver with each step by
    the stacked batched expm (``dense_fast.run_stacked_chains``:
    torch.matmul, one scaling count per batch): the library reference of
    the path, which no stepper runs."""
    op_fn, split = generic_op_fn(), texp.DenseCplxSplit()
    table = tmagnus.magnus4_table(pair=True)

    def step(t, x, dt):
        E = embed(torch.func.vmap(op_fn)(torch.cat(tmagnus.gl2_times(t, dt))))
        return dense_fast.run_stacked_chains(
            split, x, dt, E.reshape(2, -1, 2 * DIM, 2 * DIM), table,
            adaptive=True)

    grid = driver.make_grid(0.0, TF, dtype=torch.float32, device="cuda")
    return driver.integrate(step, y0, grid, GEN_H0, ctl=GEN_CTL,
                            error_norm=lambda e: e,
                            batch_shape=(y0.re.shape[0],))


def max_dy(a, b) -> float:
    return float(torch.maximum((a.y_final.re - b.y_final.re).abs(),
                               (a.y_final.im - b.y_final.im).abs()).max())


def generic_path_phase() -> int:
    """This slice's main path: 4096x64c adaptive Magnus-4 with a black-box
    operator callback, one K9 launch per driver iteration; then the same
    solve by the stacked reference, under a declared norm, and on the
    Magnus loop path (the same operator as a ModulatedOperator)."""
    _, y0 = main_inputs(GEN_TRAJ)
    reset_counts()
    sol = generic_solve(y0)
    torch.cuda.synchronize()
    k9 = fused_dense_chain_apply.launches
    n_iters = int(sol.n_iters.max())
    assert sol.path == "torch-driver+cuda-step", sol.path
    assert k9 == n_iters and counts() == (0, 0, 0), (k9, n_iters, counts())
    n_done = int((sol.status == DONE).sum())
    assert n_done == GEN_TRAJ, f"{GEN_TRAJ - n_done} trajectories not DONE"
    y = torch.complex(sol.y_final.re, sol.y_final.im)
    assert y.shape == (GEN_TRAJ, DIM) and bool(torch.isfinite(y.real).all()
                                               & torch.isfinite(y.imag).all())
    norm_dev = float((y.abs().pow(2).sum(-1).sqrt() - 1).abs().max())
    assert norm_dev <= 1e-4, f"|psi| drifted by {norm_dev}"
    print(f"[generic] {GEN_TRAJ}x{DIM}c Magnus4(DenseCplxSplit) rtol="
          f"{GEN_CTL.rtol:g}, op_fn callback: all DONE, max||psi|-1|="
          f"{norm_dev:.3e} (<= 1e-4), path={sol.path}, K9 launches={k9} == "
          f"max n_iters={n_iters} (K1/K2/K4 {counts()}), n_accept "
          f"{int(sol.n_accept.min())}..{int(sol.n_accept.max())}, n_reject "
          f"{int(sol.n_reject.min())}..{int(sol.n_reject.max())}", flush=True)

    # the stacked reference: one scaling count per batch where K9 takes one
    # per trajectory, so the states differ by f32 rounding per step and a
    # step at the controller's edge may fall the other way
    reset_counts()
    ref = stacked_generic_solve(y0)
    torch.cuda.synchronize()
    assert fused_dense_chain_apply.launches == 0 and counts() == (0, 0, 0)
    assert int((ref.status == DONE).sum()) == GEN_TRAJ
    d_acc, d_rej, d_it = (
        int((getattr(sol, k) - getattr(ref, k)).abs().max())
        for k in ("n_accept", "n_reject", "n_iters"))
    dy = max_dy(sol, ref)
    # a row that rejects once more also accepts once more: n_iters by 2
    assert d_acc <= 1 and d_rej <= 1 and d_it <= 2 and dy <= 1e-4, (
        d_acc, d_rej, d_it, dy)
    print(f"[generic] the stacked reference (no K9 launch) vs K9: max|dy|={dy:.3e} (<= 1e-4), n_accept / n_reject / n_iters "
          f"differ by at most {d_acc} / {d_rej} / {d_it} (<= 1 / 1 / 2) on "
          f"{int((sol.n_iters != ref.n_iters).sum())} of {GEN_TRAJ} rows",
          flush=True)

    # a declared norm stays on the kernel: weights in [0.5, 1] measure
    # between half the l2 error and all of it, so the solve ends at the
    # same states within the two tolerances
    wn = lc.WeightedNorm("l2", tuple(np.linspace(0.5, 1.0, DIM)))
    reset_counts()
    wsol = ensemble_solve(
        generic_op_fn(), y0, 0.0, TF,
        stepper=texp.Magnus4(texp.DenseCplxSplit()), adaptive=True,
        ctl=GEN_CTL, h0=GEN_H0, time_dtype=torch.float32, error_norm=wn)
    torch.cuda.synchronize()
    k9w, dyw = fused_dense_chain_apply.launches, max_dy(sol, wsol)
    assert wsol.path == "torch-driver+cuda-step", wsol.path
    assert k9w == int(wsol.n_iters.max()) and counts() == (0, 0, 0)
    assert int((wsol.status == DONE).sum()) == GEN_TRAJ
    assert dyw <= 5e-4, dyw
    print(f"[generic] under WeightedNorm(l2, weights): path={wsol.path}, K9 "
          f"launches={k9w} == max n_iters; n_accept "
          f"{int(wsol.n_accept.min())}..{int(wsol.n_accept.max())}, max|dy| "
          f"vs the plain l2 solve={dyw:.3e} (<= 5e-4)", flush=True)

    # two routes to one answer: the modulated Magnus-4 loop path takes the
    # Taylor action (degree 8) in a step sequence of its own, both at
    # rtol 1e-5
    op = DrivenDense.make(d=DIM, seed=0).modulated(torch.float32,
                                                   device="cuda")
    mod = ensemble_solve(None, y0, 0.0, TF, stepper=MagnusModulated4(op),
                         ctl=GEN_CTL, h0=GEN_H0, time_dtype=torch.float32)
    torch.cuda.synchronize()
    assert mod.path == "cuda-loop-persistent", mod.path
    assert int((mod.status == DONE).sum()) == GEN_TRAJ
    dy_mod = max_dy(sol, mod)
    dc_mod = int((sol.n_accept - mod.n_accept).abs().max())
    assert dy_mod <= 5e-4, dy_mod
    print(f"[generic] vs the Magnus loop path (MagnusModulated4, "
          f"{mod.path}) on the same y0: max|dy|={dy_mod:.3e} (<= 5e-4), "
          f"n_accept differs by at most {dc_mod}", flush=True)
    return k9


def k9_flop_bytes(table, counts_s, B, D, nbytes):
    """One K9 launch: the (D, D) products the data needs (two per
    commutator term, five per exponent and one per squaring, from the
    twin's counts) and a matvec per exponent; the samples, dt and x read
    once, y and err written once."""
    n_exp = len(table.exponents_flat)
    flop = (chain_products(table, counts_s) * 2 * D ** 3
            + B * n_exp * 2 * D * D)
    return flop, nbytes * (table.n_nodes * B * D * D + 2 * B * D + 2 * B)


def k9_timing_at(B: int, card: str):
    """K9 per launch for the Magnus-4 pair at B x 64c f32 on the generic
    path's samples, in turns with its twin, the stacked reference and the
    library yardstick (matrix_exp of both chains' exponents + bmm, in
    batches of 4096 exponents)."""
    table = tmagnus.magnus4_table(pair=True)
    node_ops, dt, xw = model_dense_inputs(B)
    D = 2 * DIM
    m, theta = dense_fast.ps_params(torch.float32)
    kw = dict(m=m, theta=theta, max_squarings=GEN_MAX_SQUARINGS)
    split = texp.DenseCplxSplit()
    x = Cplx(xw[:, :DIM].contiguous(), xw[:, DIM:].contiguous())

    def stacked():
        return dense_fast.run_stacked_chains(
            split, x, dt, node_ops, table, adaptive=True)

    n_lib = 4096

    def library():
        W = torch.cat([w for chain in table.exponents(node_ops, dt)
                       for w in chain])
        xs = xw.repeat(2, 1)[:, :, None]
        return torch.cat([torch.bmm(torch.linalg.matrix_exp(a), v)
                          for a, v in zip(W.split(n_lib), xs.split(n_lib))])

    counts_s = []
    torch_dense_chains(table, node_ops, dt, xw, counts=counts_s, **kw)
    y_k9, _ = fused_dense_chain_apply(table, node_ops, dt, xw, **kw)
    y_st, _ = stacked()
    y_lib = library()[:B, :, 0]
    torch.cuda.synchronize()
    d_st = float((torch.cat([y_st.re, y_st.im], 1) - y_k9).abs().max())
    d_lib = float((y_lib - y_k9).abs().max())
    assert d_st <= 1e-5 and d_lib <= 1e-5, (d_st, d_lib)
    inner = max(1, min(10, 8192 // B))
    runs = {"kernel": [], "plain": [], "stacked": [], "library": []}
    for _ in range(3):  # in turns
        runs["kernel"].append(timed_ms(lambda: fused_dense_chain_apply(
            table, node_ops, dt, xw, **kw), reps=1, inner=inner))
        runs["plain"].append(timed_ms(lambda: torch_dense_chains(
            table, node_ops, dt, xw, **kw), reps=1, inner=inner))
        runs["stacked"].append(timed_ms(stacked, reps=1, inner=inner))
        runs["library"].append(timed_ms(library, reps=1, inner=inner))
    k_ms, p_ms, s_ms, l_ms = (statistics.median(runs[k]) for k in runs)
    # what torch.matmul reaches on B such products, FP32 without TF32
    mm_ms = timed_ms(lambda: node_ops[0] @ node_ops[1], reps=3, inner=inner)
    flop, nbytes = k9_flop_bytes(table, counts_s, B, D, 4)
    b_ms, b_by = bound(flop, nbytes)
    sq = sum(int(s.sum()) for s in counts_s)
    print(f"[time] K9 one Magnus-4 pair step at B={B}, d={DIM}, f32 "
          f"({chain_products(table, counts_s)} products of {D}^3, {sq} of "
          f"them squarings): kernel {k_ms:.4f} ms "
          f"({flop / k_ms / 1e9:.2f} TFLOP/s), plain twin {p_ms:.4f} ms, "
          f"stacked reference (exponents, batched expm, matvecs) "
          f"{s_ms:.4f} ms (max|y - y_K9|={d_st:.2e}), library (matrix_exp + "
          f"bmm of both chains) {l_ms:.4f} ms (max|y - y_K9|={d_lib:.2e}); "
          f"runs " + ", ".join(f"{k} {[round(v, 4) for v in r]}"
                               for k, r in runs.items())
          + f"; bound {b_ms:.4f} ms by {b_by} ({flop / 1e9:.2f} GFLOP, "
          f"{nbytes / 1e6:.1f} MB), kernel at {b_ms / k_ms:.1%} of it; "
          f"torch.matmul on {B} products of {D}^3 {mm_ms:.4f} ms "
          f"({B * 2 * D ** 3 / mm_ms / 1e9:.2f} TFLOP/s) ({card})",
          flush=True)
    return k_ms, p_ms, b_ms, b_by, l_ms


def k9_timing_phase(card: str):
    """K9 per launch, and the generic path's solve beside its stacked
    reference, at the path's 4096 trajectories and at the 256 of the JAX
    package's record."""
    out = k9_timing_at(GEN_TRAJ, card)
    k9_timing_at(GEN_SMALL, card)
    for n in (GEN_TRAJ, GEN_SMALL):
        _, y0 = main_inputs(n)
        for fn, name in ((generic_solve, "K9 per iteration"),
                         (stacked_generic_solve, "stacked reference")):
            timed_solve(lambda: fn(y0),
                        f"generic path {n}x{DIM}c f32 Magnus4, {name}", card)
    return out


# ---------------------------------------------------------------------------
# The reversible adjoint (K6, K7, K8) on the JAX package's own adjoint
# configuration (benchmarks.py:741-781): PulseControl.make(d=64, seed=0,
# T=1.0, n_modes=6), so D = 128 widened and K' = 3 at order 4; 256 unit
# states from default_rng(3), target roll(psi0, 1), theta = 0.1 ones(6),
# 256 fixed Magnus-4 steps, f32
# ---------------------------------------------------------------------------

ADJ_B, ADJ_STEPS, ADJ_BIG = 256, 256, 4096
ADJ_CTL = StepControl(rtol=1e-5, min_dt=1e-5, max_dt=0.25, max_steps=512)
ADJ_H0 = 1e-2
ADJ_SAVES = (64, 128, 192, 256)
ADJ_ANCHOR = 64
ADJ_TWINS = ("torch_adjoint_row", "torch_adjoint_sweep_fwd",
             "torch_adjoint_sweep_bwd")


def adj_counts() -> tuple:
    """The launch counts of K6, K7, K8 and K4."""
    return (tadj.adjoint_bwd.launches, tadj.adjoint_sweep_fwd.launches,
            tadj.adjoint_sweep_bwd.launches, fused_chain_apply.launches)


class TwinCalls:
    """Counts the calls of the adjoint kernels' plain twins while active
    (the wrappers look them up in their module at each call)."""

    def __enter__(self):
        self.n = 0
        self.saved = {nm: getattr(tadj, nm) for nm in ADJ_TWINS}
        for nm, fn in self.saved.items():
            def counted(*a, _fn=fn, **k):
                self.n += 1
                return _fn(*a, **k)
            setattr(tadj, nm, counted)
        return self

    def __exit__(self, *exc):
        for nm, fn in self.saved.items():
            setattr(tadj, nm, fn)


def adjoint_inputs(dtype=torch.float32, n=ADJ_B):
    """The model, psi0, the target and theta of bench_adjoint_grad."""
    pc = PulseControl.make(d=DIM, seed=0, T=1.0, n_modes=6)
    rng = np.random.default_rng(3)
    psi0 = rng.standard_normal((n, DIM)) + 1j * rng.standard_normal((n, DIM))
    psi0 /= np.linalg.norm(psi0, axis=-1, keepdims=True)
    tgt = np.roll(psi0, 1, axis=-1)
    return (pc, from_complex(psi0, dtype, device="cuda"),
            from_complex(tgt, dtype, device="cuda"),
            torch.full((6,), 0.1, dtype=dtype, device="cuda"))


def adjoint_case(B, D, Kp, R, dtype, seed, scale):
    """A norm-preserving random basis (K', D, D) (antisymmetric: the
    reconstruction stays well conditioned), per-lane rows (B, K'), shared
    rows (R, K') and states (B, D)."""
    rng = np.random.default_rng(seed)
    S = rng.standard_normal((Kp, D, D)) / np.sqrt(D)

    def t(a):
        return torch.tensor(a, dtype=dtype, device="cuda")

    W = t(S - np.swapaxes(S, -1, -2))
    return (W, t(rng.standard_normal((B, Kp)) * scale),
            t(rng.standard_normal((R, Kp)) * scale),
            t(rng.standard_normal((B, D))), t(rng.standard_normal((B, D))))


def adj_operands(W):
    return (expmv.stacked_transpose(W), expmv.stacked_basis(W),
            expmv.basis_norms(W))


def rel(a, b) -> float:
    """max |a - b| over the finite entries of b, relative to max |b|."""
    ok = torch.isfinite(b)
    return float((a - b)[ok].abs().max() / b[ok].abs().max().clamp_min(1e-30))


# (B, D, K', R, row scale): the path's shape below theta, a ragged batch
# with rows past theta (squarings run), D a multiple of neither 32 nor 4
# (the products' checked loads), K' = 6 at a small D
ADJ_CASES = ((256, 128, 3, 8, 0.02), (77, 128, 3, 5, 0.25),
             (256, 102, 2, 4, 0.25), (33, 16, 6, 3, 0.5))


def adj_tolerances(dtype):
    """K6-K8 against their twins: f64 to summation order (FMA in the
    kernels, BLAS in the twins), f32 the same over up to 64 passes of 8
    terms; cbar relative to its largest entry."""
    return (1e-10, 1e-9) if dtype == torch.float64 else (1e-4, 1e-3)


def check_adjoint_case(B, D, Kp, R, dtype, seed, scale) -> dict:
    """K6, K7 and K8 on adjoint_case's inputs against their twins; raises
    on a disagreement. Returns the relative and absolute differences."""
    m, theta = _taylor_params(dtype)
    kw = dict(m=m, theta=theta, max_squarings=16)
    tol, cb_tol = adj_tolerances(dtype)
    W, c, c_all, x, a = adjoint_case(B, D, Kp, R, dtype, seed, scale)
    mt, ms, norms = adj_operands(W)
    _, n_pass = expmv.scale_rows(c[:, None], norms, theta, 16)
    _, n_row = expmv.scale_rows(c_all[:, None], norms, theta, 16)
    k6 = tadj.adjoint_bwd(c, x, a, mt, ms, norms, **kw)
    p6 = tadj.torch_adjoint_row(c, x, a, mt, ms, norms, **kw)
    y7 = tadj.adjoint_sweep_fwd(c_all, x, mt, norms, **kw)
    p7 = tadj.torch_adjoint_sweep_fwd(c_all, x, mt, norms, **kw)
    k8 = tadj.adjoint_sweep_bwd(c_all, y7, a, mt, ms, norms, **kw)
    p8 = tadj.torch_adjoint_sweep_bwd(c_all, y7, a, mt, ms, norms, **kw)
    torch.cuda.synchronize()
    d = dict(xn=rel(k6[0], p6[0]), an=rel(k6[1], p6[1]), cb6=rel(k6[2], p6[2]),
             y=rel(y7, p7), a0=rel(k8[0], p8[0]), cb8=rel(k8[1], p8[1]),
             k6=float(max((k6[j] - p6[j]).abs().max() for j in (0, 1))),
             k7=float((y7 - p7).abs().max()),
             k8=float((k8[0] - p8[0]).abs().max()),
             passes=(int(n_pass.min()), int(n_pass.max()), int(n_row.min()),
                     int(n_row.max())))
    assert max(d["xn"], d["an"], d["y"], d["a0"]) <= tol, d
    assert max(d["cb6"], d["cb8"]) <= cb_tol, d
    if scale > 0.1:  # rows past theta: squarings ran
        assert int(n_pass.max()) > 1 and int(n_row.max()) > 1, d
    return d


def check_adjoint_nan(dtype) -> None:
    """A NaN state row stays in its own row of x_n and cbar (K6) and of
    the reconstruction (K8, whose cbar sums it: NaN; a0 stays finite),
    as in the twins."""
    m, theta = _taylor_params(dtype)
    kw = dict(m=m, theta=theta, max_squarings=16)
    tol, _ = adj_tolerances(dtype)
    W, c, c_all, x, a = adjoint_case(9, 128, 3, 3, dtype, 90, 0.5)
    x[4, 7] = float("nan")
    mt, ms, norms = adj_operands(W)
    xn, an, cb = tadj.adjoint_bwd(c, x, a, mt, ms, norms, **kw)
    p6 = tadj.torch_adjoint_row(c, x, a, mt, ms, norms, **kw)
    a0, cb8 = tadj.adjoint_sweep_bwd(c_all, x, a, mt, ms, norms, **kw)
    p8 = tadj.torch_adjoint_sweep_bwd(c_all, x, a, mt, ms, norms, **kw)
    torch.cuda.synchronize()
    rows_nan = torch.isnan(xn).any(1)
    assert rows_nan.tolist() == [r == 4 for r in range(9)], rows_nan
    assert bool(torch.isnan(cb[4]).all()) and bool(
        torch.isfinite(cb[rows_nan.logical_not()]).all())
    assert bool(torch.isfinite(an).all()) and bool(
        torch.isfinite(a0).all()) and bool(torch.isnan(cb8).all())
    assert bool(torch.isnan(p8[1]).all())
    assert rel(xn, p6[0]) <= tol and rel(a0, p8[0]) <= tol


def adjoint_kernel_phase():
    """K6, K7 and K8 against their twins on the card, f32 and f64, on
    ADJ_CASES and a NaN state row. Returns the f32 max |d| at the path's
    shape (K6 x_n / a_n, K7 y, K8 a0)."""
    errs = {}
    for dtype in (torch.float64, torch.float32):
        for i, (B, D, Kp, R, scale) in enumerate(ADJ_CASES):
            d = check_adjoint_case(B, D, Kp, R, dtype, 80 + i, scale)
            p = d["passes"]
            print(f"[adjoint-kernels] {str(dtype)[6:]} B={B} D={D} K'={Kp} "
                  f"R={R}, passes per lane {p[0]}..{p[1]}, per row "
                  f"{p[2]}..{p[3]}: relative max|d| K6 x_n {d['xn']:.2e} a_n "
                  f"{d['an']:.2e} cbar {d['cb6']:.2e}; K7 y {d['y']:.2e}; K8 "
                  f"a0 {d['a0']:.2e} cbar {d['cb8']:.2e}", flush=True)
            if dtype == torch.float32 and i == 0:
                errs = {k: d[k] for k in ("k6", "k7", "k8")}
        check_adjoint_nan(dtype)
        print(f"[adjoint-kernels] {str(dtype)[6:]} NaN in row 4 of 9: K6 "
              f"x_n and cbar NaN in that row only, a_n finite; K8 a0 "
              f"finite, cbar NaN; as the twins", flush=True)
    return errs


def adjoint_oracle(pc, y0, tg, theta, n_steps):
    """infidelity and its theta / psi0 gradients through a scan of
    torch.linalg.matrix_exp steps over the same Magnus-4 rows, in the
    inputs' type (tests/test_adjoint.py:36-55's _oracle_solve)."""
    dtype = theta.dtype
    core = tdiff._adjoint_core(pc.basis_pair(dtype), pc.coeff_fn, order=4)
    th = theta.detach().clone().requires_grad_(True)
    yr = y0.re.detach().clone().requires_grad_(True)
    yi = y0.im.detach().clone().requires_grad_(True)
    t0, tf = (torch.tensor(v, dtype=torch.float64, device="cuda")
              for v in (0.0, pc.T))
    rows = tdiff._make_rows_all(core.cols, 4, n_steps)(th, t0, tf)
    U = torch.linalg.matrix_exp(torch.einsum(
        "rk,kij->rij", rows.to(dtype), core.W.to(dtype)))
    x = torch.cat([yr, yi], -1)
    for r in range(n_steps):
        x = x @ U[r].T
    value = 1.0 - torch.sum(pc.fidelity(Cplx(x[:, :DIM], x[:, DIM:]), tg))
    return value, torch.autograd.grad(value, (th, yr, yi))


def value_and_grads(pc, y0, tg, theta, n_steps=ADJ_STEPS, **kw):
    """The infidelity through the port's adjoint and its theta and psi0
    gradients."""
    th = theta.detach().clone().requires_grad_(True)
    yr = y0.re.detach().clone().requires_grad_(True)
    yi = y0.im.detach().clone().requires_grad_(True)
    if kw:
        ys = tdiff.adjoint_solve(pc.basis_pair(theta.dtype), pc.coeff_fn, th,
                                 Cplx(yr, yi), 0.0, pc.T, n_steps, **kw)
        value = sum(1.0 - torch.sum(pc.fidelity(Cplx(ys.re[j], ys.im[j]),
                                                tg))
                    for j in range(ys.re.shape[0])) if ys.re.ndim == 3 \
            else 1.0 - torch.sum(pc.fidelity(ys, tg))
    else:
        value = pc.infidelity(th, Cplx(yr, yi), tg, n_steps=n_steps,
                              dtype=theta.dtype)
    return value, torch.autograd.grad(value, (th, yr, yi))


def grad_diff(g, ref) -> float:
    """The largest of the gradients' max |d| relative to max |ref|."""
    return max(rel(a.to(b.dtype), b) for a, b in zip(g, ref))


def adjoint_path_phase():
    """The fixed-step adjoint at 256x64c f32 through PulseControl.infidelity
    and torch.autograd.grad: exactly one K7 and one K8 launch and no twin
    call; the f64 port against the f64 matrix_exp oracle at rtol 1e-8, the
    f32 port's difference from it; then 4 uniform saves (4 + 4 launches)
    and anchor_every=64. Returns (K7, K8) launches of the first run."""
    pc, y0, tg, theta = adjoint_inputs(torch.float32)
    reset_counts()
    with TwinCalls() as tw:
        value, grads = value_and_grads(pc, y0, tg, theta)
        torch.cuda.synchronize()
    k6, k7, k8, k4 = adj_counts()
    assert (k6, k7, k8, k4, tw.n) == (0, 1, 1, 0, 0), (k6, k7, k8, k4, tw.n)
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    _, y64, tg64, th64 = adjoint_inputs(torch.float64)
    v64, g64 = value_and_grads(pc, y64, tg64, th64)
    vo, go = adjoint_oracle(pc, y64, tg64, th64, ADJ_STEPS)
    torch.cuda.synchronize()
    d64, d32 = grad_diff(g64, go), grad_diff(grads, go)
    dv64 = abs(float(v64) - float(vo)) / abs(float(vo))
    dv32 = abs(float(value) - float(vo)) / abs(float(vo))
    assert d64 <= 1e-8 and dv64 <= 1e-8, (d64, dv64)
    print(f"[adjoint-path] {ADJ_B}x{DIM}c PulseControl infidelity, "
          f"{ADJ_STEPS} Magnus-4 steps, f32: value {float(value):.6f}, one "
          f"K7 and one K8 launch (K6 {k6}, K4 {k4}), no twin call; f64 port "
          f"vs f64 matrix_exp oracle: value {dv64:.2e}, gradients (theta, "
          f"psi0) {d64:.2e} relative (<= 1e-8); f32 port vs the f64 oracle: "
          f"value {dv32:.2e}, gradients {d32:.2e} relative; theta grad "
          f"{[round(float(v), 5) for v in grads[0]]}", flush=True)

    reset_counts()
    vs, gs = value_and_grads(pc, y0, tg, theta, save_at_steps=ADJ_SAVES)
    torch.cuda.synchronize()
    k6s, k7s, k8s, _ = adj_counts()
    assert (k6s, k7s, k8s) == (0, len(ADJ_SAVES), len(ADJ_SAVES)), (
        k6s, k7s, k8s)
    vs64, gs64 = value_and_grads(pc, y64, tg64, th64,
                                 save_at_steps=ADJ_SAVES)
    ds = grad_diff(gs, gs64)
    assert ds <= 1e-3, ds
    reset_counts()
    va, ga = value_and_grads(pc, y0, tg, theta, anchor_every=ADJ_ANCHOR)
    torch.cuda.synchronize()
    k6a, k7a, k8a, _ = adj_counts()
    n_seg = ADJ_STEPS // ADJ_ANCHOR
    assert (k6a, k7a, k8a) == (0, n_seg, n_seg), (k6a, k7a, k8a)
    assert float(va) == float(value), (float(va), float(value))
    da = grad_diff(ga, grads)
    assert da <= 1e-3, da
    print(f"[adjoint-path] {len(ADJ_SAVES)} uniform saves: {k7s} K7 + {k8s} "
          f"K8 launches, loss over the saves {float(vs):.6f}, gradients "
          f"{ds:.2e} from the f64 port's (<= 1e-3); anchor_every="
          f"{ADJ_ANCHOR}: {k7a} + {k8a} launches, the same value, gradients "
          f"{da:.2e} from the plain sweep's (<= 1e-3)", flush=True)
    return k7, k8


def adjoint_training_phase():
    """Five Adam(lr=0.05) steps on the f32 infidelity: the loss falls."""
    pc, y0, tg, theta = adjoint_inputs(torch.float32)
    th = theta.clone().requires_grad_(True)
    opt = torch.optim.Adam([th], lr=0.05)
    losses = []
    for _ in range(5):
        opt.zero_grad()
        loss = pc.infidelity(th, y0, tg, n_steps=ADJ_STEPS,
                             dtype=torch.float32)
        loss.backward()
        opt.step()
        losses.append(float(loss))
    assert losses[-1] < losses[0] and all(np.isfinite(losses)), losses
    print(f"[adjoint-train] five Adam(lr=0.05) steps on the infidelity: "
          f"{[round(v, 6) for v in losses]}", flush=True)


def recorded_times(basis, pc, y0, theta):
    """The adaptive forward's per-iteration times (n_it + 1, B), by the
    adjoint's own forward (K4 per iteration: bitwise the same steps)."""
    core = tdiff._adjoint_core(basis, pc.coeff_fn, order=4)
    plan = tdiff._AdaptivePlan(None, core, basis, pc.coeff_fn, ADJ_CTL)
    t0, tf, h0 = (torch.tensor(v, dtype=torch.float32, device="cuda")
                  for v in (0.0, 1.0, ADJ_H0))
    return tdiff._adaptive_forward(plan, theta, torch.cat([y0.re, y0.im], -1),
                                   t0, tf, h0)[2]


def adjoint_adaptive_phase():
    """adjoint_solve_adaptive at 256x64c f32, Magnus-4, rtol 1e-5: all
    lanes DONE, one K4 launch per forward iteration, one K6 launch per
    replayed iteration, the gradient against the frozen-step-sequence
    f64 matrix_exp oracle (tests/test_adjoint.py:169-250). Returns the K6
    launches and the recorded times (n_it + 1, B)."""
    pc, y0, tg, theta = adjoint_inputs(torch.float32)
    basis = pc.basis_pair(torch.float32)
    th = theta.clone().requires_grad_(True)
    yr, yi = (v.clone().requires_grad_(True) for v in (y0.re, y0.im))
    reset_counts()
    with TwinCalls() as tw:
        yf, status = tdiff.adjoint_solve_adaptive(
            basis, pc.coeff_fn, th, Cplx(yr, yi), 0.0, 1.0, ctl=ADJ_CTL,
            h0=ADJ_H0, return_status=True)
        torch.cuda.synchronize()
        k4_fwd = fused_chain_apply.launches
        value = 1.0 - torch.sum(pc.fidelity(yf, tg))
        grads = torch.autograd.grad(value, (th, yr, yi))
        torch.cuda.synchronize()
    k6, k7, k8, k4 = adj_counts()
    assert bool((status == DONE).all()), "adaptive lanes not DONE"
    ts = recorded_times(basis, pc, y0, theta)
    n_it = ts.shape[0] - 1
    assert (k4_fwd, k4, k6, k7, k8, tw.n) == (n_it, n_it, n_it, 0, 0, 0), (
        k4_fwd, k4, k6, k7, k8, tw.n, n_it)

    # the oracle: matrix_exp steps over the recorded times in f64
    _, y64, tg64, th64 = adjoint_inputs(torch.float64)
    core = tdiff._adjoint_core(pc.basis_pair(torch.float64), pc.coeff_fn,
                               order=4)
    tho = th64.clone().requires_grad_(True)
    xr, xi = (v.clone().requires_grad_(True) for v in (y64.re, y64.im))
    t64 = ts.to(torch.float64)
    x = torch.cat([xr, xi], -1)
    for r in range(n_it):
        c = torch.func.vmap(lambda t_, d_: core.cols(tho, t_, d_))(
            t64[r], t64[r + 1] - t64[r])
        U = torch.linalg.matrix_exp(torch.einsum("bk,kij->bij", c, core.W))
        x = torch.bmm(U, x[:, :, None])[:, :, 0]
    vo = 1.0 - torch.sum(pc.fidelity(Cplx(x[:, :DIM], x[:, DIM:]), tg64))
    go = torch.autograd.grad(vo, (tho, xr, xi))
    d = grad_diff(grads, go)
    dv = abs(float(value) - float(vo)) / abs(float(vo))
    assert d <= 1e-3 and dv <= 1e-4, (d, dv)
    n_acc = (torch.diff(ts, dim=0) > 0).sum(0)
    print(f"[adjoint-adaptive] {ADJ_B}x{DIM}c Magnus-4 rtol="
          f"{ADJ_CTL.rtol:g}, f32: all DONE, {n_it} iterations, "
          f"{int(n_acc.min())}..{int(n_acc.max())} accepted steps per lane; "
          f"K4 {k4_fwd} == forward iterations, K6 {k6} == replayed "
          f"iterations, no twin call; vs the frozen-sequence f64 oracle: "
          f"value {dv:.2e}, gradients {d:.2e} relative", flush=True)
    return k6, ts


def adj_flops(passes: int, D: int, Kp: int, m: int, reverse: bool,
              formed: int, rows: int = 0, idle: int = 0) -> float:
    """Operations the function needs: the exponent A = sum_k c_k W_k formed
    once per distinct nonzero row (``formed``: per shared row in K7 / K8,
    per trajectory row in K6), then per Taylor term of ``passes``
    trajectory-row passes one (D, D) action per chain with its division
    and running sum: the state chain alone forward; in reverse the x, a
    and w chains, the K' stacked W_k w and the K' Fréchet u-chains
    (2 K' + 3 actions); per trajectory row (``rows``) the K' inner
    products of cbar. A zero row (``idle`` trajectory rows, an iteration
    that did not advance) needs only the K' actions of cbar_k =
    <a, W_k x>."""
    act = 2 * D * D + 2 * D
    term = (2 * Kp + 3 if reverse else 1) * act
    return (passes * m * term + (formed + idle) * 2 * Kp * D * D
            + rows * 2 * Kp * D)


def adj_library(W, c_all, x, a, reverse: bool, per_lane: bool = False):
    """The library yardstick: matrix_exp of the exponents M = sum_k c_k W_k
    and products with the states; in reverse also matrix_exp of -M and of
    M^T and of the (2D)-wide blocks [[M, W_k], [0, M]] for the Fréchet
    terms. ``per_lane``: one exponent per trajectory (K6's rows)."""
    M = torch.einsum("rk,kij->rij", c_all, W)
    D = W.shape[1]
    if not reverse:
        U = torch.linalg.matrix_exp(M)
        for r in range(M.shape[0]):
            x = x @ U[r].T
        return x
    Kp = W.shape[0]
    Ui = torch.linalg.matrix_exp(-M)
    Ut = torch.linalg.matrix_exp(M.transpose(-1, -2))
    blk = torch.zeros(M.shape[0], Kp, 2 * D, 2 * D, dtype=M.dtype,
                      device=M.device)
    blk[:, :, :D, :D] = M[:, None]
    blk[:, :, D:, D:] = M[:, None]
    blk[:, :, :D, D:] = W
    F = torch.linalg.matrix_exp(blk)[:, :, :D, D:]
    if per_lane:
        xn = torch.bmm(Ui, x[:, :, None])[:, :, 0]
        an = torch.bmm(Ut, a[:, :, None])[:, :, 0]
        cb = torch.einsum("bkij,bj,bi->bk", F, xn, a)
        return xn, an, cb
    cb = []
    for r in range(M.shape[0] - 1, -1, -1):
        x = x @ Ui[r].T
        cb.append(torch.einsum("kij,bj,bi->k", F[r], x, a))
        a = a @ Ut[r].T
    return a, torch.stack(cb[::-1])


def adj_timing_at(B: int, card: str, basis_f32, c_all, ts):
    """K7, K8 and K6 per launch at B x 64c f32 on the path's basis: the
    fixed-step rows c_all (R, K'); for K6 the adaptive path's own per-lane
    rows from its recorded times ts (n_it + 1, 256), its lanes repeated
    above 256, timed as the path runs them: one replay of n_it launches in
    reverse, per launch its mean. At the path's batch in turns with their
    twins and the library yardstick; above it the kernels alone."""
    pc, y0, _, theta = adjoint_inputs(torch.float32, B)
    core = tdiff._adjoint_core(basis_f32, pc.coeff_fn, order=4)
    x = torch.cat([y0.re, y0.im], -1)
    rng = np.random.default_rng(9)
    a = torch.tensor(rng.standard_normal(x.shape) / np.sqrt(x.shape[1]),
                     dtype=torch.float32, device="cuda")
    mt, ms, norms, m, th_t = core.operands(x)
    kw = dict(m=m, theta=th_t, max_squarings=16)
    D, Kp, R = x.shape[1], core.Kp, c_all.shape[0]
    n_it = ts.shape[0] - 1
    lanes = torch.arange(B, device="cuda") % ts.shape[1]
    t_r, dt_r = ts[:-1][:, lanes], (ts[1:] - ts[:-1])[:, lanes]
    c_lane = torch.func.vmap(lambda t_, d_: core.cols(theta, t_, d_))(
        t_r.reshape(-1), dt_r.reshape(-1)).reshape(n_it, B, Kp).contiguous()
    W = core.W

    def replay(row):
        def run():
            xr, ar = x, a
            for r in range(n_it - 1, -1, -1):
                xr, ar, _ = row(c_lane[r], xr, ar)
            return xr, ar
        return run

    # (kernel, plain, library, the kernel's and the library's first launch,
    # launches per timed call)
    cases = {
        "K7": (lambda: tadj.adjoint_sweep_fwd(c_all, x, mt, norms, **kw),
               lambda: tadj.torch_adjoint_sweep_fwd(c_all, x, mt, norms,
                                                    **kw),
               lambda: adj_library(W, c_all, x, a, False), None, 1),
        "K8": (lambda: tadj.adjoint_sweep_bwd(c_all, x, a, mt, ms, norms,
                                              **kw),
               lambda: tadj.torch_adjoint_sweep_bwd(c_all, x, a, mt, ms,
                                                    norms, **kw),
               lambda: adj_library(W, c_all, x, a, True), None, 1),
        "K6": (replay(lambda c, xr, ar: tadj.adjoint_bwd(c, xr, ar, mt, ms,
                                                         norms, **kw)),
               replay(lambda c, xr, ar: tadj.torch_adjoint_row(
                   c, xr, ar, mt, ms, norms, **kw)),
               replay(lambda c, xr, ar: adj_library(W, c, xr, ar, True,
                                                    per_lane=True)),
               (lambda: tadj.adjoint_bwd(c_lane[-1], x, a, mt, ms, norms,
                                         **kw),
                lambda: adj_library(W, c_lane[-1], x, a, True,
                                    per_lane=True)), n_it),
    }
    with_lib = B <= ADJ_B
    out = {}
    for name, (kern, plain, lib, first, n_launch) in cases.items():
        kern_1, lib_1 = first or (kern, lib)
        got = kern_1()
        d_lib = None
        if with_lib:
            lb = lib_1()
            lb = (lb,) if name == "K7" else lb
            gk = (got,) if name == "K7" else got
            d_lib = max(rel(u, v) for u, v in zip(gk, lb))
            assert d_lib <= 1e-3, (name, d_lib)
        torch.cuda.synchronize()
        runs = {"kernel": [], "plain": [], "library": []}
        for _ in range(3):  # in turns
            runs["kernel"].append(timed_ms(kern, reps=1) / n_launch)
            if with_lib:
                runs["plain"].append(timed_ms(plain, reps=1) / n_launch)
                runs["library"].append(timed_ms(lib, reps=1) / n_launch)
        k_ms = statistics.median(runs["kernel"])
        p_ms = statistics.median(runs["plain"]) if with_lib else None
        l_ms = statistics.median(runs["library"]) if with_lib else None
        if name == "K6":
            # per launch: the mean over the replay of each row's own bound
            passes = formed = 0
            flop = nbytes = b_sum = 0.0
            row_bytes = 4 * (5 * B * D + 2 * B * Kp + 2 * Kp * D * D)
            for r in range(n_it):
                nz = c_lane[r].abs().sum(-1) > 0
                _, n_pass = expmv.scale_rows(c_lane[r][:, None], norms,
                                             th_t, 16)
                p_r, f_r = int(n_pass[nz].sum()), int(nz.sum())
                fl = adj_flops(p_r, D, Kp, m, True, f_r, B, B - f_r)
                passes, formed = passes + p_r, formed + f_r
                flop, nbytes = flop + fl, nbytes + row_bytes
                b_sum += bound(fl, row_bytes)[0]
            b_by = bound(flop, nbytes)[1]
            b_ms, flop, nbytes = b_sum / n_it, flop / n_it, nbytes / n_it
            what = (f", the adaptive path's per-lane rows over {n_it} "
                    f"launches: {formed} advancing trajectory rows, "
                    f"{passes} passes, {passes / max(formed, 1):.3f} a row, "
                    f"{n_it * B - formed} rows with dt = 0")
        else:
            _, n_pass = expmv.scale_rows(c_all[:, None], norms, th_t, 16)
            passes = int(n_pass.sum()) * B
            nbytes = 4 * ((2 if name == "K7" else 3) * B * D + R * Kp
                          + (1 if name == "K7" else 2) * Kp * D * D)
            flop = adj_flops(passes, D, Kp, m, name == "K8", R,
                             R * B if name == "K8" else 0)
            b_ms, b_by = bound(flop, nbytes)
            what = f", R={R} rows ({passes} trajectory-row passes)"
        print(f"[time] {name} at B={B}, d={DIM}, K'={Kp}, f32{what}: kernel "
              f"{k_ms:.4f} ms per launch ({flop / k_ms / 1e9:.2f} TFLOP/s)"
              + (f", plain twin {p_ms:.4f} ms, library {l_ms:.4f} ms (max "
                 f"rel |d| {d_lib:.2e})" if with_lib else "")
              + f"; runs " + ", ".join(f"{k} {[round(v, 4) for v in r]}"
                                       for k, r in runs.items() if r)
              + f"; bound {b_ms:.4f} ms by {b_by} ({flop / 1e9:.2f} GFLOP, "
              f"{nbytes / 1e6:.2f} MB a launch), kernel at {b_ms / k_ms:.1%} "
              f"of it ({card})", flush=True)
        out[name] = (k_ms, p_ms, b_ms, b_by, l_ms)
    return out


def adjoint_timing_phase(card: str, ts):
    """The kernels per launch at the path's 256 and at 4096 trajectories
    (K6 on the adaptive path's recorded times ``ts``),
    the value-and-grad wall (median of 3 after a warm run) with adjoint
    steps/s = 2 n_steps B / wall (benchmarks.py:776), and peak memory at
    256 and 1024 steps."""
    pc, y0, tg, theta = adjoint_inputs(torch.float32)
    basis = pc.basis_pair(torch.float32)
    core = tdiff._adjoint_core(basis, pc.coeff_fn, order=4)
    t0, tf = (torch.tensor(v, dtype=torch.float64, device="cuda")
              for v in (0.0, pc.T))
    c_all = tdiff._make_rows_all(core.cols, 4, ADJ_STEPS)(
        theta, t0, tf).to(torch.float32).contiguous()
    out = adj_timing_at(ADJ_B, card, basis, c_all, ts)
    adj_timing_at(ADJ_BIG, card, basis, c_all, ts)

    def vg():
        return value_and_grads(pc, y0, tg, theta)

    vg()
    walls = timed_runs(vg)
    wall = statistics.median(walls)
    peaks = {}
    for n in (ADJ_STEPS, 4 * ADJ_STEPS):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        live = torch.cuda.memory_allocated()  # what earlier phases hold
        value_and_grads(pc, y0, tg, theta, n_steps=n)
        torch.cuda.synchronize()
        peaks[n] = ((torch.cuda.max_memory_allocated() - live) / 2 ** 20,
                    torch.cuda.max_memory_allocated() / 2 ** 20)
    print(f"[time] adjoint value-and-grad {ADJ_B}x{DIM}c f32, {ADJ_STEPS} "
          f"Magnus-4 steps (one K7 + one K8 launch): median wall "
          f"{wall:.3f} ms of {[round(w, 3) for w in walls]}, "
          f"{2 * ADJ_STEPS * ADJ_B / (wall / 1e3):.4e} adjoint steps/s "
          f"(fwd + bwd counted); peak memory above what was allocated "
          f"before (total peak) "
          + ", ".join(f"{v:.2f} MiB ({t:.1f}) at n_steps={n}"
                      for n, (v, t) in peaks.items())
          + f" ({card})", flush=True)
    return out


def main() -> None:
    t_start = time.perf_counter()
    card = device_phase()
    build_phase(card)
    k1_err = step_phase()
    norm_phase()
    k2_err = loop_kernel_phase()
    k4_err = chain_step_phase()
    k5_err = chain_loop_kernel_phase()
    k9_err = dense_chain_phase()
    k1_launches = main_path_phase(card)
    k2_launches = loop_path_phase(card)
    k5_launches, loop_sol = magnus_loop_path_phase()
    k4_launches = magnus_step_path_phase(loop_sol)
    lz_path_phase()
    k9_launches = generic_path_phase()
    adj_errs = adjoint_kernel_phase()
    k7_launches, k8_launches = adjoint_path_phase()
    adjoint_training_phase()
    k6_launches, adaptive_ts = adjoint_adaptive_phase()
    k1 = timing_phase(card)
    k2 = loop_timing_phase(card)
    k4 = k4_timing_phase(card)
    k5 = k5_timing_phase(card)
    k9 = k9_timing_phase(card)
    adj = adjoint_timing_phase(card, adaptive_ts)
    print(f"[done] {time.perf_counter() - t_start:.1f} s", flush=True)
    print(card, flush=True)
    rows = []
    for name, launches, err, (ms, plain_ms, b_ms, b_by, *lib) in (
            ("fused_rk_step", k1_launches, k1_err, k1),
            ("fused_loop", k2_launches, k2_err, k2),
            ("rk_step_tile", k2_launches, k2_err, k2),
            ("fused_chain_apply", k4_launches, k4_err, k4),
            ("chain_step_tile", k5_launches, k5_err, k5),
            ("fused_dense_chain_apply", k9_launches, k9_err, k9),
            ("adjoint_bwd", k6_launches, adj_errs["k6"], adj["K6"]),
            ("adjoint_sweep_fwd", k7_launches, adj_errs["k7"], adj["K7"]),
            ("adjoint_sweep_bwd", k8_launches, adj_errs["k8"], adj["K8"])):
        source, replaces = KERNELS[name]
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib[0] if lib else None,
        })
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()

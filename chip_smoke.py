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
* the order-6 and commutator-free paths: adaptive Magnus-6
  (``exp.MagnusModulated6``, three exponentials per chain) and CFM-4
  (``exp.CFM4Modulated``, two) on the same model over 16 384 trajectories,
  in one loop launch (K2 with K5) and per step (K4), and per step at the
  JAX package's own record of 256; K4 and K5 held against their twins for
  these and BLANES17's four rows over three nodes;
* the Landau-Zener path: 16 384 fixed-step exponential-midpoint sweeps of
  a 2-level avoided crossing in the loop kernel's fixed-step mode, held
  against the closed-form transition probability;
* the generic dense path: adaptive Magnus-4 (``exp.Magnus4`` over
  ``DenseCplxSplit``) with a black-box operator callback over 4 096
  trajectories of the same model, every trajectory with its own dense
  operator samples, a launch of the dense chain kernel
  ``fused_dense_chain_apply`` (K9) per driver iteration; the same solve
  with each step by a stacked batched ``expm`` (the library reference) and
  against the Magnus loop path;
* the reversible adjoint (K6, K7, K8) on ``PulseControl``: fixed-step,
  with saves and anchors, and adaptive at Magnus orders 4 and 6 and over
  CFM-4 rows, against f64 ``matrix_exp`` oracles;
* ``Lindblad`` open-system ensembles (256 density matrices, d = 8) with
  Magnus-4 and Magnus-6, the trace kept;
* events and dense output: the loop kernel with its event / dense switch
  against its twin on every step (f64 and f32); the RK loop path with
  Re z_3 (three located crossings) and a terminal population threshold,
  against the host driver with K1 per step, and the RK main path at
  16 384 with the events in the host driver against the loop kernel
  ([events-loop]); the Magnus-4 and CFM-4 loop paths with the same
  events against the per-step path ([events-chain]); 16 384 Landau-Zener
  sweeps with a terminal threshold and, at v = 0, five crossings counted
  and three located at their closed-form times ([events-lz]); dense
  output at the nine save times on the RK, Magnus-4 and CFM-4 loop paths
  ([dense-loop]) and on the Magnus-4 per-step path ([dense-step]);
* black-box operators through ``exp.auto_modulated``: K4 and K5 against
  their twins over 3, 5 and 8 basis terms (K' up to 36) on every recipe
  and with K2's event / dense switch; the black-box DrivenDense at 16 384
  and 256 on the loop route (K2 with K5 sampling the fitted ChebForm) and
  the per-step route (K4), against the declared-CoeffForm loop and the
  generic path (K9) ([auto]); 1024 black-box Landau-Zener sweeps
  ([auto-lz]); an I/Q-driven qudit (three terms) at 16 384 on both routes
  and an eight-term drive in one loop solve ([k0]).

Then it times the paths and each kernel against its plain version, its
bound and, for K4 (also at K' = 6 and 36, with the many-term body's
masked share of passes), K6-K8 (at 256 and 4096; K7 and K8 with their
launch shapes and ptxas lines, and the value-and-grad wall with K7's and
K8's shares of it) and K9, a library yardstick. Every phase raises on failure, so
any failure exits non-zero; without a CUDA card it exits non-zero before
any result.

Output: progress lines, then the card's name and power limit as
nvidia-smi reports them, then one JSON line describing each kernel, and
last one JSON line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import math
import re
import statistics
import subprocess
import time

import numpy as np
import torch

from vec_ode_tpu_torch import diff as tdiff
from vec_ode_tpu_torch import (DONE, DONE_EVENT, DOPRI5, ERR_MAX_STEPS,
                               ERR_STALLED, RKF45, StepControl, driver, lc)
from vec_ode_tpu_torch import tableaus as ttab
from vec_ode_tpu_torch import exp as texp
from vec_ode_tpu_torch.exp import (CFM4Modulated, CFMModulated,
                                   MagnusModulated4, MagnusModulated6,
                                   MidpointModulated)
from vec_ode_tpu_torch.exp import cfm as tcfm
from vec_ode_tpu_torch.exp import dense_fast
from vec_ode_tpu_torch.exp import magnus as tmagnus
from vec_ode_tpu_torch.exp import split_solvers as tsplit
from vec_ode_tpu_torch.dense import hermite_from_endpoints
from vec_ode_tpu_torch.events import (Event, EventConfig, LinearObservable,
                                     QuadraticObservable)
from vec_ode_tpu_torch.exp.modulated import _taylor_params
from vec_ode_tpu_torch.models import (DrivenDense, LandauZener, Lindblad,
                                      PulseControl)
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
                                              init_carries, init_dense_carry,
                                              init_event_carry, loop_solution,
                                              torch_fused_loop)
from vec_ode_tpu_torch.ops.fused_rk import (FusedModulatedLinearRK,
                                            fused_rk_step, torch_rk_step)
from vec_ode_tpu_torch.parallel import ensemble_solve
from vec_ode_tpu_torch.parallel.ensemble import _batched_dense_fallback

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
    chain step and its KP; the loop kernel with its events / dense switch
    on) of the kernel, from ptxas's report in its build log."""
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
            if m.group(1).endswith("gemm") or m.group(1).endswith(
                    "sweep_bwd"):  # K4's many-term body, K7, K8
                inst += (" K0>2 many-term" if name == "chain_expmv" else "")
                inst += f" RM={kp.group(1)}"
            elif "RKLoopStep" in m.group(3):
                inst += " rk"
            elif kp:  # KP 0: the k-outer body, K0 > 2, K' at run time
                inst += " K0>2" if kp.group(1) == "0" else f" KP={kp.group(1)}"
            if name == "fused_loop" and "Lb1E" in m.group(3):
                inst += " events/dense"
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if inst and m:
            spill = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if inst and m:
            out.append(f"{inst} {m.group(1)} registers, {spill} B spilled")
            inst = None
    return "; ".join(out)


def ptxas_of(name: str, key: str) -> str:
    """The ptxas_summary items of library ``name`` that contain ``key``."""
    return "; ".join(v for v in ptxas_summary(name).split("; ") if key in v)


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


# BLANES17's four exponentials over the three Gauss-Legendre nodes, with an
# exponential-midpoint comparison row (zero alphas; three zero pad rows)
BLANES_ERR = ((0.0, 1.0, 0.0),)


def r_stepper(kind, op, norm=None):
    """The adaptive Magnus-4 pair, and the steppers with R > 1
    exponentials per chain: Magnus-6 (adaptive or fixed), CFM-4 (adaptive
    or fixed), BLANES17 with BLANES_ERR."""
    if kind == "magnus4":
        return MagnusModulated4(op, norm=norm)
    if kind.startswith("magnus6"):
        return MagnusModulated6(op, adaptive=kind == "magnus6", norm=norm)
    if kind.startswith("cfm4"):
        return CFM4Modulated(op, adaptive=kind == "cfm4", norm=norm)
    assert kind == "blanes", kind
    return CFMModulated(op, alpha=ttab.BLANES17_R4_J4,
                        c=ttab.C_GAUSS_LEGENDRE_6, alpha_err=BLANES_ERR,
                        norm=norm)


def chain_stepper(dtype, d=DIM, fast_error=False, midpoint=False, norm=None,
                  lz=False, kind="magnus4", k0=None):
    """A Magnus-4 (or midpoint, or ``kind`` of r_stepper) stepper on
    DrivenDense(d, seed 0), on the Landau-Zener operator, or (``k0``) on
    the k0-term drive with its Chebyshev form (multi_op), on the card."""
    if k0 in ("auto", "iq"):  # recovered from a black box, in f32
        assert dtype == torch.float32, dtype
        op = auto_drive_op() if k0 == "auto" else iq_op()
    elif k0 is not None:
        op = multi_op(k0, dtype, multi_cheb(k0))
    else:
        model = LandauZener(**LZ) if lz else DrivenDense.make(d=d, seed=0)
        op = model.modulated(dtype, device="cuda")
    if kind != "magnus4":
        return r_stepper(kind, op, norm)
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
    samples = [st.op.coeff_fn(tn).contiguous() for tn in
               node_times(st._recipe, t, dt, st._chains, st._table)]
    return samples, dt, xw


def chain_pair(st, samples, dt, xw, wnorm=None, kernel=True):
    """K4 and its twin on the same inputs: ((y, err), (y, err)); without
    ``kernel`` the twin's alone."""
    mt, norms, m, theta = chain_operands(st, xw.dtype)
    kw = dict(recipe=st._recipe, C=st._chains, m=m, theta=theta,
              wnorm=wnorm, table=st._table)
    want = torch_chain_step(samples, dt, xw, mt, norms, **kw)
    if not kernel:
        return want
    return fused_chain_apply(samples, dt, xw, mt, norms, **kw), want


def check_chain_step(B, dtype, label, dt_range=(1e-3, 5e-2), wnorm=None,
                     x_rel=1e-12, make=None, **stkw) -> tuple:
    """K4 against torch_chain_step on the card. The state: f64 to ``x_rel``
    of its scale (only the products' summation order differs), f32 to
    bench.py's on-device limit 1e-5. The error norm per row: f64 within
    1e-9 of it plus 1e-18; f32 within 1e-4 of it plus a floor of four
    times the plain f32 step's largest deviation from the plain f64 step
    on the same inputs (the pair's error is a difference of two chains).
    Returns (max |dy|, rows on which a norm 10% off would fail). ``make``:
    dtype -> the stepper, in place of chain_stepper(dtype, **stkw)."""
    make = make or (lambda dt_: chain_stepper(dt_, **stkw))
    st = make(dtype)
    samples, dt, xw = chain_inputs(st, B, dtype, dt_range=dt_range)
    (yk, ek), (yp, ep) = chain_pair(st, samples, dt, xw, wnorm)
    torch.cuda.synchronize()
    has_err = ep is not None
    if not has_err:
        ep = torch.zeros_like(ek)
    if dtype == torch.float64:
        x_lim, e_lim, floor = x_rel * max(float(yp.abs().max()), 1.0), \
            1e-9 * ep.abs() + 1e-18, 1e-18
    else:
        st64 = make(torch.float64)
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
    # R > 1 exponentials per chain
    "magnus6": dict(kind="magnus6"),
    "magnus6_save_grid": dict(kind="magnus6",
                              grid=(0.0, 0.075, 0.15, 0.225, 0.3)),
    "magnus6_weighted_l2": dict(kind="magnus6", norm=("l2", True)),
    "magnus6_fixed": dict(kind="magnus6_fixed", h0=0.05),
    "magnus6_h0_per_row": dict(kind="magnus6", h0="per_row"),
    "cfm4": dict(kind="cfm4"),
    "cfm4_scaled_error": dict(kind="cfm4", ctl=dict(scaled_error=True,
                                                    rtol=1e-6, atol=1e-9)),
    "cfm4_weighted_max": dict(kind="cfm4", norm=("max", False)),
    "cfm4_fixed": dict(kind="cfm4_fixed", grid=(0.0, 0.1, 0.3), h0=0.03),
    "blanes": dict(kind="blanes", ctl=dict(pi=True)),
    "magnus6_path": dict(kind="magnus6", grid=(0.0, TF)),
    "cfm4_path": dict(kind="cfm4", grid=(0.0, TF)),
}
# the cases run at their path's batch (the tiling the path runs) alone
CHAIN_PATHS = ("lz_path", "magnus_path", "magnus6_path", "cfm4_path")
# the cases of the steppers with R > 1 exponentials per chain
R_CASES = [k for k, c in CHAIN_CASES.items() if "kind" in c]


def chain_loop_case(name, B, dtype, seed=11):
    """(carries, step, ctl, adaptive, expected status) of a CHAIN_CASES
    entry: unit states, t in [0, 0.3] unless the case says otherwise."""
    case = CHAIN_CASES[name] if name in CHAIN_CASES else K0_LOOP_CASES[name]
    ctl = StepControl(**{**CHAIN_BASE, **case.get("ctl", {})})
    norm = case.get("norm")
    st = chain_stepper(
        dtype, fast_error=case.get("fast_error", False),
        midpoint=case.get("midpoint", False), lz=case.get("lz", False),
        kind=case.get("kind", "magnus4"), k0=case.get("k0"),
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
                     wnorm=None if norm is None else st._wnorm_of(y0),
                     table=st._table)
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
        if name not in CHAIN_PATHS and name not in R_CASES:
            check_chain_loop_pair(name, 1000, torch.float64)   # ragged tiles
    for name in ("plain", "save_grid", "pi", "lz_magnus4", "lz_midpoint"):
        check_chain_loop_pair(name, LOOP_TRAJ, torch.float32)
    check_chain_persistent_is_chunked("save_grid", 1000, torch.float64)
    check_chain_persistent_is_chunked("lz_midpoint", LOOP_TRAJ,
                                      torch.float32)
    # both paths' own inputs at their batch, so at the tiles they run
    check_chain_loop_pair("lz_path", N_TRAJ, torch.float32)
    return check_chain_loop_pair("magnus_path", N_TRAJ, torch.float32)


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
    columns. K_c counts the basis terms chain c's rows can hold nonzero:
    the Magnus-4 pair's comparison chain (c = 1) has zero commutator
    columns, which the kernels multiply all the same (so that a non-finite
    state reaches the error) and which only ``zero_columns`` counts."""
    Kp = expmv.n_working_terms(recipe, K0)
    flop = 0
    for c, n in enumerate(passes):
        k = K0 if c == 1 and recipe == "magnus4" and not zero_columns else Kp
        flop += n * m * (2 * D * k * D + 2 * k * D + 2 * D)
    return flop + fast_rows * 2 * D * (Kp - K0) * D


def work_passes(rows, n_pass, recipe, C, stepping=None) -> list:
    """The Taylor passes per chain, summed over trajectories and rows, that
    the data needs: a declared identity row, a zero row (CFM's pad rows)
    and, with ``stepping``, a row that does not step need none, though the
    kernels run one pass of a zero row."""
    need = rows.abs().sum(-1) > 0
    for c, r in expmv.identity_rows(recipe, C):
        need[:, c, r] = False
    if stepping is not None:
        need &= stepping[:, None, None]
    return (n_pass * need).sum((0, 2)).tolist()


def passes_needed(st, samples, dt) -> list:
    """The Taylor passes these inputs need per chain (the twin's scaling
    rule; work_passes)."""
    mt, norms, m, theta = chain_operands(st, dt.dtype)
    rows = expmv.chain_rows(st._recipe, samples, dt, st._chains, st._table)
    _, n_pass = expmv.scale_rows(rows, norms, theta, st.max_squarings)
    return work_passes(rows, n_pass, st._recipe, st._chains)


# K4's rows per block at 16384 x 128 in the k-outer body, which K4 ran for
# K0 > 2 before its many-term body (chain_step.cuh:chain_tile)
KOUTER_TILE = 32


def block_passes(st, samples, dt, tile: int) -> int:
    """Trajectory-row Taylor passes that blocks of ``tile`` rows run: per
    block and (chain, row) its slowest row's count, for every row of the
    block (the rows that have finished compute masked); the declared
    identity rows skipped."""
    mt, norms, m, theta = chain_operands(st, dt.dtype)
    rows = expmv.chain_rows(st._recipe, samples, dt, st._chains, st._table)
    _, n_pass = expmv.scale_rows(rows, norms, theta, st.max_squarings)
    for c, r in expmv.identity_rows(st._recipe, st._chains):
        n_pass[:, c, r] = 0
    pad = (-n_pass.shape[0]) % tile
    n_pass = torch.cat([n_pass, n_pass.new_zeros((pad,) + n_pass.shape[1:])])
    blocks = n_pass.reshape(-1, tile, *n_pass.shape[1:]).amax(1)
    return int(blocks.sum()) * tile


def chain_library(st, samples, dt, xw, n_lib=4096):
    """The library yardstick of one K4 step: torch.linalg.matrix_exp of
    the assembled (D, D) exponents of every row the step runs (the
    declared identity rows left out), in batches of ``n_lib`` (one call
    over 32 768 faulted with an illegal memory access on the H100, torch
    2.11.0+cu128), then bmm applying each chain's in row order. Returns a
    function of no arguments giving the C results."""
    rows = expmv.chain_rows(st._recipe, samples, dt, st._chains, st._table)
    ident = expmv.identity_rows(st._recipe, st._chains)
    used = [(c, r) for c in range(rows.shape[1]) for r in range(rows.shape[2])
            if (c, r) not in ident]
    W = st._basis_w.to(rows)
    A = torch.einsum("bnk,kij->bnij",
                     torch.stack([rows[:, c, r] for c, r in used], 1), W)
    B, n, D = A.shape[0], A.shape[1], A.shape[2]
    flat = A.reshape(B * n, D, D)

    def library():
        E = torch.cat([torch.linalg.matrix_exp(a) for a in
                       flat.split(n_lib)]).reshape(B, n, D, D)
        out = []
        for c in range(rows.shape[1]):
            v = xw[:, :, None]
            for i, (cc, _) in enumerate(used):
                if cc == c:
                    v = torch.bmm(E[:, i], v)
            out.append(v[:, :, 0])
        return out

    return library


def time_k4(st, B, label, card, dt_range=(1e-3, 5e-2)):
    """K4 per launch on one step of ``st`` at B x 64c f32 (CUDA events over
    20 launches), its twin, and the library yardstick (chain_library, the
    error norm not in it), checked against K4's advanced state. Returns
    (ms, plain_ms, bound_ms, bound_by, library_ms)."""
    samples, dt, xw = chain_inputs(st, B, torch.float32, dt_range=dt_range)
    mt, norms, m, theta = chain_operands(st, torch.float32)
    kw = dict(recipe=st._recipe, C=st._chains, m=m, theta=theta,
              table=st._table)
    for _ in range(3):
        fused_chain_apply(samples, dt, xw, mt, norms, **kw)
        torch_chain_step(samples, dt, xw, mt, norms, **kw)
    library = chain_library(st, samples, dt, xw)
    y_lib = library()[0]
    y_k4, _ = fused_chain_apply(samples, dt, xw, mt, norms, **kw)
    torch.cuda.synchronize()
    d_lib = float((y_lib - y_k4).abs().max())
    assert d_lib <= 1e-5, f"the library yardstick disagrees with K4: {d_lib}"
    inner = 20 if B >= 4096 else 100
    k_runs, p_runs, l_runs = [], [], []
    for _ in range(3):  # in turns: kernel, plain, library
        k_runs.append(timed_ms(lambda: fused_chain_apply(
            samples, dt, xw, mt, norms, **kw), reps=1, inner=inner))
        p_runs.append(timed_ms(lambda: torch_chain_step(
            samples, dt, xw, mt, norms, **kw), reps=1, inner=5))
        l_runs.append(timed_ms(library, reps=1, inner=5))
    k_ms, p_ms, l_ms = (statistics.median(r) for r in (k_runs, p_runs,
                                                        l_runs))
    passes = passes_needed(st, samples, dt)
    D, Kp, K0 = 2 * DIM, mt.shape[1] // (2 * DIM), samples[0].shape[1]
    flop = chain_flops(passes, D, m, st._recipe, K0)
    nbytes = 4 * (2 * B * D + len(samples) * B * K0 + 2 * B + Kp * D * D)
    b_ms, b_by = bound(flop, nbytes)
    b0_ms, _ = bound(chain_flops(passes, D, m, st._recipe, K0,
                                 zero_columns=True), nbytes)
    body = ""
    if K0 > 2:  # the many-term body: its tile, masked passes, registers
        props = torch.cuda.get_device_properties(0)
        tile = expmv.gemm_tile(
            B, D, 4, st._recipe, st._chains, K0, st._table,
            n_sm=props.multi_processor_count,
            max_smem=getattr(props, "shared_memory_per_block_optin", 232448))
        need = int(sum(passes))
        shares = {t: block_passes(st, samples, dt, t)
                  for t in (KOUTER_TILE, tile)}
        smem = expmv.gemm_smem_bytes(tile, D, 4, st._recipe, st._chains, K0,
                                     st._table)
        body = (f"; many-term body: {tile} rows a block, {smem} B of shared "
                f"memory, ptxas {ptxas_of('chain_expmv', 'many-term')}; "
                f"trajectory-row passes needed {need}, run by blocks of "
                + ", ".join(f"{t} rows {n} ({1 - need / n:.1%} masked)"
                            for t, n in shares.items()))
    print(f"[time] K4 one {label} step at B={B}, d={DIM}, f32 (R="
          f"{expmv.n_rows(st._recipe, st._table)}; Taylor passes over rows "
          f"that need work, per chain {passes}): kernel {k_ms:.4f} ms "
          f"({flop / k_ms / 1e9:.2f} TFLOP/s), plain twin {p_ms:.4f} ms, "
          f"library (matrix_exp + bmm of every row run) {l_ms:.4f} ms "
          f"(max|y_lib - y_K4|={d_lib:.2e}); runs kernel "
          f"{[round(v, 4) for v in k_runs]}, plain "
          f"{[round(v, 4) for v in p_runs]}, library "
          f"{[round(v, 4) for v in l_runs]}; bound {b_ms:.4f} ms by {b_by} "
          f"({flop / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB; "
          f"{b0_ms:.4f} ms counting the zero columns), kernel at "
          f"{b_ms / k_ms:.1%} of it{body} ({card})", flush=True)
    return k_ms, p_ms, b_ms, b_by, l_ms


def k4_timing_phase(card: str):
    """K4 per launch at the Magnus per-step path's 16384x64c f32 Magnus-4
    pair."""
    return time_k4(chain_stepper(torch.float32), N_TRAJ, "Magnus-4 pair",
                   card)


class PassCounter:
    """A ChainStep's twin that also counts the Taylor passes its stepping
    rows need per chain (work_passes), for the loop's bound."""

    def __init__(self, step):
        self.step, self.passes, self.fast_rows = step, [0] * step.C, 0
        self.has_err, self.scaled, self.wnorm = (step.has_err, step.scaled,
                                                 step.wnorm)

    def plain(self, t, dt, xw):
        st = self.step
        samples = [st.form.sample(tn) for tn in
                   node_times(st.recipe, t, dt, st.C, st.table)]
        rows = expmv.chain_rows(st.recipe, samples, dt, st.C, st.table)
        _, n_pass = expmv.scale_rows(rows, st.norms, st.theta,
                                     st.max_squarings)
        stepping = dt != 0
        self.passes = [a + b for a, b in zip(self.passes, work_passes(
            rows, n_pass, st.recipe, st.C, stepping))]
        if st.recipe == "magnus4_fast":
            self.fast_rows += int(stepping.sum())
        return st.plain(t, dt, xw)


def time_k5(st, y0, ctl, label, card):
    """The loop kernel with the chain step alone (one persistent launch
    over t in [0, TF] from h0 = H0) against its twin per solve, beside the
    bound of the Taylor passes the twin's stepping rows need. Returns
    (ms, plain_ms, bound_ms, bound_by)."""
    B = y0.re.shape[0]
    grid = driver.make_grid(0.0, TF, dtype=torch.float32, device="cuda")
    mt, norms, m, theta = chain_operands(st, torch.float32)
    step = ChainStep(mt=mt, norms=norms, form=st.op.form, recipe=st._recipe,
                     C=st._chains, m=m, theta=theta, table=st._table)
    carries = init_carries(grid, torch.cat([y0.re, y0.im], 1), H0)
    out = fused_loop_chunk(*carries, step, ctl=ctl, adaptive=st._adaptive)
    k_runs, p_runs = [], []
    counter = PassCounter(step)
    for i in range(3):  # in turns: kernel, plain
        k_runs.append(timed_ms(lambda: fused_loop_chunk(
            *carries, step, ctl=ctl, adaptive=st._adaptive), reps=1))
        p_runs.append(timed_ms(lambda: torch_fused_loop(
            *carries[:4], carries[4].clone(), counter if i == 0 else step,
            ctl=ctl, adaptive=st._adaptive), reps=1))
    k_ms, p_ms = statistics.median(k_runs), statistics.median(p_runs)
    D, Kp, K0 = 2 * DIM, mt.shape[1] // (2 * DIM), step.form.n_terms
    steps = int((out[1][:, 3] + out[1][:, 4]).sum())
    flop = chain_flops(counter.passes, D, m, step.recipe, K0,
                       counter.fast_rows)
    nbytes = 4 * (2 * B * (5 + D) + Kp * D * D + 2) + 2 * 4 * B * 8
    b_ms, b_by = bound(flop, nbytes)
    b0_ms, _ = bound(chain_flops(counter.passes, D, m, step.recipe, K0,
                                 counter.fast_rows, zero_columns=True),
                     nbytes)
    print(f"[time] K2 with the chain step (K5) at the {label} "
          f"({B}x{DIM}c, f32, R={expmv.n_rows(st._recipe, st._table)}): "
          f"kernel {k_ms:.4f} ms (runs {[round(v, 4) for v in k_runs]}), "
          f"plain twin {p_ms:.4f} ms (runs {[round(v, 4) for v in p_runs]}); "
          f"bound {b_ms:.4f} ms by {b_by} ({steps} steps, Taylor passes per "
          f"chain {counter.passes} (identity and zero rows need none), "
          f"{flop / 1e9:.1f} GFLOP; {b0_ms:.4f} ms counting the zero "
          f"columns), kernel at {b_ms / k_ms:.1%} of it ({card})", flush=True)
    return k_ms, p_ms, b_ms, b_by


def k5_timing_phase(card: str):
    """The Magnus path's solve (one loop launch) and the per-step path's,
    the loop kernel with the chain step alone against its twin per solve,
    and the Landau-Zener path."""
    st, y0 = r_inputs("magnus4")
    loop_ms, _ = timed_solve(
        lambda: r_solve(st, y0),
        f"Magnus loop path {N_TRAJ}x{DIM}c f32, one loop launch (K5)", card)
    st_step, _ = r_inputs("magnus4", form=False)
    step_ms, _ = timed_solve(
        lambda: r_solve(st_step, y0),
        f"Magnus per-step path on the same {N_TRAJ} inputs (K4)", card)
    k5 = time_k5(st, y0, MAG_CTL, "Magnus path", card)
    print(f"[time] Magnus loop path {loop_ms:.3f} ms vs per-step path "
          f"{step_ms:.3f} ms ({card})", flush=True)
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
    return k5


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


# -- R > 1 exponentials per chain: Magnus-6 and CFM (K4 and K5) -------------

# the JAX package's record of these steppers (benchmarks.py:546-561 and
# 668-688): rtol 1e-5, min_dt 1e-5, max_dt 0.25, h0 1e-2, 256 states from
# default_rng(3)
REC_B, REC_CTL, REC_H0 = 256, StepControl(rtol=1e-5, min_dt=1e-5,
                                          max_dt=0.25), 1e-2
LABELS = {"magnus4": "Magnus-4", "magnus6": "Magnus-6", "cfm4": "CFM-4"}
R_KINDS = ("magnus6", "cfm4")


def check_chain_edges(kind, dtype) -> None:
    """K4 on a row whose dt is 0 (x exactly) and a row with a NaN state
    (its error NaN, the other rows finite and as the twin's)."""
    st = chain_stepper(dtype, kind=kind)
    samples, dt, xw = chain_inputs(st, 300, dtype)
    dt[3] = 0.0
    xw[5, 0] = float("nan")
    (yk, ek), (yp, ep) = chain_pair(st, samples, dt, xw)
    torch.cuda.synchronize()
    rest = torch.ones(300, dtype=torch.bool, device="cuda")
    rest[5] = False
    ok = (torch.equal(yk[3], xw[3]) and bool(torch.isnan(yk[5]).any())
          and bool(torch.isfinite(yk[rest]).all())
          and float((yk[rest] - yp[rest]).abs().max()) <= 1e-4)
    if ep is not None:
        ok = ok and bool(torch.isnan(ek[5])) and bool(
            torch.isfinite(ek[rest]).all()) and float(ek[3]) == 0.0
    print(f"[chain-step] {kind} {str(dtype)[6:]} edges: dt = 0 row returns "
          f"x exactly, the NaN row stays in its row"
          f"{' (its error NaN)' if ep is not None else ''}; "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"K4 edge rows: {kind} {dtype}")


# steps long enough that each row's f64 error (the difference of two
# chains whose roundings do not cancel: the Magnus-6 sub-rows against the
# full row, the CFM rows against the comparison rows) is above 1e-5 of the
# state, so that it is held to 1e-9 of itself; and f32 steps where it is
# above 1e-4, so that every row's norm is held to 10%
R_DT64 = {"magnus6": (0.3, 0.6), "cfm4": (0.1, 0.4), "blanes": (0.1, 0.4)}
R_DT32 = {"magnus6": (0.4, 0.8), "cfm4": (0.2, 0.4)}


def chain_step_r_phase() -> dict:
    """K4 with R > 1 against its twin: f64 at B = 1000 for Magnus-6 (C = 2
    and fixed), CFM-4 (C = 2 and fixed) and BLANES17 (four rows, three
    nodes, zero alphas, three zero pad rows), with declared norms, states
    to 1e-13 of their scale; f32 at B = 1000 for each and at the path's
    16384 for Magnus-6 and CFM-4, on short steps and on long ones where
    every row's norm is held to 10%; the edge rows. Returns {kind: max
    |dy| at the path's shape}."""
    f64, f32 = torch.float64, torch.float32
    for kind in ("magnus6", "magnus6_fixed", "cfm4", "cfm4_fixed", "blanes"):
        check_chain_step(1000, f64, kind, dt_range=R_DT64[kind.split("_")[0]],
                         x_rel=1e-13, kind=kind)
        check_chain_step(1000, f32, kind, kind=kind)
        for dtype in (f32, f64):
            check_chain_edges(kind, dtype)
    check_chain_step(1000, f64, "magnus6 l2 weighted", kind="magnus6",
                     dt_range=R_DT64["magnus6"], x_rel=1e-13,
                     wnorm=weighted("l2", DIM))
    check_chain_step(1000, f64, "cfm4 max", kind="cfm4",
                     dt_range=R_DT64["cfm4"], x_rel=1e-13,
                     wnorm=weighted("max", DIM, False))
    errs = {}
    for kind in R_KINDS:
        _, sensitive = check_chain_step(N_TRAJ, f32, kind,
                                        dt_range=R_DT32[kind], kind=kind)
        if sensitive != N_TRAJ:
            raise AssertionError(
                f"the long-step check of {kind} holds only "
                f"{sensitive}/{N_TRAJ} error norms to 10%")
        errs[kind] = check_chain_step(N_TRAJ, f32, kind, kind=kind)[0]
    return errs


def chain_loop_r_phase() -> dict:
    """K5 with R > 1 in the loop kernel against the loop's twin: f64 at
    B = 1000 (counters equal per trajectory), f32 at 2048, persistent
    against chunked, and each path's own inputs at 16384. Returns {kind:
    max |dx| at the path}."""
    for name in R_CASES:
        if name not in CHAIN_PATHS:
            check_chain_loop_pair(name, 1000, torch.float64)
    for name in ("magnus6", "magnus6_fixed", "cfm4", "cfm4_fixed"):
        check_chain_loop_pair(name, LOOP_TRAJ, torch.float32)
    check_chain_persistent_is_chunked("magnus6_save_grid", 1000,
                                      torch.float64)
    check_chain_persistent_is_chunked("cfm4_fixed", LOOP_TRAJ, torch.float32)
    return {kind: check_chain_loop_pair(f"{kind}_path", N_TRAJ,
                                        torch.float32) for kind in R_KINDS}


def r_inputs(kind, n=N_TRAJ, form=True, seed=42):
    """The kind's stepper on DrivenDense(64, seed 0) in f32 (with its
    declared form, or only its coefficient function) and n unit states
    from default_rng(seed) (at seed 42 the main path's)."""
    op = DrivenDense.make(d=DIM, seed=0).modulated(torch.float32,
                                                   device="cuda")
    if not form:
        op = dataclasses.replace(op, form=None)
    return r_stepper(kind, op), unit_states(n, DIM, torch.float32, seed)


def r_solve(st, y0, ctl=MAG_CTL, h0=H0):
    return ensemble_solve(None, y0, 0.0, TF, stepper=st, ctl=ctl, h0=h0,
                          time_dtype=torch.float32)


def check_unit_solution(sol, n, label):
    n_done = int((sol.status == DONE).sum())
    assert n_done == n, f"{label}: {n - n_done} trajectories not DONE"
    y = torch.complex(sol.y_final.re, sol.y_final.im)
    assert y.shape == (n, DIM) and bool(torch.isfinite(y.real).all()
                                        & torch.isfinite(y.imag).all())
    norm_dev = float((y.abs().pow(2).sum(-1).sqrt() - 1).abs().max())
    assert norm_dev <= 1e-4, f"{label}: |psi| drifted by {norm_dev}"
    return norm_dev


def r_loop_path_phase(kind):
    """A Magnus loop path: 16384x64c of the kind (Magnus-4, or R > 1
    exponentials per chain) in one loop launch (K2 with K5), all DONE,
    |psi| = 1 within 1e-4."""
    st, y0 = r_inputs(kind)
    reset_counts()
    sol = r_solve(st, y0)
    torch.cuda.synchronize()
    k1, k2, k4 = counts()
    assert sol.path == "cuda-loop-persistent", sol.path
    assert (k1, k2, k4) == (0, 1, 0), (k1, k2, k4)
    norm_dev = check_unit_solution(sol, N_TRAJ, kind)
    print(f"[{kind}-loop] {N_TRAJ}x{DIM}c {type(st).__name__} rtol="
          f"{MAG_CTL.rtol:g}: all DONE, max||psi|-1|={norm_dev:.3e}, path="
          f"{sol.path}, launches K1/K2/K4 = {k1}/{k2}/{k4}, n_accept "
          f"{int(sol.n_accept.min())}..{int(sol.n_accept.max())}, n_reject "
          f"{int(sol.n_reject.min())}..{int(sol.n_reject.max())}, n_iters up "
          f"to {int(sol.n_iters.max())}", flush=True)
    return k2, sol


def r_step_path_phase(kind, loop_sol):
    """The same solve with only a coefficient function: the host driver and
    a K4 launch per iteration; counters within 1 of the loop path's, the
    first trajectories' states within 1e-4 of it. Then the JAX record's
    configuration at 256 on the per-step path."""
    st, y0 = r_inputs(kind, form=False)
    reset_counts()
    sol = r_solve(st, y0)
    torch.cuda.synchronize()
    k1, k2, k4 = counts()
    n_iters = int(sol.n_iters.max())
    assert sol.path == "torch-driver+cuda-step", sol.path
    assert (k1, k2) == (0, 0) and k4 == n_iters, (k1, k2, k4, n_iters)
    check_unit_solution(sol, N_TRAJ, kind)
    dcount = max(int((getattr(sol, k) - getattr(loop_sol, k)).abs().max())
                 for k in ("n_accept", "n_reject", "n_iters"))
    first = slice(0, 64)
    dy = float(torch.maximum(
        (sol.y_final.re - loop_sol.y_final.re).abs(),
        (sol.y_final.im - loop_sol.y_final.im).abs()).max())
    dy_first = float(torch.maximum(
        (sol.y_final.re[first] - loop_sol.y_final.re[first]).abs(),
        (sol.y_final.im[first] - loop_sol.y_final.im[first]).abs()).max())
    assert dcount <= 1 and dy <= 1e-4, (dcount, dy)
    st256, y256 = r_inputs(kind, n=REC_B, form=False, seed=3)
    reset_counts()
    sol256 = r_solve(st256, y256, REC_CTL, REC_H0)
    torch.cuda.synchronize()
    k4_256 = counts()[2]
    assert sol256.path == "torch-driver+cuda-step"
    assert k4_256 == int(sol256.n_iters.max())
    check_unit_solution(sol256, REC_B, kind)
    print(f"[{kind}-step] {N_TRAJ}x{DIM}c, operator without a declared "
          f"form: path={sol.path}, K4 launches={k4} == max n_iters={n_iters} "
          f"(K1/K2 {k1}/{k2}); vs the loop path: max|dcount|={dcount} (<= 1),"
          f" max|dy|={dy:.3e} (<= 1e-4; the first 64: {dy_first:.3e}); the "
          f"JAX record's configuration at {REC_B}: {k4_256} K4 launches, "
          f"all DONE", flush=True)
    return k4


def r_timing_phase(kind, card):
    """The kind's loop path and per-step paths (16384 and the record's
    256) timed end to end, K2 + K5 alone against its twin and bound, and
    K4 per launch at both batches. Returns (K4 numbers at 16384, K5
    numbers)."""
    label = LABELS[kind]
    st, y0 = r_inputs(kind)
    timed_solve(lambda: r_solve(st, y0),
                f"{label} loop path {N_TRAJ}x{DIM}c f32, one loop launch "
                f"(K5, R = {expmv.n_rows(st._recipe, st._table)})", card)
    st_step, _ = r_inputs(kind, form=False)
    timed_solve(lambda: r_solve(st_step, y0),
                f"{label} per-step path on the same {N_TRAJ} inputs (K4)",
                card)
    st256, y256 = r_inputs(kind, n=REC_B, form=False, seed=3)
    timed_solve(lambda: r_solve(st256, y256, REC_CTL, REC_H0),
                f"{label} per-step path at {REC_B}x{DIM}c, the JAX record's "
                "configuration (K4)", card)
    k5 = time_k5(st, y0, MAG_CTL, f"{label} loop path", card)
    k4 = time_k4(st, N_TRAJ, label, card)
    time_k4(st, REC_B, label, card)
    return k4, k5


def lindblad_phase(card):
    """Lindblad.make(d=8, seed=9, gamma=0.2) (D = 128), 256 density
    matrices (benchmarks.py:697-735): MM4 and MM6 on the per-step path
    with the callable control 0.8 sin(2.1 t) (a K4 launch per iteration),
    and MM6 with the declared control 0.8 cos(2.1 t) in one loop launch;
    all DONE, the trace kept within 1e-5 in f32, the wall timed."""
    lb = Lindblad.make(d=8, seed=9, gamma=0.2)
    rng = np.random.default_rng(3)
    V = rng.standard_normal((REC_B, 8, 8)) + 1j * rng.standard_normal(
        (REC_B, 8, 8))
    rho = np.einsum("bij,bkj->bik", V, V.conj())
    rho /= np.trace(rho, axis1=-2, axis2=-1)[:, None, None]
    y0 = Lindblad.vec_rho(rho, torch.float32, device="cuda")
    sin_u = lb.modulated(lambda t: 0.8 * torch.sin(2.1 * t), torch.float32,
                         device="cuda")
    cos_u = lb.modulated(texp.CoeffForm(a=(0.0,), b=(0.0,), c=(0.8,),
                                        w=(2.1,)), torch.float32,
                         device="cuda")
    for name, st, path in (
            ("MM4", MagnusModulated4(sin_u), "torch-driver+cuda-step"),
            ("MM6", MagnusModulated6(sin_u), "torch-driver+cuda-step"),
            ("MM6 declared cos", MagnusModulated6(cos_u),
             "cuda-loop-persistent")):
        reset_counts()
        sol = ensemble_solve(None, y0, 0.0, 1.0, stepper=st, ctl=REC_CTL,
                             h0=REC_H0, time_dtype=torch.float32)
        torch.cuda.synchronize()
        k1, k2, k4 = counts()
        assert sol.path == path, sol.path
        want = ((0, 1, 0) if path == "cuda-loop-persistent"
                else (0, 0, int(sol.n_iters.max())))
        assert (k1, k2, k4) == want, (name, k1, k2, k4)
        assert bool((sol.status == DONE).all()), name
        tr_re, tr_im = Lindblad.trace(sol.y_final)
        d_tr = float(torch.maximum((tr_re - 1).abs(), tr_im.abs()).max())
        assert d_tr <= 1e-5, (name, d_tr)
        wall, _ = timed_solve(lambda: ensemble_solve(
            None, y0, 0.0, 1.0, stepper=st, ctl=REC_CTL, h0=REC_H0,
            time_dtype=torch.float32),
            f"Lindblad d=8 ({REC_B} density matrices) {name}, {path}", card)
        print(f"[lindblad] {name}: path={path}, launches K1/K2/K4 = "
              f"{k1}/{k2}/{k4}, all DONE, max|tr(rho) - 1|={d_tr:.2e} (<= "
              f"1e-5), n_accept {int(sol.n_accept.min())}.."
              f"{int(sol.n_accept.max())}", flush=True)


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


def recorded_times(basis, pc, y0, theta, **scheme):
    """The adaptive forward's per-iteration times (n_it + 1, B), by the
    adjoint's own forward (K4 per iteration: bitwise the same steps);
    ``scheme``: order= or scheme= of adjoint_solve_adaptive."""
    core, stepper, step_rows = tdiff._adaptive_scheme(basis, pc.coeff_fn,
                                                      **scheme)
    plan = tdiff._AdaptivePlan(None, core, basis, pc.coeff_fn, ADJ_CTL,
                               stepper, step_rows)
    t0, tf, h0 = (torch.tensor(v, dtype=torch.float32, device="cuda")
                  for v in (0.0, 1.0, ADJ_H0))
    return tdiff._adaptive_forward(plan, theta, torch.cat([y0.re, y0.im], -1),
                                   t0, tf, h0)[2]


def adaptive_adjoint_check(label, card=None, **scheme):
    """adjoint_solve_adaptive at 256x64c f32, rtol 1e-5 (ADJ_CTL, the
    Magnus-4 adaptive configuration) with ``scheme`` (order= or scheme=): all lanes DONE,
    one K4 launch per forward iteration, n_sub K6 launches per replayed
    iteration (one reverse row per exponential: 1 at Magnus order 4, 3 at
    order 6, 2 for cfm4), no twin call, the gradient against the
    frozen-step-sequence f64 matrix_exp oracle over the same rows
    (tests/test_adjoint.py:169-250). With ``card`` the value-and-grad wall
    is timed (median of 3 after a warm run). Returns the K6 launches and
    the recorded times (n_it + 1, B)."""
    pc, y0, tg, theta = adjoint_inputs(torch.float32)
    basis = pc.basis_pair(torch.float32)

    def value_and_grad():
        th = theta.clone().requires_grad_(True)
        yr, yi = (v.clone().requires_grad_(True) for v in (y0.re, y0.im))
        yf, status = tdiff.adjoint_solve_adaptive(
            basis, pc.coeff_fn, th, Cplx(yr, yi), 0.0, 1.0, ctl=ADJ_CTL,
            h0=ADJ_H0, return_status=True, **scheme)
        k4_fwd = fused_chain_apply.launches
        value = 1.0 - torch.sum(pc.fidelity(yf, tg))
        return status, k4_fwd, value, torch.autograd.grad(value,
                                                          (th, yr, yi))

    reset_counts()
    with TwinCalls() as tw:
        status, k4_fwd, value, grads = value_and_grad()
        torch.cuda.synchronize()
    k6, k7, k8, k4 = adj_counts()
    assert bool((status == DONE).all()), "adaptive lanes not DONE"
    ts = recorded_times(basis, pc, y0, theta, **scheme)
    n_it = ts.shape[0] - 1
    n_sub = 3 if scheme.get("order") == 6 else (
        2 if scheme.get("scheme") == "cfm4" else 1)
    assert (k4_fwd, k4, k6, k7, k8, tw.n) == (
        n_it, n_it, n_sub * n_it, 0, 0, 0), (k4_fwd, k4, k6, k7, k8, tw.n,
                                              n_it, n_sub)

    # the oracle: matrix_exp of each replayed row over the recorded times,
    # in f64
    _, y64, tg64, th64 = adjoint_inputs(torch.float64)
    core, _, step_rows = tdiff._adaptive_scheme(
        pc.basis_pair(torch.float64), pc.coeff_fn, **scheme)
    tho = th64.clone().requires_grad_(True)
    xr, xi = (v.clone().requires_grad_(True) for v in (y64.re, y64.im))
    t64 = ts.to(torch.float64)
    x = torch.cat([xr, xi], -1)
    for r in range(n_it):
        c = torch.func.vmap(lambda t_, d_: step_rows(tho, t_, d_))(
            t64[r], t64[r + 1] - t64[r])
        for j in range(c.shape[1]):
            U = torch.linalg.matrix_exp(torch.einsum("bk,kij->bij", c[:, j],
                                                     core.W))
            x = torch.bmm(U, x[:, :, None])[:, :, 0]
    vo = 1.0 - torch.sum(pc.fidelity(Cplx(x[:, :DIM], x[:, DIM:]), tg64))
    go = torch.autograd.grad(vo, (tho, xr, xi))
    d = grad_diff(grads, go)
    dv = abs(float(value.detach()) - float(vo.detach())) / abs(float(
        vo.detach()))
    assert d <= 1e-3 and dv <= 1e-4, (d, dv)
    n_acc = (torch.diff(ts, dim=0) > 0).sum(0)
    wall = ""
    if card is not None:
        value_and_grad()
        walls = timed_runs(value_and_grad)
        wall = (f"; value-and-grad wall median {statistics.median(walls):.3f}"
                f" ms of {[round(w, 3) for w in walls]} ({card})")
    print(f"[adjoint-adaptive] {ADJ_B}x{DIM}c {label} rtol="
          f"{ADJ_CTL.rtol:g}, f32: all DONE, {n_it} iterations, "
          f"{int(n_acc.min())}..{int(n_acc.max())} accepted steps per lane; "
          f"K4 {k4_fwd} == forward iterations, K6 {k6} == {n_sub} x replayed "
          f"iterations, no twin call; vs the frozen-sequence f64 oracle: "
          f"value {dv:.2e}, gradients {d:.2e} relative{wall}", flush=True)
    return k6, ts


def adjoint_adaptive_phase():
    """The adaptive adjoint at Magnus order 4. Returns the K6 launches and
    the recorded times (n_it + 1, B)."""
    return adaptive_adjoint_check("Magnus-4", order=4)


def adj_flops(n_pass, B: int, D: int, Kp: int, m: int,
              reverse: bool) -> float:
    """Operations the function needs over rows of ``n_pass`` passes each,
    each row shared by ``B`` trajectories (K7, K8) or one trajectory's own
    (K6: B = 1 per advancing lane), the least of two routes per row. A row
    forms A = sum_k c_k W_k (2 K' D^2) and runs p passes of the degree-m
    Taylor polynomial P of A / p. A state chain (K7's y; K6's and K8's x)
    costs p m (D, D) actions a trajectory, or P formed as a matrix (m - 1
    products of its Taylor chain) and one action a pass. In reverse the a
    chain and cbar cost, per trajectory, the a chain, a u chain from each
    pass's state and its K' actions W_k u_l ((2 + K') m actions a pass),
    paired with the a chain's terms (K' m (m + 1) D); or, per row, one
    adjoint Frechet chain of P in the direction G = sum a x^T over the
    passes and trajectories (2 p B D^2; 3 products a term past the first,
    its power chain giving P^T, which then moves a in one action a pass)
    and the K' inner products <W_k, L>. Each action or product counts its
    division and running sum; Paterson-Stockmeyer's fewer products are not
    counted."""
    p = np.asarray(n_pass, dtype=np.float64)
    act, mm = 2 * D * D + 2 * D, 2 * D ** 3 + 2 * D * D
    fl = 2 * Kp * D * D + np.minimum(B * p * m * act,
                                     (m - 1) * mm + B * p * act)
    if reverse:
        lane = B * p * ((2 + Kp) * m * act + Kp * m * (m + 1) * D)
        row = (3 * (m - 1) * mm + B * p * act + 2 * p * B * D * D
               + 2 * Kp * D * D)
        fl = fl + np.minimum(lane, row)
    return float(fl.sum())


def adj_library(W, c_all, x, a, reverse: bool, per_lane: bool = False):
    """The library yardstick: matrix_exp of the exponents M = sum_k c_k W_k
    and products with the states; in reverse also matrix_exp of -M and of
    M^T and of the (2D)-wide blocks [[M, W_k], [0, M]] for the Fréchet
    terms. ``per_lane``: one exponent per trajectory (K6's rows).
    matrix_exp takes at most 4096 matrices a call (chain_library)."""
    M = torch.einsum("rk,kij->rij", c_all, W)
    D = W.shape[1]

    def expm(a):
        flat = a.reshape(-1, *a.shape[-2:])
        return torch.cat([torch.linalg.matrix_exp(v) for v in
                          flat.split(4096)]).reshape(a.shape)

    if not reverse:
        U = expm(M)
        for r in range(M.shape[0]):
            x = x @ U[r].T
        return x
    Kp = W.shape[0]
    Ui = expm(-M)
    Ut = expm(M.transpose(-1, -2))
    blk = torch.zeros(M.shape[0], Kp, 2 * D, 2 * D, dtype=M.dtype,
                      device=M.device)
    blk[:, :, :D, :D] = M[:, None]
    blk[:, :, D:, D:] = M[:, None]
    blk[:, :, :D, D:] = W
    F = expm(blk)[:, :, :D, D:]
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


def sweep_shape(x, B: int, Kp: int, name: str) -> str:
    """K7's or K8's launch shape at B (ops/adjoint.py:sweep_plan, bwd_plan
    on this card) and its ptxas lines."""
    props = torch.cuda.get_device_properties(0)
    card = dict(n_sm=props.multi_processor_count,
                max_smem=getattr(props, "shared_memory_per_block_optin",
                                 232448))
    if name == "K7":
        shape, key = tadj.sweep_plan(B, x.shape[1], 4, **card), "sweep_gemm"
    else:
        shape = tadj.bwd_plan(B, x.shape[1], Kp, 4, **card)
        key = "sweep_bwd"
    return (f"; shape {shape}, ptxas "
            f"{ptxas_of('adjoint', f'adjoint_{key} f32')}")


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
    # the plain twins at the path's batch; the library at both (above it
    # K6's per launch on the replay's first row, not the whole replay)
    with_plain = B <= ADJ_B
    out = {}
    for name, (kern, plain, lib, first, n_launch) in cases.items():
        kern_1, lib_1 = first or (kern, lib)
        got = kern_1()
        lb = lib_1()
        lb = (lb,) if name == "K7" else lb
        gk = (got,) if name == "K7" else got
        d_lib = max(rel(u, v) for u, v in zip(gk, lb))
        assert d_lib <= 1e-3, (name, d_lib)
        torch.cuda.synchronize()
        lib_t, lib_n = (lib, n_launch) if with_plain else (lib_1, 1)
        runs = {"kernel": [], "plain": [], "library": []}
        for _ in range(3):  # in turns
            runs["kernel"].append(timed_ms(kern, reps=1) / n_launch)
            if with_plain:
                runs["plain"].append(timed_ms(plain, reps=1) / n_launch)
            runs["library"].append(timed_ms(lib_t, reps=1) / lib_n)
        k_ms = statistics.median(runs["kernel"])
        p_ms = statistics.median(runs["plain"]) if with_plain else None
        l_ms = statistics.median(runs["library"])
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
                # a lane that did not advance needs only cbar_k = <a, W_k x>
                fl = (adj_flops(n_pass[nz].flatten().tolist(), 1, D, Kp, m,
                                True) + (B - f_r) * 2 * Kp * D * D)
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
            flop = adj_flops(n_pass.flatten().tolist(), B, D, Kp, m,
                             name == "K8")
            b_ms, b_by = bound(flop, nbytes)
            what = f", R={R} rows ({passes} trajectory-row passes)"
        if name != "K6":
            what += sweep_shape(x, B, Kp, name)
        print(f"[time] {name} at B={B}, d={DIM}, K'={Kp}, f32{what}: kernel "
              f"{k_ms:.4f} ms per launch ({flop / k_ms / 1e9:.2f} TFLOP/s)"
              + (f", plain twin {p_ms:.4f} ms" if with_plain else "")
              + f", library {l_ms:.4f} ms (max rel |d| {d_lib:.2e})"
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
    the value-and-grad wall (median of 3 after a warm run) with K7's and
    K8's spans inside it and adjoint steps/s = 2 n_steps B / wall
    (benchmarks.py:776), and peak memory at 256 and 1024 steps."""
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

    reset_counts()
    vg()
    torch.cuda.synchronize()
    _, n7, n8, _ = adj_counts()
    # K7's and K8's spans inside the timed wall: CUDA events around each
    # wrapper call that diff.py makes (the launch; K8's also the sum of its
    # partials), read after each run
    spans = {"K7": [], "K8": []}

    def evented(name, fn):
        def run(*args, **kw):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            res = fn(*args, **kw)
            ev[1].record()
            spans[name].append(ev)
            return res
        return run

    plain_fns = tdiff.adjoint_sweep_fwd, tdiff.adjoint_sweep_bwd
    tdiff.adjoint_sweep_fwd = evented("K7", plain_fns[0])
    tdiff.adjoint_sweep_bwd = evented("K8", plain_fns[1])
    walls, in_wall = [], {"K7": [], "K8": []}
    try:
        for _ in range(3):
            for v in spans.values():
                v.clear()
            walls += timed_runs(vg, reps=1)  # synchronises at its end
            for name, v in spans.items():
                in_wall[name].append(sum(a.elapsed_time(b) for a, b in v))
    finally:
        tdiff.adjoint_sweep_fwd, tdiff.adjoint_sweep_bwd = plain_fns
    wall = statistics.median(walls)
    k7_ms, k8_ms = (statistics.median(in_wall[n]) for n in ("K7", "K8"))
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
          f"Magnus-4 steps ({n7} K7 + {n8} K8 launch): median wall "
          f"{wall:.3f} ms of {[round(w, 3) for w in walls]}; inside it, "
          f"by CUDA events around the wrapper calls (medians), K7 "
          f"{k7_ms:.3f} ms ({k7_ms / wall:.1%}) of "
          f"{[round(v, 3) for v in in_wall['K7']]}, K8 {k8_ms:.3f} ms "
          f"({k8_ms / wall:.1%}) of {[round(v, 3) for v in in_wall['K8']]}"
          f", the rest {wall - k7_ms - k8_ms:.3f} ms on the host and in "
          f"small kernels; "
          f"{2 * ADJ_STEPS * ADJ_B / (wall / 1e3):.4e} adjoint steps/s "
          f"(fwd + bwd counted); peak memory above what was allocated "
          f"before (total peak) "
          + ", ".join(f"{v:.2f} MiB ({t:.1f}) at n_steps={n}"
                      for n, (v, t) in peaks.items())
          + f" ({card})", flush=True)
    return out


# -- events and dense output (slice 3b): K2's event and dense switches -----

EV_TOL = 1e-5   # t_tol of the DrivenDense events (the f32 loop paths)
# bench.py:779-826's controller for the Landau-Zener event checks
LZ_EV_CTL = StepControl(rtol=1e-5, max_steps=20000, min_dt=1e-4, max_dt=1.0)
LZ_EV_H0, LZ_EV_TOL = 0.05, 1e-4


def drive_events(d=DIM, t_tol=EV_TOL):
    """Re z_3 over the widened [re | im] (direction 0, three located
    crossings; tests/test_kernel_events.py:155) and a terminal rising
    threshold |z_0|^2 = 0.03 (unit states of d = 64 start near 1/64):
    some rows stop at it, the others run to tf."""
    w = np.zeros(2 * d)
    w[3] = 1.0
    q = np.zeros(d)
    q[0] = 1.0
    return EventConfig(events=(
        Event(LinearObservable(w=w)),
        Event(QuadraticObservable(q=q, c=0.03), direction=1, terminal=True)),
        max_crossings=3, t_tol=t_tol)


def lz_events(v):
    """bench.py:779-826: at v = 2 a terminal rising population threshold
    |c1|^2 = 0.05; at v = 0 (a pure Rabi drive) |c1|^2 = 1/2 in both
    directions, three crossings located of the five in [-20, 20]."""
    if v:
        return EventConfig(events=(Event(QuadraticObservable(
            q=[0.0, 1.0], c=0.05), direction=1, terminal=True),),
            t_tol=LZ_EV_TOL)
    return EventConfig(events=(Event(QuadraticObservable(
        q=[0.0, 1.0], c=0.5)),), max_crossings=3, t_tol=LZ_EV_TOL)


# the kernel-vs-twin cases: the step of a LOOP_CASES / CHAIN_CASES entry
# over t in [0, 1] (Landau-Zener: [-20, 20]) with drive_events / lz_events
EXTRA_STEPS = {"rk": "plain", "magnus4": "plain", "magnus4_fast":
               "fast_error", "magnus6": "magnus6", "cfm4": "cfm4",
               "lz_magnus4": "lz_magnus4", "lz_midpoint": "lz_midpoint"}
EXTRA_MODES = ("events", "dense", "both", "saves")


def extra_case(name, B, dtype, mode):
    """(carries, step, ctl, adaptive, spec, ev, dn) of a kernel-vs-twin
    case: ``mode`` events (on [t0, tf]), dense (nine dense times), both,
    or saves (events and nine grid-hit saves)."""
    if name == "rk":
        carries, step, ctl, _ = loop_case("plain", B, DIM, dtype)
        adaptive = True
    else:
        carries, step, ctl, adaptive, _ = chain_loop_case(
            EXTRA_STEPS.get(name, name), B, dtype)
    lz = name.startswith("lz")
    t0, tf = (-LZ_T / 4, LZ_T / 4) if lz else (0.0, TF)
    times = torch.linspace(t0, tf, 11, dtype=torch.float64)[1:-1]
    grid = ([t0, *times.tolist(), tf] if mode == "saves" else [t0, tf])
    x0, h0 = carries[3], carries[1][:, 1]
    new = init_carries(torch.tensor(grid, dtype=torch.float64), x0, h0)
    spec = ev = dn = None
    if mode != "dense":
        D = x0.shape[1]
        spec = (lz_events(2.0) if lz else drive_events(D // 2)).kernel_spec(
            D // 2, 2)
        ev = init_event_carry(spec, new[3])
    if mode in ("dense", "both"):
        dn = init_dense_carry(times, new[3])
        new[2][:, 0] = 1
    return new, step, ctl, adaptive, spec, ev, dn


def _copy(c):
    return None if c is None else type(c)(
        *(None if a is None else a.clone() for a in c))


def run_extra_pair(name, B, dtype, mode, chunk=None):
    """K2 with its event / dense switches and the twin on the same
    carries: ((fs, ist, x, saves, ev, dn) of each, whether the steps
    were adaptive, the step)."""
    carries, step, ctl, adaptive, spec, ev, dn = extra_case(name, B, dtype,
                                                            mode)
    kw = dict(ctl=ctl, adaptive=adaptive, events=spec)
    ev_k, dn_k = _copy(ev), _copy(dn)
    got = fused_loop_chunk(*carries[:4], carries[4].clone(), step,
                           chunk=chunk, ev=ev_k, dense=dn_k, **kw)
    while chunk is not None and bool((got[1][:, 1] == 0).any()):
        got = fused_loop_chunk(carries[0], *got, step, chunk=chunk, ev=ev_k,
                               dense=dn_k, **kw)
    want = torch_fused_loop(*carries, step, ev=ev, dense=dn, **kw)
    torch.cuda.synchronize()
    return (*got, ev_k, dn_k), (*want, ev, dn), adaptive, step


def _max(a) -> float:
    return float(a.abs().max()) if a.numel() else 0.0


def step_slope(step):
    """The endpoint slope f(t, x) of a loop step over widened rows, as the
    dense-output Hermite pass takes it: (M0 + cos(w t) M1) x for an RK
    step, sum_k c_k(t) M_k x over the declared form's basis terms (the
    first K0 of the working basis) for a chain step."""
    if isinstance(step, RKStep):
        def slope(t, xw):
            return (xw @ step.M0.T
                    + torch.cos(step.w * t)[:, None] * (xw @ step.M1.T))
        return slope
    D = step.mt.shape[0]

    def slope(t, xw):
        c = step.form.sample(t)
        return sum(c[:, k:k + 1] * (xw @ step.mt[:, k * D:(k + 1) * D])
                   for k in range(step.form.n_terms))
    return slope


def check_extra_pair(name, B, dtype, mode) -> float:
    """K2 with events / dense output against torch_fused_loop.

    f64: every counter, status, found and count equal per trajectory,
    located times and dense (t, dt) within 1e-10, states within 1e-12
    (the RK step: 1e-10 of the states' scale; only the summation order of
    its products differs), the dense endpoints within 1e-9.

    f32: the error estimate is a cancelling sum, so its rounding moves h
    by ~1e-4 relative and the two runs' step sequences drift apart (the
    same slots are crossed by steps of other lengths, and at rtol 1e-8
    the RK counters differ by a step or two). The gate is what users
    read: status, found and count equal and every located time within
    2 t_tol (each run's is within t_tol of its crossing) on at least 98%
    of the rows (a grazing crossing, g touching zero, can register in one
    run and not the other: 1 of 16 384 Landau-Zener sweeps on the H100),
    and on those the first crossing's and final states within 1e-4 (rows
    an event stopped: plus |f(t, x)| 2 t_tol, their locate steps end up
    to 2 t_tol apart); the dense output's Hermite values within 1e-4 on
    every row. Returns max |dx| (f64: every row; f32: the rows
    whose events agree)."""
    got, want, _, step = run_extra_pair(name, B, dtype, mode)
    f64 = dtype == torch.float64
    ev_g, ev_w, dn_g, dn_w = got[4], want[4], got[5], want[5]
    dcount = int((got[1][:, INT_COLS] - want[1][:, INT_COLS]).abs().max())
    if f64:
        agree = (got[1][:, INT_COLS] == want[1][:, INT_COLS]).all(1)
    else:
        agree = got[1][:, 1] == want[1][:, 1]
    if ev_g is not None:
        agree &= (ev_g.count == ev_w.count).all(1)
        agree &= (ev_g.found == ev_w.found).all(1)
    # f64: t and h differ in their last digits (the error norms' sums
    # differ in order; ROADMAP queue 3). f32: each run locates a crossing
    # inside its own last bracket, at most t_tol wide: 2 t_tol apart
    t_lim = 1e-10 if f64 else 2 * (LZ_EV_TOL if name.startswith("lz")
                                   else EV_TOL)
    n_time = 0
    if ev_g is not None and not f64:
        # a grazing crossing (g touching zero) may register in one run and
        # a step later, or at a later crossing, in the other: such a row
        # stops elsewhere, so it leaves the rows compared
        d_t = torch.nan_to_num(ev_g.t_ev - ev_w.t_ev, nan=0.0, posinf=0.0,
                               neginf=0.0).abs()
        near = (d_t <= t_lim).flatten(1).all(1)
        n_time = int((agree & ~near).sum())
        agree &= near
    n_agree = int(agree.sum())
    if f64:
        lim_x = (1e-10 * max(float(want[2].abs().max()), 1.0)
                 if name == "rk" else 1e-12)
        # a dense endpoint is a state at a time off by the t_lim above,
        # moving by |A x| (up to ~10 here) times it
        lim_dense = 1e-9
    else:
        lim_x = lim_dense = 1e-4
    # per row: f32 rows stopped by a terminal event end a locate step of
    # at most t_tol past a crossing located up to t_lim apart, so their
    # final and located states are |f(t, x)| t_lim apart on top
    row_lim = torch.full_like(want[0][:, 0], lim_x)
    if ev_g is not None and not f64:
        stopped = want[1][:, 1] == DONE_EVENT
        fx = step_slope(step)(want[0][:, 0], want[2]).abs().amax(1)
        row_lim = torch.where(stopped, lim_x + fx * t_lim, row_lim)
    row_dx = (got[2] - want[2]).abs().amax(1)
    dx = _max(row_dx[agree])
    x_ok = bool((row_dx <= row_lim)[agree].all())
    ds = _max((got[3] - want[3])[:, agree])
    dt_ev = dy_ev = ddense = dx_dense = 0.0
    n_found = n_ev = 0
    if ev_g is not None:
        tg, tw = ev_g.t_ev[agree], ev_w.t_ev[agree]
        fin = torch.isfinite(tw)
        assert bool((torch.isfinite(tg) == fin).all()), name
        dt_ev = _max(tg[fin] - tw[fin])
        if ev_g.y_ev is not None:
            row_dy = (ev_g.y_ev - ev_w.y_ev).abs().amax(2).amax(0)
            dy_ev = _max(row_dy[agree])
            x_ok &= bool((row_dy <= row_lim)[agree].all())
        n_found = int(ev_w.found.sum())
        n_ev = int((want[1][:, 1] == DONE_EVENT).sum())
    if dn_g is not None:
        fin = torch.isfinite(dn_w.td)
        assert bool((torch.isfinite(dn_g.td) == fin).all()), name
        if f64:
            ddense = max(_max((dn_g.td - dn_w.td)[fin]),
                         _max(dn_g.dtd - dn_w.dtd))
            dx_dense = _max(dn_g.dx - dn_w.dx)
        else:
            slope = step_slope(step)
            ys = [hermite_from_endpoints(dn.times, dn.td, dn.dtd, dn.dx[0::2],
                                         dn.dx[1::2], slope)
                  for dn in (dn_g, dn_w)]
            dx_dense = _max(ys[0] - ys[1])
    min_agree = B if f64 else int(0.98 * B)
    ok = (n_agree >= min_agree and x_ok and ds <= lim_x
          and dx_dense <= lim_dense and max(dt_ev, ddense) <= t_lim
          and bool(torch.isfinite(got[2]).all()))
    print(f"[extra-kernel] {name} {mode} {str(dtype)[6:]} B={B} "
          f"D={got[2].shape[1]}: {'counters, ' if f64 else ''}status, "
          f"found and count equal{'' if f64 else ', located times near,'} "
          f"on {n_agree}/{B} rows (>= {min_agree}), "
          f"max|dcount|={dcount}; on those max|dx|={dx:.3e}, max|dsaves|="
          f"{ds:.3e}, max|dy_ev|={dy_ev:.3e} (<= {lim_x:.1e}"
          f"{'' if f64 else ', + |f| t_lim on rows an event stopped'}), "
          f"{'max|d endpoints|' if f64 else 'max|d Hermite values|'}="
          f"{dx_dense:.3e} (<= {lim_dense:.1e}), max|dt| of located times="
          f"{dt_ev:.3e}{f', of dense (t, dt)={ddense:.3e}' if f64 else ''} "
          f"(<= {t_lim:.0e}; {n_time} rows left out for a crossing located "
          f"elsewhere); {n_found} crossings found, {n_ev} rows "
          f"DONE_EVENT, iterations up to {int(got[1][:, 5].max())}; "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"K2 with {mode} disagrees with its twin: "
                             f"{name} {dtype} B={B}")
    return dx


def check_extra_persistent_is_chunked(name, B, dtype, mode) -> None:
    p = run_extra_pair(name, B, dtype, mode)[0]
    c = run_extra_pair(name, B, dtype, mode, chunk=5)[0]
    same = [bool(torch.equal(a, b)) for a, b in zip(p[:4], c[:4])]
    for cp, cc in zip(p[4:], c[4:]):
        if cp is not None:
            same += [a is None or bool(torch.equal(a, b))
                     for a, b in zip(cp, cc)]
    print(f"[extra-kernel] persistent vs chunks of 5, {name} {mode} "
          f"{str(dtype)[6:]} B={B}: every carry bitwise equal {all(same)}",
          flush=True)
    if not all(same):
        raise AssertionError("persistent and chunked K2 with events differ")


def extra_kernel_phase() -> float:
    """K2's event / dense switch against its twin on every step: f64 at
    1000 rows (ragged tiles) with events and dense output together and
    with events and saves (tests/test_torch_cuda.py runs each mode
    alone), f32 events and dense output at the paths' batches."""
    for name in EXTRA_STEPS:
        for mode in ("both", "saves"):
            if not (name.startswith("lz") and mode == "saves"):
                check_extra_pair(name, 1000, torch.float64, mode)
    check_extra_persistent_is_chunked("rk", 1000, torch.float64, "both")
    check_extra_persistent_is_chunked("magnus4", 1000, torch.float64, "saves")
    errs = {}
    for mode in ("events", "dense"):
        check_extra_pair("magnus4", N_TRAJ, torch.float32, mode)
        check_extra_pair("cfm4", LOOP_TRAJ, torch.float32, mode)
        check_extra_pair("lz_magnus4", N_TRAJ, torch.float32, mode)
        errs[mode] = check_extra_pair("rk", LOOP_TRAJ, torch.float32, mode)
    return errs


def compare_events(a, b, label, t_tol, min_frac=0.99):
    """Two solves of the same events on different paths (f32): status,
    found and count equal on at least ``min_frac`` of the rows, and on
    those the located times within t_tol. Returns (rows agreeing, max
    |dt|)."""
    agree = ((a.status == b.status) & (a.event_found == b.event_found).all(1)
             & (a.event_count == b.event_count).all(1))
    ta, tb = a.event_t_k[agree], b.event_t_k[agree]
    fin = torch.isfinite(tb)
    same_mask = bool((torch.isfinite(ta) == fin).all())
    dt = _max(ta[fin] - tb[fin])
    n = a.status.shape[0]
    ok = int(agree.sum()) >= min_frac * n and same_mask and dt <= t_tol
    print(f"[{label}] status, found and count equal on {int(agree.sum())}/"
          f"{n} rows (>= {min_frac:.0%}); located times within {dt:.3e} "
          f"(<= {t_tol:g}); {int(b.event_found.sum())} crossings found, "
          f"{int((b.status == DONE_EVENT).sum())} rows DONE_EVENT; "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"{label}: the paths disagree on the events")
    return int(agree.sum()), dt


def check_event_solution(sol, n, label):
    """Every row DONE or DONE_EVENT, finite, |psi| = 1 within 1e-4."""
    ended = int(((sol.status == DONE) | (sol.status == DONE_EVENT)).sum())
    assert ended == n, f"{label}: {n - ended} rows neither DONE nor stopped"
    y = torch.complex(sol.y_final.re, sol.y_final.im)
    norm_dev = float((y.abs().pow(2).sum(-1).sqrt() - 1).abs().max())
    assert norm_dev <= 1e-4, f"{label}: |psi| drifted by {norm_dev}"
    return norm_dev


def events_loop_phase():
    """Path 1: the RK loop path (2048x64c) with drive_events in one K2
    launch, against the same solve through the host driver with a K1
    launch per iteration; path 2: the RK main path at 16384 with the
    events in the host driver (K1 per iteration), against K2 run on the
    same 16384 rows. Returns the K2 launches of path 1."""
    cfg = drive_events()
    st, y0 = main_inputs(LOOP_TRAJ)
    reset_counts()
    sol = ensemble_solve(None, y0, 0.0, TF, stepper=st, ctl=CTL, h0=H0,
                         time_dtype=torch.float32, events=cfg)
    torch.cuda.synchronize()
    k = counts()
    assert sol.path == "cuda-loop-persistent", sol.path
    assert k == (0, 1, 0), k
    check_event_solution(sol, LOOP_TRAJ, "events-loop")
    grid = driver.make_grid(0.0, TF, dtype=torch.float32, device="cuda")
    reset_counts()
    ref = driver.integrate(st.make_step_fn(), y0, grid, H0, ctl=CTL,
                           error_norm=st.error_norm,
                           batch_shape=(LOOP_TRAJ,), event_cfg=cfg)
    torch.cuda.synchronize()
    k_ref = counts()
    assert k_ref == (int(ref.n_iters.max()), 0, 0), k_ref
    print(f"[events-loop] {LOOP_TRAJ}x{DIM}c RKF45 with Re z_3 (K = 3) and "
          f"a terminal |z_0|^2 = 0.03: path={sol.path}, launches K1/K2/K4 = "
          f"{k[0]}/{k[1]}/{k[2]}; the host driver's run: {k_ref[0]} K1 "
          f"launches; n_iters up to {int(sol.n_iters.max())} (loop) and "
          f"{int(ref.n_iters.max())} (driver)", flush=True)
    compare_events(sol, ref, "events-loop", EV_TOL)

    st, y0 = main_inputs()
    reset_counts()
    main = ensemble_solve(None, y0, 0.0, TF, stepper=st, ctl=CTL, h0=H0,
                          time_dtype=torch.float32, events=cfg)
    torch.cuda.synchronize()
    k1 = counts()
    assert main.path == "torch-driver+cuda-step", main.path
    assert k1 == (int(main.n_iters.max()), 0, 0), k1
    check_event_solution(main, N_TRAJ, "events-main")
    x0 = torch.cat([y0.re, y0.im], 1)
    out = fused_loop_integrate(grid, x0, H0, RKStep(M0=st.M0, M1=st.M1,
                                                    w=st.w),
                               ctl=CTL, persistent=True,
                               events=cfg.kernel_spec(DIM, 2))
    loop = loop_solution(grid, x0, out, path="k2",
                         unwiden=lambda xw: Cplx(xw[..., :DIM],
                                                 xw[..., DIM:]))
    print(f"[events-loop] the main path at {N_TRAJ}x{DIM}c with the same "
          f"events in the host driver: path={main.path}, K1 launches="
          f"{k1[0]} == max n_iters; held against K2 on the same rows",
          flush=True)
    compare_events(main, loop, "events-loop main path vs K2", EV_TOL)
    return k[1]


def events_chain_phase():
    """Path 3: the Magnus-4 loop path (16384x64c) with drive_events in one
    K2 launch (K5), against the per-step path (no declared form: K4 per
    iteration, the events in the host driver); CFM-4 (R = 2) the same in
    the loop. Returns the K2 launches of the Magnus-4 run."""
    cfg = drive_events()
    sols = {}
    for kind in ("magnus4", "cfm4"):
        st, y0 = r_inputs(kind)
        reset_counts()
        sols[kind] = ensemble_solve(None, y0, 0.0, TF, stepper=st,
                                    ctl=MAG_CTL, h0=H0,
                                    time_dtype=torch.float32, events=cfg)
        torch.cuda.synchronize()
        k = counts()
        assert sols[kind].path == "cuda-loop-persistent", sols[kind].path
        assert k == (0, 1, 0), (kind, k)
        check_event_solution(sols[kind], N_TRAJ, f"events-chain {kind}")
        print(f"[events-chain] {kind} {N_TRAJ}x{DIM}c with Re z_3 and the "
              f"terminal threshold: path={sols[kind].path}, launches K1/K2/"
              f"K4 = {k[0]}/{k[1]}/{k[2]}, n_iters up to "
              f"{int(sols[kind].n_iters.max())}", flush=True)
    st, y0 = r_inputs("magnus4", form=False)
    reset_counts()
    ref = ensemble_solve(None, y0, 0.0, TF, stepper=st, ctl=MAG_CTL, h0=H0,
                         time_dtype=torch.float32, events=cfg)
    torch.cuda.synchronize()
    k = counts()
    assert ref.path == "torch-driver+cuda-step", ref.path
    assert k == (0, 0, int(ref.n_iters.max())), k
    print(f"[events-chain] the per-step path (no declared form): path="
          f"{ref.path}, {k[2]} K4 launches == max n_iters", flush=True)
    compare_events(sols["magnus4"], ref, "events-chain loop vs per-step",
                   EV_TOL)


def events_lz_phase():
    """Path 5: 16384 Landau-Zener sweeps from |0> (d = 2), adaptive
    Magnus-4 in the loop (K2 + K5) with bench.py:779-826's two checks,
    each against the per-step path (K4, the events in the host driver):
    at v = 2 a terminal threshold stops every sweep; at v = 0 every sweep
    counts five crossings of |c1|^2 = sin^2(delta (t + 20) / 2) = 1/2 and
    locates the first three at t_n = -20 + (2n + 1) pi / (2 delta), within
    t_tol = 1e-4: the located time is the regula-falsi point of a bracket
    of at most t_tol, and the f32 integration error at rtol 1e-5 moves
    |c1|^2 by ~1e-6 at a slope of delta / 2 = 0.2 (9.7e-7 in the twin on
    the CPU)."""
    psi = np.zeros((N_TRAJ, 2), np.complex64)
    psi[:, 0] = 1.0
    y0 = from_complex(psi, torch.float32, device="cuda")
    delta = LZ["delta"]
    for v in (LZ["v"], 0.0):
        op = LandauZener(v=v, delta=delta).modulated(torch.float32,
                                                     device="cuda")
        out = {}
        for form in (True, False):
            st = MagnusModulated4(op if form
                                  else dataclasses.replace(op, form=None))
            reset_counts()
            out[form] = ensemble_solve(
                None, y0, -LZ_T, LZ_T, stepper=st, ctl=LZ_EV_CTL,
                h0=LZ_EV_H0, time_dtype=torch.float32, events=lz_events(v))
            torch.cuda.synchronize()
            k = counts()
            want = (0, 1, 0) if form else (0, 0, int(out[form].n_iters.max()))
            assert k == want, (v, form, k)
        loop, step = out[True], out[False]
        assert loop.path == "cuda-loop-persistent", loop.path
        assert step.path == "torch-driver+cuda-step", step.path
        compare_events(loop, step, f"events-lz v={v:g} loop vs per-step",
                       LZ_EV_TOL, min_frac=1.0)
        if v:
            assert bool((loop.status == DONE_EVENT).all())
            print(f"[events-lz] v={v:g}: all {N_TRAJ} sweeps stopped at the "
                  f"terminal threshold, t = {float(loop.event_t.min()):.6f}"
                  f"..{float(loop.event_t.max()):.6f}", flush=True)
            continue
        assert bool((loop.status == DONE).all())
        assert bool((loop.event_count == 5).all()), loop.event_count.unique()
        t_n = -LZ_T + (2 * np.arange(3) + 1) * np.pi / (2 * delta)
        dt = float((loop.event_t_k[:, 0].double()
                    - torch.as_tensor(t_n, device="cuda")).abs().max())
        assert dt <= LZ_EV_TOL, dt
        print(f"[events-lz] v=0: every sweep counts 5 crossings and locates "
              f"3 at {[round(x, 6) for x in t_n.tolist()]}, max |t - t_n|="
              f"{dt:.3e} (<= {LZ_EV_TOL:g}); one loop launch a solve",
              flush=True)


def dense_loop_phase():
    """Paths 1 and 3 with dense output at the nine save times: one K2
    launch each (path ``-dense``); the step sequence is the plain [t0, tf]
    solve's (n_accept equal, one iteration fewer: no t0 iteration), fewer
    iterations than grid-hit saves at the same times, and the interpolant
    against the host driver's dense tier on the per-step path (K1) and
    against the grid-hit saves. Returns (K2 launches, the Magnus-4 dense
    solution)."""
    st, y0 = main_inputs(LOOP_TRAJ)
    reset_counts()
    sol = ensemble_solve(None, y0, 0.0, TF, stepper=st, ctl=CTL, h0=H0,
                         time_dtype=torch.float32, save_at=SAVE_AT,
                         dense=True)
    torch.cuda.synchronize()
    k = counts()
    launches = k[1]
    assert sol.path == "cuda-loop-persistent-dense", sol.path
    assert k == (0, 1, 0), k
    plain = solve(st, y0)
    hit = solve(st, y0, SAVE_AT)
    # the same controller and step over [t0, tf], free-running: the same
    # accepted steps where the two kernel builds round alike, and no t0
    # iteration; grid-hit saves take more
    same = int(((sol.n_accept == plain.n_accept)
                & (sol.n_iters + 1 == plain.n_iters)).sum())
    assert (float(sol.n_iters.float().mean())
            < float(hit.n_iters.float().mean()))
    grid = driver.make_grid(0.0, TF, SAVE_AT, dtype=torch.float32,
                            device="cuda")
    reset_counts()
    ref = _batched_dense_fallback(st, st.make_step_fn(), y0, grid, H0,
                                  adaptive=True, ctl=CTL,
                                  batch_shape=(LOOP_TRAJ,))
    torch.cuda.synchronize()
    assert ref.path == "torch-driver+cuda-step-dense", ref.path
    assert counts()[0] == int(ref.n_iters.max())
    dcount = int((sol.n_accept - ref.n_accept).abs().max())
    dy = max(_max(sol.ys.re - ref.ys.re), _max(sol.ys.im - ref.ys.im))
    dhit = max(_max(sol.ys.re - hit.ys.re), _max(sol.ys.im - hit.ys.im))
    assert dcount <= 2 and dy <= 1e-4 and dhit <= 1e-4, (dcount, dy, dhit)
    print(f"[dense-loop] {LOOP_TRAJ}x{DIM}c RKF45, dense at {len(SAVE_AT)} "
          f"times: path={sol.path}, launches K1/K2/K4 = {k[0]}/{k[1]}/{k[2]};"
          f" n_iters up to {int(sol.n_iters.max())} against "
          f"{int(plain.n_iters.max())} on [t0, tf] (n_accept equal and one "
          f"t0 iteration fewer on {same}/{LOOP_TRAJ} rows) and "
          f"{int(hit.n_iters.max())} with grid-hit "
          f"saves (mean {float(sol.n_iters.float().mean()):.2f} / "
          f"{float(hit.n_iters.float().mean()):.2f}); against the host "
          f"driver's dense tier (K1): max|dcount|={dcount} (<= 2), "
          f"max|dys|={dy:.3e} (<= 1e-4); against the grid-hit saves "
          f"{dhit:.3e} (<= 1e-4)", flush=True)
    dense_sols = {}
    for kind in ("magnus4", "cfm4"):
        st, y0 = r_inputs(kind)
        reset_counts()
        dense_sols[kind] = ensemble_solve(
            None, y0, 0.0, TF, stepper=st, ctl=MAG_CTL, h0=H0,
            time_dtype=torch.float32, save_at=SAVE_AT, dense=True)
        torch.cuda.synchronize()
        k = counts()
        s = dense_sols[kind]
        assert s.path == "cuda-loop-persistent-dense", s.path
        assert k == (0, 1, 0), (kind, k)
        check_unit_solution(s, N_TRAJ, kind)
        ys = torch.complex(s.ys.re, s.ys.im)
        norm_dev = float((ys.abs().pow(2).sum(-1).sqrt() - 1).abs().max())
        assert norm_dev <= 1e-4, norm_dev
        print(f"[dense-loop] {kind} {N_TRAJ}x{DIM}c dense at {len(SAVE_AT)} "
              f"times: path={s.path}, launches K1/K2/K4 = {k[0]}/{k[1]}/"
              f"{k[2]}, all DONE, every slot's |psi| within {norm_dev:.3e} "
              f"of 1, n_iters up to {int(s.n_iters.max())}", flush=True)
    return launches, dense_sols["magnus4"]


def dense_step_phase(loop_sol):
    """Path 4: the Magnus-4 per-step path (no declared form) with dense
    output: the host driver's integrate_interp with Hermite slopes A(t) x,
    a K4 launch per iteration; against the loop path's dense output."""
    st, y0 = r_inputs("magnus4", form=False)
    reset_counts()
    sol = ensemble_solve(None, y0, 0.0, TF, stepper=st, ctl=MAG_CTL, h0=H0,
                         time_dtype=torch.float32, save_at=SAVE_AT,
                         dense=True)
    torch.cuda.synchronize()
    k = counts()
    assert sol.path == "torch-driver+cuda-step-dense", sol.path
    assert k == (0, 0, int(sol.n_iters.max())), k
    dcount = max(int((getattr(sol, c) - getattr(loop_sol, c)).abs().max())
                 for c in ("n_accept", "n_reject", "n_iters"))
    dy = max(_max(sol.ys.re - loop_sol.ys.re),
             _max(sol.ys.im - loop_sol.ys.im))
    assert dcount <= 1 and dy <= 1e-4, (dcount, dy)
    print(f"[dense-step] Magnus-4 {N_TRAJ}x{DIM}c per step, dense at "
          f"{len(SAVE_AT)} times: path={sol.path}, {k[2]} K4 launches == max "
          f"n_iters; against the loop path's dense output: max|dcount|="
          f"{dcount} (<= 1), max|dys|={dy:.3e} (<= 1e-4)", flush=True)
    return k[2]


def event_flops(spec, iters) -> float:
    """g of every event at ``iters`` row-iterations: 2 D (lin) or 3 D
    (quad) operations a row."""
    D = spec.rows.shape[1]
    return iters * sum(2 * D if k == "lin" else 3 * D for k in spec.kinds)


# -- 3 to 8 basis terms (K' up to 36) in K4 and K5 ------------------------

K0_CASES = (3, 5, 8)
# the recipes K4 is held to its twin on at each K0
K0_KINDS = ("midpoint", "magnus4", "magnus4_fast", "magnus6", "magnus6_fixed",
            "cfm4", "blanes")


def multi_coeffs(t, K0):
    """The coefficients of the K0-term drive on [0, 1]: [1, t, cos 2 pi t,
    sin 2 pi t, cos 4 pi t, sin 4 pi t, cos 6 pi t, sin 6 pi t][:K0]
    (their probe matrix has sigma_8 / sigma_1 ~ 0.13), (...,) -> (...,
    K0)."""
    cols = [torch.ones_like(t), t]
    for n in (1, 2, 3):
        a = (2.0 * math.pi * n) * t
        cols += [torch.cos(a), torch.sin(a)]
    return torch.stack(cols[:K0], -1)


def multi_basis(K0, dtype, device="cuda", d=DIM):
    """-i H0 of DrivenDense(d, seed 0) and -i V of DrivenDense(d, seed s),
    s = 1 .. K0 - 1: the drift and K0 - 1 controls, a Cplx (K0, d, d)."""
    hs = [DrivenDense.make(d=d, seed=0).H0] + [
        DrivenDense.make(d=d, seed=s).V for s in range(1, K0)]
    H = from_complex(np.stack(hs), dtype, device=device)
    return Cplx(H.im, -H.re)


def multi_op(K0, dtype, form=None, device="cuda"):
    """The K0-term drive as a ModulatedOperator: its exact coefficients,
    or the declared ``form`` (sampled in-kernel in the loop)."""
    return texp.ModulatedOperator(
        basis=multi_basis(K0, dtype, device),
        coeff_fn=(lambda t: multi_coeffs(t, K0)) if form is None
        else form.sample, form=form)


def multi_cheb(K0, deg=40):
    """multi_coeffs fitted on [0, 1] by a Chebyshev series of degree deg
    at 2 deg + 2 Chebyshev-Gauss points, in float64."""
    n = 2 * deg + 2
    u = np.cos(np.pi * (2 * np.arange(n) + 1) / (2 * n))
    C = multi_coeffs(torch.as_tensor(0.5 + 0.5 * u), K0).numpy()
    return texp.ChebForm(np.polynomial.chebyshev.chebfit(u, C, deg), 0.0,
                         1.0)


def k0_stepper(kind, op):
    if kind == "midpoint":
        return MidpointModulated(op)
    if kind == "magnus4_fast":
        return MagnusModulated4(op, fast_error=True)
    return r_stepper(kind, op)


# the loop kernel's cases over the k0-term drive with its Chebyshev form
K0_LOOP_CASES = {
    **{f"k0_{K}_{kind}": dict(k0=K, kind=kind) for K, kind in (
        (3, "magnus4"), (3, "magnus6"), (5, "magnus4"), (5, "cfm4"),
        (8, "magnus4"), (8, "magnus6"), (8, "cfm4"))},
    "k0_8_fast_error": dict(k0=8, fast_error=True),
    "k0_8_midpoint": dict(k0=8, midpoint=True, h0=0.05),
    "k0_8_magnus6_fixed": dict(k0=8, kind="magnus6_fixed", h0=0.05),
    "k0_8_save_grid": dict(k0=8, grid=(0.0, 0.075, 0.15, 0.225, 0.3)),
    "k0_8_pi_weighted": dict(k0=8, ctl=dict(pi=True), norm=("l2", True)),
}
# the recovered operators' loops at their paths' batch: the I/Q drive
# (K' = 6) and the black-box DrivenDense with its ChebForm (K' = 3)
K0_PATHS = {"iq_path": dict(k0="iq", grid=(0.0, TF)),
            "auto_path": dict(k0="auto", grid=(0.0, TF))}
K0_LOOP_CASES.update(K0_PATHS)


def k0_step_phase() -> float:
    """K4 over 3, 5 and 8 basis terms (K' up to 36 for the Magnus
    recipes) against its twin at 2048x64c in f64 and f32, on every recipe:
    check_chain_step's limits. Returns max |dy| of Magnus-4 at K0 = 8 in
    f32."""
    err = 0.0
    for K0 in K0_CASES:
        for kind in K0_KINDS:
            for dtype in (torch.float64, torch.float32):
                dy, _ = check_chain_step(
                    LOOP_TRAJ, dtype, f"K0={K0} {kind}",
                    make=lambda dt_, k=kind, K=K0: k0_stepper(
                        k, multi_op(K, dt_)))
                if (K0, kind, dtype) == (8, "magnus4", torch.float32):
                    err = dy
    return err


def k0_loop_phase() -> float:
    """K5 over 3, 5 and 8 basis terms with a ChebForm in the loop kernel
    against the loop's twin: f64 at B = 1000 (counters equal per
    trajectory), f32 at 2048, persistent against chunked, K2's event /
    dense switch on at K0 = 8, and the recovered operators' loops at their
    paths' 16384 (the I/Q drive, K' = 6; the black-box DrivenDense, K' =
    3, sampling its ChebForm). Returns {"k0": max |dx| of the I/Q path,
    "cheb": of the black-box DrivenDense path}."""
    for name in K0_LOOP_CASES:
        if name not in K0_PATHS:
            check_chain_loop_pair(name, 1000, torch.float64)
    check_chain_loop_pair("k0_8_magnus6", LOOP_TRAJ, torch.float32)
    check_chain_persistent_is_chunked("k0_8_save_grid", 1000, torch.float64)
    check_extra_pair("k0_8_magnus4", 1000, torch.float64, "both")
    check_extra_pair("k0_8_cfm4", 1000, torch.float64, "saves")
    check_chain_loop_pair("k0_8_magnus4", LOOP_TRAJ, torch.float32)
    return {"k0": check_chain_loop_pair("iq_path", N_TRAJ, torch.float32),
            "cheb": check_chain_loop_pair("auto_path", N_TRAJ,
                                          torch.float32)}


# -- black-box operators through auto_modulated ----------------------------

AUTO_REC_SEED = 2   # benchmarks.py:609-660: the record's 256 states


def make_auto_drive_op(fit_cols: bool = True):
    """DrivenDense(64, seed 0)'s op_pair as a black box through
    auto_modulated on [0, 1] (benchmarks.py:609): two terms, with a fitted
    ChebForm unless fit_cols is off."""
    dd = DrivenDense.make(d=DIM, seed=0)
    mod = texp.auto_modulated(lambda t: dd.op_pair(t, torch.float32), 0.0,
                              TF, fit_cols=fit_cols)
    assert mod is not None and mod.n_terms == 2, mod
    assert isinstance(mod.form, texp.ChebForm) == fit_cols, mod.form
    return mod


auto_drive_op = functools.cache(make_auto_drive_op)


def timed_setup(fn):
    """(fn(), seconds of host wall until the card is idle) of one call."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


@functools.cache
def iq_parts():
    """H0, V of DrivenDense(64, seed 0) and V2 = DrivenDense(64, seed 1).V
    on the card, and w."""
    m0 = DrivenDense.make(d=DIM, seed=0)
    H = from_complex(np.stack([m0.H0, m0.V,
                               DrivenDense.make(d=DIM, seed=1).V]),
                     torch.float32, device="cuda")
    return H, float(m0.w)


def iq_op_fn(t):
    """The I/Q-driven qudit as a black box: A(t) = -i (H0 + cos(w t) V +
    sin(w t) V2), the rotating-frame pulse with in-phase and quadrature
    controls, f32 on the card."""
    H, w = iq_parts()
    t = (t.to(torch.float32) if isinstance(t, torch.Tensor)
         else torch.tensor(t, dtype=torch.float32, device="cuda"))
    c = torch.stack([torch.ones_like(t), torch.cos(w * t),
                     torch.sin(w * t)])
    return Cplx(torch.einsum("k,kij->ij", c, H.im),
                -torch.einsum("k,kij->ij", c, H.re))


@functools.cache
def iq_op(fit_cols: bool = True):
    mod = texp.auto_modulated(iq_op_fn, 0.0, TF, fit_cols=fit_cols)
    assert mod is not None and mod.n_terms == 3, mod
    assert isinstance(mod.form, texp.ChebForm) == fit_cols, mod.form
    return mod


def auto_solve(mod, y0):
    """Adaptive Magnus-4 at benchmarks.py:609's settings (rtol 1e-5,
    min_dt 1e-5, max_dt 0.25, h0 1e-2), f32, t in [0, 1]."""
    return ensemble_solve(None, y0, 0.0, TF, stepper=MagnusModulated4(mod),
                          ctl=GEN_CTL, h0=GEN_H0, time_dtype=torch.float32)


def counted(fn):
    """(fn(), (K1, K2, K4 launches), K9 launches) of one run."""
    reset_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, counts(), fused_dense_chain_apply.launches


def dcounts(a, b) -> tuple:
    return tuple(int((getattr(a, k) - getattr(b, k)).abs().max())
                 for k in ("n_accept", "n_reject", "n_iters"))


def check_routes(label, loop, step, n, *others):
    """The loop route's solution (one K2 launch) and the per-step route's
    (a K4 launch per iteration) on the same states: all DONE, |psi| = 1
    within 1e-4, counters within 1 / 1 / 2 and states within 1e-4 of each
    other (f32 rounding moves a step at the controller's edge); each of
    ``others`` (label, solution, state limit) within its limit of the
    loop route."""
    (sol, c_loop, _), (ssol, c_step, _) = loop, step
    assert sol.path == "cuda-loop-persistent", sol.path
    assert ssol.path == "torch-driver+cuda-step", ssol.path
    assert c_loop == (0, 1, 0), c_loop
    assert c_step[:2] == (0, 0) and c_step[2] == int(ssol.n_iters.max()), \
        c_step
    dev = max(check_unit_solution(sol, n, label),
              check_unit_solution(ssol, n, label))
    dc, dy = dcounts(sol, ssol), max_dy(sol, ssol)
    assert dc[0] <= 1 and dc[1] <= 1 and dc[2] <= 2 and dy <= 1e-4, (dc, dy)
    line = (f"[{label}] {n}x{DIM}c: loop route {sol.path} (K1/K2/K4 "
            f"{c_loop}), per-step route {ssol.path} ({c_step[2]} K4 launches"
            f" == max n_iters); all DONE, max||psi|-1|={dev:.3e} (<= 1e-4); "
            f"n_iters up to {int(sol.n_iters.max())}; per-step vs loop: "
            f"counters differ by {dc} (<= 1 / 1 / 2), max|dy|={dy:.3e} "
            f"(<= 1e-4)")
    for name, other, lim in others:
        dy_o = max_dy(sol, other)
        assert int((other.status == DONE).sum()) == n, name
        assert dy_o <= lim, (name, dy_o)
        line += (f"; {name} vs loop: counters differ by "
                 f"{dcounts(sol, other)}, max|dy|={dy_o:.3e} (<= {lim:g})")
    print(line, flush=True)


def auto_phase() -> int:
    """[auto] The black-box DrivenDense (benchmarks.py:609): auto_modulated
    recovers two terms and a ChebForm; adaptive Magnus-4 at 16 384 (the
    main path's states) and at the record's 256 (default_rng(2)) on the
    loop route (one K2 launch, K5 sampling the ChebForm) and the per-step
    route (fit_cols off: a K4 launch per iteration), held against the
    declared-CoeffForm loop (DrivenDense.modulated) and the generic
    Magnus4(DenseCplxSplit) over the same op_fn (K9). Returns the 16 384
    loop's K2 launches."""
    # each set-up timed on its own uncached call: probes, SVD and, with
    # fit_cols, the Chebyshev fit and its validation
    mod, fit_s = timed_setup(lambda: make_auto_drive_op(True))
    mod_step, proj_s = timed_setup(lambda: make_auto_drive_op(False))
    print(f"[auto] auto_modulated(DrivenDense(64).op_pair, 0, 1): "
          f"{mod.n_terms} terms, ChebForm of {mod.form.n_coeffs} "
          f"coefficients per term; set-up {fit_s:.4f} s", flush=True)
    print(f"[auto] auto_modulated(..., fit_cols=False): {mod_step.n_terms} "
          f"terms, no form; set-up {proj_s:.4f} s", flush=True)
    declared = MagnusModulated4(DrivenDense.make(d=DIM, seed=0).modulated(
        torch.float32, device="cuda"))
    k2 = 0
    for n, seed in ((N_TRAJ, 42), (REC_B, AUTO_REC_SEED)):
        y0 = unit_states(n, DIM, torch.float32, seed)
        loop = counted(lambda: auto_solve(mod, y0))
        k2 = k2 or loop[1][1]
        step = counted(lambda: auto_solve(mod_step, y0))
        dsol = ensemble_solve(None, y0, 0.0, TF, stepper=declared,
                              ctl=GEN_CTL, h0=GEN_H0,
                              time_dtype=torch.float32)
        gen, c_gen, k9 = counted(lambda: generic_solve(y0))
        assert gen.path == "torch-driver+cuda-step" and c_gen == (0, 0, 0)
        assert k9 == int(gen.n_iters.max()), (k9, int(gen.n_iters.max()))
        check_routes("auto", loop, step, n,
                     ("declared CoeffForm loop", dsol, 1e-4),
                     (f"generic Magnus4 over op_fn ({k9} K9 launches)", gen,
                      5e-4))
    return k2


def auto_lz_phase() -> None:
    """[auto-lz] benchmarks.py:284: LandauZener(2.0, 0.4).op_pair as a
    black box over [-20, 20]: two terms and a ChebForm; 1024 sweeps from
    |0> by adaptive Magnus-4 (rtol 1e-5, max_steps 20000, h0 0.05) in one
    loop launch (unpacked), all DONE, |psi| = 1 within 1e-4, the |0>
    population within 0.02 of the closed form P_LZ."""
    lz = LandauZener(**LZ)
    mod = texp.auto_modulated(lambda t: lz.op_pair(t, torch.float32),
                              -LZ_T, LZ_T, dtype=torch.float32)
    assert mod is not None and mod.n_terms == 2
    assert isinstance(mod.form, texp.ChebForm)
    psi = np.zeros((1024, 2), np.complex64)
    psi[:, 0] = 1.0
    y0 = from_complex(psi, torch.float32, device="cuda")
    ctl = StepControl(rtol=1e-5, max_steps=20000)
    sol, c, _ = counted(lambda: ensemble_solve(
        None, y0, -LZ_T, LZ_T, stepper=MagnusModulated4(mod), ctl=ctl,
        h0=0.05, time_dtype=torch.float32))
    assert sol.path == "cuda-loop-persistent" and c == (0, 1, 0), (sol.path,
                                                                   c)
    assert int((sol.status == DONE).sum()) == 1024
    y = torch.complex(sol.y_final.re, sol.y_final.im)
    dev = float((y.abs().pow(2).sum(-1).sqrt() - 1).abs().max())
    p_stay = y[:, 0].abs().pow(2)
    dp = float((p_stay - lz.p_transition).abs().max())
    assert dev <= 1e-4 and dp <= 0.02, (dev, dp)
    print(f"[auto-lz] 1024 Landau-Zener sweeps, black-box op_pair through "
          f"auto_modulated ({mod.n_terms} terms, ChebForm of "
          f"{mod.form.n_coeffs} coefficients): path={sol.path}, K1/K2/K4 "
          f"{c}; all DONE, max||psi|-1|={dev:.3e}, |P(|0>) - P_LZ|="
          f"{dp:.4f} (<= 0.02; P_LZ={lz.p_transition:.4f}), n_iters "
          f"{int(sol.n_iters.min())}..{int(sol.n_iters.max())}", flush=True)


def k0_path_phase() -> tuple:
    """[k0] The I/Q drive (K = 3, K' = 6) recovered from its black box, at
    16 384x64c f32 on the loop and per-step routes (check_routes); K4
    against its twin on the I/Q step at that batch; the eight-term drive
    recovered from its black box (K = 8, K' = 36) in one loop solve at
    2048x64c against the per-step route. Returns (K4 launches of the I/Q
    per-step solve, K2 launches of its loop solve, K4 max |dy| at the
    path)."""
    y0 = unit_states(N_TRAJ, DIM, torch.float32, 42)
    loop = counted(lambda: auto_solve(iq_op(), y0))
    step = counted(lambda: auto_solve(iq_op(fit_cols=False), y0))
    check_routes("k0 iq", loop, step, N_TRAJ)
    k4_err = check_chain_step(N_TRAJ, torch.float32, "I/Q magnus4 pair",
                              make=lambda dt_: MagnusModulated4(
                                  iq_op(fit_cols=False)))[0]
    fn = multi_op_fn(8)
    mod = texp.auto_modulated(fn, 0.0, TF)
    assert mod is not None and mod.n_terms == 8, mod
    assert isinstance(mod.form, texp.ChebForm)
    y8 = unit_states(LOOP_TRAJ, DIM, torch.float32, 42)
    check_routes("k0 eight terms", counted(lambda: auto_solve(mod, y8)),
                 counted(lambda: auto_solve(
                     dataclasses.replace(mod, form=None), y8)), LOOP_TRAJ)
    return step[1][2], loop[1][1], k4_err


def multi_op_fn(K0):
    """The K0-term drive as a black box, f32 on the card."""
    basis = multi_basis(K0, torch.float32)

    def op_fn(t):
        t = (t.to(torch.float32) if isinstance(t, torch.Tensor)
             else torch.tensor(t, dtype=torch.float32, device="cuda"))
        c = multi_coeffs(t, K0)
        return Cplx(torch.einsum("k,kij->ij", c, basis.re),
                    torch.einsum("k,kij->ij", c, basis.im))
    return op_fn


def k0_timing_phase(card):
    """K4 per launch at K' = 6 (the I/Q step) and 36 (the eight-term
    drive) at 16384x64c f32 against its twin, bound and library
    yardstick; K2 + K5 per solve for the I/Q loop; the ChebForm loop
    against the declared CoeffForm loop on DrivenDense (the same steps, in
    turns). Returns the numbers of fused_chain_apply/k0 (K' = 6),
    chain_step_tile/k0 (I/Q) and chain_step_tile/cheb."""
    k4 = time_k4(MagnusModulated4(iq_op(fit_cols=False)), N_TRAJ,
                 "I/Q Magnus-4 pair (K' = 6)", card)
    time_k4(MagnusModulated4(multi_op(8, torch.float32)), N_TRAJ,
            "eight-term Magnus-4 pair (K' = 36)", card)
    y0 = unit_states(N_TRAJ, DIM, torch.float32, 42)
    # the eight-term drive per step (K4 at K' = 36 each iteration)
    eight = counted(lambda: auto_solve(multi_op(8, torch.float32), y0))
    check_unit_solution(eight[0], N_TRAJ, "eight-term per-step route")
    assert eight[1][2] == int(eight[0].n_iters.max()), eight[1]
    timed_solve(lambda: auto_solve(multi_op(8, torch.float32), y0),
                f"eight-term per-step route {N_TRAJ}x{DIM}c f32 (K' = 36): "
                f"{eight[1][2]} K4 launches a solve", card)
    timed_solve(lambda: auto_solve(iq_op(), y0),
                f"I/Q loop route {N_TRAJ}x{DIM}c f32, one loop launch", card)
    timed_solve(lambda: auto_solve(iq_op(fit_cols=False), y0),
                f"I/Q per-step route on the same {N_TRAJ} inputs (K4)", card)
    k5 = time_k5(MagnusModulated4(iq_op()), y0, MAG_CTL, "I/Q loop", card)
    cheb = MagnusModulated4(auto_drive_op())
    coeff = MagnusModulated4(DrivenDense.make(d=DIM, seed=0).modulated(
        torch.float32, device="cuda"))
    grid = driver.make_grid(0.0, TF, dtype=torch.float32, device="cuda")
    runs = {}
    for name, st in (("cheb", cheb), ("coeff", coeff)):
        mt, norms, m, theta = chain_operands(st, torch.float32)
        step = ChainStep(mt=mt, norms=norms, form=st.op.form,
                         recipe=st._recipe, C=st._chains, m=m, theta=theta)
        carries = init_carries(grid, torch.cat([y0.re, y0.im], 1), H0)
        runs[name] = (lambda c=carries, s=step: fused_loop_chunk(
            *c, s, ctl=MAG_CTL))
    times = {name: [] for name in runs}
    for _ in range(3):  # in turns
        for name, fn in runs.items():
            times[name].append(timed_ms(fn, reps=1))
    ms = {name: statistics.median(v) for name, v in times.items()}
    print(f"[time] K2 + K5 per solve on DrivenDense {N_TRAJ}x{DIM}c f32, "
          f"the same steps (not the same passes: the recovered orthonormal "
          f"basis and the declared one bound a row's 1-norm differently): "
          f"ChebForm (black box through auto_modulated) "
          f"{ms['cheb']:.4f} ms, declared CoeffForm {ms['coeff']:.4f} ms "
          f"(in turns: "
          f"{({n: [round(v, 4) for v in t] for n, t in times.items()})}) "
          f"({card})", flush=True)
    k5_cheb = time_k5(cheb, y0, MAG_CTL, "black-box DrivenDense loop", card)
    return k4, k5, k5_cheb


def time_extra(kind, card):
    """K2 alone per solve at path 1 (kind "rk", 2048x64c) or path 3
    ("magnus4", 16384x64c), f32, t in [0, 1]: without events or dense
    output, with drive_events, with dense output at the nine save times,
    and with grid-hit saves at them (in turns, median of 3); the twin once
    with events and once with dense output; the bound of each: the step's
    operations on every stepping row-iteration, g's, and the state, the
    carries and the dense endpoints moved once. Returns {mode: (ms,
    plain_ms, bound_ms, bound_by)} for events and dense."""
    cfg = drive_events()
    spec = cfg.kernel_spec(DIM, 2)
    if kind == "rk":
        st, y0 = main_inputs(LOOP_TRAJ)
        step, ctl = RKStep(M0=st.M0, M1=st.M1, w=st.w), CTL
    else:
        st, y0 = r_inputs(kind)
        mt, norms, m, theta = chain_operands(st, torch.float32)
        step = ChainStep(mt=mt, norms=norms, form=st.op.form,
                         recipe=st._recipe, C=st._chains, m=m, theta=theta,
                         table=st._table)
        ctl = MAG_CTL
    B, D = y0.re.shape[0], 2 * DIM
    x0 = torch.cat([y0.re, y0.im], 1)
    full = driver.make_grid(0.0, TF, SAVE_AT, dtype=torch.float32,
                            device="cuda")
    bare = full[[0, -1]]
    runs = {
        "none": lambda: fused_loop_integrate(bare, x0, H0, step, ctl=ctl,
                                             persistent=True),
        "events": lambda: fused_loop_integrate(bare, x0, H0, step, ctl=ctl,
                                               persistent=True, events=spec),
        "dense": lambda: fused_loop_integrate(
            bare, x0, H0, step, ctl=ctl, persistent=True,
            dense_times=full[1:-1]),
        "saves": lambda: fused_loop_integrate(full, x0, H0, step, ctl=ctl,
                                              persistent=True),
    }
    outs = {m: fn() for m, fn in runs.items()}
    times = {m: [] for m in runs}
    for _ in range(3):  # in turns
        for m, fn in runs.items():
            times[m].append(timed_ms(fn, reps=1))
    ms = {m: statistics.median(v) for m, v in times.items()}
    result = {}
    for mode in ("events", "dense"):
        t_grid = bare.clone()
        fs, ist, x, saves = init_carries(t_grid, x0, H0)[1:]
        ev = init_event_carry(spec, x) if mode == "events" else None
        dn = None
        if mode == "dense":
            dn = init_dense_carry(full[1:-1], x)
            ist[:, 0] = 1
        counter = step if kind == "rk" else PassCounter(step)
        p_ms = timed_ms(lambda: torch_fused_loop(
            t_grid, fs, ist, x, saves, counter, ctl=ctl,
            events=None if ev is None else spec, ev=ev, dense=dn), reps=1)
        ist_k = outs[mode][1]
        stepping = int((ist_k[:, 5] - (ist_k[:, 0] - (1 if dn else 0))).sum())
        if kind == "rk":
            flop = stepping * 2 * RKF45.stages * D * 2 * D
            op_bytes = 2 * D * D
        else:
            flop = chain_flops(counter.passes, D, step.m, step.recipe,
                               step.form.n_terms, counter.fast_rows)
            op_bytes = step.mt.numel()
        if mode == "events":
            flop += event_flops(spec, stepping)
        moved = 4 * (2 * B * (5 + D) + op_bytes + 2) + 2 * 4 * B * 8
        if mode == "events":
            E, K = spec.n, spec.k
            moved += 4 * (B * E * (K + 3) + 2 * B + E * B * D + E * D)
        else:
            n = full.shape[0] - 2
            moved += 4 * (2 * B * n + 2 * n * B * D + n)
        b_ms, b_by = bound(flop, moved)
        result[mode] = (ms[mode], p_ms, b_ms, b_by)
        print(f"[time] K2 {mode} at {kind} {B}x{DIM}c f32: kernel "
              f"{ms[mode]:.4f} ms (runs {[round(v, 4) for v in times[mode]]})"
              f", plain twin {p_ms:.4f} ms; bound {b_ms:.4f} ms by {b_by} "
              f"({stepping} stepping row-iterations, {flop / 1e9:.2f} GFLOP"
              f" with g, {moved / 1e6:.2f} MB), kernel at "
              f"{b_ms / ms[mode]:.1%} of it ({card})", flush=True)
    its = {m: int(o[1][:, 5].sum()) for m, o in outs.items()}
    print(f"[time] K2 at {kind} {B}x{DIM}c f32 per solve: none "
          f"{ms['none']:.4f} ms, events {ms['events']:.4f} ms, dense "
          f"{ms['dense']:.4f} ms, grid-hit saves {ms['saves']:.4f} ms "
          f"(runs {({m: [round(v, 4) for v in t] for m, t in times.items()})}"
          f"); row-iterations {its}, max n_iters "
          f"{({m: int(o[1][:, 5].max()) for m, o in outs.items()})} "
          f"({card})", flush=True)
    return result


def extra_timing_phase(card):
    out = {kind: time_extra(kind, card) for kind in ("rk", "magnus4")}
    return out["rk"]


def main() -> None:
    t_start = time.perf_counter()
    card = device_phase()
    build_phase(card)
    k1_err = step_phase()
    norm_phase()
    k2_err = loop_kernel_phase()
    k4_err = chain_step_phase()
    k5_err = chain_loop_kernel_phase()
    k4r_err = chain_step_r_phase()
    k5r_err = chain_loop_r_phase()
    extra_errs = extra_kernel_phase()
    k0_err = k0_step_phase()
    k0_loop_errs = k0_loop_phase()
    k9_err = dense_chain_phase()
    k1_launches = main_path_phase(card)
    k2_launches = loop_path_phase(card)
    k5_launches, loop_sol = r_loop_path_phase("magnus4")
    k4_launches = r_step_path_phase("magnus4", loop_sol)
    r_launches = {}
    for kind in R_KINDS:
        k5r_launches, r_sol = r_loop_path_phase(kind)
        r_launches[kind] = (r_step_path_phase(kind, r_sol), k5r_launches)
    lz_path_phase()
    k9_launches = generic_path_phase()
    adj_errs = adjoint_kernel_phase()
    k7_launches, k8_launches = adjoint_path_phase()
    adjoint_training_phase()
    k6_launches, adaptive_ts = adjoint_adaptive_phase()
    adaptive_adjoint_check("Magnus-6", card, order=6)
    adaptive_adjoint_check("CFM-4", card, scheme="cfm4")
    lindblad_phase(card)
    ev_launches = events_loop_phase()
    events_chain_phase()
    events_lz_phase()
    dense_launches, dense_sol = dense_loop_phase()
    dense_step_phase(dense_sol)
    cheb_launches = auto_phase()
    auto_lz_phase()
    k0_k4_launches, k0_k2_launches, k0_k4_err = k0_path_phase()
    k1 = timing_phase(card)
    k2 = loop_timing_phase(card)
    k4 = k4_timing_phase(card)
    k5 = k5_timing_phase(card)
    r_times = {kind: r_timing_phase(kind, card) for kind in R_KINDS}
    k9 = k9_timing_phase(card)
    adj = adjoint_timing_phase(card, adaptive_ts)
    extra = extra_timing_phase(card)
    k0_times = k0_timing_phase(card)
    print(f"[done] {time.perf_counter() - t_start:.1f} s", flush=True)
    print(card, flush=True)
    rows = []
    for name, launches, err, (ms, plain_ms, b_ms, b_by, *lib) in (
            ("fused_rk_step", k1_launches, k1_err, k1),
            ("fused_loop", k2_launches, k2_err, k2),
            ("rk_step_tile", k2_launches, k2_err, k2),
            ("fused_chain_apply", k4_launches, k4_err, k4),
            ("chain_step_tile", k5_launches, k5_err, k5),
            *((f"fused_chain_apply/{kind}", r_launches[kind][0],
               k4r_err[kind], r_times[kind][0]) for kind in R_KINDS),
            *((f"chain_step_tile/{kind}", r_launches[kind][1],
               k5r_err[kind], r_times[kind][1]) for kind in R_KINDS),
            ("fused_dense_chain_apply", k9_launches, k9_err, k9),
            ("adjoint_bwd", k6_launches, adj_errs["k6"], adj["K6"]),
            ("adjoint_sweep_fwd", k7_launches, adj_errs["k7"], adj["K7"]),
            ("adjoint_sweep_bwd", k8_launches, adj_errs["k8"], adj["K8"]),
            ("fused_loop/events", ev_launches, extra_errs["events"],
             extra["events"]),
            ("fused_loop/dense", dense_launches, extra_errs["dense"],
             extra["dense"]),
            ("fused_chain_apply/k0", k0_k4_launches,
             max(k0_err, k0_k4_err), k0_times[0]),
            ("chain_step_tile/k0", k0_k2_launches, k0_loop_errs["k0"],
             k0_times[1]),
            ("chain_step_tile/cheb", cheb_launches, k0_loop_errs["cheb"],
             k0_times[2])):
        source, replaces = KERNELS[name.split("/")[0]]
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

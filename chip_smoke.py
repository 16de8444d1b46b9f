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
  against the Magnus loop path; K9 against its twin on both of its routes
  (Taylor actions from the resident exponent, and the formed polynomial
  past the route rule) in f32 and f64, D = 4 to 256 (clusters at 256),
  with NaN rows and the declared norms, counting each route's exponents;
* the reversible adjoint (K6, K7, K8) on ``PulseControl``: fixed-step,
  with saves and anchors, and adaptive at Magnus orders 4 and 6 and over
  CFM-4 rows, and adaptive at order 4 over four basis terms (K' = 10,
  ``FourControls``), against f64 ``matrix_exp`` oracles; K6, K7 and K8
  against their twins also at K' = 10 and 36;
* the adjoint past K' = 6 and the rest of it: the fixed-step adjoint
  over four and eight basis terms (K' = 10 at 256, [adjoint-k10]; K' =
  36 at 256 and 4096, [adjoint-k36]; one K7 and one K8 launch each,
  against the f64 oracle and, in f64, K7 and K8 against their twins on
  the path's rows); basis gradients (``basis_grad=True``, one K7 launch
  and one K6 a row, against a central difference in f64,
  [basis-grad]); the dense-operator adjoint over DrivenDense's black box
  (no hand kernel, [adjoint-dense]); PulseControl under
  ``torch.func.vmap`` over four pulses against the per-pulse loop
  ([pulse-vmap]); ``fit_loop`` against the five Adam steps
  ([fit-loop]);
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
  and an eight-term drive in one loop solve ([k0]);
* K4's two launch routes: its cluster route at the JAX record's 256 on
  every recipe in f32 and f64 against its twin, two launches equal bit
  for bit, and the same rows on the tiled route at 16 384 with the same
  bits ([cluster]);
* the RK stage body that K1 and K2's RK step share: each launch plan
  against its Python mirror, and one K2 iteration against one K1 launch
  on the same rows, t and h, bit for bit, in f32 and f64 ([rk-body]);
* the front door, whose paths launch no hand kernel (every launch count
  stays 0; TF32 off): the JAX package's flagship entry, the generic
  vmapped RKF45 ensemble ``ensemble_solve(rhs_pair, stepper=None)`` at
  16 384 x 64c f32 against the K1 main path on the same states, its first
  64 rows in f64 against the CPU, timed beside the K1 path
  ([generic-rk]); 4096 Van der Pol trajectories in 1000 fixed RK4 steps
  ([vdp-rk4]); ``solve_ivp`` on an 8-dim linear ODE in f64 against its
  closed form and the CPU, backward with two saves, and ``solve_linear``
  over the split solvers on the driven tight-binding chain, unitary
  ([solve-ivp]);
* the driver finished: the K1 main path with ``method="scan"`` (exactly
  max_steps = 48 K1 launches, bitwise the while path, the loop under
  ``torch.cuda.set_sync_debug_mode("error")``, an M1 that requires grad
  refused by K1's wrapper) ([scan-k1]); value and gradient in a drive
  amplitude through the flagship ensemble with scan, ``grad_safe`` and
  ``remat_levels``, 256 rows in f64 against the CPU and a central
  difference ([grad-flagship]); BASELINE config 2 differentiated, remat
  levels 0 / 1 / 2 bitwise equal ([grad-vdp]); dense output on the
  vmapped tier (DOPRI5 with FSAL and its continuous extension) and the
  scalar tier (``solve_ivp_dense``, ``solve_linear_dense``)
  ([dense-tiers]); DOPRI5 with and without the FSAL carry ([fsal]).
  No hand kernel runs on these gradient and dense paths;
* the last single-device modules: K1 and K3 on declared drives (a
  CoeffForm with every term nonzero and a 16-coefficient ChebForm of a
  chirped drive) against their twins in f32 and f64, the main path at
  16 384 on K1 with each drive (the cos form: its 33 iterations, bitwise
  the ``w=`` shorthand), the 2048 loop path on K2 + K3 against K1 per
  step, a callable drive on the twin step with no launch ([drive-form]);
  the compensated tier, Magnus-4 over DrivenDense's black box at 4096
  and RKF45 on the flagship's vmapped tier at 16 384, against plain f32
  and an f64 solve, no kernel launched ([compensated]); hand-written l2
  norms promoted to ``lc.TracedNorm`` on the RK and Magnus-4 natively
  batched steppers, on the twin step with no launch ([traced-norm]);
  ``ensemble_solve_compact`` of the main path (one K1 launch an
  iteration, bitwise ``ensemble_solve``) and of 4096 Van der Pol
  trajectories, its efficiency against ``step_efficiency`` ([compact]);
  the main path's carry saved after 10 iterations, loaded and resumed,
  bitwise the uninterrupted solve ([checkpoint]);
* the last modules, over a torch.distributed DeviceMesh of world =
  min(cards, 4) ranks (torch.multiprocessing.spawn, NCCL over a FileStore
  in a temporary directory, one card a rank; the world size printed on
  each line): the main path through ``ensemble_solve(None,
  shard_batch(y0, mesh), ..., mesh=mesh)`` (K1 launches per rank,
  [mesh-main]), 2048 rows a rank with nine saves (one K2 + K3 launch a
  rank, [mesh-loop]) and the 4096 x 64c generic Magnus-4 path (K9,
  [mesh-generic]), each against the one-card ensemble_solve of the rank's
  rows (counters equal, states within 1e-6; bitwise expected); a CPU
  batch on the CUDA mesh refused; ``solve_linear_state_sharded`` of a real
  antisymmetric D = 16 384 f64 operator (2 GiB) row-sharded over the
  world against the unsharded solve_ivp (counters equal, states within
  1e-10, ||y|| within 1e-7), its RHS evaluations and the HBM rate reached
  ([state-sharded]); ``ensemble_solve_state_sharded`` of 256 x 4096 f32
  states under a time-dependent ``local_rows`` on a (world / 2, 2) mesh
  against the unsharded batched solve ([state-2d]); then the seven
  examples (``vec_ode_tpu_torch.examples``, each with its own check) and
  ``ensemble_sweep --mesh`` under torchrun, run together as processes of
  their own ([examples]).

Then it times the paths and each kernel against its plain version, its
bound and, for K4 (at 256 on its cluster route and 16 384 on its tiled
one, also at K' = 6 and 36, each with its launch plan, ptxas lines and
masked share of passes), K6-K8 (at 256 and 4096; K6 with its launch
plan and ptxas line, K7 and K8 with their launch shapes and ptxas lines,
also at K' = 10 and 36, and the value-and-grad wall with K7's and K8's
shares of it; the basis-grad and dense-adjoint walls) and K9 (at
4096 and 256, with its launch plan and its bound by the least work,
k9_flop_bytes), a library yardstick; K1 and K2's RK step with their
launch plans and ptxas lines, K1 beside its six stage products alone
(``torch.matmul``, TF32 off, timed in turns), K1 on each declared drive
against the cos drive in turns and K2 + K3 on the ChebForm. Every
phase raises on failure, so
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
                               ERR_STALLED, RK4, RKF45, RungeKutta,
                               StepControl, driver, lc, solve_ivp,
                               solve_ivp_dense, solve_linear,
                               solve_linear_dense)
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
                                      LinearConstant, PulseControl,
                                      TightBindingChain, VanDerPol,
                                      stable_dense_matrix)
from vec_ode_tpu_torch.ops import adjoint as tadj
from vec_ode_tpu_torch.ops import (_build, dense_chains, expmv, fused_loop,
                                   fused_rk)
from vec_ode_tpu_torch.ops.cplx import Cplx, embed, from_complex
from vec_ode_tpu_torch.ops.dense_chains import (fused_dense_chain_apply,
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
from vec_ode_tpu_torch.ops.forms import ChebForm, CoeffForm
from vec_ode_tpu_torch.parallel import (ensemble_solve,
                                        ensemble_solve_compact,
                                        step_efficiency)
from vec_ode_tpu_torch.parallel.ensemble import _batched_dense_fallback
from vec_ode_tpu_torch.utils import load_state, save_state

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
    chain step; K1's rows a thread and stages in registers (KS, 0: in
    shared memory) and, for K1 and K2's RK step, the stack frame; K4's and
    K6's tiled or cluster route with its rows and
    columns a thread, K6's stack frame (its partial cbar); K7's and K8's
    rows a thread; the loop kernel with its events / dense switch on; K9
    on one block or a cluster) of the kernel, from ptxas's report in its
    build log."""
    log = _build.build_log(name)
    if not log.exists():   # a library built before logs were kept
        return "no build log"
    out, inst = [], None
    for line in log.read_text().splitlines():
        m = re.search(r"Compiling entry function "
                      r"'\S*?([a-z_]+?)_kernelI([fd])(\S*)'", line)
        if m:
            inst, spill = {"f": "f32", "d": "f64"}[m.group(2)], "?"
            frame = "?"
            stack = (m.group(1) in ("adjoint_row", "fused_rk_step")
                     or "RKLoopStep" in m.group(3))
            if name == "adjoint":  # three kernels
                inst = f"{m.group(1)} {inst}"
            route = re.match(r"Li(\d+)ELi(\d+)ELb([01])E", m.group(3))
            rm = re.match(r"Li(\d+)E(?:Li(\d+)E)?", m.group(3))
            if name in ("chain_expmv", "adjoint") and route:
                # K4, K6: the route, RM x CN
                inst += (" cluster" if route.group(3) == "1" else " tiled")
                inst += f" RM={route.group(1)} CN={route.group(2)}"
            elif name == "adjoint" and rm:  # K7's, K8's rows a thread
                inst += f" RM={rm.group(1)}" + (
                    " wide" if rm.group(2) == "1024" else "")
            elif name == "fused_rk_step" and rm:  # K1: RM, stages in registers
                inst += f" RM={rm.group(1)} KS={rm.group(2)}"
            elif "RKLoopStep" in m.group(3):
                inst += " rk"
            elif "ChainLoopStep" in m.group(3):
                inst += " chain"
            if name == "fused_loop" and "Lb1E" in m.group(3):
                inst += " events/dense"
            if name == "dense_chains":  # K9: one block, or a cluster
                inst += " cluster" if "Lb1E" in m.group(3) else " one block"
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores",
                      line)
        if inst and m:
            frame, spill = m.groups()
        m = re.search(r"Used (\d+) registers", line)
        if inst and m:
            out.append(f"{inst} {m.group(1)} registers, {spill} B spilled"
                       + (f", {frame} B stack frame" if stack else ""))
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
                         u_fn=fused_rk.drive_fn(st.u_fn), tab=tab,
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
                           u_fn=fused_rk.drive_fn(st.u_fn), tab=tab,
                           advance_lower=advance_lower, wnorm=wnorm)
    floor = 4 * float((ep.double() - e64).abs().max())
    return (1e-4 * ep.abs() + floor).to(ep.dtype), floor


def weighted(kind: str, d: int, weights: bool = True):
    """A declared WeightedNorm's kernel parts over the widened layout, with
    a ramp of weights in [0.5, 2] or none."""
    w = tuple(np.linspace(0.5, 2.0, d)) if weights else None
    return lc.WeightedNorm(kind, w).kernel_parts(d, 2)


def compare_step(B, d, dtype, tab=RKF45, advance_lower=True,
                 dt_range=(1e-3, 5e-2), wnorm=None, label="", u_fn=None):
    """Kernel vs plain step on the card; returns (max |dx|, rows on which
    the error-norm check would catch a norm 10% off). The f32 state limit
    is bench.py's on-device limit; f64 differs only by summation order.
    ``u_fn``: a declared drive in place of the model's cos(w t)."""
    st, t, dt, xw = step_inputs(B, d, dtype, dt_range=dt_range)
    if u_fn is not None:
        st = dataclasses.replace(st, u_fn=u_fn)
    xk, ek = fused_rk_step(t, dt, xw, st.M0, st.M1, u_fn=st.u_fn, tab=tab,
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


def one_loop_step(st, t, dt, xw, tab=RKF45):
    """One K2 iteration on the rows (t, dt, xw): the grid cursor past t0
    (so that the first iteration steps), h = dt, a far end (dt = h) and a
    loose rtol, so that every row takes and accepts one step of dt.
    Returns (x, the error measure) after it."""
    B = xw.shape[0]
    grid = torch.tensor([0.0, 1e6], dtype=xw.dtype, device=xw.device)
    fs = torch.stack([t, dt, dt, torch.zeros_like(t), torch.zeros_like(t)],
                     dim=1)
    ist = torch.zeros(B, 8, dtype=torch.int32, device=xw.device)
    ist[:, 0] = 1
    saves = torch.zeros(0, B, xw.shape[1], dtype=xw.dtype, device=xw.device)
    step = RKStep(M0=st.M0, M1=st.M1, u_fn=st.u_fn, tableau=tab)
    fs, ist, x, _ = fused_loop_chunk(grid, fs, ist, xw, saves, step,
                                     ctl=StepControl(rtol=1.0), chunk=1)
    assert bool((ist[:, 3] == 1).all()), "a row did not accept its step"
    return x, fs[:, 3]


def rk_body_phase() -> None:
    """[rk-body] K1 and K2's RK step run one stage body: their launch plans
    equal their mirrors, and one K2 iteration gives one K1 launch's state
    and error measure bit for bit on the same rows, t and h, at the main
    path's batch and at a ragged one with an odd width, in f32 and f64,
    RKF45 and DOPRI5 (the stages in registers and in shared memory)."""
    for dtype in (torch.float32, torch.float64):
        elem = 4 if dtype == torch.float32 else 8
        for B, d, tab in ((N_TRAJ, DIM, RKF45), (LOOP_TRAJ, DIM, DOPRI5),
                          (1000, 5, RKF45), (33, 3, DOPRI5)):
            st, t, dt, xw = step_inputs(B, d, dtype)
            s = tab.stages
            p1 = fused_rk.rk_plan(B, 2 * d, s, elem)
            assert fused_rk.kernel_rk_plan(B, 2 * d, s, dtype) == p1, p1
            for extra in (False, True):
                p2 = fused_loop.rk_loop_plan(B, 2 * d, s, elem, extra)
                assert fused_loop.kernel_rk_loop_plan(
                    B, 2 * d, s, dtype, extra) == p2, (p2, extra)
            xk, ek = fused_rk_step(t, dt, xw, st.M0, st.M1, w=st.w, tab=tab)
            xl, el = one_loop_step(st, t, dt, xw, tab)
            same = torch.equal(xk, xl) and torch.equal(ek, el)
            print(f"[rk-body] {tab.name} {str(dtype)[6:]} B={B} d={d}: "
                  f"K1 plan {p1['tile']} rows, {p1['rm']} x 4, ks "
                  f"{p1['ks']}, {'resident' if p1['resident'] else 'ring'};"
                  f" K2 plan {p2['tile']} rows, {p2['rm']} x 4, ks "
                  f"{p2['ks']}, {'resident' if p2['resident'] else 'ring'}"
                  f" (mirrors = kernels); one K2 iteration = one K1 launch "
                  f"bit for bit (state and error): {same}", flush=True)
            if not same:
                raise AssertionError(f"K2's RK step differs from K1: {tab.name}"
                                     f" {dtype} B={B} d={d}")


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


# every kernel wrapper, K1-K9, the one list that the counts below read:
# K1, K2 and K4 first (``counts``)
WRAPPERS = (fused_rk_step, fused_loop_chunk, fused_chain_apply,
            fused_dense_chain_apply, tadj.adjoint_bwd, tadj.adjoint_sweep_fwd,
            tadj.adjoint_sweep_bwd)


def reset_counts() -> None:
    """Every kernel wrapper's launch count to 0."""
    for w in WRAPPERS:
        w.launches = 0


def all_launches() -> tuple:
    """Every kernel wrapper's launch count, K1-K9."""
    return tuple(w.launches for w in WRAPPERS)


def counts() -> tuple:
    """The launch counts of K1, K2 and K4."""
    return all_launches()[:3]


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


def walls_of(fn) -> tuple:
    """A warm call, then three CUDA-event timed calls: (median ms, the
    three, the first timed result, peak device memory in MiB)."""
    fn()
    torch.cuda.reset_peak_memory_stats()
    outs = []
    walls = timed_runs(lambda: outs.append(fn()))
    return (statistics.median(walls), walls, outs[0],
            torch.cuda.max_memory_allocated() / 2**20)


def timed_solve(fn, label: str, card: str):
    """Median of 3 CUDA-event timed solves after one warm solve, with
    accepted steps per second and peak device memory. Returns (ms, the
    first timed solution)."""
    wall_ms, walls, sol, peak = walls_of(fn)
    accepted = int(sol.n_accept.sum())
    print(f"[time] {label}: median wall {wall_ms:.3f} ms of "
          f"{[round(w, 3) for w in walls]}, {int(sol.n_iters.max())} "
          f"iterations at most, {accepted} accepted steps, "
          f"{accepted / (wall_ms / 1e3):.4e} accepted steps/s, peak memory "
          f"{peak:.1f} MiB ({card})", flush=True)
    return wall_ms, sol


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
    y_ms, y_runs = products_alone(xw, sk, RKF45.stages)
    print(f"[time] K1 one RKF45 step at B={N_TRAJ}, d={DIM}, f32: kernel "
          f"{k_ms:.4f} ms ({flop / k_ms / 1e9:.2f} TFLOP/s), plain torch "
          f"{p_ms:.4f} ms ({flop / p_ms / 1e9:.2f} TFLOP/s); runs "
          f"kernel {[round(v, 4) for v in k_runs]}, plain "
          f"{[round(v, 4) for v in p_runs]}; bound {b_ms:.4f} ms by {b_by} "
          f"({flop / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB), kernel at "
          f"{b_ms / k_ms:.1%} of it; products alone ({RKF45.stages} x "
          f"torch.matmul ({N_TRAJ}, {2 * DIM}) @ ({2 * DIM}, {4 * DIM}), "
          f"TF32 off) {y_ms:.4f} ms ({flop / y_ms / 1e9:.2f} TFLOP/s, runs "
          f"{[round(v, 4) for v in y_runs]}); "
          f"{k1_plan_text(N_TRAJ, 2 * DIM, RKF45.stages)} ({card})",
          flush=True)
    return k_ms, p_ms, b_ms, b_by


def products_alone(xw, st, stages: int, n: int = 3):
    """The step's stage products alone, a yardstick: ``stages`` calls of
    torch.matmul of the (B, D) state with [M0^T | M1^T] (D, 2D) in the
    state's type (TF32 off), timed in turns with K1 (n rounds of 20).
    Returns (median ms for the stages, runs)."""
    mt = torch.cat([st.M0.T, st.M1.T], dim=1).contiguous()
    out = torch.empty(xw.shape[0], mt.shape[1], dtype=xw.dtype,
                      device=xw.device)

    def run():
        for _ in range(stages):
            torch.matmul(xw, mt, out=out)

    run()
    runs = [timed_ms(run, reps=1, inner=20) for _ in range(n)]
    return statistics.median(runs), runs


def k1_plan_text(B: int, D: int, s: int, dtype=torch.float32) -> str:
    """K1's launch plan (its mirror, fused_rk.rk_plan, held equal to the
    kernel's own, kernel_rk_plan) and the ptxas lines of both builds."""
    plan = fused_rk.rk_plan(B, D, s, 4 if dtype == torch.float32 else 8)
    got = fused_rk.kernel_rk_plan(B, D, s, dtype)
    assert got == {k: plan[k] for k in fused_rk.RK_PLAN_KEYS}, (got, plan)
    return (f"plan (mirror = kernel): {plan['tile']} rows a block, "
            f"{plan['rm']} x 4 outputs a thread, stages "
            f"{'in registers' if plan['ks'] else 'in shared memory'}, "
            f"{plan['threads']} threads, {plan['blocks']} blocks, "
            f"{plan['smem']} B shared, operator "
            f"{'resident' if plan['resident'] else 'streamed'}; ptxas "
            f"{ptxas_of('fused_rk_step', 'RM=')}")


def k2_plan_text(B: int, D: int, s: int, dtype=torch.float32) -> str:
    """The RK step's plan in K2 (its mirror, fused_loop.rk_loop_plan, held
    equal to the kernel's own) and the ptxas lines of its builds."""
    plan = fused_loop.rk_loop_plan(B, D, s,
                                   4 if dtype == torch.float32 else 8)
    got = fused_loop.kernel_rk_loop_plan(B, D, s, dtype)
    assert got == plan, (got, plan)
    return (f"RK step plan (mirror = kernel): {plan['tile']} rows a block, "
            f"{plan['rm']} x 4 outputs a thread, stages "
            f"{'in registers' if plan['ks'] else 'in shared memory'}, "
            f"{plan['threads']} threads, {plan['smem']} B shared, operator "
            f"{'resident' if plan['resident'] else 'streamed'}; ptxas "
            f"{ptxas_of('fused_loop', ' rk')}")


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
          f"path {loop_ms:.3f} ms vs per-step path {step_ms:.3f} ms; "
          f"{k2_plan_text(LOOP_TRAJ, 2 * DIM, RKF45.stages)} ({card})",
          flush=True)

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
          f"{bb_ms / big_ms:.1%} of it; "
          f"{k2_plan_text(N_TRAJ, 2 * DIM, RKF45.stages)} ({card})",
          flush=True)
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


def k4_plan(B, D, st, K0, elem=4) -> dict:
    """K4's launch plan for the stepper's recipe on this card
    (expmv.chain_plan) and the bytes of its resident basis slice."""
    props = torch.cuda.get_device_properties(0)
    plan = expmv.chain_plan(
        B, D, elem, st._recipe, st._chains, K0, st._table,
        n_sm=props.multi_processor_count,
        max_smem=getattr(props, "shared_memory_per_block_optin", 232448))
    kp = expmv.n_working_terms(st._recipe, K0)
    plan["resident_bytes"] = kp * D * expmv.gemm_dp(plan["dc"]) * elem
    return plan


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
    plan = k4_plan(B, D, st, K0)
    need = int(sum(passes))
    run = block_passes(st, samples, dt, plan["tile"])
    body = (f"; {plan['route']} route: {plan['n']} block(s) a tile of "
            f"{plan['tile']} rows, {plan['dc']} columns a block, "
            f"{plan['rm']} x {plan['cn']} outputs a thread, {plan['threads']}"
            f" threads, {plan['blocks']} blocks, {plan['smem']} B of shared "
            f"memory, basis "
            + (f"resident ({plan['resident_bytes']} B a block)"
               if plan["resident"] else "streamed through the ring")
            + f", ptxas {ptxas_of('chain_expmv', plan['route'])}; "
            f"trajectory-row passes needed {need}, run {run} "
            f"({1 - need / run:.1%} masked)")
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
    pair (the tiled route), and at the JAX record's 256 (the cluster
    route)."""
    st = chain_stepper(torch.float32)
    time_k4(st, REC_B, "Magnus-4 pair", card)
    return time_k4(st, N_TRAJ, "Magnus-4 pair", card)


CLUSTER_KINDS = (("magnus4 pair", {}),
                 ("magnus4 fast_error", dict(fast_error=True)),
                 ("magnus6", dict(kind="magnus6")), ("cfm4", dict(kind="cfm4")),
                 ("midpoint", dict(midpoint=True)))


def cluster_phase() -> float:
    """K4's cluster route at the JAX record's batch, 256x64c: every recipe
    (the Magnus-4 pair and fast_error, Magnus-6, CFM-4, midpoint) in f32
    and f64 against its twin (check_chain_step's limits); two launches
    equal bit for bit; and the same rows inside a 16384-row launch (the
    tiled route) give the same bits. Returns max |dy| of Magnus-6 in
    f32."""
    err = 0.0
    for label, kw in CLUSTER_KINDS:
        for dtype in (torch.float32, torch.float64):
            st = chain_stepper(dtype, **kw)
            D = st._basis_w.shape[-1]
            K0 = st.op.form.n_terms
            elem = 4 if dtype == torch.float32 else 8
            plans = [k4_plan(n, D, st, K0, elem) for n in (REC_B, N_TRAJ)]
            assert [p["route"] for p in plans] == ["cluster", "tiled"], plans
            extra = {}
            if dtype == torch.float64 and label in R_DT64:
                # steps on which each f64 error stands above rounding
                extra = dict(dt_range=R_DT64[label], x_rel=1e-13)
            dy, _ = check_chain_step(REC_B, dtype, f"cluster route {label}",
                                     **extra, **kw)
            if (label, dtype) == ("magnus6", torch.float32):
                err = dy
            samples, dt, xw = chain_inputs(st, REC_B, dtype)
            mt, norms, m, theta = chain_operands(st, dtype)
            kwk = dict(recipe=st._recipe, C=st._chains, m=m, theta=theta,
                       table=st._table)
            y1, e1 = fused_chain_apply(samples, dt, xw, mt, norms, **kwk)
            y2, e2 = fused_chain_apply(samples, dt, xw, mt, norms, **kwk)
            reps = N_TRAJ // REC_B
            yb, eb = fused_chain_apply(
                [g.repeat(reps, 1) for g in samples], dt.repeat(reps),
                xw.repeat(reps, 1), mt, norms, **kwk)
            same = (torch.equal(y1, y2) and torch.equal(e1, e2)
                    and torch.equal(y1, yb[:REC_B])
                    and torch.equal(e1, eb[:REC_B]))
            print(f"[cluster] {label} {str(dtype)[6:]} B={REC_B}: "
                  f"{plans[0]['n']} blocks a tile of {plans[0]['tile']} rows"
                  f" ({plans[0]['blocks']} blocks), two launches and the "
                  f"same rows on the tiled route at {N_TRAJ} equal bit for "
                  f"bit: {same}", flush=True)
            if not same:
                raise AssertionError(f"K4's routes disagree: {label} {dtype}")
    return err


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
    assert k4_plan(REC_B, 2 * DIM, st256, 2)["route"] == "cluster"
    print(f"[{kind}-step] {N_TRAJ}x{DIM}c, operator without a declared "
          f"form: path={sol.path}, K4 launches={k4} == max n_iters={n_iters} "
          f"(K1/K2 {k1}/{k2}); vs the loop path: max|dcount|={dcount} (<= 1),"
          f" max|dy|={dy:.3e} (<= 1e-4; the first 64: {dy_first:.3e}); the "
          f"JAX record's configuration at {REC_B}: {k4_256} K4 launches "
          f"(the cluster route), all DONE", flush=True)
    return k4, k4_256


def r_timing_phase(kind, card):
    """The kind's loop path and per-step paths (16384 and the record's
    256) timed end to end, K2 + K5 alone against its twin and bound, and
    K4 per launch at both batches. Returns (K4 numbers at 16384, K5
    numbers, K4 numbers at 256)."""
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
    return k4, k5, time_k4(st, REC_B, label, card)


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


def dense_inputs(table, B, D, dtype, seed=5, big_row=None, nan_row=None,
                 formed_row=None):
    """Random per-trajectory samples of 1-norm about sqrt(D), dt in
    [1e-3, 5e-2) and states of scale 0.1; ``big_row`` gets dt = 0.7 (past
    theta, so only it squares in f32), ``nan_row`` a NaN sample and
    ``formed_row`` dt = 1 and independent skew-symmetric samples, scaled
    together so that the table's largest exponent has 1-norm 1.5 2^s
    theta, s the least count the route rule forms at this D: that exponent
    takes the formed route with s squarings (7 at D = 128), its
    propagator orthogonal."""
    rng = np.random.default_rng(seed)
    ops = rng.standard_normal((table.n_nodes, B, D, D)) / D ** 0.5
    dt = rng.uniform(1e-3, 5e-2, B)
    if big_row is not None:
        dt[big_row] = 0.7
    if nan_row is not None:
        ops[0, nan_row, 0, 0] = np.nan
    if formed_row is not None:
        G = rng.standard_normal((table.n_nodes, D, D))
        S = G - np.swapaxes(G, 1, 2)
        m, theta = dense_fast.ps_params(dtype)
        sq = next(k for k in range(64)
                  if not dense_chains.takes_actions(k, m, D))
        ops[:, formed_row] = S * formed_scale(table, S,
                                              1.5 * 2.0 ** sq * theta)
        dt[formed_row] = 1.0
    xw = rng.standard_normal((B, D)) * 0.1
    return (torch.as_tensor(a, dtype=dtype, device="cuda")
            for a in (ops, dt, xw))


def formed_scale(table, S, target: float) -> float:
    """The factor c > 0 at which the largest 1-norm of the table's
    exponents over the samples c S (n_nodes, D, D) at dt = 1 is ``target``
    (bisection: the norm grows with c, its commutators as c^2)."""
    one = torch.ones(1, dtype=torch.float64)

    def top(c):
        ops = torch.as_tensor(c * S)[:, None]
        return max(float(W.abs().sum(-2).amax())
                   for chain in table.exponents(ops, one) for W in chain)

    lo, hi = 0.0, 1.0
    while top(hi) < target:
        lo, hi = hi, 2 * hi
    for _ in range(50):
        mid = 0.5 * (lo + hi)
        lo, hi = (mid, hi) if top(mid) < target else (lo, mid)
    return hi


def check_dense(label, table, node_ops, dt, xw, nan_row=None,
                wnorm=None, formed_row=None) -> float:
    """K9 against its twin on the card, printing how many exponents took
    each route (``formed_row``: one must be formed). f64: only the order of
    the sums differs, 1e-11 on states of scale <= 1 and 1e-9 of each error
    norm. f32: 2e-5 of the largest state entry; the error norm is a
    difference of two propagated states, so its limit is 1e-3 of the norm
    plus four times the f32 twin's own distance from the f64 twin on these
    inputs. ``wnorm``: a declared error norm, which both execute."""
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
    n_act, n_formed = k9_routes(table, counts_s, m, xw.shape[1])
    if formed_row is not None:
        ok = ok and n_formed > 0
    print(f"[dense] {label} {str(dtype)[6:]} B={xw.shape[0]} D={xw.shape[1]} "
          f"({table.n_nodes} nodes, chains of "
          f"{[len(c) for c in table.chains]}): max|dy|={dy:.3e} (<= "
          f"{y_lim:.1e}); {de_txt}; squarings up to {int(s_all.max())}, "
          f"{int(s_all.amax(0).gt(0).sum())} row(s) square; exponents "
          f"{n_act} by actions, {n_formed} formed"
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
    """K9 against its twin on both routes: every table in f64 at D = 8
    and D = 128, with a row past theta, a row on the formed route and a
    NaN row; the Magnus-4 pair under each declared norm in f64 and f32;
    the cluster plans at D = 256 in f32 and f64; the main path's table in
    f32 at D = 4 and at 4096 x 128, on random samples and on the path's
    own (every exponent by actions)."""
    rows = dict(big_row=3, nan_row=5, formed_row=4)
    for name, table in dense_tables().items():
        for B, D in ((1500, 8), (300, 128)):
            check_dense(name, table,
                        *dense_inputs(table, B, D, torch.float64, **rows),
                        nan_row=5, formed_row=4)
    pair = tmagnus.magnus4_table(pair=True)
    for kind, weights in (("l2", True), ("rms", False), ("max", True)):
        label = (f"magnus4 pair, norm {kind}"
                 f"{' weighted' if weights else ''}")
        for B, D, dtype in ((1500, 8, torch.float64),
                            (300, 128, torch.float64),
                            (1000, 128, torch.float32)):
            check_dense(label, pair,
                        *dense_inputs(pair, B, D, dtype, **rows), nan_row=5,
                        wnorm=weighted(kind, D // 2, weights), formed_row=4)
    for dtype in (torch.float32, torch.float64):
        check_dense("magnus4 pair, a cluster a trajectory", pair,
                    *dense_inputs(pair, 200, 256, dtype, **rows), nan_row=5,
                    formed_row=4)
    # samples at an offset and with a stride of their own over the nodes
    ops, dt, xw = dense_inputs(pair, 300, 128, torch.float32)
    store = torch.zeros(2, 301, 128 * 128 + 1, device="cuda")
    store[:, 1:, 1:] = ops.reshape(2, 300, -1)
    check_dense("magnus4 pair, samples as an unaligned strided view", pair,
                store[:, 1:, 1:].unflatten(-1, (128, 128)), dt, xw)
    check_dense("magnus4 pair", pair,
                *dense_inputs(pair, 1000, 4, torch.float32, big_row=3))
    check_dense("magnus4 pair", pair,
                *dense_inputs(pair, GEN_TRAJ, 2 * DIM, torch.float32, **rows),
                nan_row=5, formed_row=4)
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


def k9_flop_bytes(table, counts_s, B, D, nbytes, m=12):
    """One K9 launch by the least work the data needs, whatever route the
    kernel takes: per trajectory and exponent (``counts_s``: each
    exponent's (B,) squaring counts s from the twin) its formation
    (n_nodes D^2), two products of 2 D^3 per commutator term, and the least
    of the formed route (ps_products(m) + s products and one
    matrix-vector product of 2 D^2) and the Taylor actions (2^s m
    matrix-vector products); the samples, dt and x read once, y and err
    written once."""
    mm, mv = 2 * D ** 3, 2 * D * D
    flop = 0
    for ex, s in zip(table.exponents_flat, counts_s):
        s = s.to(torch.float64).cpu()
        formed = (dense_chains.ps_products(m) + s) * mm + mv
        actions = torch.exp2(s) * (m * mv)
        flop += (int(torch.minimum(formed, actions).sum())
                 + B * (table.n_nodes * D * D + 2 * len(ex.comms) * mm))
    return flop, nbytes * (table.n_nodes * B * D * D + 2 * B * D + 2 * B)


def k9_plan_text(B, D, dtype) -> str:
    """K9's launch plan on this card, and whether the Python mirror agrees."""
    kp = dense_chains.kernel_plan(B, D, dtype)
    mirror = dense_chains.dense_plan(B, D, torch.finfo(dtype).bits // 8)
    same = all(mirror[k] == v for k, v in kp.items())
    if not same:
        raise AssertionError(f"K9's plan {kp} is not its mirror's {mirror}")
    return (f"{kp['clusters']} clusters of {kp['cs']} block(s), "
            f"{kp['rows']} rows of W a block, {kp['smem']} B of shared "
            f"memory a block, product chunks of {kp['rc']} rows, "
            f"{kp['tpr']} threads a matrix-vector row; the mirror agrees")


def k9_routes(table, counts_s, m, D) -> tuple:
    """(exponents on the actions route, exponents formed) over the
    trajectories, by the route rule the kernel and its twin share."""
    act = sum(int(dense_chains.takes_actions(s, m, D).sum())
              for s in counts_s)
    return act, sum(s.numel() for s in counts_s) - act


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
    flop, nbytes = k9_flop_bytes(table, counts_s, B, D, 4, m=m)
    b_ms, b_by = bound(flop, nbytes)
    sq = sum(int(s.sum()) for s in counts_s)
    n_act, n_formed = k9_routes(table, counts_s, m, D)
    print(f"[time] K9 one Magnus-4 pair step at B={B}, d={DIM}, f32 "
          f"(exponents: {n_act} by actions, {n_formed} formed; {sq} "
          f"squarings in all; plan {k9_plan_text(B, D, torch.float32)}): "
          f"kernel {k_ms:.4f} ms "
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
# K6 alone past K' = 6: four basis terms at order 4 (K' = 10) and eight
# (K' = 36, K4's largest), rows past theta (16 to 64 passes); K6 with K7
# and K8 there too, on fewer rows
ROW_CASES = ((256, 128, 10, 0, 0.1), (256, 128, 36, 0, 0.05),
             (256, 128, 10, 3, 0.1), (256, 128, 36, 2, 0.05))


def adj_tolerances(dtype):
    """K6-K8 against their twins: f64 to summation order (FMA in the
    kernels, BLAS in the twins), f32 the same over up to 64 passes of 8
    terms; cbar relative to its largest entry."""
    return (1e-10, 1e-9) if dtype == torch.float64 else (1e-4, 1e-3)


def check_adjoint_case(B, D, Kp, R, dtype, seed, scale) -> dict:
    """K6, K7 and K8 on adjoint_case's inputs against their twins (K6 alone
    with no shared rows, R = 0); raises on a disagreement. Returns the
    relative and absolute differences and the passes per lane and row."""
    m, theta = _taylor_params(dtype)
    kw = dict(m=m, theta=theta, max_squarings=16)
    tol, cb_tol = adj_tolerances(dtype)
    W, c, c_all, x, a = adjoint_case(B, D, Kp, R, dtype, seed, scale)
    mt, ms, norms = adj_operands(W)
    _, n_pass = expmv.scale_rows(c[:, None], norms, theta, 16)
    k6 = tadj.adjoint_bwd(c, x, a, mt, ms, norms, **kw)
    p6 = tadj.torch_adjoint_row(c, x, a, mt, ms, norms, **kw)
    torch.cuda.synchronize()
    d = dict(xn=rel(k6[0], p6[0]), an=rel(k6[1], p6[1]), cb6=rel(k6[2], p6[2]),
             k6=float(max((k6[j] - p6[j]).abs().max() for j in (0, 1))),
             passes=(int(n_pass.min()), int(n_pass.max())))
    if R > 0:
        _, n_row = expmv.scale_rows(c_all[:, None], norms, theta, 16)
        y7 = tadj.adjoint_sweep_fwd(c_all, x, mt, norms, **kw)
        p7 = tadj.torch_adjoint_sweep_fwd(c_all, x, mt, norms, **kw)
        k8 = tadj.adjoint_sweep_bwd(c_all, y7, a, mt, ms, norms, **kw)
        p8 = tadj.torch_adjoint_sweep_bwd(c_all, y7, a, mt, ms, norms, **kw)
        torch.cuda.synchronize()
        d.update(y=rel(y7, p7), a0=rel(k8[0], p8[0]), cb8=rel(k8[1], p8[1]),
                 k7=float((y7 - p7).abs().max()),
                 k8=float((k8[0] - p8[0]).abs().max()),
                 passes=(*d["passes"], int(n_row.min()), int(n_row.max())))
    assert max(d.get(k, 0.0) for k in ("xn", "an", "y", "a0")) <= tol, d
    assert max(d.get(k, 0.0) for k in ("cb6", "cb8")) <= cb_tol, d
    if scale > 0.09:  # rows past theta: squarings ran
        assert all(v > 1 for v in d["passes"][1::2]), d
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
    ADJ_CASES and ROW_CASES (K' = 10 and 36), and a NaN state row. Returns
    the f32 max |d| at the path's shape (K6 x_n / a_n, K7 y, K8 a0)."""
    errs = {}
    for dtype in (torch.float64, torch.float32):
        for i, (B, D, Kp, R, scale) in enumerate(ADJ_CASES + ROW_CASES):
            d = check_adjoint_case(B, D, Kp, R, dtype, 80 + i, scale)
            p = d["passes"]
            sweeps = (f", per row {p[2]}..{p[3]}" if len(p) > 2 else "")
            print(f"[adjoint-kernels] {str(dtype)[6:]} B={B} D={D} K'={Kp} "
                  f"R={R}, passes per lane {p[0]}..{p[1]}{sweeps}: relative "
                  f"max|d| K6 x_n {d['xn']:.2e} a_n {d['an']:.2e} cbar "
                  f"{d['cb6']:.2e}" + (
                      f"; K7 y {d['y']:.2e}; K8 a0 {d['a0']:.2e} cbar "
                      f"{d['cb8']:.2e}" if "y" in d else " (K6 alone)"),
                  flush=True)
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
    """Five Adam(lr=0.05) steps on the f32 infidelity: the loss falls.
    Returns the parameters and the losses."""
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
    return th.detach(), losses


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
    return tdiff._adaptive_forward(plan, core, theta,
                                   torch.cat([y0.re, y0.im], -1),
                                   t0, tf, h0)[2]


@dataclasses.dataclass(frozen=True)
class ManyControls:
    """A control problem over K0 basis terms, multi_basis(K0) (-i H0 of
    DrivenDense(64) and K0 - 1 controls -i V_s, random Hermitian terms from
    numpy seeds), with the coefficients [1, th0 cos(th1 t), th2 sin(th3
    t), th4 cos(th5 t), ...] (cosine modes on odd controls, sine modes on
    even ones): a working basis of K' = K0 + K0 (K0 - 1) / 2 at order 4,
    10 at K0 = 4 and 36 at 8."""

    K0: int = 4
    T = 1.0
    fidelity = staticmethod(PulseControl.fidelity)

    @property
    def Kp(self) -> int:
        return self.K0 + self.K0 * (self.K0 - 1) // 2

    def basis_pair(self, dtype=torch.float64, device="cuda"):
        return multi_basis(self.K0, dtype, device)

    def coeff_fn(self, t, th):
        cols = [torch.ones_like(t)]
        for k in range(1, self.K0):
            mode = torch.cos if k % 2 else torch.sin
            cols.append(th[2 * k - 2] * mode(th[2 * k - 1] * t))
        return torch.stack(cols, -1)

    def theta(self, dtype, device="cuda"):
        return torch.tensor(MANY_THETA[:2 * self.K0 - 2], dtype=dtype,
                            device=device)


# the controls' amplitudes and frequencies (ManyControls.theta)
MANY_THETA = (0.6, 2.0, -0.4, 3.0, 0.3, 5.0, 0.2, 4.0, -0.3, 6.0, 0.25, 7.0,
              -0.2, 2.5)


def FourControls():
    """Four basis terms (K' = 10 at order 4), past K' = 6."""
    return ManyControls(4)


def adaptive_adjoint_check(label, card=None, model=None, **scheme):
    """adjoint_solve_adaptive at 256x64c f32, rtol 1e-5 (ADJ_CTL, the
    Magnus-4 adaptive configuration) with ``scheme`` (order= or scheme=)
    on PulseControl or ``model`` (its basis_pair, coeff_fn, fidelity):
    all lanes DONE, one K4 launch per forward iteration, n_sub K6
    launches per replayed iteration (one reverse row per exponential: 1
    at Magnus order 4, 3 at order 6, 2 for cfm4), no twin call, the
    gradient against the
    frozen-step-sequence f64 matrix_exp oracle over the same rows
    (tests/test_adjoint.py:169-250). With ``card`` the value-and-grad wall
    is timed (median of 3 after a warm run). Returns the K6 launches and
    the recorded times (n_it + 1, B)."""
    pc, y0, tg, theta = adjoint_inputs(torch.float32)
    pc = model or pc
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
    """The adaptive adjoint at Magnus order 4, on PulseControl (K' = 3) and
    on FourControls (K' = 10, K6 past K' = 6). Returns the K6 launches
    and the recorded times (n_it + 1, B) of the first."""
    out = adaptive_adjoint_check("Magnus-4", order=4)
    adaptive_adjoint_check("Magnus-4, four basis terms (K' = 10)",
                           model=FourControls(), order=4)
    return out


def sweep_check(core, c_all, x, a) -> dict:
    """K7 and K8 on the rows c_all over the core's basis against their
    twins (the same inputs): relative max |d| of K7's y, K8's a0 and cbar,
    and K7's and K8's (a0) max |d|."""
    mt, ms, norms, m, theta = core.operands(x)
    kw = dict(m=m, theta=theta, max_squarings=16)
    y7 = tadj.adjoint_sweep_fwd(c_all, x, mt, norms, **kw)
    p7 = tadj.torch_adjoint_sweep_fwd(c_all, x, mt, norms, **kw)
    k8 = tadj.adjoint_sweep_bwd(c_all, y7, a, mt, ms, norms, **kw)
    p8 = tadj.torch_adjoint_sweep_bwd(c_all, y7, a, mt, ms, norms, **kw)
    torch.cuda.synchronize()
    return dict(y=rel(y7, p7), a0=rel(k8[0], p8[0]), cb=rel(k8[1], p8[1]),
                k7=float((y7 - p7).abs().max()),
                k8=float((k8[0] - p8[0]).abs().max()))


def model_rows(model, theta, n_steps: int, dtype):
    """The model's adjoint core at order 4 and its fixed-step rows (R, K')
    over [0, T] in ``dtype``."""
    core = tdiff._adjoint_core(model.basis_pair(dtype), model.coeff_fn,
                               order=4)
    t0, tf = (torch.tensor(v, dtype=torch.float64, device="cuda")
              for v in (0.0, model.T))
    return core, tdiff._make_rows_all(core.cols, 4, n_steps)(
        theta, t0, tf).to(dtype).contiguous()


def cotangents(B: int, dtype, seed: int = 9):
    rng = np.random.default_rng(seed)
    return torch.tensor(rng.standard_normal((B, 2 * DIM)) / np.sqrt(2 * DIM),
                        dtype=dtype, device="cuda")


def adjoint_many_phase(K0: int, batches) -> dict:
    """The fixed-step adjoint past K' = 6 ([adjoint-k10], [adjoint-k36]):
    the infidelity of ManyControls(K0) over ADJ_STEPS Magnus-4 steps, f32,
    value and theta / psi0 gradients at each batch: one K7 and one K8
    launch and no twin call, the gradients against the f64 matrix_exp
    oracle (the f64 port too at ADJ_B, <= 1e-8), and K7 and K8 against
    their twins in f64 on the path's rows (<= 1e-12). Returns the
    launches, the f64 check, the f32 gradient differences and the f32
    value-and-grad at ADJ_B (``vg``) for the timing."""
    model = ManyControls(K0)
    label = f"[adjoint-k{model.Kp}]"
    out = {}
    for B in batches:
        _, y0, tg, _ = adjoint_inputs(torch.float32, B)
        theta = model.theta(torch.float32)
        reset_counts()
        with TwinCalls() as tw:
            value, grads = value_and_grads(model, y0, tg, theta, order=4)
            torch.cuda.synchronize()
        k6, k7, k8, k4 = adj_counts()
        assert (k6, k7, k8, k4, tw.n) == (0, 1, 1, 0, 0), (k6, k7, k8, k4,
                                                           tw.n)
        assert all(bool(torch.isfinite(g).all()) for g in grads)
        _, y64, tg64, _ = adjoint_inputs(torch.float64, B)
        th64 = model.theta(torch.float64)
        vo, go = adjoint_oracle(model, y64, tg64, th64, ADJ_STEPS)
        d32 = grad_diff(grads, go)
        dv32 = abs(float(value) - float(vo)) / abs(float(vo))
        assert d32 <= 1e-3 and dv32 <= 1e-4, (d32, dv32)
        f64 = ""
        if B == ADJ_B:
            v64, g64 = value_and_grads(model, y64, tg64, th64, order=4)
            d64 = grad_diff(g64, go)
            dv64 = abs(float(v64) - float(vo)) / abs(float(vo))
            assert d64 <= 1e-8 and dv64 <= 1e-8, (d64, dv64)
            core, c_all = model_rows(model, th64, ADJ_STEPS, torch.float64)
            d = sweep_check(core, c_all, torch.cat([y64.re, y64.im], -1),
                            cotangents(B, torch.float64))
            assert max(d["y"], d["a0"], d["cb"]) <= 1e-12, d
            out["f64"] = d
            f64 = (f"; f64 port vs the oracle: value {dv64:.2e}, gradients "
                   f"{d64:.2e} (<= 1e-8); K7 / K8 vs their twins on the "
                   f"path's {c_all.shape[0]} rows in f64: y {d['y']:.2e}, "
                   f"a0 {d['a0']:.2e}, cbar {d['cb']:.2e} (<= 1e-12)")
        out[B] = dict(k7=k7, k8=k8, grads=d32)
        if B == ADJ_B:
            out["vg"] = lambda y0=y0, tg=tg, theta=theta: value_and_grads(
                model, y0, tg, theta, order=4)
        print(f"{label} {B}x{DIM}c ManyControls({K0}) infidelity, "
              f"{ADJ_STEPS} Magnus-4 steps, f32: value {float(value):.6f}, "
              f"K7 {k7} and K8 {k8} launch (K6 {k6}, K4 {k4}), no twin "
              f"call; f32 vs the f64 matrix_exp oracle: value {dv32:.2e}, "
              f"gradients (theta, psi0) {d32:.2e} relative{f64}", flush=True)
    return out


BASIS_STEPS = 64   # [basis-grad] and [adjoint-dense]


def basis_loss(model, basis, y0, tg, theta):
    yf = tdiff.adjoint_solve(basis, model.coeff_fn, theta, y0, 0.0, model.T,
                             BASIS_STEPS, order=4, basis_grad=True)
    return 1.0 - torch.sum(model.fidelity(yf, tg))


def basis_grad_phase():
    """adjoint_solve(basis_grad=True) at 256x64c over four basis terms,
    BASIS_STEPS Magnus-4 steps: in f32 one K7 launch and one K6 launch a
    row and no twin call; the basis gradient along a seeded direction
    against a central difference in f64 on the card; the f32 gradients
    (theta, the basis pair) against the f64 ones. Returns the K6
    launches and the value-and-grad closure (f32) for the timing."""
    model = ManyControls(4)

    def run(dtype):
        _, y0, tg, _ = adjoint_inputs(dtype)
        b = model.basis_pair(dtype)
        b = Cplx(b.re.clone().requires_grad_(True),
                 b.im.clone().requires_grad_(True))
        th = model.theta(dtype).requires_grad_(True)

        def vg():
            value = basis_loss(model, b, y0, tg, th)
            return value, torch.autograd.grad(value, (th, b.re, b.im))
        return vg, (y0, tg, th, b)

    vg32, _ = run(torch.float32)
    reset_counts()
    with TwinCalls() as tw:
        value, g32 = vg32()
        torch.cuda.synchronize()
    k6, k7, k8, k4 = adj_counts()
    R = BASIS_STEPS
    assert (k6, k7, k8, k4, tw.n) == (R, 1, 0, 0, 0), (k6, k7, k8, k4, tw.n)
    vg64, (y0, tg, th, b) = run(torch.float64)
    v64, g64 = vg64()
    d32 = grad_diff(g32, g64)
    assert d32 <= 1e-3, d32
    rng = np.random.default_rng(17)
    V = [torch.tensor(rng.standard_normal(b.re.shape), dtype=torch.float64,
                      device="cuda") for _ in range(2)]
    V = [v / float(torch.sqrt(V[0].square().sum() + V[1].square().sum()))
         for v in V]
    eps = 1e-5
    with torch.no_grad():
        lp, lm = (float(basis_loss(model, Cplx(b.re + s * eps * V[0],
                                               b.im + s * eps * V[1]),
                                   y0, tg, th)) for s in (1.0, -1.0))
    fd = (lp - lm) / (2 * eps)
    an = float((g64[1] * V[0]).sum() + (g64[2] * V[1]).sum())
    dfd = abs(an - fd) / max(abs(fd), 1e-30)
    assert dfd <= 1e-6, (an, fd, dfd)
    print(f"[basis-grad] {ADJ_B}x{DIM}c ManyControls(4) infidelity, "
          f"basis_grad=True, {R} Magnus-4 steps, f32: value "
          f"{float(value):.6f}, K7 {k7} launch and K6 {k6} (one a row; K8 "
          f"{k8}, K4 {k4}), no twin call; f64 on the card: the basis "
          f"gradient along a seeded unit direction {an:.10e} against the "
          f"central difference {fd:.10e} (eps {eps:g}): {dfd:.2e} relative "
          f"(<= 1e-6); f32 gradients (theta, basis re / im) vs f64 "
          f"{d32:.2e} relative (<= 1e-3)", flush=True)
    return k6, vg32


def dense_op_fn(dtype):
    """DrivenDense(64)'s black-box operator with a pulse amplitude and a
    time scale: A(t; theta) = theta0 op_pair(theta1 t) = -i theta0 (H0 +
    cos(w theta1 t) V), a Cplx pair in ``dtype``."""
    model = DrivenDense.make(d=DIM, seed=0)

    def op_fn(t, th):
        A = model.op_pair(th[1] * t, dtype, device="cuda")
        return Cplx(th[0] * A.re, th[0] * A.im)
    return op_fn


def adjoint_dense_phase():
    """adjoint_solve_dense over dense_op_fn at 256x64c, BASIS_STEPS
    Magnus-4 steps, f64 (no hand kernel on this path: every launch count
    stays 0): the infidelity's theta gradient along a seeded direction
    against a central difference, the state's norm kept. Returns the
    value-and-grad closure for the timing."""
    op_fn = dense_op_fn(torch.float64)
    _, y0, tg, _ = adjoint_inputs(torch.float64)
    theta = torch.tensor([1.0, 0.8], dtype=torch.float64, device="cuda")

    def loss(th):
        yf = tdiff.adjoint_solve_dense(op_fn, th, y0, 0.0, 1.0, BASIS_STEPS,
                                       order=4)
        return yf, 1.0 - torch.sum(PulseControl.fidelity(yf, tg))

    def vg():
        th = theta.clone().requires_grad_(True)
        yf, value = loss(th)
        return yf, value, torch.autograd.grad(value, th)[0]

    reset_counts()
    yf, value, g = vg()
    torch.cuda.synchronize()
    check_no_hand_kernel("adjoint-dense")
    norm = float((yf.re.square() + yf.im.square()).sum(-1).sqrt()
                 .sub(1.0).abs().max())
    assert norm <= 1e-10, norm
    u = torch.tensor(np.random.default_rng(19).standard_normal(2),
                     dtype=torch.float64, device="cuda")
    u = u / u.norm()
    eps = 1e-6
    with torch.no_grad():
        lp, lm = (float(loss(theta + s * eps * u)[1]) for s in (1.0, -1.0))
    fd = (lp - lm) / (2 * eps)
    an = float((g * u).sum())
    dfd = abs(an - fd) / max(abs(fd), 1e-30)
    assert dfd <= 1e-6, (an, fd, dfd)
    print(f"[adjoint-dense] {ADJ_B}x{DIM}c DrivenDense black-box operator, "
          f"adjoint_solve_dense, {BASIS_STEPS} Magnus-4 steps, f64: value "
          f"{float(value):.10f}, every hand kernel's launch count 0, max "
          f"||psi| - 1| {norm:.2e}; theta gradient along a seeded unit "
          f"direction {an:.10e} vs the central difference {fd:.10e}: "
          f"{dfd:.2e} relative (<= 1e-6)", flush=True)
    return vg


PULSES, PULSE_STATES = 4, 64   # [pulse-vmap]


def pulse_vmap_phase():
    """torch.func.vmap of torch.func.grad_and_value of PulseControl's f32
    infidelity over PULSES pulses x PULSE_STATES states at 64c: one K7 and
    one K8 launch per pulse (the operators' vmap rule runs the samples in
    turn), no twin call; values and gradients against the per-pulse loop.
    Returns the largest relative difference."""
    pc, y0, tg, _ = adjoint_inputs(torch.float32, PULSE_STATES)
    rng = np.random.default_rng(23)
    thetas = torch.tensor(0.1 + 0.05 * rng.standard_normal((PULSES, 6)),
                          dtype=torch.float32, device="cuda")

    def loss(th):
        return pc.infidelity(th, y0, tg, n_steps=ADJ_STEPS,
                             dtype=torch.float32)

    reset_counts()
    with TwinCalls() as tw:
        gv, vv = torch.func.vmap(torch.func.grad_and_value(loss))(thetas)
        torch.cuda.synchronize()
    k6, k7, k8, k4 = adj_counts()
    assert (k6, k7, k8, k4, tw.n) == (0, PULSES, PULSES, 0, 0), (
        k6, k7, k8, k4, tw.n)
    dv = dg = 0.0
    for p in range(PULSES):
        th = thetas[p].clone().requires_grad_(True)
        v = loss(th)
        (g,) = torch.autograd.grad(v, th)
        dv = max(dv, abs(float(vv[p]) - float(v)) / abs(float(v)))
        dg = max(dg, rel(gv[p], g))
    assert dv <= 1e-6 and dg <= 1e-6, (dv, dg)
    print(f"[pulse-vmap] PulseControl({DIM}c) infidelity, {PULSES} pulses x "
          f"{PULSE_STATES} states, {ADJ_STEPS} Magnus-4 steps, f32, "
          f"torch.func.vmap(grad_and_value): K7 {k7} and K8 {k8} launches "
          f"(one a pulse), no twin call; vs the per-pulse loop: values "
          f"{dv:.2e}, gradients {dg:.2e} relative (<= 1e-6)", flush=True)
    return max(dv, dg)


def fit_loop_phase(trained):
    """fit_loop with Adam(lr=0.05), five iterations on the f32 infidelity
    of adjoint_training_phase: its parameters and losses (``trained``)."""
    pc, y0, tg, theta = adjoint_inputs(torch.float32)
    res = tdiff.fit_loop(
        lambda th: pc.infidelity(th, y0, tg, n_steps=ADJ_STEPS,
                                 dtype=torch.float32),
        theta, optimizer=lambda p: torch.optim.Adam(p, lr=0.05), n_iters=5)
    params, losses = trained
    dp = float((res.params - params).abs().max())
    dl = max(abs(a - b) for a, b in zip(res.losses.tolist(), losses))
    assert res.n_done == 5 and dp <= 1e-6 and dl <= 1e-6, (dp, dl)
    print(f"[fit-loop] fit_loop, Adam(lr=0.05), five iterations on the "
          f"infidelity: losses {[round(v, 6) for v in res.losses.tolist()]}; "
          f"vs [adjoint-train]'s loop: parameters max |d| {dp:.2e}, losses "
          f"{dl:.2e} (<= 1e-6)", flush=True)


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


def row_plan_text(B: int, D: int, Kp: int, m: int) -> str:
    """K6's plan at B in f32 (ops/adjoint.py:row_plan on this card, held
    to the kernel's own, kernel_row_plan) and its ptxas line."""
    props = torch.cuda.get_device_properties(0)
    plan = tadj.row_plan(B, D, Kp, 4, m, n_sm=props.multi_processor_count,
                         max_smem=getattr(props,
                                          "shared_memory_per_block_optin",
                                          232448))
    got = tadj.kernel_row_plan(B, D, Kp, m, torch.float32)
    assert all(plan[k] == v for k, v in got.items()), (plan, got)
    return (f"; plan {plan['route']}, {plan['n']} block(s) a tile of "
            f"{plan['lanes']} lanes, {plan['blocks']} blocks of "
            f"{plan['threads']} threads, {plan['smem']} B shared memory, "
            f"basis {'resident' if plan['resident'] else 'ringed'}; ptxas "
            f"{ptxas_of('adjoint', 'adjoint_row f32 ' + plan['route'])}")


def k6_rows(B: int, ts, basis_f32):
    """K6's inputs on the adaptive path's own rows at B x 64c f32: the
    states x and cotangents a (B, D), each recorded iteration's per-lane
    rows c_lane (n_it, B, K') from the recorded times ts (n_it + 1, 256),
    its lanes repeated above 256; the adjoint core and its operands (mt,
    ms, norms, m, theta)."""
    pc, y0, _, theta = adjoint_inputs(torch.float32, B)
    core = tdiff._adjoint_core(basis_f32, pc.coeff_fn, order=4)
    x = torch.cat([y0.re, y0.im], -1)
    rng = np.random.default_rng(9)
    a = torch.tensor(rng.standard_normal(x.shape) / np.sqrt(x.shape[1]),
                     dtype=torch.float32, device="cuda")
    n_it = ts.shape[0] - 1
    lanes = torch.arange(B, device="cuda") % ts.shape[1]
    t_r, dt_r = ts[:-1][:, lanes], (ts[1:] - ts[:-1])[:, lanes]
    c_lane = torch.func.vmap(lambda t_, d_: core.cols(theta, t_, d_))(
        t_r.reshape(-1), dt_r.reshape(-1)).reshape(n_it, B,
                                                   core.Kp).contiguous()
    return x, a, c_lane, core, core.operands(x)


def k6_replay(row, c_lane, x, a):
    """One replay as the adaptive path runs K6: row(c, x, a) over the
    recorded iterations in reverse; returns the final (x, a)."""
    def run():
        xr, ar = x, a
        for r in range(c_lane.shape[0] - 1, -1, -1):
            xr, ar, _ = row(c_lane[r], xr, ar)
        return xr, ar
    return run


def adj_timing_at(B: int, card: str, basis_f32, c_all, ts):
    """K7, K8 and K6 per launch at B x 64c f32 on the path's basis: the
    fixed-step rows c_all (R, K'); for K6 the adaptive path's own per-lane
    rows from its recorded times ts (n_it + 1, 256), its lanes repeated
    above 256, timed as the path runs them: one replay of n_it launches in
    reverse, per launch its mean. At the path's batch in turns with their
    twins and the library yardstick; above it the kernels alone."""
    x, a, c_lane, core, (mt, ms, norms, m, th_t) = k6_rows(B, ts, basis_f32)
    kw = dict(m=m, theta=th_t, max_squarings=16)
    D, Kp, R = x.shape[1], core.Kp, c_all.shape[0]
    n_it = c_lane.shape[0]
    W = core.W

    def replay(row):
        return k6_replay(row, c_lane, x, a)

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
                    f"{n_it * B - formed} rows with dt = 0"
                    + row_plan_text(B, D, Kp, m))
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
    # operator call that diff.py makes (the launch; K8's also the sum of
    # its partials), read after each run
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

    plain_fns = tdiff.sweep_fwd_op, tdiff.sweep_bwd_op
    tdiff.sweep_fwd_op = evented("K7", plain_fns[0])
    tdiff.sweep_bwd_op = evented("K8", plain_fns[1])
    walls, in_wall = [], {"K7": [], "K8": []}
    try:
        for _ in range(3):
            for v in spans.values():
                v.clear()
            walls += timed_runs(vg, reps=1)  # synchronises at its end
            for name, v in spans.items():
                in_wall[name].append(sum(a.elapsed_time(b) for a, b in v))
    finally:
        tdiff.sweep_fwd_op, tdiff.sweep_bwd_op = plain_fns
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


def many_timing_phase(card: str) -> dict:
    """K7 and K8 per launch past K' = 6, at K' = 10 and 36 (ManyControls(4)
    and (8), the path's f32 rows of ADJ_STEPS Magnus-4 steps) at 256 and
    4096 trajectories: kernel (median of 3), the plain twin at 256, the
    library yardstick (matrix_exp of the rows and of the Fréchet blocks,
    and products; adj_library) and the bound by the least work
    (adj_flops, as for K' = 3), with the launch shape and ptxas lines.
    Returns {(name, K'): (ms at 256, plain ms, bound ms, bound by, library
    ms)}."""
    out = {}
    for K0 in (4, 8):
        model = ManyControls(K0)
        core, c_all = model_rows(model, model.theta(torch.float32),
                                 ADJ_STEPS, torch.float32)
        R, Kp = c_all.shape
        for B in (ADJ_B, ADJ_BIG):
            _, y0, _, _ = adjoint_inputs(torch.float32, B)
            x, a = torch.cat([y0.re, y0.im], -1), cotangents(B, torch.float32)
            D = x.shape[1]
            mt, ms, norms, m, th = core.operands(x)
            kw = dict(m=m, theta=th, max_squarings=16)
            _, n_pass = expmv.scale_rows(c_all[:, None], norms, th, 16)
            cases = {
                "K7": (lambda: tadj.adjoint_sweep_fwd(c_all, x, mt, norms,
                                                      **kw),
                       lambda: tadj.torch_adjoint_sweep_fwd(c_all, x, mt,
                                                            norms, **kw),
                       lambda: adj_library(core.W, c_all, x, a, False)),
                "K8": (lambda: tadj.adjoint_sweep_bwd(c_all, x, a, mt, ms,
                                                      norms, **kw),
                       lambda: tadj.torch_adjoint_sweep_bwd(
                           c_all, x, a, mt, ms, norms, **kw),
                       lambda: adj_library(core.W, c_all, x, a, True))}
            for name, (kern, plain, lib) in cases.items():
                got, lb = kern(), lib()
                got, lb = ((got,), (lb,)) if name == "K7" else (got, lb)
                d_lib = max(rel(u, v) for u, v in zip(got, lb))
                assert d_lib <= 1e-3, (name, Kp, B, d_lib)
                del got, lb
                with_plain = B == ADJ_B
                runs = {"kernel": [], "plain": [], "library": []}
                for _ in range(3):  # in turns
                    runs["kernel"].append(timed_ms(kern, reps=1))
                    if with_plain:
                        runs["plain"].append(timed_ms(plain, reps=1))
                    runs["library"].append(timed_ms(lib, reps=1))
                k_ms = statistics.median(runs["kernel"])
                p_ms = statistics.median(runs["plain"]) if with_plain else None
                l_ms = statistics.median(runs["library"])
                nbytes = 4 * ((2 if name == "K7" else 3) * B * D + R * Kp
                              + (1 if name == "K7" else 2) * Kp * D * D)
                flop = adj_flops(n_pass.flatten().tolist(), B, D, Kp, m,
                                 name == "K8")
                b_ms, b_by = bound(flop, nbytes)
                print(f"[time] {name} at B={B}, d={DIM}, K'={Kp}, f32, R={R} "
                      f"rows ({int(n_pass.sum()) * B} trajectory-row "
                      f"passes){sweep_shape(x, B, Kp, name)}: kernel "
                      f"{k_ms:.4f} ms per launch "
                      f"({flop / k_ms / 1e9:.2f} TFLOP/s)"
                      + (f", plain twin {p_ms:.4f} ms" if with_plain else "")
                      + f", library {l_ms:.4f} ms (max rel |d| {d_lib:.2e})"
                      + "; runs " + ", ".join(
                          f"{k} {[round(v, 4) for v in r]}"
                          for k, r in runs.items() if r)
                      + f"; bound {b_ms:.4f} ms by {b_by} "
                      f"({flop / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB a "
                      f"launch), kernel at {b_ms / k_ms:.1%} of it ({card})",
                      flush=True)
                if B == ADJ_B:
                    out[(name, Kp)] = (k_ms, p_ms, b_ms, b_by, l_ms)
    return out


def wall_phase(label: str, vg, card: str) -> float:
    """A value-and-grad wall: median of 3 CUDA-event timed calls after a
    warm one."""
    vg()
    walls = timed_runs(vg)
    wall = statistics.median(walls)
    print(f"[time] {label}: median wall {wall:.3f} ms of "
          f"{[round(w, 3) for w in walls]} ({card})", flush=True)
    return wall


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


# -- the front door: the generic RK ensemble and the scalar tier ------------

GRK_ROWS = 64               # rows held in f64 on the card against the CPU
VDP_TRAJ, VDP_STEPS = 4096, 1000    # BASELINE config 2 (benchmarks.py:63)


def check_no_hand_kernel(label: str) -> None:
    launches = all_launches()
    assert launches == (0,) * len(launches), (label, launches)


def check_ieee_products() -> None:
    """The error estimates below run through cuBLAS: no TF32."""
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def generic_rk_solve(model, y0, dtype=torch.float32):
    """The JAX package's flagship entry (``__graft_entry__.py:99-114``):
    the generic vmapped RKF45 ensemble, ``stepper=None``, over
    ``DrivenDense.rhs_pair``."""
    return ensemble_solve(lambda t, y: model.rhs_pair(t, y, dtype), y0, 0.0,
                          TF, h0=H0, ctl=CTL, time_dtype=dtype)


def rows_of(y, n: int, dtype, device) -> Cplx:
    return Cplx(y.re[:n].to(device=device, dtype=dtype),
                y.im[:n].to(device=device, dtype=dtype))


def generic_rk_phase(card: str) -> None:
    """The generic vmapped RKF45 ensemble at 16 384 x 64c f32 (BASELINE
    config 5): no hand kernel on its path; held against the K1 main path
    on the same states, and its first 64 rows in f64 against the CPU."""
    check_ieee_products()
    st, y0 = main_inputs()
    model = DrivenDense.make(d=DIM, seed=0)
    reset_counts()
    sol = generic_rk_solve(model, y0)
    torch.cuda.synchronize()
    check_no_hand_kernel("generic-rk")
    assert sol.path == "torch-driver", sol.path
    assert sol.y_final.re.shape == (N_TRAJ, DIM)
    assert bool(torch.isfinite(sol.y_final.re).all()
                & torch.isfinite(sol.y_final.im).all()), "non-finite state"
    n_done = int((sol.status == DONE).sum())
    assert n_done == N_TRAJ, f"{N_TRAJ - n_done} trajectories not DONE"
    norm = torch.sqrt((sol.y_final.re ** 2 + sol.y_final.im ** 2).sum(-1))
    norm_dev = float((norm - 1).abs().max())
    assert norm_dev <= 1e-4, f"|psi| drifted by {norm_dev}"
    print(f"[generic-rk] {N_TRAJ}x{DIM}c ensemble_solve(rhs_pair, "
          f"stepper=None) RKF45 rtol={CTL.rtol:g} f32: all DONE, "
          f"max||psi|-1|={norm_dev:.3e} (<= 1e-4), path={sol.path}, hand "
          f"kernel launches {all_launches()} (all 0), n_iters up to "
          f"{int(sol.n_iters.max())}, n_accept "
          f"{int(sol.n_accept.min())}..{int(sol.n_accept.max())}, n_reject "
          f"{int(sol.n_reject.min())}..{int(sol.n_reject.max())}", flush=True)

    # the K1 main path on the same states: rtol 1e-8 sits at f32 rounding,
    # so a step at the controller's edge may fall the other way
    k1 = solve(st, y0)
    dy = max_dy(sol, k1)
    dcount = max(int((sol.n_accept - k1.n_accept).abs().max()),
                 int((sol.n_reject - k1.n_reject).abs().max()))
    assert dy <= 1e-4 and dcount <= 2, (dy, dcount)
    print(f"[generic-rk] vs the K1 main path on the same y0: max|dy|="
          f"{dy:.3e} (<= 1e-4), max|dcount|={dcount} (<= 2) on "
          f"{int((sol.n_iters != k1.n_iters).sum())} rows with another "
          f"n_iters", flush=True)

    on_card = generic_rk_solve(
        model, rows_of(y0, GRK_ROWS, torch.float64, "cuda"), torch.float64)
    on_cpu = generic_rk_solve(
        model, rows_of(y0, GRK_ROWS, torch.float64, "cpu"), torch.float64)
    for k in ("status", "n_accept", "n_reject", "n_iters"):
        assert torch.equal(getattr(on_card, k).cpu(), getattr(on_cpu, k)), k
    dys = max(float((a.cpu() - b).abs().max())
              for a, b in zip(on_card.ys, on_cpu.ys))
    assert dys <= 1e-10, dys
    print(f"[generic-rk] first {GRK_ROWS} rows in f64, card vs CPU: equal "
          f"status / n_accept / n_reject / n_iters, max|dys|={dys:.3e} "
          f"(<= 1e-10)", flush=True)

    ms, walls, tsol, peak = walls_of(lambda: generic_rk_solve(model, y0))
    k1_ms, k1_walls, k1_sol, k1_peak = walls_of(lambda: solve(st, y0))
    acc = int(tsol.n_accept.sum())
    print(f"[generic-rk] wall: median {ms:.3f} ms of "
          f"{[round(w, 3) for w in walls]} after a warm solve, "
          f"{int(tsol.n_iters.max())} iterations, {acc} accepted steps, "
          f"{acc / (ms / 1e3):.4e} accepted steps/s, peak memory "
          f"{peak:.1f} MiB; the K1 main path on the same inputs: median "
          f"{k1_ms:.3f} ms of {[round(w, 3) for w in k1_walls]}, "
          f"{int(k1_sol.n_iters.max())} iterations, "
          f"{int(k1_sol.n_accept.sum()) / (k1_ms / 1e3):.4e} accepted "
          f"steps/s, peak {k1_peak:.1f} MiB ({card})", flush=True)


def vdp_solve(y0, dtype):
    """BASELINE config 2 (``benchmarks.py:63-87``): fixed-step RK4 over Van
    der Pol (mu = 1.5), h = 10 / 1000 on [0, 10]."""
    return ensemble_solve(VanDerPol(mu=1.5).rhs, y0, 0.0, 10.0,
                          stepper=RungeKutta(RK4), adaptive=False,
                          h0=10.0 / VDP_STEPS, time_dtype=dtype)


def vdp_rk4_phase(card: str) -> None:
    y_np = np.random.default_rng(0).uniform(-2, 2, (VDP_TRAJ, 2))
    y0 = torch.as_tensor(y_np, dtype=torch.float32, device="cuda")
    reset_counts()
    sol = vdp_solve(y0, torch.float32)
    torch.cuda.synchronize()
    check_no_hand_kernel("vdp-rk4")
    assert sol.path == "torch-driver", sol.path
    assert bool((sol.status == DONE).all()), "not all DONE"
    assert bool((sol.n_accept == VDP_STEPS).all()), (
        int(sol.n_accept.min()), int(sol.n_accept.max()))
    assert bool(torch.isfinite(sol.y_final).all())
    ref = vdp_solve(torch.as_tensor(y_np[:GRK_ROWS]), torch.float64)
    dy = float((sol.y_final[:GRK_ROWS].double().cpu() - ref.y_final)
               .abs().max())
    assert dy <= 1e-3, dy
    ms, walls, tsol, peak = walls_of(lambda: vdp_solve(y0, torch.float32))
    steps = int(tsol.n_accept.sum())
    print(f"[vdp-rk4] {VDP_TRAJ} Van der Pol trajectories, RungeKutta(RK4) "
          f"fixed h=0.01 on [0, 10] f32: all DONE, n_accept == {VDP_STEPS} "
          f"on every row, path={sol.path}, hand kernel launches "
          f"{all_launches()} (all 0); first {GRK_ROWS} rows vs the f64 CPU "
          f"solve: max|dy|={dy:.3e} (<= 1e-3); wall: median {ms:.3f} ms of "
          f"{[round(w, 3) for w in walls]}, {steps / (ms / 1e3):.4e} "
          f"steps/s, peak memory {peak:.1f} MiB ({card})", flush=True)


def solve_ivp_phase(card: str) -> None:
    """BASELINE config 1 through the scalar tier on the card: adaptive
    RKF45 on an 8-dim linear ODE in f64 against its closed form and the
    same solve on the CPU, a backward solve with two saves, and
    solve_linear over the split solvers on the driven chain."""
    A = stable_dense_matrix(8, seed=0, device="cuda")
    model, cpu_model = LinearConstant(A), LinearConstant(A.cpu())
    y0 = torch.linspace(0.3, 1.0, 8, dtype=torch.float64, device="cuda")
    ctl = StepControl(rtol=1e-10, min_dt=1e-10, max_dt=0.5)

    def fwd(m, y):
        return solve_ivp(m.rhs, 0.0, 2.0, y, ctl=ctl, h0=1e-3)

    def back(m, y):
        return solve_ivp(m.rhs, 2.0, 0.0, y, ctl=ctl, h0=1e-3,
                         save_at=[0.5, 1.5])

    def same(a, b, label, tol=1e-12):
        for k in ("status", "n_accept", "n_reject", "n_iters",
                  "n_rhs_evals"):
            assert torch.equal(getattr(a, k).cpu(), getattr(b, k)), (label, k)
        leaves = torch.utils._pytree.tree_leaves
        d = max(float((x.cpu() - y).abs().max())
                for x, y in zip(leaves((a.y_final, a.ys)),
                                leaves((b.y_final, b.ys))))
        assert d <= tol, (label, d)
        return d

    reset_counts()
    sol = fwd(model, y0)
    bsol = back(model, sol.y_final)
    torch.cuda.synchronize()
    check_no_hand_kernel("solve-ivp")
    assert sol.path == bsol.path == "torch-driver"
    assert int(sol.status) == int(bsol.status) == DONE
    err = float((sol.y_final - model.exact(2.0, y0)).abs().max())
    assert err <= 1e-8, err
    d_cpu = same(sol, fwd(cpu_model, y0.cpu()), "forward")
    ts = bsol.ts.cpu().tolist()
    assert ts == [0.0, 0.5, 1.5, 2.0], ts
    exact_ys = torch.stack([model.exact(t, y0) for t in ts])
    err_b = float((bsol.ys - exact_ys).abs().max())
    assert err_b <= 1e-8, err_b
    db_cpu = same(bsol, back(cpu_model, sol.y_final.cpu()), "backward")
    ms = statistics.median(timed_runs(lambda: fwd(model, y0)))
    print(f"[solve-ivp] LinearConstant(stable_dense_matrix(8)) RKF45 "
          f"rtol=1e-10 f64 on the card: DONE, {int(sol.n_accept)} accepted /"
          f" {int(sol.n_reject)} rejected, n_rhs_evals "
          f"{int(sol.n_rhs_evals)}, max|y - exp(2A) y0|={err:.3e} (<= 1e-8),"
          f" vs the CPU: equal counters, max|dy|={d_cpu:.3e} (<= 1e-12); "
          f"backward 2 -> 0 with saves at 0.5, 1.5: ts={ts}, max|ys - "
          f"exact|={err_b:.3e} (<= 1e-8), vs the CPU max|dy|={db_cpu:.3e} "
          f"(<= 1e-12), hand kernel launches {all_launches()} (all 0); "
          f"forward wall median {ms:.3f} ms ({card})", flush=True)

    # a python y0, no device named: the solve runs on the card
    def decay(**kw):
        return solve_ivp(lambda t, y: -y, 0.0, 2.0, 1.0, ctl=ctl, **kw)

    reset_counts()
    psol = decay()
    check_no_hand_kernel("solve-ivp python y0")
    assert psol.y_final.device.type == psol.ts.device.type == "cuda"
    assert int(psol.status) == DONE
    dp = same(psol, decay(device="cpu"), "python y0")
    print(f"[solve-ivp] y' = -y from the python float y0 = 1.0, no device "
          f"named: solved on {psol.y_final.device} in "
          f"{psol.y_final.dtype}, vs device='cpu': equal counters, "
          f"max|dy|={dp:.3e} (<= 1e-12) ({card})", flush=True)

    chain = TightBindingChain(n=8, J=1.0, seed=3, w=2.0)
    psi0 = np.zeros(8, np.complex128)
    psi0[4] = 1.0
    for st in (texp.SplitMidpoint(texp.DenseCplxSplit(),
                                  texp.DiagonalCplxSplit()),
               texp.ExpMidpoint(texp.StrangSplit(texp.DenseCplxSplit(),
                                                 texp.DiagonalCplxSplit()))):
        def lin(dev):
            return solve_linear(
                lambda t: chain.ops_pair(t, torch.float64, device=dev), 0.0,
                2.0, from_complex(psi0, torch.float64, device=dev),
                stepper=st, h0=0.05)

        reset_counts()
        lsol = lin("cuda")
        torch.cuda.synchronize()
        check_no_hand_kernel("solve-linear")
        assert int(lsol.status) == DONE and lsol.path == "torch-driver"
        d = same(lsol, lin("cpu"), type(st).__name__)
        n2 = float((lsol.y_final.re ** 2 + lsol.y_final.im ** 2).sum())
        assert abs(n2 - 1.0) <= 1e-12, n2
        ms = statistics.median(timed_runs(lambda: lin("cuda")))
        name = (f"ExpMidpoint({type(st.split).__name__})"
                if isinstance(st, texp.ExpMidpoint) else type(st).__name__)
        print(f"[solve-ivp] solve_linear TightBindingChain(8) {name} h=0.05"
              f" f64 on the card: DONE, {int(lsol.n_accept)} steps, vs the "
              f"CPU max|dy|={d:.3e} (<= 1e-12), ||psi||^2 - 1 = "
              f"{n2 - 1:.3e} (within 1e-12); wall median {ms:.3f} ms "
              f"({card})", flush=True)


# -- the driver finished: scan, gradients, dense tiers, FSAL ------------------

SCAN_STEPS = 48                    # the main path's while loop takes 33
SCAN_CTL = dataclasses.replace(CTL, max_steps=SCAN_STEPS)
GRAD_ROWS = 256                    # [grad-flagship]'s f64 card-vs-CPU rows
VDP_GRAD_ROWS = 64                 # [grad-vdp]'s f64 central difference
VDP_SCAN = VDP_STEPS + 2           # 1000 steps and the t0 / tf grid hits
DENSE_CTL = StepControl(rtol=1e-6, min_dt=1e-6, max_dt=0.25)


def scan_solve(st, y0, method, ctl=SCAN_CTL):
    return ensemble_solve(None, y0, 0.0, TF, stepper=st, ctl=ctl, h0=H0,
                          adaptive=True, time_dtype=torch.float32,
                          method=method)


def same_counters(a, b, label) -> None:
    for k in ("status", "n_accept", "n_reject", "n_iters"):
        assert torch.equal(getattr(a, k).cpu(), getattr(b, k).cpu()), (label,
                                                                       k)


def scan_k1_phase(card: str) -> int:
    """The main path with method="scan": exactly SCAN_STEPS K1 launches,
    no host sync inside the loop, bitwise the while path's result; K1
    refuses an operator that requires grad."""
    st, y0 = main_inputs()
    reset_counts()
    sol = scan_solve(st, y0, "scan")
    torch.cuda.synchronize()
    launches = all_launches()
    assert launches == (SCAN_STEPS,) + (0,) * (len(launches) - 1), launches
    assert sol.path == "torch-driver+cuda-step", sol.path
    ref = scan_solve(st, y0, "while")
    assert int((ref.status == DONE).sum()) == N_TRAJ
    same_counters(sol, ref, "scan-k1")
    assert torch.equal(sol.y_final.re, ref.y_final.re)
    assert torch.equal(sol.y_final.im, ref.y_final.im)

    # the loop alone under the sync check: driver.resume from a carry made
    # outside it, the step's operands made by one warm call
    step = st.make_step_fn()
    grid = driver.make_grid(0.0, TF, dtype=torch.float32, device="cuda")
    state = driver.init_state(y0, grid, H0, (N_TRAJ,))
    step(state.t, state.x, torch.zeros_like(state.t))
    torch.cuda.synchronize()
    reset_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        dsol = driver.resume(state, step, ctl=SCAN_CTL, batched=True,
                             error_norm=st.error_norm, method="scan")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert fused_rk_step.launches == SCAN_STEPS, fused_rk_step.launches
    assert torch.equal(dsol.y_final.re, sol.y_final.re)

    gst = dataclasses.replace(st, M1=st.M1.detach().clone().requires_grad_())
    with torch.enable_grad():
        try:
            scan_solve(gst, y0, "scan")
        except TypeError as e:
            refusal = str(e)
        else:
            raise AssertionError("K1 ran an operator that requires grad")
    assert "no backward" in refusal, refusal

    scan_ms, scan_walls, _, scan_peak = walls_of(
        lambda: scan_solve(st, y0, "scan"))
    while_ms, while_walls, _, while_peak = walls_of(
        lambda: scan_solve(st, y0, "while"))
    print(f"[scan-k1] {N_TRAJ}x{DIM}c RKF45 method='scan' max_steps="
          f"{SCAN_STEPS}: K1 launches {launches[0]} == max_steps (the rest "
          f"{launches[1:]}), path={sol.path}, status / n_accept / n_reject "
          f"/ n_iters and y_final bitwise the while path's (n_iters up to "
          f"{int(ref.n_iters.max())}); the loop ran under "
          f"set_sync_debug_mode('error') with no sync; an M1 that requires "
          f"grad: TypeError ({refusal[:60]}...); wall: scan median "
          f"{scan_ms:.3f} ms of {[round(w, 3) for w in scan_walls]} (peak "
          f"{scan_peak:.1f} MiB), while {while_ms:.3f} ms of "
          f"{[round(w, 3) for w in while_walls]} (peak {while_peak:.1f} "
          f"MiB) ({card})", flush=True)
    return launches[0]


def flagship_rhs(model, eps, dtype, device):
    """DrivenDense.rhs_pair with the drive's operator scaled by ``eps``:
    dpsi/dt = -i (H0 + eps cos(w t) V) psi, the same single product of
    [re | im] with [embed(-i H0)^T | embed(-i V)^T] a stage."""
    H0m, V = (from_complex(m, dtype, device=device)
              for m in (model.H0, model.V))
    W = torch.cat([embed(Cplx(H.im, -H.re)).T for H in (H0m, V)],
                  dim=-1).contiguous()

    def f(t, psi):
        c = torch.cos(model.w * t.to(dtype))
        y = torch.cat([psi.re, psi.im], dim=-1) @ W
        cv = (eps * c) * y[..., 2 * DIM:]
        return Cplx(y[..., :DIM] + cv[..., :DIM],
                    y[..., DIM:2 * DIM] + cv[..., DIM:])

    return f


def flagship_loss(model, eps, y0, dtype, method="scan", **kw):
    """The mean of |z_0(tf)|^2 over the flagship ensemble (stepper=None,
    RKF45 on the vmapped tier), and its Solution."""
    dev = y0.re.device
    sol = ensemble_solve(flagship_rhs(model, eps, dtype, dev), y0, 0.0, TF,
                         h0=H0, ctl=SCAN_CTL, time_dtype=dtype,
                         method=method, **kw)
    return (sol.y_final.re[:, 0] ** 2 + sol.y_final.im[:, 0] ** 2).mean(), sol


def flagship_value_and_grad(model, y0, dtype, device, levels):
    eps = torch.tensor(1.0, dtype=dtype, device=device, requires_grad=True)
    loss, sol = flagship_loss(model, eps, y0, dtype, grad_safe=True,
                              remat_levels=levels)
    (g,) = torch.autograd.grad(loss, eps)
    return loss.detach(), g, sol


def grad_flagship_phase(card: str) -> dict:
    """Value and gradient through the driver on the flagship: the vmapped
    RKF45 ensemble with method="scan", grad_safe and remat_levels; no hand
    kernel."""
    check_ieee_products()
    _, y0 = main_inputs()
    model = DrivenDense.make(d=DIM, seed=0)
    one = torch.tensor(1.0, device="cuda")
    reset_counts()
    v, g, sol = flagship_value_and_grad(model, y0, torch.float32, "cuda", 1)
    torch.cuda.synchronize()
    check_no_hand_kernel("grad-flagship")
    assert int((sol.status == DONE).sum()) == N_TRAJ, "not all DONE"
    assert sol.path == "torch-driver", sol.path
    assert bool(torch.isfinite(g)), g
    with torch.no_grad():
        v_while, _ = flagship_loss(model, one, y0, torch.float32,
                                   method="while")
    dv = abs(float(v) / float(v_while) - 1)
    assert dv <= 1e-5, (float(v), float(v_while))

    rows = rows_of(y0, GRAD_ROWS, torch.float64, "cuda")
    _, g_card, _ = flagship_value_and_grad(model, rows, torch.float64,
                                           "cuda", 0)
    _, g_cpu, _ = flagship_value_and_grad(
        model, rows_of(y0, GRAD_ROWS, torch.float64, "cpu"), torch.float64,
        "cpu", 0)
    d_cpu = abs(float(g_card) - float(g_cpu))
    assert d_cpu <= 1e-10, (float(g_card), float(g_cpu))
    step = 1e-6
    with torch.no_grad():
        lp, _ = flagship_loss(model, torch.tensor(1.0 + step,
                                                  dtype=torch.float64,
                                                  device="cuda"),
                              rows, torch.float64)
        lm, _ = flagship_loss(model, torch.tensor(1.0 - step,
                                                  dtype=torch.float64,
                                                  device="cuda"),
                              rows, torch.float64)
    fd = float(lp - lm) / (2 * step)
    d_fd = abs(float(g_card) / fd - 1)
    assert d_fd <= 1e-6, (float(g_card), fd)

    out = {}
    for levels in (0, 1):
        # warm already: three timed runs, the peak over them
        torch.cuda.reset_peak_memory_stats()
        res = []
        walls = timed_runs(lambda: res.append(flagship_value_and_grad(
            model, y0, torch.float32, "cuda", levels)))
        ms = statistics.median(walls)
        peak = torch.cuda.max_memory_allocated() / 2**20
        res = res[0]
        out[levels] = (ms, peak)
        print(f"[grad-flagship] remat_levels={levels}: value-and-grad wall "
              f"median {ms:.3f} ms of {[round(w, 3) for w in walls]}, peak "
              f"memory {peak:.1f} MiB, d/d eps = {float(res[1]):.6e} "
              f"({card})", flush=True)
    print(f"[grad-flagship] {N_TRAJ}x{DIM}c ensemble_solve(rhs_pair with "
          f"eps V, stepper=None) RKF45 method='scan' max_steps={SCAN_STEPS} "
          f"grad_safe=True remat_levels=1 f32: all DONE, loss mean|z_0(tf)|^2"
          f" = {float(v):.8e} vs the while path's {float(v_while):.8e} "
          f"(rel {dv:.2e} <= 1e-5), d/d eps = {float(g):.6e}, hand kernel "
          f"launches {all_launches()} (all 0); first {GRAD_ROWS} rows in f64"
          f" (remat_levels=0): card {float(g_card):.12e} vs CPU "
          f"{float(g_cpu):.12e} "
          f"(|d| {d_cpu:.2e} <= 1e-10), vs the central difference "
          f"{fd:.12e} (rel {d_fd:.2e} <= 1e-6) ({card})", flush=True)
    return out


def vdp_loss(mu, y0, levels, dtype):
    """BASELINE config 2 differentiated: the mean of y_0(10)^2 over Van
    der Pol ensembles, 1000 fixed RK4 steps by the scan driver."""
    sol = ensemble_solve(VanDerPol(mu=mu).rhs, y0, 0.0, 10.0,
                         stepper=RungeKutta(RK4), adaptive=False,
                         h0=10.0 / VDP_STEPS, time_dtype=dtype,
                         method="scan", remat_levels=levels,
                         ctl=StepControl(max_steps=VDP_SCAN))
    return (sol.y_final[:, 0] ** 2).mean(), sol


def vdp_grad(y0, levels, dtype):
    mu = torch.tensor(1.5, dtype=dtype, device=y0.device, requires_grad=True)
    loss, sol = vdp_loss(mu, y0, levels, dtype)
    (g,) = torch.autograd.grad(loss, mu)
    return loss.detach(), g, sol


def grad_vdp_phase(card: str) -> dict:
    y_np = np.random.default_rng(0).uniform(-2, 2, (VDP_TRAJ, 2))
    y0 = torch.as_tensor(y_np, dtype=torch.float32, device="cuda")
    reset_counts()
    grads, peaks, walls_ms = {}, {}, {}
    for levels in (0, 1, 2):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        v, g, sol = vdp_grad(y0, levels, torch.float32)
        torch.cuda.synchronize()
        walls_ms[levels] = (time.perf_counter() - t0) * 1e3
        peaks[levels] = (torch.cuda.max_memory_allocated() - base) / 2**20
        grads[levels] = g
        assert bool((sol.status == DONE).all()), levels
        assert bool((sol.n_accept == VDP_STEPS).all()), levels
    check_no_hand_kernel("grad-vdp")
    assert torch.equal(grads[0], grads[1]) and torch.equal(grads[0],
                                                           grads[2]), grads
    assert peaks[2] < peaks[0], peaks
    rows = torch.as_tensor(y_np[:VDP_GRAD_ROWS], dtype=torch.float64,
                           device="cuda")
    _, g64, _ = vdp_grad(rows, 0, torch.float64)
    step = 1e-6
    with torch.no_grad():
        lp, _ = vdp_loss(torch.tensor(1.5 + step, dtype=torch.float64,
                                      device="cuda"), rows, 0, torch.float64)
        lm, _ = vdp_loss(torch.tensor(1.5 - step, dtype=torch.float64,
                                      device="cuda"), rows, 0, torch.float64)
    fd = float(lp - lm) / (2 * step)
    d_fd = abs(float(g64) / fd - 1)
    assert d_fd <= 1e-6, (float(g64), fd)
    print(f"[grad-vdp] {VDP_TRAJ} Van der Pol, mu=1.5, RK4 h=0.01 on [0, 10]"
          f" f32, method='scan' max_steps={VDP_SCAN}: all DONE with "
          f"n_accept == {VDP_STEPS}; d/d mu mean y_0(10)^2 = "
          f"{float(grads[0]):.8e}, bitwise equal at remat_levels 0/1/2 "
          f"(levels {[driver.scan_lengths(VDP_SCAN, k) for k in (0, 1, 2)]});"
          f" peak memory above the inputs "
          f"{[round(peaks[k], 1) for k in (0, 1, 2)]} MiB, value-and-grad "
          f"wall {[round(walls_ms[k], 1) for k in (0, 1, 2)]} ms (one run "
          f"each, host clock); hand kernel launches {all_launches()} (all "
          f"0); first {VDP_GRAD_ROWS} rows in f64: {float(g64):.12e} vs the "
          f"central difference {fd:.12e} (rel {d_fd:.2e} <= 1e-6) ({card})",
          flush=True)
    return peaks


def dense_flagship(model, y0, stepper, save_at, dense, ctl=DENSE_CTL):
    return ensemble_solve(lambda t, y: model.rhs_pair(t, y, torch.float32),
                          y0, 0.0, TF, stepper=stepper, h0=H0, ctl=ctl,
                          time_dtype=torch.float32, save_at=save_at,
                          dense=dense)


def dense_tiers_phase(card: str) -> None:
    """Dense output on the vmapped tier (DOPRI5 with FSAL and its
    continuous extension at 16 384 x 64c) and on the scalar tier
    (solve_ivp_dense, solve_linear_dense over Magnus-4, one trajectory,
    f64 card vs CPU)."""
    check_ieee_products()
    _, y0 = main_inputs()
    model = DrivenDense.make(d=DIM, seed=0)
    st = RungeKutta(DOPRI5, advance_lower=False)
    assert st.use_fsal
    reset_counts()
    sol = dense_flagship(model, y0, st, SAVE_AT, True)
    torch.cuda.synchronize()
    check_no_hand_kernel("dense-tiers")
    assert int((sol.status == DONE).sum()) == N_TRAJ, "not all DONE"
    bare = dense_flagship(model, y0, st, None, False)
    assert torch.equal(sol.n_accept, bare.n_accept)
    ys = torch.complex(sol.ys.re, sol.ys.im)
    assert ys.shape == (N_TRAJ, len(SAVE_AT) + 2, DIM), ys.shape
    norm_dev = float((ys.abs().pow(2).sum(-1).sqrt() - 1).abs().max())
    assert norm_dev <= 1e-4, norm_dev
    hit = dense_flagship(model, y0, st, SAVE_AT, False)
    dy = float(torch.maximum((sol.ys.re - hit.ys.re).abs(),
                             (sol.ys.im - hit.ys.im).abs()).max())
    assert dy <= 10 * DENSE_CTL.rtol, dy
    ms, walls, _, peak = walls_of(
        lambda: dense_flagship(model, y0, st, SAVE_AT, True))
    print(f"[dense-tiers] vmapped tier: {N_TRAJ}x{DIM}c ensemble_solve("
          f"rhs_pair, RungeKutta(DOPRI5, advance_lower=False) (FSAL, "
          f"p_dense), dense=True, {len(SAVE_AT)} saves, rtol="
          f"{DENSE_CTL.rtol:g}) f32: all DONE, n_accept per row == the run "
          f"without saves, max||psi|-1| over saves {norm_dev:.3e} (<= 1e-4),"
          f" vs the grid-hitting run max|dy| {dy:.3e} (<= 10 rtol), hand "
          f"kernel launches {all_launches()} (all 0); wall median {ms:.3f} "
          f"ms of {[round(w, 3) for w in walls]}, peak {peak:.1f} MiB "
          f"({card})", flush=True)

    psi = from_complex(np.asarray(model.H0[0]) / np.linalg.norm(
        model.H0[0]), torch.float64, device="cpu")
    ctl = StepControl(rtol=1e-10, min_dt=1e-8, max_dt=0.25)

    def ivp(dev):
        y = Cplx(psi.re.to(dev), psi.im.to(dev))
        return solve_ivp_dense(
            lambda t, p: model.rhs_pair(t, p, torch.float64), 0.0, TF, y,
            tableau=DOPRI5, ctl=ctl, h0=H0, save_at=SAVE_AT)

    def lin(dev):
        y = Cplx(psi.re.to(dev), psi.im.to(dev))
        return solve_linear_dense(
            lambda t: model.op_pair(t, torch.float64, device=dev), 0.0, TF,
            y, stepper=texp.Magnus4(texp.DenseCplxSplit()), adaptive=True,
            ctl=StepControl(rtol=1e-9, min_dt=1e-8, max_dt=0.25), h0=1e-2,
            save_at=SAVE_AT)

    for label, run in (("solve_ivp_dense DOPRI5", ivp),
                       ("solve_linear_dense Magnus-4", lin)):
        reset_counts()
        a = run("cuda")
        torch.cuda.synchronize()
        check_no_hand_kernel("dense-tiers scalar")
        b = run("cpu")
        assert int(a.status) == DONE, label
        same_counters(a, b, label)
        d = max(float((x.cpu() - y).abs().max()) for x, y in zip(
            (a.ys.re, a.ys.im, a.y_final.re, a.y_final.im),
            (b.ys.re, b.ys.im, b.y_final.re, b.y_final.im)))
        assert d <= 1e-12, (label, d)
        n2 = float((a.ys.re ** 2 + a.ys.im ** 2).sum(-1).sub(1).abs().max())
        print(f"[dense-tiers] scalar tier: {label} over DrivenDense(d={DIM})"
              f" f64, one trajectory, {len(SAVE_AT)} saves: DONE, "
              f"{int(a.n_accept)} accepted / {int(a.n_reject)} rejected, "
              f"card vs CPU equal counters, max|d| {d:.3e} (<= 1e-12), "
              f"max| ||psi||^2 - 1 | over saves {n2:.3e} ({card})",
              flush=True)


def fsal_phase(card: str) -> None:
    """FSAL on the flagship: DOPRI5 with the last stage carried against
    every stage evaluated, 16 384 x 64c f32 on the vmapped tier."""
    _, y0 = main_inputs()
    model = DrivenDense.make(d=DIM, seed=0)
    calls = {}

    def counted_rhs(key):
        def f(t, y):
            calls[key] += 1
            return model.rhs_pair(t, y, torch.float32)

        return f

    # the plain clock: the carried stage was evaluated at fl(t + 1.0 dt),
    # which the compensated clock's t_next may differ from by an ulp
    ctl = dataclasses.replace(CTL, time_compensated=False)
    sols = {}
    for fsal in (True, False):
        st = RungeKutta(DOPRI5, advance_lower=False, fsal=fsal)
        calls[fsal] = 0
        sols[fsal] = ensemble_solve(counted_rhs(fsal), y0, 0.0, TF,
                                    stepper=st, h0=H0, ctl=ctl,
                                    time_dtype=torch.float32)
        assert int((sols[fsal].status == DONE).sum()) == N_TRAJ, fsal
    a, b = sols[True], sols[False]
    same_counters(a, b, "fsal")
    dy = max_dy(a, b)
    assert dy <= 1e-5, dy
    n = int(a.n_iters.max())
    fs, pl = (RungeKutta(DOPRI5, advance_lower=False, fsal=x)
              for x in (True, False))
    assert (fs.nfev_per_step, fs.nfev_init) == (6, 1)
    assert (pl.nfev_per_step, pl.nfev_init) == (7, 0)
    # the vmapped tier evaluates every lane on every iteration
    assert calls[True] == 1 + 6 * n and calls[False] == 7 * n, (calls, n)
    attempts = int((a.n_accept + a.n_reject).sum())
    print(f"[fsal] {N_TRAJ}x{DIM}c DOPRI5 advancing b, fsal=True vs False, "
          f"rtol={CTL.rtol:g}, plain clock, f32: all DONE, equal status / "
          f"n_accept / "
          f"n_reject / n_iters (up to {n}), max|dy| {dy:.3e} (<= 1e-5); "
          f"RHS calls over the batch {calls[True]} (= 1 + 6 x {n}) against "
          f"{calls[False]} (= 7 x {n}); nfev summed over the rows {N_TRAJ} "
          f"+ 6 x {attempts} attempts = {N_TRAJ + 6 * attempts} against 7 x"
          f" {attempts} = {7 * attempts} ({card})", flush=True)


# -- the last single-device modules: the declared drive on K1 and K3, the
# compensated tier, traced norms, compact ensembles, checkpoints ------------

MAIN_ITERS = 33       # the RK main path's iterations with the cos(w t) drive
COMP_STEPS = 100      # fixed Magnus-4 steps of [compensated]
COMP_RK_STEPS = 500   # fixed RKF45 steps of [compensated]
COMP_B, COMP_REF = 4096, 256
VDP_B = 4096


def drive_forms() -> dict:
    """The declared drives of [drive-form] beside the model's cos(w t): a
    CoeffForm with every term nonzero, and a 16-coefficient ChebForm of
    the chirped drive cos(w t + 3 t^2) on [0, TF], fitted at 64
    Chebyshev nodes."""
    w = DrivenDense.make(d=DIM, seed=0).w
    u = np.cos(np.pi * (np.arange(64) + 0.5) / 64)
    tt = 0.5 * TF * (u + 1.0)
    series = np.polynomial.chebyshev.chebfit(u, np.cos(w * tt + 3 * tt ** 2),
                                             15)
    return {"coeff": CoeffForm(a=(0.3,), b=(0.1,), c=(0.8,), w=(w,)),
            "cheb": ChebForm(series[:, None], 0.0, TF)}


def check_drive_loop(form, B, dtype) -> tuple:
    """K2 with K3 on the declared drive against torch_fused_loop on the
    RK loop path's model, states and nine saves: f64 counters equal and
    states within 1e-10; f32 counters within 2 and states within 1e-4 (as
    [loop]). Returns (max |dx|, K2 launches)."""
    st, y0 = main_inputs(B)
    if dtype == torch.float64:
        y0 = Cplx(y0.re.double(), y0.im.double())
    step = RKStep(M0=st.M0.to(dtype), M1=st.M1.to(dtype), u_fn=form)
    grid = driver.make_grid(0.0, TF, SAVE_AT, dtype=dtype, device="cuda")
    carries = init_carries(grid, torch.cat([y0.re, y0.im], 1), H0)
    before = fused_loop_chunk.launches
    got = fused_loop_chunk(*carries[:4], carries[4].clone(), step, ctl=CTL)
    launches = fused_loop_chunk.launches - before
    want = torch_fused_loop(*carries, step, ctl=CTL)
    torch.cuda.synchronize()
    dcount = int((got[1][:, INT_COLS] - want[1][:, INT_COLS]).abs().max())
    dx = float((got[2] - want[2]).abs().max())
    ds = float((got[3] - want[3]).abs().max())
    f64 = dtype == torch.float64
    lim_c, lim_x = (0, 1e-10) if f64 else (2, 1e-4)
    n_done = int((got[1][:, 1] == DONE).sum())
    ok = dcount <= lim_c and max(dx, ds) <= lim_x and n_done == B
    print(f"[drive-form] K2 + K3 vs twin, {type(form).__name__} "
          f"{str(dtype)[6:]} B={B}, {len(SAVE_AT)} saves: DONE {n_done}/{B}, "
          f"max|dcount|={dcount} (<= {lim_c}), max|dx|={dx:.3e}, "
          f"max|dsaves|={ds:.3e} (<= {lim_x:.0e}), iterations up to "
          f"{int(got[1][:, 5].max())}; {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"K2 + K3 disagree with the twin on "
                             f"{type(form).__name__} {dtype}")
    return dx, launches


def counter_rows(a, b) -> int:
    """Rows whose n_accept, n_reject, n_iters or status differ."""
    return int(((a.n_accept != b.n_accept) | (a.n_reject != b.n_reject)
                | (a.n_iters != b.n_iters) | (a.status != b.status)).sum())


def drive_form_phase() -> dict:
    """[drive-form]: K1 and K3 on each declared drive against their twins
    (f32 at the main path's shape, f64 at 256), the main path at 16 384
    on K1 with each drive, the 2048 loop path on K2 + K3 against K1 per
    step, and a callable drive on the twin step (no kernel)."""
    forms = drive_forms()
    out = {"err": {}, "k1": {}, "loop_err": {}, "k2": {}}
    for name, form in forms.items():
        out["err"][name] = compare_step(N_TRAJ, DIM, torch.float32,
                                        u_fn=form, label=f" drive {name}")[0]
        compare_step(256, DIM, torch.float64, u_fn=form,
                     label=f" drive {name}")
        out["loop_err"][name], _ = check_drive_loop(form, LOOP_TRAJ,
                                                    torch.float32)
        check_drive_loop(form, 256, torch.float64)

    st, y0 = main_inputs()
    w = st.w
    base = solve(st, y0)
    for name, form in (("cos", fused_rk.cos_drive(w)), *forms.items()):
        stf = dataclasses.replace(st, u_fn=form)
        reset_counts()
        sol = solve(stf, y0)
        torch.cuda.synchronize()
        k1, k2, k4 = counts()
        n_it = int(sol.n_iters.max())
        assert sol.path == "torch-driver+cuda-step", sol.path
        assert int((sol.status == DONE).sum()) == N_TRAJ, name
        assert (k1, k2, k4) == (n_it, 0, 0), (name, k1, k2, k4, n_it)
        assert bool(torch.isfinite(sol.y_final.re).all()), name
        out["k1"][name] = k1
        extra = ""
        if name == "cos":
            same = (counter_rows(sol, base) == 0
                    and torch.equal(sol.y_final.re, base.y_final.re)
                    and torch.equal(sol.y_final.im, base.y_final.im))
            assert n_it == MAIN_ITERS and same, (n_it, same)
            extra = (f", bitwise the w= shorthand's solve, the main "
                     f"path's {MAIN_ITERS} iterations")
        print(f"[drive-form] main path {N_TRAJ}x{DIM}c RKF45 drive {name}: "
              f"all DONE, {k1} K1 launches == {n_it} iterations, n_accept "
              f"{int(sol.n_accept.min())}..{int(sol.n_accept.max())}{extra}",
              flush=True)
        # 2048 with nine saves: K1 per step against K2 + K3
        if name == "cos":
            continue
        sub = Cplx(y0.re[:LOOP_TRAJ].contiguous(),
                   y0.im[:LOOP_TRAJ].contiguous())
        reset_counts()
        loop = solve(stf, sub, SAVE_AT)
        k1l, k2l, _ = counts()
        step = per_step_solve(stf, sub)
        torch.cuda.synchronize()
        assert loop.path == "cuda-loop-persistent", loop.path
        assert (k1l, k2l) == (0, 1), (k1l, k2l)
        out["k2"][name] = k2l
        rows = counter_rows(loop, step)
        dy = float(torch.maximum((loop.ys.re - step.ys.re).abs(),
                                 (loop.ys.im - step.ys.im).abs()).max())
        assert rows == 0 and dy <= 1e-4, (name, rows, dy)
        print(f"[drive-form] {LOOP_TRAJ}x{DIM}c, {len(SAVE_AT)} saves, drive "
              f"{name}: K2 + K3 ({k2l} launch) vs K1 per step: counters "
              f"equal on every row ({rows} differ), max|dy| over saves "
              f"{dy:.3e} (<= 1e-4)", flush=True)

    # a callable drive: no kernel runs it, the twin step does, on the card
    stc = dataclasses.replace(st, u_fn=lambda t: torch.cos(w * t))
    reset_counts()
    sol = solve(stc, y0)
    torch.cuda.synchronize()
    assert all_launches() == (0,) * len(WRAPPERS), all_launches()
    assert sol.path == "torch-driver+twin-step", sol.path
    assert int((sol.status == DONE).sum()) == N_TRAJ
    dy = float(torch.maximum((sol.y_final.re - base.y_final.re).abs(),
                             (sol.y_final.im - base.y_final.im).abs()).max())
    dcount = int((sol.n_iters - base.n_iters).abs().max())
    assert dy <= 1e-4 and dcount <= 2, (dy, dcount)
    print(f"[drive-form] callable drive at {N_TRAJ}: path {sol.path}, every "
          f"kernel launch count 0, all DONE; vs the K1 main path max|dy|="
          f"{dy:.3e} (<= 1e-4), max|dn_iters|={dcount} (<= 2)", flush=True)
    return out


def drive_timing_phase(card: str) -> dict:
    """K1 with each declared drive against the cos drive, in turns (3
    rounds of 20 launches, CUDA-event medians), each beside its plain
    twin; K2 + K3 on the ChebForm at the 2048 loop path against its
    twin."""
    forms = {"cos": None, **drive_forms()}
    sk, t, dt, xw = step_inputs(N_TRAJ, DIM, torch.float32)
    mt, tab_c = fused_rk.kernel_operands(sk.M0, sk.M1, RKF45)
    drives = {n: fused_rk.kernel_drive(f or sk.u_fn, xw)
              for n, f in forms.items()}
    steppers = {n: dataclasses.replace(sk, u_fn=f or sk.u_fn)
                for n, f in forms.items()}

    def k1(n):
        return fused_rk.launch(t, dt, xw, mt, tab_c, drive=drives[n],
                               tab=RKF45, advance_lower=True)

    for n in forms:
        k1(n)
        plain_step(steppers[n], t, dt, xw)
    runs = {n: [] for n in forms}
    for _ in range(3):   # in turns
        for n in forms:
            runs[n].append(timed_ms(lambda: k1(n), reps=1, inner=20))
    flop, nbytes = k1_flop_bytes(N_TRAJ, 2 * DIM, RKF45.stages, 4)
    b_ms, b_by = bound(flop, nbytes)
    out = {}
    for n in forms:
        ms = statistics.median(runs[n])
        p_ms = timed_ms(lambda: plain_step(steppers[n], t, dt, xw), reps=3,
                        inner=5)
        out[n] = (ms, p_ms, b_ms, b_by)
        print(f"[time] K1 drive {n} at B={N_TRAJ}, d={DIM}, f32: "
              f"{ms:.4f} ms (runs {[round(v, 4) for v in runs[n]]}; "
              f"{ms / statistics.median(runs['cos']):.4f}x the cos drive's), "
              f"plain twin {p_ms:.4f} ms, bound {b_ms:.4f} ms by {b_by} "
              f"({b_ms / ms:.1%}) ({card})", flush=True)

    st, y0 = main_inputs(LOOP_TRAJ)
    grid = driver.make_grid(0.0, TF, SAVE_AT, dtype=torch.float32,
                            device="cuda")
    carries = init_carries(grid, torch.cat([y0.re, y0.im], 1), H0)
    k2_runs = {}
    outs = {}
    for n in ("cos", "cheb"):
        step = RKStep(M0=st.M0, M1=st.M1, u_fn=forms[n] or st.u_fn)
        outs[n] = (step, fused_loop_chunk(*carries, step, ctl=CTL))
        k2_runs[n] = []
    for _ in range(3):
        for n, (step, _) in outs.items():
            k2_runs[n].append(timed_ms(
                lambda: fused_loop_chunk(*carries, step, ctl=CTL), reps=1))
    step, got = outs["cheb"]
    p_ms = timed_ms(lambda: torch_fused_loop(*carries[:4], carries[4].clone(),
                                             step, ctl=CTL), reps=1)
    (kb_ms, kb_by), steps = k2_bound(got[1], LOOP_TRAJ, 2 * DIM,
                                     RKF45.stages, grid.shape[0], 4)
    k_ms = statistics.median(k2_runs["cheb"])
    print(f"[time] K2 + K3 drive cheb at the loop path ({LOOP_TRAJ}x{DIM}c, "
          f"{len(SAVE_AT)} saves, f32): {k_ms:.4f} ms (runs "
          f"{[round(v, 4) for v in k2_runs['cheb']]}), cos drive "
          f"{statistics.median(k2_runs['cos']):.4f} ms (runs "
          f"{[round(v, 4) for v in k2_runs['cos']]}), plain twin "
          f"{p_ms:.4f} ms; bound {kb_ms:.4f} ms by {kb_by} ({steps} steps, "
          f"{kb_ms / k_ms:.1%}); "
          f"{k2_plan_text(LOOP_TRAJ, 2 * DIM, RKF45.stages)} ({card})",
          flush=True)
    out["k2_cheb"] = (k_ms, p_ms, kb_ms, kb_by)
    return out


def count_syncs(fn):
    """(fn's result, host syncs it made): torch's sync debug mode warns at
    each synchronizing call."""
    import warnings

    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            res = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return res, sum("synchroniz" in str(r.message) for r in rec)


def quantized_op_fn(dtype):
    """DrivenDense's black box sampled in float32 at float32 times and
    cast to ``dtype``: the f64 reference solves the f32 solves' operator,
    so the comparison isolates the state's arithmetic."""
    model = DrivenDense.make(d=DIM, seed=0)

    def op_fn(t):
        a = model.op_pair(t.to(torch.float32), torch.float32)
        return type(a)(*(x.to(dtype) for x in a))

    return op_fn


def quantized_rhs(dtype):
    """The flagship's RHS (DrivenDense.rhs_pair) over float32 operators
    and a float32 cosine, cast to ``dtype`` (see quantized_op_fn)."""
    model = DrivenDense.make(d=DIM, seed=0)
    H0m, V = (from_complex(m, torch.float32, device="cuda")
              for m in (model.H0, model.V))
    W = torch.cat([embed(Cplx(H.im, -H.re)).T for H in (H0m, V)],
                  dim=-1).contiguous().to(dtype)

    def f(t, psi):
        c = torch.cos(model.w * t.to(torch.float32)).to(dtype)
        y = torch.cat([psi.re, psi.im], dim=-1) @ W
        cv = c * y[..., 2 * DIM:]
        return Cplx(y[..., :DIM] + cv[..., :DIM],
                    y[..., DIM:2 * DIM] + cv[..., DIM:])

    return f


def max_row_err(sol, ref, n: int) -> float:
    """The largest l2 distance of the first n rows' final states from the
    f64 reference's."""
    d2 = ((sol.y_final.re[:n].double() - ref.y_final.re) ** 2
          + (sol.y_final.im[:n].double() - ref.y_final.im) ** 2)
    return float(d2.sum(-1).sqrt().max())


def compensated_phase(card: str) -> dict:
    """[compensated]: Magnus-4 over DrivenDense's black box at 4096 x 64c
    (COMP_STEPS fixed steps, the generic steppers' batched tier: torch
    on the card, K9 not launched) and RKF45 on the flagship's vmapped
    tier at 16 384 x 64c (rtol 1e-8, and COMP_RK_STEPS fixed steps), each
    compensated against plain f32, both against an f64 solve of the first
    COMP_REF rows on the same f32-quantized operator. The fixed-step
    errors must fall by the factor tests/test_compensated.py asserts for
    the tier: 5."""
    y0 = unit_states(COMP_B, DIM, torch.float32, 42)
    ref0 = Cplx(y0.re[:COMP_REF].double(), y0.im[:COMP_REF].double())
    kw = dict(adaptive=False, h0=TF / COMP_STEPS, time_dtype=torch.float64,
              ctl=StepControl(max_steps=COMP_STEPS + 10, min_dt=1e-9))

    def magnus(y, dtype, comp):
        return ensemble_solve(quantized_op_fn(dtype), y, 0.0, TF,
                              stepper=texp.Magnus4(texp.DenseCplxSplit(),
                                                   compensated=comp), **kw)

    ref = magnus(ref0, torch.float64, False)
    reset_counts()
    plain = magnus(y0, torch.float32, False)
    k9_plain = fused_dense_chain_apply.launches
    reset_counts()
    comp, syncs = count_syncs(lambda: magnus(y0, torch.float32, True))
    torch.cuda.synchronize()
    assert all_launches() == (0,) * len(WRAPPERS), all_launches()
    assert comp.path == "torch-driver+comp-step", comp.path
    assert int((comp.status == DONE).sum()) == COMP_B
    e_p, e_c = (max_row_err(s, ref, COMP_REF) for s in (plain, comp))
    assert e_c < e_p / 5.0, (e_c, e_p)
    # one timed run each (the checks above warmed both)
    torch.cuda.reset_peak_memory_stats()
    _, m_ms = timed_call(lambda: magnus(y0, torch.float32, True))
    m_peak = torch.cuda.max_memory_allocated() / 2**20
    _, mp_ms = timed_call(lambda: magnus(y0, torch.float32, False))
    print(f"[compensated] Magnus-4 over DrivenDense's black box, {COMP_B}x"
          f"{DIM}c f32, {COMP_STEPS} fixed steps: plain (K9, {k9_plain} "
          f"launches) max error {e_p:.3e}, compensated (torch, every kernel "
          f"launch count 0, path {comp.path}) {e_c:.3e} (< plain / 5; "
          f"{e_p / e_c:.1f}x), against f64 on {COMP_REF} rows; walls "
          f"compensated {m_ms:.3f} ms (peak {m_peak:.1f} MiB), plain "
          f"{mp_ms:.3f} ms; {syncs / COMP_STEPS:.2f} host syncs an "
          f"iteration ({card})", flush=True)

    y0 = unit_states(N_TRAJ, DIM, torch.float32, 42)
    ref0 = Cplx(y0.re[:COMP_REF].double(), y0.im[:COMP_REF].double())
    out = {"magnus4": (m_ms, e_p, e_c)}
    for label, rkw in (
            ("rtol 1e-8", dict(adaptive=True, h0=H0, ctl=CTL)),
            (f"{COMP_RK_STEPS} fixed steps",
             dict(adaptive=False, h0=TF / COMP_RK_STEPS,
                  ctl=StepControl(max_steps=COMP_RK_STEPS + 10,
                                  min_dt=1e-9)))):
        def rk(y, dtype, comp):
            return ensemble_solve(quantized_rhs(dtype), y, 0.0, TF,
                                  stepper=RungeKutta(compensated=comp),
                                  time_dtype=torch.float64, **rkw)

        ref = rk(ref0, torch.float64, False)
        plain = rk(y0, torch.float32, False)
        reset_counts()
        comp, syncs = count_syncs(lambda: rk(y0, torch.float32, True))
        torch.cuda.synchronize()
        assert all_launches() == (0,) * len(WRAPPERS), all_launches()
        assert int((comp.status == DONE).sum()) == N_TRAJ
        e_p, e_c = (max_row_err(s, ref, COMP_REF) for s in (plain, comp))
        fixed = not rkw["adaptive"]
        assert e_c < (e_p / 5.0 if fixed else e_p), (label, e_c, e_p)
        n_it = int(comp.n_iters.max())
        walls = ""
        if not fixed:   # the fixed run's walls are its iterations' (~9 ms)
            r_ms, r_walls, _, r_peak = walls_of(lambda: rk(y0, torch.float32,
                                                           True))
            p_ms = walls_of(lambda: rk(y0, torch.float32, False))[0]
            walls = (f"; walls compensated {r_ms:.3f} ms of "
                     f"{[round(v, 3) for v in r_walls]} (peak {r_peak:.1f} "
                     f"MiB), plain {p_ms:.3f} ms")
            out[label] = (r_ms, e_p, e_c)
        print(f"[compensated] RKF45 on the flagship's vmapped tier, {N_TRAJ}"
              f"x{DIM}c f32, {label}: plain max error {e_p:.3e} ("
              f"{int(plain.n_iters.max())} iterations), compensated "
              f"{e_c:.3e} ({n_it} iterations; {e_p / e_c:.1f}x, < plain"
              f"{' / 5' if fixed else ''}), against f64 on {COMP_REF} rows; "
              f"every kernel launch count 0{walls}; "
              f"{syncs / max(n_it, 1):.2f} host syncs an iteration "
              f"({card})", flush=True)
    return out


def hand_l2(err):
    """A hand-written l2 over the Cplx pair: what WeightedNorm("l2")
    declares, written as plain torch."""
    return torch.sqrt(torch.sum(err.re ** 2) + torch.sum(err.im ** 2))


def traced_norm_phase(card: str) -> None:
    """[traced-norm]: an opaque error_norm= on the natively batched
    FusedModulatedLinearRK (main path) and MagnusModulated4 (16 384):
    promoted to lc.TracedNorm, run on the twin step on the card (no K1,
    K2 or K4 launch), against the same solve with the declared l2."""
    st, y0 = main_inputs()
    model = DrivenDense.make(d=DIM, seed=0)
    mod = model.modulated(torch.float32)
    for label, stepper, ctl, h0 in (
            ("RKF45", st, CTL, H0),
            ("Magnus-4", MagnusModulated4(mod), MAG_CTL, H0)):
        def run(norm):
            return ensemble_solve(None, y0, 0.0, TF, stepper=stepper,
                                  ctl=ctl, h0=h0, error_norm=norm,
                                  time_dtype=torch.float32)

        reset_counts()
        sol, wall = timed_call(lambda: run(hand_l2))
        torch.cuda.synchronize()
        assert all_launches() == (0,) * len(WRAPPERS), all_launches()
        assert sol.path == "torch-driver+twin-step", sol.path
        assert int((sol.status == DONE).sum()) == N_TRAJ
        # the declared l2 on the same twin step (a TracedNorm of the
        # declaration, whose per-trajectory sum is the hand-written one's)
        twin = ensemble_solve(None, y0, 0.0, TF, stepper=dataclasses.replace(
            stepper, norm=lc.TracedNorm(lc.WeightedNorm("l2"))), ctl=ctl,
            h0=h0, time_dtype=torch.float32)
        rows_twin = counter_rows(sol, twin)
        same = (rows_twin == 0 and torch.equal(sol.y_final.re,
                                               twin.y_final.re))
        assert same, (label, rows_twin)
        ref = run(lc.WeightedNorm("l2"))
        rows = counter_rows(sol, ref)
        dy = float(torch.maximum((sol.y_final.re - ref.y_final.re).abs(),
                                 (sol.y_final.im - ref.y_final.im).abs())
                   .max())
        dcount = int((sol.n_iters - ref.n_iters).abs().max())
        assert dcount <= 2 and dy <= 1e-4, (label, dcount, dy)
        print(f"[traced-norm] {label} {N_TRAJ}x{DIM}c f32 with a hand-written"
              f" l2: path {sol.path}, every kernel launch count 0, all DONE,"
              f" {int(sol.n_iters.max())} iterations, wall {wall:.1f} ms; "
              f"per-trajectory counters and y_final bitwise the declared l2 "
              f"on the same twin step; vs the declared l2 on the kernel path "
              f"({ref.path}): counters differ on {rows}/{N_TRAJ} rows "
              f"(kernel against twin rounding), max|dn_iters|={dcount} "
              f"(<= 2), max|dy|={dy:.3e} (<= 1e-4) ({card})", flush=True)


def timed_call(fn):
    """(fn's result, its CUDA-event wall in ms)."""
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    res = fn()
    b.record()
    torch.cuda.synchronize()
    return res, a.elapsed_time(b)


def compact_phase(card: str) -> dict:
    """[compact]: ensemble_solve_compact of the main path at 16 384
    (chunks of 8, K1 once an iteration on the compacted batch) against
    ensemble_solve; 4096 Van der Pol with amplitudes over 0.1-4 on the
    vmapped tier, compact's efficiency against step_efficiency of the
    plain solve."""
    st, y0 = main_inputs()
    base = solve(st, y0)
    calls = [0]
    orig = driver.step_once

    def counting(*a, **k):
        calls[0] += 1
        return orig(*a, **k)

    def compact():
        return ensemble_solve_compact(None, y0, 0.0, TF, stepper=st, ctl=CTL,
                                      h0=H0, time_dtype=torch.float32,
                                      chunk_iters=8)

    reset_counts()
    driver.step_once = counting
    try:
        sol, stats = compact()
    finally:
        driver.step_once = orig
    torch.cuda.synchronize()
    k1, k2, k4 = counts()
    assert (k1, k2, k4) == (calls[0], 0, 0), (k1, k2, k4, calls[0])
    rows = counter_rows(sol, base)
    same = (torch.equal(sol.y_final.re, base.y_final.re)
            and torch.equal(sol.y_final.im, base.y_final.im)
            and torch.equal(sol.t_final, base.t_final)
            and torch.equal(sol.h_final, base.h_final))
    assert rows == 0 and same, (rows, same)
    eff_plain = float(step_efficiency(base))
    c_ms, c_walls, _, _ = walls_of(lambda: compact()[0])
    p_ms = walls_of(lambda: solve(st, y0))[0]
    print(f"[compact] main path {N_TRAJ}x{DIM}c, chunks of 8: {k1} K1 "
          f"launches == {calls[0]} chunk iterations (loop kernel {k2}), "
          f"counters equal on every row and y_final, t_final, h_final "
          f"bitwise ensemble_solve's; efficiency {stats['efficiency']:.4f} "
          f"(executed {stats['executed_lane_iters']}, useful "
          f"{stats['useful_lane_iters']}) against step_efficiency "
          f"{eff_plain:.4f}; wall median {c_ms:.3f} ms of "
          f"{[round(v, 3) for v in c_walls]} against ensemble_solve's "
          f"{p_ms:.3f} ({card})", flush=True)

    rng = np.random.default_rng(0)
    amp = np.linspace(0.1, 4.0, VDP_B)
    ang = rng.uniform(0, 2 * np.pi, VDP_B)
    v0 = torch.as_tensor(np.stack([amp * np.cos(ang), amp * np.sin(ang)], 1),
                         dtype=torch.float32, device="cuda")
    vkw = dict(h0=1e-2, ctl=StepControl(rtol=1e-6, atol=1e-8, max_dt=0.5),
               time_dtype=torch.float32)
    rhs = VanDerPol(mu=1.5).rhs
    plain = ensemble_solve(rhs, v0, 0.0, 10.0, **vkw)
    vsol, vstats = ensemble_solve_compact(rhs, v0, 0.0, 10.0, chunk_iters=8,
                                          **vkw)
    torch.cuda.synchronize()
    eff_p = float(step_efficiency(plain))
    assert int((vsol.status == DONE).sum()) == VDP_B
    assert vstats["efficiency"] > eff_p, (vstats["efficiency"], eff_p)
    rows = counter_rows(vsol, plain)
    print(f"[compact] Van der Pol {VDP_B} x 2 (mu = 1.5, amplitudes 0.1-4), "
          f"vmapped RKF45: compact efficiency {vstats['efficiency']:.4f} > "
          f"step_efficiency of ensemble_solve {eff_p:.4f}; iterations "
          f"{int(plain.n_iters.min())}..{int(plain.n_iters.max())}; counters"
          f" differ from ensemble_solve's on {rows}/{VDP_B} rows ({card})",
          flush=True)
    return {"k1": k1, "wall": c_ms}


def checkpoint_phase() -> None:
    """[checkpoint]: the main path at 16 384, its carry saved after 10
    iterations (utils.save_state), loaded (load_state) and resumed
    (driver.resume): bitwise the uninterrupted solve."""
    import tempfile

    st, y0 = main_inputs()
    base = solve(st, y0)
    grid = driver.make_grid(0.0, TF, dtype=torch.float32, device="cuda")
    step_fn = st.make_step_fn()
    state = driver.init_state(y0, grid, H0, batch_shape=(N_TRAJ,))
    for _ in range(10):
        state = driver.step_once(state, step_fn, adaptive=True, ctl=CTL,
                                 error_norm=st.error_norm, batched=True)
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/main.iter10"
        save_state(path, state)
        loaded = load_state(path, like=state)
    sol = driver.resume(loaded, step_fn, ctl=CTL, error_norm=st.error_norm,
                        batched=True)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in (
        (sol.y_final.re, base.y_final.re), (sol.y_final.im, base.y_final.im),
        (sol.t_final, base.t_final), (sol.h_final, base.h_final),
        (sol.n_accept, base.n_accept), (sol.n_reject, base.n_reject),
        (sol.n_iters, base.n_iters), (sol.status, base.status)))
    assert same, "the resumed solve differs from the uninterrupted one"
    print(f"[checkpoint] main path {N_TRAJ}x{DIM}c: carry saved after 10 "
          f"iterations, loaded and resumed: y_final, t_final, h_final and "
          f"every counter bitwise the uninterrupted solve's "
          f"({int(base.n_iters.max())} iterations)", flush=True)


# the last modules: sharded ensembles and state sharding over a DeviceMesh
# of world = min(cards, 4) ranks, each on its own card (NCCL), launched by
# torch.multiprocessing.spawn; the ranks re-import this script and write
# their numbers to RANK_OUT in a temporary directory
MESH_TIMEOUT = 600.0         # seconds from the spawn to the last rank's exit
STATE_D = 16384              # [state-sharded]: f64, 2 GiB of operator
STATE_CTL = StepControl(rtol=1e-8)
S2D_B, S2D_D, S2D_W = 256, 4096, 1.3   # [state-2d]: f32, A0 + cos(w t) A1
S2D_CTL = StepControl(rtol=1e-5, min_dt=1e-6, max_dt=0.25)
RANK_OUT = "rank{}.json"


def mesh_world() -> int:
    return min(torch.cuda.device_count(), 4)


def local_rows_of(y, rank: int, world: int):
    """A Cplx batch's contiguous rows of ``rank``."""
    b = y.re.shape[0] // world
    return Cplx(y.re[rank * b:(rank + 1) * b], y.im[rank * b:(rank + 1) * b])


def shard_check(sol, ref, label: str) -> dict:
    """A sharded Solution's rows on this rank against the one-card solve of
    the same rows: counters equal, states within 1e-6 (bitwise expected),
    every row DONE; returns the numbers the parent prints."""
    loc = {k: getattr(sol, k).to_local() for k in
           ("status", "n_accept", "n_reject", "n_iters", "t_final",
            "h_final")}
    yre, yim = sol.y_final.re.to_local(), sol.y_final.im.to_local()
    assert int((loc["status"] == DONE).sum()) == loc["status"].shape[0], (
        f"{label}: rows not DONE")
    for k in ("status", "n_accept", "n_reject", "n_iters"):
        assert torch.equal(loc[k], getattr(ref, k)), f"{label}: {k} differs"
    dy = float(torch.maximum((yre - ref.y_final.re).abs(),
                             (yim - ref.y_final.im).abs()).max())
    assert dy <= 1e-6, (label, dy)
    bitwise = (dy == 0.0 and torch.equal(loc["h_final"], ref.h_final)
               and torch.equal(loc["t_final"], ref.t_final))
    return {"dy": dy, "bitwise": bitwise, "rows": int(yre.shape[0]),
            "n_iters": int(loc["n_iters"].max()), "path": sol.path}


def host_wall(fn):
    """(fn's result, its wall in ms from a synchronised start to a
    synchronised end, on the host's clock)."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return res, (time.perf_counter() - t) * 1e3


def mesh_ensemble_phases(rank: int, world: int) -> dict:
    """[mesh-main], [mesh-loop], [mesh-generic] on this rank: the main path
    (16 384 x 64c RKF45, K1 per step), 2048 rows a rank with nine saves
    (K2 + K3, one launch) and the 4096 x 64c generic Magnus-4 path (K9 per
    step), each through ensemble_solve(..., shard_batch(y0, mesh),
    mesh=mesh) against the unsharded ensemble_solve of the rank's rows."""
    from vec_ode_tpu_torch.parallel import ensemble_mesh, shard_batch

    mesh = ensemble_mesh(world, device="cuda")
    out = {}
    st, y0 = main_inputs()

    def sharded_main():
        return ensemble_solve(None, shard_batch(y0, mesh), 0.0, TF,
                              stepper=st, ctl=CTL, h0=H0,
                              time_dtype=torch.float32, mesh=mesh)

    sharded_main()                                   # warm
    reset_counts()
    sol, wall = host_wall(sharded_main)
    launches = all_launches()
    rec = shard_check(sol, solve(st, local_rows_of(y0, rank, world)),
                      "mesh-main")
    assert launches[0] == rec["n_iters"] and launches[1:3] == (0, 0), (
        launches, rec)
    out["main"] = dict(rec, wall=wall, k1=launches[0])

    st, y0 = main_inputs(LOOP_TRAJ * world)
    reset_counts()
    sol, wall = host_wall(lambda: ensemble_solve(
        None, shard_batch(y0, mesh), 0.0, TF, stepper=st, ctl=CTL, h0=H0,
        save_at=SAVE_AT, time_dtype=torch.float32, mesh=mesh))
    launches = all_launches()
    assert launches[:3] == (0, 1, 0), launches
    assert sol.path == "cuda-loop-persistent", sol.path
    ref = solve(st, local_rows_of(y0, rank, world), SAVE_AT)
    rec = shard_check(sol, ref, "mesh-loop")
    saves_equal = (torch.equal(sol.ys.re.to_local(), ref.ys.re)
                   and torch.equal(sol.ys.im.to_local(), ref.ys.im))
    out["loop"] = dict(rec, wall=wall, k2=launches[1], saves=saves_equal)

    _, y0 = main_inputs(GEN_TRAJ)
    reset_counts()
    sol, wall = host_wall(lambda: ensemble_solve(
        generic_op_fn(), shard_batch(y0, mesh), 0.0, TF,
        stepper=texp.Magnus4(texp.DenseCplxSplit()), adaptive=True,
        ctl=GEN_CTL, h0=GEN_H0, time_dtype=torch.float32, mesh=mesh))
    k9 = fused_dense_chain_apply.launches
    rec = shard_check(sol, generic_solve(local_rows_of(y0, rank, world)),
                      "mesh-generic")
    assert k9 == rec["n_iters"] and counts() == (0, 0, 0), (k9, counts())
    out["generic"] = dict(rec, wall=wall, k9=k9)

    # no host staging: a CPU batch on the CUDA mesh is refused
    try:
        ensemble_solve(None, Cplx(y0.re.cpu(), y0.im.cpu()), 0.0, TF,
                       stepper=st, mesh=mesh)
        refused = False
    except ValueError:
        refused = True
    assert refused, "a CPU batch ran on the CUDA mesh"
    return out


def antisymmetric_rows(D: int, rows: slice, seed: int, dtype):
    """Rows of (G - G^T) / sqrt(2 D) for a seeded Gaussian G made on the
    card (the same on every card): a real antisymmetric operator of norm
    ~2, so exp(A t) keeps ||y||. Returns (its rows, G)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    G = torch.randn(D, D, generator=g, device="cuda", dtype=dtype)
    return (G[rows] - G[:, rows].T) / math.sqrt(2 * D), G


def counted_gathers(fn):
    """(fn's result, the state-sharded all-gathers it made: its RHS
    evaluations)."""
    from vec_ode_tpu_torch.parallel import state_parallel

    n, orig = [0], state_parallel._all_gather

    def counting(*a, **k):
        n[0] += 1
        return orig(*a, **k)

    state_parallel._all_gather = counting
    try:
        return fn(), n[0]
    finally:
        state_parallel._all_gather = orig


def state_sharded_phase(rank: int, world: int) -> dict:
    """[state-sharded]: dx/dt = A x, A real antisymmetric, D = 16 384 in
    f64 (2 GiB) row-sharded over the world (each card D/world rows, given
    as a DTensor), RKF45 at rtol 1e-8 on [0, 1], against the unsharded
    solve_ivp of the same A on one card (rank 0)."""
    from torch.distributed.tensor import DTensor, Shard

    from vec_ode_tpu_torch.parallel import (ensemble_mesh,
                                            solve_linear_state_sharded)

    mesh = ensemble_mesh(world, axis="state", device="cuda")
    dl = STATE_D // world
    A_loc, G = antisymmetric_rows(STATE_D, slice(rank * dl, (rank + 1) * dl),
                                  0, torch.float64)
    A_full = (G - G.T) / math.sqrt(2 * STATE_D) if rank == 0 else None
    del G
    A = DTensor.from_local(A_loc, mesh, [Shard(0)], run_check=False,
                           shape=(STATE_D, STATE_D), stride=(STATE_D, 1))
    g = torch.Generator(device="cuda").manual_seed(1)
    y0 = torch.randn(STATE_D, generator=g, device="cuda",
                     dtype=torch.float64)
    y0 /= torch.linalg.vector_norm(y0)

    def run():
        return solve_linear_state_sharded(A, y0, 0.0, 1.0, mesh=mesh,
                                          ctl=STATE_CTL, h0=1e-2)

    run()                                            # warm
    (sol, wall), evals = counted_gathers(lambda: host_wall(run))
    y = sol.y_final.full_tensor()
    out = {"wall": wall, "evals": evals, "n_accept": int(sol.n_accept),
           "n_reject": int(sol.n_reject), "status": int(sol.status)}
    # the bytes a card streams an evaluation: its rows of A, the gathered
    # state in and its block out
    out["bytes"] = 8 * (dl * STATE_D + STATE_D + dl)
    prod_ms = timed_ms(lambda: torch.matmul(y0, A_loc.mT), inner=20)
    out["prod_ms"] = prod_ms
    if rank == 0:
        ref = solve_ivp(lambda t, x: A_full @ x, 0.0, 1.0, y0, ctl=STATE_CTL,
                        h0=1e-2)
        rel = float(torch.linalg.vector_norm(y - ref.y_final)
                    / torch.linalg.vector_norm(ref.y_final))
        drift = abs(float(torch.linalg.vector_norm(y)) - 1.0)
        assert out["status"] == DONE == int(ref.status), (out, ref.status)
        assert (out["n_accept"], out["n_reject"]) == (
            int(ref.n_accept), int(ref.n_reject)), (out, ref.n_accept)
        assert rel <= 1e-10 and drift <= 1e-7, (rel, drift)
        out.update(rel=rel, drift=drift, ref_accept=int(ref.n_accept))
    return out


def state_2d_phase(rank: int, world: int) -> dict:
    """[state-2d]: 256 trajectories of dx/dt = (A0 + cos(w t) A1) x, D =
    4096 in f32, A0 and A1 real antisymmetric, through
    ensemble_solve_state_sharded with local_rows of the global assembly on
    a (world / 2, 2) mesh ((1, 1) on one card), against the unsharded
    batched solve (the host driver over the per-trajectory operators) on
    rank 0."""
    from vec_ode_tpu_torch.parallel import (ensemble_solve_state_sharded,
                                            local_rows, mesh_2d)

    n_state = 2 if world >= 2 else 1
    mesh = mesh_2d(world // n_state, n_state, device="cuda")
    all_rows = slice(0, S2D_D)
    A0 = antisymmetric_rows(S2D_D, all_rows, 2, torch.float32)[0]
    A1 = antisymmetric_rows(S2D_D, all_rows, 3, torch.float32)[0]
    torch.cuda.empty_cache()

    def assemble(t):
        return A0 + torch.cos(S2D_W * t) * A1

    g = torch.Generator(device="cuda").manual_seed(4)
    y0 = torch.randn(S2D_B, S2D_D, generator=g, device="cuda")
    y0 /= torch.linalg.vector_norm(y0, dim=-1, keepdim=True)
    out = {}
    if mesh.get_coordinate() is not None:
        (sol, wall), evals = counted_gathers(lambda: host_wall(
            lambda: ensemble_solve_state_sharded(
                local_rows(assemble, mesh), y0, 0.0, 1.0, mesh=mesh,
                ctl=S2D_CTL, h0=1e-2)))
        got = {k: getattr(sol, k).full_tensor() for k in
               ("y_final", "status", "n_accept", "n_reject")}
        out.update(wall=wall, evals=evals, mesh=list(mesh.shape),
                   n_iters=int(sol.n_iters.full_tensor().max()))
    if rank == 0:
        def rhs(t, x):
            if t.ndim == 0:
                return torch.matmul(x, assemble(t).mT)
            return torch.matmul(torch.func.vmap(assemble)(t),
                                x.unsqueeze(-1)).squeeze(-1)

        grid = driver.make_grid(0.0, 1.0, dtype=torch.float64, device="cuda")
        ref = driver.integrate(RungeKutta().make_step_fn(rhs), y0, grid,
                               1e-2, ctl=S2D_CTL,
                               error_norm=lc.norm_l2_batched,
                               batch_shape=(S2D_B,))
        dcount = max(int((got[k] - getattr(ref, k)).abs().max())
                     for k in ("n_accept", "n_reject"))
        rows = int(((got["n_accept"] != ref.n_accept)
                    | (got["n_reject"] != ref.n_reject)).sum())
        dy = float((got["y_final"] - ref.y_final).abs().max())
        n_done = int((got["status"] == DONE).sum())
        assert n_done == S2D_B and int((ref.status == DONE).sum()) == S2D_B
        assert dy <= 1e-4 and dcount <= 2, (dy, dcount)
        out.update(dy=dy, dcount=dcount, rows=rows)
    return out


def mesh_rank(rank: int, world: int, tmp: str) -> None:
    """One rank of the mesh phases (the target of torch.multiprocessing
    .spawn): card ``rank``, NCCL over a FileStore in ``tmp``; writes its
    numbers to tmp/rank{rank}.json. Any failure raises, which fails the
    spawn and the script."""
    import torch.distributed as dist

    torch.cuda.set_device(rank)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                            rank=rank, world_size=world)
    try:
        out = mesh_ensemble_phases(rank, world)
        out["state"] = state_sharded_phase(rank, world)
        out["state2d"] = state_2d_phase(rank, world)
    finally:
        dist.destroy_process_group()
    with open(f"{tmp}/{RANK_OUT.format(rank)}", "w") as f:
        json.dump(out, f)


def spawn_world(world: int, tmp: str) -> None:
    """Run mesh_rank on ``world`` ranks; a rank that fails, or a world that
    outlives MESH_TIMEOUT, fails the script (every rank is stopped)."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(mesh_rank, args=(world, tmp), nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + MESH_TIMEOUT
    try:
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                raise RuntimeError(f"the mesh world outlived {MESH_TIMEOUT} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()


def mesh_phase(card: str) -> dict:
    """The sharded phases: spawn the world (kernels already built: the
    ranks load the cached libraries), then print each rank's numbers.
    Returns the rows' launches and errors, rank 0's."""
    import tempfile

    world = mesh_world()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        t = time.perf_counter()
        spawn_world(world, tmp)
        spawn_s = time.perf_counter() - t
        ranks = []
        for r in range(world):
            with open(f"{tmp}/{RANK_OUT.format(r)}") as f:
                ranks.append(json.load(f))
    print(f"[mesh] world of {world} rank(s), NCCL, one card a rank, "
          f"torch.multiprocessing.spawn over a FileStore: {spawn_s:.1f} s "
          f"from spawn to the last exit ({card})", flush=True)
    for key, label, kernel in (("main", "mesh-main", "k1"),
                               ("loop", "mesh-loop", "k2"),
                               ("generic", "mesh-generic", "k9")):
        for r, o in enumerate(ranks):
            rec = o[key]
            extra = (f", saves bitwise: {rec['saves']}" if key == "loop"
                     else "")
            print(f"[{label}] world {world}, rank {r}: {rec['rows']} rows, "
                  f"path {rec['path']}, {kernel.upper()} launches "
                  f"{rec[kernel]} (max n_iters {rec['n_iters']}), all DONE, "
                  f"counters equal to the one-card ensemble_solve of the "
                  f"same rows, max|dy| {rec['dy']:.3e} (<= 1e-6; bitwise: "
                  f"{rec['bitwise']}){extra}; sharded wall "
                  f"{rec['wall']:.3f} ms ({card})", flush=True)
    s = ranks[0]["state"]
    bw = s["evals"] * s["bytes"] / (s["wall"] / 1e3)
    prod_bw = s["bytes"] / (s["prod_ms"] / 1e3)
    print(f"[state-sharded] world {world}: D = {STATE_D} f64, A row-sharded "
          f"({STATE_D // world} rows a card), RKF45 rtol {STATE_CTL.rtol:g} "
          f"on [0, 1]: status {s['status']}, n_accept {s['n_accept']} "
          f"n_reject {s['n_reject']} equal to the unsharded solve_ivp's; "
          f"|y - y_ref| / |y_ref| = {s['rel']:.3e} (<= 1e-10), ||y|| - 1 = "
          f"{s['drift']:.3e} (<= 1e-7); wall {s['wall']:.3f} ms, "
          f"{s['evals']} RHS evaluations, {s['bytes']} B a card streams an "
          f"evaluation: {bw / 1e12:.3f} TB/s over the wall, the local "
          f"product alone {s['prod_ms']:.4f} ms = {prod_bw / 1e12:.3f} TB/s, "
          f"against the card's {HBM_BYTE_S / 1e12:.2f} TB/s ({card})",
          flush=True)
    s2 = ranks[0]["state2d"]
    print(f"[state-2d] world {world}, mesh {s2['mesh']}: B = {S2D_B} x D = "
          f"{S2D_D} f32, A0 + cos({S2D_W} t) A1 through local_rows, RKF45 "
          f"rtol {S2D_CTL.rtol:g} on [0, 1]: all DONE, {s2['n_iters']} "
          f"iterations at most, {s2['evals']} RHS evaluations on rank 0; "
          f"against the unsharded batched solve max|dy| {s2['dy']:.3e} "
          f"(<= 1e-4), counters differ on {s2['rows']} of {S2D_B} rows by "
          f"at most {s2['dcount']} (<= 2); wall {s2['wall']:.3f} ms "
          f"({card})", flush=True)
    return {"k1": ranks[0]["main"]["k1"], "k1_err": ranks[0]["main"]["dy"],
            "k2": ranks[0]["loop"]["k2"], "k2_err": ranks[0]["loop"]["dy"],
            "k9": ranks[0]["generic"]["k9"],
            "k9_err": ranks[0]["generic"]["dy"]}


EXAMPLES_TIMEOUT = 420.0     # seconds; impact_events, the longest, ~140
EXAMPLES = ("ensemble_sweep", "blackbox_fast_path", "hamiltonian_learning",
            "impact_events", "lindblad_open_system", "pulse_control",
            "threshold_events_kernel")


def examples_phase(card: str) -> None:
    """[examples]: each of the seven examples (``python -m
    vec_ode_tpu_torch.examples.<name> --device cuda``, its main() with its
    own check) and ``ensemble_sweep --mesh`` under torchrun on the world's
    cards, as processes of their own run together (the examples are
    host-bound: one card serves them all). Any that fails or outlives
    EXAMPLES_TIMEOUT fails the script."""
    import os
    import sys
    import tempfile

    root = os.path.dirname(os.path.abspath(__file__))
    mod = "vec_ode_tpu_torch.examples."
    cmds = {name: [sys.executable, "-m", mod + name, "--device", "cuda"]
            for name in EXAMPLES}
    cmds["ensemble_sweep --mesh"] = [
        sys.executable, "-m", "torch.distributed.run", "--standalone",
        f"--nproc-per-node={mesh_world()}", "-m", mod + "ensemble_sweep",
        "--mesh"]
    env = dict(os.environ, PYTHONPATH=root)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        procs, walls = {}, {}
        t0 = time.perf_counter()
        for i, (name, cmd) in enumerate(cmds.items()):
            with open(f"{tmp}/{i}.log", "w") as log:
                procs[name] = (subprocess.Popen(
                    cmd, cwd=root, env=env, stdout=log,
                    stderr=subprocess.STDOUT), f"{tmp}/{i}.log")
        try:
            while len(walls) < len(procs):
                if time.perf_counter() - t0 > EXAMPLES_TIMEOUT:
                    raise RuntimeError(
                        f"examples still running after {EXAMPLES_TIMEOUT} s:"
                        f" {sorted(set(procs) - set(walls))}")
                for name, (p, _) in procs.items():
                    if name not in walls and p.poll() is not None:
                        walls[name] = time.perf_counter() - t0
                time.sleep(0.2)
        finally:
            for p, _ in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.wait()
        failed = []
        for name, (p, path) in procs.items():
            with open(path) as f:
                lines = f.read().splitlines()
            last = lines[-1] if lines else ""
            print(f"[examples] {name}: exit {p.returncode} after "
                  f"{walls[name]:.2f} s (from the common start), last line "
                  f"{last!r} ({card})", flush=True)
            if p.returncode != 0:
                failed.append(name)
                print("\n".join(lines[-40:]), flush=True)
    assert not failed, f"examples failed: {failed}"


def main() -> None:
    t_start = time.perf_counter()
    card = device_phase()
    build_phase(card)
    k1_err = step_phase()
    norm_phase()
    k2_err = loop_kernel_phase()
    rk_body_phase()
    k4_err = chain_step_phase()
    cluster_err = cluster_phase()
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
    k4_launches, _ = r_step_path_phase("magnus4", loop_sol)
    r_launches = {}
    for kind in R_KINDS:
        k5r_launches, r_sol = r_loop_path_phase(kind)
        r_launches[kind] = (*r_step_path_phase(kind, r_sol), k5r_launches)
    lz_path_phase()
    k9_launches = generic_path_phase()
    adj_errs = adjoint_kernel_phase()
    k7_launches, k8_launches = adjoint_path_phase()
    trained = adjoint_training_phase()
    k6_launches, adaptive_ts = adjoint_adaptive_phase()
    many = {10: adjoint_many_phase(4, (ADJ_B,)),
            36: adjoint_many_phase(8, (ADJ_B, ADJ_BIG))}
    basis_k6, basis_vg = basis_grad_phase()
    dense_vg = adjoint_dense_phase()
    pulse_vmap_phase()
    fit_loop_phase(trained)
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
    generic_rk_phase(card)
    vdp_rk4_phase(card)
    solve_ivp_phase(card)
    k1_scan_launches = scan_k1_phase(card)
    grad_flagship_phase(card)
    grad_vdp_phase(card)
    dense_tiers_phase(card)
    fsal_phase(card)
    drive = drive_form_phase()
    compensated_phase(card)
    traced_norm_phase(card)
    compact = compact_phase(card)
    checkpoint_phase()
    mesh = mesh_phase(card)
    examples_phase(card)
    k1 = timing_phase(card)
    drive_t = drive_timing_phase(card)
    k2 = loop_timing_phase(card)
    k4 = k4_timing_phase(card)
    k5 = k5_timing_phase(card)
    r_times = {kind: r_timing_phase(kind, card) for kind in R_KINDS}
    k9 = k9_timing_phase(card)
    adj = adjoint_timing_phase(card, adaptive_ts)
    many_t = many_timing_phase(card)
    for Kp in (10, 36):
        wall_phase(f"adjoint-k{Kp} value-and-grad {ADJ_B}x{DIM}c f32, "
                   f"{ADJ_STEPS} Magnus-4 steps (1 K7 + 1 K8 launch)",
                   many[Kp]["vg"], card)
    wall_phase(f"basis-grad value-and-grad {ADJ_B}x{DIM}c f32, four basis "
               f"terms, {BASIS_STEPS} Magnus-4 steps (1 K7 + {basis_k6} K6 "
               f"launches)", basis_vg, card)
    wall_phase(f"adjoint-dense value-and-grad {ADJ_B}x{DIM}c f64, "
               f"{BASIS_STEPS} Magnus-4 steps (no hand kernel)", dense_vg,
               card)
    extra = extra_timing_phase(card)
    k0_times = k0_timing_phase(card)
    print(f"[done] {time.perf_counter() - t_start:.1f} s", flush=True)
    print(card, flush=True)
    rows = []
    for name, launches, err, (ms, plain_ms, b_ms, b_by, *lib) in (
            ("fused_rk_step", k1_launches, k1_err, k1),
            ("fused_rk_step/scan", k1_scan_launches, k1_err, k1),
            *((f"fused_rk_step/{n}", drive["k1"][n], drive["err"][n],
               drive_t[n]) for n in ("coeff", "cheb")),
            ("fused_rk_step/compact", compact["k1"], k1_err, k1),
            ("fused_rk_step/mesh", mesh["k1"], mesh["k1_err"], k1),
            ("rk_step_tile/cheb", drive["k2"]["cheb"],
             drive["loop_err"]["cheb"], drive_t["k2_cheb"]),
            ("fused_loop", k2_launches, k2_err, k2),
            ("fused_loop/mesh", mesh["k2"], mesh["k2_err"], k2),
            ("rk_step_tile", k2_launches, k2_err, k2),
            ("fused_chain_apply", k4_launches, k4_err, k4),
            ("chain_step_tile", k5_launches, k5_err, k5),
            *((f"fused_chain_apply/{kind}", r_launches[kind][0],
               k4r_err[kind], r_times[kind][0]) for kind in R_KINDS),
            *((f"chain_step_tile/{kind}", r_launches[kind][2],
               k5r_err[kind], r_times[kind][1]) for kind in R_KINDS),
            ("fused_chain_apply/cluster", r_launches["magnus6"][1],
             cluster_err, r_times["magnus6"][2]),
            ("fused_dense_chain_apply", k9_launches, k9_err, k9),
            ("fused_dense_chain_apply/mesh", mesh["k9"], mesh["k9_err"], k9),
            ("adjoint_bwd", k6_launches, adj_errs["k6"], adj["K6"]),
            ("adjoint_sweep_fwd", k7_launches, adj_errs["k7"], adj["K7"]),
            ("adjoint_sweep_bwd", k8_launches, adj_errs["k8"], adj["K8"]),
            *((f"{name}/k{Kp}", many[Kp][ADJ_B][key], many[Kp]["f64"][key],
               many_t[(nm, Kp)])
              for Kp in (10, 36)
              for name, key, nm in (("adjoint_sweep_fwd", "k7", "K7"),
                                    ("adjoint_sweep_bwd", "k8", "K8"))),
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

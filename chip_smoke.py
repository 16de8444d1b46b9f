"""GPU smoke run of the PyTorch / CUDA port (vec_ode_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (nvcc). It builds the port's
kernels from the sources in this checkout, holds each kernel against its
plain torch version on the card, drives the port's main path once at full
width (adaptive RKF45 over 16 384 trajectories of a 64-dim complex driven
system, through ``vec_ode_tpu_torch.parallel.ensemble_solve``), checks the
result, and times it. Every phase raises on failure, so any failure exits
non-zero; without a CUDA card it exits non-zero before any result.

Output: progress lines, then the card's name and power limit as
nvidia-smi reports them, then one JSON line describing each kernel, and
last one JSON line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import time

import numpy as np
import torch

from vec_ode_tpu_torch import DONE, DOPRI5, RKF45, StepControl, driver
from vec_ode_tpu_torch.models import DrivenDense
from vec_ode_tpu_torch.ops import _build, fused_rk
from vec_ode_tpu_torch.ops.cplx import Cplx, from_complex
from vec_ode_tpu_torch.ops.fused_rk import (FusedModulatedLinearRK,
                                            fused_rk_step, torch_rk_step)
from vec_ode_tpu_torch.parallel import ensemble_solve

N_TRAJ, DIM = 16384, 64
CTL = StepControl(rtol=1e-8, min_dt=1e-6, max_dt=0.25)
H0, TF = 1e-3, 1.0
KERNEL_SOURCE = "vec_ode_tpu_torch/csrc/fused_rk_step.cu"
REPLACES = "vec_ode_tpu/ops/pallas_rk.py:134"   # fused_rk_step -> pallas_call


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


def build_phase(card: str) -> None:
    cached = _build.library_path("fused_rk_step").exists()
    t0 = time.perf_counter()
    fused_rk._kernel_lib()
    print(f"[build] fused_rk_step {'(cached) ' if cached else ''}"
          f"{time.perf_counter() - t0:.2f} s ({card})", flush=True)


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


def plain_step(st, t, dt, xw, tab=RKF45, advance_lower=True):
    return torch_rk_step(t, dt, xw, st.M0, st.M1,
                         u_fn=lambda ti: torch.cos(st.w * ti), tab=tab,
                         advance_lower=advance_lower)


def err_norm_limit(st, t, dt, xw, ep, tab=RKF45, advance_lower=True):
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
                           advance_lower=advance_lower)
    floor = 4 * float((ep.double() - e64).abs().max())
    return (1e-4 * ep.abs() + floor).to(ep.dtype), floor


def compare_step(B, d, dtype, tab=RKF45, advance_lower=True,
                 dt_range=(1e-3, 5e-2)):
    """Kernel vs plain step on the card; returns (max |dx|, rows on which
    the error-norm check would catch a norm 10% off). The f32 state limit
    is bench.py's on-device limit; f64 differs only by summation order."""
    st, t, dt, xw = step_inputs(B, d, dtype, dt_range=dt_range)
    xk, ek = fused_rk_step(t, dt, xw, st.M0, st.M1, w=st.w, tab=tab,
                           advance_lower=advance_lower)
    xp, ep = plain_step(st, t, dt, xw, tab, advance_lower)
    e_lim, floor = err_norm_limit(st, t, dt, xw, ep, tab, advance_lower)
    torch.cuda.synchronize()
    dx = float((xk - xp).abs().max())
    de = (ek - ep).abs()
    x_lim = 1e-5 * max(float(xp.abs().max()), 1.0) if dtype == torch.float32 \
        else 1e-12
    sensitive = int((0.1 * ep > e_lim).sum())
    ok = (dx <= x_lim and bool((de <= e_lim).all())
          and bool(torch.isfinite(xk).all()) and bool(torch.isfinite(ek).all()))
    print(f"[step] {tab.name} {str(dtype)[6:]} B={B} d={d} dt in "
          f"[{dt_range[0]:g}, {dt_range[1]:g}) advance_lower={advance_lower}: "
          f"max|dx|={dx:.3e} (<= {x_lim:.1e}); max|derr|={float(de.max()):.3e}"
          f", max|derr|/limit={float((de / e_lim).max()):.3f} (<= 1; limit "
          f"1e-4*|err| + {floor:.2e}, err up to {float(ep.max()):.2e}); a "
          f"norm 10% off fails on {sensitive}/{B} rows; "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"kernel disagrees with the plain step: "
                             f"{tab.name} {dtype} B={B} d={d}")
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


def main_inputs():
    model = DrivenDense.make(d=DIM, seed=0)
    rng = np.random.default_rng(42)
    psi0 = (rng.standard_normal((N_TRAJ, DIM))
            + 1j * rng.standard_normal((N_TRAJ, DIM)))
    psi0 /= np.linalg.norm(psi0, axis=-1, keepdims=True)
    y0 = from_complex(psi0, torch.float32, device="cuda")
    st = FusedModulatedLinearRK.from_driven_dense(model, torch.float32,
                                                  device="cuda")
    return st, y0


def solve(st, y0):
    return ensemble_solve(None, y0, 0.0, TF, stepper=st, ctl=CTL, h0=H0,
                          adaptive=True, time_dtype=torch.float32)


def main_path_phase(card: str) -> int:
    st, y0 = main_inputs()
    fused_rk_step.launches = 0
    sol = solve(st, y0)
    torch.cuda.synchronize()
    launches = fused_rk_step.launches

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
    print(f"[main] {N_TRAJ}x{DIM}c RKF45 rtol={CTL.rtol:g}: all DONE, "
          f"max||psi|-1|={norm_dev:.3e}, path={sol.path}, "
          f"kernel launches={launches} == max n_iters={n_iters}, "
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


def timed_ms(fn, reps: int = 3, inner: int = 1) -> float:
    """Median over ``reps`` of the CUDA-event time of ``inner`` calls."""
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
    return statistics.median(out)


def timing_phase(card: str):
    st, y0 = main_inputs()
    solve(st, y0)  # warm
    torch.cuda.reset_peak_memory_stats()
    walls, sols = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        sols.append(solve(st, y0))
        b.record()
        torch.cuda.synchronize()
        walls.append(a.elapsed_time(b))
    peak = torch.cuda.max_memory_allocated()
    wall_ms = statistics.median(walls)
    accepted = int(sols[0].n_accept.sum())
    iters = int(sols[0].n_iters.max())
    print(f"[time] full solve {N_TRAJ}x{DIM}c f32: median wall "
          f"{wall_ms:.3f} ms of {[round(w, 3) for w in walls]}, "
          f"{iters} driver iterations, {accepted} accepted steps, "
          f"{accepted / (wall_ms / 1e3):.4e} accepted steps/s, peak memory "
          f"{peak / 2**20:.1f} MiB ({card})", flush=True)

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
    flop = 6 * N_TRAJ * (2 * DIM) * (4 * DIM) * 2
    print(f"[time] one RKF45 step at B={N_TRAJ}, d={DIM}, f32: kernel "
          f"{k_ms:.4f} ms ({flop / k_ms / 1e9:.2f} TFLOP/s), plain torch "
          f"{p_ms:.4f} ms ({flop / p_ms / 1e9:.2f} TFLOP/s); runs "
          f"kernel {[round(v, 4) for v in k_runs]}, plain "
          f"{[round(v, 4) for v in p_runs]} ({card})", flush=True)
    return k_ms, p_ms


def main() -> None:
    card = device_phase()
    build_phase(card)
    max_abs_err = step_phase()
    launches = main_path_phase(card)
    k_ms, p_ms = timing_phase(card)
    print(card, flush=True)
    print(json.dumps({"kernels": [{
        "name": "fused_rk_step", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": launches,
        "max_abs_err": max_abs_err, "ms": k_ms, "plain_ms": p_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()

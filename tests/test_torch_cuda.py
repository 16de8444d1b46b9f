"""The hand-written CUDA kernels of the port against their plain torch
twins, on a CUDA card: the step kernel (K1) with and without a declared
norm, the whole-loop kernel (K2) with its RK step (K3) and its chain step
(K5) and fixed-step mode, the chain kernel (K4), both chain kernels with
R > 1 exponentials per chain (Magnus-6, CFM), the per-trajectory
dense chain kernel (K9) with the generic exponential path over it, and the
adjoint kernels (K6, K7, K8) with the fixed-step and adaptive adjoint over
them, the chain kernels over 3 to 8 basis terms and the loop kernel
sampling a ChebForm, with black-box operators through auto_modulated on
both routes, K4's many-term body (the tiled GEMM for K0 > 2), and K7 and
K8 with their formed exponents on every launch shape. Every test here carries the
``cuda`` marker and skips without a card. The file imports no jax, so on a machine with a card but without
jax it runs as

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
from chip_smoke import err_norm_limit
from vec_ode_tpu_torch import DONE, StepControl, lc, tableaus as ttab
from vec_ode_tpu_torch import diff as tdiff
from vec_ode_tpu_torch import exp as texp
from vec_ode_tpu_torch.exp import (CFM4Modulated, CFMModulated, CoeffForm,
                                   MagnusModulated4, MagnusModulated6,
                                   MidpointModulated, ModulatedOperator)
from vec_ode_tpu_torch.models import DrivenDense, PulseControl
from vec_ode_tpu_torch.exp.modulated import _taylor_params
from vec_ode_tpu_torch.ops import adjoint as tadj
from vec_ode_tpu_torch.ops import expmv
from vec_ode_tpu_torch.ops.expmv import fused_chain_apply
from vec_ode_tpu_torch.ops.cplx import Cplx, from_complex
from vec_ode_tpu_torch.ops.dense_chains import fused_dense_chain_apply
from vec_ode_tpu_torch.ops.fused_loop import fused_loop_chunk
from vec_ode_tpu_torch.ops.fused_rk import (MAX_WIDTH,
                                            FusedModulatedLinearRK,
                                            fused_rk_step, torch_rk_step)
from vec_ode_tpu_torch.parallel import ensemble_solve

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(B, d, dtype, device, seed=3, dt_range=(1e-3, 5e-2)):
    st = FusedModulatedLinearRK.from_driven_dense(
        DrivenDense.make(d=d, seed=0), dtype, device=device)
    rng = np.random.default_rng(seed)
    xw = torch.as_tensor(rng.standard_normal((B, 2 * d)) * 0.1, dtype=dtype,
                         device=device)
    t = torch.as_tensor(rng.uniform(0, 1, B), dtype=dtype, device=device)
    dt = torch.as_tensor(rng.uniform(*dt_range, B), dtype=dtype,
                         device=device)
    return st, t, dt, xw


@pytest.mark.parametrize("advance_lower", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B,d,tab", [
    (1000, 64, "rkf45"), (1000, 64, "dopri5"), (257, 5, "bosh32"),
    (1, 1, "rkf45"), (64, MAX_WIDTH // 2, "cash_karp"),
])
def test_kernel_matches_plain_step(card, dtype, B, d, tab, advance_lower):
    st, t, dt, xw = _inputs(B, d, dtype, card)
    tab = ttab.TABLEAUS[tab]
    before = fused_rk_step.launches
    kx, ke = fused_rk_step(t, dt, xw, st.M0, st.M1, w=st.w, tab=tab,
                           advance_lower=advance_lower)
    assert fused_rk_step.launches == before + 1
    px, pe = torch_rk_step(t, dt, xw, st.M0, st.M1,
                           u_fn=lambda ti: torch.cos(st.w * ti), tab=tab,
                           advance_lower=advance_lower)
    e_lim, _ = err_norm_limit(st, t, dt, xw, pe, tab, advance_lower)
    torch.cuda.synchronize()
    # the state: f32 to the JAX package's on-device kernel-vs-XLA limit
    # (bench.py), f64 to summation order (FMA in the kernel, cuBLAS in the
    # twin); the error norms per row to chip_smoke.err_norm_limit
    x_tol = (1e-5 * max(float(px.abs().max()), 1.0)
             if dtype == torch.float32 else 1e-12)
    np.testing.assert_allclose(kx.cpu().numpy(), px.cpu().numpy(),
                               rtol=0, atol=x_tol)
    excess = (ke - pe).abs() - e_lim
    assert bool((excess <= 0).all()), float(excess.max())


def test_kernel_error_norm_holds_to_the_row_on_long_steps(card):
    """At the main path's shape with long steps every f32 error norm
    stands above rounding, so the limit catches a norm 10% off on every
    row (and a kernel returning zero)."""
    st, t, dt, xw = _inputs(16384, 64, torch.float32, card,
                            dt_range=(0.15, 0.25))
    _, ke = fused_rk_step(t, dt, xw, st.M0, st.M1, w=st.w)
    _, pe = torch_rk_step(t, dt, xw, st.M0, st.M1,
                          u_fn=lambda ti: torch.cos(st.w * ti))
    e_lim, _ = err_norm_limit(st, t, dt, xw, pe)
    assert bool(((ke - pe).abs() <= e_lim).all())
    assert bool((0.1 * pe > e_lim).all())


def test_kernel_without_embedded_pair_gives_zero_error(card):
    st, t, dt, xw = _inputs(100, 8, torch.float64, card)
    kx, ke = fused_rk_step(t, dt, xw, st.M0, st.M1, w=st.w, tab=ttab.RK4)
    px, pe = torch_rk_step(t, dt, xw, st.M0, st.M1,
                           u_fn=lambda ti: torch.cos(st.w * ti),
                           tab=ttab.RK4)
    assert pe is None
    assert bool((ke == 0).all())
    np.testing.assert_allclose(kx.cpu().numpy(), px.cpu().numpy(), rtol=0,
                               atol=1e-12)


def test_wrapper_refuses_what_the_kernel_does_not_take(card):
    st, t, dt, xw = _inputs(16, 4, torch.float32, card)
    M0, M1, w = st.M0, st.M1, st.w
    with pytest.raises(TypeError):
        fused_rk_step(t.double(), dt, xw, M0, M1, w=w)
    with pytest.raises(TypeError):
        fused_rk_step(t.half(), dt.half(), xw.half(), M0.half(), M1.half(),
                      w=w)
    with pytest.raises(ValueError, match="contiguous"):
        fused_rk_step(t, dt, xw.t().contiguous().t(), M0, M1, w=w)
    with pytest.raises(ValueError):
        fused_rk_step(t.cpu(), dt, xw, M0, M1, w=w)
    with pytest.raises(ValueError):
        fused_rk_step(t[:8], dt, xw, M0, M1, w=w)
    wide = torch.zeros(4, MAX_WIDTH + 2, device=card)
    sq = torch.zeros(MAX_WIDTH + 2, MAX_WIDTH + 2, device=card)
    with pytest.raises(ValueError, match="maximum"):
        fused_rk_step(t[:4], dt[:4], wide, sq, sq, w=w)


def test_step_fn_launches_the_kernel_once_per_step(card):
    """The stepper's step makes the kernel's operands once and launches
    the same kernel as the wrapper, once per step."""
    st, t, dt, xw = _inputs(300, 16, torch.float32, card)
    step = st.make_step_fn()
    want_x, want_e = fused_rk_step(t, dt, xw, st.M0, st.M1, w=st.w)
    before = fused_rk_step.launches
    for k in range(1, 4):
        y, e = step(t, Cplx(xw[:, :16], xw[:, 16:]), dt)
        assert fused_rk_step.launches == before + k
        assert torch.equal(torch.cat([y.re, y.im], dim=1), want_x)
        assert torch.equal(e, want_e)


def test_ensemble_on_the_card_matches_the_cpu_path_f64(card):
    """The ensemble at a small size in f64: on the card 300 trajectories
    with f64 time take the whole-loop path (one launch of the loop kernel,
    no step kernel), on the CPU the host driver over the plain step; the
    same steps per trajectory."""
    model = DrivenDense.make(d=16, seed=0)
    rng = np.random.default_rng(42)
    psi = rng.standard_normal((300, 16)) + 1j * rng.standard_normal((300, 16))
    psi /= np.linalg.norm(psi, axis=-1, keepdims=True)
    ctl = StepControl(rtol=1e-8, min_dt=1e-6, max_dt=0.25)
    sols = {}
    for dev in ("cpu", "cuda"):
        st = FusedModulatedLinearRK.from_driven_dense(model, torch.float64,
                                                      device=dev)
        before = (fused_rk_step.launches, fused_loop_chunk.launches)
        sols[dev] = ensemble_solve(
            None, from_complex(psi, torch.float64, device=dev), 0.0, 1.0,
            stepper=st, ctl=ctl, h0=1e-3, save_at=(0.5,))
        launched = (fused_rk_step.launches - before[0],
                    fused_loop_chunk.launches - before[1])
        if dev == "cuda":
            assert launched == (0, 1)
            assert sols[dev].path == "cuda-loop-persistent"
        else:
            assert launched == (0, 0) and sols[dev].path == "torch-driver"
    cpu, gpu = sols["cpu"], sols["cuda"]
    assert bool((gpu.status == DONE).all())
    for k in ("status", "n_accept", "n_reject", "n_iters"):
        assert torch.equal(getattr(gpu, k).cpu(), getattr(cpu, k)), k
    for part in ("re", "im"):
        np.testing.assert_allclose(getattr(gpu.ys, part).cpu().numpy(),
                                   getattr(cpu.ys, part).numpy(), rtol=0,
                                   atol=1e-10)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind,weights", [("l2", True), ("max", True),
                                          ("rms", False), ("max", False)])
@pytest.mark.parametrize("B,d", [(1000, 64), (257, 5)])
def test_kernel_declared_norm_matches_plain_step(card, B, d, kind, weights,
                                                 dtype):
    st, t, dt, xw = _inputs(B, d, dtype, card)
    wnorm = chip_smoke.weighted(kind, d, weights)
    kx, ke = fused_rk_step(t, dt, xw, st.M0, st.M1, w=st.w, wnorm=wnorm)
    px, pe = torch_rk_step(t, dt, xw, st.M0, st.M1,
                           u_fn=lambda ti: torch.cos(st.w * ti), wnorm=wnorm)
    e_lim, _ = err_norm_limit(st, t, dt, xw, pe, wnorm=wnorm)
    torch.cuda.synchronize()
    assert torch.equal(kx, fused_rk_step(t, dt, xw, st.M0, st.M1, w=st.w)[0])
    excess = (ke - pe).abs() - e_lim
    assert bool((excess <= 0).all()), float(excess.max())


LOOP_NAMES = [n for n in chip_smoke.LOOP_CASES if n != "loop_path"]


@pytest.mark.parametrize("d", [64, 5])
@pytest.mark.parametrize("name", LOOP_NAMES)
def test_loop_kernel_matches_twin_f64(card, name, d):
    """1000 trajectories (a ragged last tile): status and counters equal
    per trajectory, states and saves within 1e-10 (chip_smoke's check)."""
    chip_smoke.check_loop_pair(name, 1000, d, torch.float64)


@pytest.mark.parametrize("name", ["plain", "save_grid", "pi", "loop_path"])
def test_loop_kernel_matches_twin_f32(card, name):
    chip_smoke.check_loop_pair(name, 2048, 64, torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_loop_kernel_persistent_equals_chunked(card, dtype):
    chip_smoke.check_persistent_is_chunked("save_grid", 1000, 64, dtype)


def test_loop_path_through_ensemble_solve(card):
    st, y0 = chip_smoke.main_inputs(512)
    before = (fused_rk_step.launches, fused_loop_chunk.launches)
    sol = chip_smoke.solve(st, y0, chip_smoke.SAVE_AT)
    assert (fused_rk_step.launches - before[0],
            fused_loop_chunk.launches - before[1]) == (0, 1)
    assert sol.path == "cuda-loop-persistent"
    assert bool((sol.status == DONE).all())
    assert sol.ys.re.shape == (512, len(chip_smoke.SAVE_AT) + 2, 64)
    # chunked on request, and the same result
    chunked = st.fused_loop_solve(
        y0, sol.ts[0], chip_smoke.H0, ctl=chip_smoke.CTL, adaptive=True,
        persistent=False)
    assert chunked.path == "cuda-loop-chunked"
    assert torch.equal(chunked.ys.re, sol.ys.re)
    assert torch.equal(chunked.n_iters, sol.n_iters)
    # above the crossover, or with fixed steps: the per-step path
    sol = chip_smoke.solve(*chip_smoke.main_inputs(2049))
    assert sol.path == "torch-driver+cuda-step"
    sol = ensemble_solve(None, y0, 0.0, 0.01, stepper=st, ctl=chip_smoke.CTL,
                         h0=1e-3, adaptive=False, time_dtype=torch.float32)
    assert sol.path == "torch-driver+cuda-step"
    # a time dtype other than the state's: the loop declines, and the step
    # kernel refuses it (the JAX package's per-step path fails there too)
    grid64 = torch.tensor([0.0, 0.1], dtype=torch.float64, device="cuda")
    assert st.fused_loop_solve(y0, grid64, 1e-3, ctl=chip_smoke.CTL,
                               adaptive=True) is None
    with pytest.raises(TypeError, match="float64"):
        ensemble_solve(None, y0, 0.0, 0.1, stepper=st, ctl=chip_smoke.CTL,
                       h0=1e-3)
    # scaled_error runs in the loop kernel, and nowhere else
    ctl = StepControl(rtol=1e-6, atol=1e-9, scaled_error=True)
    sol = ensemble_solve(None, y0, 0.0, 0.1, stepper=st, ctl=ctl, h0=1e-3,
                         time_dtype=torch.float32)
    assert sol.path == "cuda-loop-persistent"
    with pytest.raises(ValueError, match="scaled_error"):
        ensemble_solve(None, y0, 0.0, 0.1, stepper=st, ctl=ctl, h0=1e-3)
    # a declared norm runs in both kernels
    norm = lc.WeightedNorm("max")
    sol = ensemble_solve(None, y0, 0.0, 0.1, stepper=st, h0=1e-3,
                         ctl=chip_smoke.CTL, error_norm=norm,
                         time_dtype=torch.float32)
    assert sol.path == "cuda-loop-persistent" and bool(
        (sol.status == DONE).all())


def test_loop_wrapper_refuses_what_the_kernel_does_not_take(card):
    carries, step, ctl, _ = chip_smoke.loop_case("save_grid", 16, 4,
                                                 torch.float32)
    t_grid, fs, ist, x, saves = carries
    with pytest.raises(ValueError, match="t_grid"):
        fused_loop_chunk(t_grid.cpu(), fs, ist, x, saves, step, ctl=ctl)
    with pytest.raises(TypeError, match="ist"):
        fused_loop_chunk(t_grid, fs, ist.long(), x, saves, step, ctl=ctl)
    with pytest.raises(ValueError, match="fs"):
        fused_loop_chunk(t_grid, fs[:8], ist, x, saves, step, ctl=ctl)
    with pytest.raises(ValueError, match="saves"):
        fused_loop_chunk(t_grid, fs, ist, x, saves[:1], step, ctl=ctl)
    with pytest.raises(ValueError, match="contiguous"):
        fused_loop_chunk(t_grid, fs, ist, x.t().contiguous().t(), saves,
                         step, ctl=ctl)
    with pytest.raises(TypeError):
        fused_loop_chunk(t_grid.double(), fs.double(), ist, x.double(),
                         saves, step, ctl=ctl)


# -- the modulated exponential path: K4 and the loop kernel's chain step --

CHAIN_STEP_CASES = {
    "pair_f64": dict(B=1000, dtype=torch.float64),
    "fast_f64": dict(B=1000, dtype=torch.float64, fast_error=True),
    "l2_weighted_f64": dict(B=1000, dtype=torch.float64,
                            wnorm=("l2", True)),
    "max_f64": dict(B=1000, dtype=torch.float64, wnorm=("max", False)),
    "midpoint_f64": dict(B=1000, dtype=torch.float64, midpoint=True),
    "lz_pair_f32": dict(B=1000, dtype=torch.float32, lz=True),
    "lz_midpoint_f64": dict(B=1000, dtype=torch.float64, lz=True,
                            midpoint=True),
    "pair_f32": dict(B=16384, dtype=torch.float32),
    "fast_f32": dict(B=16384, dtype=torch.float32, fast_error=True),
}


@pytest.mark.parametrize("name", list(CHAIN_STEP_CASES))
def test_chain_kernel_matches_twin(card, name):
    """K4 against torch_chain_step (chip_smoke.check_chain_step's limits):
    f64 at B=1000 (a ragged last tile), the main path's 16384x64c in f32,
    D=4 (Landau-Zener)."""
    kw = dict(CHAIN_STEP_CASES[name])
    B, dtype, wn = kw.pop("B"), kw.pop("dtype"), kw.pop("wnorm", None)
    before = fused_chain_apply.launches
    chip_smoke.check_chain_step(
        B, dtype, name, wnorm=None if wn is None else chip_smoke.weighted(
            wn[0], 64, wn[1]), **kw)
    assert fused_chain_apply.launches == before + 1


def test_chain_kernel_error_norm_holds_to_the_row_on_long_steps(card):
    _, sensitive = chip_smoke.check_chain_step(16384, torch.float32, "pair",
                                               dt_range=(0.1, 0.2))
    assert sensitive == 16384


CHAIN_LOOP_NAMES = [n for n in chip_smoke.CHAIN_CASES
                    if n not in chip_smoke.CHAIN_PATHS]


@pytest.mark.parametrize("name", CHAIN_LOOP_NAMES)
def test_chain_loop_kernel_matches_twin_f64(card, name):
    """1000 trajectories: status and every counter equal per trajectory,
    states and saves within 1e-12 (chip_smoke's check)."""
    chip_smoke.check_chain_loop_pair(name, 1000, torch.float64)


@pytest.mark.parametrize("name", ["plain", "save_grid", "pi", "lz_magnus4",
                                  "lz_midpoint", "magnus_path"])
def test_chain_loop_kernel_matches_twin_f32(card, name):
    chip_smoke.check_chain_loop_pair(name, 2048, torch.float32)


@pytest.mark.parametrize("name,dtype", [("save_grid", torch.float64),
                                        ("fast_error", torch.float32),
                                        ("lz_midpoint", torch.float32)])
def test_chain_loop_persistent_equals_chunked(card, name, dtype):
    chip_smoke.check_chain_persistent_is_chunked(name, 1000, dtype)


def test_chain_loop_kernel_matches_twin_at_the_landau_zener_path(card):
    """The Landau-Zener path's own inputs, batch and 4000 fixed steps
    through the loop kernel and its twin: counters equal, states within
    1e-4."""
    chip_smoke.check_chain_loop_pair("lz_path", chip_smoke.N_TRAJ,
                                     torch.float32)


def test_landau_zener_fixed_steps_on_the_card(card):
    """16384 sweeps in the loop kernel's fixed-step mode: one launch, the
    |0> rows within 0.02 of the closed form, |psi| = 1 within 1e-4."""
    assert chip_smoke.lz_path_phase() == 1


def test_magnus_ensemble_on_the_card_matches_the_cpu_path_f64(card):
    """300 trajectories of a 16-dim driven system in f64: on the card the
    declared form takes the loop kernel (one launch) and a bare
    coefficient function the per-step kernel (a launch per iteration); on
    the CPU the loop's twin. The same steps per trajectory."""
    model = DrivenDense.make(d=16, seed=0)
    rng = np.random.default_rng(42)
    psi = rng.standard_normal((300, 16)) + 1j * rng.standard_normal((300, 16))
    psi /= np.linalg.norm(psi, axis=-1, keepdims=True)
    ctl = StepControl(rtol=1e-8, min_dt=1e-6, max_dt=0.2)
    sols = {}
    for dev, form in (("cpu", True), ("cuda", True), ("cuda", False)):
        op = model.modulated(torch.float64, device=dev)
        if not form:
            op = dataclasses.replace(op, form=None)
        before = (fused_loop_chunk.launches, fused_chain_apply.launches)
        sol = ensemble_solve(
            None, from_complex(psi, torch.float64, device=dev), 0.0, 1.0,
            stepper=MagnusModulated4(op), ctl=ctl, h0=1e-3, save_at=(0.5,))
        launched = (fused_loop_chunk.launches - before[0],
                    fused_chain_apply.launches - before[1])
        if dev == "cpu":
            assert launched == (0, 0) and sol.path == "torch-loop"
        elif form:
            assert launched == (1, 0) and sol.path == "cuda-loop-persistent"
        else:
            assert launched == (0, int(sol.n_iters.max()))
            assert sol.path == "torch-driver+cuda-step"
        sols[(dev, form)] = sol
    cpu = sols[("cpu", True)]
    assert bool((cpu.status == DONE).all())
    for key in (("cuda", True), ("cuda", False)):
        gpu = sols[key]
        for k in ("status", "n_accept", "n_reject", "n_iters"):
            assert torch.equal(getattr(gpu, k).cpu(), getattr(cpu, k)), k
        for part in ("re", "im"):
            np.testing.assert_allclose(getattr(gpu.ys, part).cpu().numpy(),
                                       getattr(cpu.ys, part).numpy(), rtol=0,
                                       atol=1e-10)


def _one_term_operator(device):
    """DrivenDense(64)'s drive term alone: A(t) = cos(w t) (-i V), one
    basis term (K' = 1)."""
    op = DrivenDense.make(d=64, seed=0).modulated(torch.float64,
                                                  device=device)
    form = CoeffForm(a=(0.0,), b=(0.0,), c=(1.0,), w=op.form.w[1:])
    return ModulatedOperator(Cplx(op.basis.re[1:], op.basis.im[1:]),
                             form.sample, form=form)


@pytest.mark.parametrize("stepper", [MagnusModulated4, MidpointModulated])
def test_chain_kernels_on_one_basis_term(card, stepper):
    """K' = 1, f64: K4 against its twin (for Magnus-4 the two chains
    coincide without a commutator, so err is 0), and the loop kernel
    against the loop's twin on the CPU through ensemble_solve: the same
    counters, states within 1e-10."""
    st = stepper(_one_term_operator(card))
    samples, dt, xw = chip_smoke.chain_inputs(st, 1000, torch.float64)
    (yk, ek), (yp, ep) = chip_smoke.chain_pair(st, samples, dt, xw)
    assert float((yk - yp).abs().max()) <= 1e-12
    assert not bool(ek.any()) and (ep is None or not bool(ep.any()))
    psi = chip_smoke.unit_states(300, 64, torch.float64, seed=3)
    sols = {}
    for dev in ("cpu", card):
        sol = ensemble_solve(
            None, Cplx(psi.re.to(dev), psi.im.to(dev)), 0.0, 0.3,
            stepper=stepper(_one_term_operator(dev)),
            ctl=StepControl(rtol=1e-8, min_dt=1e-6, max_dt=0.2,
                            max_steps=1000), h0=0.01,
            adaptive=stepper is MagnusModulated4)
        assert bool((sol.status == DONE).all()), dev
        sols[dev] = sol
    assert sols[card].path == "cuda-loop-persistent"
    for k in ("n_accept", "n_reject", "n_iters"):
        assert torch.equal(getattr(sols[card], k).cpu(),
                           getattr(sols["cpu"], k)), k
    for part in ("re", "im"):
        np.testing.assert_allclose(
            getattr(sols[card].y_final, part).cpu().numpy(),
            getattr(sols["cpu"].y_final, part).numpy(), rtol=0, atol=1e-10)


def test_chain_wrapper_refuses_what_the_kernel_does_not_take(card):
    st = chip_smoke.chain_stepper(torch.float32, d=8)
    samples, dt, xw = chip_smoke.chain_inputs(st, 16, torch.float32)
    mt, norms, m, theta = chip_smoke.chain_operands(st, torch.float32)
    kw = dict(recipe="magnus4", C=2, m=m, theta=theta)
    fused_chain_apply(samples, dt, xw, mt, norms, **kw)
    with pytest.raises(TypeError):
        fused_chain_apply(samples, dt.double(), xw, mt, norms, **kw)
    with pytest.raises(TypeError):
        fused_chain_apply(samples, dt, xw, mt.double(), norms, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        fused_chain_apply(samples, dt, xw.t().contiguous().t(), mt, norms,
                          **kw)
    with pytest.raises(ValueError):
        fused_chain_apply(samples, dt[:8], xw, mt, norms, **kw)
    with pytest.raises(ValueError, match="stacked basis"):
        fused_chain_apply(samples, dt, xw, mt[:, :16], norms, **kw)
    with pytest.raises(ValueError, match="basis terms"):
        g9 = [torch.zeros(16, 9, device=card) for _ in range(2)]
        fused_chain_apply(g9, dt, xw, mt, norms, **kw)
    with pytest.raises(ValueError, match="samples"):
        fused_chain_apply(samples[:1], dt, xw, mt, norms, **kw)


# -- R > 1 exponentials per chain: Magnus-6 and CFM in K4 and K5 -----------

CHAIN_R_STEP_CASES = {
    "magnus6_f64": dict(B=1000, dtype=torch.float64, kind="magnus6"),
    "magnus6_fixed_f64": dict(B=1000, dtype=torch.float64,
                              kind="magnus6_fixed"),
    "cfm4_f64": dict(B=1000, dtype=torch.float64, kind="cfm4"),
    "cfm4_fixed_f64": dict(B=1000, dtype=torch.float64, kind="cfm4_fixed"),
    "blanes_f64": dict(B=1000, dtype=torch.float64, kind="blanes"),
    "magnus6_l2_weighted_f64": dict(B=1000, dtype=torch.float64,
                                    kind="magnus6", wnorm=("l2", True)),
    "cfm4_max_f64": dict(B=1000, dtype=torch.float64, kind="cfm4",
                         wnorm=("max", False)),
    "blanes_f32": dict(B=1000, dtype=torch.float32, kind="blanes"),
    "magnus6_f32": dict(B=16384, dtype=torch.float32, kind="magnus6"),
    "cfm4_f32": dict(B=16384, dtype=torch.float32, kind="cfm4"),
}


@pytest.mark.parametrize("name", list(CHAIN_R_STEP_CASES))
def test_chain_kernel_r_matches_twin(card, name):
    """K4 with R > 1 against torch_chain_step (chip_smoke.check_chain_step's
    limits; f64 states to 1e-13 of their scale on steps where each error
    is held to 1e-9 of itself), one launch."""
    kw = dict(CHAIN_R_STEP_CASES[name])
    B, dtype, wn = kw.pop("B"), kw.pop("dtype"), kw.pop("wnorm", None)
    extra = {}
    if dtype == torch.float64:
        extra = dict(dt_range=chip_smoke.R_DT64[kw["kind"].split("_")[0]],
                     x_rel=1e-13)
    before = fused_chain_apply.launches
    chip_smoke.check_chain_step(
        B, dtype, name, wnorm=None if wn is None else chip_smoke.weighted(
            wn[0], 64, wn[1]), **extra, **kw)
    assert fused_chain_apply.launches == before + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", ["magnus6", "magnus6_fixed", "cfm4",
                                  "blanes"])
def test_chain_kernel_r_edge_rows(card, kind, dtype):
    """A NaN state stays in its row (its error NaN, through the zero pad
    rows for CFM); a row with dt = 0 returns x exactly."""
    chip_smoke.check_chain_edges(kind, dtype)


@pytest.mark.parametrize("kind", ["magnus6", "cfm4"])
def test_chain_kernel_r_error_norm_holds_to_the_row_on_long_steps(card,
                                                                   kind):
    _, sensitive = chip_smoke.check_chain_step(
        16384, torch.float32, kind, dt_range=chip_smoke.R_DT32[kind],
        kind=kind)
    assert sensitive == 16384


CHAIN_R_LOOP_NAMES = [n for n in chip_smoke.R_CASES
                      if n not in chip_smoke.CHAIN_PATHS]


@pytest.mark.parametrize("name", CHAIN_R_LOOP_NAMES)
def test_chain_loop_kernel_r_matches_twin_f64(card, name):
    """K5 with R > 1 in the loop kernel, 1000 trajectories: status and every
    counter equal per trajectory, states and saves within 1e-12."""
    chip_smoke.check_chain_loop_pair(name, 1000, torch.float64)


@pytest.mark.parametrize("name", ["magnus6", "magnus6_fixed", "cfm4",
                                  "cfm4_fixed", "magnus6_path", "cfm4_path"])
def test_chain_loop_kernel_r_matches_twin_f32(card, name):
    chip_smoke.check_chain_loop_pair(name, 2048, torch.float32)


@pytest.mark.parametrize("name,dtype", [("magnus6_save_grid", torch.float64),
                                        ("cfm4_fixed", torch.float32),
                                        ("blanes", torch.float64)])
def test_chain_loop_r_persistent_equals_chunked(card, name, dtype):
    chip_smoke.check_chain_persistent_is_chunked(name, 1000, dtype)


@pytest.mark.parametrize("stepper", [
    MagnusModulated6, CFM4Modulated,
    lambda op: CFMModulated(op, alpha=ttab.BLANES17_R4_J4,
                            c=ttab.C_GAUSS_LEGENDRE_6,
                            alpha_err=chip_smoke.BLANES_ERR)],
    ids=["magnus6", "cfm4", "blanes"])
def test_r_ensemble_on_the_card_matches_the_cpu_path_f64(card, stepper):
    """300 trajectories of a 16-dim driven system in f64: on the card the
    declared form takes the loop kernel (one launch) and a bare
    coefficient function the per-step kernel (a launch per iteration); on
    the CPU the loop's twin. The same steps per trajectory."""
    model = DrivenDense.make(d=16, seed=0)
    rng = np.random.default_rng(42)
    psi = rng.standard_normal((300, 16)) + 1j * rng.standard_normal((300, 16))
    psi /= np.linalg.norm(psi, axis=-1, keepdims=True)
    ctl = StepControl(rtol=1e-8, min_dt=1e-6, max_dt=0.2)
    sols = {}
    for dev, form in (("cpu", True), ("cuda", True), ("cuda", False)):
        op = model.modulated(torch.float64, device=dev)
        if not form:
            op = dataclasses.replace(op, form=None)
        before = (fused_loop_chunk.launches, fused_chain_apply.launches)
        sol = ensemble_solve(
            None, from_complex(psi, torch.float64, device=dev), 0.0, 1.0,
            stepper=stepper(op), ctl=ctl, h0=1e-3, save_at=(0.5,))
        launched = (fused_loop_chunk.launches - before[0],
                    fused_chain_apply.launches - before[1])
        if dev == "cpu":
            assert launched == (0, 0) and sol.path == "torch-loop"
        elif form:
            assert launched == (1, 0) and sol.path == "cuda-loop-persistent"
        else:
            assert launched == (0, int(sol.n_iters.max()))
            assert sol.path == "torch-driver+cuda-step"
        sols[(dev, form)] = sol
    cpu = sols[("cpu", True)]
    assert bool((cpu.status == DONE).all())
    for key in (("cuda", True), ("cuda", False)):
        gpu = sols[key]
        for k in ("status", "n_accept", "n_reject", "n_iters"):
            assert torch.equal(getattr(gpu, k).cpu(), getattr(cpu, k)), k
        for part in ("re", "im"):
            np.testing.assert_allclose(getattr(gpu.ys, part).cpu().numpy(),
                                       getattr(cpu.ys, part).numpy(), rtol=0,
                                       atol=1e-10)


def test_out_of_limit_tables_raise_on_the_card(card):
    """A CFM table of R = 5 exponentials or J = 9 nodes is past the
    kernels' limits: on CUDA tensors the per-step kernel and the loop
    kernel raise, and no twin runs in their place."""
    op = DrivenDense.make(d=8, seed=0).modulated(torch.float64,
                                                 device=card)
    c9 = tuple(np.linspace(0.05, 0.95, 9))
    tables = {"R=5": dict(alpha=np.full((5, 2), 0.1), c=(0.3, 0.7),
                          alpha_err=((0.5, 0.5),)),
              "J=9": dict(alpha=(tuple(np.full(9, 1.0 / 9)),), c=c9,
                          alpha_err=(tuple(np.full(9, 1.0 / 9)),))}
    psi = chip_smoke.unit_states(16, 8, torch.float64, seed=3)
    twin = chip_smoke.expmv.torch_chain_step
    try:
        def refuse(*a, **k):
            raise AssertionError("the twin ran on CUDA tensors")
        chip_smoke.expmv.torch_chain_step = refuse
        for name, tab in tables.items():
            for form in (True, False):
                st = CFMModulated(op if form else dataclasses.replace(
                    op, form=None), **tab)
                before = (fused_loop_chunk.launches,
                          fused_chain_apply.launches)
                with pytest.raises(ValueError, match="at most 4 "
                                   "exponentials per chain and 8"):
                    ensemble_solve(None, psi, 0.0, 0.3, stepper=st,
                                   ctl=StepControl(rtol=1e-6, max_steps=50),
                                   h0=1e-2)
                assert (fused_loop_chunk.launches,
                        fused_chain_apply.launches) == before, (name, form)
    finally:
        chip_smoke.expmv.torch_chain_step = twin


@pytest.mark.parametrize("kw,n_sub", [(dict(order=6), 3),
                                      (dict(scheme="cfm4"), 2)])
def test_adaptive_adjoint_r_on_the_card_matches_the_cpu_path_f64(card, kw,
                                                                 n_sub):
    """The adaptive adjoint at order 6 and with cfm4 through K4 forward
    (one launch per iteration) and K6 backward (n_sub launches per
    iteration) against the twins: the same status, value and gradients
    to f64 rounding."""
    ctl = StepControl(rtol=1e-7, atol=1e-10, min_dt=1e-7, max_dt=0.4,
                      max_steps=400)
    out = {}
    for dev in (card, "cpu"):
        pc, y0, tg, theta = _small_pulse(dev)
        th = theta.clone().requires_grad_(True)
        yr, yi = (v.clone().requires_grad_(True) for v in (y0.re, y0.im))
        before = (tadj.adjoint_bwd.launches, fused_chain_apply.launches)
        yf, st = tdiff.adjoint_solve_adaptive(
            pc.basis_pair(torch.float64, dev), pc.coeff_fn, th, Cplx(yr, yi),
            0.0, pc.T, ctl=ctl, h0=0.3, return_status=True, **kw)
        n_fwd = fused_chain_apply.launches - before[1]
        value = torch.sum(pc.fidelity(yf, tg))
        grads = torch.autograd.grad(value, (th, yr, yi))
        n_bwd = tadj.adjoint_bwd.launches - before[0]
        assert bool((st == DONE).all())
        assert n_bwd == (n_sub * n_fwd if dev == card else 0)
        out[dev] = ([st.cpu(), n_fwd], [value.detach().cpu()]
                    + [g.cpu() for g in grads])
    assert torch.equal(out[card][0][0], out["cpu"][0][0])
    assert out[card][0][1] > 0
    for u, v in zip(out[card][1], out["cpu"][1]):
        np.testing.assert_allclose(u.numpy(), v.numpy(), rtol=1e-8,
                                   atol=1e-12)


# -- the per-trajectory dense chain kernel (K9) and the generic path --------

@pytest.mark.parametrize("dtype,B,D", [(torch.float64, 300, 8),
                                       (torch.float64, 140, 128),
                                       (torch.float32, 300, 128),
                                       (torch.float32, 1000, 4),
                                       (torch.float64, 3, 1)])
@pytest.mark.parametrize("name", list(chip_smoke.dense_tables()))
def test_dense_chain_kernel_matches_twin(card, name, dtype, B, D):
    """K9 against its twin to chip_smoke.check_dense's limits, with a row
    past theta and a NaN row where the batch has them."""
    table = chip_smoke.dense_tables()[name]
    rows = dict(big_row=1, nan_row=2 if B > 3 else None)
    before = fused_dense_chain_apply.launches
    chip_smoke.check_dense(name, table,
                           *chip_smoke.dense_inputs(table, B, D, dtype,
                                                    **rows),
                           nan_row=rows["nan_row"])
    assert fused_dense_chain_apply.launches == before + 1


def test_dense_chain_kernel_reads_strided_samples_and_is_deterministic(card):
    """Trajectory-major and node-major samples give the same bits, and so
    do two launches."""
    table = chip_smoke.dense_tables()["magnus4 pair"]
    node_ops, dt, xw = chip_smoke.dense_inputs(table, 200, 16, torch.float32)
    kw = dict(m=12, theta=1.0)
    y1, e1 = fused_dense_chain_apply(table, node_ops, dt, xw, **kw)
    y2, e2 = fused_dense_chain_apply(table, node_ops, dt, xw, **kw)
    major = node_ops.transpose(0, 1).contiguous().transpose(0, 1)
    assert major.stride(1) > major.stride(0)
    y3, e3 = fused_dense_chain_apply(table, major, dt, xw, **kw)
    torch.cuda.synchronize()
    for y, e in ((y2, e2), (y3, e3)):
        assert torch.equal(y, y1) and torch.equal(e, e1)


def test_dense_chain_wrapper_refuses_what_the_kernel_does_not_take(card):
    table = chip_smoke.dense_tables()["magnus4 pair"]
    node_ops, dt, xw = chip_smoke.dense_inputs(table, 16, 8, torch.float32)
    kw = dict(m=12, theta=1.0)
    fused_dense_chain_apply(table, node_ops, dt, xw, **kw)
    with pytest.raises(TypeError):
        fused_dense_chain_apply(table, node_ops, dt.double(), xw, **kw)
    with pytest.raises(TypeError):
        fused_dense_chain_apply(table, node_ops.double(), dt, xw, **kw)
    with pytest.raises(TypeError):
        fused_dense_chain_apply(table, node_ops.half(), dt.half(), xw.half(),
                                **kw)
    with pytest.raises(ValueError, match="contiguous"):
        fused_dense_chain_apply(table, node_ops.transpose(2, 3), dt, xw, **kw)
    with pytest.raises(ValueError):
        fused_dense_chain_apply(table, node_ops, dt[:8], xw, **kw)
    with pytest.raises(ValueError, match="node_ops"):
        fused_dense_chain_apply(table, node_ops[:1], dt, xw, **kw)
    with pytest.raises(ValueError, match="exceeds"):
        wide = torch.zeros(2, 2, 260, 260, device=card)
        fused_dense_chain_apply(table, wide, dt[:2], torch.zeros(
            2, 260, device=card), **kw)
    with pytest.raises(ValueError, match="max_squarings"):
        fused_dense_chain_apply(table, node_ops, dt, xw, max_squarings=65,
                                **kw)


@pytest.mark.parametrize("name", ["magnus4", "magnus6", "cfm4_blanes17",
                                  "midpoint"])
def test_generic_ensemble_on_the_card_matches_the_cpu_path_f64(card, name):
    """ensemble_solve with a generic stepper on the card (K9 per
    iteration) against the CPU path (its twin) in f64: the same counters,
    states within 1e-10."""
    make = {"magnus4": lambda **kw: texp.Magnus4(texp.DenseCplxSplit(), **kw),
            "magnus6": lambda **kw: texp.Magnus6(texp.DenseCplxSplit(), **kw),
            "cfm4_blanes17": lambda **kw: texp.CFM4_BLANES17(
                texp.DenseCplxSplit(), **kw),
            "midpoint": lambda **kw: texp.ExpMidpoint(texp.DenseCplxSplit(),
                                                      **kw)}[name]
    model = DrivenDense.make(d=16, seed=0)
    psi = chip_smoke.unit_states(200, 16, torch.float64, seed=3)
    sols = {}
    for dev in ("cpu", card):
        before = fused_dense_chain_apply.launches
        sol = ensemble_solve(
            lambda t: model.op_pair(t, torch.float64, t.device),
            Cplx(psi.re.to(dev), psi.im.to(dev)), 0.0, 0.4, stepper=make(),
            ctl=StepControl(rtol=1e-7, min_dt=1e-6, max_dt=0.25,
                            max_steps=1000), h0=0.02,
            adaptive=name != "midpoint")
        assert bool((sol.status == DONE).all()), dev
        launched = fused_dense_chain_apply.launches - before
        assert launched == (int(sol.n_iters.max()) if dev == card else 0)
        sols[dev] = sol
    assert sols[card].path == "torch-driver+cuda-step"
    assert sols["cpu"].path == "torch-driver"
    for k in ("n_accept", "n_reject", "n_iters"):
        assert torch.equal(getattr(sols[card], k).cpu(),
                           getattr(sols["cpu"], k)), k
    for part in ("re", "im"):
        np.testing.assert_allclose(
            getattr(sols[card].y_final, part).cpu().numpy(),
            getattr(sols["cpu"].y_final, part).numpy(), rtol=0, atol=1e-10)


def test_generic_path_stays_on_the_kernel_under_a_declared_norm(card):
    """A declared norm takes a K9 launch per iteration like the plain l2,
    and says so in Solution.path; the unweighted l2 declaration gives the
    plain solve's bits, and the stacked reference agrees in f32."""
    _, y0 = chip_smoke.main_inputs(256)
    sols = {}
    for key, kw in (("k9", {}), ("norm", dict(norm=lc.WeightedNorm("l2"))),
                    ("max", dict(norm=lc.WeightedNorm(
                        "max", tuple(np.linspace(0.5, 1.0, chip_smoke.DIM)))))):
        before = fused_dense_chain_apply.launches
        sols[key] = ensemble_solve(
            chip_smoke.generic_op_fn(), y0, 0.0, 1.0,
            stepper=texp.Magnus4(texp.DenseCplxSplit(), **kw),
            ctl=chip_smoke.GEN_CTL, h0=chip_smoke.GEN_H0,
            time_dtype=torch.float32)
        launched = fused_dense_chain_apply.launches - before
        assert launched == int(sols[key].n_iters.max())
        assert bool((sols[key].status == DONE).all())
        assert sols[key].path == "torch-driver+cuda-step"
    assert torch.equal(sols["k9"].y_final.re, sols["norm"].y_final.re)
    assert torch.equal(sols["k9"].n_iters, sols["norm"].n_iters)
    before = fused_dense_chain_apply.launches
    ref = chip_smoke.stacked_generic_solve(y0)
    assert fused_dense_chain_apply.launches == before
    assert chip_smoke.max_dy(sols["k9"], ref) <= 1e-4
    assert chip_smoke.max_dy(sols["k9"], sols["max"]) <= 2e-3


@pytest.mark.parametrize("dtype,B,D", [(torch.float64, 300, 8),
                                       (torch.float64, 140, 128),
                                       (torch.float32, 300, 128),
                                       (torch.float32, 1000, 4)])
@pytest.mark.parametrize("kind,weights", [("l2", True), ("rms", False),
                                          ("rms", True), ("max", False),
                                          ("max", True)])
def test_dense_chain_kernel_declared_norm_matches_twin(card, kind, weights,
                                                       dtype, B, D):
    """K9's error under each declared norm against its twin, with a row
    past theta and a NaN row."""
    table = chip_smoke.dense_tables()["magnus4 pair"]
    chip_smoke.check_dense(
        f"norm {kind}", table,
        *chip_smoke.dense_inputs(table, B, D, dtype, big_row=1, nan_row=2),
        nan_row=2, wnorm=chip_smoke.weighted(kind, D // 2, weights))


def test_dense_chain_wrapper_refuses_misaligned_samples(card):
    """Where the kernel reads in 16-byte vectors (D a multiple of 128), an
    offset or a stride off that grid raises before the launch; at other D
    the same view runs."""
    table = chip_smoke.dense_tables()["magnus4 pair"]
    kw = dict(m=12, theta=1.0)
    for D, refuses in ((128, True), (8, False)):
        node_ops, dt, xw = chip_smoke.dense_inputs(table, 6, D, torch.float32)
        flat = torch.zeros(2, 6, D * D + 1, device=card)
        flat[..., 1:] = node_ops.reshape(2, 6, -1)
        off = flat[..., 1:].unflatten(-1, (D, D))
        assert off.stride(2) == D and off.stride(3) == 1
        if refuses:
            with pytest.raises(ValueError, match="16 bytes"):
                fused_dense_chain_apply(table, off, dt, xw, **kw)
        else:
            y, e = fused_dense_chain_apply(table, off, dt, xw, **kw)
            y0, e0 = fused_dense_chain_apply(table, node_ops, dt, xw, **kw)
            assert torch.equal(y, y0) and torch.equal(e, e0)


# the adjoint kernels K6, K7, K8 (ops/adjoint.py, csrc/adjoint.cu)

@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("B,D,Kp,R,scale", [
    *chip_smoke.ADJ_CASES, (1, 128, 1, 2, 0.5), (1000, 64, 4, 3, 0.3),
    (5, 512, 6, 2, 0.2), (300, 8, 5, 4, 2.0), (40, 18, 3, 3, 0.5)])
def test_adjoint_kernels_match_twins(card, dtype, B, D, Kp, R, scale):
    """K6, K7 and K8 against their twins: ragged batches, D not a multiple
    of 32 and the largest D, K' from 1 to 6, rows past theta."""
    before = (tadj.adjoint_bwd.launches, tadj.adjoint_sweep_fwd.launches,
              tadj.adjoint_sweep_bwd.launches)
    chip_smoke.check_adjoint_case(B, D, Kp, R, dtype, 7, scale)
    assert (tadj.adjoint_bwd.launches, tadj.adjoint_sweep_fwd.launches,
            tadj.adjoint_sweep_bwd.launches) == tuple(b + 1 for b in before)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_adjoint_kernels_keep_a_nan_row_in_its_row(card, dtype):
    chip_smoke.check_adjoint_nan(dtype)


def test_adjoint_sweep_bwd_is_deterministic(card):
    """K8's cbar is summed per block and then in block order: the same
    bits from run to run."""
    W, _, c_all, x, a = chip_smoke.adjoint_case(4096, 128, 3, 6,
                                                torch.float32, 3, 0.3)
    mt, ms, norms = chip_smoke.adj_operands(W)
    kw = dict(m=8, theta=0.35)
    first = tadj.adjoint_sweep_bwd(c_all, x, a, mt, ms, norms, **kw)
    for _ in range(3):
        again = tadj.adjoint_sweep_bwd(c_all, x, a, mt, ms, norms, **kw)
        assert all(torch.equal(u, v) for u, v in zip(first, again))


def test_adjoint_wrappers_refuse_what_the_kernels_do_not_take(card):
    W, c, c_all, x, a = chip_smoke.adjoint_case(4, 16, 3, 2, torch.float32,
                                                1, 0.3)
    mt, ms, norms = chip_smoke.adj_operands(W)
    kw = dict(m=8, theta=0.35)
    W7, c7, _, x7, a7 = chip_smoke.adjoint_case(4, 16, 7, 2, torch.float32,
                                                1, 0.3)
    mt7, ms7, n7 = chip_smoke.adj_operands(W7)
    with pytest.raises(ValueError, match="1 to 6 basis terms"):
        tadj.adjoint_bwd(c7, x7, a7, mt7, ms7, n7, **kw)
    xb = torch.zeros(4, 520, device=card)
    with pytest.raises(ValueError, match="D <= 512"):
        tadj.adjoint_sweep_fwd(c_all, xb, torch.zeros(520, 3 * 520,
                                                      device=card),
                               norms, **kw)
    with pytest.raises(TypeError):
        tadj.adjoint_sweep_bwd(c_all.double(), x, a, mt, ms, norms, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        tadj.adjoint_bwd(c, x.t().contiguous().t(), a, mt, ms, norms, **kw)
    with pytest.raises(ValueError, match="rows must be"):
        tadj.adjoint_bwd(c[:3], x, a, mt, ms, norms, **kw)


def _small_pulse(device, dtype=torch.float64, B=5, d=4):
    pc = PulseControl.make(d=d, seed=0, T=2.0, n_modes=4)
    rng = np.random.default_rng(3)
    z = rng.standard_normal((B, d)) + 1j * rng.standard_normal((B, d))
    z /= np.linalg.norm(z, axis=-1, keepdims=True)
    return (pc, from_complex(z, dtype, device=device),
            from_complex(np.roll(z, 1, axis=-1), dtype, device=device),
            torch.linspace(0.1, 0.4, 4, dtype=dtype, device=device))


@pytest.mark.parametrize("kw", [dict(order=4), dict(order=6), dict(order=2),
                                dict(save_at_steps=(4, 8, 16)),
                                dict(anchor_every=4)])
def test_fixed_step_adjoint_on_the_card_matches_the_cpu_path_f64(card, kw):
    """Value and theta / psi0 gradients of the same loss through K7 and K8
    and through their twins; one launch of each per segment."""
    out = {}
    for dev in (card, "cpu"):
        pc, y0, tg, theta = _small_pulse(dev)
        th = theta.clone().requires_grad_(True)
        yr, yi = (v.clone().requires_grad_(True) for v in (y0.re, y0.im))
        before = (tadj.adjoint_sweep_fwd.launches,
                  tadj.adjoint_sweep_bwd.launches)
        ys = tdiff.adjoint_solve(pc.basis_pair(torch.float64, dev),
                                 pc.coeff_fn, th, Cplx(yr, yi), 0.0, pc.T,
                                 16, **kw)
        value = torch.sum(pc.fidelity(ys, tg))
        grads = torch.autograd.grad(value, (th, yr, yi))
        launched = (tadj.adjoint_sweep_fwd.launches - before[0],
                    tadj.adjoint_sweep_bwd.launches - before[1])
        n_seg = (3 if "save_at_steps" in kw else 4 if "anchor_every" in kw
                 else 1)
        assert launched == ((n_seg, n_seg) if dev == card else (0, 0))
        out[dev] = [value.detach().cpu()] + [g.cpu() for g in grads]
    for u, v in zip(out[card], out["cpu"]):
        np.testing.assert_allclose(u.numpy(), v.numpy(), rtol=1e-10,
                                   atol=1e-13)


def test_adaptive_adjoint_on_the_card_matches_the_cpu_path_f64(card):
    """The adaptive adjoint through K4 forward and K6 backward against the
    twins: the same status and iterations, one K6 launch per iteration,
    value and gradients to f64 rounding."""
    ctl = StepControl(rtol=1e-7, atol=1e-10, min_dt=1e-7, max_dt=0.4,
                      max_steps=400)
    out = {}
    for dev in (card, "cpu"):
        pc, y0, tg, theta = _small_pulse(dev)
        th = theta.clone().requires_grad_(True)
        yr, yi = (v.clone().requires_grad_(True) for v in (y0.re, y0.im))
        before = (tadj.adjoint_bwd.launches, fused_chain_apply.launches)
        yf, st = tdiff.adjoint_solve_adaptive(
            pc.basis_pair(torch.float64, dev), pc.coeff_fn, th, Cplx(yr, yi),
            0.0, pc.T, ctl=ctl, h0=0.3, return_status=True)
        n_fwd = fused_chain_apply.launches - before[1]
        value = torch.sum(pc.fidelity(yf, tg))
        grads = torch.autograd.grad(value, (th, yr, yi))
        n_bwd = tadj.adjoint_bwd.launches - before[0]
        assert bool((st == DONE).all())
        assert n_bwd == (n_fwd if dev == card else 0)
        out[dev] = ([st.cpu(), n_fwd], [value.detach().cpu()]
                    + [g.cpu() for g in grads])
    assert torch.equal(out[card][0][0], out["cpu"][0][0])
    assert out[card][0][1] > 0
    for u, v in zip(out[card][1], out["cpu"][1]):
        np.testing.assert_allclose(u.numpy(), v.numpy(), rtol=1e-8,
                                   atol=1e-12)


def test_pulse_control_infidelity_runs_only_the_kernels(card):
    """On CUDA tensors the value-and-grad makes one K7 and one K8 launch
    and calls no twin."""
    pc, y0, tg, theta = _small_pulse(card, torch.float32, B=16, d=8)
    th = theta.clone().requires_grad_(True)
    before = (tadj.adjoint_sweep_fwd.launches, tadj.adjoint_sweep_bwd.launches,
              tadj.adjoint_bwd.launches)
    with chip_smoke.TwinCalls() as tw:
        value = pc.infidelity(th, y0, tg, n_steps=32, dtype=torch.float32)
        (g,) = torch.autograd.grad(value, th)
        torch.cuda.synchronize()
    assert tw.n == 0
    assert (tadj.adjoint_sweep_fwd.launches - before[0],
            tadj.adjoint_sweep_bwd.launches - before[1],
            tadj.adjoint_bwd.launches - before[2]) == (1, 1, 0)
    assert bool(torch.isfinite(g).all())


# -- events and dense output in the loop kernel (K2's switches) ----------

EXTRA_NAMES = list(chip_smoke.EXTRA_STEPS)
EXTRA_F64 = [(n, m) for n in EXTRA_NAMES for m in chip_smoke.EXTRA_MODES
             if not (n.startswith("lz") and m == "saves")]


@pytest.mark.parametrize("name,mode", EXTRA_F64)
def test_loop_kernel_events_and_dense_match_twin_f64(card, name, mode):
    """300 trajectories (a ragged last tile), both steps: counters,
    status, found and count equal per trajectory, located times and
    dense (t, dt) within 1e-10, states within 1e-12 (chip_smoke's
    check)."""
    chip_smoke.check_extra_pair(name, 300, torch.float64, mode)


@pytest.mark.parametrize("mode", ["events", "dense"])
@pytest.mark.parametrize("name", ["rk", "magnus4", "cfm4", "lz_magnus4"])
def test_loop_kernel_events_and_dense_match_twin_f32(card, name, mode):
    """f32: status, found and count equal on 98% of the rows at least, and
    on those the located times within 2 t_tol, the states and the dense
    output's Hermite values within 1e-4 (chip_smoke's check)."""
    chip_smoke.check_extra_pair(name, 1024, torch.float32, mode)


@pytest.mark.parametrize("name,mode", [("rk", "both"), ("cfm4", "saves")])
def test_loop_kernel_events_persistent_equals_chunked(card, name, mode):
    chip_smoke.check_extra_persistent_is_chunked(name, 300, torch.float64,
                                                 mode)


def test_ensemble_names_the_event_and_dense_paths(card):
    """The declared observables run in K2 on both steps (one launch, the
    loop paths' names, ``-dense`` with dense output); opaque callables,
    batches past the loop's and operators without a declared form run in
    the host driver with a step kernel per iteration."""
    cfg = chip_smoke.drive_events()
    st, y0 = chip_smoke.main_inputs(256)
    kw = dict(ctl=chip_smoke.CTL, h0=chip_smoke.H0, time_dtype=torch.float32)

    def run(stepper, y, **extra):
        chip_smoke.reset_counts()
        sol = ensemble_solve(None, y, 0.0, 0.5, stepper=stepper, **kw,
                             **extra)
        torch.cuda.synchronize()
        return sol, chip_smoke.counts()

    sol, k = run(st, y0, events=cfg)
    assert (sol.path, k) == ("cuda-loop-persistent", (0, 1, 0))
    assert sol.event_t_k.shape == (256, 2, 3) and sol.event_t_k.is_cuda
    sol, k = run(st, y0, save_at=(0.1, 0.3), dense=True)
    assert (sol.path, k) == ("cuda-loop-persistent-dense", (0, 1, 0))
    sol, k = run(st, y0, save_at=(0.1, 0.3), dense=True, events=cfg)
    assert (sol.path, k) == ("cuda-loop-persistent-dense", (0, 1, 0))
    chunked = st.fused_loop_solve(
        y0, sol.ts[0], chip_smoke.H0, ctl=chip_smoke.CTL, adaptive=True,
        persistent=False, chunk=7, events=cfg, dense=True)
    assert chunked.path == "cuda-loop-chunked-dense"
    for f in ("n_iters", "event_count", "event_t_k"):
        assert torch.equal(getattr(chunked, f), getattr(sol, f)), f
    assert torch.equal(chunked.ys.re, sol.ys.re)
    opaque = chip_smoke.EventConfig(events=(chip_smoke.Event(
        lambda t, x: x.re[0] - 0.05),))
    sol, k = run(st, y0, events=opaque)
    assert sol.path == "torch-driver+cuda-step"
    assert k == (int(sol.n_iters.max()), 0, 0)
    big_st, big = chip_smoke.main_inputs(2049)
    sol, k = run(big_st, big, events=cfg)
    assert sol.path == "torch-driver+cuda-step" and k[1] == 0
    sol, k = run(big_st, big, save_at=(0.1, 0.3), dense=True)
    assert sol.path == "torch-driver+cuda-step-dense" and k[1] == 0
    kw["ctl"] = chip_smoke.MAG_CTL
    mst, my0 = chip_smoke.r_inputs("cfm4", n=256)
    sol, k = run(mst, my0, events=cfg, save_at=(0.2,))
    assert (sol.path, k) == ("cuda-loop-persistent", (0, 1, 0))
    sol, k = run(mst, my0, save_at=(0.2,), dense=True)
    assert (sol.path, k) == ("cuda-loop-persistent-dense", (0, 1, 0))
    pst, _ = chip_smoke.r_inputs("magnus4", n=256, form=False)
    sol, k = run(pst, my0, save_at=(0.2,), dense=True)
    assert sol.path == "torch-driver+cuda-step-dense"
    assert k == (0, 0, int(sol.n_iters.max()))
    sol, k = run(pst, my0, events=cfg)
    assert sol.path == "torch-driver+cuda-step"
    with pytest.raises(ValueError, match="events="):
        run(pst, my0, save_at=(0.2,), dense=True, events=cfg)


def test_no_event_or_dense_path_gives_way_to_a_twin(card, monkeypatch):
    """On CUDA tensors every event and dense route launches its kernel:
    with the plain twins made to fail, each still runs."""
    from vec_ode_tpu_torch.ops import expmv, fused_loop, fused_rk

    def refuse(*a, **k):
        raise AssertionError("a plain twin ran on CUDA tensors")

    for mod, name in ((fused_loop, "torch_fused_loop"),
                      (expmv, "torch_chain_step"),
                      (fused_rk, "torch_rk_step")):
        monkeypatch.setattr(mod, name, refuse)
    cfg = chip_smoke.drive_events()
    st, y0 = chip_smoke.main_inputs(128)
    kw = dict(ctl=chip_smoke.CTL, h0=chip_smoke.H0, time_dtype=torch.float32)
    for extra in (dict(events=cfg), dict(save_at=(0.2,), dense=True)):
        for stepper in (st, chip_smoke.main_inputs(2049)[0]):
            y = y0 if stepper is st else chip_smoke.main_inputs(2049)[1]
            sol = ensemble_solve(None, y, 0.0, 0.3, stepper=stepper, **kw,
                                 **extra)
            assert sol.path.startswith(("cuda-loop", "torch-driver+cuda"))
    kw["ctl"] = chip_smoke.MAG_CTL
    for form in (True, False):
        mst, my0 = chip_smoke.r_inputs("magnus4", n=128, form=form)
        for extra in (dict(events=cfg), dict(save_at=(0.2,), dense=True)):
            sol = ensemble_solve(None, my0, 0.0, 0.3, stepper=mst, **kw,
                                 **extra)
            assert sol.path.startswith(("cuda-loop", "torch-driver+cuda"))


# -- 3 to 8 basis terms (K' up to 36) and the ChebForm ---------------------

@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("kind", chip_smoke.K0_KINDS)
@pytest.mark.parametrize("K0", chip_smoke.K0_CASES)
def test_chain_kernel_k0_matches_twin(card, K0, kind, dtype):
    """K4 over 3, 5 and 8 basis terms against torch_chain_step at 2048x64c
    (chip_smoke.check_chain_step's limits), every recipe."""
    before = fused_chain_apply.launches
    chip_smoke.check_chain_step(
        2048, dtype, f"K0={K0} {kind}",
        make=lambda dt_: chip_smoke.k0_stepper(
            kind, chip_smoke.multi_op(K0, dt_)))
    assert fused_chain_apply.launches == before + 1


@pytest.mark.parametrize("name", [k for k in chip_smoke.K0_LOOP_CASES
                                  if k not in chip_smoke.K0_PATHS])
def test_loop_kernel_cheb_k0_matches_twin_f64(card, name):
    """K2 with K5 sampling a ChebForm over 3 to 8 terms against
    torch_fused_loop: counters equal per trajectory, states within
    1e-12."""
    chip_smoke.check_chain_loop_pair(name, 1000, torch.float64)


@pytest.mark.parametrize("name", ["auto_path", "iq_path"])
def test_loop_kernel_recovered_operators_match_twin_f32(card, name):
    """The ChebForm of a recovered black box in K2 (two terms, the
    register body; three, the k-outer one) against its twin at 2048."""
    chip_smoke.check_chain_loop_pair(name, 2048, torch.float32)


@pytest.mark.parametrize("name,mode", [("k0_8_magnus4", "events"),
                                       ("k0_8_magnus4", "dense"),
                                       ("k0_8_cfm4", "both"),
                                       ("k0_3_magnus6", "saves")])
def test_loop_kernel_cheb_events_and_dense_match_twin(card, name, mode):
    chip_smoke.check_extra_pair(name, 1000, torch.float64, mode)


def test_loop_kernel_cheb_events_f32(card):
    chip_smoke.check_extra_pair("auto_path", 2048, torch.float32, "events")


def test_loop_kernel_k0_persistent_equals_chunked(card):
    chip_smoke.check_chain_persistent_is_chunked("k0_8_save_grid", 1000,
                                                 torch.float64)
    chip_smoke.check_extra_persistent_is_chunked("k0_5_magnus4", 1000,
                                                 torch.float64, "both")


@pytest.mark.parametrize("kind", ["auto", "iq"])
def test_black_box_routes_count_launches_and_name_paths(card, kind):
    """A black box through auto_modulated: with its ChebForm one K2 launch
    (cuda-loop-persistent), without it a K4 launch per iteration
    (torch-driver+cuda-step); all DONE, the two within f32 rounding."""
    op = (chip_smoke.auto_drive_op if kind == "auto" else chip_smoke.iq_op)
    y0 = chip_smoke.unit_states(256, chip_smoke.DIM, torch.float32, 2)
    loop = chip_smoke.counted(lambda: chip_smoke.auto_solve(op(), y0))
    step = chip_smoke.counted(
        lambda: chip_smoke.auto_solve(op(fit_cols=False), y0))
    chip_smoke.check_routes(kind, loop, step, 256)


def test_more_than_eight_terms_raise_before_any_launch(card, monkeypatch):
    """Nine basis terms on CUDA tensors: the chain kernel and the loop
    kernel raise ValueError, launch nothing and run no twin."""
    from vec_ode_tpu_torch.ops import expmv, fused_loop

    def refuse(*a, **k):
        raise AssertionError("a plain twin ran on CUDA tensors")

    monkeypatch.setattr(expmv, "torch_chain_step", refuse)
    monkeypatch.setattr(fused_loop, "torch_fused_loop", refuse)
    D, B = 8, 16
    xw = torch.zeros(B, D, device=card)
    dt = torch.full((B,), 0.1, device=card)
    mt = torch.zeros(D, 45 * D, device=card)
    g9 = [torch.zeros(B, 9, device=card) for _ in range(2)]
    before = (fused_chain_apply.launches, fused_loop_chunk.launches)
    with pytest.raises(ValueError, match="1 to 8 basis terms"):
        fused_chain_apply(g9, dt, xw, mt, (1.0,) * 45, recipe="magnus4",
                          C=2, m=8, theta=0.35)
    form = texp.ChebForm(np.zeros((3, 9)), 0.0, 1.0)
    step = chip_smoke.ChainStep(mt=mt, norms=(1.0,) * 45, form=form,
                                recipe="magnus4", C=2, m=8, theta=0.35)
    grid = torch.tensor([0.0, 1.0], device=card)
    carries = chip_smoke.init_carries(grid, xw, 0.01)
    with pytest.raises(ValueError, match="1 to 8 basis terms"):
        fused_loop_chunk(*carries, step, ctl=chip_smoke.MAG_CTL)
    assert (fused_chain_apply.launches, fused_loop_chunk.launches) == before


# -- K4's many-term body (K0 > 2, the tiled GEMM) and K7's formed exponent --

GEMM_KINDS = ("magnus4", "magnus4_fast", "magnus6", "cfm4")


def _gemm_case(B, D, K0, kind, dtype, seed=0):
    """fused_chain_apply's inputs for the recipe of ``kind`` over K0 basis
    terms: a random antisymmetric working basis of width D (any D, not
    only 2d), node samples, dt in [1e-3, 5e-2) and states."""
    st = chip_smoke.k0_stepper(kind, chip_smoke.multi_op(K0, dtype))
    _, _, m, theta = chip_smoke.chain_operands(st, dtype)
    Kp = expmv.n_working_terms(st._recipe, K0)
    rng = np.random.default_rng(seed)
    S = rng.standard_normal((Kp, D, D)) / np.sqrt(D)

    def t(a):
        return torch.tensor(a, dtype=dtype, device="cuda")

    W = t(S - np.swapaxes(S, -1, -2))
    J = expmv.n_nodes(st._recipe, st._chains, st._table)
    kw = dict(recipe=st._recipe, C=st._chains, m=m, theta=theta,
              table=st._table)
    return (t(rng.standard_normal((J, B, K0))),
            t(rng.uniform(1e-3, 5e-2, B)), t(rng.standard_normal((B, D))),
            expmv.stacked_transpose(W), expmv.basis_norms(W), kw)


def _check_gemm_body(B, D, K0, kind, dtype, nan_row=None):
    """K4 on _gemm_case's inputs against torch_chain_step on the card, at
    check_chain_step's limits (f64: y to 1e-12 of its scale, the error
    norm to 1e-9 of itself plus 1e-18; f32: y to 1e-5, the norm to 1e-4
    plus four times the f32 twin's largest distance from the f64 twin on
    1000 or more rows of the same draw: one row alone understates the
    rounding of a difference of two chains); with ``nan_row``, that row
    NaN in y and err and every other row finite."""
    g, dt, xw, mt, norms, kw = _gemm_case(B, D, K0, kind, dtype)
    if nan_row is not None:
        xw[nan_row, D // 2] = float("nan")
    before = fused_chain_apply.launches
    yk, ek = fused_chain_apply(g, dt, xw, mt, norms, **kw)
    assert fused_chain_apply.launches == before + 1
    yp, ep = expmv.torch_chain_step(list(g), dt, xw, mt, norms, **kw)
    has_err = ep is not None
    ep = ep if has_err else torch.zeros_like(ek)
    ok = torch.ones(B, dtype=torch.bool, device="cuda")
    if nan_row is not None:
        ok[nan_row] = False
        assert bool(torch.isnan(yk[nan_row]).all())
        assert not has_err or bool(torch.isnan(ek[nan_row]))
    scale = max(float(yp[ok].abs().max()), 1.0)
    if dtype == torch.float64:
        x_lim, e_lim = 1e-12 * scale, 1e-9 * ep[ok].abs() + 1e-18
    else:
        floor = 0.0
        if has_err:
            gf, dtf, xf, mtf, nf, _ = _gemm_case(max(B, 1000), D, K0, kind,
                                                 dtype)
            _, e32 = expmv.torch_chain_step(list(gf), dtf, xf, mtf, nf, **kw)
            _, e64 = expmv.torch_chain_step(
                [v.double() for v in gf], dtf.double(), xf.double(),
                mtf.double(), nf, **kw)
            floor = 4 * float((e32.double() - e64).abs().max())
        x_lim, e_lim = 1e-5 * scale, 1e-4 * ep[ok].abs() + floor
    assert bool(torch.isfinite(yk[ok]).all() & torch.isfinite(ek[ok]).all())
    assert float((yk - yp)[ok].abs().max()) <= x_lim
    assert bool(((ek - ep)[ok].abs() <= e_lim).all())
    if not has_err:
        assert bool((ek == 0).all())
    return yk, ek


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("kind", GEMM_KINDS)
@pytest.mark.parametrize("K0", [3, 5, 8])
@pytest.mark.parametrize("B,D", [(1, 128), (33, 5), (33, 64), (1000, 5),
                                 (1000, 64), (1000, 128)])
def test_chain_gemm_body_matches_twin(card, B, D, K0, kind, dtype):
    """K4's many-term body against its twin: K0 = 3, 5, 8 on every recipe
    (the Magnus-4 pair and fast_error, Magnus-6, CFM-4), a batch of one,
    ragged last tiles, D = 5 (not a multiple of the 4 columns a thread
    or of a panel), 64 and 128."""
    _check_gemm_body(B, D, K0, kind, dtype)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("kind", GEMM_KINDS)
def test_chain_gemm_body_at_the_path_batch(card, kind, dtype):
    """The same at the per-step path's 16384 x 128 with eight terms (K' =
    36 for the Magnus recipes), and two launches equal bit for bit."""
    yk, ek = _check_gemm_body(16384, 128, 8, kind, dtype)
    g, dt, xw, mt, norms, kw = _gemm_case(16384, 128, 8, kind, dtype)
    y2, e2 = fused_chain_apply(g, dt, xw, mt, norms, **kw)
    assert torch.equal(yk, y2) and torch.equal(ek, e2)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("kind", GEMM_KINDS)
def test_chain_gemm_body_keeps_a_nan_row_in_its_row(card, kind, dtype):
    _check_gemm_body(300, 128, 5, kind, dtype, nan_row=77)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("D", [8, 128, 512])
@pytest.mark.parametrize("Kp", [1, 2, 3, 4, 5, 6])
@pytest.mark.parametrize("B", [1, 3, 256, 4096])
def test_adjoint_sweep_fwd_matches_twin(card, B, Kp, D, dtype):
    """K7 against torch_adjoint_sweep_fwd (adj_tolerances: f64 1e-10, f32
    1e-4 relative to the largest entry), on rows that need squarings; D =
    8 and 128 take both exponents in shared memory in f32 (one, formed
    between rows, in f64 at 128), D = 512 the panels."""
    W, _, c_all, x, _ = chip_smoke.adjoint_case(B, D, Kp, 4, dtype, 11 + Kp,
                                                0.4)
    mt, _, norms = chip_smoke.adj_operands(W)
    m, theta = _taylor_params(dtype)
    kw = dict(m=m, theta=theta, max_squarings=16)
    before = tadj.adjoint_sweep_fwd.launches
    y = tadj.adjoint_sweep_fwd(c_all, x, mt, norms, **kw)
    assert tadj.adjoint_sweep_fwd.launches == before + 1
    want = tadj.torch_adjoint_sweep_fwd(c_all, x, mt, norms, **kw)
    _, n_row = expmv.scale_rows(c_all[:, None], norms, theta, 16)
    assert int(n_row.max()) > 1
    assert chip_smoke.rel(y, want) <= chip_smoke.adj_tolerances(dtype)[0]
    shape = tadj.sweep_plan(B, D, x.element_size())
    assert shape["plan"] == ("panel" if D == 512 else "single" if (
        D == 128 and dtype == torch.float64) else "double"), shape


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("D", [8, 128, 512])
def test_adjoint_sweep_fwd_keeps_a_nan_row(card, D, dtype):
    """A NaN state row stays in its row of K7's result, the other rows agree
    with the twin, and two launches give the same bits."""
    W, _, c_all, x, _ = chip_smoke.adjoint_case(40, D, 3, 3, dtype, 5, 0.4)
    x[9, 1] = float("nan")
    mt, _, norms = chip_smoke.adj_operands(W)
    m, theta = _taylor_params(dtype)
    kw = dict(m=m, theta=theta, max_squarings=16)
    y = tadj.adjoint_sweep_fwd(c_all, x, mt, norms, **kw)
    bad = torch.isnan(y).any(1)
    assert bad.tolist() == [r == 9 for r in range(40)]
    assert bool(torch.isnan(y[9]).all())
    want = tadj.torch_adjoint_sweep_fwd(c_all, x, mt, norms, **kw)
    assert chip_smoke.rel(y[~bad], want[~bad]) <= \
        chip_smoke.adj_tolerances(dtype)[0]
    again = tadj.adjoint_sweep_fwd(c_all, x, mt, norms, **kw)
    assert torch.equal(torch.nan_to_num(again), torch.nan_to_num(y))


# K8 over formed exponents: (B, D, K') reaching each plan and tile (the
# exponent in shared memory at D <= 128, panels at 512, a wide block at
# 512 with K' >= 4; 1 to 32 trajectories a block, 1, 2 or 4 rows a
# thread, 1, 2 or 4 contraction groups)
BWD_CASES = [(1, 8, 1), (5, 8, 6), (256, 8, 2), (4096, 8, 6), (5, 18, 3),
             (256, 18, 5), (4096, 18, 4), (1, 64, 2), (256, 64, 3),
             (4096, 64, 6), (1, 128, 1), (5, 128, 4), (256, 128, 3),
             (256, 128, 6), (4096, 128, 3), (4096, 128, 6), (1, 512, 1),
             (5, 512, 3), (5, 512, 4), (5, 512, 6), (256, 512, 2)]


def _bwd_case(B, D, Kp, dtype, seed):
    W, _, c_all, x, a = chip_smoke.adjoint_case(B, D, Kp, 4, dtype, seed,
                                                0.4)
    mt, ms, norms = chip_smoke.adj_operands(W)
    m, theta = _taylor_params(dtype)
    return (c_all, x, a, mt, ms, norms), dict(m=m, theta=theta,
                                              max_squarings=16)


def _bwd_tolerances(dtype):
    """K8 against its twin: f64 a0 and cbar to summation order (FMA chains
    in the kernel, BLAS in the twin), relative to the largest entry; f32
    as check_adjoint_case."""
    return (1e-12, 1e-12) if dtype == torch.float64 else \
        chip_smoke.adj_tolerances(dtype)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("B,D,Kp", BWD_CASES)
def test_adjoint_sweep_bwd_matches_twin(card, B, D, Kp, dtype):
    """K8 against torch_adjoint_sweep_bwd on rows that need squarings, its
    partials' block count the plan mirror's (ops/adjoint.py:bwd_plan on
    this card)."""
    args, kw = _bwd_case(B, D, Kp, dtype, 13 + Kp)
    before = tadj.adjoint_sweep_bwd.launches
    a0, cb = tadj.adjoint_sweep_bwd(*args, **kw)
    assert tadj.adjoint_sweep_bwd.launches == before + 1
    a0p, cbp = tadj.torch_adjoint_sweep_bwd(*args, **kw)
    _, n_row = expmv.scale_rows(args[0][:, None], args[-1], kw["theta"], 16)
    assert int(n_row.max()) > 1
    tol, cb_tol = _bwd_tolerances(dtype)
    assert chip_smoke.rel(a0, a0p) <= tol
    assert chip_smoke.rel(cb, cbp) <= cb_tol
    props = torch.cuda.get_device_properties(0)
    shape = tadj.bwd_plan(B, D, Kp, a0.element_size(),
                          n_sm=props.multi_processor_count,
                          max_smem=getattr(props,
                                           "shared_memory_per_block_optin",
                                           232448))
    assert shape["plan"] == ("panel" if D == 512 else "buffer"), shape
    assert tadj._kernel_lib().vec_ode_adjoint_blocks(
        B, D, Kp, a0.element_size()) == shape["blocks"]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("D", [8, 128, 512])
def test_adjoint_sweep_bwd_keeps_a_nan_row(card, D, dtype):
    """A NaN state row reaches only cbar (all NaN: it sums the batch); a
    NaN cotangent row stays in its row of a0; the other rows agree with
    the twin, on both plans."""
    args, kw = _bwd_case(40, D, 3, dtype, 5)
    c_all, x, a, mt, ms, norms = args
    tol, _ = _bwd_tolerances(dtype)
    xn = x.clone()
    xn[9, 1] = float("nan")
    a0, cb = tadj.adjoint_sweep_bwd(c_all, xn, a, mt, ms, norms, **kw)
    a0p, _ = tadj.torch_adjoint_sweep_bwd(c_all, xn, a, mt, ms, norms, **kw)
    assert bool(torch.isfinite(a0).all()) and bool(torch.isnan(cb).all())
    assert chip_smoke.rel(a0, a0p) <= tol
    an = a.clone()
    an[3, 0] = float("nan")
    a0, _ = tadj.adjoint_sweep_bwd(c_all, x, an, mt, ms, norms, **kw)
    a0p, _ = tadj.torch_adjoint_sweep_bwd(c_all, x, an, mt, ms, norms, **kw)
    bad = torch.isnan(a0).any(1)
    assert bad.tolist() == [r == 3 for r in range(40)]
    assert chip_smoke.rel(a0[~bad], a0p[~bad]) <= tol

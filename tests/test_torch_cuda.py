"""The hand-written CUDA kernel of the port against its plain torch twin,
on a CUDA card. Every test here carries the ``cuda`` marker and skips
without a card. The file imports no jax, so on a machine with a card but
without jax it runs as

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from chip_smoke import err_norm_limit
from vec_ode_tpu_torch import DONE, StepControl, tableaus as ttab
from vec_ode_tpu_torch.models import DrivenDense
from vec_ode_tpu_torch.ops.cplx import Cplx, from_complex
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
    """The main path at a small size in f64: the kernel-driven solve on
    the card against the plain-step solve on the CPU."""
    model = DrivenDense.make(d=16, seed=0)
    rng = np.random.default_rng(42)
    psi = rng.standard_normal((300, 16)) + 1j * rng.standard_normal((300, 16))
    psi /= np.linalg.norm(psi, axis=-1, keepdims=True)
    ctl = StepControl(rtol=1e-8, min_dt=1e-6, max_dt=0.25)
    sols = {}
    for dev in ("cpu", "cuda"):
        st = FusedModulatedLinearRK.from_driven_dense(model, torch.float64,
                                                      device=dev)
        before = fused_rk_step.launches
        sols[dev] = ensemble_solve(
            None, from_complex(psi, torch.float64, device=dev), 0.0, 1.0,
            stepper=st, ctl=ctl, h0=1e-3, save_at=(0.5,))
        launched = fused_rk_step.launches - before
        if dev == "cuda":
            assert launched == int(sols[dev].n_iters.max())
            assert sols[dev].path == "torch-driver+cuda-step"
        else:
            assert launched == 0 and sols[dev].path == "torch-driver"
    cpu, gpu = sols["cpu"], sols["cuda"]
    assert bool((gpu.status == DONE).all())
    for k in ("status", "n_accept", "n_reject", "n_iters"):
        assert torch.equal(getattr(gpu, k).cpu(), getattr(cpu, k)), k
    for part in ("re", "im"):
        np.testing.assert_allclose(getattr(gpu.ys, part).cpu().numpy(),
                                   getattr(cpu.ys, part).numpy(), rtol=0,
                                   atol=1e-10)

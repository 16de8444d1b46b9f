"""FSAL slope reuse in the port (``rk.rk_step_fsal`` and the driver's
stepper carry), the cases of ``tests/test_fsal.py`` against the JAX
package in f64 on the same inputs: an FSAL tableau advancing the b
solution takes the steps of the same stepper with every stage evaluated
(counters equal, states bitwise equal, through rejects and save-grid
hits, on the scalar carry and the vmapped tier), ``n_rhs_evals`` drops to
1 + (s - 1) attempts, and both agree with the JAX package's FSAL solve
(``test_torch_rk.assert_same_solution``). ``time_compensated=False``
pins the bitwise identity, as the JAX tests do: the cached last stage
was evaluated at t + 1.0 dt."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

import vec_ode_tpu as vo
from vec_ode_tpu.models import VanDerPol as JVanDerPol
from vec_ode_tpu.parallel import ensemble_solve as jensemble_solve
import vec_ode_tpu_torch as vt
from vec_ode_tpu_torch.models import VanDerPol
from vec_ode_tpu_torch.parallel import ensemble_solve
from vec_ode_tpu_torch.rk import rk_step_fsal, rk_step_stages

from test_torch_rk import assert_same_solution

torch.set_num_threads(1)

F64 = torch.float64
TABS = {"dopri5": (vt.DOPRI5, vo.DOPRI5, 7), "bosh32": (vt.BOSH32, vo.BOSH32,
                                                         4)}


def _stiffish(lib):
    # nonlinear with varying scales: accepts and rejects
    return lambda t, y: lib.stack([y[1], -25.0 * y[0] - 2.0 * y[1]
                                   + lib.sin(3.0 * t)])


def _ctl(mod, **kw):
    return mod.StepControl(rtol=1e-7, min_dt=1e-7, max_dt=0.5,
                           max_steps=5000, time_compensated=False, **kw)


@pytest.mark.parametrize("name", sorted(TABS))
def test_fsal_tableau_detection(name):
    tt, jt, _ = TABS[name]
    assert tt.is_fsal and jt.is_fsal
    assert not vt.RKF45.is_fsal
    st = vt.RungeKutta(tt, advance_lower=False)
    assert st.use_fsal and st.has_carry and st.nfev_init == 1
    off = vt.RungeKutta(tt, advance_lower=False, fsal=False)
    assert not off.use_fsal and not off.has_carry and off.nfev_init == 0


@functools.cache
def _jax_fsal(name, save_at=None):
    _, jt, _ = TABS[name]
    return vo.solve_ivp(_stiffish(jnp), 0.0, 3.0, jnp.asarray([1.0, 0.0]),
                        stepper=vo.RungeKutta(jt, advance_lower=False),
                        ctl=_ctl(vo), save_at=save_at)


@pytest.mark.parametrize("name", sorted(TABS))
def test_fsal_trajectory_identical_and_nfev(name):
    tt, _, s = TABS[name]
    y0 = torch.tensor([1.0, 0.0], dtype=F64)
    kw = dict(ctl=_ctl(vt))
    plain = vt.solve_ivp(_stiffish(torch), 0.0, 3.0, y0, stepper=vt.RungeKutta(
        tt, advance_lower=False, fsal=False), **kw)
    fsal = vt.solve_ivp(_stiffish(torch), 0.0, 3.0, y0,
                        stepper=vt.RungeKutta(tt, advance_lower=False), **kw)
    assert int(fsal.status) == int(plain.status) == vt.DONE
    for k in ("n_accept", "n_reject", "n_iters", "y_final", "h_final"):
        assert torch.equal(getattr(fsal, k), getattr(plain, k)), k
    if name == "dopri5":   # BOSH32's smaller steps never reject here
        assert int(plain.n_reject) > 0, "rejects not exercised"
    attempts = int(fsal.n_accept + fsal.n_reject)
    assert int(fsal.n_rhs_evals) == 1 + (s - 1) * attempts
    assert int(plain.n_rhs_evals) == s * attempts
    assert_same_solution(fsal, _jax_fsal(name))


def test_fsal_step_reuses_the_carry():
    """rk_step_fsal is rk_step_stages with K[0] from the carry; its new
    carry is the last stage f(t + dt, x_b)."""
    f = _stiffish(torch)
    t, dt = torch.tensor(0.3, dtype=F64), torch.tensor(0.05, dtype=F64)
    x = torch.tensor([0.4, -0.2], dtype=F64)
    x_b, err, k1 = rk_step_fsal(f, t, x, dt, vt.DOPRI5, f(t, x))
    x_ref, err_ref, K, _ = rk_step_stages(f, t, x, dt, vt.DOPRI5,
                                          advance_lower=False)
    assert torch.equal(x_b, x_ref) and torch.equal(err, err_ref)
    assert torch.equal(k1, K[-1])
    torch.testing.assert_close(k1, f(t + dt, x_b), rtol=0, atol=1e-15)


def test_fsal_accuracy_vs_closed_form():
    A = np.array([[-1.0, 0.4], [0.0, -2.0]])
    At = torch.as_tensor(A)
    sol = vt.solve_ivp(lambda t, y: At @ y, 0.0, 2.0,
                       torch.tensor([1.0, 1.0], dtype=F64),
                       stepper=vt.RungeKutta(vt.DOPRI5, advance_lower=False),
                       ctl=vt.StepControl(rtol=1e-9, min_dt=1e-8, max_dt=0.5))
    assert int(sol.status) == vt.DONE
    np.testing.assert_allclose(sol.y_final.numpy(),
                               scipy.linalg.expm(2.0 * A) @ [1.0, 1.0],
                               rtol=1e-7)


@functools.cache
def _y0_ensemble():
    return np.random.default_rng(0).uniform(-2, 2, (8, 2))


@functools.cache
def _jax_ensemble():
    return jensemble_solve(JVanDerPol(mu=1.0).rhs,
                           jnp.asarray(_y0_ensemble()), 0.0, 4.0,
                           stepper=vo.RungeKutta(vo.DOPRI5,
                                                 advance_lower=False),
                           ctl=_ctl(vo))


def test_fsal_under_the_vmapped_tier():
    m = VanDerPol(mu=1.0)
    y0 = torch.as_tensor(_y0_ensemble())
    fsal = ensemble_solve(m.rhs, y0, 0.0, 4.0,
                          stepper=vt.RungeKutta(vt.DOPRI5,
                                                advance_lower=False),
                          ctl=_ctl(vt))
    plain = ensemble_solve(m.rhs, y0, 0.0, 4.0,
                           stepper=vt.RungeKutta(vt.DOPRI5,
                                                 advance_lower=False,
                                                 fsal=False),
                           ctl=_ctl(vt))
    assert (fsal.status == vt.DONE).all()
    for k in ("n_accept", "n_reject", "y_final"):
        assert torch.equal(getattr(fsal, k), getattr(plain, k)), k
    assert_same_solution(fsal, _jax_ensemble())


def test_fsal_misuse_raises():
    with pytest.raises(ValueError, match="FSAL"):
        vt.RungeKutta(vt.RKF45, fsal=True)
    with pytest.raises(ValueError, match="FSAL"):
        vt.RungeKutta(vt.DOPRI5, advance_lower=True, fsal=True)
    with pytest.raises(ValueError, match="FSAL"):
        vo.RungeKutta(vo.RKF45, fsal=True).use_fsal


def test_fsal_grid_hitting_save_at():
    """The carry survives grid-hit iterations untouched."""
    y0 = torch.tensor([1.0, 0.0], dtype=F64)
    save = (0.7, 1.3)
    kw = dict(save_at=list(save), ctl=_ctl(vt))
    fsal = vt.solve_ivp(_stiffish(torch), 0.0, 3.0, y0,
                        stepper=vt.RungeKutta(vt.DOPRI5, advance_lower=False),
                        **kw)
    plain = vt.solve_ivp(_stiffish(torch), 0.0, 3.0, y0,
                         stepper=vt.RungeKutta(vt.DOPRI5, advance_lower=False,
                                               fsal=False), **kw)
    assert int(fsal.status) == vt.DONE
    assert torch.equal(fsal.ys, plain.ys)
    assert_same_solution(fsal, _jax_fsal("dopri5", save))

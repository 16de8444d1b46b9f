"""Dense output in the port's host driver on the CPU (``dense.py``:
the cubic-Hermite helpers, ``integrate_interp`` and the batched dense
fallback of ``parallel.ensemble_solve(dense=True)``), against the JAX
package in f64 on the same numpy inputs: counters equal per trajectory,
states and dense ``ys`` within 1e-12. The loop kernel's dense output:
tests/test_torch_loop_events.py."""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vec_ode_tpu as vo
from vec_ode_tpu import dense as jdense
from vec_ode_tpu import exp as vexp
from vec_ode_tpu.models import DrivenDense as JDrivenDense
from vec_ode_tpu.ops import cplx as jcp
from vec_ode_tpu.ops.pallas_rk import FusedModulatedLinearRK as JStepper
from vec_ode_tpu.parallel import ensemble_solve as jensemble_solve
import vec_ode_tpu_torch as vt
from vec_ode_tpu_torch import convert, lc
from vec_ode_tpu_torch import dense as tdense
from vec_ode_tpu_torch import exp as texp
from vec_ode_tpu_torch.models import DrivenDense
from vec_ode_tpu_torch.ops import cplx as tcp
from vec_ode_tpu_torch.parallel import ensemble_solve

torch.set_num_threads(1)

D, B, TF = 4, 6, 1.5
SAVE_AT = (0.1, 0.35, 0.8, 1.2)
RK_CTL = dict(rtol=1e-8, min_dt=1e-6, max_dt=0.25)
EXP_CTL = dict(rtol=1e-6, min_dt=1e-6, max_dt=0.25)


@functools.cache
def _psi():
    rng = np.random.default_rng(42)
    psi = rng.standard_normal((B, D)) + 1j * rng.standard_normal((B, D))
    return psi / np.linalg.norm(psi, axis=-1, keepdims=True)


@functools.cache
def _model():
    return JDrivenDense.make(d=D, seed=0)


def _steppers(name):
    """(JAX stepper, port stepper, ctl, port path) on the per-step path."""
    m = _model()
    if name == "rk":
        jst = JStepper.from_driven_dense(m, jnp.float64)
        M0, M1 = np.asarray(jst.M0), np.asarray(jst.M1)
        return (dataclasses.replace(jst, use_pallas=False),
                convert.stepper_from_numpy(M0, M1, m.w, device="cpu"),
                RK_CTL, "torch-driver-dense")
    jmod = m.modulated(jnp.float64)
    ext = np.asarray(vexp.MagnusModulated4(jmod, use_pallas=False)
                     ._ext_basis_w)
    tmod = convert.modulated_from_numpy(
        np.asarray(jmod.basis.re), np.asarray(jmod.basis.im),
        DrivenDense.make(d=D, seed=0).modulated(torch.float64,
                                                device="cpu").form,
        dtype=torch.float64, device="cpu", ext_basis_w=ext)
    return (vexp.MagnusModulated4(jmod, use_pallas=False),
            texp.MagnusModulated4(dataclasses.replace(tmod, form=None)),
            EXP_CTL, "torch-driver-dense")


@pytest.mark.parametrize("name", ["rk", "magnus4"])
def test_dense_fallback_matches_jax(name):
    """ensemble_solve(dense=True) on the per-step path: the host driver's
    integrate_interp with Hermite slopes from hermite_slope (RK) or the
    operator (Magnus-4), against the JAX package's dense fallback."""
    jst, tst, ctl, path = _steppers(name)
    want = jensemble_solve(
        None, jcp.from_complex(_psi(), jnp.float64), 0.0, TF, stepper=jst,
        ctl=vo.StepControl(**ctl), h0=1e-3, save_at=SAVE_AT, dense=True,
        time_dtype=jnp.float64)
    assert want.path == "xla-driver-dense"
    sol = ensemble_solve(
        None, tcp.from_complex(_psi(), torch.float64, device="cpu"), 0.0,
        TF, stepper=tst, ctl=vt.StepControl(**ctl), h0=1e-3,
        save_at=SAVE_AT, dense=True, time_dtype=torch.float64)
    assert sol.path == path
    for k in ("status", "n_accept", "n_reject", "n_iters"):
        np.testing.assert_array_equal(getattr(sol, k).numpy(),
                                      np.asarray(getattr(want, k)), err_msg=k)
    for p in ("re", "im"):
        np.testing.assert_allclose(getattr(sol.ys, p).numpy(),
                                   np.asarray(getattr(want.ys, p)), rtol=0,
                                   atol=1e-12)
        np.testing.assert_allclose(getattr(sol.y_final, p).numpy(),
                                   np.asarray(getattr(want.y_final, p)),
                                   rtol=0, atol=1e-12)
    np.testing.assert_array_equal(sol.ts.numpy(), np.asarray(want.ts))
    assert (sol.status == vt.DONE).all()


@pytest.mark.parametrize("name", ["rk", "magnus4"])
def test_dense_leaves_the_step_sequence(name):
    """Save times do not truncate steps: the dense solve takes the steps
    of a solve without them, and its first and last slots are x0 and the
    final state."""
    _, tst, ctl, _ = _steppers(name)
    y0 = tcp.from_complex(_psi(), torch.float64, device="cpu")
    kw = dict(stepper=tst, ctl=vt.StepControl(**ctl), h0=1e-3,
              time_dtype=torch.float64)
    dense = ensemble_solve(None, y0, 0.0, TF, save_at=SAVE_AT, dense=True,
                           **kw)
    plain = ensemble_solve(None, y0, 0.0, TF, **kw)
    hit = ensemble_solve(None, y0, 0.0, TF, save_at=SAVE_AT, **kw)
    # (h_final differs: a grid hit at tf restores the step before its
    # truncation, the dense driver keeps the controller's)
    for k in ("n_accept", "n_reject", "t_final"):
        assert torch.equal(getattr(dense, k), getattr(plain, k)), k
    # the grid-hitting driver spends one iteration on t0, the dense one
    # none (dense._dense_step)
    assert torch.equal(dense.n_iters + 1, plain.n_iters)
    assert (hit.n_iters > dense.n_iters).all()
    assert torch.equal(dense.y_final.re, plain.y_final.re)
    assert torch.equal(dense.ys.re[:, 0], y0.re)
    assert torch.equal(dense.ys.re[:, -1], dense.y_final.re)
    # the interpolant agrees with the grid-hitting saves to the tolerance
    assert (dense.ys.re - hit.ys.re).abs().max() < 1e-6


def test_hermite_cubic_is_exact_for_cubics():
    def p(t):
        return 1 + 2 * t - t**2 + 0.5 * t**3

    def dp(t):
        return 2 - 2 * t + 1.5 * t**2

    dt = 0.7
    for theta in (0.0, 0.3, 0.5, 0.9, 1.0):
        got = tdense.hermite_cubic(
            *(torch.tensor(v, dtype=torch.float64) for v in
              (p(0.0), p(dt), dp(0.0), dp(dt), dt, theta)))
        np.testing.assert_allclose(float(got), p(theta * dt), rtol=1e-14)


def test_hermite_from_endpoints_matches_jax():
    """All slots in one batch, a never-crossed slot (t_entry = inf) and a
    NaN endpoint behind it come back zero, as in the JAX package."""
    rng = np.random.default_rng(7)
    n, nb, Dw = 3, 5, 6
    t_eval = np.array([0.2, 0.5, 0.9])
    td = t_eval[None, :] - rng.uniform(0.0, 0.1, (nb, n))
    dtd = rng.uniform(0.1, 0.2, (nb, n))
    td[1, 2] = np.inf
    x0 = rng.standard_normal((n, nb, Dw))
    x1 = rng.standard_normal((n, nb, Dw))
    x1[2, 1] = np.nan
    A = rng.standard_normal((Dw, Dw))

    def jslope(t, xw):
        return (xw @ jnp.asarray(A).T) * jnp.cos(t)[:, None]

    def tslope(t, xw):
        return (xw @ torch.as_tensor(A).T) * torch.cos(t)[:, None]

    want = jdense.hermite_from_endpoints(jnp.asarray(t_eval), jnp.asarray(td),
                                         jnp.asarray(dtd), jnp.asarray(x0),
                                         jnp.asarray(x1), jslope)
    got = tdense.hermite_from_endpoints(
        torch.as_tensor(t_eval), torch.as_tensor(td), torch.as_tensor(dtd),
        torch.as_tensor(x0), torch.as_tensor(x1), tslope)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-14)
    assert (got[2, 1] == 0).all() and torch.isfinite(got).all()


def _heun_euler(rhs, backend):
    """An embedded Heun-Euler step with its Hermite slopes, batched,
    written for one backend's arrays (torch or jax.numpy)."""

    def step(t, x, dt):
        dtc = dt[:, None]
        k1 = rhs(t, x, backend)
        k2 = rhs(t + dt, x + dtc * k1, backend)
        xn = x + dtc * 0.5 * (k1 + k2)
        return xn, dtc * 0.5 * (k2 - k1), (k1, rhs(t + dt, xn, backend))

    return step


def _stiff(t, y, backend):
    return -50.0 * (y * y * y)


def _blow_up(t, y, backend):
    return y * y


def _interp_both(rhs, y0, grid, h0, ctl):
    import jax

    jsol = jdense.integrate_interp(
        _heun_euler(rhs, jnp), jnp.asarray(y0), jnp.asarray(grid), h0,
        ctl=vo.StepControl(**ctl),
        error_norm=jax.vmap(vo.lc.norm_l2), batch_shape=(len(y0),))
    tsol = tdense.integrate_interp(
        _heun_euler(rhs, torch), torch.as_tensor(y0),
        torch.tensor(grid, dtype=torch.float64), h0,
        ctl=vt.StepControl(**ctl),
        error_norm=lc.norm_l2_batched, batch_shape=(len(y0),))
    for k in ("status", "n_accept", "n_reject", "n_iters"):
        np.testing.assert_array_equal(getattr(tsol, k).numpy(),
                                      np.asarray(getattr(jsol, k)), err_msg=k)
    np.testing.assert_allclose(tsol.ys.numpy(), np.asarray(jsol.ys), rtol=0,
                               atol=1e-12)
    return tsol


def test_slot0_survives_a_first_step_that_overflows():
    """A first trial whose stages overflow must not poison ys[:, 0]: slot
    0 records x0 directly, not through the interpolant (0 * inf)."""
    y0 = np.array([[1.0, 2.0], [0.5, 3.0]])
    sol = _interp_both(_stiff, y0, [0.0, 0.5, 1.0], 1.0,
                       dict(rtol=1e-6, min_dt=1e-9, max_dt=1.0,
                            max_steps=10000))
    assert (sol.status == vt.DONE).all()
    assert (sol.n_reject > 0).all()
    assert torch.equal(sol.ys[:, 0], torch.as_tensor(y0))
    assert torch.isfinite(sol.ys).all()


def test_failed_lane_keeps_its_unreached_final_slot():
    """A lane that fails mid-run does not report its last state as y(tf):
    its final slot keeps what was recorded (zero, never reached)."""
    y0 = np.array([[0.1], [3.0]])      # lane 1 blows up before tf
    sol = _interp_both(_blow_up, y0, [0.0, 0.9], 1e-3,
                       dict(rtol=1e-6, min_dt=1e-6, max_dt=0.5,
                            max_steps=300))
    assert sol.status[0] == vt.DONE and sol.status[1] != vt.DONE
    assert torch.equal(sol.ys[0, -1], sol.y_final[0])
    assert (sol.ys[1, -1] == 0).all()
    assert not torch.equal(sol.ys[1, -1], sol.y_final[1])


def test_dense_with_events_needs_the_loop():
    """dense=True with events on a path the loop kernel does not take
    raises the JAX package's ValueError; a generic exponential stepper
    has no Hermite slope and raises too."""
    _, tst, ctl, _ = _steppers("rk")
    y0 = tcp.from_complex(_psi(), torch.float64, device="cpu")
    ev = vt.EventConfig(events=(vt.Event(vt.LinearObservable(
        w=np.eye(2 * D)[3])),))
    with pytest.raises(ValueError, match="events="):
        ensemble_solve(None, y0, 0.0, TF, stepper=tst, h0=1e-3,
                       save_at=SAVE_AT, dense=True, events=ev,
                       time_dtype=torch.float64)
    m = _model()
    with pytest.raises(ValueError, match="hermite_slope"):
        ensemble_solve(convert.driven_op_from_numpy(m.H0, m.V, m.w,
                                                    device="cpu"),
                       y0, 0.0, TF, stepper=texp.Magnus4(texp.DenseCplxSplit()),
                       h0=1e-2, save_at=SAVE_AT, dense=True,
                       time_dtype=torch.float64)

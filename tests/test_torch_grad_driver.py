"""Gradients through the port's driver (``diff.solve_for_grad``,
``grad_terminal``, ``value_and_grad_terminal``: autograd through the scan
driver) against ``jax.grad`` of the JAX package's, in f64 on the same
inputs, within 1e-10 (but where the problem itself moves the values
further, see ``TOL``): the cases of ``tests/test_treeverse.py:56``,
``:73`` and ``:88`` (Van der Pol and Lotka-Volterra with grad_safe, and
overflowing rejected trials that NaN the gradient without grad_safe and
not with it) at tight ``max_steps``, ``tests/test_aux.py:57`` and ``:86``
(fixed steps, ``remat=True``) and Magnus-4 through ``solve_linear``
(``tests/test_exp_solvers.py:317``)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vec_ode_tpu as vo
from vec_ode_tpu import diff as jdiff
from vec_ode_tpu import exp as vexp
from vec_ode_tpu.rk import rk_step as j_rk_step
import vec_ode_tpu_torch as vt
from vec_ode_tpu_torch import diff as tdiff
from vec_ode_tpu_torch import exp as texp
from vec_ode_tpu_torch.rk import rk_step

torch.set_num_threads(1)

F64 = torch.float64


def _side(side):
    if side == "jax":
        return dict(vo=vo, diff=jdiff, stack=jnp.stack, sum=jnp.sum,
                    arr=lambda a: jnp.asarray(np.asarray(a, np.float64)),
                    rk_step=j_rk_step, exp=vexp, sin=jnp.sin, kw={})
    return dict(vo=vt, diff=tdiff, stack=torch.stack, sum=torch.sum,
                arr=lambda a: torch.as_tensor(np.asarray(a, np.float64)),
                rk_step=rk_step, exp=texp, sin=torch.sin,
                kw=dict(device="cpu"))


def _vdp(S):
    def factory(mu):
        return S["vo"].RungeKutta().make_step_fn(
            lambda t, y: S["stack"]([y[1], mu * (1 - y[0] ** 2) * y[1]
                                     - y[0]]))

    return factory


def _lv(S):
    # tests/test_treeverse.py's stiff-ish Lotka-Volterra, its two rates a
    # pytree of parameters
    def factory(p):
        return S["vo"].RungeKutta().make_step_fn(
            lambda t, y: S["stack"]([p["a"] * y[0] - p["b"] * y[0] * y[1],
                                     -4.0 * y[1] + 1.5 * y[0] * y[1]]))

    return factory


def _overflow(S):
    def factory(a):
        return S["vo"].RungeKutta().make_step_fn(lambda t, y: a * y ** 2)

    return factory


# name -> (factory, loss, y0, (t0, tf, h0), ctl, params, grad_safe)
CASES = {
    "vdp": (_vdp, lambda S: lambda yf: S["sum"](yf ** 2), [2.0, 0.0],
            (0.0, 6.0, 0.5),
            dict(rtol=1e-6, min_dt=1e-9, max_dt=2.0, max_steps=128), 3.0,
            None),
    "lotka_volterra": (
        _lv, lambda S: lambda yf: S["sum"]((yf - 1.0) ** 2), [1.0, 1.0],
        (0.0, 3.0, 0.1),
        dict(rtol=1e-6, min_dt=1e-9, max_dt=1.0, max_steps=150),
        {"a": 6.0, "b": 2.0}, None),
    # h0 = max_dt = 1e6: the first trials overflow inside the stages
    "overflow_grad_safe": (
        _overflow, lambda S: lambda yf: 1e6 * S["sum"](yf ** 2), [-2.0],
        (0.0, 1e6, 1e6),
        dict(rtol=1e-6, min_dt=1e-9, max_dt=1e6, max_steps=80), 1.0, True),
    "overflow_bare": (
        _overflow, lambda S: lambda yf: 1e6 * S["sum"](yf ** 2), [-2.0],
        (0.0, 1e6, 1e6),
        dict(rtol=1e-6, min_dt=1e-9, max_dt=1e6, max_steps=80), 1.0, False),
}


def _value_and_grad(side, name, params=None):
    factory, loss, y0, (t0, tf, h0), ctl, p0, gs = CASES[name]
    S = _side(side)
    vg = S["diff"].value_and_grad_terminal(
        loss(S), factory(S), S["arr"](y0), t0, tf, h0, adaptive=True,
        ctl=S["vo"].StepControl(**ctl), grad_safe=gs, **S["kw"])
    return vg(p0 if params is None else params)


@functools.cache
def _jax_value_and_grad(name):
    v, g = _value_and_grad("jax", name)
    return float(v), jax.tree_util.tree_map(float, g)


# (value, gradient) rtol. The overflowing problem spans twelve decades of
# step size from h0 = 1e6; its step sizes agree to eps / rtol (ROADMAP
# queue 3), which moves the value by 4.0e-10 and the gradient by 2.9e-8
TOL = {"overflow_grad_safe": (1e-9, 1e-7), "overflow_bare": (1e-9, None)}


@pytest.mark.parametrize("name", sorted(CASES))
def test_value_and_grad_terminal_matches_jax(name):
    v, g = _value_and_grad("torch", name)
    jv, jg = _jax_value_and_grad(name)
    v_rtol, g_rtol = TOL.get(name, (1e-12, 1e-10))
    np.testing.assert_allclose(v.item(), jv, rtol=v_rtol)
    if name == "overflow_bare":
        # the documented caveat: rejected trials that overflowed NaN the
        # bare scan's gradient, in both packages
        assert np.isnan(g.item()) and np.isnan(jg)
        return
    got = torch.utils._pytree.tree_map(lambda a: a.item(), g)
    assert jax.tree_util.tree_structure(got) \
        == jax.tree_util.tree_structure(jg)
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(jg)):
        assert np.isfinite(a)
        np.testing.assert_allclose(a, b, rtol=g_rtol)


def test_grad_safe_keeps_the_primal_and_the_rejects():
    """grad_safe changes the gradient only: the same value, status and
    rejected (overflowing) trials as the bare scan."""
    factory, loss, y0, (t0, tf, h0), ctl, p0, _ = CASES["overflow_bare"]
    S = _side("torch")
    sols = [tdiff.solve_for_grad(factory(S), p0, S["arr"](y0), t0, tf, h0,
                                 adaptive=True, ctl=vt.StepControl(**ctl),
                                 grad_safe=gs, device="cpu")
            for gs in (False, True)]
    assert all(int(s.status) == vt.DONE for s in sols)
    assert int(sols[0].n_reject) == int(sols[1].n_reject) > 5
    assert torch.equal(sols[0].y_final, sols[1].y_final)


def test_vdp_gradient_matches_central_differences():
    """tests/test_treeverse.py:56: the grad_safe gradient within 2e-3 of
    central differences (the dropped reject-branch h-shrink terms)."""
    S = _side("torch")
    factory, loss, y0, (t0, tf, h0), ctl, p0, _ = CASES["vdp"]

    def value(mu):
        sol = tdiff.solve_for_grad(factory(S), mu, S["arr"](y0), t0, tf, h0,
                                   adaptive=True, ctl=vt.StepControl(**ctl),
                                   device="cpu")
        return loss(S)(sol.y_final).item()

    _, g = _value_and_grad("torch", "vdp")
    fd = (value(3.0 + 1e-5) - value(3.0 - 1e-5)) / 2e-5
    np.testing.assert_allclose(g.item(), fd, rtol=2e-3)


def _rotation_factory(S):
    """tests/test_aux.py:57: dx/dt = theta [[0, 1], [-1, 0]] x, RKF45."""
    def factory(theta):
        A = S["arr"]([[0.0, 1.0], [-1.0, 0.0]]) * theta

        def step_fn(t, x, dt):
            return S["rk_step"](lambda tt, y: A @ y, t, x, dt,
                                S["vo"].RKF45)

        return step_fn

    return factory


def _decay_factory(S):
    """tests/test_aux.py:86: dx/dt = -theta x."""
    def factory(theta):
        def step_fn(t, x, dt):
            return S["rk_step"](lambda tt, y: -theta * y, t, x, dt,
                                S["vo"].RKF45)

        return step_fn

    return factory


@pytest.mark.parametrize("case", ["rotation", "decay_remat"])
def test_grad_terminal_fixed_steps_matches_jax(case):
    grads = {}
    for side in ("jax", "torch"):
        S = _side(side)
        if case == "rotation":
            g = S["diff"].grad_terminal(
                lambda yf: yf[0], _rotation_factory(S), S["arr"]([1.0, 0.0]),
                0.0, 1.0, 0.05, ctl=S["vo"].StepControl(max_steps=32),
                **S["kw"])(0.7)
        else:
            g = S["diff"].grad_terminal(
                lambda yf: yf, _decay_factory(S), S["arr"](1.0), 0.0, 1.0,
                0.05, ctl=S["vo"].StepControl(max_steps=32), remat=True,
                **S["kw"])(1.3)
        grads[side] = float(g)
    np.testing.assert_allclose(grads["torch"], grads["jax"], rtol=1e-10)
    if case == "decay_remat":
        np.testing.assert_allclose(grads["torch"], -np.exp(-1.3), rtol=1e-6)
    else:
        S = _side("torch")

        def value(th):
            sol = tdiff.solve_for_grad(
                _rotation_factory(S), th, S["arr"]([1.0, 0.0]), 0.0, 1.0,
                0.05, ctl=vt.StepControl(max_steps=32), device="cpu")
            return sol.y_final[0].item()

        fd = (value(0.7 + 1e-6) - value(0.7 - 1e-6)) / 2e-6
        np.testing.assert_allclose(grads["torch"], fd, rtol=1e-6)


def _magnus4_loss(side, theta):
    """tests/test_exp_solvers.py:317: Magnus-4 through solve_linear's scan
    and the matrix exponential's adjoint."""
    S = _side(side)
    B = S["arr"]([[0.1, 0.0], [0.0, -0.1]])
    J = S["arr"]([[0.0, 1.0], [-1.0, 0.0]])

    def op(t):
        return theta * J + S["sin"](t) * B

    sol = S["vo"].solve_linear(
        op, 0.0, 1.0, S["arr"]([1.0, 0.0]),
        stepper=S["exp"].Magnus4(S["exp"].DenseSplit()), h0=0.05,
        method="scan", ctl=S["vo"].StepControl(max_steps=32), **S["kw"])
    return sol.y_final[0]


def test_magnus4_grad_through_solve_linear_matches_jax():
    theta = torch.tensor(0.8, dtype=F64, requires_grad=True)
    (g,) = torch.autograd.grad(_magnus4_loss("torch", theta), theta)
    jg = jax.grad(functools.partial(_magnus4_loss, "jax"))(
        jnp.asarray(0.8, jnp.float64))
    np.testing.assert_allclose(g.item(), float(jg), rtol=1e-10)
    fd = (_magnus4_loss("torch", torch.tensor(0.8 + 1e-6, dtype=F64))
          - _magnus4_loss("torch", torch.tensor(0.8 - 1e-6, dtype=F64))
          ).item() / 2e-6
    np.testing.assert_allclose(g.item(), fd, rtol=1e-5)

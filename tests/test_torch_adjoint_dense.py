"""The port's reversible adjoint for black-box dense operators
(vec_ode_tpu_torch.diff.make_adjoint_dense_solver, adjoint_solve_dense)
against the JAX package's on the same inputs, in f64 on the CPU: value and
gradients (theta, y0, t0, tf) at orders 2, 4 and 6, the forward against
the generic Magnus-4 stepper, a driven qubit (Cplx) against a central
difference, batched states, validation, and the anchored backward on a
dissipative operator against plain autograd through the same rows. No
hand kernel lies on this path (the JAX package's runs XLA's expm)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vec_ode_tpu import diff as jdiff
from vec_ode_tpu.ops.cplx import Cplx as JCplx
from vec_ode_tpu_torch import diff as tdiff
from vec_ode_tpu_torch import solve_linear
from vec_ode_tpu_torch.exp import DenseSplit, Magnus4
from vec_ode_tpu_torch.exp.magnus import _B2, _C_MID, _SUB_LEN, _SUB_OFF
from vec_ode_tpu_torch.ops.cplx import Cplx
from vec_ode_tpu_torch.ops.expm import expm

jax.config.update("jax_enable_x64", True)

F64 = torch.float64
S = np.array([[0.0, 1.0], [-1.0, 0.0]])
N = np.array([[0.0, 1.0], [0.0, 0.0]])
DAMP = np.array([[-12.0, 0.0], [0.0, 0.0]])


def j_op(t, th, damped=False):
    A = th[0] * jnp.asarray(S) + jnp.sin(th[1] * t) * jnp.asarray(N)
    return A + jnp.asarray(DAMP) if damped else A


def t_op(t, th, damped=False):
    A = th[0] * torch.tensor(S) + torch.sin(th[1] * t) * torch.tensor(N)
    return A + torch.tensor(DAMP) if damped else A


THETA, Y0 = np.array([0.8, 1.7]), np.array([1.0, 0.25])


@functools.cache
def _jax_value_grads(order, n_steps, t0, tf, anchor_every=None,
                     damped=False):
    solve = jdiff.make_adjoint_dense_solver(
        lambda t, th: j_op(t, th, damped), n_steps=n_steps, order=order,
        anchor_every=anchor_every)

    def loss(th, y, a, b):
        yf = solve(th, y, a, b)
        return jnp.sum(yf ** 2) + yf[0]

    v, g = jax.value_and_grad(loss, argnums=(0, 1, 2, 3))(
        jnp.asarray(THETA), jnp.asarray(Y0), jnp.float64(t0),
        jnp.float64(tf))
    return float(v), [np.asarray(x) for x in g]


def _leaf(a):
    return torch.tensor(np.asarray(a), dtype=F64, requires_grad=True)


def _port_value_grads(solve, t0, tf):
    args = [_leaf(THETA), _leaf(Y0), _leaf(t0), _leaf(tf)]
    yf = solve(*args)
    v = torch.sum(yf ** 2) + yf[0]
    return float(v.detach()), [g.numpy() for g in
                               torch.autograd.grad(v, args)]


def _close(port, ref, rtol):
    (v, g), (jv, jg) = port, ref
    assert abs(v - jv) <= rtol * abs(jv)
    for a, b in zip(g, jg):
        assert float(np.abs(a - b).max()) <= rtol * float(np.abs(b).max())


@pytest.mark.parametrize("order", [2, 4, 6])
def test_gradient_matches_jax(order):
    """Value and gradients (theta, y0, t0, tf) of the JAX package's
    test_gradient_matches_plain_ad_oracle loss, 24 steps on [0.3, 2.1]:
    held to 1e-10 relative to each gradient's largest entry."""
    solve = tdiff.make_adjoint_dense_solver(t_op, n_steps=24, order=order)
    _close(_port_value_grads(solve, 0.3, 2.1),
           _jax_value_grads(order, 24, 0.3, 2.1), 1e-10)


def test_forward_matches_magnus4_stepper():
    """The adjoint's discrete forward is the Magnus4(DenseSplit()) map of
    solve_linear with fixed steps (rtol 1e-12, as the JAX test)."""
    theta = torch.tensor([1.1, 0.9], dtype=F64)
    y0 = torch.tensor([0.7, -0.2], dtype=F64)
    yf = tdiff.adjoint_solve_dense(t_op, theta, y0, 0.0, 1.5, 16, order=4)
    sol = solve_linear(lambda t: t_op(t, theta), 0.0, 1.5, y0,
                       stepper=Magnus4(DenseSplit()), adaptive=False,
                       h0=1.5 / 16, device="cpu")
    np.testing.assert_allclose(yf.numpy(), sol.y_final.numpy(), rtol=1e-12)


def _qubit_op(pkg):
    if pkg == "jax":
        sx = jnp.asarray([[0.0, 1.0], [1.0, 0.0]])
        sz = jnp.asarray([[1.0, 0.0], [0.0, -1.0]])

        def op(t, th):
            H = sx + th * jnp.cos(2.0 * t) * sz
            return JCplx(jnp.zeros_like(H), -H)
        return op
    sx = torch.tensor([[0.0, 1.0], [1.0, 0.0]], dtype=F64)
    sz = torch.tensor([[1.0, 0.0], [0.0, -1.0]], dtype=F64)

    def op(t, th):
        H = sx + th * torch.cos(2.0 * t) * sz
        return Cplx(torch.zeros_like(H), -H)
    return op


def test_cplx_driven_qubit_grad_fd():
    """H(t) = sx + theta cos(2t) sz, A = -iH as a Cplx: the infidelity's
    gradient against the JAX package's (1e-10) and a central difference
    (rtol 1e-6, as the JAX test); the propagated state stays unit."""
    y0 = Cplx(torch.tensor([1.0, 0.0], dtype=F64),
              torch.zeros(2, dtype=F64))
    op = _qubit_op("torch")

    def loss(th):
        yf = tdiff.adjoint_solve_dense(op, th, y0, 0.0, 2.0, 32, order=4)
        return 1.0 - (yf.re[1] ** 2 + yf.im[1] ** 2)

    th0 = _leaf(0.6)
    (g,) = torch.autograd.grad(loss(th0), th0)
    jy0 = JCplx(jnp.asarray([1.0, 0.0]), jnp.zeros(2))
    jop = _qubit_op("jax")

    def jloss(th):
        yf = jdiff.adjoint_solve_dense(jop, th, jy0, 0.0, 2.0, 32, order=4)
        return 1.0 - (yf.re[1] ** 2 + yf.im[1] ** 2)

    jg = jax.grad(jloss)(jnp.float64(0.6))
    np.testing.assert_allclose(float(g), float(jg), rtol=1e-10)
    eps = 1e-6
    fd = (float(loss(torch.tensor(0.6 + eps, dtype=F64)))
          - float(loss(torch.tensor(0.6 - eps, dtype=F64)))) / (2 * eps)
    np.testing.assert_allclose(float(g), fd, rtol=1e-6, atol=1e-9)
    yf = tdiff.adjoint_solve_dense(op, torch.tensor(0.6, dtype=F64), y0,
                                   0.0, 2.0, 32, order=4)
    norm = float(torch.sqrt(torch.sum(yf.re ** 2 + yf.im ** 2)))
    np.testing.assert_allclose(norm, 1.0, atol=1e-10)


def test_batched_states_broadcast():
    """A leading batch axis of y0 broadcasts against the shared exponents:
    each row as its own solve (rtol 1e-12), and a batched loss's gradient
    against the JAX package's (1e-10)."""
    theta = torch.tensor(THETA, dtype=F64)
    y0b = torch.tensor([[1.0, 0.0], [0.0, 1.0], [0.5, -0.5]], dtype=F64)
    solve = tdiff.make_adjoint_dense_solver(t_op, n_steps=12, order=4)
    yfb = solve(theta, y0b, 0.0, 1.0)
    for i in range(3):
        np.testing.assert_allclose(yfb[i].numpy(),
                                   solve(theta, y0b[i], 0.0, 1.0).numpy(),
                                   rtol=1e-12)
    th = theta.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(torch.sum(solve(th, y0b, 0.0, 1.0) ** 2), th)
    jsolve = jdiff.make_adjoint_dense_solver(j_op, n_steps=12, order=4)
    jg = jax.grad(lambda t: jnp.sum(jsolve(t, jnp.asarray(y0b.numpy()), 0.0,
                                           1.0) ** 2))(jnp.asarray(THETA))
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-10)


def test_order_validation():
    with pytest.raises(ValueError):
        tdiff.make_adjoint_dense_solver(t_op, n_steps=4, order=3)
    with pytest.raises(ValueError):
        tdiff.make_adjoint_dense_solver(t_op, n_steps=4, anchor_every=0)


def _oracle_solver(op_fn, n_steps, order):
    """The same rows through plain autograd (the trajectory kept): expm's
    Fréchet-adjoint backward, O(n_steps) memory."""
    rps = tdiff.rows_per_step(order)

    def omega(theta, t0, tf, r):
        dt = (tf - t0) / n_steps
        if order == 6:
            n, j = divmod(r, rps)
            t_r, dt_r = t0 + n * dt + _SUB_OFF[j] * dt, _SUB_LEN[j] * dt
        else:
            t_r, dt_r = t0 + r * dt, dt
        if order == 2:
            return dt_r * op_fn(t_r + 0.5 * dt_r, theta)
        tm = t_r + 0.5 * dt_r
        A1 = op_fn(tm - _C_MID * dt_r, theta)
        A2 = op_fn(tm + _C_MID * dt_r, theta)
        return 0.5 * dt_r * (A1 + A2) + (_B2 * dt_r * dt_r) * (A1 @ A2
                                                               - A2 @ A1)

    def solve(theta, y0, t0, tf):
        x = y0
        for r in range(n_steps * rps):
            x = torch.einsum("ij,...j->...i", expm(omega(theta, t0, tf, r)),
                             x)
        return x

    return solve


def _damped(t, th):
    return t_op(t, th, damped=True)


@pytest.mark.parametrize("anchor_every", [1, 4, 7])
def test_anchored_gradient_dissipative(anchor_every):
    """anchor_every=k on an anisotropically damped operator (decay spread
    12 over T = 2): the value op for op as the unanchored forward (against
    the JAX package's, 1e-12) and the theta / y0 gradients against the
    JAX package's anchored ones (1e-10) and plain autograd through the
    same rows (rtol 1e-8, as the JAX test)."""
    anchored = tdiff.make_adjoint_dense_solver(
        _damped, n_steps=24, order=4, anchor_every=anchor_every)
    port = _port_value_grads(anchored, 0.0, 2.0)
    jv, jg = _jax_value_grads(4, 24, 0.0, 2.0, anchor_every, True)
    v, g = port
    assert abs(v - jv) <= 1e-12 * abs(jv)
    for a, b in zip(g[:2], jg[:2]):
        assert float(np.abs(a - b).max()) <= 1e-10 * float(np.abs(b).max())
    ov, og = _port_value_grads(_oracle_solver(_damped, 24, 4), 0.0, 2.0)
    np.testing.assert_allclose(v, ov, rtol=1e-12)
    for a, b in zip(g[:2], og[:2]):
        np.testing.assert_allclose(a, b, rtol=1e-8)


def test_unanchored_dissipative_drifts_more_than_anchored():
    """On the same damped operator the plain O(1) sweep's theta gradient is
    orders of magnitude further from plain autograd than the anchored
    one's."""
    _, ref = _port_value_grads(_oracle_solver(_damped, 24, 4), 0.0, 2.0)

    def err(**kw):
        _, g = _port_value_grads(tdiff.make_adjoint_dense_solver(
            _damped, n_steps=24, order=4, **kw), 0.0, 2.0)
        return float(np.linalg.norm(g[0] - ref[0]) / np.linalg.norm(ref[0]))

    e_plain, e_anch = err(), err(anchor_every=2)
    assert e_anch < 1e-9, e_anch
    assert e_plain > 100 * max(e_anch, 1e-14), (e_plain, e_anch)

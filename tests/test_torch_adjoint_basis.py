"""Basis-matrix gradients through the port's reversible adjoint
(vec_ode_tpu_torch.diff.make_adjoint_basis_solver, adjoint_solve(
basis_grad=True)) against the JAX package's on the same numpy inputs, in
f64 on the CPU: the value and the gradients with respect to theta, y0, t0,
tf and the basis, at orders 2, 4 and 6 and over four basis terms (K' = 10
at order 4); through a Cplx basis pair; and the theta / endpoint
cotangents against the port's coefficient-only adjoint. On CPU tensors
the port runs K7's and K6's plain twins."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vec_ode_tpu import diff as jdiff
from vec_ode_tpu.exp.modulated import _real_basis as j_real_basis
from vec_ode_tpu.ops import cplx as jcp
from vec_ode_tpu_torch import diff as tdiff
from vec_ode_tpu_torch.exp.modulated import _real_basis
from vec_ode_tpu_torch.ops.cplx import Cplx

jax.config.update("jax_enable_x64", True)

F64 = torch.float64
D0 = 4  # complex dimension; the real working basis is 8 x 8
N_STEPS = 6


@functools.cache
def _inputs(seed, K):
    """tests/test_adjoint_basis.py's setup: K Hermitian terms as -i H_k,
    three unit states, a weight for the loss, as numpy."""
    rng = np.random.default_rng(seed)
    Hs = rng.standard_normal((K, D0, D0)) + 1j * rng.standard_normal(
        (K, D0, D0))
    Hs = (Hs + np.conj(np.swapaxes(Hs, -1, -2))) / 2
    psi = rng.standard_normal((3, D0)) + 1j * rng.standard_normal((3, D0))
    psi /= np.linalg.norm(psi, axis=-1, keepdims=True)
    y0w = np.concatenate([psi.real, psi.imag], axis=-1)
    w = rng.standard_normal((3, 2 * D0))
    theta = np.array([0.8, -0.3, 0.5, 0.2][:K])
    return Hs.imag, -Hs.real, y0w, w, theta


def _jcoeff(t, th):
    t = jnp.asarray(t)
    return jnp.stack([jnp.ones_like(t) * th[0]]
                     + [th[k] * jnp.sin((2.0 + k) * t)
                        for k in range(1, th.shape[0])])


def _tcoeff(t, th):
    return torch.stack([torch.ones_like(t) * th[0]]
                       + [th[k] * torch.sin((2.0 + k) * t)
                          for k in range(1, th.shape[0])])


@functools.cache
def _jax_basis_grads(seed, K, order, t0, tf):
    """The JAX solver's value and gradients (theta, y0w, t0, tf, W0) of
    sum(w * y_final)."""
    re, im, y0w, w, theta = _inputs(seed, K)
    basis = jcp.Cplx(jnp.asarray(re), jnp.asarray(im))
    solve = jdiff.make_adjoint_basis_solver(basis, _jcoeff, n_steps=N_STEPS,
                                            order=order)
    W0 = j_real_basis(basis)

    def loss(th, y, a, b, W):
        return jnp.sum(jnp.asarray(w) * solve(th, y, a, b, W))

    v, g = jax.value_and_grad(loss, argnums=(0, 1, 2, 3, 4))(
        jnp.asarray(theta), jnp.asarray(y0w), jnp.float64(t0),
        jnp.float64(tf), W0)
    return float(v), [np.asarray(x) for x in g]


def _leaf(a):
    return torch.tensor(np.asarray(a), dtype=F64, requires_grad=True)


def _port_basis_grads(seed, K, order, t0, tf):
    re, im, y0w, w, theta = _inputs(seed, K)
    basis = Cplx(torch.tensor(re), torch.tensor(im))
    solve = tdiff.make_adjoint_basis_solver(basis, _tcoeff, n_steps=N_STEPS,
                                            order=order)
    args = [_leaf(theta), _leaf(y0w), _leaf(t0), _leaf(tf),
            _real_basis(basis).detach().requires_grad_(True)]
    v = torch.sum(torch.tensor(w) * solve(*args))
    return float(v.detach()), [g.numpy() for g in torch.autograd.grad(v,
                                                                      args)]


def _rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


@pytest.mark.parametrize("order,K", [(2, 2), (4, 2), (6, 2), (4, 4)],
                         ids=["order2", "order4", "order6", "order4_K0_4"])
def test_basis_grad_matches_jax(order, K):
    """Value and every gradient (theta, y0, t0, tf, W0) of the basis
    solver against the JAX package's (tests/test_adjoint_basis.py:
    test_basis_grad_matches_direct's inputs; K0 = 4 is four basis terms,
    K' = 10 at order 4): held to 1e-10 relative to each gradient's
    largest entry."""
    v, g = _port_basis_grads(0, K, order, 0.0, 0.7)
    jv, jg = _jax_basis_grads(0, K, order, 0.0, 0.7)
    assert abs(v - jv) <= 1e-10 * abs(jv)
    for a, b, name in zip(g, jg, ("theta", "y0", "t0", "tf", "W0")):
        assert a.shape == b.shape, name
        assert _rel(a, b) <= 1e-10, (name, _rel(a, b))


def test_basis_grad_through_cplx_pair():
    """adjoint_solve(basis_grad=True): gradients with respect to the Cplx
    basis pair flow through the ring embedding; against the JAX package's
    jax.grad of the same loss (1e-10 relative) and a central difference on
    one entry of each part (rtol 1e-5, as the JAX test)."""
    re, im, y0w, w, theta = _inputs(3, 2)

    def tloss(b):
        y0 = Cplx(torch.tensor(y0w[:, :D0]), torch.tensor(y0w[:, D0:]))
        yf = tdiff.adjoint_solve(b, _tcoeff, torch.tensor(theta), y0, 0.0,
                                 0.5, 5, order=4, basis_grad=True)
        return (torch.sum(torch.tensor(w[:, :D0]) * yf.re)
                + torch.sum(torch.tensor(w[:, D0:]) * yf.im))

    def jloss(b):
        y0 = jcp.Cplx(jnp.asarray(y0w[:, :D0]), jnp.asarray(y0w[:, D0:]))
        yf = jdiff.adjoint_solve(b, _jcoeff, jnp.asarray(theta), y0, 0.0, 0.5,
                                 5, order=4, basis_grad=True)
        return (jnp.sum(jnp.asarray(w[:, :D0]) * yf.re)
                + jnp.sum(jnp.asarray(w[:, D0:]) * yf.im))

    b = Cplx(_leaf(re), _leaf(im))
    g = torch.autograd.grad(tloss(b), (b.re, b.im))
    jg = jax.grad(jloss)(jcp.Cplx(jnp.asarray(re), jnp.asarray(im)))
    for a, ref in zip(g, (jg.re, jg.im)):
        assert a.shape == ref.shape
        assert _rel(a.numpy(), np.asarray(ref)) <= 1e-10
    eps = 1e-6
    for i, part in enumerate((re, im)):
        hit = np.zeros_like(part)
        hit[1, 2, 3] = eps
        parts = [re, im]
        parts[i] = part + hit
        lp = float(tloss(Cplx(*(torch.tensor(p) for p in parts))))
        parts[i] = part - hit
        lm = float(tloss(Cplx(*(torch.tensor(p) for p in parts))))
        np.testing.assert_allclose(float(g[i][1, 2, 3]), (lp - lm) / (2 * eps),
                                   rtol=1e-5, atol=1e-7)


def test_basis_grad_endpoint_and_theta_consistency():
    """The basis solver's theta / t0 / tf cotangents (<W_k, Gbar_r> through
    the batched Fréchet adjoint) agree with the coefficient-only adjoint
    make_adjoint_solver (K8's twin): the same discrete scheme, another
    factorisation of the cotangents; rtol 1e-8, as the JAX test."""
    re, im, y0w, w, theta = _inputs(5, 2)
    basis = Cplx(torch.tensor(re), torch.tensor(im))
    adj_b = tdiff.make_adjoint_basis_solver(basis, _tcoeff, n_steps=5,
                                            order=4)
    adj = tdiff.make_adjoint_solver(basis, _tcoeff, n_steps=5, order=4)
    W0 = _real_basis(basis)
    out = []
    for run in (lambda a: adj_b(*a, W0), lambda a: adj(*a)):
        args = [_leaf(theta), torch.tensor(y0w), _leaf(0.1), _leaf(0.9)]
        v = torch.sum(torch.tensor(w) * run(args))
        out.append(torch.autograd.grad(v, [args[0], args[2], args[3]]))
    for b, a, name in zip(*out, ("theta", "t0", "tf")):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-8,
                                   atol=1e-10, err_msg=name)

"""The port's reversible adjoint (vec_ode_tpu_torch.diff) against the JAX
package's (vec_ode_tpu.diff) on the same numpy inputs, in f64 on the CPU:
values and gradients with respect to theta (a tensor and a pytree), the
initial state and both endpoints, for the fixed-step solver at orders 2, 4
and 6, with saves and anchors, over CFM rows, and for the adaptive solver
(status per lane, NaN-poisoned truncation); PulseControl's matrices and
losses; what the port does not take. On CPU tensors the port runs the
kernels' plain twins. Every tolerance is stated beside the difference
measured on this machine."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vec_ode_tpu as vo
from vec_ode_tpu import diff as jdiff
from vec_ode_tpu.models import PulseControl as JPulse
from vec_ode_tpu.ops import cplx as jcp
import vec_ode_tpu_torch as vt
from vec_ode_tpu_torch import convert
from vec_ode_tpu_torch import diff as tdiff
from vec_ode_tpu_torch.models import PulseControl
from vec_ode_tpu_torch.ops.cplx import Cplx

jax.config.update("jax_enable_x64", True)

F64 = torch.float64


def _basis(K, d, seed):
    """A Cplx (K, d, d) basis of -i H, H Hermitian, as numpy (re, im)."""
    rng = np.random.default_rng(seed)
    Hs = rng.standard_normal((K, d, d)) + 1j * rng.standard_normal((K, d, d))
    Hs = 0.5 * (Hs + np.conj(np.swapaxes(Hs, -1, -2)))
    M = -1j * Hs
    return M.real, M.imag


def _pair(re, im):
    return (jcp.Cplx(jnp.asarray(re), jnp.asarray(im)),
            convert.basis_from_numpy(re, im, device="cpu"))


def _states(B, d, seed):
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((B, d)) + 1j * rng.standard_normal((B, d))
    return z / np.linalg.norm(z, axis=-1, keepdims=True)


def _jcoeff(t, th):
    return jnp.stack([jnp.ones_like(jnp.asarray(t)),
                      th[0] * jnp.cos(th[1] * t)], axis=-1)


def _tcoeff(t, th):
    return torch.stack([torch.ones_like(t), th[0] * torch.cos(th[1] * t)],
                       dim=-1)


def _jloss(y):
    return jnp.sum(y.re[..., 0] ** 2) + 0.5 * jnp.sum(y.im[..., 1] ** 2)


def _tloss(y):
    return torch.sum(y.re[..., 0] ** 2) + 0.5 * torch.sum(y.im[..., 1] ** 2)


def _leaf(a):
    return torch.tensor(np.asarray(a), dtype=F64, requires_grad=True)


def _compare(jfn, tfn, theta, z, t0, tf, rtol):
    """Value and the gradients (theta, y0.re, y0.im, t0, tf) of the JAX
    loss jfn(theta, y0, t0, tf) against the port's tfn, theta a dict or an
    array. Returns the largest relative difference."""
    jth = jax.tree_util.tree_map(jnp.asarray, theta)
    v, g = jax.value_and_grad(
        lambda th, yr, yi, a, b: jfn(th, jcp.Cplx(yr, yi), a, b),
        argnums=(0, 1, 2, 3, 4))(jth, jnp.asarray(z.real),
                                 jnp.asarray(z.imag), jnp.float64(t0),
                                 jnp.float64(tf))
    tth = ({k: _leaf(a) for k, a in theta.items()}
           if isinstance(theta, dict) else _leaf(theta))
    args = [_leaf(z.real), _leaf(z.imag), _leaf(t0), _leaf(tf)]
    tv = tfn(tth, Cplx(args[0], args[1]), args[2], args[3])
    leaves = list(tth.values()) if isinstance(tth, dict) else [tth]
    tg = torch.autograd.grad(tv, leaves + args)
    jg = (list(g[0].values()) if isinstance(g[0], dict) else [g[0]]) \
        + list(g[1:])
    tv = float(tv.detach())
    worst = abs(tv - float(v)) / max(abs(float(v)), 1e-300)
    np.testing.assert_allclose(tv, float(v), rtol=rtol)
    for a, b in zip(tg, jg):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=rtol,
                                   atol=rtol * max(1.0, np.abs(b).max()))
        worst = max(worst, float(np.abs(a.numpy() - b).max()
                                 / max(np.abs(b).max(), 1e-300)))
    return worst


@pytest.mark.parametrize("order", [2, 4, 6])
def test_adjoint_solve_matches_jax(order):
    """adjoint_solve at each order, batched Cplx states, theta, y0, t0 and
    tf gradients: measured <= 3e-15 relative, held to 1e-10."""
    jb, tb = _pair(*_basis(2, 3, 1))
    z = _states(3, 3, 2)
    theta = np.array([0.8, 2.5])

    def jfn(th, y, t0, tf):
        return _jloss(jdiff.adjoint_solve(jb, _jcoeff, th, y, t0, tf, 16,
                                          order=order))

    def tfn(th, y, t0, tf):
        return _tloss(tdiff.adjoint_solve(tb, _tcoeff, th, y, t0, tf, 16,
                                          order=order))

    _compare(jfn, tfn, theta, z, 0.2, 1.4, rtol=1e-10)


def test_pytree_theta_and_unbatched_state_match_jax():
    """theta as a dict (coefficients not in the trailing-K form: the rows
    are vmapped) and a single unbatched state; measured <= 2e-15, held to
    1e-10."""
    jb, tb = _pair(*_basis(2, 3, 3))
    z = _states(1, 3, 4)[0]
    theta = {"amp": np.array(0.7), "w": np.array(3.0)}

    def jfn(th, y, t0, tf):
        def cf(t, p):
            return jnp.stack([jnp.ones_like(jnp.asarray(t)),
                              p["amp"] * jnp.sin(p["w"] * t)])
        return _jloss(jdiff.adjoint_solve(jb, cf, th, y, t0, tf, 12))

    def tfn(th, y, t0, tf):
        def cf(t, p):
            return torch.stack([torch.ones_like(t),
                                p["amp"] * torch.sin(p["w"] * t)])
        return _tloss(tdiff.adjoint_solve(tb, cf, th, y, t0, tf, 12))

    _compare(jfn, tfn, theta, z, 0.0, 1.0, rtol=1e-10)


@pytest.mark.parametrize("saves", [(4, 8, 12), (3, 8, 12), (12,)])
def test_saves_match_jax(saves):
    """save_at_steps, uniform, irregular and terminal only: one K7 and one
    K8 segment per save; measured <= 3e-15, held to 1e-10."""
    jb, tb = _pair(*_basis(2, 3, 1))
    z = _states(2, 3, 2)
    theta = np.array([0.8, 2.5])

    def jfn(th, y, t0, tf):
        return _jloss(jdiff.adjoint_solve(jb, _jcoeff, th, y, t0, tf, 12,
                                          save_at_steps=saves))

    def tfn(th, y, t0, tf):
        ys = tdiff.adjoint_solve(tb, _tcoeff, th, y, t0, tf, 12,
                                 save_at_steps=saves)
        assert ys.re.shape == (len(saves), 2, 3)
        return _tloss(ys)

    _compare(jfn, tfn, theta, z, 0.2, 1.4, rtol=1e-10)


def test_saves_validation():
    _, tb = _pair(*_basis(2, 3, 1))
    y0 = Cplx(torch.ones(1, 3, dtype=F64), torch.zeros(1, 3, dtype=F64))
    theta = torch.tensor([0.8, 2.5], dtype=F64)
    for bad in [(0, 4), (4, 4), (5, 3), (9,), ()]:
        with pytest.raises(ValueError, match="save_at_steps"):
            tdiff.adjoint_solve(tb, _tcoeff, theta, y0, 0.0, 1.0, 8,
                                save_at_steps=bad)


def _damped(gamma, seed=0):
    """tests/test_adjoint_anchored.py's damped real basis: a rotation and
    a strong contraction."""
    rng = np.random.default_rng(seed)
    D = 8
    S = rng.standard_normal((D, D))
    W1 = (S - S.T) * 0.7
    W2 = np.diag(-gamma * (0.5 + rng.uniform(0, 1, D)))
    y0w = rng.standard_normal((4, D))
    w = rng.standard_normal((4, D))
    return np.stack([W1, W2]), np.array([1.0, 0.9]), y0w, w


def _damped_grads(gamma, n_steps, anchor_every):
    basis, theta, y0w, w = _damped(gamma)

    def jcf(t, th):
        return jnp.stack([th[0] * jnp.cos(2.0 * t), th[1] * jnp.ones_like(t)])

    def tcf(t, th):
        return torch.stack([th[0] * torch.cos(2.0 * t),
                            th[1] * torch.ones_like(t)])

    jv, jg = jax.value_and_grad(lambda th, y: jnp.sum(jnp.asarray(w) * (
        jdiff.adjoint_solve(jnp.asarray(basis), jcf, th, y, 0.0, 1.0,
                            n_steps, anchor_every=anchor_every))),
        argnums=(0, 1))(jnp.asarray(theta), jnp.asarray(y0w))
    th, y = _leaf(theta), _leaf(y0w)
    tv = torch.sum(torch.as_tensor(w) * tdiff.adjoint_solve(
        torch.as_tensor(basis), tcf, th, y, 0.0, 1.0, n_steps,
        anchor_every=anchor_every))
    tg = torch.autograd.grad(tv, (th, y))
    return (float(jv), [np.asarray(g) for g in jg]), (float(tv), tg)


def test_anchor_every_matches_jax_on_a_damped_basis():
    """anchor_every=8 over 32 steps on the damped basis at gamma = 40
    (the plain sweep loses digits there, in both packages): the port's
    anchored
    gradients equal the JAX package's; measured <= 1e-15, held to 1e-10.
    The anchored primal equals the plain one (gamma = 3)."""
    (jv, jg), (tv, tg) = _damped_grads(40.0, 32, 8)
    np.testing.assert_allclose(tv, jv, rtol=1e-10)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-10,
                                   atol=1e-10 * np.abs(b).max())
    basis, theta, y0w, _ = _damped(3.0)

    def tcf(t, th):
        return torch.stack([th[0] * torch.cos(2.0 * t),
                            th[1] * torch.ones_like(t)])

    args = (torch.as_tensor(basis), tcf, torch.as_tensor(theta),
            torch.as_tensor(y0w), 0.0, 1.0, 32)
    ya = tdiff.adjoint_solve(*args, anchor_every=8)
    yp = tdiff.adjoint_solve(*args)
    np.testing.assert_allclose(ya.numpy(), yp.numpy(), rtol=1e-12,
                               atol=1e-14)


def test_anchor_every_validation():
    basis, theta, y0w, _ = _damped(6.0)
    args = (torch.as_tensor(basis), lambda t, th: torch.stack(
        [th[0] * torch.ones_like(t), th[1] * torch.ones_like(t)]),
        torch.as_tensor(theta), torch.as_tensor(y0w), 0.0, 1.0, 16)
    with pytest.raises(ValueError):
        tdiff.adjoint_solve(*args, anchor_every=0)
    with pytest.raises(ValueError):
        tdiff.adjoint_solve(*args, anchor_every=4, save_at_steps=(8, 16))
    with pytest.raises(ValueError):
        tdiff.adjoint_solve(*args, anchor_every=4, basis_grad=True)


def test_cfm_solver_matches_jax():
    """make_adjoint_cfm_solver (CFM_R4_J2_GL rows on the un-extended
    basis): value and gradients; measured <= 2e-15, held to 1e-10."""
    jb, tb = _pair(*_basis(2, 4, 0))
    z = _states(3, 4, 5)
    theta = np.array([0.7, -0.4])

    def jcf(t, th):
        return jnp.stack([th[0] * jnp.ones_like(t),
                          th[1] * jnp.cos(2.0 * t)], axis=-1)

    def tcf(t, th):
        return torch.stack([th[0] * torch.ones_like(t),
                            th[1] * torch.cos(2.0 * t)], dim=-1)

    jsol = jdiff.make_adjoint_cfm_solver(jb, jcf, n_steps=6,
                                         use_pallas=False)
    tsol = tdiff.make_adjoint_cfm_solver(tb, tcf, n_steps=6)

    def jfn(th, y, t0, tf):
        yw = jsol(th, jnp.concatenate([y.re, y.im], -1), t0, tf)
        return jnp.sum(yw[:, 0] ** 2 + yw[:, 5] * yw[:, 1])

    def tfn(th, y, t0, tf):
        yw = tsol(th, torch.cat([y.re, y.im], -1), t0, tf)
        return torch.sum(yw[:, 0] ** 2 + yw[:, 5] * yw[:, 1])

    _compare(jfn, tfn, theta, z, 0.1, 0.9, rtol=1e-10)


@pytest.mark.parametrize("order", [4, 6])
def test_three_controls_match_jax(order):
    """K = 3 basis terms, a working basis of K' = 6 (the kernels' largest);
    measured <= 3e-15, held to 1e-10."""
    jb, tb = _pair(*_basis(3, 3, 41))
    z = _states(2, 3, 42)
    theta = np.array([0.8, 2.5, -0.6, 1.4])

    def jfn(th, y, t0, tf):
        def cf(t, p):
            t = jnp.asarray(t)
            return jnp.stack([jnp.ones_like(t), p[0] * jnp.cos(p[1] * t),
                              p[2] * jnp.sin(p[3] * t)], axis=-1)
        return _jloss(jdiff.adjoint_solve(jb, cf, th, y, t0, tf, 6,
                                          order=order))

    def tfn(th, y, t0, tf):
        def cf(t, p):
            return torch.stack([torch.ones_like(t), p[0] * torch.cos(p[1] * t),
                                p[2] * torch.sin(p[3] * t)], dim=-1)
        return _tloss(tdiff.adjoint_solve(tb, cf, th, y, t0, tf, 6,
                                          order=order))

    _compare(jfn, tfn, theta, z, 0.0, 1.2, rtol=1e-10)


ADAPTIVE = dict(rtol=1e-7, atol=1e-9, min_dt=1e-7, max_dt=0.4, max_steps=256)


def test_adaptive_matches_jax():
    """adjoint_solve_adaptive (h0 = 0.4 forces rejects, so dt = 0 rows are
    replayed): the same status per lane, value and theta, y0, t0, tf
    gradients; measured <= 6e-15, held to 1e-10."""
    jb, tb = _pair(*_basis(2, 3, 8))
    z = _states(4, 3, 9)
    theta = np.array([0.9, 2.2])
    _, jst = jdiff.adjoint_solve_adaptive(
        jb, _jcoeff, jnp.asarray(theta), jcp.from_complex(z, jnp.float64),
        0.0, 1.0, ctl=vo.StepControl(**ADAPTIVE), h0=0.4, return_status=True)
    _, tst = tdiff.adjoint_solve_adaptive(
        tb, _tcoeff, torch.as_tensor(theta),
        Cplx(torch.as_tensor(z.real), torch.as_tensor(z.imag)), 0.0, 1.0,
        ctl=vt.StepControl(**ADAPTIVE), h0=0.4, return_status=True)
    np.testing.assert_array_equal(tst.numpy(), np.asarray(jst))
    assert (tst == vt.DONE).all()

    def jfn(th, y, t0, tf):
        return _jloss(jdiff.adjoint_solve_adaptive(
            jb, _jcoeff, th, y, t0, tf, ctl=vo.StepControl(**ADAPTIVE),
            h0=0.4))

    def tfn(th, y, t0, tf):
        return _tloss(tdiff.adjoint_solve_adaptive(
            tb, _tcoeff, th, y, t0, tf, ctl=vt.StepControl(**ADAPTIVE),
            h0=0.4))

    _compare(jfn, tfn, theta, z, 0.0, 1.0, rtol=1e-10)


def test_adaptive_truncation_is_loud():
    """Lanes out of max_steps come back NaN, or with ERR_MAX_STEPS under
    return_status=True, per lane as in the JAX package."""
    jb, tb = _pair(*_basis(2, 3, 8))
    z = _states(2, 3, 9)
    theta = np.array([0.9, 2.2])
    kw = dict(rtol=1e-10, atol=1e-12, min_dt=1e-9, max_dt=0.05, max_steps=4)
    y0 = Cplx(torch.as_tensor(z.real), torch.as_tensor(z.imag))
    yf = tdiff.adjoint_solve_adaptive(tb, _tcoeff, torch.as_tensor(theta),
                                      y0, 0.0, 1.0, ctl=vt.StepControl(**kw),
                                      h0=0.05)
    assert bool(torch.isnan(yf.re).all())
    yf2, st = tdiff.adjoint_solve_adaptive(
        tb, _tcoeff, torch.as_tensor(theta), y0, 0.0, 1.0,
        ctl=vt.StepControl(**kw), h0=0.05, return_status=True)
    _, jst = jdiff.adjoint_solve_adaptive(
        jb, _jcoeff, jnp.asarray(theta), jcp.from_complex(z, jnp.float64),
        0.0, 1.0, ctl=vo.StepControl(**kw), h0=0.05, return_status=True)
    np.testing.assert_array_equal(st.numpy(), np.asarray(jst))
    assert bool((st == vt.ERR_MAX_STEPS).all())
    assert bool(torch.isfinite(yf2.re).all())


def test_adaptive_cotangents_keep_their_types():
    """t0 / tf / h0 cotangents carry their own primal types; h0's is 0."""
    _, tb = _pair(*_basis(2, 3, 8))
    z = _states(2, 3, 9)
    y0 = Cplx(torch.as_tensor(z.real), torch.as_tensor(z.imag))
    t0 = torch.tensor(0.0, dtype=torch.float32, requires_grad=True)
    tf = torch.tensor(1.0, dtype=F64, requires_grad=True)
    h0 = torch.tensor(0.2, dtype=F64, requires_grad=True)
    yf = tdiff.adjoint_solve_adaptive(
        tb, _tcoeff, torch.tensor([0.9, 2.2], dtype=F64), y0, t0, tf,
        ctl=vt.StepControl(rtol=1e-6, atol=1e-8, min_dt=1e-7, max_dt=0.4,
                           max_steps=128), h0=h0)
    g0, gf, gh = torch.autograd.grad(torch.sum(yf.re[:, 0] ** 2),
                                     (t0, tf, h0))
    assert g0.dtype == torch.float32 and gf.dtype == F64
    assert gh.dtype == F64 and float(gh) == 0.0
    assert bool(torch.isfinite(g0)) and bool(torch.isfinite(gf))


def test_adaptive_rejects_an_unbatched_state():
    _, tb = _pair(*_basis(2, 3, 8))
    y0 = Cplx(torch.ones(3, dtype=F64) / 3 ** 0.5, torch.zeros(3, dtype=F64))
    with pytest.raises(ValueError, match="BATCHED"):
        tdiff.adjoint_solve_adaptive(
            tb, _tcoeff, torch.tensor([0.9, 2.2], dtype=F64), y0, 0.0, 1.0,
            ctl=vt.StepControl(rtol=1e-6, max_steps=64), h0=0.1)


def test_unported_options_raise():
    """basis_grad (no kernel) is ROADMAP item 23; the adaptive adjoint at
    order 6 and over CFM rows needs the slice-4b steppers."""
    _, tb = _pair(*_basis(2, 3, 8))
    y0 = Cplx(torch.ones(1, 3, dtype=F64), torch.zeros(1, 3, dtype=F64))
    theta = torch.tensor([0.9, 2.2], dtype=F64)
    with pytest.raises(NotImplementedError, match="item 23"):
        tdiff.adjoint_solve(tb, _tcoeff, theta, y0, 0.0, 1.0, 8,
                            basis_grad=True)
    ctl = vt.StepControl(rtol=1e-6, max_steps=64)
    for kw in (dict(order=6), dict(scheme="cfm4")):
        with pytest.raises(NotImplementedError, match="slice 4b"):
            tdiff.adjoint_solve_adaptive(tb, _tcoeff, theta, y0, 0.0, 1.0,
                                         ctl=ctl, **kw)
    with pytest.raises(ValueError):
        tdiff.adjoint_solve_adaptive(tb, _tcoeff, theta, y0, 0.0, 1.0,
                                     ctl=ctl, order=2)
    with pytest.raises(ValueError):
        tdiff.adjoint_solve(tb, _tcoeff, theta, y0, 0.0, 1.0, 8, order=3)


def test_pulse_control_matches_jax_bitwise():
    """make draws H0 and Hc as the JAX package does (bitwise), the basis
    pair and the coefficients agree, and convert carries a JAX model
    across."""
    jpc = JPulse.make(d=4, seed=0, T=5.0, n_modes=6)
    pc = PulseControl.make(d=4, seed=0, T=5.0, n_modes=6)
    assert np.array_equal(pc.H0, jpc.H0) and np.array_equal(pc.Hc, jpc.Hc)
    jb = jpc.basis_pair(jnp.float64)
    tb = pc.basis_pair(F64, device="cpu")
    assert np.array_equal(tb.re.numpy(), np.asarray(jb.re))
    assert np.array_equal(tb.im.numpy(), np.asarray(jb.im))
    th = np.linspace(-0.3, 0.4, 6)
    t = np.linspace(0.0, 5.0, 11)
    # sin of the same argument: torch's and XLA's CPU sin may differ by an
    # ulp (ROADMAP queue 3); measured <= 2.3e-16
    np.testing.assert_allclose(
        pc.coeff_fn(torch.as_tensor(t), torch.as_tensor(th)).numpy(),
        np.asarray(jpc.coeff_fn(jnp.asarray(t), jnp.asarray(th))),
        rtol=1e-14, atol=1e-15)
    back = convert.pulse_control_from_numpy(np.asarray(jpc.H0),
                                            np.asarray(jpc.Hc), jpc.T,
                                            jpc.n_modes)
    assert np.array_equal(back.H0, pc.H0) and (back.T, back.n_modes) == (
        5.0, 6)


def test_pulse_control_losses_match_jax():
    """infidelity (state transfer) and gate_infidelity (a Hadamard), value
    and theta gradient through the adjoint; measured <= 4e-15, held to
    1e-10."""
    jpc = JPulse.make(d=4, seed=0, T=5.0, n_modes=6)
    pc = PulseControl.make(d=4, seed=0, T=5.0, n_modes=6)
    z = _states(3, 4, 7)
    tgt = np.roll(z, 1, axis=-1)
    theta = 0.1 * np.arange(1, 7)
    jv, jg = jax.value_and_grad(lambda th: jpc.infidelity(
        th, jcp.from_complex(z, jnp.float64),
        jcp.from_complex(tgt, jnp.float64), n_steps=16,
        use_pallas=False))(jnp.asarray(theta))
    th = _leaf(theta)
    tv = pc.infidelity(th, Cplx(torch.as_tensor(z.real),
                                torch.as_tensor(z.imag)),
                       Cplx(torch.as_tensor(tgt.real),
                            torch.as_tensor(tgt.imag)), n_steps=16)
    (tg,) = torch.autograd.grad(tv, th)
    np.testing.assert_allclose(float(tv), float(jv), rtol=1e-10)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-10,
                               atol=1e-12)

    jpc2 = JPulse.make(d=2, seed=0, T=5.0, n_modes=6)
    pc2 = PulseControl.make(d=2, seed=0, T=5.0, n_modes=6)
    H = (np.array([[1, 1], [1, -1]]) / np.sqrt(2)).astype(complex)
    jv, jg = jax.value_and_grad(lambda th: jpc2.gate_infidelity(
        th, H, n_steps=12, use_pallas=False))(jnp.asarray(theta))
    th = _leaf(theta)
    tv = pc2.gate_infidelity(th, H, n_steps=12)
    (tg,) = torch.autograd.grad(tv, th)
    np.testing.assert_allclose(float(tv), float(jv), rtol=1e-10)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-10,
                               atol=1e-12)


def test_forward_keeps_no_graph():
    """O(1) memory: what the adjoint keeps for its backward is theta, the
    final state and the endpoints, whatever n_steps is."""
    _, tb = _pair(*_basis(2, 3, 7))
    y0 = Cplx(torch.ones(2, 3, dtype=F64) / 3 ** 0.5,
              torch.zeros(2, 3, dtype=F64))
    sizes = []
    for n in (8, 512):
        th = _leaf(np.array([0.8, 2.5]))
        yf = tdiff.adjoint_solve(tb, _tcoeff, th, y0, 0.0, 1.0, n)
        node = yf.re.grad_fn
        while node is not None and "Backward" not in type(node).__name__ \
                or "_FixedStepAdjoint" not in type(node).__name__:
            node = node.next_functions[0][0]
        sizes.append(sum(t.numel() for t in node.saved_tensors))
    assert sizes[0] == sizes[1] < 50, sizes

"""The port's optimisation loop (vec_ode_tpu_torch.diff.fit_loop /
make_fit_loop over torch.optim) against the JAX package's fit_loop over
optax, in f64 on the CPU: the same iterates as optax.adam over 40
iterations, losses at the pre-update parameters, early stopping with
``tol`` (NaN past n_done), has_aux and extra arguments, pytree
parameters, a reusable factory, validation, and the reversible adjoint
inside the loss. The JAX loop's ``jit`` / ``unroll`` are XLA compile
options with no counterpart (ROADMAP queue 3)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vec_ode_tpu import diff as jdiff
from vec_ode_tpu_torch.diff import FitResult, fit_loop, make_fit_loop
from vec_ode_tpu_torch.models import PulseControl
from vec_ode_tpu_torch.ops.cplx import from_complex

jax.config.update("jax_enable_x64", True)

F64 = torch.float64


def _quad(th):
    return torch.sum((th - 3.0) ** 2)


def _adam(lr):
    return lambda p: torch.optim.Adam(p, lr=lr)


def _sgd(lr):
    return lambda p: torch.optim.SGD(p, lr=lr)


def test_matches_jax_adam_40_iterations():
    """40 iterations of Adam(0.2) on the quadratic from zeros: parameters
    and losses against the JAX package's fit_loop with optax.adam(0.2)
    (the same update to rounding), held to 1e-10."""
    jres = jdiff.fit_loop(lambda th: jnp.sum((th - 3.0) ** 2),
                          jnp.zeros(4, jnp.float64), optimizer=optax.adam(0.2),
                          n_iters=40)
    res = fit_loop(_quad, torch.zeros(4, dtype=F64), optimizer=_adam(0.2),
                   n_iters=40)
    np.testing.assert_allclose(res.params.numpy(), np.asarray(jres.params),
                               rtol=1e-10)
    np.testing.assert_allclose(res.losses.numpy(), np.asarray(jres.losses),
                               rtol=1e-10)
    assert res.n_done == int(jres.n_done) == 40 and res.aux is None
    assert isinstance(res.opt_state, torch.optim.Adam)


def test_losses_are_pre_update():
    res = fit_loop(_quad, torch.zeros(4, dtype=F64), optimizer=_sgd(0.1),
                   n_iters=5)
    assert float(res.losses[0]) == pytest.approx(4 * 9.0)


def test_tol_early_stop():
    """The JAX package's while-loop: an iteration whose loss is <= tol
    still updates, then the loop stops; the same n_done as JAX's."""
    res = fit_loop(_quad, torch.zeros(4, dtype=F64), optimizer=_adam(0.2),
                   n_iters=500, tol=1e-10)
    n = res.n_done
    assert 0 < n < 500
    assert float(res.losses[n - 1]) <= 1e-10 < float(res.losses[n - 2])
    assert bool(torch.isnan(res.losses[n:]).all())
    assert res.losses.shape == (500,)
    jres = jdiff.fit_loop(lambda th: jnp.sum((th - 3.0) ** 2),
                          jnp.zeros(4, jnp.float64), optimizer=optax.adam(0.2),
                          n_iters=500, tol=1e-10)
    assert n == int(jres.n_done)


def test_tol_never_reached_runs_all_iters():
    res = fit_loop(_quad, torch.zeros(2, dtype=F64), optimizer=_sgd(1e-4),
                   n_iters=10, tol=1e-30)
    assert res.n_done == 10
    assert not bool(torch.isnan(res.losses).any())


def test_has_aux_and_extra_args():
    def loss(th, data, w):
        r = torch.sum(w * (th - data) ** 2)
        return r, {"twice": 2.0 * r}

    data = torch.tensor([1.0, 2.0, 3.0], dtype=F64)
    w = torch.tensor([1.0, 0.5, 2.0], dtype=F64)
    res = fit_loop(loss, torch.zeros(3, dtype=F64), data, w,
                   optimizer=_adam(0.3), n_iters=120, has_aux=True)
    np.testing.assert_allclose(res.params.numpy(), data.numpy(), atol=1e-2)
    assert res.aux["twice"].shape == (120,)
    np.testing.assert_allclose(res.aux["twice"].numpy(),
                               2.0 * res.losses.numpy(), rtol=1e-12)


def test_pytree_params():
    def loss(th):
        return (torch.sum((th["a"] - 1.0) ** 2)
                + torch.sum((th["b"] + 2.0) ** 2))

    theta0 = {"a": torch.zeros(2, dtype=F64), "b": torch.zeros(2, 2,
                                                               dtype=F64)}
    res = fit_loop(loss, theta0, optimizer=_adam(0.1), n_iters=300)
    np.testing.assert_allclose(res.params["a"].numpy(), 1.0, atol=1e-3)
    np.testing.assert_allclose(res.params["b"].numpy(), -2.0, atol=1e-3)
    assert float(theta0["a"].abs().max()) == 0.0  # theta0 is not changed


def test_factory_reuse():
    fit = make_fit_loop(_quad, _adam(0.2), n_iters=20)
    r1 = fit(torch.zeros(4, dtype=F64))
    r2 = fit(torch.ones(4, dtype=F64))
    assert isinstance(r1, FitResult)
    assert float(r2.losses[0]) == pytest.approx(4 * 4.0)
    np.testing.assert_allclose(fit(torch.zeros(4, dtype=F64)).losses.numpy(),
                               r1.losses.numpy(), rtol=0)


def test_n_iters_validation():
    with pytest.raises(ValueError, match="n_iters"):
        make_fit_loop(_quad, _sgd(0.1), n_iters=0)


def test_verbose_every_prints_from_the_host(capsys):
    fit_loop(_quad, torch.zeros(2, dtype=F64), optimizer=_sgd(0.1),
             n_iters=5, verbose_every=2)
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split()[2] for ln in lines] == ["0", "2", "4"]


def test_adjoint_solve_inside_loop():
    """The pulse-control composition: the reversible adjoint inside the
    loss, 30 Adam(0.3) iterations (the JAX test's case): the loss halves
    and stays finite."""
    pc = PulseControl.make(d=4, seed=0, T=5.0, n_modes=6)
    psi0 = from_complex(np.eye(4)[0][None].astype(complex), F64,
                        device="cpu")
    tgt = from_complex(np.eye(4)[2][None].astype(complex), F64,
                       device="cpu")
    res = fit_loop(lambda th: pc.infidelity(th, psi0, tgt, n_steps=48,
                                            dtype=F64),
                   0.1 * torch.ones(6, dtype=F64), optimizer=_adam(0.3),
                   n_iters=30)
    assert float(res.losses[-1]) < 0.5 * float(res.losses[0])
    assert bool(torch.isfinite(res.losses).all())

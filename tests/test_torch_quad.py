"""``vec_ode_tpu_torch.quad`` against ``vec_ode_tpu/quad.py`` on the CPU in
f64: the Gauss-Legendre tables, fixed-order Gauss-Legendre and composite
trapezoid quadrature of scalar, array and Cplx-valued functions, and the
averaged operator of a black-box operator callback."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vec_ode_tpu import quad as jquad
from vec_ode_tpu.models import DrivenDense as JDrivenDense
from vec_ode_tpu_torch import quad as tquad
from vec_ode_tpu_torch.models import DrivenDense

jax.config.update("jax_enable_x64", True)
torch.set_num_threads(1)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5])
def test_gauss_legendre_tables_are_the_jax_packages(n):
    c, w = tquad.gauss_legendre(n)
    jc, jw = jquad.gauss_legendre(n)
    np.testing.assert_array_equal(c, jc)
    np.testing.assert_array_equal(w, jw)
    # exact for polynomials of degree 2n - 1 on [0, 1]
    assert abs(np.sum(w * c ** (2 * n - 1)) - 1.0 / (2 * n)) < 1e-15


def test_gauss_legendre_rejects_other_counts():
    with pytest.raises(ValueError, match="point count"):
        tquad.gauss_legendre(6)


def _fns():
    A = np.arange(6.0).reshape(2, 3)
    return {
        "scalar": (lambda t: jnp.exp(-t) * jnp.sin(3.0 * t),
                   lambda t: torch.exp(-t) * torch.sin(3.0 * t)),
        "array": (lambda t: jnp.cos(t) * jnp.asarray(A) + t ** 2,
                  lambda t: torch.cos(t) * torch.as_tensor(A) + t ** 2),
    }


@pytest.mark.parametrize("n", [1, 3, 5])
@pytest.mark.parametrize("name", list(_fns()))
def test_fixed_quad_matches_jax(name, n):
    jf, tf = _fns()[name]
    a, b = jnp.float64(0.2), jnp.float64(1.7)
    want = np.asarray(jquad.fixed_quad(jf, a, b, n=n))
    got = tquad.fixed_quad(tf, torch.tensor(0.2, dtype=torch.float64),
                           torch.tensor(1.7, dtype=torch.float64), n=n)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-14, atol=1e-15)


@pytest.mark.parametrize("name", list(_fns()))
def test_trapezoid_matches_jax(name):
    jf, tf = _fns()[name]
    want = np.asarray(jquad.trapezoid(jf, jnp.float64(-0.5), jnp.float64(2.0),
                                      n=37))
    got = tquad.trapezoid(tf, torch.tensor(-0.5, dtype=torch.float64),
                          torch.tensor(2.0, dtype=torch.float64), n=37)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-13, atol=1e-14)


@pytest.mark.parametrize("n", [2, 4])
def test_averaged_operator_matches_jax(n):
    """The averaged operator of DrivenDense(8)'s black-box Cplx pair over
    one step, per part."""
    jm, tm = JDrivenDense.make(d=8, seed=0), DrivenDense.make(d=8, seed=0)
    want = jquad.averaged_operator(lambda t: jm.op_pair(t, jnp.float64),
                                   jnp.float64(0.3), jnp.float64(0.05), n=n)
    got = tquad.averaged_operator(
        lambda t: tm.op_pair(t, torch.float64, device="cpu"),
        torch.tensor(0.3, dtype=torch.float64),
        torch.tensor(0.05, dtype=torch.float64), n=n)
    for part in ("re", "im"):
        np.testing.assert_allclose(getattr(got, part).numpy(),
                                   np.asarray(getattr(want, part)), rtol=0,
                                   atol=1e-14)
    # a constant-coefficient part averages to itself
    np.testing.assert_allclose(
        got.im.numpy(), -np.real(tm.H0) - np.real(tm.V) * float(
            tquad.fixed_quad(lambda t: torch.cos(tm.w * t),
                             torch.tensor(0.3, dtype=torch.float64),
                             torch.tensor(0.35, dtype=torch.float64), n=n)
            / 0.05), rtol=0, atol=1e-13)

"""The port's model library against the JAX package's, in f64 on the same
inputs: the right-hand sides of ``VanDerPol``, ``LotkaVolterra``,
``Brusselator``, ``LinearConstant``, ``DecayDiag`` and
``DrivenDense.rhs`` / ``.rhs_pair``, the operators of
``TightBindingChain``, the closed forms (``exact``) and the
Lotka-Volterra invariant; the numpy constructors give the same matrices
for a seed. ``rhs_pair`` under ``torch.func.vmap`` equals the unbatched
call and keeps its operator on the device between calls."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vec_ode_tpu import models as jm
from vec_ode_tpu.ops import cplx as jcp
from vec_ode_tpu_torch import models as tm
from vec_ode_tpu_torch.ops import cplx as tcp

torch.set_num_threads(1)

RNG = np.random.default_rng(5)
Y2 = RNG.uniform(0.5, 2.0, (3, 2))
T = np.array([0.0, 0.7, 2.3])


def close(got, want, rtol=1e-13, atol=1e-14):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("name,kw", [
    ("VanDerPol", dict(mu=1.5)),
    ("LotkaVolterra", dict(a=1.2, b=0.8, c=2.5, d=1.1)),
    ("Brusselator", dict(A=1.0, B=3.0)),
])
def test_nonlinear_rhs_match_jax(name, kw):
    want = getattr(jm, name)(**kw).rhs(0.3, jnp.asarray(Y2))
    got = getattr(tm, name)(**kw).rhs(0.3, torch.as_tensor(Y2))
    close(got.numpy(), want)


def test_lotka_volterra_invariant_matches_jax():
    close(tm.LotkaVolterra().invariant(torch.as_tensor(Y2)).numpy(),
          jm.LotkaVolterra().invariant(jnp.asarray(Y2)))


def test_stable_dense_matrix_is_the_jax_matrix():
    want = np.asarray(jm.stable_dense_matrix(8, seed=3))
    np.testing.assert_array_equal(
        tm.stable_dense_matrix(8, seed=3, device="cpu").numpy(), want)
    np.testing.assert_array_equal(tm.stable_dense_matrix(8, 3, dtype=None),
                                  want)
    assert tm.stable_dense_matrix(4, device="cpu").dtype == torch.float64


def test_linear_constant_rhs_and_exact_match_jax():
    A = tm.stable_dense_matrix(6, seed=0, device="cpu")
    jA = jm.LinearConstant(jm.stable_dense_matrix(6, seed=0))
    tA = tm.LinearConstant(A)
    y = RNG.standard_normal((4, 6))
    close(tA.rhs(0.0, torch.as_tensor(y)).numpy(),
          jA.rhs(0.0, jnp.asarray(y)))
    close(tA.exact(1.3, torch.as_tensor(y)).numpy(),
          jA.exact(1.3, jnp.asarray(y)), rtol=1e-12)
    assert tA.op(0.0) is A


def test_decay_diag_matches_jax():
    rates = np.array([-1.0, -2.0, -0.5])
    y = RNG.standard_normal(3)
    jd, td = jm.DecayDiag(jnp.asarray(rates)), tm.DecayDiag(
        torch.as_tensor(rates))
    close(td.rhs(0.0, torch.as_tensor(y)).numpy(),
          jd.rhs(0.0, jnp.asarray(y)))
    close(td.exact(0.8, torch.as_tensor(y)).numpy(),
          jd.exact(0.8, jnp.asarray(y)))


def _psi(batch, d):
    psi = RNG.standard_normal(batch + (d,)) + 1j * RNG.standard_normal(
        batch + (d,))
    return psi / np.linalg.norm(psi, axis=-1, keepdims=True)


def test_driven_dense_rhs_matches_jax():
    jd = jm.DrivenDense.make(d=4, seed=0)
    td = tm.DrivenDense.make(d=4, seed=0)
    psi = _psi((3,), 4)
    for t in T:
        close(td.rhs(t, torch.as_tensor(psi)).numpy(),
              jd.rhs(t, jnp.asarray(psi)))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_driven_dense_rhs_pair_matches_jax(dtype):
    jd = jm.DrivenDense.make(d=4, seed=0)
    td = tm.DrivenDense.make(d=4, seed=0)
    psi = _psi((3,), 4)
    tol = 1e-13 if dtype == "float64" else 2e-6
    for t in T:
        want = jd.rhs_pair(jnp.asarray(t), jcp.from_complex(
            psi, getattr(jnp, dtype)), getattr(jnp, dtype))
        got = td.rhs_pair(torch.tensor(t), tcp.from_complex(
            psi, getattr(torch, dtype), device="cpu"), getattr(torch, dtype))
        assert got.re.dtype == getattr(torch, dtype)
        close(got.re.numpy(), want.re, rtol=tol, atol=tol)
        close(got.im.numpy(), want.im, rtol=tol, atol=tol)


def test_rhs_pair_under_vmap_is_the_unbatched_call():
    td = tm.DrivenDense.make(d=4, seed=0)
    psi = tcp.from_complex(_psi((5,), 4), torch.float64, device="cpu")
    ts = torch.linspace(0.0, 1.0, 5, dtype=torch.float64)
    got = torch.func.vmap(lambda t, y: td.rhs_pair(t, y, torch.float64))(
        ts, psi)
    for b in range(5):
        one = td.rhs_pair(ts[b], tcp.Cplx(psi.re[b], psi.im[b]),
                          torch.float64)
        close(got.re[b].numpy(), one.re.numpy(), rtol=1e-15, atol=1e-15)
        close(got.im[b].numpy(), one.im.numpy(), rtol=1e-15, atol=1e-15)
    # the widened operator is made once per (dtype, device)
    W = td._op_fns[("pair", torch.float64, torch.device("cpu"))]
    td.rhs_pair(ts[0], psi, torch.float64)
    assert td._op_fns[("pair", torch.float64, torch.device("cpu"))] is W


def test_rhs_pair_returns_contiguous_halves():
    """re and im are tensors of their own, not strided views of one
    (B, 2d) buffer, alone and under vmap: the stage sums over them take
    torch's vectorised elementwise kernels."""
    td = tm.DrivenDense.make(d=4, seed=0)
    psi = tcp.from_complex(_psi((5,), 4), torch.float64, device="cpu")
    ts = torch.linspace(0.0, 1.0, 5, dtype=torch.float64)
    one = td.rhs_pair(ts[0], psi, torch.float64)
    got = torch.func.vmap(lambda t, y: td.rhs_pair(t, y, torch.float64))(
        ts, psi)
    for y in (one, got):
        assert y.re.is_contiguous() and y.im.is_contiguous()
        assert y.re.shape == y.im.shape == (5, 4)


def test_rhs_pair_takes_one_product_a_call_under_vmap():
    """One (B, 2d) x (2d, 4d) product a stage, not B matrix-vector
    products or a batched (B, 2d, 2d) operator."""
    from torch.profiler import ProfilerActivity, profile

    td = tm.DrivenDense.make(d=4, seed=0)
    psi = tcp.from_complex(_psi((64,), 4), torch.float64, device="cpu")
    ts = torch.zeros(64, dtype=torch.float64)
    f = torch.func.vmap(lambda t, y: td.rhs_pair(t, y, torch.float64))
    f(ts, psi)
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        f(ts, psi)
    # the profiler also lists vmap's per-sample view of each op; the
    # products that ran on the batch are those with its leading 64
    ran = [(e.name, e.input_shapes) for e in prof.events()
           if e.name in ("aten::mm", "aten::bmm", "aten::mv", "aten::addmm")
           and e.input_shapes and e.input_shapes[0][:1] == [64]]
    assert ran == [("aten::mm", [[64, 8], [8, 16]])], ran


def test_tight_binding_chain_operators_match_jax():
    jc = jm.TightBindingChain(n=8, J=1.0, seed=3, w=2.0)
    tc = tm.TightBindingChain(n=8, J=1.0, seed=3, w=2.0)
    np.testing.assert_array_equal(tc.hop_matrix(), jc.hop_matrix())
    np.testing.assert_array_equal(tc.onsite_energies(), jc.onsite_energies())
    for t in T:
        ja, jb = jc.ops_pair(jnp.asarray(t), jnp.float64)
        ta, tb = tc.ops_pair(t, torch.float64, device="cpu")
        for g, w in ((ta, ja), (tb, jb)):
            close(g.re.numpy(), w.re)
            close(g.im.numpy(), w.im)
        close(tc.op(t, device="cpu").numpy(), jc.op(t))
    per = jm.TightBindingChain(n=5, periodic=True).hop_matrix()
    np.testing.assert_array_equal(
        tm.TightBindingChain(n=5, periodic=True).hop_matrix(), per)


def test_models_put_tensors_on_the_card_by_default():
    """The default device is the card: without one it is refused, as by
    every constructor of the port."""
    if torch.cuda.is_available():
        assert tm.stable_dense_matrix(4).is_cuda
        assert tm.TightBindingChain(n=4).ops_pair(0.0)[0].re.is_cuda
        return
    with pytest.raises((RuntimeError, AssertionError)):
        tm.stable_dense_matrix(4)
    with pytest.raises((RuntimeError, AssertionError)):
        tm.TightBindingChain(n=4).ops_pair(0.0)

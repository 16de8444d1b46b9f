"""The port's open-system model ``models.Lindblad`` on the CPU against the
JAX package's (``vec_ode_tpu.models.Lindblad``) on the same numpy inputs:
the superoperator basis and the density-matrix vectorisation bit for bit,
and adaptive ensembles of density matrices through Magnus-4 and Magnus-6
in f64, with a callable control (the per-step twin, as the JAX package
runs it) and with the same control declared as a ``CoeffForm`` (the loop
twin), against the JAX XLA driver: status, n_accept, n_reject and n_iters
equal per trajectory, states to 1e-10, the trace kept."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vec_ode_tpu as vo
from vec_ode_tpu import exp as vexp
from vec_ode_tpu.models import Lindblad as JLindblad
from vec_ode_tpu.parallel import ensemble_solve as jensemble_solve
import vec_ode_tpu_torch as vt
from vec_ode_tpu_torch import exp as texp
from vec_ode_tpu_torch.models import Lindblad
from vec_ode_tpu_torch.parallel import ensemble_solve

jax.config.update("jax_enable_x64", True)
torch.set_num_threads(1)

B, d = 8, 4
MODEL = dict(d=d, seed=9, gamma=0.2)
CTL = dict(rtol=1e-7, min_dt=1e-6, max_dt=0.25, max_steps=2000)
# u(t) = 0.8 cos(2.1 t): a callable, and the same control declared
U_FORM = texp.CoeffForm(a=(0.0,), b=(0.0,), c=(0.8,), w=(2.1,))


def _rho(seed=3):
    """Random valid density matrices rho = V V^dagger / tr (benchmarks.py's
    bench_lindblad)."""
    rng = np.random.default_rng(seed)
    V = rng.standard_normal((B, d, d)) + 1j * rng.standard_normal((B, d, d))
    rho = np.einsum("bij,bkj->bik", V, V.conj())
    return rho / np.trace(rho, axis1=-2, axis2=-1)[:, None, None]


def test_model_and_superop_basis_match_jax():
    jlb, lb = JLindblad.make(**MODEL), Lindblad.make(**MODEL)
    assert np.array_equal(lb.H0, jlb.H0) and np.array_equal(lb.Hc, jlb.Hc)
    assert len(lb.jumps) == 1 and lb.jumps[0][0] == jlb.jumps[0][0]
    assert np.array_equal(lb.jumps[0][1], jlb.jumps[0][1])
    jb = jlb.superop_basis(jnp.float64)
    tb = lb.superop_basis(torch.float64, device="cpu")
    assert tb.re.shape == (2, d * d, d * d)
    assert np.array_equal(tb.re.numpy(), np.asarray(jb.re))
    assert np.array_equal(tb.im.numpy(), np.asarray(jb.im))


def test_vec_rho_round_trip_and_trace():
    rho = _rho()
    v = Lindblad.vec_rho(rho, torch.float64, device="cpu")
    jv = JLindblad.vec_rho(rho, jnp.float64)
    assert np.array_equal(v.re.numpy(), np.asarray(jv.re))
    assert np.array_equal(v.im.numpy(), np.asarray(jv.im))
    assert np.array_equal(Lindblad.unvec_rho(v), rho)
    assert np.array_equal(Lindblad.unvec_rho(v), JLindblad.unvec_rho(jv))
    tr_re, tr_im = Lindblad.trace(v)
    np.testing.assert_allclose(tr_re.numpy(), 1.0, rtol=0, atol=1e-15)
    np.testing.assert_allclose(tr_im.numpy(), 0.0, rtol=0, atol=1e-15)


def test_modulated_declares_only_a_form():
    lb = Lindblad.make(**MODEL)
    op = lb.modulated(lambda t: 0.8 * torch.cos(2.1 * t), torch.float64,
                      device="cpu")
    assert op.form is None and op.n_terms == 2
    declared = lb.modulated(U_FORM, torch.float64, device="cpu")
    assert declared.form == texp.CoeffForm(a=(1.0, 0.0), b=(0.0, 0.0),
                                           c=(0.0, 0.8), w=(0.0, 2.1))
    t = torch.linspace(-1.0, 3.0, 17, dtype=torch.float64)
    assert torch.equal(declared.coeff_fn(t), op.coeff_fn(t))
    with pytest.raises(ValueError, match="one term"):
        lb.modulated(None, form=texp.CoeffForm((1.0, 0.0), (0.0, 0.0),
                                               (0.0, 1.0), (0.0, 1.0)))


@functools.cache
def _jax(stepper):
    lb = JLindblad.make(**MODEL)
    mod = lb.modulated(lambda t: 0.8 * jnp.cos(2.1 * jnp.asarray(t)),
                       dtype=jnp.float64)
    cls = {"mm4": vexp.MagnusModulated4, "mm6": vexp.MagnusModulated6}
    sol = jensemble_solve(
        None, JLindblad.vec_rho(_rho(), jnp.float64), 0.0, 1.0,
        stepper=cls[stepper](mod, use_pallas=False),
        ctl=vo.StepControl(**CTL), h0=1e-2, time_dtype=jnp.float64)
    return {k: np.asarray(getattr(sol, k)) for k in
            ("status", "n_accept", "n_reject", "n_iters")} | {
        "y": JLindblad.unvec_rho(sol.y_final)}


@pytest.mark.parametrize("path", ["per_step", "loop"])
@pytest.mark.parametrize("stepper", ["mm4", "mm6"])
def test_ensemble_matches_jax(stepper, path):
    """256 density matrices at d = 8 is the chip's workload (chip_smoke.py);
    here 8 at d = 4, f64."""
    lb = Lindblad.make(**MODEL)
    u = (U_FORM if path == "loop"
         else (lambda t: 0.8 * torch.cos(2.1 * t)))
    op = lb.modulated(u, torch.float64, device="cpu")
    cls = {"mm4": texp.MagnusModulated4, "mm6": texp.MagnusModulated6}
    sol = ensemble_solve(
        None, Lindblad.vec_rho(_rho(), torch.float64, device="cpu"), 0.0,
        1.0, stepper=cls[stepper](op), ctl=vt.StepControl(**CTL), h0=1e-2,
        time_dtype=torch.float64)
    assert sol.path == ("torch-loop" if path == "loop" else "torch-driver")
    want = _jax(stepper)
    for k in ("status", "n_accept", "n_reject", "n_iters"):
        np.testing.assert_array_equal(getattr(sol, k).numpy(), want[k],
                                      err_msg=k)
    assert (sol.status == vt.DONE).all()
    got = Lindblad.unvec_rho(sol.y_final)
    np.testing.assert_allclose(got, want["y"], rtol=0, atol=1e-10)
    tr_re, tr_im = Lindblad.trace(sol.y_final)
    np.testing.assert_allclose(tr_re.numpy(), 1.0, rtol=0, atol=1e-12)
    np.testing.assert_allclose(tr_im.numpy(), 0.0, rtol=0, atol=1e-12)
    # a dissipative system: the purity tr(rho^2) falls below its start
    purity = np.einsum("bij,bji->b", got, got).real
    assert (purity < np.einsum("bij,bji->b", _rho(), _rho()).real).all()

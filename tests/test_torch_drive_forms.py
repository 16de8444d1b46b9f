"""Declared drives of the RK steppers (ops/fused_rk.py, ops/fused_loop.py)
against the JAX package in f64 on the CPU: a one-term ``CoeffForm`` with
every term nonzero and a 16-coefficient ``ChebForm`` of a chirped drive,
given to the JAX package as the same function ``u_fn`` (written in
``CoeffForm.sample`` / ``ChebForm.sample``'s order). The twins
``torch_rk_step`` and ``RKStep.plain`` against ``xla_rk_step`` and the
Pallas loop in interpret mode, the ensemble against the JAX ensemble
(counters and status per trajectory), the cos(w t) shorthand, callable
drives on the twin step, and the kernels' drive arguments. The kernels
against their twins on a card: tests/test_torch_cuda.py."""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vec_ode_tpu as vo
from vec_ode_tpu import tableaus as jtab
from vec_ode_tpu.models import DrivenDense as JDrivenDense
from vec_ode_tpu.ops import pallas_loop
from vec_ode_tpu.ops import pallas_rk
from vec_ode_tpu.ops.cplx import Cplx as JCplx
from vec_ode_tpu.parallel import ensemble_solve as jensemble_solve
import vec_ode_tpu_torch as vt
from vec_ode_tpu_torch import tableaus as ttab
from vec_ode_tpu_torch.ops import fused_rk
from vec_ode_tpu_torch.ops.cplx import Cplx
from vec_ode_tpu_torch.ops.forms import FORMS, ChebForm, CoeffForm
from vec_ode_tpu_torch.ops.fused_loop import (RKStep, fused_loop_integrate,
                                              loop_solution)
from vec_ode_tpu_torch.ops.fused_rk import (FusedModulatedLinearRK,
                                            cos_drive, drive_fn,
                                            kernel_drive, torch_rk_step)
from vec_ode_tpu_torch.parallel import ensemble_solve

torch.set_num_threads(1)

B, D, TF = 16, 16, 0.5
CTL = dict(rtol=1e-8, min_dt=1e-6, max_dt=0.25)
W = float(JDrivenDense.make(d=D, seed=0).w)


def _forms() -> dict:
    """The port's declared drives, by name: all-nonzero CoeffForm terms,
    and the chirp cos(w t + 3 t^2) on [0, TF] as a 16-term series."""
    u = np.cos(np.pi * (np.arange(64) + 0.5) / 64)
    tt = 0.5 * TF * (u + 1.0)
    series = np.polynomial.chebyshev.chebfit(
        u, np.cos(W * tt + 3 * tt ** 2), 15)
    return {"coeff": CoeffForm(a=(0.3,), b=(0.1,), c=(0.8,), w=(W,)),
            "cheb": ChebForm(series[:, None], 0.0, TF)}


FORMS_ = _forms()


def _jax_u(name):
    """The same drive as a JAX callable, in the sampler's order."""
    form = FORMS_[name]
    if name == "coeff":
        a, b, c, w = (v[0] for v in (form.a, form.b, form.c, form.w))
        return lambda t: (a + b * t) + c * jnp.cos(w * t)
    mid, inv = form.folded()
    coef = np.asarray(form.series)[:, 0]

    def u(t):
        x = (2.0 * t - mid) * inv
        x2 = 2.0 * x
        b1 = b2 = jnp.zeros_like(x)
        for j in range(len(coef) - 1, 0, -1):
            b1, b2 = (x2 * b1 - b2) + coef[j], b1
        return (x * b1 - b2) + coef[0]

    return u


def _problem(seed=3):
    jst = pallas_rk.FusedModulatedLinearRK.from_driven_dense(
        JDrivenDense.make(d=D, seed=0), jnp.float64)
    rng = np.random.default_rng(seed)
    xw = rng.standard_normal((B, 2 * D)) * 0.1
    t = rng.uniform(0, TF - 0.05, B)
    dt = rng.uniform(1e-3, 5e-2, B)
    psi = rng.standard_normal((B, D)) + 1j * rng.standard_normal((B, D))
    psi /= np.linalg.norm(psi, axis=-1, keepdims=True)
    return np.asarray(jst.M0), np.asarray(jst.M1), t, dt, xw, psi


@pytest.mark.parametrize("name", ["coeff", "cheb"])
def test_form_sample_matches_the_jax_callable(name):
    t = np.linspace(0.0, TF, 101)
    got = drive_fn(FORMS_[name])(torch.as_tensor(t)).numpy()
    np.testing.assert_allclose(got, np.asarray(_jax_u(name)(jnp.asarray(t))),
                               rtol=0, atol=1e-14)


@pytest.mark.parametrize("tab", ["rkf45", "dopri5"])
@pytest.mark.parametrize("name", ["coeff", "cheb"])
def test_torch_step_matches_xla_step_f64(name, tab):
    M0, M1, t, dt, xw, _ = _problem()
    jx, je = pallas_rk.xla_rk_step(
        *(jnp.asarray(a) for a in (t, dt, xw, M0, M1)), u_fn=_jax_u(name),
        tab=jtab.TABLEAUS[tab])
    tx, te = torch_rk_step(*(torch.as_tensor(a) for a in (t, dt, xw, M0, M1)),
                           u_fn=drive_fn(FORMS_[name]),
                           tab=ttab.TABLEAUS[tab])
    # the tolerances of tests/test_torch_fused_rk.py (BLAS order only)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=1e-9,
                               atol=1e-18)
    # the wrapper on CPU tensors is the twin, bit for bit
    fx, fe = fused_rk.fused_rk_step(
        *(torch.as_tensor(a) for a in (t, dt, xw, M0, M1)),
        u_fn=FORMS_[name], tab=ttab.TABLEAUS[tab])
    assert torch.equal(fx, tx) and torch.equal(fe, te)


@functools.cache
def _jax_loop(name, grid):
    M0, M1, _, _, _, psi = _problem()
    ctl = vo.StepControl(**CTL)
    builder = pallas_loop.make_rk_step_builder(jtab.RKF45, _jax_u(name),
                                               True)
    fs, ist, parts, saves, _ = pallas_loop.fused_loop_integrate(
        jnp.asarray(grid), (jnp.asarray(psi.real), jnp.asarray(psi.imag)),
        jnp.asarray(1e-3), [jnp.asarray(M0), jnp.asarray(M1)], builder,
        adaptive=True, ctl=ctl, persistent=True, tile=8, interpret=True,
        group=1)
    x = np.concatenate([np.asarray(p) for p in parts], axis=1)
    return np.asarray(fs), np.asarray(ist), x


@pytest.mark.parametrize("grid", [(0.0, TF), (0.0, 0.2, TF)])
@pytest.mark.parametrize("name", ["coeff", "cheb"])
def test_loop_twin_matches_pallas_loop_interpret_f64(name, grid):
    """RKStep.plain in the loop twin against the Pallas loop with the
    same u_fn: status and every counter equal per trajectory, states to
    rounding (the tolerances of tests/test_torch_fused_loop.py)."""
    jfs, jist, jx = _jax_loop(name, grid)
    M0, M1, _, _, _, psi = _problem()
    step = RKStep(M0=torch.as_tensor(M0), M1=torch.as_tensor(M1),
                  u_fn=FORMS_[name])
    x0 = torch.as_tensor(np.concatenate([psi.real, psi.imag], 1))
    fs, ist, x, _ = fused_loop_integrate(
        torch.tensor(grid, dtype=torch.float64), x0,
        torch.tensor(1e-3, dtype=torch.float64), step,
        ctl=vt.StepControl(**CTL), persistent=True)
    for col in (1, 3, 4, 5):
        np.testing.assert_array_equal(ist[:, col].numpy(), jist[:, col])
    np.testing.assert_allclose(fs[:, 0].numpy(), jfs[:, 0], rtol=1e-12)
    np.testing.assert_allclose(x.numpy(), jx, rtol=1e-9, atol=1e-12)


@functools.cache
def _jax_ensemble(name):
    M0, M1, _, _, _, psi = _problem()
    st = pallas_rk.FusedModulatedLinearRK(M0=jnp.asarray(M0),
                                          M1=jnp.asarray(M1),
                                          u_fn=_jax_u(name))
    y0 = JCplx(jnp.asarray(psi.real), jnp.asarray(psi.imag))
    sol = jensemble_solve(None, y0, 0.0, TF, stepper=st, h0=1e-3,
                          ctl=vo.StepControl(**CTL), save_at=[0.2])
    return {k: np.asarray(getattr(sol, k)) for k in
            ("status", "n_accept", "n_reject", "n_iters")}, (
        np.asarray(sol.y_final.re), np.asarray(sol.ys.re))


@pytest.mark.parametrize("name", ["coeff", "cheb"])
def test_ensemble_matches_jax_f64(name):
    counters, (yre, ysre) = _jax_ensemble(name)
    M0, M1, _, _, _, psi = _problem()
    st = FusedModulatedLinearRK(M0=torch.as_tensor(M0),
                                M1=torch.as_tensor(M1), u_fn=FORMS_[name])
    y0 = Cplx(torch.as_tensor(psi.real), torch.as_tensor(psi.imag))
    sol = ensemble_solve(None, y0, 0.0, TF, stepper=st, h0=1e-3,
                         ctl=vt.StepControl(**CTL), save_at=[0.2])
    assert sol.path == "torch-driver"
    for k, v in counters.items():
        np.testing.assert_array_equal(getattr(sol, k).numpy(), v, err_msg=k)
    np.testing.assert_allclose(sol.y_final.re.numpy(), yre, rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(sol.ys.re.numpy(), ysre, rtol=0, atol=1e-10)


def test_cos_form_is_the_cos_drive():
    """The w= shorthand is the declared form (0, 0, 1, w), whose sampler
    gives cos(w t)'s bits; .w reads it back, dataclasses.replace keeps
    it, and a new u_fn replaces it."""
    t = torch.linspace(0, 1, 257, dtype=torch.float32)
    assert torch.equal(drive_fn(cos_drive(W))(t), torch.cos(W * t))
    M = torch.eye(4)
    a = FusedModulatedLinearRK(M0=M, M1=M, w=W)
    assert a.u_fn == cos_drive(W) and a.w == W
    assert dataclasses.replace(a, advance_lower=False).u_fn == a.u_fn
    b = dataclasses.replace(a, u_fn=FORMS_["cheb"])
    assert b.u_fn == FORMS_["cheb"] and b.w is None
    assert RKStep(M0=M, M1=M, w=W).u_fn == cos_drive(W)
    with pytest.raises(TypeError, match="drive"):
        FusedModulatedLinearRK(M0=M, M1=M)
    with pytest.raises(TypeError, match="drive"):
        RKStep(M0=M, M1=M)
    with pytest.raises(ValueError, match="one function"):
        FusedModulatedLinearRK(M0=M, M1=M, u_fn=CoeffForm(
            a=(0.0, 1.0), b=(0.0, 0.0), c=(1.0, 0.0), w=(1.0, 0.0)))
    with pytest.raises(TypeError, match="declared drive"):
        RKStep(M0=M, M1=M, u_fn=torch.cos)
    with pytest.raises(ValueError, match="exactly one"):
        fused_rk.fused_rk_step(t[:1], t[:1], M[:1], M, M)


def test_kernel_drive_layout():
    """The kernels' 8 drive values [kind, n, a, b, c, w, mid, inv] and the
    ChebForm's (1, n) series in the state's type; a callable raises."""
    like = torch.zeros(2, 4, dtype=torch.float32)
    kd = kernel_drive(FORMS_["coeff"], like)
    assert list(kd.params) == [FORMS["coeff"], 0, 0.3, 0.1, 0.8, W, 0, 0]
    assert kd.cheb is None
    cheb = FORMS_["cheb"]
    kd = kernel_drive(cheb, like)
    assert list(kd.params)[:2] == [FORMS["cheb"], 16]
    assert list(kd.params)[6:] == list(cheb.folded())
    assert kd.cheb.shape == (1, 16) and kd.cheb.dtype == torch.float32
    np.testing.assert_array_equal(
        kd.cheb.numpy()[0], np.asarray(cheb.series, np.float32)[:, 0])
    with pytest.raises(TypeError, match="declared"):
        kernel_drive(lambda t: t, like)


def test_callable_drive_runs_the_twin_step():
    """A callable u_fn runs no kernel: the twin step on the tensors'
    device (path torch-driver+twin-step on the card), the same solve as
    the declared form it computes."""
    M0, M1, _, _, _, psi = _problem()
    form = FORMS_["coeff"]
    st = FusedModulatedLinearRK(M0=torch.as_tensor(M0),
                                M1=torch.as_tensor(M1), u_fn=form)
    sc = dataclasses.replace(st, u_fn=drive_fn(form))
    assert sc.twin_only and not st.twin_only

    class OnCard:
        is_cuda = True

    assert sc.step_path(Cplx(OnCard(), OnCard())) == "torch-driver+twin-step"
    assert st.step_path(Cplx(OnCard(), OnCard())) == "torch-driver+cuda-step"
    y0 = Cplx(torch.as_tensor(psi.real), torch.as_tensor(psi.imag))
    kw = dict(h0=1e-3, ctl=vt.StepControl(**CTL))
    a = ensemble_solve(None, y0, 0.0, TF, stepper=st, **kw)
    b = ensemble_solve(None, y0, 0.0, TF, stepper=sc, **kw)
    assert torch.equal(a.n_iters, b.n_iters)
    assert torch.equal(a.y_final.re, b.y_final.re)


@pytest.mark.parametrize("name", ["coeff", "cheb"])
def test_hermite_slope_samples_the_drive(name):
    M0, M1, _, _, xw, _ = _problem()
    st = FusedModulatedLinearRK(M0=torch.as_tensor(M0),
                                M1=torch.as_tensor(M1), u_fn=FORMS_[name])
    t = torch.tensor(0.3, dtype=torch.float64)
    x = torch.as_tensor(xw)
    f = st.hermite_slope(t, Cplx(x[:, :D], x[:, D:]))
    u = float(_jax_u(name)(0.3))
    want = x @ torch.as_tensor(M0).T + u * (x @ torch.as_tensor(M1).T)
    np.testing.assert_allclose(torch.cat([f.re, f.im], 1).numpy(),
                               want.numpy(), rtol=0, atol=1e-14)


def test_dense_output_with_a_form_on_the_host_driver():
    """dense=True on the CPU takes the host driver's Hermite tier with the
    drive's slope: equal to the plain grid-hitting solve to the Hermite
    interpolant's accuracy."""
    M0, M1, _, _, _, psi = _problem()
    st = FusedModulatedLinearRK(M0=torch.as_tensor(M0),
                                M1=torch.as_tensor(M1),
                                u_fn=FORMS_["cheb"])
    y0 = Cplx(torch.as_tensor(psi.real), torch.as_tensor(psi.imag))
    kw = dict(h0=1e-3, ctl=vt.StepControl(**CTL), save_at=[0.2, 0.3])
    d = ensemble_solve(None, y0, 0.0, TF, stepper=st, dense=True, **kw)
    g = ensemble_solve(None, y0, 0.0, TF, stepper=st, **kw)
    assert d.path == "torch-driver-dense"
    np.testing.assert_allclose(d.ys.re.numpy(), g.ys.re.numpy(), atol=1e-6)


def test_loop_solution_names_the_path():
    """fused_loop_solve declines on CPU tensors; the loop twin run by hand
    with a ChebForm drive gives a Solution of the caller's grid."""
    M0, M1, _, _, _, psi = _problem()
    step = RKStep(M0=torch.as_tensor(M0), M1=torch.as_tensor(M1),
                  u_fn=FORMS_["cheb"])
    x0 = torch.as_tensor(np.concatenate([psi.real, psi.imag], 1))
    grid = torch.tensor((0.0, 0.2, TF), dtype=torch.float64)
    out = fused_loop_integrate(grid, x0, torch.tensor(1e-3,
                                                      dtype=torch.float64),
                               step, ctl=vt.StepControl(**CTL),
                               persistent=True)
    sol = loop_solution(grid, x0, out, path="torch-loop",
                        unwiden=lambda a: Cplx(a[..., :D], a[..., D:]))
    assert sol.ys.re.shape == (B, 3, D) and sol.path == "torch-loop"
    assert bool((sol.status == vt.DONE).all())

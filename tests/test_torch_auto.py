"""``exp.auto_modulated`` of the port against the JAX package's on the
cases of tests/test_auto_modulated.py, in f64 on the CPU: the recovered
K (or None where JAX returns None), the basis up to a sign per direction,
the assembled A(t), the Chebyshev form (``ChebForm.sample`` against
JAX's ``coeff_cols_fn`` on the same series, and the port's own fit against
JAX's), and ensembles over a recovered operator through both port routes
(the per-step twin of K4 over the projection, and the loop twin of K2
with K5 over the fitted ChebForm) against the JAX package's XLA driver,
per trajectory: status, n_accept, n_reject and n_iters equal, y within
1e-12."""

import dataclasses
import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vec_ode_tpu as vo
from vec_ode_tpu import exp as vexp
from vec_ode_tpu.models import DrivenDense as JDrivenDense
from vec_ode_tpu.models import LandauZener as JLandauZener
from vec_ode_tpu.ops import cplx as jcp
from vec_ode_tpu.parallel import ensemble_solve as jensemble_solve
import vec_ode_tpu_torch as vt
from vec_ode_tpu_torch import convert
from vec_ode_tpu_torch import exp as texp
from vec_ode_tpu_torch.models import DrivenDense, LandauZener
from vec_ode_tpu_torch.ops import cplx as tcp
from vec_ode_tpu_torch.parallel import ensemble_solve

torch.set_num_threads(1)


# -- the black boxes, each written for both packages over the same numpy
# matrices: A(t) = -i sum_k c_k(t) H_k as the pair (Im H, -Re H)

def _multi_coeffs(xp, t):
    """[1, t, cos 2 pi t, sin 2 pi t, cos 4 pi t, sin 4 pi t, cos 6 pi t,
    sin 6 pi t]: the eight-term drive on [0, 1]."""
    cols = [xp.ones_like(t), t]
    for n in (1, 2, 3):
        a = (2.0 * math.pi * n) * t
        cols += [xp.cos(a), xp.sin(a)]
    return cols


def _iq_coeffs(xp, t, w):
    """[1, cos w t, sin w t]: a drift and in-phase / quadrature controls."""
    return [xp.ones_like(t), xp.cos(w * t), xp.sin(w * t)]


def _hams(kind, d):
    """The Hermitian H_k (K, d, d) of a drive: I/Q on DrivenDense(d, 0)'s
    H0 and V and DrivenDense(d, 1)'s V; 'multi' the drift and seven
    controls DrivenDense(d, s).V, s = 1 .. 7."""
    m0 = JDrivenDense.make(d=d, seed=0)
    if kind == "iq":
        return np.stack([m0.H0, m0.V, JDrivenDense.make(d=d, seed=1).V]), \
            float(m0.w)
    return np.stack([m0.H0] + [JDrivenDense.make(d=d, seed=s).V
                               for s in range(1, 8)]), None


def jax_op(kind, d):
    H, w = _hams(kind, d)
    Hr, Hi = jnp.asarray(H.real), jnp.asarray(H.imag)

    def op_fn(t):
        t = jnp.asarray(t, jnp.float64)
        c = jnp.stack(_iq_coeffs(jnp, t, w) if kind == "iq"
                      else _multi_coeffs(jnp, t))
        return jcp.Cplx(jnp.einsum("k,kij->ij", c, Hi),
                        -jnp.einsum("k,kij->ij", c, Hr))
    return op_fn


def torch_op(kind, d):
    H, w = _hams(kind, d)
    Hr, Hi = torch.as_tensor(H.real), torch.as_tensor(H.imag)

    def op_fn(t):
        t = torch.as_tensor(t, dtype=torch.float64)
        c = torch.stack(_iq_coeffs(torch, t, w) if kind == "iq"
                        else _multi_coeffs(torch, t))
        return tcp.Cplx(torch.einsum("k,kij->ij", c, Hi),
                        -torch.einsum("k,kij->ij", c, Hr))
    return op_fn


def _drive_ops(d):
    jm, tm = JDrivenDense.make(d=d, seed=0), DrivenDense.make(d=d, seed=0)
    return (lambda t: jm.op_pair(t, jnp.float64),
            lambda t: tm.op_pair(t, torch.float64, device="cpu"))


# name: (jax op_fn, port op_fn, t0, tf, K)
CASES = {
    "drive_k2": (*_drive_ops(16), 0.0, 2.0, 2),
    "iq_k3": (jax_op("iq", 8), torch_op("iq", 8), 0.0, 1.0, 3),
    "multi_k8": (jax_op("multi", 4), torch_op("multi", 4), 0.0, 1.0, 8),
}


@functools.cache
def recovered(name):
    jop, top, t0, tf, _ = CASES[name]
    return (vexp.auto_modulated(jop, t0, tf),
            texp.auto_modulated(top, t0, tf, device="cpu"))


def _basis(mod):
    b = mod.basis
    return np.concatenate([np.asarray(b.re).reshape(b.re.shape[0], -1),
                           np.asarray(b.im).reshape(b.im.shape[0], -1)], 1)


def _signs(jmod, tmod):
    """The sign of each recovered direction of the port against JAX's."""
    return np.sign(np.sum(_basis(jmod) * _basis(tmod), axis=1))


@pytest.mark.parametrize("name", list(CASES))
def test_recovers_the_same_structure_as_jax(name):
    jmod, tmod = recovered(name)
    K = CASES[name][4]
    assert jmod is not None and tmod is not None
    assert jmod.n_terms == tmod.n_terms == K
    assert tmod.is_cplx and tmod.basis.re.dtype == torch.float64
    s = _signs(jmod, tmod)
    np.testing.assert_allclose(_basis(tmod) * s[:, None], _basis(jmod),
                               rtol=0, atol=1e-12)
    # the projection reconstructs A(t), as JAX's does
    top = CASES[name][1]
    for t in (0.137, 0.7137):
        A, R = top(t), tmod.assemble(torch.tensor(t, dtype=torch.float64))
        JR = jmod.assemble(jnp.asarray(t, jnp.float64))
        for part in ("re", "im"):
            np.testing.assert_allclose(getattr(R, part).numpy(),
                                       getattr(A, part).numpy(), rtol=0,
                                       atol=1e-12)
            np.testing.assert_allclose(getattr(R, part).numpy(),
                                       np.asarray(getattr(JR, part)),
                                       rtol=0, atol=1e-12)
    # coeff_fn on a batch of times: one vmap and one product
    ts = torch.linspace(CASES[name][2], CASES[name][3], 5,
                        dtype=torch.float64)
    c = tmod.coeff_fn(ts)
    assert c.shape == (5, K)
    np.testing.assert_allclose(
        c.numpy(), np.stack([tmod.coeff_fn(t).numpy() for t in ts]),
        rtol=0, atol=1e-14)


def _jax_series(jmod):
    """The (n, K) series, lo and hi of JAX's coeff_cols_fn closure."""
    fn = jmod.coeff_cols_fn
    cells = dict(zip(fn.__code__.co_freevars,
                     (c.cell_contents for c in fn.__closure__)))
    return np.asarray(cells["coeffs"]).T, cells["lo"], cells["hi"]


@pytest.mark.parametrize("name", list(CASES))
def test_cheb_form_samples_as_jax(name):
    """ChebForm.sample on JAX's own series against JAX's coeff_cols_fn at
    64 times: 1e-14 in f64, 1e-6 relative in f32; the port's own fit
    against JAX's, directions aligned, within 1e-12."""
    jmod, tmod = recovered(name)
    t0, tf = CASES[name][2:4]
    series, lo, hi = _jax_series(jmod)
    form = texp.ChebForm(series, lo, hi)
    assert form.n_terms == jmod.n_terms
    ts = np.linspace(t0, tf, 64)
    want = np.stack(jmod.coeff_cols_fn(jnp.asarray(ts)), -1)
    got = form.sample(torch.as_tensor(ts)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-14)
    want32 = np.stack(jmod.coeff_cols_fn(jnp.asarray(ts, jnp.float32)), -1)
    got32 = form.sample(torch.as_tensor(ts, dtype=torch.float32)).numpy()
    np.testing.assert_allclose(got32, want32, rtol=1e-6,
                               atol=1e-6 * np.abs(want32).max())
    # the port's own fit
    assert isinstance(tmod.form, texp.ChebForm)
    assert tmod.form.n_coeffs == form.n_coeffs
    np.testing.assert_allclose(
        tmod.form.sample(torch.as_tensor(ts)).numpy() * _signs(jmod, tmod),
        want, rtol=0, atol=1e-12)


def test_cheb_form_carries_nan_and_validates():
    form = texp.ChebForm(np.zeros((3, 2)), 0.0, 1.0)
    out = form.sample(torch.tensor([0.5, float("nan")], dtype=torch.float64))
    assert out[0].eq(0).all() and out[1].isnan().all()
    with pytest.raises(ValueError):
        texp.ChebForm(np.zeros((0, 2)), 0.0, 1.0)
    with pytest.raises(ValueError):
        texp.ChebForm(np.zeros((3, 2)), 1.0, 1.0)


# -- the rejections of tests/test_auto_modulated.py ------------------------

def _real_pair(xp, cplx, A):
    return cplx.Cplx(A, xp.zeros_like(A))


def _rejections():
    rng = np.random.default_rng(1)
    Ms = rng.standard_normal((40, 8, 8))
    sz = np.array([[0.5, 0.0], [0.0, -0.5]])

    def forty(xp, cplx):
        M = xp.asarray(Ms) if xp is jnp else torch.as_tensor(Ms)

        def op_fn(t):
            w = xp.cos(xp.arange(40, dtype=xp.float64) * 2.1
                       * xp.asarray(t, dtype=xp.float64))
            return _real_pair(xp, cplx, xp.einsum("k,kij->ij", w, M))
        return op_fn

    def nan(xp, cplx):
        return lambda t: _real_pair(xp, cplx, xp.full((4, 4), float("nan"),
                                                      dtype=xp.float64))

    def zero(xp, cplx):
        return lambda t: _real_pair(xp, cplx, xp.zeros((4, 4),
                                                       dtype=xp.float64))

    def chirp(xp, cplx):
        s = xp.asarray(sz)
        return lambda t: xp.cos(8.0 * xp.asarray(t, dtype=xp.float64)
                                * xp.asarray(t, dtype=xp.float64)) * s

    def sine(xp, cplx):
        s = xp.asarray(sz)
        return lambda t: xp.sin(xp.asarray(t, dtype=xp.float64)) * s

    # name: (builder, t0, tf, kwargs, expected: None, or (K, has form))
    return {
        "forty_directions": (forty, 0.0, 1.0, dict(k_max=8), None),
        "nan": (nan, 0.0, 1.0, {}, None),
        "zero": (zero, 0.0, 1.0, {}, None),
        "unfittable_chirp": (chirp, 0.0, 30.0, {}, (1, False)),
        "fit_cols_off": (sine, 0.0, 3.0, dict(fit_cols=False), (1, False)),
    }


REJECTIONS = _rejections()


@pytest.mark.parametrize("name", list(REJECTIONS))
def test_rejections_match_jax(name):
    build, t0, tf, kw, expected = REJECTIONS[name]
    jmod = vexp.auto_modulated(build(jnp, jcp), t0, tf, **kw)
    tmod = texp.auto_modulated(build(torch, tcp), t0, tf, device="cpu",
                               **kw)
    if expected is None:
        assert jmod is None and tmod is None
        return
    K, has_form = expected
    assert jmod.n_terms == tmod.n_terms == K
    assert (jmod.coeff_cols_fn is not None) == has_form
    assert (tmod.form is not None) == has_form


def test_real_operator_support():
    A0 = np.diag(np.arange(1.0, 5.0))
    A1 = np.eye(4)[::-1].copy()
    jmod = vexp.auto_modulated(
        lambda t: jnp.asarray(A0) + jnp.sin(jnp.asarray(t)) * jnp.asarray(A1),
        0.0, 3.0)
    top = (lambda t: torch.as_tensor(A0) + torch.sin(
        torch.as_tensor(t, dtype=torch.float64)) * torch.as_tensor(A1))
    tmod = texp.auto_modulated(top, 0.0, 3.0, device="cpu")
    assert tmod.n_terms == jmod.n_terms == 2 and not tmod.is_cplx
    assert isinstance(tmod.form, texp.ChebForm)
    s = np.sign(np.sum(np.asarray(jmod.basis).reshape(2, -1)
                       * tmod.basis.numpy().reshape(2, -1), axis=1))
    np.testing.assert_allclose(tmod.basis.numpy() * s[:, None, None],
                               np.asarray(jmod.basis), rtol=0, atol=1e-12)
    R = tmod.assemble(torch.tensor(1.234, dtype=torch.float64))
    np.testing.assert_allclose(R.numpy(), top(1.234).numpy(), rtol=0,
                               atol=1e-12)


def test_landau_zener_black_box_recovers_two_terms():
    """The black box of bench_lz_blackbox_auto: LandauZener.op_pair over
    [-20, 20] recovers two terms with a Chebyshev form, as in JAX; its
    pair is JAX's op_pair bit for bit, and op is -i H."""
    jlz, tlz = JLandauZener(v=2.0, delta=0.4), LandauZener(v=2.0, delta=0.4)
    for t in (-17.3, 0.0, 4.56):
        jp = jlz.op_pair(t, jnp.float64)
        tp = tlz.op_pair(t, torch.float64, device="cpu")
        np.testing.assert_array_equal(tp.im.numpy(), np.asarray(jp.im))
        np.testing.assert_array_equal(tp.re.numpy(), 0.0)
        np.testing.assert_allclose(tlz.op(t, device="cpu").numpy(),
                                   np.asarray(jlz.op(t)), rtol=0, atol=1e-15)
    jmod = vexp.auto_modulated(lambda t: jlz.op_pair(t, jnp.float64),
                               -20.0, 20.0)
    tmod = texp.auto_modulated(
        lambda t: tlz.op_pair(t, torch.float64, device="cpu"), -20.0, 20.0,
        device="cpu")
    assert jmod.n_terms == tmod.n_terms == 2
    assert jmod.coeff_cols_fn is not None and tmod.form is not None


# -- ensembles over a recovered operator -----------------------------------

B, TF = 6, 0.3
CTL = dict(rtol=1e-6, min_dt=1e-6, max_dt=0.2, max_steps=2000)
STEPPERS = {"magnus4": ("MagnusModulated4", {}),
            "magnus6": ("MagnusModulated6", {}),
            "cfm4": ("CFM4Modulated", {})}
ENSEMBLES = {"drive_k2": (*_drive_ops(8), 0.0, 1.0, 2),
             "iq_k3": CASES["iq_k3"]}


@functools.cache
def _ens_recovered(name):
    jop, top, t0, tf, K = ENSEMBLES[name]
    jmod = vexp.auto_modulated(jop, t0, tf)
    tmod = texp.auto_modulated(top, t0, tf, device="cpu")
    assert jmod.n_terms == tmod.n_terms == K and tmod.form is not None
    return jmod, tmod


@functools.cache
def _psi(d):
    rng = np.random.default_rng(3)
    psi = rng.standard_normal((B, d)) + 1j * rng.standard_normal((B, d))
    return psi / np.linalg.norm(psi, axis=-1, keepdims=True)


def _cheb_coeff_fn(jmod):
    """JAX's Chebyshev columns as a coeff_fn: the loop kernel's
    coefficients, through the XLA driver."""
    return lambda t: jnp.stack(jmod.coeff_cols_fn(jnp.asarray(t)), -1)


@functools.cache
def _jax_solve(name, stepper, route):
    jmod, _ = _ens_recovered(name)
    if route == "loop":
        jmod = vexp.ModulatedOperator(basis=jmod.basis,
                                      coeff_fn=_cheb_coeff_fn(jmod))
    cls, kw = STEPPERS[stepper]
    d = jmod.basis.re.shape[-1]
    sol = jensemble_solve(
        None, jcp.from_complex(_psi(d), jnp.float64), 0.0, TF,
        stepper=getattr(vexp, cls)(jmod, use_pallas=False, **kw),
        ctl=vo.StepControl(**CTL), h0=1e-2, time_dtype=jnp.float64)
    return {k: np.asarray(getattr(sol, k)) for k in
            ("status", "n_accept", "n_reject", "n_iters")} | {
        "y": np.concatenate([np.asarray(sol.y_final.re),
                             np.asarray(sol.y_final.im)], -1)}


def _port_solve(mod, stepper):
    cls, kw = STEPPERS[stepper]
    d = mod.basis.re.shape[-1]
    return ensemble_solve(
        None, tcp.from_complex(_psi(d), torch.float64, device="cpu"), 0.0,
        TF, stepper=getattr(texp, cls)(mod, **kw),
        ctl=vt.StepControl(**CTL), h0=1e-2, time_dtype=torch.float64)


def _gate(sol, want):
    for k in ("status", "n_accept", "n_reject", "n_iters"):
        np.testing.assert_array_equal(getattr(sol, k).numpy(), want[k],
                                      err_msg=k)
    assert (sol.status.numpy() == vt.DONE).all()
    y = torch.cat([sol.y_final.re, sol.y_final.im], 1).numpy()
    np.testing.assert_allclose(y, want["y"], rtol=0, atol=1e-12)


@pytest.mark.parametrize("route", ["per_step", "loop"])
@pytest.mark.parametrize("stepper", list(STEPPERS))
@pytest.mark.parametrize("name", list(ENSEMBLES))
def test_ensembles_match_jax(name, stepper, route):
    """The per-step route (no form: the host driver over the twin of K4,
    coefficients projected through op_fn) against JAX's per-step
    solve; the loop route (the fitted ChebForm: the twin of K2 with K5)
    against JAX's XLA driver over its Chebyshev columns."""
    _, tmod = _ens_recovered(name)
    mod = tmod if route == "loop" else dataclasses.replace(tmod, form=None)
    sol = _port_solve(mod, stepper)
    assert sol.path == ("torch-loop" if route == "loop" else "torch-driver")
    _gate(sol, _jax_solve(name, stepper, route))


def test_carried_jax_operator_runs_the_loop_as_jax():
    """JAX's recovered operator carried across as numpy (basis, series,
    lo, hi) by convert.modulated_from_numpy with a ChebForm: the loop
    twin takes JAX's steps over the very same operator."""
    jmod, _ = _ens_recovered("iq_k3")
    series, lo, hi = _jax_series(jmod)
    mod = convert.modulated_from_numpy(
        np.asarray(jmod.basis.re), np.asarray(jmod.basis.im),
        texp.ChebForm(series, lo, hi), device="cpu")
    sol = _port_solve(mod, "magnus4")
    assert sol.path == "torch-loop"
    _gate(sol, _jax_solve("iq_k3", "magnus4", "loop"))


def test_loop_declines_without_a_form():
    """fused_loop_solve returns None for an operator without a form (JAX:
    coeff_cols_fn None), so ensemble_solve takes the per-step path."""
    _, tmod = _ens_recovered("drive_k2")
    st = texp.MagnusModulated4(dataclasses.replace(tmod, form=None))
    y0 = tcp.from_complex(_psi(8), torch.float64, device="cpu")
    grid = vt.make_grid(0.0, TF, dtype=torch.float64, device="cpu")
    assert st.fused_loop_solve(y0, grid, 1e-2, ctl=vt.StepControl(**CTL),
                               adaptive=True) is None

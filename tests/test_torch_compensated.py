"""The compensated (double-word) tier of the port (``comp.py``,
``compensated=True`` on ``RungeKutta``, ``ExpMidpoint``, ``Magnus4``
(``fast_error`` too), ``Magnus6`` and ``CFM``) against the JAX package:
the primitives bit for bit, every stepper on the scalar, vmapped and
natively batched tiers against the JAX package's compensated solve in f64
(counters equal per trajectory), and the cases of tests/test_compensated.py
in f32 against f64 references: drift removed, the rtol 1e-9 regime, the
batched tier. On the card the batched tier runs torch (no kernel has an
increment form): tests/test_torch_cuda.py and chip_smoke.py's
[compensated]."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vec_ode_tpu as vo
from vec_ode_tpu import comp as jcomp
from vec_ode_tpu import exp as jexp
from vec_ode_tpu.ops import cplx as jcp
from vec_ode_tpu.parallel import ensemble_solve as jensemble_solve
import vec_ode_tpu_torch as vt
from vec_ode_tpu_torch import comp
from vec_ode_tpu_torch import exp as texp
from vec_ode_tpu_torch.models import LandauZener
from vec_ode_tpu_torch.ops import dense_chains
from vec_ode_tpu_torch.ops.cplx import Cplx, from_complex
from vec_ode_tpu_torch.parallel import ensemble_solve

torch.set_num_threads(1)

D = 8


def _mats():
    """H0, H1 (Hermitian, d = 8) and a unit psi0, the generator of
    tests/test_compensated.py:_driven_dense."""
    rng = np.random.default_rng(1)

    def mk(s):
        H = rng.standard_normal((D, D)) + 1j * rng.standard_normal((D, D))
        H = 0.5 * (H + H.conj().T)
        return H * s / np.linalg.norm(H, 2)

    H0, H1 = mk(0.5), mk(0.25)
    psi0 = rng.standard_normal(D) + 1j * rng.standard_normal(D)
    return H0, H1, psi0 / np.linalg.norm(psi0)


H0, H1, PSI0 = _mats()


def _op(dtype, quantized=True, device="cpu"):
    """A(t) = -i (H0 + sin(1.3 t) H1) as a Cplx pair. ``quantized``: the
    assembly in float32 for every dtype (the JAX test's op_pair), so that
    f32 and f64 solves integrate the same ODE; else in ``dtype``."""
    at = torch.float32 if quantized else dtype
    mats = [torch.as_tensor(m, dtype=at, device=device)
            for m in (H0.real, H0.imag, H1.real, H1.imag)]

    def op(t):
        s = torch.sin(1.3 * torch.as_tensor(t).to(at))
        hre, him = mats[0] + s * mats[2], mats[1] + s * mats[3]
        return Cplx(him.to(dtype), (-hre).to(dtype))

    return op


def _jop(dtype):
    mats = [jnp.asarray(m, jnp.float64) for m in
            (H0.real, H0.imag, H1.real, H1.imag)]

    def op(t):
        s = jnp.sin(1.3 * t)
        return jcp.Cplx((mats[1] + s * mats[3]).astype(dtype),
                        (-(mats[0] + s * mats[2])).astype(dtype))

    return op


def _psis(B=3, seed=7):
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((B, D)) + 1j * rng.standard_normal((B, D))
    return z / np.linalg.norm(z, axis=1, keepdims=True)


# -- primitives -------------------------------------------------------------

def test_two_sum_exact():
    s, e = comp.two_sum(torch.tensor(1.0), torch.tensor(1e-9))
    assert float(s) + float(e) == pytest.approx(1.0 + 1e-9, abs=1e-17)
    assert float(s) == 1.0 and float(e) == pytest.approx(1e-9, rel=1e-6)
    rng = np.random.default_rng(0)
    a = rng.standard_normal(64).astype(np.float32)
    b = (rng.standard_normal(64) * 1e-5).astype(np.float32)
    ts, te = comp.two_sum(torch.as_tensor(a), torch.as_tensor(b))
    js, je = jcomp.two_sum(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    # the residual is exact: a + b == s + e in float64
    np.testing.assert_array_equal(
        a.astype(np.float64) + b, ts.double().numpy() + te.double().numpy())


def test_comp_update_accumulates_exactly():
    """10 000 increments of 1e-8 onto 1 in float32: the pair keeps them,
    the plain sum loses every one; bit for bit the JAX package's."""
    hi = Cplx(torch.ones(3), torch.ones(3))
    lo = comp.zero_lo(hi)
    jhi = jcp.Cplx(jnp.ones(3, jnp.float32), jnp.ones(3, jnp.float32))
    jlo = jcomp.zero_lo(jhi)
    plain = torch.ones(3)
    d = Cplx(torch.full((3,), 1e-8), torch.full((3,), 1e-8))
    jd = jcp.Cplx(jnp.full(3, 1e-8, jnp.float32),
                  jnp.full(3, 1e-8, jnp.float32))
    for _ in range(100):
        hi, lo = comp.update(hi, lo, d)
        jhi, jlo = jcomp.update(jhi, jlo, jd)
        plain = plain + d.re
    total = float(hi.re[0]) + float(lo.re[0])
    assert total == pytest.approx(1.0 + 1e-6, rel=1e-7)
    assert float(plain[0]) == 1.0
    np.testing.assert_array_equal(lo.re.numpy(), np.asarray(jlo.re))
    np.testing.assert_array_equal(hi.im.numpy(), np.asarray(jhi.im))


def test_chain_increment_matches_jax():
    rng = np.random.default_rng(3)
    phis = [rng.standard_normal((D, D)) * 0.01 for _ in range(3)]
    x = rng.standard_normal(D)

    def tmap(p, v):
        return p @ v

    got = comp.chain_increment(tmap, [torch.as_tensor(p) for p in phis],
                               torch.as_tensor(x))
    want = jcomp.chain_increment(lambda p, v: p @ v,
                                 [jnp.asarray(p) for p in phis],
                                 jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-14)
    full = x.copy()
    for p in phis:
        full = (np.eye(D) + p) @ full
    np.testing.assert_allclose(got.numpy(), full - x, rtol=1e-12)


# -- parity with the JAX package, f64 ---------------------------------------

EXP = {
    "midpoint": (lambda lib, **kw: lib.ExpMidpoint(lib.DenseCplxSplit(),
                                                   **kw), False),
    "magnus4": (lambda lib, **kw: lib.Magnus4(lib.DenseCplxSplit(), **kw),
                True),
    "magnus4_fast": (lambda lib, **kw: lib.Magnus4(
        lib.DenseCplxSplit(), fast_error=True, **kw), True),
    "magnus6": (lambda lib, **kw: lib.Magnus6(lib.DenseCplxSplit(), **kw),
                True),
    "cfm4": (lambda lib, **kw: lib.CFM4(lib.DenseCplxSplit(), **kw), True),
}
CTL9 = dict(rtol=1e-9, min_dt=1e-9, max_dt=0.5, max_steps=20000)


def _kw(adaptive):
    return dict(adaptive=adaptive, h0=1e-2 if adaptive else 0.05)


@functools.cache
def _jax_exp(name, tier):
    make, adaptive = EXP[name]
    ctl = vo.StepControl(**CTL9)
    if tier == "scalar":
        sol = vo.solve_linear(_jop(jnp.float64), 0.0, 1.0,
                              jcp.from_complex(PSI0, jnp.float64),
                              stepper=make(jexp, compensated=True), ctl=ctl,
                              **_kw(adaptive))
    else:
        sol = jensemble_solve(
            _jop(jnp.float64), jcp.from_complex(_psis(), jnp.float64), 0.0,
            1.0, stepper=make(jexp, compensated=True,
                              batched=tier == "batched"), ctl=ctl,
            **_kw(adaptive))
    return (np.asarray(sol.n_accept), np.asarray(sol.n_reject),
            np.asarray(sol.y_final.re), np.asarray(sol.y_final.im))


@pytest.mark.parametrize("tier", ["scalar", "vmapped", "batched"])
@pytest.mark.parametrize("name", list(EXP))
def test_exp_steppers_match_jax_f64(name, tier):
    """Every compensated exponential stepper on every tier takes the JAX
    package's steps (counters equal per trajectory) to the same states
    (1e-12: both carry the same double-word arithmetic in f64)."""
    make, adaptive = EXP[name]
    ctl = vt.StepControl(**CTL9)
    if tier == "scalar":
        sol = vt.solve_linear(_op(torch.float64, quantized=False), 0.0, 1.0,
                              from_complex(PSI0, device="cpu"),
                              stepper=make(texp, compensated=True), ctl=ctl,
                              **_kw(adaptive))
    else:
        st = make(texp, compensated=True, batched=tier == "batched")
        assert st.has_carry
        sol = ensemble_solve(_op(torch.float64, quantized=False),
                             from_complex(_psis(), device="cpu"), 0.0, 1.0,
                             stepper=st, ctl=ctl, **_kw(adaptive))
    na, nr, yre, yim = _jax_exp(name, tier)
    np.testing.assert_array_equal(sol.n_accept.numpy(), na)
    np.testing.assert_array_equal(sol.n_reject.numpy(), nr)
    np.testing.assert_allclose(sol.y_final.re.numpy(), yre, rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(sol.y_final.im.numpy(), yim, rtol=0,
                               atol=1e-12)


def _skew():
    rng = np.random.default_rng(0)
    A = rng.standard_normal((8, 8)) * 0.5
    y0 = rng.standard_normal(8)
    return A - A.T, y0 / np.linalg.norm(y0)


RK = {"rkf45": dict(), "dopri5_fsal": dict(advance_lower=False)}


@functools.cache
def _jax_rk(name, tier):
    A, y0 = _skew()
    kw = RK[name]
    st = vo.RungeKutta(vo.DOPRI5 if "dopri" in name else vo.RKF45,
                       compensated=True, **kw)
    Aj = jnp.asarray(A)
    ctl = vo.StepControl(**CTL9)
    if tier == "scalar":
        sol = vo.solve_ivp(lambda t, y: Aj @ y, 0.0, 2.0, jnp.asarray(y0),
                           stepper=st, ctl=ctl, save_at=jnp.asarray([0.5]))
    else:
        sol = jensemble_solve(lambda t, y: Aj @ y,
                              jnp.asarray(np.stack([y0, -y0, 2 * y0])), 0.0,
                              2.0, stepper=st, ctl=ctl, h0=1e-2)
    return np.asarray(sol.n_accept), np.asarray(sol.y_final)


@pytest.mark.parametrize("tier", ["scalar", "vmapped"])
@pytest.mark.parametrize("name", list(RK))
def test_rk_matches_jax_f64(name, tier):
    """RungeKutta(compensated=True), with and without FSAL (carry (k0,
    lo)), on the scalar and vmapped tiers: the JAX package's steps and
    states."""
    A, y0 = _skew()
    st = vt.RungeKutta(vt.DOPRI5 if "dopri" in name else vt.RKF45,
                       compensated=True, **RK[name])
    assert st.has_carry and st.use_fsal == ("fsal" in name)
    At = torch.as_tensor(A)
    ctl = vt.StepControl(**CTL9)
    if tier == "scalar":
        sol = vt.solve_ivp(lambda t, y: At @ y, 0.0, 2.0, torch.as_tensor(y0),
                           stepper=st, ctl=ctl, save_at=[0.5])
    else:
        sol = ensemble_solve(lambda t, y: At @ y,
                             torch.as_tensor(np.stack([y0, -y0, 2 * y0])),
                             0.0, 2.0, stepper=st, ctl=ctl, h0=1e-2)
    na, yf = _jax_rk(name, tier)
    np.testing.assert_array_equal(sol.n_accept.numpy(), na)
    np.testing.assert_allclose(sol.y_final.numpy(), yf, rtol=0, atol=1e-13)


# -- the f32 properties of tests/test_compensated.py -------------------------

def _run_rk_fixed(A, y0, dtype, compensated, n, T):
    Ad = torch.as_tensor(A, dtype=dtype)
    sol = vt.solve_ivp(lambda t, y: Ad @ y, 0.0, T,
                       torch.as_tensor(y0, dtype=dtype),
                       stepper=vt.RungeKutta(compensated=compensated),
                       adaptive=False, h0=T / n,
                       ctl=vt.StepControl(max_steps=n + 10, min_dt=1e-9),
                       time_dtype=torch.float64)
    assert int(sol.status) == vt.DONE
    return sol.y_final.double().numpy()


def test_rk_fixed_step_drift_eliminated():
    """The same step sequence in both precisions: the difference is the
    state's rounding, which the pair removes (the JAX test's bounds at a
    quarter of its 8000 steps over a quarter of its span)."""
    A, y0 = _skew()
    n, T = 2000, 2.0
    ref = _run_rk_fixed(A, y0, torch.float64, False, n, T)
    e_plain = np.abs(_run_rk_fixed(A, y0, torch.float32, False, n, T)
                     - ref).max()
    e_comp = np.abs(_run_rk_fixed(A, y0, torch.float32, True, n, T)
                    - ref).max()
    assert e_comp < e_plain / 5.0 and e_comp < 3e-7, (e_comp, e_plain)


def _lz_op(dtype):
    lz = LandauZener(v=2.0, delta=0.5)
    return lambda t: lz.op_pair(t, dtype, device="cpu")


def test_magnus4_fixed_step_drift_eliminated():
    psi0 = np.zeros(2, np.complex128)
    psi0[0] = 1.0

    def run(dtype, compensated):
        sol = vt.solve_linear(
            _lz_op(dtype), -5.0, 5.0, from_complex(psi0, dtype,
                                                   device="cpu"),
            stepper=texp.Magnus4(texp.DenseCplxSplit(),
                                 compensated=compensated),
            adaptive=False, h0=10.0 / 2000,
            ctl=vt.StepControl(max_steps=2100, min_dt=1e-9),
            time_dtype=torch.float64)
        assert int(sol.status) == vt.DONE
        return (sol.y_final.re.double() + 1j * sol.y_final.im.double()
                ).numpy()

    ref = run(torch.float64, False)
    e_plain = np.linalg.norm(run(torch.float32, False) - ref)
    e_comp = np.linalg.norm(run(torch.float32, True) - ref)
    assert e_comp < e_plain / 4.0 and e_comp < 5e-7, (e_comp, e_plain)


def _adaptive(dtype, rtol, stepper, max_steps=100_000):
    sol = vt.solve_linear(_op(dtype), 0.0, 2.0,
                          from_complex(PSI0, dtype, device="cpu"),
                          stepper=stepper, adaptive=True,
                          ctl=vt.StepControl(rtol=rtol, min_dt=1e-9,
                                             max_dt=0.5,
                                             max_steps=max_steps),
                          h0=1e-3, time_dtype=torch.float64)
    z = (sol.y_final.re.double() + 1j * sol.y_final.im.double()).numpy()
    return sol, z


@functools.cache
def _ref():
    return _adaptive(torch.float64, 1e-12,
                     texp.Magnus4(texp.DenseCplxSplit()))[1]


def _rel(z):
    return np.linalg.norm(z - _ref()) / np.linalg.norm(_ref())


def test_magnus4_adaptive_rtol_1e9():
    """At rtol 1e-9 in f32 the plain pair storms with rejects; the
    increment-form estimate does not, and the error falls 20x."""
    sp, zp = _adaptive(torch.float32, 1e-9,
                       texp.Magnus4(texp.DenseCplxSplit()))
    sc, zc = _adaptive(torch.float32, 1e-9,
                       texp.Magnus4(texp.DenseCplxSplit(), compensated=True))
    assert int(sc.status) == vt.DONE
    assert _rel(zc) < 1e-7 and _rel(zc) < _rel(zp) / 20.0
    assert int(sc.n_reject) < int(sp.n_reject) / 10


def test_magnus6_adaptive_usable_at_rtol_1e8():
    """Plain f32 Magnus-6 rejects every step at rtol 1e-8 (its estimate's
    ~1e-7 floor) and runs into max_steps; compensated it is DONE."""
    sp, _ = _adaptive(torch.float32, 1e-8,
                      texp.Magnus6(texp.DenseCplxSplit()), max_steps=1500)
    assert int(sp.status) == vt.ERR_MAX_STEPS
    sc, zc = _adaptive(torch.float32, 1e-8,
                       texp.Magnus6(texp.DenseCplxSplit(), compensated=True))
    assert int(sc.status) == vt.DONE and int(sc.n_accept) < 2000
    assert _rel(zc) < 2e-7


def test_cfm4_compensated_adaptive():
    sc, zc = _adaptive(torch.float32, 1e-9,
                       texp.CFM4(texp.DenseCplxSplit(), compensated=True))
    assert int(sc.status) == vt.DONE and _rel(zc) < 2e-7


def test_expmidpoint_compensated_runs():
    sol = vt.solve_linear(_op(torch.float32), 0.0, 1.0,
                          from_complex(PSI0, torch.float32, device="cpu"),
                          stepper=texp.ExpMidpoint(texp.DenseCplxSplit(),
                                                   compensated=True),
                          adaptive=False, h0=1e-2,
                          ctl=vt.StepControl(max_steps=200, min_dt=1e-9),
                          time_dtype=torch.float64)
    assert int(sol.status) == vt.DONE


def test_rk_compensated_adaptive_with_save_grid_and_rejects():
    """Rejects and grid hits: the lo word advances only with the state."""
    A, y0 = _skew()

    def run(dtype, compensated, rtol):
        Ad = torch.as_tensor(A, dtype=dtype)
        return vt.solve_ivp(lambda t, y: Ad @ y, 0.0, 4.0,
                            torch.as_tensor(y0, dtype=dtype),
                            stepper=vt.RungeKutta(compensated=compensated),
                            save_at=[1.0, 2.5],
                            ctl=vt.StepControl(rtol=rtol, min_dt=1e-9,
                                               max_dt=0.5,
                                               max_steps=100_000),
                            time_dtype=torch.float64)

    ref = run(torch.float64, False, 1e-12)
    sc = run(torch.float32, True, 1e-8)
    assert int(sc.status) == vt.DONE and int(sc.n_reject) > 0
    assert np.abs(sc.ys.double().numpy() - ref.ys.numpy()).max() < 5e-6


def test_dopri5_fsal_compensated():
    A, y0 = _skew()
    st = vt.RungeKutta(vt.DOPRI5, advance_lower=False, compensated=True)
    assert st.has_carry and st.use_fsal
    Ad = torch.as_tensor(A, dtype=torch.float32)
    sol = vt.solve_ivp(lambda t, y: Ad @ y, 0.0, 4.0,
                       torch.as_tensor(y0, dtype=torch.float32), stepper=st,
                       ctl=vt.StepControl(rtol=1e-7, min_dt=1e-9, max_dt=0.5,
                                          max_steps=100_000),
                       time_dtype=torch.float64)
    assert int(sol.status) == vt.DONE
    ref = _run_rk_fixed(A, y0, torch.float64, False, n=4000, T=4.0)
    assert np.abs(sol.y_final.double().numpy() - ref).max() < 1e-5


def test_batched_compensated_matches_scalar():
    """The batched tier's compensated executor (stacked expm_m1, chains in
    increment form, TwoSum) against the scalar compensated solve of each
    row, f32."""
    psis = _psis(3, seed=7)
    st = texp.Magnus4(texp.DenseCplxSplit(), compensated=True)
    ctl = vt.StepControl(rtol=1e-9, min_dt=1e-9, max_dt=0.5,
                         max_steps=100_000)
    kw = dict(ctl=ctl, h0=1e-3, adaptive=True, time_dtype=torch.float64)
    before = dense_chains.fused_dense_chain_apply.launches
    sol_b = ensemble_solve(_op(torch.float32),
                           from_complex(psis, torch.float32, device="cpu"),
                           0.0, 2.0, stepper=st, **kw)
    assert dense_chains.fused_dense_chain_apply.launches == before
    assert bool((sol_b.status == vt.DONE).all())
    for i in range(3):
        sol_s = vt.solve_linear(_op(torch.float32), 0.0, 2.0,
                                from_complex(psis[i], torch.float32,
                                             device="cpu"), stepper=st, **kw)
        zb = (sol_b.y_final.re[i] + 1j * sol_b.y_final.im[i]).numpy()
        zs = (sol_s.y_final.re + 1j * sol_s.y_final.im).numpy()
        assert np.linalg.norm(zb - zs) < 1e-6
        assert abs(int(sol_b.n_accept[i]) - int(sol_s.n_accept)) <= 2


def test_batched_compensated_improves_lz():
    """The batched tier on a Landau-Zener sweep at rtol 1e-9: the error
    falls 5x (the JAX test's bound; its span [-10, 10] halved, and the
    f64 reference by Magnus-6 at rtol 1e-13, to keep the CPU run short)."""
    psi0 = np.zeros((2, 2), np.complex128)
    psi0[:, 0] = 1.0

    def run(dtype, stepper, rtol):
        sol = ensemble_solve(
            _lz_op(dtype), from_complex(psi0, dtype, device="cpu"), -5.0,
            5.0, stepper=stepper,
            ctl=vt.StepControl(rtol=rtol, min_dt=1e-9, max_dt=0.5,
                               max_steps=400_000),
            h0=1e-3, time_dtype=torch.float64)
        assert bool((sol.status == vt.DONE).all())
        return (sol.y_final.re.double() + 1j * sol.y_final.im.double()
                ).numpy()

    ref = run(torch.float64, texp.Magnus6(texp.DenseCplxSplit()), 1e-13)
    e_plain = np.linalg.norm(run(torch.float32, texp.Magnus4(
        texp.DenseCplxSplit()), 1e-9)[0] - ref[0])
    e_comp = np.linalg.norm(run(torch.float32, texp.Magnus4(
        texp.DenseCplxSplit(), compensated=True), 1e-9)[0] - ref[0])
    assert e_comp < e_plain / 5.0, (e_comp, e_plain)


@pytest.mark.parametrize("make", [
    lambda: texp.Magnus6(texp.DenseCplxSplit(), compensated=True),
    lambda: texp.Magnus4(texp.DenseCplxSplit(), compensated=True,
                         fast_error=True),
], ids=["magnus6_rtol_1e8", "fast_error_rtol_1e7"])
def test_batched_compensated_steppers_run(make):
    st = make()
    rtol = 1e-8 if isinstance(st, texp.Magnus6) else 1e-7
    sol = ensemble_solve(_op(torch.float32),
                         from_complex(_psis(2, seed=9), torch.float32,
                                      device="cpu"), 0.0, 2.0, stepper=st,
                         ctl=vt.StepControl(rtol=rtol, min_dt=1e-9,
                                            max_dt=0.5, max_steps=100_000),
                         h0=1e-3, time_dtype=torch.float64)
    assert bool((sol.status == vt.DONE).all())
    assert bool((sol.n_accept < 2000).all())


def test_compensated_with_events():
    """Events see the plain hi state: the event time of the f64 solve."""
    A, y0 = _skew()
    Ad = torch.as_tensor(A, dtype=torch.float32)
    sol = vt.solve_ivp(lambda t, y: Ad @ y, 0.0, 6.0,
                       torch.as_tensor(y0, dtype=torch.float32),
                       stepper=vt.RungeKutta(compensated=True),
                       events=vt.Event(lambda t, y: y[0]),
                       ctl=vt.StepControl(rtol=1e-7, min_dt=1e-9, max_dt=0.5,
                                          max_steps=100_000),
                       time_dtype=torch.float64)
    assert int(sol.status) == vt.DONE
    ref = vt.solve_ivp(lambda t, y: torch.as_tensor(A) @ y, 0.0, 6.0,
                       torch.as_tensor(y0), events=vt.Event(lambda t, y: y[0]),
                       ctl=vt.StepControl(rtol=1e-10, min_dt=1e-12,
                                          max_dt=0.5),
                       time_dtype=torch.float64)
    assert bool(sol.event_found.reshape(-1)[0])
    assert abs(float(sol.event_t.reshape(-1)[0])
               - float(ref.event_t.reshape(-1)[0])) < 1e-3


def test_dense_output_refuses_the_compensated_tier():
    with pytest.raises(ValueError, match="compensated"):
        ensemble_solve(_op(torch.float64),
                       from_complex(_psis(), device="cpu"), 0.0, 1.0,
                       stepper=texp.Magnus4(texp.DenseCplxSplit(),
                                            compensated=True,
                                            batched=False),
                       dense=True, save_at=[0.5], h0=1e-2)

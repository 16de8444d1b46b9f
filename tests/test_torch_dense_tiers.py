"""Dense output on the port's scalar and vmapped tiers
(``dense.solve_ivp_dense``, ``solve_linear_dense``,
``integrate_interp(interp_kind=, tab=, method=, init_carry_fn=)`` and
``ensemble_solve(dense=True)`` on the vmapped tier): the cases of
``tests/test_dense.py`` that ``tests/test_torch_dense.py`` does not hold,
against the JAX package in f64 on the same inputs (counters equal,
states and dense saves within 1e-12, ``test_torch_rk.assert_same_solution``)
and against closed forms: the DOPRI5 / BOSH32 continuous extensions
(``p_dense``), the FSAL slope carry, the split pair, the modulated
stepper, the batched carry against per-trajectory solves, the scan
gradient, and the overflowing and failed lanes."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

import vec_ode_tpu as vo
from vec_ode_tpu import dense as jdense
from vec_ode_tpu import exp as vexp
from vec_ode_tpu.models import DrivenDense as JDrivenDense
from vec_ode_tpu.ops import cplx as jcp
from vec_ode_tpu.parallel import ensemble_solve as jensemble_solve
import vec_ode_tpu_torch as vt
from vec_ode_tpu_torch import dense as tdense
from vec_ode_tpu_torch import exp as texp
from vec_ode_tpu_torch import lc
from vec_ode_tpu_torch.models import DrivenDense
from vec_ode_tpu_torch.ops import cplx as tcp
from vec_ode_tpu_torch.parallel import ensemble_solve

from test_torch_rk import (H_FINAL_PAIRS, H_FINAL_TIGHT,
                           assert_same_solution)

torch.set_num_threads(1)

F64 = torch.float64


def _side(side):
    if side == "jax":
        return dict(dense=jdense, vo=vo, exp=vexp, np=jnp, cp=jcp,
                    arr=lambda a: jnp.asarray(np.asarray(a)), sin=jnp.sin,
                    cos=jnp.cos, ensemble=jensemble_solve, kw={})
    return dict(dense=tdense, vo=vt, exp=texp, np=torch, cp=tcp,
                arr=lambda a: torch.as_tensor(np.asarray(a)), sin=torch.sin,
                cos=torch.cos, ensemble=ensemble_solve,
                kw=dict(device="cpu"))


A_ROT = np.asarray([[0.0, 1.0], [-1.0, 0.0]])
SAVE7 = tuple(np.linspace(0.1, 1.9, 7))

# name -> builder(S) of (solve_ivp_dense args, kwargs)
IVP = {
    # tests/test_dense.py:28 (RKF45, cubic Hermite with an extra slope)
    "decay_hermite": lambda S: ((lambda t, y: -y, 0.0, 2.0, S["arr"](1.0)),
                                dict(ctl=S["vo"].StepControl(rtol=1e-8),
                                     h0=1e-2, save_at=SAVE7)),
    # tests/test_dense.py:63 (a vector state)
    "rotation": lambda S: ((lambda t, y: S["arr"](A_ROT) @ y, 0.0, 2.0,
                            S["arr"]([1.0, 0.0])),
                           dict(ctl=S["vo"].StepControl(rtol=1e-9,
                                                        min_dt=1e-8),
                                save_at=(0.5, 1.0, 1.5))),
    # a dict state, DOPRI5's continuous extension with the FSAL carry
    "pytree_dopri5": lambda S: (
        (lambda t, y: {"a": -y["a"], "b": -2.0 * y["b"] + S["cos"](t)}, 0.0,
         1.5, {"a": S["arr"](1.0), "b": S["arr"]([0.5, -0.5])}),
        dict(tableau=S["vo"].DOPRI5, ctl=S["vo"].StepControl(rtol=1e-8),
             h0=1e-2, save_at=(0.3, 0.7, 1.1))),
    # tests/test_dense.py:206 (BOSH32's extension)
    "bosh32": lambda S: ((lambda t, y: -y, 0.0, 2.0, S["arr"](1.0)),
                         dict(tableau=S["vo"].BOSH32,
                              ctl=S["vo"].StepControl(rtol=1e-6), h0=1e-2,
                              save_at=tuple(np.linspace(0.2, 1.8, 5)))),
    # tests/test_dense.py:296 (p_dense where the advance allows it)
    "pdense_cos": lambda S: ((lambda t, y: -y + S["cos"](t), 0.0, 1.0,
                              S["arr"](0.5)),
                             dict(tableau=S["vo"].DOPRI5,
                                  advance_lower=False,
                                  ctl=S["vo"].StepControl(rtol=1e-10),
                                  h0=1e-2,
                                  save_at=tuple(np.linspace(0.1, 0.9, 7)))),
    # DOPRI5 advancing the lower solution: Hermite with an extra slope
    "dopri5_lower_hermite": lambda S: (
        (lambda t, y: -y + S["cos"](t), 0.0, 1.0, S["arr"](0.5)),
        dict(tableau=S["vo"].DOPRI5, advance_lower=True,
             ctl=S["vo"].StepControl(rtol=1e-8), h0=1e-2,
             save_at=(0.25, 0.5, 0.75))),
    # the scan driver, iterations past DONE
    "scan_dopri5": lambda S: ((lambda t, y: -1.3 * y, 0.0, 1.0,
                               S["arr"](1.0)),
                              dict(tableau=S["vo"].DOPRI5,
                                   ctl=S["vo"].StepControl(rtol=1e-8,
                                                           max_steps=64),
                                   h0=1e-2, save_at=(0.5,), method="scan")),
}


def _ivp(side, name):
    S = _side(side)
    args, kw = IVP[name](S)
    return S["dense"].solve_ivp_dense(*args, **kw, **S["kw"])


@functools.cache
def _jax_ivp(name):
    return _ivp("jax", name)


@pytest.mark.parametrize("name", sorted(IVP))
def test_solve_ivp_dense_matches_jax(name):
    sol = _ivp("torch", name)
    assert int(sol.status) == vt.DONE
    # h_final at rtol 1e-10: ROADMAP queue 3's limit for RK
    assert_same_solution(sol, _jax_ivp(name), h_rtol=H_FINAL_TIGHT)


def test_dense_matches_exact_solution():
    sol = _ivp("torch", "decay_hermite")
    np.testing.assert_allclose(sol.ys.numpy(), np.exp(-sol.ts.numpy()),
                               rtol=1e-5)
    assert sol.ys[0].item() == 1.0   # the t0 slot is the exact y0
    rot = _ivp("torch", "rotation")
    for i, t in enumerate(rot.ts.numpy()):
        np.testing.assert_allclose(rot.ys[i].numpy(),
                                   scipy.linalg.expm(A_ROT * t) @ [1, 0],
                                   atol=1e-6)
    b = _ivp("torch", "bosh32")
    np.testing.assert_allclose(b.ys.numpy(), np.exp(-b.ts.numpy()),
                               rtol=1e-4)


def test_dense_does_not_perturb_step_sequence():
    kw = dict(ctl=vt.StepControl(rtol=1e-8), h0=1e-2)
    y0 = torch.tensor(1.0, dtype=F64)
    save = tuple(np.linspace(0.05, 1.95, 17))
    a = vt.solve_ivp_dense(lambda t, y: -y, 0.0, 2.0, y0, **kw)
    b = vt.solve_ivp_dense(lambda t, y: -y, 0.0, 2.0, y0, save_at=save, **kw)
    for k in ("n_accept", "n_reject", "y_final"):
        assert torch.equal(getattr(a, k), getattr(b, k)), k
    # grid-hitting saves do take other steps
    c = vt.solve_ivp(lambda t, y: -y, 0.0, 2.0, y0, save_at=save, **kw)
    assert int(c.n_accept) != int(a.n_accept)


def _fixed_errors(tableau, hs, save):
    f = lambda t, y: torch.sin(3.0 * t) * y            # noqa: E731
    exact = np.exp((1.0 - np.cos(3.0 * np.asarray(save))) / 3.0)
    errs = []
    for h in hs:
        sol = vt.solve_ivp_dense(f, 0.0, 2.0, torch.tensor(1.0, dtype=F64),
                                 tableau=tableau, adaptive=False, h0=h,
                                 save_at=save,
                                 ctl=vt.StepControl(max_steps=10000))
        errs.append(np.abs(sol.ys[1:-1].numpy() - exact).max())
    return errs


def test_interpolation_orders():
    """Cubic Hermite converges at ~h^4 at a generic point
    (tests/test_dense.py:78), the DOPRI5 extension with slope > 3.9 at
    mid-step points (:183)."""
    e1, e2 = _fixed_errors(vt.RKF45, [0.2, 0.1], (0.777,))
    assert 3.3 < np.log2(e1 / e2) < 5.0, (e1, e2)
    hs = [0.2, 0.1, 0.05]
    errs = _fixed_errors(vt.DOPRI5, hs, tuple(np.linspace(0.13, 1.87, 11)))
    slopes = np.diff(np.log(errs)) / np.diff(np.log(hs))
    assert slopes.mean() > 3.9, (errs, slopes)


def test_fsal_p_dense_costs_no_extra_evaluation():
    """tests/test_dense.py:219: with p_dense and FSAL every iteration calls
    the RHS s - 1 times and the carry once; RKF45's Hermite right-end
    slope costs one more an iteration (the port evaluates every iteration,
    the finishing one too)."""
    def count(tableau):
        calls = [0]

        def f(t, y):
            calls[0] += 1
            return -y

        sol = vt.solve_ivp_dense(f, 0.0, 1.0, torch.tensor(1.0, dtype=F64),
                                 tableau=tableau, h0=1e-2,
                                 ctl=vt.StepControl(rtol=1e-6))
        return calls[0], int(sol.n_iters)

    calls, n = count(vt.DOPRI5)
    assert calls == 1 + 6 * n
    calls, n = count(vt.RKF45)
    assert calls == (6 + 1) * n


def test_dense_batched_carry_matches_per_trajectory_solves():
    """tests/test_dense.py:242: the natively batched dense driver equals
    per-trajectory dense solves, and the JAX package's batched one."""
    def fb(lib):
        rate = lib["arr"]([1.0, 2.0])
        return lambda t, y: -rate * y * (1.0 + 0.1 * lib["sin"](t))[..., None]

    B = 4
    y0 = np.random.default_rng(0).uniform(0.5, 1.5, (B, 2))
    kw = dict(ctl=vt.StepControl(rtol=1e-8), h0=1e-2, save_at=(0.35, 0.9))
    S = _side("torch")
    sol_b = vt.solve_ivp_dense(fb(S), 0.0, 1.5, torch.as_tensor(y0),
                               tableau=vt.DOPRI5, batch_shape=(B,),
                               error_norm=lc.norm_l2_batched, **kw)
    assert (sol_b.status == vt.DONE).all()
    for i in range(B):
        sol_i = vt.solve_ivp_dense(lambda t, y: fb(S)(t, y[None])[0], 0.0,
                                   1.5, torch.as_tensor(y0[i]),
                                   tableau=vt.DOPRI5, **kw)
        np.testing.assert_allclose(sol_b.ys[i].numpy(), sol_i.ys.numpy(),
                                   rtol=1e-12, atol=1e-14)
    J = _side("jax")
    want = jdense.solve_ivp_dense(
        fb(J), 0.0, 1.5, jnp.asarray(y0), tableau=vo.DOPRI5,
        batch_shape=(B,), error_norm=vo.lc.norm_l2_batched,
        ctl=vo.StepControl(rtol=1e-8), h0=1e-2, save_at=(0.35, 0.9))
    assert_same_solution(sol_b, want)


def _scan_grad_loss(side, k):
    S = _side(side)
    sol = S["dense"].solve_ivp_dense(
        lambda t, y: -k * y, 0.0, 1.0, S["arr"](1.0), tableau=S["vo"].DOPRI5,
        ctl=S["vo"].StepControl(rtol=1e-8, max_steps=64), h0=1e-2,
        save_at=(0.5,), method="scan", **S["kw"])
    return sol.ys[1]


def test_dense_scan_method_grad():
    """tests/test_dense.py:273: autograd through the dense scan driver,
    through the interpolated save."""
    k = torch.tensor(1.3, dtype=F64, requires_grad=True)
    (g,) = torch.autograd.grad(_scan_grad_loss("torch", k), k)
    jg = jax.grad(functools.partial(_scan_grad_loss, "jax"))(
        jnp.asarray(1.3, jnp.float64))
    np.testing.assert_allclose(g.item(), float(jg), rtol=1e-10)
    np.testing.assert_allclose(g.item(), -0.5 * np.exp(-1.3 / 2), rtol=1e-5)


# -- solve_linear_dense: the split, the split pair, the modulated stepper --

def _op_magnus(S):
    A0 = np.asarray([[0.0, 1.0], [-1.0, 0.0]]) * 0.8
    Bm = np.asarray([[0.3, 0.1], [0.1, -0.3]])
    return lambda t: S["arr"](A0) + S["sin"](t) * S["arr"](Bm)


LINEAR = {
    # tests/test_dense.py:93
    "magnus4": lambda S: ((_op_magnus(S), 0.0, 2.0, S["arr"]([1.0, 0.0])),
                          dict(stepper=S["exp"].Magnus4(S["exp"].DenseSplit()),
                               adaptive=True, h0=1e-2,
                               ctl=S["vo"].StepControl(rtol=1e-8, max_dt=0.2),
                               save_at=tuple(np.linspace(0.2, 1.8, 9)))),
    # tests/test_dense.py:127
    "split_pair": lambda S: (
        (lambda t: (S["arr"](A_ROT), S["arr"]([-0.2, -0.6])), 0.0, 1.0,
         S["arr"]([1.0, 0.5])),
        dict(stepper=S["exp"].SplitMidpoint(S["exp"].DenseSplit(),
                                            S["exp"].DiagonalSplit()),
             h0=0.02, save_at=(0.5,))),
    # tests/test_dense.py:163
    "antihermitian": lambda S: (
        (lambda t: S["arr"](-1j * np.asarray([[0.5, 0.2], [0.2, -0.5]])),
         0.0, 1.0, S["arr"](np.asarray([1.0, 0.0], np.complex128))),
        dict(stepper=S["exp"].ExpMidpoint(S["exp"].AntiHermitianSplit()),
             h0=0.05, save_at=(0.5,))),
}


def _linear(side, name):
    S = _side(side)
    args, kw = LINEAR[name](S)
    return S["dense"].solve_linear_dense(*args, **kw, **S["kw"])


@functools.cache
def _jax_linear(name):
    return _linear("jax", name)


@pytest.mark.parametrize("name", sorted(LINEAR))
def test_solve_linear_dense_matches_jax(name):
    sol = _linear("torch", name)
    assert int(sol.status) == vt.DONE
    # adaptive Magnus-4: h_final follows the last step, the sliver up to
    # tf, whose error estimate sits at the rounding floor (4.1e-7 here;
    # the grid-hitting solve's h_final agrees to 5.9e-10)
    assert_same_solution(sol, _jax_linear(name),
                         h_rtol=1e-6 if name == "magnus4" else 1e-9)
    if name == "split_pair":
        want = scipy.linalg.expm(0.5 * (A_ROT + np.diag([-0.2, -0.6])))
        np.testing.assert_allclose(sol.ys[1].numpy(), want @ [1.0, 0.5],
                                   atol=1e-4)
    if name == "antihermitian":
        np.testing.assert_allclose(np.linalg.norm(sol.ys[1].numpy()), 1.0,
                                   atol=1e-5)


def test_solve_linear_dense_without_error_estimate_raises():
    with pytest.raises(ValueError, match="error estimate"):
        vt.solve_linear_dense(lambda t: torch.as_tensor(A_ROT), 0.0, 1.0,
                              torch.tensor([1.0, 0.0], dtype=F64),
                              stepper=texp.ExpMidpoint(texp.DenseSplit()),
                              adaptive=True, h0=0.1)


def test_solve_linear_dense_modulated_stepper():
    """tests/test_dense.py:313: slopes from op.assemble; the saves agree
    with the grid-hitting solve, and with the JAX package's dense one."""
    d = 6
    rng = np.random.default_rng(3)
    z = rng.standard_normal(d) + 1j * rng.standard_normal(d)
    z /= np.linalg.norm(z)
    mod = DrivenDense.make(d=d, seed=2).modulated(F64, device="cpu")
    psi0 = tcp.from_complex(z, F64, device="cpu")
    kw = dict(stepper=texp.MagnusModulated4(mod), adaptive=True,
              ctl=vt.StepControl(rtol=1e-8, max_dt=0.2), save_at=(0.3, 0.8))
    sol = vt.solve_linear_dense(None, 0.0, 1.2, psi0, **kw)
    assert int(sol.status) == vt.DONE
    ref = vt.solve_linear(None, 0.0, 1.2, psi0, **kw)
    np.testing.assert_allclose(sol.ys.re.numpy(), ref.ys.re.numpy(),
                               rtol=1e-5, atol=1e-7)
    jmod = JDrivenDense.make(d=d, seed=2).modulated(jnp.float64)
    want = jdense.solve_linear_dense(
        None, 0.0, 1.2, jcp.from_complex(z, jnp.float64),
        stepper=vexp.MagnusModulated4(jmod, use_pallas=False), adaptive=True,
        ctl=vo.StepControl(rtol=1e-8, max_dt=0.2), save_at=(0.3, 0.8))
    for k in ("status", "n_accept", "n_reject"):
        assert int(getattr(sol, k)) == int(getattr(want, k)), k
    np.testing.assert_allclose(sol.ys.re.numpy(), np.asarray(want.ys.re),
                               rtol=1e-10, atol=1e-12)


# -- the overflowing first trial and the failed lane -------------------------

def test_dense_slot0_survives_first_step_overflow():
    y0 = torch.tensor([1.0, 2.0], dtype=F64)
    sol = vt.solve_ivp_dense(
        lambda t, y: -50.0 * y ** 3, 0.0, 1.0, y0, save_at=(0.5,), h0=1.0,
        ctl=vt.StepControl(rtol=1e-6, min_dt=1e-9, max_dt=1.0,
                           max_steps=10000))
    assert int(sol.status) == vt.DONE
    assert torch.equal(sol.ys[0], y0)
    assert torch.isfinite(sol.ys).all()


def test_dense_failed_lane_keeps_unreached_final_slot():
    def rhs(t, y):
        return y * y                   # blows up before tf for y0 = 3

    base = vt.RungeKutta().make_step_fn(rhs)

    def step_dense(t, x, dt):
        xn, err = base(t, x, dt)
        return xn, err, (rhs(t, x), rhs(t + dt, xn))

    sol = tdense.integrate_interp(
        torch.func.vmap(step_dense), torch.tensor([[0.1], [3.0]], dtype=F64),
        torch.tensor([0.0, 0.9], dtype=F64), 1e-3, adaptive=True,
        ctl=vt.StepControl(rtol=1e-6, min_dt=1e-6, max_dt=0.5,
                           max_steps=300),
        error_norm=torch.func.vmap(lc.norm_l2), batch_shape=(2,))
    assert int(sol.status[0]) == vt.DONE and int(sol.status[1]) != vt.DONE
    assert torch.equal(sol.ys[0, -1], sol.y_final[0])
    assert not torch.allclose(sol.ys[1, -1], sol.y_final[1])


# -- ensemble_solve(dense=True) on the vmapped tier --------------------------

B = 4
SAVE_E = (0.4, 0.9, 1.3)


def _ensemble(side, name, **extra):
    S = _side(side)
    rng = np.random.default_rng(7)
    if name == "magnus4":
        m = (JDrivenDense if side == "jax" else DrivenDense).make(d=3, seed=0)
        psi = rng.standard_normal((B, 3)) + 1j * rng.standard_normal((B, 3))
        psi /= np.linalg.norm(psi, axis=-1, keepdims=True)
        y0 = S["cp"].from_complex(psi, F64 if side == "torch" else
                                  jnp.float64, **S["kw"])
        dt_ = F64 if side == "torch" else jnp.float64
        op = ((lambda t: m.op_pair(t, dt_, device="cpu")) if side == "torch"
              else (lambda t: m.op_pair(t, dt_)))
        return S["ensemble"](op, y0, 0.0, 1.5, stepper=S["exp"].Magnus4(
            S["exp"].DenseCplxSplit(), batched=False), h0=1e-2,
            ctl=S["vo"].StepControl(rtol=1e-7, max_dt=0.25),
            save_at=SAVE_E, dense=True, **extra)
    y0 = S["arr"](rng.uniform(-2, 2, (B, 2)))
    mus = S["arr"](rng.uniform(0.5, 2.0, B))
    stepper = {"dopri5": S["vo"].RungeKutta(S["vo"].DOPRI5,
                                            advance_lower=False),
               "rkf45": None}[name]
    return S["ensemble"](
        lambda t, y, mu: S["np"].stack([y[1], mu * (1 - y[0] ** 2) * y[1]
                                        - y[0]]),
        y0, 0.0, 1.5, stepper=stepper, params=mus, h0=1e-2,
        ctl=S["vo"].StepControl(rtol=1e-7, max_steps=200), save_at=SAVE_E,
        dense=True, **extra)


@functools.cache
def _jax_ensemble(name):
    return _ensemble("jax", name)


@pytest.mark.parametrize("name", ["dopri5", "rkf45", "magnus4"])
def test_vmapped_tier_dense_matches_jax(name):
    sol = _ensemble("torch", name)
    assert sol.path == "torch-driver"
    assert (sol.status == vt.DONE).all()
    assert_same_solution(sol, _jax_ensemble(name), h_rtol=H_FINAL_PAIRS)
    if name == "dopri5":
        # the steps of a run with no saves, and the scan driver's result
        bare = ensemble_solve(
            lambda t, y, mu: torch.stack([y[1], mu * (1 - y[0] ** 2) * y[1]
                                          - y[0]]),
            _ensemble_y0(), 0.0, 1.5, params=_ensemble_mus(),
            stepper=vt.RungeKutta(vt.DOPRI5, advance_lower=False), h0=1e-2,
            ctl=vt.StepControl(rtol=1e-7, max_steps=200))
        assert torch.equal(sol.n_accept, bare.n_accept)
        scan = _ensemble("torch", name, method="scan")
        for k in ("n_accept", "n_reject", "ys", "y_final"):
            assert torch.equal(getattr(scan, k), getattr(sol, k)), k


def _ensemble_y0():
    return torch.as_tensor(np.random.default_rng(7).uniform(-2, 2, (B, 2)))


def _ensemble_mus():
    rng = np.random.default_rng(7)
    rng.uniform(-2, 2, (B, 2))
    return torch.as_tensor(rng.uniform(0.5, 2.0, B))

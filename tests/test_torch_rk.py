"""The port's generic Runge-Kutta stepper (``vec_ode_tpu_torch.rk``) and
its front door ``solve_ivp`` against the JAX package's, in f64 on the same
numpy inputs: ``rk_step`` / ``rk_step_stages`` for every tableau on a
tuple pytree and a complex state, and the cases of ``tests/test_rk.py``
through ``solve_ivp`` (the driver's scalar carry). The gate for a solve:
status, n_accept, n_reject, n_iters and n_rhs_evals equal, y_final and
ys within rtol 1e-12, h_final within rtol 1e-9, or ``H_FINAL_TIGHT`` /
``H_FINAL_PAIRS`` where the controller's rtol is 1e-8 or tighter
(ROADMAP queue 3's measured limits for the cancelling error sum)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vec_ode_tpu as vo
from vec_ode_tpu.rk import rk_step_stages as j_rk_step_stages
import vec_ode_tpu_torch as vt
from vec_ode_tpu_torch import rk as trk

torch.set_num_threads(1)

TABS = sorted(vo.TABLEAUS)

# h_final where the controller's rtol is 1e-8 or tighter: the embedded
# error is a cancelling sum whose last digits follow the summation order,
# so h_final parity goes as eps / rtol (ROADMAP queue 3, measured limits:
# <= 9.5e-9 for RK at rtol 1e-10 with events, <= 9.5e-8 for the Magnus-4
# and CFM-4 pairs at rtol 1e-9); counters and states keep their gates
H_FINAL_TIGHT = 3e-8
H_FINAL_PAIRS = 2e-7


def _np(tree):
    return [np.asarray(a) for a in jax.tree_util.tree_leaves(tree)]


def _tnp(tree):
    return [a.detach().cpu().numpy()
            for a in torch.utils._pytree.tree_leaves(tree)]


def assert_trees_close(got, want, rtol=1e-12, atol=1e-14):
    g, w = _tnp(got), _np(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.shape == b.shape and a.dtype == b.dtype, (a.dtype, b.dtype)
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


def assert_same_solution(got, want, *, events=False, h_rtol=1e-9):
    """Counters equal, states within rtol 1e-12, h_final within h_rtol."""
    for k in ("status", "n_accept", "n_reject", "n_iters", "n_rhs_evals"):
        w = getattr(want, k)
        g = getattr(got, k)
        if w is None:
            assert g is None, k
            continue
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=k)
    assert_trees_close(got.y_final, want.y_final)
    assert_trees_close(got.ys, want.ys)
    np.testing.assert_array_equal(got.ts.numpy(), np.asarray(want.ts))
    np.testing.assert_allclose(got.t_final.numpy(), np.asarray(want.t_final),
                               rtol=1e-14, atol=1e-14)
    np.testing.assert_allclose(got.h_final.numpy(), np.asarray(want.h_final),
                               rtol=h_rtol)
    assert got.path == "torch-driver"
    if events:
        for k in ("event_found", "event_count"):
            np.testing.assert_array_equal(getattr(got, k).numpy(),
                                          np.asarray(getattr(want, k)))
        for k in ("event_t", "event_t_k"):
            np.testing.assert_allclose(getattr(got, k).numpy(),
                                       np.asarray(getattr(want, k)),
                                       rtol=1e-12, atol=1e-14)
        assert_trees_close(got.event_y, want.event_y)


# -- the step, for every tableau ----------------------------------------------

def _tuple_rhs(lib):
    def f(t, y):
        a, b = y
        return (-a * b + lib.sin(t), 0.5 * a - 0.25 * b * b)
    return f


def _state(kind):
    rng = np.random.default_rng(3)
    if kind == "tuple":
        a, b = rng.standard_normal(3), rng.standard_normal(())
        return ((jnp.asarray(a), jnp.asarray(b)),
                (torch.as_tensor(a), torch.as_tensor(b)))
    z = rng.standard_normal(3) + 1j * rng.standard_normal(3)
    return jnp.asarray(z), torch.as_tensor(z)


@pytest.mark.parametrize("kind", ["tuple", "complex"])
@pytest.mark.parametrize("name", TABS)
def test_rk_step_stages_match_jax(name, kind):
    jy, ty = _state(kind)
    if kind == "tuple":
        jf, tf = _tuple_rhs(jnp), _tuple_rhs(torch)
    else:
        rates = [-1.0 + 0.5j, -2.0 - 1.0j, 0.3j]

        def jf(t, y):
            return y * jnp.asarray(rates) + 0.1j * jnp.cos(t) * y[::-1]

        def tf(t, y):
            r = torch.tensor(rates, dtype=torch.complex128)
            return y * r + 0.1j * torch.cos(t) * torch.flip(y, (0,))
    t0 = 0.3
    dt = 0.07
    for advance_lower in (True, False):
        want = j_rk_step_stages(jf, jnp.asarray(t0), jy, jnp.asarray(dt),
                                vo.TABLEAUS[name],
                                advance_lower=advance_lower)
        got = trk.rk_step_stages(tf, torch.tensor(t0, dtype=torch.float64),
                                 ty, torch.tensor(dt, dtype=torch.float64),
                                 vt.TABLEAUS[name],
                                 advance_lower=advance_lower)
        assert_trees_close(got[0], want[0])
        if want[1] is None:
            assert got[1] is None
        else:
            assert_trees_close(got[1], want[1])
        assert len(got[2]) == len(want[2])
        for gk, wk in zip(got[2], want[2]):
            assert_trees_close(gk, wk)
        assert_trees_close(got[3], want[3])
    x, err = trk.rk_step(tf, torch.tensor(t0, dtype=torch.float64), ty,
                         torch.tensor(dt, dtype=torch.float64),
                         vt.TABLEAUS[name], embedded=False)
    jx, jerr = vo.rk_step(jf, jnp.asarray(t0), jy, jnp.asarray(dt),
                          vo.TABLEAUS[name], embedded=False)
    assert err is None and jerr is None
    assert_trees_close(x, jx)


# -- the cases of tests/test_rk.py through solve_ivp ---------------------------

def _decay(lib):
    return lambda t, y: -y


def _two_rates(lib, dtype):
    def g(t, y):
        return y * lib.asarray([-1.0, -2.0], dtype=dtype)
    return g


CASES = {
    # the reference's fixed-step RK4 problem (h = 1e-3 over [0, 2])
    "fixed_rkf45": dict(y0=[1.0, 1.0], rhs="two_rates", t=(0.0, 2.0),
                        kw=dict(adaptive=False, h0=1e-3)),
    "adaptive_scalar": dict(y0=1.0, rhs="decay", t=(0.0, 2.0), kw=dict(
        ctl=dict(rtol=1e-10, atol=1e-10, min_dt=1e-10), h0=1e-4)),
    "complex": dict(y0=[1.0 + 0.0j, 1.0 + 0.0j], rhs="two_rates_c",
                    t=(0.0, 2.0), kw=dict(ctl=dict(rtol=1e-8))),
    "save_at": dict(y0=1.0, rhs="decay", t=(0.0, 2.0),
                    kw=dict(save_at=[0.5, 1.0, 1.5])),
    "rk4": dict(y0=1.0, rhs="decay", t=(0.0, 1.0), stepper=("rk4",),
                kw=dict(adaptive=False, h0=0.1)),
    "no_embedded": dict(y0=1.0, rhs="decay", t=(0.0, 1.0),
                        stepper=("rkf45", dict(embedded=False)),
                        kw=dict(adaptive=False, h0=0.05)),
    "max_steps": dict(y0=1.0, rhs="decay", t=(0.0, 1e6), kw=dict(
        adaptive=False, h0=1e-3, ctl=dict(max_steps=100))),
    "dopri5": dict(y0=1.0, rhs="decay", t=(0.0, 2.0), stepper=("dopri5",),
                   kw=dict(ctl=dict(rtol=1e-9, min_dt=1e-8), h0=1e-3)),
    "bosh32": dict(y0=1.0, rhs="decay", t=(0.0, 2.0), stepper=("bosh32",),
                   kw=dict(ctl=dict(rtol=1e-9, min_dt=1e-8), h0=1e-3)),
    "cash_karp": dict(y0=1.0, rhs="decay", t=(0.0, 2.0),
                      stepper=("cash_karp",),
                      kw=dict(ctl=dict(rtol=1e-9, min_dt=1e-8), h0=1e-3)),
    "advance_higher": dict(y0=1.0, rhs="decay", t=(0.0, 1.0),
                           stepper=("rkf45", dict(advance_lower=False)),
                           kw=dict(adaptive=False, h0=0.05)),
    # an FSAL tableau advancing b with every stage evaluated
    "dopri5_no_fsal": dict(y0=1.0, rhs="decay", t=(0.0, 2.0),
                           stepper=("dopri5", dict(advance_lower=False,
                                                   fsal=False)),
                           kw=dict(ctl=dict(rtol=1e-9, min_dt=1e-8),
                                   h0=1e-3)),
    "pi_scaled": dict(y0=[1.0, 1.0], rhs="two_rates", t=(0.0, 2.0), kw=dict(
        ctl=dict(rtol=1e-7, atol=1e-9, pi=True, scaled_error=True))),
    "stalled": dict(y0=1.0, rhs="decay", t=(0.0, 2.0), kw=dict(
        ctl=dict(rtol=1e-14, max_reject_streak=2), h0=0.5)),
}


def _rhs(name, lib):
    if name == "decay":
        return _decay(lib)
    if name == "two_rates":
        return _two_rates(lib, lib.float64)
    return _two_rates(lib, lib.complex128)


def _stepper(spec, lib):
    if spec is None:
        return None
    name, kw = (spec + ({},))[:2]
    return lib.RungeKutta(lib.TABLEAUS[name], **kw)


@functools.cache
def _jax_solution(name):
    c = CASES[name]
    kw = dict(c["kw"])
    if "ctl" in kw:
        kw["ctl"] = vo.StepControl(**kw["ctl"])
    y0 = jnp.asarray(np.asarray(c["y0"]))
    return vo.solve_ivp(_rhs(c["rhs"], jnp), *c["t"], y0,
                        stepper=_stepper(c.get("stepper"), vo), **kw)


@pytest.mark.parametrize("name", sorted(CASES))
def test_solve_ivp_matches_jax(name):
    c = CASES[name]
    kw = dict(c["kw"])
    if "ctl" in kw:
        kw["ctl"] = vt.StepControl(**kw["ctl"])
    got = vt.solve_ivp(_rhs(c["rhs"], torch), *c["t"],
                       torch.as_tensor(np.asarray(c["y0"])),
                       stepper=_stepper(c.get("stepper"), vt), **kw)
    assert_same_solution(got, _jax_solution(name))


def test_pytree_state_matches_jax():
    y0 = {"p": np.array([1.0, 2.0]), "q": np.array(3.0)}

    def g(lib):
        return lambda t, y: {"p": -y["p"], "q": -2.0 * y["q"]}

    want = vo.solve_ivp(g(jnp), 0.0, 1.0,
                        {k: jnp.asarray(v) for k, v in y0.items()},
                        ctl=vo.StepControl(rtol=1e-8), save_at=[0.5])
    got = vt.solve_ivp(g(torch), 0.0, 1.0,
                       {k: torch.as_tensor(v) for k, v in y0.items()},
                       ctl=vt.StepControl(rtol=1e-8), save_at=[0.5])
    assert_same_solution(got, want)
    np.testing.assert_allclose(got.y_final["q"].item(), 3 * np.exp(-2.0),
                               rtol=1e-6)


# -- refusals -----------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(compensated=True),
    # FSAL runs through the driver's carry (tests/test_torch_fsal.py); the
    # compensated state carry is refused with it too
    dict(tableau=vt.DOPRI5, advance_lower=False, compensated=True),
    dict(tableau=vt.BOSH32, advance_lower=False, fsal=True,
         compensated=True),
])
def test_stepper_carry_refusals_name_item_25(kw):
    """Item 25's compensated carry is ported: the stepper takes it (the
    residual word alone, or (k0, lo) with FSAL; tests/
    test_torch_compensated.py holds the solves against the JAX package)."""
    st = vt.RungeKutta(**kw)
    assert st.has_carry and st.compensated
    x = torch.tensor([1.0, 2.0], dtype=torch.float64)
    carry = st.make_init_carry(lambda t, y: -y)(torch.tensor(0.0), x)
    lo = carry[1] if st.use_fsal else carry
    assert torch.equal(lo, torch.zeros_like(x))


def test_fsal_needs_an_fsal_tableau():
    with pytest.raises(ValueError, match="FSAL"):
        vt.RungeKutta(vt.RKF45, advance_lower=False, fsal=True)


@pytest.mark.parametrize("kw", [dict(method="scan"), dict(grad_safe=True),
                                dict(remat_levels=2, method="scan")])
def test_gradient_options_name_item_22(kw):
    """The options of item 22 (gradients through the driver) run: the
    same solve as the plain while loop (tests/test_torch_scan.py holds
    them against the JAX package)."""
    y0 = torch.tensor(1.0, dtype=torch.float64)
    ctl = vt.StepControl(rtol=1e-8, max_steps=64)
    want = vt.solve_ivp(lambda t, y: -y, 0.0, 1.0, y0, ctl=ctl)
    got = vt.solve_ivp(lambda t, y: -y, 0.0, 1.0, y0, ctl=ctl, **kw)
    for k in ("status", "n_accept", "n_reject"):
        assert torch.equal(getattr(got, k), getattr(want, k)), k
    assert torch.equal(got.y_final, want.y_final)


def test_adaptive_needs_an_error_estimate():
    with pytest.raises(ValueError, match="error estimate"):
        vt.solve_ivp(lambda t, y: -y, 0.0, 1.0,
                     torch.tensor(1.0, dtype=torch.float64),
                     stepper=vt.RungeKutta(vt.RK4))

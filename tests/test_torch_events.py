"""Events in the port's host driver on the CPU (``events.py`` and the
event branch of ``driver.step_once``), against the JAX package in f64 on
the same numpy inputs: ``event_step`` itself, and ``ensemble_solve(...,
events=...)`` on the per-step paths of the RK stepper (K1's twin), of
Magnus-4 on an operator without a declared form (K4's twin) and of the
generic Magnus-4 over a dense leaf (K9's twin), against the JAX
package's XLA driver. The gate: status, n_accept, n_reject, n_iters,
event_found and event_count equal per trajectory; event_t and event_t_k
(the same finite mask) and event_y within 1e-10; y_final within 1e-12.
The loop kernel's events: tests/test_torch_loop_events.py."""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vec_ode_tpu as vo
from vec_ode_tpu import events as jev
from vec_ode_tpu import exp as vexp
from vec_ode_tpu.models import DrivenDense as JDrivenDense
from vec_ode_tpu.ops import cplx as jcp
from vec_ode_tpu.ops.pallas_rk import FusedModulatedLinearRK as JStepper
from vec_ode_tpu.parallel import ensemble_solve as jensemble_solve
import vec_ode_tpu_torch as vt
from vec_ode_tpu_torch import convert
from vec_ode_tpu_torch import events as tev
from vec_ode_tpu_torch import exp as texp
from vec_ode_tpu_torch.models import DrivenDense
from vec_ode_tpu_torch.ops import cplx as tcp
from vec_ode_tpu_torch.parallel import ensemble_solve

torch.set_num_threads(1)

D, B, TF = 4, 8, 3.0
RK_CTL = dict(rtol=1e-8, min_dt=1e-6, max_dt=0.25, max_steps=3000)
EXP_CTL = dict(rtol=1e-6, min_dt=1e-6, max_dt=0.25, max_steps=3000)
E3 = tuple(np.eye(2 * D)[3])          # g = Re z_3 over [re | im]
P0 = tuple(np.eye(D)[0])              # g = |z_0|^2


def _opaque(t, x):
    """An event no kernel can lay out: a callable of time and state."""
    return x.re[1] * x.im[2] - 0.05 * t


# name -> a function of the events module that makes the EventConfig,
# the same on both sides (the observables and Event types are the
# package's own). An
# explicit t_tol keeps the search above the rounding floor of g: at
# 1e-9 a quadratic event's search took one iteration more on 2 of 8 rows
# in one package than in the other (the g sums differ by rounding, and
# theta near the root carries it); at 1e-7 the counts agree.
EVENTS = {
    "lin_multi": lambda m: m.EventConfig(events=(
        m.Event(m.LinearObservable(w=E3)),
        m.Event(m.QuadraticObservable(q=P0, c=0.2), terminal=True)),
        max_crossings=3, t_tol=1e-7),
    "directions": lambda m: m.EventConfig(events=(
        m.Event(m.LinearObservable(w=E3), direction=1),
        m.Event(m.LinearObservable(w=E3), direction=-1),
        m.Event(m.LinearObservable(w=E3, c=0.05), direction=0)),
        max_crossings=2, t_tol=1e-9),
    "terminal_n": lambda m: m.EventConfig(events=(
        m.Event(m.LinearObservable(w=E3), terminal=2),), max_crossings=2,
        t_tol=1e-8),
    "record_y_off": lambda m: m.EventConfig(events=(
        m.Event(m.QuadraticObservable(q=P0, c=0.2), terminal=True),),
        record_y=False, t_tol=1e-7),
    "opaque": lambda m: m.EventConfig(events=(
        m.Event(_opaque), m.Event(m.LinearObservable(w=E3))),
        max_crossings=2, t_tol=1e-7),
    # Re z_0 = 0 at t0 on every row: a zero at t0 is not a crossing
    "zero_at_t0": lambda m: m.EventConfig(events=(
        m.Event(m.LinearObservable(w=tuple(np.eye(2 * D)[0]))),),
        max_crossings=3, t_tol=1e-9),
    # the default t_tol, 64 eps max(1, |t|): the search runs down to the
    # rounding floor, where theta is noise (see test_default_t_tol)
    "default_t_tol": lambda m: m.EventConfig(events=(
        m.Event(m.QuadraticObservable(q=P0, c=0.2), terminal=True),)),
}


@functools.cache
def _psi(zero_re0=False):
    rng = np.random.default_rng(42)
    psi = rng.standard_normal((B, D)) + 1j * rng.standard_normal((B, D))
    if zero_re0:
        psi[:, 0] = 1j * psi[:, 0].imag
    return psi / np.linalg.norm(psi, axis=-1, keepdims=True)


@functools.cache
def _model():
    return JDrivenDense.make(d=D, seed=0)


@functools.cache
def _rk_mats():
    jst = JStepper.from_driven_dense(_model(), jnp.float64)
    return np.asarray(jst.M0), np.asarray(jst.M1)


def _jmod():
    return _model().modulated(jnp.float64)


def _tmod():
    jmod = _jmod()
    ext = np.asarray(vexp.MagnusModulated4(jmod, use_pallas=False)
                     ._ext_basis_w)
    return convert.modulated_from_numpy(
        np.asarray(jmod.basis.re), np.asarray(jmod.basis.im),
        DrivenDense.make(d=D, seed=0).modulated(torch.float64,
                                                device="cpu").form,
        dtype=torch.float64, device="cpu", ext_basis_w=ext)


# stepper name -> (JAX (rhs_or_op, stepper), port (rhs_or_op, stepper),
# ctl, h0, the port's path)
def _steppers(name):
    m = _model()
    if name == "rk":
        M0, M1 = _rk_mats()
        w = float(m.w)
        return ((None, JStepper(M0=M0, M1=M1,
                                u_fn=lambda t: jnp.cos(w * t),
                                use_pallas=False)),
                (None, convert.stepper_from_numpy(M0, M1, w, device="cpu")),
                RK_CTL, 1e-3, "torch-driver")
    if name == "magnus4":
        return ((None, vexp.MagnusModulated4(_jmod(), use_pallas=False)),
                (None, texp.MagnusModulated4(
                    dataclasses.replace(_tmod(), form=None))),
                EXP_CTL, 1e-3, "torch-driver")
    return ((lambda t: m.op_pair(t, jnp.float64),
             vexp.Magnus4(vexp.DenseCplxSplit())),
            (convert.driven_op_from_numpy(m.H0, m.V, m.w, device="cpu"),
             texp.Magnus4(texp.DenseCplxSplit())),
            EXP_CTL, 2e-2, "torch-driver")


CASES = ([("rk", e) for e in EVENTS if e != "default_t_tol"]
         + [(s, e) for s in ("magnus4", "generic")
            for e in ("lin_multi", "opaque")])


@functools.cache
def _jax(stepper, events, save_at=None):
    (jop, jst), _, ctl, h0, _ = _steppers(stepper)
    sol = jensemble_solve(
        jop, jcp.from_complex(_psi(events == "zero_at_t0"), jnp.float64),
        0.0, TF, stepper=jst, ctl=vo.StepControl(**ctl), h0=h0,
        time_dtype=jnp.float64, events=EVENTS[events](jev), save_at=save_at)
    keys = ("status", "n_accept", "n_reject", "n_iters", "event_found",
            "event_count", "event_t", "event_t_k")
    out = {k: np.asarray(getattr(sol, k)) for k in keys}
    out["y_final"] = np.asarray(sol.y_final.re), np.asarray(sol.y_final.im)
    out["ys"] = np.asarray(sol.ys.re), np.asarray(sol.ys.im)
    out["event_y"] = (None if sol.event_y is None else
                      (np.asarray(sol.event_y.re),
                       np.asarray(sol.event_y.im)))
    return out


def _port(stepper, events, save_at=None):
    _, (top, tst), ctl, h0, path = _steppers(stepper)
    sol = ensemble_solve(
        top, tcp.from_complex(_psi(events == "zero_at_t0"), torch.float64,
                              device="cpu"),
        0.0, TF, stepper=tst, ctl=vt.StepControl(**ctl), h0=h0,
        time_dtype=torch.float64, events=EVENTS[events](tev),
        save_at=save_at)
    assert sol.path == path
    return sol


def gate(sol, want, y_tol=1e-12, flips=0):
    """The parity gate of this file, shared with the loop tests.

    ``flips``: rows whose n_accept and n_iters may differ by up to 2.
    Regula falsi on a nearly linear g puts a search trial's end on the
    root to rounding, so whether that trial crosses (and is vetoed) or
    stops short (and is accepted as an approach step) follows the last
    bits of the state; where the two packages' steps differ by rounding
    (Magnus-6: a Taylor chain here, a Pade / Paterson-Stockmeyer expm
    there) a row can take one approach step more. Such a row still
    locates the same crossings at the same times."""
    g = convert.solution_to_numpy(sol)
    for k in ("status", "n_reject", "event_found", "event_count"):
        np.testing.assert_array_equal(g[k], want[k], err_msg=k)
    flipped = np.zeros(len(want["status"]), bool)
    for k in ("n_accept", "n_iters"):
        d = np.abs(g[k].astype(np.int64) - want[k])
        flipped |= d != 0
        assert d.max() <= 2, (k, g[k], want[k])
    assert flipped.sum() <= flips, (g["n_iters"], want["n_iters"])
    # a flipped row's later steps differ: its states agree to the
    # integration tolerance only
    y_tol = np.where(flipped, 1e-6, y_tol)
    for k in ("event_t", "event_t_k"):
        fin = np.isfinite(want[k])
        np.testing.assert_array_equal(np.isfinite(g[k]), fin, err_msg=k)
        np.testing.assert_allclose(g[k][fin], want[k][fin], rtol=0,
                                   atol=1e-10, err_msg=k)
    def close(got, ref, tol):
        err = np.abs(got - ref).reshape(len(tol), -1).max(1)
        assert (err <= tol).all(), (err, tol)

    if want["event_y"] is None:
        assert sol.event_y is None
    else:
        for got, ref in zip(g["event_y"], want["event_y"]):
            close(got, ref, np.maximum(y_tol, 1e-10))
    for key in ("y_final", "ys"):
        for got, ref in zip(g[key], want[key]):
            close(got, ref, y_tol + np.zeros(len(flipped)))


@pytest.mark.parametrize("stepper,events", CASES)
def test_driver_events_match_jax(stepper, events):
    sol = _port(stepper, events)
    want = _jax(stepper, events)
    gate(sol, want)
    if events in ("lin_multi", "terminal_n"):
        assert (want["status"] == vo.DONE_EVENT).any()
    if events == "terminal_n":
        # the second crossing stops some rows; the others reach tf
        assert (want["status"] == vo.DONE).any()
        assert (want["event_count"][want["status"] == vo.DONE_EVENT]
                == 2).all()
    if events == "zero_at_t0":
        # no crossing at t0; the later crossings are located
        assert (want["event_t_k"] > 0.0).all()
        assert want["event_found"].any()


def test_default_t_tol():
    """With the default t_tol (64 eps max(1, |t|)) the bracket search ends
    at the rounding floor of g, where regula falsi's theta is noise: the
    two packages, whose states and g sums differ by rounding, take
    different numbers of search and approach steps (up to 41 iterations
    apart on these rows), but locate the same crossings at the same
    times, to rounding."""
    sol = _port("rk", "default_t_tol")
    want = _jax("rk", "default_t_tol")
    g = convert.solution_to_numpy(sol)
    for k in ("status", "event_found", "event_count"):
        np.testing.assert_array_equal(g[k], want[k], err_msg=k)
    assert (want["status"] == vo.DONE_EVENT).all()
    np.testing.assert_allclose(g["event_t"], want["event_t"], rtol=0,
                               atol=1e-13)
    np.testing.assert_allclose(g["t_final"], want["event_t"][:, 0], rtol=0,
                               atol=1e-13)


def test_terminal_event_leaves_later_saves_zero():
    """A row stopped by a terminal event never reaches the later save
    times: their slots stay zero, as in the JAX driver."""
    save_at = (0.6, 1.5, 2.4)
    sol = _port("rk", "lin_multi", save_at=save_at)
    want = _jax("rk", "lin_multi", save_at=save_at)
    gate(sol, want)
    stopped = sol.status == vt.DONE_EVENT
    assert stopped.any()
    t_stop = sol.t_final[stopped]
    later = torch.tensor((0.0,) + save_at + (TF,)) > t_stop[:, None]
    assert (sol.ys.re[stopped][later] == 0).all()


def test_fixed_steps_search_is_not_a_reject():
    """Fixed steps have no numerical rejections: the search's vetoes show
    in n_iters, not in n_reject, and the located time is within t_tol."""
    M0, M1 = _rk_mats()
    st = convert.stepper_from_numpy(M0, M1, float(_model().w), device="cpu")
    cfg = tev.EventConfig(events=(tev.Event(tev.LinearObservable(w=E3)),),
                          max_crossings=2, t_tol=1e-9)
    sol = ensemble_solve(None, tcp.from_complex(_psi(), torch.float64,
                                                device="cpu"),
                         0.0, TF, stepper=st, adaptive=False, h0=0.01,
                         time_dtype=torch.float64, events=cfg)
    assert (sol.status == vt.DONE).all()
    assert (sol.n_reject == 0).all()
    assert sol.event_found.any()
    assert (sol.n_iters[sol.event_found[:, 0]]
            > sol.n_accept[sol.event_found[:, 0]] + 1).all()


def test_event_step_matches_jax():
    """One ``event_step`` on random brackets: every output field equal to
    the JAX package's (the g values, theta and the slot select)."""
    rng = np.random.default_rng(3)
    n, E, K = 16, 3, 3
    psi0, psi1 = (rng.standard_normal((2, n, D))
                  + 1j * rng.standard_normal((2, n, D)))
    t = rng.uniform(0, 1, n)
    dt = np.where(rng.uniform(size=n) < 0.5, 1e-9, 0.05)
    count = rng.integers(0, K + 1, (n, E)).astype(np.int32)
    stepping = rng.uniform(size=n) < 0.9
    accept = rng.uniform(size=n) < 0.8
    searching = rng.uniform(size=n) < 0.3
    h_entry = rng.uniform(size=n)

    def cfg(m):
        return m.EventConfig(events=(
            m.Event(m.LinearObservable(w=E3), direction=1),
            m.Event(m.QuadraticObservable(q=P0, c=0.3), terminal=2),
            m.Event(m.LinearObservable(w=tuple(np.eye(2 * D)[5]), c=0.1))),
            max_crossings=K, t_tol=1e-6)

    outs = []
    for m, arr, cp, bool_of in (
            (jev, jnp.asarray, jcp.from_complex,
             lambda a: jnp.asarray(a)),
            (tev, torch.as_tensor,
             lambda z, dt_: tcp.from_complex(z, dt_, device="cpu"),
             lambda a: torch.as_tensor(a))):
        c = cfg(m)
        fdt = jnp.float64 if m is jev else torch.float64
        x0, x1 = cp(psi0, fdt), cp(psi1, fdt)
        ev = m.init_event_state(c, arr(t), x0, batch_shape=(n,))
        ev = ev._replace(count=arr(count), searching=bool_of(searching),
                         h_entry=arr(h_entry))
        outs.append(m.event_step(c, ev, arr(t), arr(dt), x0, x1,
                                 bool_of(stepping), bool_of(accept)))
    jo, to = outs
    for f in ("accept", "search", "h_override", "restore_h", "h_entry",
              "terminal_hit"):
        np.testing.assert_allclose(getattr(to, f).numpy(),
                                   np.asarray(getattr(jo, f)), rtol=0,
                                   atol=1e-15, err_msg=f)
    for f in ("g_prev", "t_ev", "found", "searching", "count"):
        np.testing.assert_allclose(getattr(to.ev_next, f).numpy(),
                                   np.asarray(getattr(jo.ev_next, f)),
                                   rtol=0, atol=1e-15, err_msg=f)
    for p in ("re", "im"):
        np.testing.assert_allclose(
            getattr(to.ev_next.y_ev, p).numpy(),
            np.asarray(getattr(jo.ev_next.y_ev, p)), rtol=0, atol=1e-15)
    assert to.search.any() and to.terminal_hit.any()


def test_observables_match_jax():
    """The declared observables are the same callables on both sides, on
    Cplx pairs and on real states, with their kernel rows."""
    rng = np.random.default_rng(5)
    z = rng.standard_normal((3, D)) + 1j * rng.standard_normal((3, D))
    r = rng.standard_normal((3, 2 * D))
    w = rng.standard_normal(2 * D)
    q = rng.standard_normal(D)
    for jo, to in ((jev.LinearObservable(w=w, c=0.3),
                    tev.LinearObservable(w=w, c=0.3)),
                   (jev.QuadraticObservable(q=q, c=-0.2),
                    tev.QuadraticObservable(q=q, c=-0.2))):
        got = to(0.0, tcp.from_complex(z, torch.float64, device="cpu"))
        want = jo(0.0, jcp.from_complex(z, jnp.float64))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-14)
        for part, n_parts in ((D, 2), (2 * D, 1)):
            a, b = jo.kernel_row(part, n_parts), to.kernel_row(part, n_parts)
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a, b)
    lin = tev.LinearObservable(w=w)
    np.testing.assert_allclose(
        lin(0.0, torch.as_tensor(r)).numpy(),
        np.asarray(jev.LinearObservable(w=w)(0.0, jnp.asarray(r))),
        rtol=1e-14)
    with pytest.raises(ValueError, match="2\\*"):
        tev.LinearObservable(w=w[:D])(0.0, tcp.from_complex(
            z, torch.float64, device="cpu"))


@pytest.mark.parametrize("kw,err", [
    (dict(events=()), ValueError),
    (dict(events=("not an event",)), TypeError),
    (dict(events=(tev.Event(_opaque),), max_crossings=0), ValueError),
    (dict(events=(tev.Event(_opaque),), max_crossings=65), ValueError),
    (dict(events=(tev.Event(_opaque, terminal=3),), max_crossings=2),
     ValueError),
])
def test_config_validation(kw, err):
    with pytest.raises(err):
        tev.EventConfig(**kw)


def test_event_validation_and_normalisation():
    with pytest.raises(ValueError):
        tev.Event(_opaque, direction=2)
    with pytest.raises(ValueError):
        tev.Event(_opaque, terminal=0)
    with pytest.raises(TypeError):
        tev.Event(_opaque, terminal=1.5)
    assert tev.Event(_opaque, terminal=True).terminal_count == 1
    assert tev.as_event_config(None) is None
    one = tev.as_event_config(_opaque)
    assert one.n == 1 and one.events[0].direction == 0
    two = tev.as_event_config([_opaque, tev.Event(_opaque, direction=-1)])
    assert [e.direction for e in two.events] == [0, -1]
    cfg = EVENTS["opaque"](tev)
    assert tev.as_event_config(cfg) is cfg
    # an opaque callable has no kernel layout; the declared ones do
    assert cfg.kernel_spec(D, 2) is None
    spec = EVENTS["lin_multi"](tev).kernel_spec(D, 2)
    assert spec.kinds == ("lin", "quad") and spec.terminal == (0, 1)
    assert spec.rows.shape == (2, 2 * D) and spec.k == 3

"""The port's bounded-scan driver (``driver.integrate(method="scan")``,
``remat_levels``, ``batched=``) against its while loop and the JAX
package in f64 on the same inputs: scan and while give equal counters and
states (bitwise within the port), the JAX package's scan the same
counters and states within 1e-12 (``test_torch_rk.assert_same_solution``),
with saves, events (``tests/test_events.py:137``,
``tests/test_multicrossing_events.py:142``) and natively batched carries;
the nested level lengths equal the JAX package's rule, recorded from its
own trace; ``remat_levels`` 0 / 1 / 2 give bitwise equal gradients;
the 65536-iteration guard; ``batched=`` checked against the carry; the
post-DONE gradient of ``tests/test_driver.py:167`` and the event-time
gradient of ``tests/test_events.py:272`` against ``jax.grad``."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vec_ode_tpu as vo
from vec_ode_tpu import diff as jdiff
from vec_ode_tpu.events import Event as JEvent
from vec_ode_tpu.events import EventConfig as JEventConfig
from vec_ode_tpu.parallel import ensemble_solve as jensemble_solve
from vec_ode_tpu.rk import rk_step as j_rk_step
import vec_ode_tpu_torch as vt
from vec_ode_tpu_torch import diff as tdiff
from vec_ode_tpu_torch import driver
from vec_ode_tpu_torch.events import Event, EventConfig
from vec_ode_tpu_torch.parallel import ensemble_solve
from vec_ode_tpu_torch.rk import rk_step

from test_torch_rk import H_FINAL_TIGHT, assert_same_solution

torch.set_num_threads(1)

F64 = torch.float64


def _lib(side):
    if side == "jax":
        return dict(np=jnp, arr=lambda a: jnp.asarray(np.asarray(a)),
                    Event=JEvent, EventConfig=JEventConfig, vo=vo,
                    stack=jnp.stack, sin=jnp.sin, ensemble=jensemble_solve)
    return dict(np=torch, arr=lambda a: torch.as_tensor(np.asarray(a)),
                Event=Event, EventConfig=EventConfig, vo=vt,
                stack=torch.stack, sin=torch.sin, ensemble=ensemble_solve)


def _vdp(L, mu=3.0):
    return lambda t, y: L["stack"]([y[1], mu * (1 - y[0] ** 2) * y[1] - y[0]])


def _osc(L):
    return lambda t, y: L["stack"]([y[1], -y[0]])


# name -> (solve kwargs builder); every case runs on the scalar carry
SCALAR = {
    # rejects and accepts, the default [t0, tf] grid (ys elided)
    "vdp_adaptive": lambda L: dict(
        f=_vdp(L), t=(0.0, 6.0), y0=[2.0, 0.0], h0=0.5,
        ctl=dict(rtol=1e-6, min_dt=1e-9, max_dt=2.0, max_steps=140)),
    # save-grid hits recorded in the loop
    "saves": lambda L: dict(
        f=lambda t, y: -y, t=(0.0, 2.0), y0=1.0, h0=1e-2,
        save_at=[0.5, 1.0, 1.5], ctl=dict(rtol=1e-8, max_steps=60)),
    # fixed steps, iterations past DONE
    "fixed": lambda L: dict(
        f=_osc(L), t=(0.0, 1.0), y0=[1.0, 0.0], h0=0.05, adaptive=False,
        ctl=dict(max_steps=40)),
    # too few iterations: ERR_MAX_STEPS (fixed steps: the adaptive step
    # sizes agree only to eps / rtol, ROADMAP queue 3, and the state of a
    # lane stopped mid-way follows them)
    "max_steps": lambda L: dict(
        f=lambda t, y: -y, t=(0.0, 5.0), y0=1.0, h0=1e-2, adaptive=False,
        ctl=dict(max_steps=12)),
    # tests/test_events.py:137, a terminal event
    "terminal_event": lambda L: dict(
        f=lambda t, y: -y, t=(0.0, 5.0), y0=1.0,
        ctl=dict(rtol=1e-10, max_steps=120),
        events=L["Event"](lambda t, y: y - 0.5, terminal=True)),
    # tests/test_multicrossing_events.py:142, three crossings (a tight
    # bracket keeps the searches off the rounding floor, ROADMAP queue 3)
    "multicrossing": lambda L: dict(
        f=_osc(L), t=(0.0, 10.0), y0=[1.0, 0.0],
        ctl=dict(rtol=1e-8, atol=1e-10, max_steps=260),
        events=L["EventConfig"](events=(L["Event"](lambda t, x: x[0]),),
                                max_crossings=3, t_tol=1e-9)),
    # the FSAL carry through the scan
    "fsal": lambda L: dict(
        f=_vdp(L, 1.0), t=(0.0, 2.0), y0=[1.0, 0.0], h0=1e-2,
        stepper=L["vo"].RungeKutta(L["vo"].DOPRI5, advance_lower=False),
        ctl=dict(rtol=1e-7, max_steps=80, time_compensated=False)),
}


def _scalar_solve(side, name, method):
    L = _lib(side)
    c = SCALAR[name](L)
    y0 = L["arr"](np.asarray(c["y0"], np.float64))
    kw = {k: c[k] for k in ("h0", "save_at", "adaptive", "events", "stepper")
          if k in c}
    return L["vo"].solve_ivp(c["f"], *c["t"], y0,
                             ctl=L["vo"].StepControl(**c["ctl"]),
                             method=method, **kw)


@functools.cache
def _jax_scalar(name):
    return _scalar_solve("jax", name, "scan")


@pytest.mark.parametrize("name", sorted(SCALAR))
def test_scan_matches_while_and_jax(name):
    events = "event" in name or name == "multicrossing"
    scan = _scalar_solve("torch", name, "scan")
    loop = _scalar_solve("torch", name, "while")
    for k in ("status", "n_accept", "n_reject", "n_iters", "h_final",
              "t_final", "y_final", "ys"):
        assert torch.equal(getattr(scan, k), getattr(loop, k)), k
    assert_same_solution(scan, _jax_scalar(name), events=events,
                         h_rtol=H_FINAL_TIGHT)


def test_scan_terminal_event_where_the_closed_form_says():
    sol = _scalar_solve("torch", "terminal_event", "scan")
    assert int(sol.status) == vt.DONE_EVENT
    np.testing.assert_allclose(sol.event_t[0].item(), np.log(2.0), atol=1e-9)
    mc = _scalar_solve("torch", "multicrossing", "scan")
    np.testing.assert_allclose(mc.event_t_k[0].numpy(),
                               np.pi / 2 + np.arange(3) * np.pi, atol=1e-6)
    assert int(mc.event_count[0]) == 3


B = 5


def _batched_solve(side, method):
    """The vmapped tier, per-trajectory h0 and saves, and VdP lanes that
    finish at different iterations."""
    L = _lib(side)
    rng = np.random.default_rng(4)
    y0 = L["arr"](rng.uniform(-2, 2, (B, 2)))
    h0 = L["arr"](rng.uniform(0.01, 0.1, B))
    return L["ensemble"](_vdp(L, 1.5), y0, 0.0, 3.0, h0=h0,
                         save_at=[0.7, 2.1], method=method,
                         ctl=L["vo"].StepControl(rtol=1e-7, max_steps=150))


@functools.cache
def _jax_batched():
    return _batched_solve("jax", "scan")


def test_vmapped_tier_scan_matches_while_and_jax():
    scan = _batched_solve("torch", "scan")
    loop = _batched_solve("torch", "while")
    for k in ("status", "n_accept", "n_reject", "n_iters", "y_final", "ys"):
        assert torch.equal(getattr(scan, k), getattr(loop, k)), k
    assert_same_solution(scan, _jax_batched())


def test_natively_batched_scan_runs_the_host_driver():
    """A natively batched stepper under scan runs the per-step host
    driver (on the CPU its plain twin) for exactly max_steps iterations,
    with the while loop's counters and states."""
    from vec_ode_tpu_torch import convert
    from vec_ode_tpu_torch.models import DrivenDense

    m = DrivenDense.make(d=3, seed=0)
    st = vt.ops.FusedModulatedLinearRK.from_driven_dense(m, F64,
                                                         device="cpu")
    rng = np.random.default_rng(1)
    psi = rng.standard_normal((4, 3)) + 1j * rng.standard_normal((4, 3))
    y0 = convert.state_from_numpy(psi.real, psi.imag, device="cpu")
    ctl = vt.StepControl(rtol=1e-8, max_dt=0.25, max_steps=50)
    kw = dict(stepper=st, ctl=ctl, h0=1e-3, time_dtype=F64)
    scan = ensemble_solve(None, y0, 0.0, 1.0, method="scan", **kw)
    loop = ensemble_solve(None, y0, 0.0, 1.0, **kw)
    assert scan.path == loop.path == "torch-driver"
    assert (scan.status == vt.DONE).all()
    for k in ("n_accept", "n_reject", "n_iters"):
        assert torch.equal(getattr(scan, k), getattr(loop, k)), k
    assert torch.equal(scan.y_final.re, loop.y_final.re)


# -- the nested level lengths: the JAX package's rule, read off its trace ----

def _jax_lengths(max_steps, levels):
    """The lengths of the nested lax.scans the JAX driver builds, in
    trace order (outermost first), from an abstract trace."""
    seen = []
    real_scan = jax.lax.scan

    def spy(f, init, xs=None, length=None, **kw):
        seen.append(length)
        return real_scan(f, init, xs, length=length, **kw)

    step = vo.RungeKutta().make_step_fn(lambda t, y: -y)
    grid = vo.make_grid(0.0, 1.0, dtype=jnp.float64)
    jax.lax.scan = spy
    try:
        jax.eval_shape(lambda y: vo.integrate(
            step, y, grid, 1e-3, adaptive=False,
            ctl=vo.StepControl(max_steps=max_steps), method="scan",
            remat_levels=levels).y_final, jnp.asarray(1.0))
    finally:
        jax.lax.scan = real_scan
    return seen


@pytest.mark.parametrize("levels", [1, 2, 3])
@pytest.mark.parametrize("max_steps", [7, 100, 4096, 100_000])
def test_level_lengths_are_the_jax_rule(max_steps, levels):
    got = driver.scan_lengths(max_steps, levels)
    assert got == _jax_lengths(max_steps, levels)
    assert len(got) == levels + 1 and np.prod(got) >= max_steps
    assert driver.scan_lengths(max_steps, 0) == [max_steps]


def test_scan_guard_and_remat_lift_it():
    class Started(Exception):
        pass

    def step(t, x, dt):
        raise Started

    grid = vt.make_grid(0.0, 1.0, dtype=F64, device="cpu")
    y0 = torch.ones(1, dtype=F64)
    ctl = vt.StepControl(max_steps=100_050, max_dt=1.0)
    with pytest.raises(ValueError, match="remat_levels"):
        vt.integrate(step, y0, grid, 1e-5, adaptive=False, ctl=ctl,
                     method="scan")
    # with remat the guard is lifted: the loop starts
    with pytest.raises(Started):
        vt.integrate(step, y0, grid, 1e-5, adaptive=False, ctl=ctl,
                     method="scan", remat_levels=2)
    with pytest.raises(ValueError, match="method='scan'"):
        vt.integrate(step, y0, grid, 1e-5, ctl=vt.StepControl(),
                     remat_levels=1)
    with pytest.raises(ValueError, match="unknown integrate method"):
        vt.integrate(step, y0, grid, 1e-5, method="fori")


def test_batched_argument_is_checked_against_the_carry():
    step = vt.RungeKutta().make_step_fn(lambda t, y: -y)
    grid = vt.make_grid(0.0, 1.0, dtype=F64, device="cpu")
    ctl = vt.StepControl(rtol=1e-8)
    scalar = vt.init_state(torch.tensor(1.0, dtype=F64), grid, 1e-2)
    batched = vt.init_state(torch.ones(3, dtype=F64), grid, 1e-2,
                            batch_shape=(3,))
    with pytest.raises(ValueError, match="batched=True"):
        vt.step_once(scalar, step, adaptive=True, ctl=ctl, batched=True)
    with pytest.raises(ValueError, match="batched=False"):
        vt.resume(batched, torch.func.vmap(step), ctl=ctl, batched=False)
    one = vt.step_once(scalar, step, adaptive=True, ctl=ctl, batched=False)
    assert int(one.n_iters) == 1
    sol = vt.resume(batched, torch.func.vmap(step), ctl=ctl, batched=True,
                    error_norm=vt.lc.norm_l2_batched)
    assert (sol.status == vt.DONE).all()


# -- gradients through the scan ----------------------------------------------

def _vdp_factory(side):
    L = _lib(side)

    def factory(mu):
        return L["vo"].RungeKutta().make_step_fn(_vdp(L, mu))

    return factory


VDP_CTL = dict(rtol=1e-6, min_dt=1e-9, max_dt=2.0, max_steps=140)


def _vdp_loss(side, levels=0):
    L = _lib(side)
    mod = tdiff if side == "torch" else jdiff
    y0 = L["arr"]([2.0, 0.0])
    extra = dict(device="cpu") if side == "torch" else {}
    return mod.value_and_grad_terminal(
        lambda yf: (yf ** 2).sum(), _vdp_factory(side), y0, 0.0, 6.0, 0.5,
        adaptive=True, ctl=L["vo"].StepControl(**VDP_CTL),
        remat_levels=levels, **extra)


@functools.cache
def _jax_vdp_grad():
    return jdiff.value_and_grad_terminal(
        lambda yf: jnp.sum(yf ** 2), _vdp_factory("jax"),
        jnp.asarray([2.0, 0.0]), 0.0, 6.0, 0.5, adaptive=True,
        ctl=vo.StepControl(**VDP_CTL))(3.0)


def test_remat_levels_give_bitwise_equal_gradients():
    out = [_vdp_loss("torch", rl)(3.0) for rl in (0, 1, 2)]
    for v, g in out[1:]:
        assert torch.equal(v, out[0][0]) and torch.equal(g, out[0][1])
    v, g = out[0]
    jv, jg = _jax_vdp_grad()
    np.testing.assert_allclose(v.item(), float(jv), rtol=1e-12)
    np.testing.assert_allclose(g.item(), float(jg), rtol=1e-10)


def test_scan_grad_not_poisoned_after_done():
    """tests/test_driver.py:167: ~10x the iterations needed; the lanes
    past DONE step with dt = 0 and the gradient stays finite."""
    def factory(side):
        step = rk_step if side == "torch" else j_rk_step
        tab = vt.RKF45 if side == "torch" else vo.RKF45

        def make(theta):
            return lambda t, x, dt: step(lambda tt, y: -theta * y * y, t, x,
                                         dt, tab)

        return make

    g = tdiff.grad_terminal(
        lambda yf: yf, factory("torch"), torch.tensor(1.0, dtype=F64),
        0.0, 1.0, 0.05, adaptive=True, device="cpu",
        ctl=vt.StepControl(rtol=1e-8, max_steps=256))(1.0)
    jg = jdiff.grad_terminal(
        lambda yf: yf, factory("jax"), jnp.asarray(1.0, jnp.float64),
        0.0, 1.0, 0.05, adaptive=True,
        ctl=vo.StepControl(rtol=1e-8, max_steps=256))(1.0)
    assert np.isfinite(g.item())
    np.testing.assert_allclose(g.item(), float(jg), rtol=1e-10)
    np.testing.assert_allclose(g.item(), -0.25, rtol=1e-5)


def _tstar(side, y0):
    """tests/test_events.py:272: the terminal event's time."""
    L = _lib(side)
    sol = L["vo"].solve_ivp(
        lambda t, y: -y, 0.0, 5.0, y0,
        ctl=L["vo"].StepControl(rtol=1e-10, max_steps=120), method="scan",
        events=L["Event"](lambda t, y: y - 0.5, terminal=True))
    return sol.event_t[0]


def test_event_time_gradient_matches_jax():
    y0 = torch.tensor(1.3, dtype=F64, requires_grad=True)
    t = _tstar("torch", y0)
    (g,) = torch.autograd.grad(t, y0)
    jg = jax.grad(functools.partial(_tstar, "jax"))(
        jnp.asarray(1.3, jnp.float64))
    np.testing.assert_allclose(t.item(), np.log(1.3 / 0.5), atol=1e-8)
    np.testing.assert_allclose(g.item(), float(jg), rtol=1e-10)
    np.testing.assert_allclose(g.item(), 1 / 1.3, atol=1e-7)

"""Events and dense output in the loop kernel's plain twin
(``ops/fused_loop.torch_fused_loop``) on the CPU, in f64 on the same
numpy inputs as the JAX package: on the RK step (``RKStep``, K3) and on
the chain step (K5; Magnus-4 pair and ``fast_error``, R = 1, CFM-4 and
Magnus-6, R > 1, the fixed-step midpoint) against the JAX package's XLA
driver (``ensemble_solve(..., events=..., use_pallas=False)`` and its
dense fallback), and against its unpacked Pallas loop kernel in
interpret mode. The gate is tests/test_torch_events.py's (counters,
found and count equal per trajectory, times within 1e-10, states within
1e-12). The kernel against this twin on a card: tests/test_torch_cuda.py."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vec_ode_tpu as vo
from vec_ode_tpu import events as jev
from vec_ode_tpu import exp as vexp
from vec_ode_tpu import lc as jlc
from vec_ode_tpu.models import DrivenDense as JDrivenDense
from vec_ode_tpu.models import LandauZener as JLandauZener
from vec_ode_tpu.ops import cplx as jcp
from vec_ode_tpu.ops.pallas_rk import FusedModulatedLinearRK as JStepper
from vec_ode_tpu.parallel import ensemble_solve as jensemble_solve
import vec_ode_tpu_torch as vt
from vec_ode_tpu_torch import convert, lc
from vec_ode_tpu_torch import events as tev
from vec_ode_tpu_torch import exp as texp
from vec_ode_tpu_torch.models import DrivenDense, LandauZener
from vec_ode_tpu_torch.ops import cplx as tcp
from vec_ode_tpu_torch.ops import fused_loop
from vec_ode_tpu_torch.ops.fused_loop import (RKStep, fused_loop_integrate,
                                              loop_solution)
from vec_ode_tpu_torch.parallel import ensemble_solve

from test_torch_events import gate

torch.set_num_threads(1)

D, B, TF = 4, 8, 3.0
RK_CTL = dict(rtol=1e-8, min_dt=1e-6, max_dt=0.25, max_steps=3000)
EXP_CTL = dict(rtol=1e-6, min_dt=1e-6, max_dt=0.25, max_steps=3000)
E3 = tuple(np.eye(2 * D)[3])
P0 = tuple(np.eye(D)[0])
SAVE_AT = (0.4, 1.1, 2.3)
DENSE_AT = (0.3, 0.7, 1.25, 2.0, 2.9)


def _events(m, terminal_n=False):
    """Re z_3 (both directions, K = 3 located crossings) and a terminal
    rising population threshold; with ``terminal_n`` the second crossing
    of Re z_3 ends the row (K = 2) and the threshold does not."""
    return m.EventConfig(events=(
        m.Event(m.LinearObservable(w=E3), terminal=2 if terminal_n else False),
        m.Event(m.QuadraticObservable(q=P0, c=0.55), direction=1,
                terminal=not terminal_n)),
        max_crossings=2 if terminal_n else 3, t_tol=1e-7)


@functools.cache
def _psi():
    rng = np.random.default_rng(42)
    psi = rng.standard_normal((B, D)) + 1j * rng.standard_normal((B, D))
    return psi / np.linalg.norm(psi, axis=-1, keepdims=True)


@functools.cache
def _model():
    return JDrivenDense.make(d=D, seed=0)


@functools.cache
def _tmod():
    jmod = _model().modulated(jnp.float64)
    ext = np.asarray(vexp.MagnusModulated4(jmod, use_pallas=False)
                     ._ext_basis_w)
    return convert.modulated_from_numpy(
        np.asarray(jmod.basis.re), np.asarray(jmod.basis.im),
        DrivenDense.make(d=D, seed=0).modulated(torch.float64,
                                                device="cpu").form,
        dtype=torch.float64, device="cpu", ext_basis_w=ext)


# chain steppers: name -> (JAX maker(mod), port maker(mod), kwargs)
CHAIN = {
    "magnus4": (lambda m: vexp.MagnusModulated4(m, use_pallas=False),
                texp.MagnusModulated4),
    "magnus4_fast": (lambda m: vexp.MagnusModulated4(
        m, use_pallas=False, fast_error=True),
        lambda m: texp.MagnusModulated4(m, fast_error=True)),
    "cfm4": (lambda m: vexp.CFM4Modulated(m, use_pallas=False),
             texp.CFM4Modulated),
    "magnus6": (lambda m: vexp.MagnusModulated6(m, use_pallas=False),
                texp.MagnusModulated6),
}


def _np(sol):
    keys = ("status", "n_accept", "n_reject", "n_iters", "event_found",
            "event_count", "event_t", "event_t_k")
    out = {k: (None if getattr(sol, k, None) is None
               else np.asarray(getattr(sol, k))) for k in keys}
    out["y_final"] = np.asarray(sol.y_final.re), np.asarray(sol.y_final.im)
    out["ys"] = np.asarray(sol.ys.re), np.asarray(sol.ys.im)
    ey = getattr(sol, "event_y", None)
    out["event_y"] = (None if ey is None else
                      (np.asarray(ey.re), np.asarray(ey.im)))
    return out


@functools.cache
def _jax_chain(name, mode, **kw):
    jst = CHAIN[name][0](_model().modulated(jnp.float64))
    extra = dict(save_at=SAVE_AT) if mode == "saves" else {}
    if mode in ("events", "saves"):
        extra["events"] = _events(jev)
    if mode == "dense":
        extra.update(dense=True, save_at=DENSE_AT)
    return _np(jensemble_solve(
        None, jcp.from_complex(_psi(), jnp.float64), 0.0, TF, stepper=jst,
        ctl=vo.StepControl(**EXP_CTL), h0=1e-3, time_dtype=jnp.float64,
        **extra))


def _port_chain(name, mode, **kw):
    extra = dict(save_at=SAVE_AT) if mode == "saves" else {}
    if mode in ("events", "saves"):
        extra["events"] = _events(tev)
    if mode == "dense":
        extra.update(dense=True, save_at=DENSE_AT)
    before = fused_loop.fused_loop_chunk.launches
    sol = ensemble_solve(
        None, tcp.from_complex(_psi(), torch.float64, device="cpu"), 0.0,
        TF, stepper=CHAIN[name][1](_tmod()), ctl=vt.StepControl(**EXP_CTL),
        h0=1e-3, time_dtype=torch.float64, **extra)
    assert sol.path == "torch-loop" + ("-dense" if mode == "dense" else "")
    # the twin runs on CPU tensors: no launch
    assert fused_loop.fused_loop_chunk.launches == before
    return sol


@pytest.mark.parametrize("mode", ["events", "saves", "dense"])
@pytest.mark.parametrize("name", sorted(CHAIN))
def test_chain_loop_twin_matches_jax_xla(name, mode):
    """Events (with and without interior saves) and dense output in the
    loop twin with the chain step, R = 1 and R > 1."""
    want = _jax_chain(name, mode)
    sol = _port_chain(name, mode)
    if mode == "dense":
        for k in ("status", "n_accept", "n_reject", "n_iters"):
            np.testing.assert_array_equal(getattr(sol, k).numpy(), want[k])
        for got, ref in zip((sol.ys.re, sol.ys.im), want["ys"]):
            np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-12)
        assert sol.event_t is None
        return
    # Magnus-6 with saves: one row takes one approach step more than in
    # the JAX package (see test_torch_events.gate)
    gate(sol, want, flips=int(name == "magnus6"))
    assert (want["status"] == vo.DONE_EVENT).any()
    assert (want["event_count"][:, 0] >= 2).any()


def _rk_parts():
    jst = JStepper.from_driven_dense(_model(), jnp.float64)
    return np.asarray(jst.M0), np.asarray(jst.M1), float(_model().w)


@functools.cache
def _jax_rk(mode):
    M0, M1, w = _rk_parts()
    jst = JStepper(M0=M0, M1=M1, u_fn=lambda t: jnp.cos(w * t),
                   use_pallas=False)
    extra = dict(save_at=SAVE_AT) if mode == "saves" else {}
    if mode in ("events", "saves", "terminal_n"):
        extra["events"] = _events(jev, mode == "terminal_n")
    if mode == "dense":
        extra.update(dense=True, save_at=DENSE_AT)
    return _np(jensemble_solve(
        None, jcp.from_complex(_psi(), jnp.float64), 0.0, TF, stepper=jst,
        ctl=vo.StepControl(**RK_CTL), h0=1e-3, time_dtype=jnp.float64,
        **extra))


def _port_rk(mode, persistent=True, chunk=8):
    """The RK loop twin through fused_loop_integrate (the stepper's
    fused_loop_solve declines on the CPU, as the JAX package's does off
    the TPU), its Solution built as fused_loop_solve builds it."""
    M0, M1, w = _rk_parts()
    st = convert.stepper_from_numpy(M0, M1, w, device="cpu")
    save_at = SAVE_AT if mode == "saves" else (
        DENSE_AT if mode == "dense" else None)
    grid = vt.make_grid(0.0, TF, save_at, dtype=torch.float64, device="cpu")
    events = None
    if mode in ("events", "saves", "terminal_n"):
        events = _events(tev, mode == "terminal_n").kernel_spec(D, 2)
    dense = mode == "dense"
    x0 = torch.as_tensor(np.concatenate([_psi().real, _psi().imag], 1))
    out = fused_loop_integrate(
        grid[[0, -1]] if dense else grid, x0, 1e-3,
        RKStep(M0=st.M0, M1=st.M1, w=w), ctl=vt.StepControl(**RK_CTL),
        persistent=persistent, chunk=chunk, events=events,
        dense_times=grid[1:-1] if dense else None)

    def unwiden(xw):
        return tcp.Cplx(xw[..., :D], xw[..., D:])

    def slope(t, xw):
        f = st.hermite_slope(t, unwiden(xw))
        return torch.cat([f.re, f.im], -1)

    return loop_solution(grid, x0, out, path="twin", unwiden=unwiden,
                         slope=slope)


@pytest.mark.parametrize("mode", ["events", "saves", "terminal_n", "dense"])
def test_rk_loop_twin_matches_jax_xla(mode):
    want = _jax_rk(mode)
    sol = _port_rk(mode)
    if mode == "dense":
        assert sol.path == "twin-dense"
        for k in ("status", "n_accept", "n_reject", "n_iters"):
            np.testing.assert_array_equal(getattr(sol, k).numpy(), want[k])
        for got, ref in zip((sol.ys.re, sol.ys.im), want["ys"]):
            np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-12)
        return
    gate(sol, want)
    assert (want["status"] == vo.DONE_EVENT).any()
    if mode == "terminal_n":
        stopped = want["status"] == vo.DONE_EVENT
        assert (want["event_count"][stopped, 0] == 2).all()


@pytest.mark.parametrize("mode", ["saves", "dense"])
def test_persistent_equals_chunked(mode):
    """Chunked launches round-trip the event and dense carries."""
    p = _port_rk(mode, persistent=True)
    c = _port_rk(mode, persistent=False, chunk=3)
    for k in ("status", "n_accept", "n_reject", "n_iters", "h_final",
              "t_final", "event_found", "event_count", "event_t_k"):
        a, b = getattr(p, k), getattr(c, k)
        assert (a is None and b is None) or torch.equal(a, b), k
    assert torch.equal(p.ys.re, c.ys.re) and torch.equal(p.ys.im, c.ys.im)


def test_terminal_event_before_a_save_leaves_later_slots_zero():
    """A row stopped by its terminal event before an interior save time
    keeps that slot zero (the XLA driver's convention; the JAX package's
    windowed persistent saves write the frozen state there)."""
    sol = _port_rk("saves")
    stopped = sol.status == vt.DONE_EVENT
    assert stopped.any()
    grid = torch.tensor((0.0,) + SAVE_AT + (TF,), dtype=torch.float64)
    later = grid > sol.t_final[stopped][:, None]
    assert later.any()
    assert (sol.ys.re[stopped][later] == 0).all()
    assert (sol.ys.im[stopped][later] == 0).all()


@functools.cache
def _lz_psi(n=8):
    rng = np.random.default_rng(42)
    psi = rng.standard_normal((n, 2)) + 1j * rng.standard_normal((n, 2))
    psi /= np.linalg.norm(psi, axis=-1, keepdims=True)
    psi[: n // 2] = [1.0, 0.0]
    return psi


def _lz_events(m):
    return m.EventConfig(events=(
        m.Event(m.QuadraticObservable(q=[0.0, 1.0], c=0.05), direction=1,
                terminal=True),
        m.Event(m.LinearObservable(w=[1.0, 0.0, 0.0, 0.0], c=0.3))),
        max_crossings=2, t_tol=1e-4)


def test_fixed_step_midpoint_events_match_jax_xla():
    """Landau-Zener sweeps in fixed steps with a terminal population
    event: the loop twin against the XLA driver."""
    lz = dict(v=2.0, delta=0.4)
    want = _np(jensemble_solve(
        None, jcp.from_complex(_lz_psi(), jnp.float64), -20.0, 20.0,
        stepper=vexp.MidpointModulated(
            JLandauZener(**lz).modulated(jnp.float64), use_pallas=False),
        h0=0.01, adaptive=False, time_dtype=jnp.float64,
        events=_lz_events(jev)))
    sol = ensemble_solve(
        None, tcp.from_complex(_lz_psi(), torch.float64, device="cpu"),
        -20.0, 20.0, stepper=texp.MidpointModulated(
            LandauZener(**lz).modulated(torch.float64, device="cpu")),
        h0=0.01, adaptive=False, time_dtype=torch.float64,
        events=_lz_events(tev))
    assert sol.path == "torch-loop"
    gate(sol, want, y_tol=1e-10)
    # the |0> rows cross the threshold once, rising, and stop there
    assert (sol.status[: len(_lz_psi()) // 2] == vt.DONE_EVENT).all()
    assert (sol.n_reject == 0).all()


def test_events_under_a_declared_norm_match_jax_xla():
    w = tuple(np.linspace(0.5, 2.0, D))
    want = _np(jensemble_solve(
        None, jcp.from_complex(_psi(), jnp.float64), 0.0, TF,
        stepper=vexp.MagnusModulated4(_model().modulated(jnp.float64),
                                      use_pallas=False),
        ctl=vo.StepControl(**EXP_CTL), h0=1e-3, time_dtype=jnp.float64,
        error_norm=jlc.WeightedNorm("l2", w), events=_events(jev)))
    sol = ensemble_solve(
        None, tcp.from_complex(_psi(), torch.float64, device="cpu"), 0.0,
        TF, stepper=texp.MagnusModulated4(_tmod()),
        ctl=vt.StepControl(**EXP_CTL), h0=1e-3, time_dtype=torch.float64,
        error_norm=lc.WeightedNorm("l2", w), events=_events(tev))
    assert sol.path == "torch-loop"
    gate(sol, want)


def test_twin_matches_jax_pallas_loop_interpret():
    """The JAX package's unpacked loop kernel (d = 64, widened 128, no
    lane packing) in interpret mode with Re z_3 as in
    tests/test_kernel_events.py:155, plus a terminal population event,
    against the port's loop twin on the same states."""
    d, n = 64, 8
    model = JDrivenDense.make(d=d, seed=0)
    jmod = model.modulated(jnp.float64)
    rng = np.random.default_rng(21)
    z = rng.standard_normal((n, d)) + 1j * rng.standard_normal((n, d))
    z /= np.linalg.norm(z, axis=-1, keepdims=True)
    w = np.zeros(2 * d)
    w[3] = 1.0
    q = np.zeros(d)
    q[0] = 1.0

    def cfg(m):
        return m.EventConfig(events=(
            m.Event(m.LinearObservable(w=w)),
            m.Event(m.QuadraticObservable(q=q, c=0.02), terminal=True)),
            max_crossings=3, t_tol=1e-7)

    ctl = dict(rtol=1e-6, min_dt=1e-6, max_dt=0.2, max_steps=2000)
    jst = vexp.MagnusModulated4(jmod, interpret=True)
    grid = vo.make_grid(0.0, 0.5, dtype=jnp.float64)
    orig = jax.default_backend
    try:
        jax.default_backend = lambda: "tpu"
        jsol = jst.fused_loop_solve(jcp.from_complex(z, jnp.float64), grid,
                                    1e-2, ctl=vo.StepControl(**ctl),
                                    adaptive=True, events=cfg(jev))
    finally:
        jax.default_backend = orig
    assert jsol.path == "pallas-loop-persistent"
    ext = np.asarray(vexp.MagnusModulated4(jmod, use_pallas=False)
                     ._ext_basis_w)
    tmod = convert.modulated_from_numpy(
        np.asarray(jmod.basis.re), np.asarray(jmod.basis.im),
        DrivenDense.make(d=d, seed=0).modulated(torch.float64,
                                                device="cpu").form,
        dtype=torch.float64, device="cpu", ext_basis_w=ext)
    sol = ensemble_solve(
        None, tcp.from_complex(z, torch.float64, device="cpu"), 0.0, 0.5,
        stepper=texp.MagnusModulated4(tmod), ctl=vt.StepControl(**ctl),
        h0=1e-2, time_dtype=torch.float64, events=cfg(tev))
    assert sol.path == "torch-loop"
    want = _np(jsol)
    gate(sol, want, y_tol=1e-10)
    assert want["event_found"].any()


def test_opaque_events_decline_the_loop():
    """The loop runs declared observables only: an opaque callable makes
    fused_loop_solve decline and the host driver run the events."""
    st = texp.MagnusModulated4(_tmod())
    y0 = tcp.from_complex(_psi(), torch.float64, device="cpu")
    grid = vt.make_grid(0.0, TF, dtype=torch.float64, device="cpu")
    cfg = tev.EventConfig(events=(tev.Event(lambda t, x: x.re[0] - 0.1),
                                  tev.Event(tev.LinearObservable(w=E3))),
                          t_tol=1e-7)
    assert st.fused_loop_solve(y0, grid, 1e-3, ctl=vt.StepControl(**EXP_CTL),
                               adaptive=True, events=cfg) is None
    sol = ensemble_solve(None, y0, 0.0, TF, stepper=st,
                         ctl=vt.StepControl(**EXP_CTL), h0=1e-3,
                         time_dtype=torch.float64, events=cfg)
    assert sol.path == "torch-driver"
    assert sol.event_found.shape == (B, 2)


def test_no_cap_on_events_or_slots():
    """Twelve events of eight slots (past the JAX kernel's budgets of 8
    events and 32 slots, where it declines) run in the loop and match the
    host driver on the same stepper without a declared form."""
    rows = np.eye(2 * D)
    evs = tuple(tev.Event(tev.LinearObservable(w=rows[i % (2 * D)],
                                               c=0.02 * (i // (2 * D))))
                for i in range(12))
    cfg = tev.EventConfig(events=evs, max_crossings=8, t_tol=1e-7)
    y0 = tcp.from_complex(_psi(), torch.float64, device="cpu")
    sols = [ensemble_solve(None, y0, 0.0, TF,
                           stepper=texp.MagnusModulated4(op),
                           ctl=vt.StepControl(**EXP_CTL), h0=1e-3,
                           time_dtype=torch.float64, events=cfg)
            for op in (_tmod(), dataclasses.replace(_tmod(), form=None))]
    assert [s.path for s in sols] == ["torch-loop", "torch-driver"]
    for k in ("status", "n_accept", "n_reject", "n_iters", "event_found",
              "event_count"):
        assert torch.equal(getattr(sols[0], k), getattr(sols[1], k)), k
    fin = torch.isfinite(sols[1].event_t_k)
    assert torch.equal(torch.isfinite(sols[0].event_t_k), fin)
    assert (sols[0].event_t_k[fin] - sols[1].event_t_k[fin]).abs().max() \
        < 1e-12
    assert (sols[0].event_count >= 2).sum() > 10


def test_event_carry_round_trip_and_checks():
    """fused_loop_chunk takes the event and dense carries as declared and
    refuses what does not match them."""
    M0, M1, w = _rk_parts()
    st = convert.stepper_from_numpy(M0, M1, w, device="cpu")
    spec = _events(tev).kernel_spec(D, 2)
    x0 = torch.as_tensor(np.concatenate([_psi().real, _psi().imag], 1))
    ev = fused_loop.init_event_carry(spec, x0)
    assert ev.g_prev.shape == (B, 2) and ev.t_ev.shape == (B, 2, 3)
    assert ev.y_ev.shape == (2, B, 2 * D)
    assert torch.equal(ev.g_prev[:, 0], x0[:, 3])   # g = Re z_3
    grid, fs, ist, x, saves = fused_loop.init_carries(
        torch.tensor([0.0, TF], dtype=torch.float64), x0, 1e-3)
    step = RKStep(M0=st.M0, M1=st.M1, w=w)
    ctl = vt.StepControl(**RK_CTL)
    with pytest.raises(ValueError, match="together"):
        fused_loop.fused_loop_chunk(grid, fs, ist, x, saves, step, ctl=ctl,
                                    events=spec)
    with pytest.raises(TypeError, match="count"):
        fused_loop.fused_loop_chunk(
            grid, fs, ist, x, saves, step, ctl=ctl, events=spec,
            ev=ev._replace(count=ev.count.long()))
    dn = fused_loop.init_dense_carry(torch.tensor(DENSE_AT), x0)
    with pytest.raises(ValueError, match="free-running"):
        fused_loop.fused_loop_chunk(
            torch.tensor([0.0, 1.0, TF], dtype=torch.float64), fs, ist, x,
            torch.zeros(1, B, 2 * D, dtype=torch.float64), step, ctl=ctl,
            dense=dn)

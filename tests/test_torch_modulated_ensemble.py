"""The modulated exponential ensembles of the port on the CPU:
``parallel.ensemble_solve`` with ``MagnusModulated4`` through its per-step
twin (an operator without a declared form: the host driver over the twin
of K4) and through its loop twin (the declared form: the twin of the loop
kernel with its chain step K5), against the JAX package's
``ensemble_solve`` over ``MagnusModulated4(mod, use_pallas=False)`` (the
XLA driver) and against its Pallas loop kernel in interpret mode
(unpacked, D = 128), in f64 on the same numpy inputs; and the
Landau-Zener sweep with ``MidpointModulated`` in fixed steps. The gate:
status, n_accept, n_reject and n_iters equal per trajectory, y_final to
1e-10."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vec_ode_tpu as vo
from vec_ode_tpu import exp as vexp
from vec_ode_tpu import lc as jlc
from vec_ode_tpu.models import DrivenDense as JDrivenDense
from vec_ode_tpu.models import LandauZener as JLandauZener
from vec_ode_tpu.ops import cplx as jcp
from vec_ode_tpu.parallel import ensemble_solve as jensemble_solve
import vec_ode_tpu_torch as vt
from vec_ode_tpu_torch import convert, lc
from vec_ode_tpu_torch import exp as texp
from vec_ode_tpu_torch.models import DrivenDense, LandauZener
from vec_ode_tpu_torch.ops import cplx as tcp
from vec_ode_tpu_torch.ops import expmv, fused_loop
from vec_ode_tpu_torch.parallel import ensemble_solve

torch.set_num_threads(1)

B, D, TF = 16, 64, 0.3
BASE = dict(rtol=1e-5, min_dt=1e-5, max_dt=0.2, max_steps=2000)
WEIGHTS = tuple(np.linspace(0.5, 2.0, D))


@dataclasses.dataclass(frozen=True)
class Case:
    ctl: dict = dataclasses.field(default_factory=dict)
    save_at: tuple = None
    norm: tuple = None          # (kind, weights) of a WeightedNorm
    fast_error: bool = False
    h0: float = 1e-3


CASES = {
    "plain": Case(),
    "save_grid": Case(save_at=(0.075, 0.15, 0.225)),
    "pi": Case(ctl=dict(pi=True)),
    "scaled_error": Case(ctl=dict(scaled_error=True, rtol=1e-6, atol=1e-9)),
    "weighted_l2": Case(norm=("l2", WEIGHTS)),
    "weighted_max": Case(norm=("max", None)),
    "fast_error": Case(fast_error=True),
    "max_steps": Case(ctl=dict(max_steps=6)),
    # far too long a first step at rtol 1e-14: rejects in a row
    "stalled": Case(ctl=dict(max_reject_streak=2, rtol=1e-14), h0=0.2),
}
# scaled_error runs in the loop only, as in the JAX package
XLA_CASES = [k for k in CASES if k != "scaled_error"]
STATUS = {"max_steps": vt.ERR_MAX_STEPS, "stalled": vt.ERR_STALLED}


@functools.cache
def _problem():
    model = JDrivenDense.make(d=D, seed=0)
    jmod = model.modulated(jnp.float64)
    rng = np.random.default_rng(42)
    psi = rng.standard_normal((B, D)) + 1j * rng.standard_normal((B, D))
    psi /= np.linalg.norm(psi, axis=-1, keepdims=True)
    ext = np.asarray(vexp.MagnusModulated4(jmod, use_pallas=False)
                     ._ext_basis_w)
    tmod = convert.modulated_from_numpy(
        np.asarray(jmod.basis.re), np.asarray(jmod.basis.im),
        DrivenDense.make(d=D, seed=0).modulated(torch.float64,
                                                device="cpu").form,
        dtype=torch.float64, device="cpu", ext_basis_w=ext)
    return jmod, tmod, psi


def _jctl(case):
    return vo.StepControl(**{**BASE, **case.ctl})


@functools.cache
def _jax_xla(name):
    case = CASES[name]
    jmod, _, psi = _problem()
    kw = {}
    if case.norm is not None:
        kw["error_norm"] = jlc.WeightedNorm(*case.norm)
    sol = jensemble_solve(
        None, jcp.from_complex(psi, jnp.float64), 0.0, TF,
        stepper=vexp.MagnusModulated4(jmod, use_pallas=False,
                                      fast_error=case.fast_error),
        ctl=_jctl(case), h0=case.h0, save_at=case.save_at,
        time_dtype=jnp.float64, **kw)
    return _np_sol(sol)


@functools.cache
def _jax_pallas_loop(name):
    """The JAX package's whole-loop kernel, interpret mode, unpacked (the
    widened width is 128): its ``fused_loop_solve`` with the backend
    stubbed, as tests/test_modulated.py runs it."""
    case = CASES[name]
    jmod, _, psi = _problem()
    st = vexp.MagnusModulated4(
        jmod, interpret=True, fast_error=case.fast_error,
        norm=None if case.norm is None else jlc.WeightedNorm(*case.norm))
    grid = vo.make_grid(0.0, TF, case.save_at, dtype=jnp.float64)
    orig = jax.default_backend
    try:
        jax.default_backend = lambda: "tpu"
        sol = st.fused_loop_solve(jcp.from_complex(psi, jnp.float64), grid,
                                  case.h0, ctl=_jctl(case), adaptive=True)
    finally:
        jax.default_backend = orig
    assert sol.path == "pallas-loop-persistent", sol.path
    return _np_sol(sol)


def _np_sol(sol):
    out = {k: np.asarray(getattr(sol, k)) for k in
           ("status", "n_accept", "n_reject", "n_iters")}
    out["y"] = np.concatenate([np.asarray(sol.y_final.re),
                               np.asarray(sol.y_final.im)], axis=-1)
    out["ys"] = np.concatenate([np.asarray(sol.ys.re),
                                np.asarray(sol.ys.im)], axis=-1)
    return out


def _port(name, path):
    case = CASES[name]
    _, tmod, psi = _problem()
    op = tmod if path == "loop" else dataclasses.replace(tmod, form=None)
    kw = {}
    if case.norm is not None:
        kw["error_norm"] = lc.WeightedNorm(*case.norm)
    sol = ensemble_solve(
        None, tcp.from_complex(psi, torch.float64, device="cpu"), 0.0, TF,
        stepper=texp.MagnusModulated4(op, fast_error=case.fast_error),
        ctl=vt.StepControl(**{**BASE, **case.ctl}), h0=case.h0,
        save_at=case.save_at, time_dtype=torch.float64, **kw)
    assert sol.path == ("torch-loop" if path == "loop" else "torch-driver")
    return sol


def _gate(sol, want, name):
    for k in ("status", "n_accept", "n_reject", "n_iters"):
        np.testing.assert_array_equal(getattr(sol, k).numpy(), want[k],
                                      err_msg=k)
    assert (sol.status.numpy() == STATUS.get(name, vt.DONE)).all()
    y = torch.cat([sol.y_final.re, sol.y_final.im], 1).numpy()
    np.testing.assert_allclose(y, want["y"], rtol=0, atol=1e-10)
    ys = torch.cat([sol.ys.re, sol.ys.im], -1).numpy()
    np.testing.assert_allclose(ys, want["ys"], rtol=0, atol=1e-10)


@pytest.mark.parametrize("path", ["per_step", "loop"])
@pytest.mark.parametrize("name", XLA_CASES)
def test_magnus4_ensemble_matches_jax_xla(name, path):
    _gate(_port(name, path), _jax_xla(name), name)


@pytest.mark.parametrize("name", ["plain", "save_grid", "scaled_error",
                                  "fast_error", "weighted_max"])
def test_loop_twin_matches_jax_pallas_loop(name):
    _gate(_port(name, "loop"), _jax_pallas_loop(name), name)


def test_scaled_error_needs_the_loop():
    """As in the JAX package, scaled_error on a norm-returning stepper
    runs only in the loop; the per-step path raises."""
    with pytest.raises(ValueError, match="scaled_error"):
        _port("scaled_error", "per_step")


def test_loop_solve_declines_and_routes():
    _, tmod, psi = _problem()
    y0 = tcp.from_complex(psi, torch.float64, device="cpu")
    grid = vt.make_grid(0.0, TF, dtype=torch.float64, device="cpu")
    ctl = vt.StepControl(**BASE)
    st = texp.MagnusModulated4(tmod)
    # another adaptivity than the stepper's, no declared form, a state
    # that is not (B, d), a time dtype other than the state's: None
    assert st.fused_loop_solve(y0, grid, 1e-3, ctl=ctl,
                               adaptive=False) is None
    assert texp.MagnusModulated4(dataclasses.replace(tmod, form=None)) \
        .fused_loop_solve(y0, grid, 1e-3, ctl=ctl, adaptive=True) is None
    assert st.fused_loop_solve(tcp.Cplx(y0.re[0], y0.im[0]), grid, 1e-3,
                               ctl=ctl, adaptive=True) is None
    assert st.fused_loop_solve(y0, grid.float(), 1e-3, ctl=ctl,
                               adaptive=True) is None
    # an opaque event declines (the kernel runs declared observables);
    # dense output on the bare [t0, tf] is the plain solve, with interior
    # times the free-running loop
    opaque = vt.EventConfig(events=(vt.Event(lambda t, x: x.re[0]),))
    assert st.fused_loop_solve(y0, grid, 1e-3, ctl=ctl, adaptive=True,
                               events=opaque) is None
    assert st.fused_loop_solve(y0, grid, 1e-3, ctl=ctl, adaptive=True,
                               dense=True).path == "torch-loop"
    grid3 = vt.make_grid(0.0, TF, (0.1,), dtype=torch.float64, device="cpu")
    assert st.fused_loop_solve(y0, grid3, 1e-3, ctl=ctl, adaptive=True,
                               dense=True).path == "torch-loop-dense"
    # the per-step twin launches nothing on CPU tensors
    before = (expmv.fused_chain_apply.launches,
              fused_loop.fused_loop_chunk.launches)
    _port("plain", "per_step")
    _port("plain", "loop")
    assert (expmv.fused_chain_apply.launches,
            fused_loop.fused_loop_chunk.launches) == before
    # the persistent and chunked loop twins take the same steps
    p = st.fused_loop_solve(y0, grid, 1e-3, ctl=ctl, adaptive=True)
    c = st.fused_loop_solve(y0, grid, 1e-3, ctl=ctl, adaptive=True,
                            persistent=False, chunk=3)
    for k in ("status", "n_accept", "n_reject", "n_iters", "h_final"):
        assert torch.equal(getattr(p, k), getattr(c, k)), k
    assert torch.equal(p.y_final.re, c.y_final.re)


LZ = dict(v=2.0, delta=0.4)


@functools.cache
def _lz_inputs(n=8):
    """Half the rows in |0>, the rest random unit states."""
    rng = np.random.default_rng(42)
    psi = rng.standard_normal((n, 2)) + 1j * rng.standard_normal((n, 2))
    psi /= np.linalg.norm(psi, axis=-1, keepdims=True)
    psi[: n // 2] = [1.0, 0.0]
    return psi


def test_landau_zener_fixed_steps_match_jax_and_closed_form():
    """MidpointModulated, fixed steps of 0.01 over t in [-20, 20] (4000
    steps): the loop twin against the JAX package's XLA driver (not its
    lane-packed loop, whose counters differ by one, ROADMAP queue 3), and
    the |0> rows against the closed-form transition probability."""
    psi = _lz_inputs()
    jsol = jensemble_solve(
        None, jcp.from_complex(psi, jnp.float64), -20.0, 20.0,
        stepper=vexp.MidpointModulated(
            JLandauZener(**LZ).modulated(jnp.float64), use_pallas=False),
        h0=0.01, adaptive=False, time_dtype=jnp.float64)
    lz = LandauZener(**LZ)
    sol = ensemble_solve(
        None, tcp.from_complex(psi, torch.float64, device="cpu"), -20.0,
        20.0, stepper=texp.MidpointModulated(
            lz.modulated(torch.float64, device="cpu")),
        h0=0.01, adaptive=False, time_dtype=torch.float64)
    assert sol.path == "torch-loop"
    want = _np_sol(jsol)
    for k in ("status", "n_accept", "n_reject", "n_iters"):
        np.testing.assert_array_equal(getattr(sol, k).numpy(), want[k])
    assert (sol.status.numpy() == vt.DONE).all()
    assert (sol.n_accept.numpy() == 4000).all()
    y = torch.cat([sol.y_final.re, sol.y_final.im], 1).numpy()
    np.testing.assert_allclose(y, want["y"], rtol=0, atol=1e-10)
    p_stay = y[: len(psi) // 2, 0] ** 2 + y[: len(psi) // 2, 2] ** 2
    np.testing.assert_allclose(p_stay, lz.p_transition, atol=0.02)
    np.testing.assert_allclose(np.linalg.norm(y, axis=1), 1.0, atol=1e-10)


def test_landau_zener_per_step_twin_matches_loop_twin():
    """The same sweep over [-2, 2] through the host driver over the per-step
    twin (no declared form) and through the loop twin: the same steps."""
    psi = _lz_inputs()
    op = LandauZener(**LZ).modulated(torch.float64, device="cpu")
    sols = [ensemble_solve(
        None, tcp.from_complex(psi, torch.float64, device="cpu"), -2.0, 2.0,
        stepper=texp.MidpointModulated(o), h0=0.01, adaptive=False,
        time_dtype=torch.float64)
        for o in (op, dataclasses.replace(op, form=None))]
    assert [s.path for s in sols] == ["torch-loop", "torch-driver"]
    for k in ("status", "n_accept", "n_reject", "n_iters"):
        assert torch.equal(getattr(sols[0], k), getattr(sols[1], k)), k
    assert torch.equal(sols[0].y_final.re, sols[1].y_final.re)
    with pytest.raises(ValueError, match="error estimate"):
        ensemble_solve(None, tcp.from_complex(psi, torch.float64,
                                              device="cpu"), -2.0, 2.0,
                       stepper=texp.MidpointModulated(op), h0=0.01,
                       time_dtype=torch.float64)

"""The vmapped tier of the port's ``parallel.ensemble_solve`` (one batched
driver loop over ``torch.func.vmap`` of the per-trajectory step) against
the JAX package's (``jax.vmap`` of the XLA driver), in f64 on the same
numpy inputs: ``stepper=None`` (RKF45) on Van der Pol, Lotka-Volterra
and ``DrivenDense.rhs_pair``, fixed-step RK4 on Van der Pol (BASELINE
config 2), heterogeneous step counts through ``params=`` (the case of
``tests/test_driver.py::test_vmap_heterogeneous_step_counts``),
per-trajectory ``h0``, ``scaled_error``, an opaque error norm, a declared
``WeightedNorm``, opaque event callables and ``Magnus4(batched=False)``;
and the arity check of ``params``. Per trajectory: status, n_accept,
n_reject and n_iters equal, y_final and ys within rtol 1e-12, h_final
within ``H_FINAL_TIGHT``. The controller's rtol is 1e-8, that of
``test_vmap_heterogeneous_step_counts`` and of the JAX package's flagship
ensemble."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vec_ode_tpu as vo
from vec_ode_tpu import exp as vexp
from vec_ode_tpu import lc as jlc
from vec_ode_tpu import models as jm
from vec_ode_tpu.events import Event as JEvent
from vec_ode_tpu.events import EventConfig as JEventConfig
from vec_ode_tpu.ops import cplx as jcp
from vec_ode_tpu.parallel import ensemble_solve as jensemble_solve
import vec_ode_tpu_torch as vt
from vec_ode_tpu_torch import exp as texp
from vec_ode_tpu_torch import lc
from vec_ode_tpu_torch import models as tm
from vec_ode_tpu_torch.events import Event, EventConfig
from vec_ode_tpu_torch.ops import cplx as tcp
from vec_ode_tpu_torch.parallel import ensemble_solve

from test_torch_rk import H_FINAL_TIGHT, assert_same_solution

torch.set_num_threads(1)

B = 4
CTL = dict(rtol=1e-8, min_dt=1e-6, max_dt=0.25)


def _vdp_y0():
    return np.random.default_rng(0).uniform(-2, 2, (B, 2))


def _lv_y0():
    return np.random.default_rng(1).uniform(0.5, 2.0, (B, 2))


def _psi(d=4):
    rng = np.random.default_rng(42)
    psi = rng.standard_normal((B, d)) + 1j * rng.standard_normal((B, d))
    return psi / np.linalg.norm(psi, axis=-1, keepdims=True)


def _side(side):
    if side == "jax":
        return dict(m=jm, solve=jensemble_solve, ctl=vo.StepControl,
                    arr=jnp.asarray, RK=vo.RungeKutta, TAB=vo.TABLEAUS,
                    lc=jlc, ex=vexp, Event=JEvent, EventConfig=JEventConfig,
                    f64=jnp.float64,
                    cplx=lambda z: jcp.from_complex(z, jnp.float64))
    return dict(m=tm, solve=ensemble_solve, ctl=vt.StepControl,
                arr=torch.as_tensor, RK=vt.RungeKutta, TAB=vt.TABLEAUS,
                lc=lc, ex=texp, Event=Event, EventConfig=EventConfig,
                f64=torch.float64,
                cplx=lambda z: tcp.from_complex(z, torch.float64,
                                                device="cpu"))


def _max_abs(side):
    if side == "jax":
        return lambda e: jnp.max(jnp.abs(e))
    return lambda e: torch.amax(torch.abs(e))


def _op_pair(side):
    if side == "jax":
        m = jm.DrivenDense.make(d=4, seed=0)
        return lambda t: m.op_pair(t, jnp.float64)
    m = tm.DrivenDense.make(d=4, seed=0)
    return lambda t: m.op_pair(t, torch.float64, device="cpu")


def _case(side, name):
    """(rhs_or_op, y0, t0, tf, kwargs) of each case on one side."""
    S = _side(side)
    vdp = S["m"].VanDerPol(mu=1.5).rhs
    y_vdp = S["arr"](_vdp_y0())
    ctl = S["ctl"](**CTL)
    base = dict(ctl=ctl, h0=1e-2)
    if name == "vdp":
        return vdp, y_vdp, 0.0, 2.0, dict(base, save_at=[0.5, 1.0])
    if name == "lotka_volterra":
        return (S["m"].LotkaVolterra().rhs, S["arr"](_lv_y0()), 0.0, 2.0,
                base)
    if name == "rhs_pair":
        m = S["m"].DrivenDense.make(d=4, seed=0)
        return ((lambda t, y: m.rhs_pair(t, y, S["f64"])), S["cplx"](_psi()),
                0.0, 1.0, dict(base, save_at=[0.25, 0.5]))
    if name == "rk4_fixed":
        return vdp, y_vdp, 0.0, 1.0, dict(
            stepper=S["RK"](S["TAB"]["rk4"]), adaptive=False, h0=0.01)
    if name == "heterogeneous_params":
        return ((lambda t, y, p: p * y), S["arr"](np.ones(B)), 0.0, 1.0,
                dict(base, params=S["arr"](np.array([-0.1, -1.0, -10.0,
                                                     -100.0]))))
    if name == "vdp_params":
        mus = np.array([0.5, 1.0, 1.5, 3.0])

        stack = jnp.stack if side == "jax" else torch.stack

        def f(t, y, p):
            x, v = y[..., 0], y[..., 1]
            return stack([v, p * (1.0 - x * x) * v - x], -1)
        return f, y_vdp, 0.0, 1.0, dict(base, params=S["arr"](mus))
    if name == "h0_per_trajectory":
        return vdp, y_vdp, 0.0, 1.0, dict(
            ctl=ctl, h0=S["arr"](np.array([1e-3, 1e-2, 5e-2, 1e-1])))
    if name == "scaled_error":
        return vdp, y_vdp, 0.0, 1.0, dict(base, ctl=S["ctl"](
            scaled_error=True, atol=1e-9, **CTL))
    if name == "opaque_norm":
        return vdp, y_vdp, 0.0, 1.0, dict(base, error_norm=_max_abs(side))
    if name == "weighted_norm":
        return vdp, y_vdp, 0.0, 1.0, dict(
            base, error_norm=S["lc"].WeightedNorm("rms", (1.0, 0.5)))
    if name == "opaque_events":
        cfg = S["EventConfig"](events=(
            S["Event"](lambda t, y: y[0]),
            S["Event"](lambda t, y: y[1] - 1.0, direction=1, terminal=True),
        ), t_tol=1e-9)
        return vdp, y_vdp, 0.0, 3.0, dict(base, events=cfg)
    if name == "magnus4_unbatched":
        return (_op_pair(side), S["cplx"](_psi()), 0.0, 1.0, dict(
            base, h0=2e-2, stepper=S["ex"].Magnus4(S["ex"].DenseCplxSplit(),
                                                   batched=False)))
    raise KeyError(name)


CASES = ["vdp", "lotka_volterra", "rhs_pair", "rk4_fixed",
         "heterogeneous_params", "vdp_params", "h0_per_trajectory",
         "scaled_error", "opaque_norm", "weighted_norm", "opaque_events",
         "magnus4_unbatched"]


def _solve(side, name):
    f, y0, t0, tf, kw = _case(side, name)
    return _side(side)["solve"](f, y0, t0, tf, **kw)


@functools.cache
def _jax_solution(name):
    return _solve("jax", name)


@pytest.mark.parametrize("name", CASES)
def test_vmapped_tier_matches_jax(name):
    got = _solve("torch", name)
    want = _jax_solution(name)
    assert got.path == "torch-driver"
    assert got.n_rhs_evals is None and want.n_rhs_evals is None
    assert_same_solution(got, want, events=name == "opaque_events",
                         h_rtol=H_FINAL_TIGHT)
    assert got.ts.shape == (B, np.asarray(want.ts).shape[-1])


def test_heterogeneous_step_counts_finish_apart():
    """Each lane steps its own sequence: the stiffer lanes take more steps,
    and each lane's result is the same as its own single solve."""
    sol = _solve("torch", "heterogeneous_params")
    assert (sol.status == vt.DONE).all()
    n = sol.n_accept.tolist()
    assert n[3] > n[2] > n[0], n
    rates = [-0.1, -1.0, -10.0, -100.0]
    for b, r in enumerate(rates):
        one = vt.solve_ivp(lambda t, y: r * y, 0.0, 1.0,
                           torch.tensor(1.0, dtype=torch.float64),
                           ctl=vt.StepControl(**CTL), h0=1e-2)
        assert int(one.n_accept) == n[b]
        assert int(one.n_iters) == int(sol.n_iters[b])
        np.testing.assert_allclose(sol.y_final[b].item(),
                                   one.y_final.item(), rtol=1e-14)


def test_params_arity_is_checked():
    """With params an RK RHS takes (t, y, p) and an operator (t, p), on
    both sides."""
    y0 = torch.ones(B, dtype=torch.float64)
    m4 = dict(stepper=texp.Magnus4(texp.DenseCplxSplit(), batched=False))
    for fn, kw in ((lambda t, y: -y, {}), (lambda t, y, p: y, m4)):
        with pytest.raises(ValueError, match="params"):
            ensemble_solve(fn, y0, 0.0, 1.0, h0=1e-2, params=y0, **kw)
    with pytest.raises(ValueError, match="params"):
        jensemble_solve(lambda t, y: -y, jnp.ones(B), 0.0, 1.0, h0=1e-2,
                        params=jnp.ones(B))


@pytest.mark.parametrize("kw", [
    # dense output (item 13) and method="scan" (item 22) run on this tier
    # now (tests/test_torch_dense_tiers.py, test_torch_scan.py); dense
    # output with events stays refused, as in the JAX package
    dict(dense=True, save_at=[0.5], events=lambda t, y: y - 0.5),
    dict(mesh=object()),
    dict(method="scan", mesh=object()),
])
def test_vmapped_tier_refusals_name_their_item(kw):
    # mesh= takes a torch.distributed DeviceMesh (tests/test_torch_mesh.py)
    err, match = ((ValueError, "events") if "dense" in kw
                  else (TypeError, "DeviceMesh"))
    with pytest.raises(err, match=match):
        ensemble_solve(lambda t, y: -y, torch.ones(B, dtype=torch.float64),
                       0.0, 1.0, h0=1e-2, **kw)


def test_masked_lanes_step_with_zero_dt_and_stay_finite():
    """A lane that finished steps with dt = 0 while the others run: its
    state does not move and nothing non-finite leaks into it."""
    y0 = torch.tensor([1.0, 1.0], dtype=torch.float64)
    sol = ensemble_solve(lambda t, y, p: p * y, y0, 0.0, 1.0, h0=1e-2,
                         ctl=vt.StepControl(**CTL),
                         params=torch.tensor([-0.1, -100.0],
                                             dtype=torch.float64))
    assert torch.isfinite(sol.y_final).all()
    assert (sol.status == vt.DONE).all()
    assert int(sol.n_iters[0]) < int(sol.n_iters[1])

"""The port's front door (``vec_ode_tpu_torch.api``) against the JAX
package's, in f64 on the same inputs: ``solve_ivp`` with events (the cases
of ``tests/test_events.py``), backward integration (tf < t0) with saves
and mirrored event directions (``tests/test_driver.py::
test_backward_with_array_endpoints``), ``solve_linear`` over
``ExpMidpoint``, ``Magnus4``, ``CFM4``, ``SplitMidpoint`` and
``SplitCFM`` on dense, diagonal and anti-Hermitian leaves and over each
of the composite splits of ``exp.splits``; and BASELINE config 1 (an
8-dim linear ODE, adaptive and fixed RKF45) against the native C++
oracle: counters, the event sequence and the final state. The gate is
``test_torch_rk.assert_same_solution``'s."""

import functools
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vec_ode_tpu as vo
from vec_ode_tpu import exp as vexp
from vec_ode_tpu import models as jm
from vec_ode_tpu.events import Event as JEvent
from vec_ode_tpu.events import EventConfig as JEventConfig
from vec_ode_tpu.utils import oracle
import vec_ode_tpu_torch as vt
from vec_ode_tpu_torch import api
from vec_ode_tpu_torch import exp as texp
from vec_ode_tpu_torch import models as tm
from vec_ode_tpu_torch.events import Event, EventConfig
from vec_ode_tpu_torch.ops import cplx as tcp

from test_torch_rk import H_FINAL_PAIRS, H_FINAL_TIGHT, assert_same_solution

torch.set_num_threads(1)

# tests/test_events.py's controller; h_final is held to H_FINAL_TIGHT
TIGHT = dict(rtol=1e-10)
# a tight bracket keeps the located times off the rounding floor (ROADMAP
# queue 3: event searches at the rounding floor)
T_TOL = 1e-9


def _lib(side):
    if side == "jax":
        return dict(np=jnp, arr=lambda a: jnp.asarray(np.asarray(a)),
                    Event=JEvent, EventConfig=JEventConfig, solve=vo,
                    ctl=vo.StepControl, stack=jnp.stack)
    return dict(np=torch, arr=lambda a: torch.as_tensor(np.asarray(a)),
                Event=Event, EventConfig=EventConfig, solve=vt,
                ctl=vt.StepControl, stack=torch.stack)


def _events(L, spec):
    evs = tuple(L["Event"](fn, direction=d, terminal=term)
                for fn, d, term in spec)
    return L["EventConfig"](events=evs, t_tol=T_TOL)


def _decay(t, y):
    return -y


def _osc(L):
    return lambda t, y: L["stack"]([y[1], -y[0]])


def _y_minus(c):
    return lambda t, y: y - c


def _pos(t, y):
    return y[0]


EVENT_CASES = {
    "terminal": dict(y0=1.0, t=(0.0, 5.0), ev=[(_y_minus(0.5), 0, True)]),
    "nonterminal": dict(y0=1.0, t=(0.0, 2.0), ev=[(_y_minus(0.5), 0, False)]),
    "never_found": dict(y0=1.0, t=(0.0, 1.0), ev=[(_y_minus(-1.0), 0, False)]),
    "fixed_terminal": dict(y0=1.0, t=(0.0, 5.0), adaptive=False, h0=0.05,
                           ev=[(_y_minus(0.5), 0, True)]),
    "fixed_nonterminal": dict(y0=1.0, t=(0.0, 2.0), adaptive=False, h0=0.05,
                              ev=[(_y_minus(0.5), 0, False)]),
    "with_saves": dict(y0=1.0, t=(0.0, 2.0), save_at=[0.5, 1.0, 1.5],
                       ev=[(_y_minus(0.5), 0, False)]),
    "oscillator_directions": dict(y0=[1.0, 0.0], t=(0.0, 7.0), rhs="osc",
                                  ev=[(_pos, -1, False), (_pos, 1, False)]),
    "backward": dict(y0=1.0, t=(0.0, -2.0), ev=[(_y_minus(2.0), 0, False)]),
    "backward_falling": dict(y0=1.0, t=(0.0, -2.0),
                             ev=[(_y_minus(2.0), -1, False)]),
    "backward_rising": dict(y0=1.0, t=(0.0, -2.0),
                            ev=[(_y_minus(2.0), 1, False)]),
    "backward_saves_terminal": dict(y0=1.0, t=(0.0, -3.0),
                                    save_at=[-2.5, -1.0, -0.5],
                                    ev=[(_y_minus(4.0), 0, True)]),
}


def _event_solve(side, name, ctl=TIGHT):
    L = _lib(side)
    c = EVENT_CASES[name]
    f = _osc(L) if c.get("rhs") == "osc" else _decay
    kw = dict(ctl=L["ctl"](**ctl)) if c.get("adaptive", True) else dict(
        adaptive=False, h0=c["h0"])
    return L["solve"].solve_ivp(f, *c["t"], L["arr"](c["y0"]),
                                save_at=c.get("save_at"),
                                events=_events(L, c["ev"]), **kw)


@functools.cache
def _jax_event_solution(name):
    return _event_solve("jax", name)


@pytest.mark.parametrize("name", sorted(EVENT_CASES))
def test_solve_ivp_events_match_jax(name):
    got = _event_solve("torch", name)
    assert_same_solution(got, _jax_event_solution(name), events=True,
                         h_rtol=H_FINAL_TIGHT)


def test_events_land_where_the_closed_form_says():
    ln2 = float(np.log(2.0))
    sol = _event_solve("torch", "terminal")
    assert int(sol.status) == vt.DONE_EVENT
    np.testing.assert_allclose(sol.event_t[0].item(), ln2, atol=1e-9)
    back = _event_solve("torch", "backward_falling")
    np.testing.assert_allclose(back.event_t[0].item(), -ln2, atol=1e-9)
    assert not bool(_event_solve("torch", "backward_rising").event_found[0])
    osc = _event_solve("torch", "oscillator_directions")
    np.testing.assert_allclose(osc.event_t.numpy(),
                               [np.pi / 2, 3 * np.pi / 2], atol=1e-7)


@pytest.mark.parametrize("endpoints", ["python", "tensor"])
def test_backward_with_array_endpoints_matches_jax(endpoints):
    y0 = float(np.exp(-2.0))
    ctl_kw = dict(rtol=1e-9, min_dt=1e-8)
    want = vo.solve_ivp(lambda t, y: -y, jnp.asarray(2.0), jnp.asarray(0.0),
                        jnp.asarray(y0, jnp.float64),
                        ctl=vo.StepControl(**ctl_kw), save_at=[0.5, 1.5])
    t0, tf = (2.0, 0.0) if endpoints == "python" else (
        torch.tensor(2.0, dtype=torch.float64),
        torch.tensor(0.0, dtype=torch.float64))
    got = vt.solve_ivp(lambda t, y: -y, t0, tf,
                       torch.tensor(y0, dtype=torch.float64),
                       ctl=vt.StepControl(**ctl_kw), save_at=[0.5, 1.5])
    assert_same_solution(got, want, h_rtol=H_FINAL_TIGHT)
    np.testing.assert_allclose(got.ts.numpy(), [0.0, 0.5, 1.5, 2.0])
    np.testing.assert_allclose(got.y_final.item(), 1.0, rtol=1e-5)


# -- solve_linear over the leaves, the split solvers and the splits ----------

D = 4


@functools.cache
def _mats():
    rng = np.random.default_rng(21)
    A0 = np.asarray(jm.stable_dense_matrix(D, seed=2, dtype=None))
    A1 = rng.standard_normal((D, D)) * 0.3
    rates = -rng.uniform(0.2, 1.5, D)
    e = rng.uniform(-1, 1, D)
    return A0, A1, rates, e


def _dd():
    return jm.DrivenDense.make(d=D, seed=0)


@functools.cache
def _tdd():
    return tm.DrivenDense.make(d=D, seed=0)


def _ops(side, leaf):
    """op_fn(t) of each leaf kind, and the split, on each side."""
    A0, A1, rates, e = _mats()
    if side == "jax":
        from vec_ode_tpu.ops.cplx import Cplx
        cos, sin, ex = jnp.cos, jnp.sin, vexp

        def arr(a):
            return jnp.asarray(a)
    else:
        Cplx = tcp.Cplx
        cos, sin, ex = torch.cos, torch.sin, texp

        def arr(a):
            return torch.as_tensor(a)
    if leaf == "dense_real":
        return (lambda t: arr(A0) + cos(t) * arr(A1)), ex.DenseSplit()
    if leaf == "diag_real":
        return (lambda t: arr(rates) * (1.0 + 0.5 * sin(t))), \
            ex.DiagonalSplit()
    if leaf == "diag_cplx":
        return (lambda t: Cplx(-0.1 * arr(np.abs(e)) + 0.0 * t,
                               -cos(t) * arr(e))), ex.DiagonalCplxSplit()
    if leaf in ("dense_cplx", "antiherm_cplx"):
        op = ((lambda t: _dd().op_pair(t, jnp.float64)) if side == "jax"
              else (lambda t: _tdd().op_pair(t, torch.float64,
                                             device="cpu")))
        return op, (ex.DenseCplxSplit() if leaf == "dense_cplx"
                    else ex.AntiHermitianCplxSplit())
    if leaf == "antiherm":
        op = ((lambda t: _dd().op(t)) if side == "jax"
              else (lambda t: _tdd().op(t, device="cpu")))
        return op, ex.AntiHermitianSplit()
    raise KeyError(leaf)


def _y0(side, leaf):
    rng = np.random.default_rng(8)
    if leaf.endswith("_real"):
        y = rng.standard_normal(D)
        return jnp.asarray(y) if side == "jax" else torch.as_tensor(y)
    z = rng.standard_normal(D) + 1j * rng.standard_normal(D)
    z /= np.linalg.norm(z)
    if leaf == "antiherm":
        return jnp.asarray(z) if side == "jax" else torch.as_tensor(z)
    if side == "jax":
        from vec_ode_tpu.ops import cplx as jcp
        return jcp.from_complex(z, jnp.float64)
    return tcp.from_complex(z, torch.float64, device="cpu")


def _chain_ops(side):
    if side == "jax":
        ch = jm.TightBindingChain(n=8, J=1.0, seed=3, w=2.0)
        return lambda t: ch.ops_pair(t, jnp.float64)
    ch = tm.TightBindingChain(n=8, J=1.0, seed=3, w=2.0)
    return lambda t: ch.ops_pair(t, torch.float64, device="cpu")


def _chain_y0(side):
    z = np.zeros(8, complex)
    z[0] = 1.0
    if side == "jax":
        from vec_ode_tpu.ops import cplx as jcp
        return jcp.from_complex(z, jnp.float64)
    return tcp.from_complex(z, torch.float64, device="cpu")


SPLIT_CFM = dict(rho=((0.5, 0.5),), sigma=((0.5, 0.0), (0.0, 0.5)),
                 c=(0.2113248654051871, 0.7886751345948129))
FIXED = dict(adaptive=False, h0=0.05)
# tests/test_exp_solvers.py's adaptive controller; h_final is held to
# H_FINAL_PAIRS
ADAPT = dict(adaptive=True, h0=0.02, ctl=dict(rtol=1e-9, min_dt=1e-6,
                                              max_dt=0.25))
SPLITS = ["CommutativeSplit", "StrangSplit", "SemiComplexO4Split",
          "TripleJumpSplit", "RKNR4Split"]

LINEAR_CASES = {
    **{f"magnus4-{leaf}": ("Magnus4", leaf, ADAPT)
       for leaf in ("dense_real", "diag_real", "diag_cplx", "dense_cplx",
                    "antiherm_cplx", "antiherm")},
    **{f"expmid-{leaf}": ("ExpMidpoint", leaf, FIXED)
       for leaf in ("dense_cplx", "diag_real", "antiherm")},
    **{f"cfm4-{leaf}": ("CFM4", leaf, ADAPT)
       for leaf in ("dense_real", "diag_cplx", "antiherm_cplx")},
    **{f"{s.lower()}-{a}": (s, ("chain", a), FIXED)
       for s in ("SplitMidpoint", "SplitCFM")
       for a in ("DenseCplxSplit", "AntiHermitianCplxSplit")},
    **{f"expmid-{sp}": ("ExpMidpoint", ("split", sp), FIXED)
       for sp in SPLITS},
    **{f"magnus4-{sp}": ("Magnus4", ("split", sp), ADAPT)
       for sp in ("StrangSplit", "TripleJumpSplit")},
}


def _linear_solve(side, name, backward=False):
    stepper_name, leaf, kw = LINEAR_CASES[name]
    ex = vexp if side == "jax" else texp
    kw = dict(kw)
    if "ctl" in kw:
        kw["ctl"] = (vo if side == "jax" else vt).StepControl(**kw["ctl"])
    if isinstance(leaf, tuple):
        op, y0 = _chain_ops(side), _chain_y0(side)
        sp_a = getattr(ex, leaf[1])() if leaf[0] == "chain" \
            else ex.DenseCplxSplit()
        sp_b = ex.DiagonalCplxSplit()
        if leaf[0] == "split":
            split = getattr(ex, leaf[1])(sp_a, sp_b)
        else:
            split = None
    else:
        op, split = _ops(side, leaf)
        y0 = _y0(side, leaf)
    if stepper_name == "SplitMidpoint":
        stepper = ex.SplitMidpoint(sp_a, sp_b)
    elif stepper_name == "SplitCFM":
        stepper = ex.SplitCFM(sp_a, sp_b, **SPLIT_CFM)
    elif stepper_name == "ExpMidpoint":
        stepper = ex.ExpMidpoint(split)
    else:
        stepper = getattr(ex, stepper_name)(split)
    t0, tf = (1.0, 0.0) if backward else (0.0, 1.0)
    return (vo if side == "jax" else vt).solve_linear(
        op, t0, tf, y0, stepper=stepper, save_at=[0.5], **kw)


@functools.cache
def _jax_linear(name, backward=False):
    return _linear_solve("jax", name, backward)


@pytest.mark.parametrize("name", sorted(LINEAR_CASES))
def test_solve_linear_matches_jax(name):
    assert_same_solution(_linear_solve("torch", name), _jax_linear(name),
                         h_rtol=H_FINAL_PAIRS)


@pytest.mark.parametrize("name", ["magnus4-dense_cplx", "expmid-StrangSplit",
                                  "splitmidpoint-DenseCplxSplit"])
def test_backward_solve_linear_matches_jax(name):
    assert_same_solution(_linear_solve("torch", name, backward=True),
                         _jax_linear(name, backward=True),
                         h_rtol=H_FINAL_PAIRS)


def test_splits_keep_the_chain_unitary():
    for name in ("expmid-StrangSplit", "expmid-RKNR4Split",
                 "splitmidpoint-AntiHermitianCplxSplit"):
        y = _linear_solve("torch", name).y_final
        n2 = float((y.re ** 2 + y.im ** 2).sum())
        assert abs(n2 - 1.0) < 1e-12, (name, n2)


# -- BASELINE config 1 against the native oracle ------------------------------

@pytest.fixture(scope="module")
def lib():
    return oracle.load()


@pytest.mark.parametrize("adaptive", [True, False])
def test_baseline_config_1_matches_native_oracle(lib, adaptive):
    """Adaptive (and fixed-step) RKF45 on an 8-dim linear ODE y' = A y in
    f64 through solve_ivp and step by step: the oracle's counters, its
    event sequence (accept / reject / save-grid hit / end) and state."""
    A = np.array(jm.stable_dense_matrix(8, seed=3), np.float64)
    y0 = np.linspace(0.3, 1.0, 8)
    kw = dict(rtol=1e-6, min_dt=1e-6, max_dt=0.5)
    ctl = vt.StepControl(time_compensated=False, **kw)
    want = oracle.solve_linear_rkf45(A, y0, 0.0, 2.0, 1e-3, adaptive=adaptive,
                                     **kw)
    model = tm.LinearConstant(torch.as_tensor(A))
    sol = vt.solve_ivp(model.rhs, 0.0, 2.0, torch.as_tensor(y0), ctl=ctl,
                       h0=1e-3, adaptive=adaptive)
    assert int(sol.status) == want["status"] == vt.DONE
    assert int(sol.n_accept) == want["n_accept"]
    assert int(sol.n_reject) == want["n_reject"]
    assert int(sol.n_iters) == len(want["events"])
    assert int(sol.n_rhs_evals) == 6 * (want["n_accept"] + want["n_reject"])
    np.testing.assert_allclose(sol.y_final.numpy(), want["y_final"],
                               rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(sol.t_final.item(), want["t_final"],
                               rtol=1e-15)
    np.testing.assert_allclose(sol.h_final.item(), want["h_final"],
                               rtol=1e-12)

    step = vt.RungeKutta().make_step_fn(model.rhs)
    state = vt.init_state(torch.as_tensor(y0),
                          vt.make_grid(0.0, 2.0, device="cpu"), 1e-3)
    events = []
    while int(state.status) == vt.RUNNING:
        state = vt.step_once(state, step, adaptive=adaptive, ctl=ctl)
        events.append(int(state.last_event))
    np.testing.assert_array_equal(np.asarray(events, np.int8),
                                  want["events"])


def test_solve_ivp_runs_where_y0_lies():
    sol = vt.solve_ivp(lambda t, y: -y, 0.0, 1.0,
                       torch.tensor([1.0, 2.0], dtype=torch.float32),
                       time_dtype=torch.float32, h0=1e-2)
    assert sol.ts.dtype == torch.float32 and sol.y_final.device.type == "cpu"
    assert sol.path == "torch-driver"
    want = vo.solve_ivp(lambda t, y: -y, 0.0, 1.0,
                        jnp.asarray([1.0, 2.0], jnp.float32),
                        time_dtype=jnp.float32, h0=1e-2)
    assert int(sol.n_accept) == int(want.n_accept)
    np.testing.assert_allclose(sol.y_final.numpy(), np.asarray(want.y_final),
                               rtol=1e-6)


def test_leaves_that_are_not_tensors_go_on_the_card_unless_asked():
    """A python or numpy y0 is solved on the card unless ``device="cpu"``
    is given; a leaf beside tensor leaves joins their device."""
    for fn in (vt.solve_ivp, vt.solve_linear):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    assert api._as_state(1.0, "meta").device.type == "meta"
    mixed = api._as_state({"a": torch.ones(2), "b": np.ones(2)}, "meta")
    assert mixed["b"].device.type == "cpu"
    assert mixed["b"].dtype == torch.float64
    want = vo.solve_ivp(lambda t, y: -y, 0.0, 2.0, 1.0,
                        ctl=vo.StepControl(rtol=1e-8))
    got = vt.solve_ivp(lambda t, y: -y, 0.0, 2.0, 1.0, device="cpu",
                       ctl=vt.StepControl(rtol=1e-8))
    assert got.y_final.dtype == torch.float64
    assert_same_solution(got, want, h_rtol=H_FINAL_TIGHT)
    op, split = _ops("torch", "antiherm")
    z = _y0("torch", "antiherm")
    kw = dict(stepper=texp.ExpMidpoint(split), h0=0.05)
    got = vt.solve_linear(op, 0.0, 1.0, z.numpy(), device="cpu", **kw)
    assert torch.equal(got.y_final, vt.solve_linear(op, 0.0, 1.0, z,
                                                    **kw).y_final)

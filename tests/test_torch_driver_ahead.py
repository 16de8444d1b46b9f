"""The host driver's condition read one iteration late
(``driver._run_while`` once ``_pays_ahead`` finds the device the slower
side, which on the card it may), driven here on CPU carries by a policy
that says it pays: every
``Solution`` field bitwise the plain loop's, on an RK stepper with its
FSAL carry and a save grid, Magnus-4 on a callable drive (the host
driver's K4 route, through K4's twin), a terminal event, ``max_steps``
exhausted, a stalled reject streak, t0 = tf, a carry that is already
finished and both time accumulations; the stepper called once more than
the plain loop calls it (where any iteration ran), from whichever read
the loop turns to running ahead, and the condition read as often; the
policy itself, and ranks of a process group kept to the plain reads;
``step_once``
writing nothing into its input carry; an error raised in the dropped
iteration swallowed, one raised in a needed iteration surfacing; and a
modulated stepper's declared weight row made on the device once, not at
every step."""

import dataclasses
import functools

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils import _pytree as pytree

import vec_ode_tpu_torch as vt
from vec_ode_tpu_torch import driver, telemetry
from vec_ode_tpu_torch import events as tev
from vec_ode_tpu_torch.exp import MagnusModulated4
from vec_ode_tpu_torch.exp.modulated import ModulatedOperator
from vec_ode_tpu_torch.models import DrivenDense
from vec_ode_tpu_torch.ops.cplx import Cplx
from vec_ode_tpu_torch.ops.fused_rk import FusedModulatedLinearRK
from vec_ode_tpu_torch.parallel import ensemble_solve

torch.set_num_threads(1)

F64 = torch.float64
D, B = 4, 8
MAG = dict(rtol=1e-5, min_dt=1e-5, max_dt=0.2, max_steps=2000)
P0 = tuple(np.eye(D)[0])              # g = |z_0|^2


def _stiffish(t, y):
    # nonlinear with varying scales: accepts and rejects
    return torch.stack([y[1], -25.0 * y[0] - 2.0 * y[1] + torch.sin(3.0 * t)])


@functools.cache
def _model():
    return DrivenDense.make(d=D, seed=0)


def _y0():
    gen = torch.Generator().manual_seed(3)
    return Cplx(torch.randn(B, D, generator=gen, dtype=F64),
                torch.randn(B, D, generator=gen, dtype=F64))


def _callable_magnus():
    op = _model().modulated(F64, device="cpu")
    w = float(_model().w)
    return MagnusModulated4(ModulatedOperator(
        basis=op.basis, coeff_fn=lambda t: torch.stack(
            [torch.ones_like(t), torch.cos(w * t)], dim=-1)))


def _magnus(t0=0.0, tf=1.0, h0=1e-3, **ctl):
    return lambda: ensemble_solve(
        None, _y0(), t0, tf, stepper=_callable_magnus(), h0=h0,
        ctl=vt.StepControl(**{**MAG, **ctl}), time_dtype=F64)


def _rk_fsal():
    return vt.solve_ivp(
        _stiffish, 0.0, 3.0, torch.tensor([1.0, 0.0], dtype=F64),
        stepper=vt.RungeKutta(vt.DOPRI5, advance_lower=False),
        save_at=(0.5, 1.0, 2.0),
        ctl=vt.StepControl(rtol=1e-7, min_dt=1e-7, max_dt=0.5,
                           max_steps=5000))


def _terminal_event():
    st = FusedModulatedLinearRK.from_driven_dense(_model(), F64,
                                                  device="cpu")
    cfg = tev.EventConfig(events=(
        tev.Event(tev.QuadraticObservable(q=P0, c=0.2), terminal=True),),
        t_tol=1e-7)
    return ensemble_solve(
        None, _y0(), 0.0, 3.0, stepper=st, h0=1e-3, events=cfg,
        ctl=vt.StepControl(rtol=1e-8, min_dt=1e-6, max_dt=0.25,
                           max_steps=3000), time_dtype=F64)


def _finished():
    """``resume`` from a carry whose every trajectory is DONE: the plain
    loop runs no iteration."""
    st = _callable_magnus()
    x0 = _y0()
    grid = driver.make_grid(0.0, 1.0, dtype=F64, device="cpu")
    state = driver.init_state(x0, grid, 1e-3, (B,))
    state = state._replace(status=torch.full_like(state.status, vt.DONE))
    return driver.resume(state, st.make_step_fn(), ctl=vt.StepControl(**MAG),
                         error_norm=st.error_norm, batched=True)


# name -> (solve, the status every or some trajectory ends in)
CASES = {
    "rk_fsal_saves": (_rk_fsal, vt.DONE),
    "magnus4_callable": (_magnus(), vt.DONE),
    "terminal_event": (_terminal_event, vt.DONE_EVENT),
    "max_steps": (_magnus(max_steps=6), vt.ERR_MAX_STEPS),
    # far too long a first step at rtol 1e-14: rejects in a row
    "stalled": (_magnus(rtol=1e-14, max_reject_streak=2, h0=0.2),
                vt.ERR_STALLED),
    "t0_is_tf": (_magnus(t0=0.5, tf=0.5), vt.DONE),
    "finished_carry": (_finished, vt.DONE),
    "compensated_time": (_magnus(time_compensated=True), vt.DONE),
    "plain_time": (_magnus(time_compensated=False), vt.DONE),
}


def _counted(monkeypatch, fail_at=None):
    """``driver.step_once`` wrapped to keep the carry of each call (and
    raise at call ``fail_at``); the list it appends them to."""
    calls = []
    step_once = driver.step_once

    def counting(state, *args, **kwargs):
        calls.append(None)
        if len(calls) - 1 == fail_at:
            raise RuntimeError("planted")
        calls[-1] = step_once(state, *args, **kwargs)
        return calls[-1]

    monkeypatch.setattr(driver, "step_once", counting)
    return calls


def _ahead(monkeypatch, after=0):
    """The loop run ahead on CPU carries: from its ``after``-th decision
    (one a read before it runs ahead) on, the policy says it pays."""
    decisions = []

    def pays(device, waited, enqueued):
        decisions.append(None)
        return len(decisions) > after

    monkeypatch.setattr(driver, "_pays_ahead", pays)


def _assert_bitwise(got, want):
    for f in dataclasses.fields(driver.Solution):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if f.name == "path" or a is None or b is None:
            assert a == b, f.name
            continue
        la, sa = pytree.tree_flatten(a)
        lb, sb = pytree.tree_flatten(b)
        assert sa == sb, f.name
        for x, y in zip(la, lb):
            assert x.dtype == y.dtype and torch.equal(x, y), f.name


def _reads(solve):
    telemetry.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        sol = solve()
    spans = telemetry.spans()
    return sol, spans


@pytest.mark.parametrize("name", sorted(CASES))
def test_lagged_loop_gives_the_plain_loops_solution(name, monkeypatch):
    solve, status = CASES[name]
    with monkeypatch.context() as m:
        plain_calls = _counted(m)
        plain, plain_spans = _reads(solve)
    assert bool((plain.status == status).any()), plain.status
    with monkeypatch.context() as m:
        _ahead(m)
        calls = _counted(m)
        sol, spans = _reads(solve)
    _assert_bitwise(sol, plain)
    steps = int(plain.n_iters.max())
    assert len(plain_calls) == steps
    # the first read admits the first iteration: with none, none is dropped
    assert len(calls) == len(plain_calls) + (steps > 0)
    assert driver.last_dropped == (steps > 0)
    # the carry returned is the last the plain loop makes, not the dropped
    # iteration's
    assert all(sol.t_final is not c.t for c in calls[-1:])
    if steps:
        assert plain.t_final is plain_calls[-1].t
        assert sol.t_final is calls[-2].t

    def count(spans, name):
        return sum(s.name == name for s in spans)

    reads = "vec_ode.sync.driver_cond"
    assert count(spans, reads) == count(plain_spans, reads) == \
        len(plain_calls) + 1
    # every iteration, the dropped one too, is a step span
    assert count(spans, "vec_ode.driver.step") == len(calls)
    assert count(plain_spans, "vec_ode.driver.step") == len(plain_calls)


@pytest.mark.parametrize("name", sorted(CASES))
def test_step_once_leaves_its_input_carry_unchanged(name, monkeypatch):
    """The lagged loop keeps carry k alive while it builds carry k + 1
    from it: no iteration may write into the carry it is given."""
    step_once = driver.step_once
    checked = []

    def guarded(state, *args, **kwargs):
        leaves = [a for a in pytree.tree_leaves(state)
                  if isinstance(a, torch.Tensor)]
        before = [a.clone() for a in leaves]
        out = step_once(state, *args, **kwargs)
        for a, b in zip(leaves, before):
            assert torch.equal(a, b)
        checked.append(len(leaves))
        return out

    _ahead(monkeypatch)
    monkeypatch.setattr(driver, "step_once", guarded)
    sol = CASES[name][0]()
    # a carry that needs no iteration gives none to check
    assert len(checked) == int(sol.n_iters.max()) + driver.last_dropped
    assert all(n > 0 for n in checked)


@pytest.mark.parametrize("where", ("dropped", "needed"))
def test_an_error_surfaces_only_from_a_needed_iteration(where, monkeypatch):
    """An error raised while enqueuing the dropped iteration (which the
    plain loop never runs) is swallowed and the plain loop's solution
    returned; one raised in an iteration the plain loop runs surfaces."""
    solve = CASES["magnus4_callable"][0]
    plain = solve()
    steps = int(plain.n_iters.max())
    fail_at = steps if where == "dropped" else steps - 2
    with monkeypatch.context() as m:
        _ahead(m)
        calls = _counted(m, fail_at=fail_at)
        if where == "dropped":
            _assert_bitwise(solve(), plain)
            assert len(calls) == steps + 1
        else:
            with pytest.raises(RuntimeError, match="planted"):
                solve()
            assert len(calls) == steps - 1
    with monkeypatch.context() as m:
        _counted(m, fail_at=fail_at)
        if where == "dropped":
            _assert_bitwise(solve(), plain)
        else:
            with pytest.raises(RuntimeError, match="planted"):
                solve()


@pytest.mark.parametrize("after", (1, 5))
def test_the_loop_runs_ahead_from_any_read(after, monkeypatch):
    """The loop turns to running ahead at whichever read its policy first
    says so, and stays there: the plain loop's solution, one dropped
    iteration."""
    solve = CASES["rk_fsal_saves"][0]
    with monkeypatch.context() as m:
        plain_calls = _counted(m)
        plain = solve()
    with monkeypatch.context() as m:
        _ahead(m, after=after)
        calls = _counted(m)
        sol = solve()
    _assert_bitwise(sol, plain)
    assert len(calls) == len(plain_calls) + 1 and driver.last_dropped == 1
    assert sol.t_final is calls[-2].t


def test_the_policy_runs_ahead_only_behind_a_slower_device():
    """Ahead only on a CUDA device, where the read waited at least
    ``AHEAD_WAIT_SHARE`` of the iteration's enqueuing; never on the CPU,
    and never before an iteration was timed."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    share = driver.AHEAD_WAIT_SHARE
    assert driver._pays_ahead(cuda, share * 2e-3, 2e-3)
    assert driver._pays_ahead(cuda, 4e-3, 1e-3)
    assert not driver._pays_ahead(cuda, 0.9 * share * 2e-3, 2e-3)
    assert not driver._pays_ahead(cuda, 1.0, float("inf"))
    assert not driver._pays_ahead(cpu, 4e-3, 1e-3)
    # no process group here: nothing holds the loop in step with others
    assert not driver._lockstep()


def test_ranks_of_a_process_group_never_run_ahead(monkeypatch):
    """A body may hold collectives, which pair only where every rank runs
    as many iterations: the loop keeps its reads first, whatever the
    policy says."""
    _ahead(monkeypatch)
    monkeypatch.setattr(driver, "_lockstep", lambda: True)
    calls = _counted(monkeypatch)
    sol = CASES["magnus4_callable"][0]()
    assert len(calls) == int(sol.n_iters.max()) and driver.last_dropped == 0


def test_cpu_carries_take_the_plain_loop(monkeypatch):
    """Only a CUDA carry runs ahead: on the CPU the stepper is called
    once an iteration, a step span each."""
    calls = _counted(monkeypatch)
    sol, spans = _reads(CASES["magnus4_callable"][0])
    assert len(calls) == int(sol.n_iters.max()) and driver.last_dropped == 0
    assert sum(s.name == "vec_ode.driver.step" for s in spans) == len(calls)


def test_a_declared_weight_row_is_copied_once(monkeypatch):
    """The modulated steppers keep a declared norm's weight row on the
    state's device, in its type, beside their other operands, made once
    a device and type: every step hands the step kernel's wrapper the
    same tensor (a copy from host memory at every step would hold the
    host until the card drains its queue), with the values of a fresh
    copy."""
    from vec_ode_tpu_torch import lc
    from vec_ode_tpu_torch.exp import modulated

    seen = []
    apply = modulated.fused_chain_apply

    def recording(*args, wnorm=None, **kwargs):
        seen.append(wnorm)
        return apply(*args, wnorm=wnorm, **kwargs)

    monkeypatch.setattr(modulated, "fused_chain_apply", recording)
    wn = lc.WeightedNorm("max", tuple(np.linspace(0.5, 2.0, D)))
    st = dataclasses.replace(_callable_magnus(), norm=wn)
    sol = ensemble_solve(None, _y0(), 0.0, 1.0, stepper=st, h0=1e-3,
                         ctl=vt.StepControl(**MAG), time_dtype=F64)
    assert bool((sol.status == vt.DONE).all())
    assert len(seen) == int(sol.n_iters.max())
    assert len({id(w[0]) for w in seen}) == 1
    row, post, kind = seen[0]
    w_row, w_post, w_kind = wn.kernel_parts(D, 2)
    assert torch.equal(row, torch.as_tensor(w_row, dtype=F64).reshape(-1))
    assert (post, kind) == (float(w_post), w_kind)

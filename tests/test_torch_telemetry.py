"""The port's spans (``vec_ode_tpu_torch.telemetry``) on the CPU: nothing
recorded and no profiler annotation with the profiler off; with it on,
the phases of an ``ensemble_solve`` on the loop route, the host driver
and the driver with a save grid, each read of the device counted once,
the top-level spans disjoint and on the profiler's own clock; and the
arithmetic of the benchmark's readers of them (``odebench/metrics``) on
planted spans and device intervals."""

import collections
import contextlib
import sys
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from odebench import manifest
from odebench.run import Run
from vec_ode_tpu_torch import StepControl, telemetry
from vec_ode_tpu_torch.exp import MagnusModulated4
from vec_ode_tpu_torch.exp.modulated import ModulatedOperator
from vec_ode_tpu_torch.models import DrivenDense
from vec_ode_tpu_torch.ops.cplx import Cplx
from vec_ode_tpu_torch.ops.fused_rk import FusedModulatedLinearRK
from vec_ode_tpu_torch.parallel import ensemble_solve

D, B = 4, 8
SAVES = [0.1 * i for i in range(1, 10)]
ROUTES = ("loop", "driver", "driver_saves")


def _problem(route):
    """A small solve of the benchmark's driven system on ``route``, as a
    call: the loop twin (declared drive), the host driver (a callable
    drive) or the host driver with nine saves (the RK stepper, which the
    CPU runs on the host driver)."""
    model = DrivenDense.make(d=D, seed=0)
    gen = torch.Generator().manual_seed(1)
    y0 = Cplx(torch.randn(B, D, generator=gen),
              torch.randn(B, D, generator=gen))
    op = model.modulated(torch.float32, device="cpu")
    save_at = None
    if route == "loop":
        stepper = MagnusModulated4(op)
    elif route == "driver":
        w = float(model.w)
        stepper = MagnusModulated4(ModulatedOperator(
            basis=op.basis, coeff_fn=lambda t: torch.stack(
                [torch.ones_like(t), torch.cos(w * t)], dim=-1)))
    else:
        stepper = FusedModulatedLinearRK.from_driven_dense(
            model, torch.float32, device="cpu")
        save_at = SAVES
    ctl = StepControl(rtol=1e-5, atol=1e-6, min_dt=1e-5, max_dt=0.2)
    return lambda: ensemble_solve(
        None, y0, 0.0, 1.0, stepper=stepper, h0=1e-3, save_at=save_at,
        ctl=ctl, time_dtype=torch.float32)


def _traced(route, n=1):
    solve = _problem(route)
    telemetry.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sols = [solve() for _ in range(n)]
    return sols, telemetry.spans(), prof


def _raise(*args, **kwargs):
    raise AssertionError("entered with the profiler off")


@pytest.mark.parametrize("route", ROUTES)
def test_profiler_off_records_nothing(route, monkeypatch):
    telemetry.clear()
    monkeypatch.setattr(telemetry, "_annotate", _raise)
    monkeypatch.setattr(telemetry, "_clock", _raise)
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    sol = _problem(route)()
    assert bool((sol.status == 1).all())
    assert telemetry.spans() == [] and telemetry.dropped() == 0


@pytest.mark.parametrize("route", ROUTES)
def test_phases_and_reads_of_one_call(route):
    (sol,), spans, _ = _traced(route)
    names = collections.Counter(s.name for s in spans)
    steps = int(sol.n_iters.max())
    assert names["vec_ode.entry"] == 1 and names["vec_ode.solution"] == 1
    # the save grid's checks read it back only where there are saves
    assert names["vec_ode.sync.grid"] == (5 if route == "driver_saves"
                                          else 0)
    if route == "loop":
        assert sol.path == "torch-loop"
        assert names["vec_ode.loop.launch"] == 1
        assert names["vec_ode.driver.step"] == 0
        assert names["vec_ode.sync.driver_cond"] == 0
    else:
        assert names["vec_ode.driver.init"] == 1
        assert names["vec_ode.driver.step"] == steps
        assert names["vec_ode.sync.driver_cond"] == steps + 1
        its = [s.iteration for s in spans if s.name == "vec_ode.driver.step"]
        assert its == list(range(steps))
    # the grid's reads lie in the entry; the driver's condition is a phase
    for s in spans:
        parent = spans[s.parent].name if s.parent >= 0 else None
        want = "vec_ode.entry" if s.name == "vec_ode.sync.grid" else None
        assert parent == want, s


@pytest.mark.parametrize("route", ROUTES)
def test_top_level_spans_partition_each_call(route):
    sols, spans, _ = _traced(route, n=2)
    assert all(s.end_ns >= s.start_ns for s in spans)
    assert sorted({s.call for s in spans}) == [spans[0].call,
                                               spans[0].call + 1]
    for call in {s.call for s in spans}:
        top = [s for s in spans if s.call == call and s.parent < 0]
        assert top[0].name == "vec_ode.entry"
        assert top[-1].name == "vec_ode.solution"
        for a, b in zip(top, top[1:]):
            assert a.end_ns <= b.start_ns, (a, b)
    for s in spans:
        if s.parent >= 0:
            p = spans[s.parent]
            assert p.call == s.call
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns


@pytest.mark.parametrize("route", ("loop", "driver_saves"))
def test_spans_bracket_the_profilers_events(route):
    """Every annotation the profiler recorded lies inside a span of the
    same name on ``time.time_ns``'s clock, and every span holds one."""
    _, spans, prof = _traced(route)
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("vec_ode.")]
    assert len(events) >= len(spans)
    held = collections.Counter()
    for e in events:
        inside = [i for i, s in enumerate(spans) if s.name == e.name()
                  and s.start_ns <= e.start_ns() <= e.end_ns() <= s.end_ns]
        assert len(inside) == 1, e.name()
        held[inside[0]] += 1
    assert set(held) == set(range(len(spans)))


def test_every_read_is_a_sync_span():
    """On the host driver with saves (the CPU twin step reads nothing),
    each ``item`` of the call lies in a ``vec_ode.sync`` span."""
    _, spans, prof = _traced("driver_saves")
    syncs = [s for s in spans if s.name.startswith(telemetry.SYNC)]
    items = [e for e in prof.profiler.kineto_results.events()
             if e.name() == "aten::_local_scalar_dense"]
    assert len(items) == len(syncs)
    for e in items:
        assert any(s.start_ns <= e.start_ns() and e.end_ns() <= s.end_ns
                   for s in syncs)


def test_adjacent_spans_of_one_phase_merge_and_reads_do_not():
    telemetry.clear()
    x = torch.ones(())
    with profile(activities=[ProfilerActivity.CPU]):
        with telemetry.call():
            with telemetry.span("vec_ode.loop.launch"):
                pass
            with telemetry.span("vec_ode.loop.launch"):
                telemetry.read("grid", x)
                telemetry.read("grid", x)
            telemetry.read("loop_cond", x)
            with telemetry.span("vec_ode.loop.launch"):
                pass
            with telemetry.span("vec_ode.driver.step", 0):
                pass
            with telemetry.span("vec_ode.driver.step", 1):
                pass
    spans = telemetry.spans()
    assert [(s.name, s.parent) for s in spans] == [
        ("vec_ode.loop.launch", -1), ("vec_ode.sync.grid", 0),
        ("vec_ode.sync.grid", 0), ("vec_ode.sync.loop_cond", -1),
        ("vec_ode.loop.launch", -1), ("vec_ode.driver.step", -1),
        ("vec_ode.driver.step", -1)]
    assert spans[0].end_ns >= spans[2].end_ns
    assert spans[0].call >= 0 and {s.call for s in spans} == {spans[0].call}


def test_a_full_list_counts_what_it_drops(monkeypatch):
    telemetry.clear()
    monkeypatch.setattr(telemetry, "CAPACITY", 3)
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(5):
            with telemetry.span("vec_ode.driver.step", i):
                pass
    assert [s.iteration for s in telemetry.spans()] == [0, 1, 2]
    assert telemetry.dropped() == 2
    telemetry.clear()
    assert telemetry.spans() == [] and telemetry.dropped() == 0


def test_threads_keep_their_own_calls_and_parents(monkeypatch):
    """The recorder under threads that record at once (the profiler
    records only the thread that started it, so its switch and annotation
    are stood in for here)."""
    telemetry.clear()
    monkeypatch.setattr(telemetry, "_profiling", lambda: True)
    monkeypatch.setattr(telemetry, "_annotate",
                        lambda name: contextlib.nullcontext())
    n_threads, n_calls = 6, 40
    errors = []

    def work():
        try:
            for _ in range(n_calls):
                with telemetry.call():
                    with telemetry.span("vec_ode.entry"):
                        telemetry.read("grid", torch.ones(()))
                    with telemetry.span("vec_ode.solution"):
                        pass
        except Exception as exc:  # reported below, from the main thread
            errors.append(exc)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not errors and not any(t.is_alive() for t in threads)
    spans = telemetry.spans()
    by_call = collections.Counter(s.call for s in spans)
    assert len(by_call) == n_threads * n_calls
    assert set(by_call.values()) == {3}
    for s in spans:
        if s.name == "vec_ode.sync.grid":
            p = spans[s.parent]
            assert p.name == "vec_ode.entry" and p.call == s.call


# -- the benchmark's readers of the spans, on planted numbers --------------

MS = 1_000_000   # ns


class _Trace:
    """What the readers take of ``odebench.trace.Trace``: host events
    and device intervals in microseconds, activity counts by name."""

    def __init__(self, host, intervals, by_name):
        self.host, self.intervals, self.by_name = host, intervals, by_name


def _planted():
    """Two calls on the host driver, in ns: call 0 from 0 to 10 ms (entry
    0-2 with a grid read 1-1.5, a condition read 2-3, a step 3-7 with a
    nested read 5-6, a condition read 7-8, the solution 8-9.5), call 1
    from 20 to 25 ms (entry 20-21, a loop launch 21-24, solution 24-25),
    and a span of an earlier profile at -100 ms."""
    S = telemetry.Span
    return [
        S("vec_ode.entry", -100 * MS, -99 * MS, 7, -1, -1),
        S("vec_ode.entry", 0, 2 * MS, 0, -1, -1),
        S("vec_ode.sync.grid", 1 * MS, 1.5 * MS, 0, -1, 1),
        S("vec_ode.sync.driver_cond", 2 * MS, 3 * MS, 0, -1, -1),
        S("vec_ode.driver.step", 3 * MS, 7 * MS, 0, 0, -1),
        S("vec_ode.sync.other", 5 * MS, 6 * MS, 0, -1, 4),
        S("vec_ode.sync.driver_cond", 7 * MS, 8 * MS, 0, -1, -1),
        S("vec_ode.solution", 8 * MS, 9.5 * MS, 0, -1, -1),
        S("vec_ode.entry", 20 * MS, 21 * MS, 1, -1, -1),
        S("vec_ode.loop.launch", 21 * MS, 24 * MS, 1, -1, -1),
        S("vec_ode.solution", 24 * MS, 25 * MS, 1, -1, -1),
    ]


def _run(spans, dropped=0, monkeypatch=None, intervals=None):
    monkeypatch.setattr(telemetry, "spans", lambda: list(spans))
    monkeypatch.setattr(telemetry, "dropped", lambda: dropped)
    # the device busy 0-4, 6-9 and 22-30 ms (in us); the window 40 ms
    if intervals is None:
        intervals = [(0.0, 4_000.0), (6_000.0, 9_000.0),
                     (22_000.0, 30_000.0)]
    trace = _Trace(host=[(-1.0, 2_000.0), (2_000.0, 40_000.0)],
                   intervals=intervals,
                   by_name={"k4": [6, 0.0], "copy": [2, 0.0]})
    return Run(cell=None, system=None, n_calls=2, window_s=0.04,
               trace=trace)


def _read(name, run):
    return manifest.module("metrics", name).read(run)


# top-level 2 + 1 + 4 + 1 + 1.5 (call 0) + 1 + 3 + 1 (call 1) = 14.5 ms,
# reads 0.5 + 1 + 1 + 1 = 3.5 ms, over two calls; idle 4-6 and 9-22 ms
# meets the spans over 4-6 (the step), 9-9.5 (solution) and 20-22
# (entry, launch): 4.5 ms of 40
HOST_MS, SYNCS, IDLE = (14.5 - 3.5) / 2, 4 / 2, 100 * 4.5 / 40
WANT = {"port_host_ms_per_solve": HOST_MS,
        "port_host_ms_per_solve.host_paced": HOST_MS,
        "syncs_per_solve": SYNCS, "syncs_per_solve.host_paced": SYNCS,
        "port_idle_pct": IDLE, "port_idle_pct.host_paced": IDLE,
        "driver_ms_per_iter.host_paced": 4.0 - 1.0,
        "device_ops_per_iter.host_paced": 8 / 1,
        # the one step begins at 3 ms, with the device busy 0-4
        "driver_ahead_pct.host_paced": 100.0}


@pytest.mark.parametrize("name", sorted(WANT))
def test_span_readers_on_planted_numbers(name, monkeypatch):
    run = _run(_planted(), monkeypatch=monkeypatch)
    assert _read(name, run) == pytest.approx(WANT[name], rel=1e-12)
    assert _read(name, _run([], monkeypatch=monkeypatch)) is None
    assert _read(name, _run(_planted(), dropped=1,
                            monkeypatch=monkeypatch)) is None
    run.trace = None
    assert _read(name, run) is None


def _driver_call():
    """One call of three driver iterations, in ns: steps of 2 ms at 2, 5
    and 8 ms, each followed by its condition read, and a span of an
    earlier profile at -100 ms."""
    S = telemetry.Span
    spans = [S("vec_ode.driver.step", -100 * MS, -99 * MS, 7, 0, -1),
             S("vec_ode.entry", 0, 1 * MS, 0, -1, -1)]
    for k in range(3):
        at = (2 + 3 * k) * MS
        spans += [S("vec_ode.driver.step", at, at + 2 * MS, 0, k, -1),
                  S("vec_ode.sync.driver_cond", at + 2 * MS, at + 3 * MS, 0,
                    -1, -1)]
    return spans + [S("vec_ode.solution", 11 * MS, 12 * MS, 0, -1, -1)]


def test_driver_ahead_pct_on_plain_spans(monkeypatch):
    """The condition read before each step drains the device: it runs
    from 0.5 ms into each step to the end of the read that follows (in
    us), idle as each step begins."""
    busy = [(a + 500.0, a + 3_000.0) for a in (2_000.0, 5_000.0, 8_000.0)]
    run = _run(_driver_call(), monkeypatch=monkeypatch, intervals=busy)
    assert _read("driver_ahead_pct.host_paced", run) == 0.0


def test_driver_ahead_pct_on_lagged_spans(monkeypatch):
    """The condition read one step late: the device still runs as each
    step begins (busy 1.5-12 ms, in us), or as all but the second begin,
    which starts after the device went idle (4.8-5.2 ms)."""
    name = "driver_ahead_pct.host_paced"
    run = _run(_driver_call(), monkeypatch=monkeypatch,
               intervals=[(1_500.0, 12_000.0)])
    assert _read(name, run) == 100.0
    run = _run(_driver_call(), monkeypatch=monkeypatch,
               intervals=[(1_500.0, 4_800.0), (5_200.0, 12_000.0)])
    assert _read(name, run) == pytest.approx(100.0 * 2 / 3, rel=1e-12)


def test_every_reader_is_listed():
    listed = {m["name"] for m in manifest.load()["per_layer"]}
    assert set(WANT) <= listed

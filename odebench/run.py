"""Run one cell of the benchmark once.

    python3 -m odebench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the cards the cell asks
for. Set-up makes the configuration's operators (from the configuration's
own seed) and the traffic's pool of initial states (on the card, from
``--seed``), builds the port's stepper and warms up the cell's own call (the port's kernels build once a checkout,
into ``build/kernels/``). Then one caller calls
``vec_ode_tpu_torch.parallel.ensemble_solve`` in a closed loop for
``--seconds``, each call timed from the call to a ``synchronize()`` after
it. After the window a sample of the calls, drawn from the seed, is
judged against the configuration's plain reference.

The last line of standard output is one JSON object: ``correct``,
``attempted`` and ``failed`` (trajectories), ``metrics`` (with
``--trace 0`` the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics, read from a ``torch.profiler`` trace of the window),
``device`` and, traced, ``breakdown``; last, ``checks``: each number the
output check compares, with its limit. The checks are also the last lines
of standard error. Without the cards the cell asks for, or with JAX or the
JAX package loaded, it prints no result and exits non-zero.
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
import warnings  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

T_TORCH = time.time()

from . import manifest, traffic  # noqa: E402
from .trace import Trace, power_limit, profiler  # noqa: E402

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "vec_ode_tpu"})


def log(msg: str) -> None:
    print(f"[odebench] {msg}", file=sys.stderr, flush=True)


@dataclasses.dataclass
class Run:
    """What a window produced, for the metrics and the output check."""

    cell: manifest.Cell
    system: object
    n_calls: int = 0
    walls: list = dataclasses.field(default_factory=list)
    window_s: float = 0.0
    failed: int = 0
    accepts: int = 0
    rejects: int = 0
    trace: Trace = None

    @property
    def steps(self) -> int:
        return self.accepts + self.rejects


def loaded_forbidden() -> list:
    """Top-level names of loaded modules that the port must not load,
    compared whole (``vec_ode_tpu_torch`` is not ``vec_ode_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def window(run: Run, seconds: float, seed: int, traced: bool, sync):
    """The closed loop: call, wait, time, until ``seconds`` have passed.
    Returns the sampler of calls kept for the output check."""
    from vec_ode_tpu_torch import DONE

    system = run.system
    sampler = traffic.Sampler(system.mix["check_calls"], seed)
    dev = system.device
    bad = torch.zeros((), dtype=torch.int64, device=dev)
    counted = torch.zeros(2, dtype=torch.int64, device=dev)
    i, start = 0, time.perf_counter()
    while True:
        t0 = time.perf_counter()
        sol = system.call(i)
        sync()
        t1 = time.perf_counter()
        run.walls.append(t1 - t0)
        bad += (sol.status != DONE).sum()
        if traced:
            counted += torch.stack([sol.n_accept.sum(), sol.n_reject.sum()])
        sampler.offer(i, sol)
        del sol
        i += 1
        if t1 - start >= seconds:
            break
    sync()
    run.n_calls, run.window_s = i, t1 - start
    run.failed = int(bad)
    if traced:
        run.accepts, run.rejects = (int(v) for v in counted.tolist())
    return sampler


def run_cell(cell: manifest.Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: float = None, wrap=None,
             marks=()) -> tuple:
    """One run of ``cell``. Returns (result line, check lines). ``wrap``,
    if given, is applied to the built system before warm-up (the tests
    plant faults with it); ``marks`` are (name, time) of set-up's steps
    before this call, for the set-up line."""
    t_start = time.time() if t_start is None else t_start
    marks = list(marks)
    from vec_ode_tpu_torch import config as port_config

    marks.append(("the port's import", time.time()))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    port_config.warn_on_fallback = True
    cuda = device.startswith("cuda")
    sync = torch.cuda.synchronize if cuda else (lambda: None)

    conf, mix = cell.config, cell.mix
    system = manifest.module("systems", conf["system"]).build(
        conf, mix, seed, device)
    sync()
    marks.append(("operators, pool and stepper", time.time()))
    if wrap is not None:
        wrap(system)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for j in range(mix["warmup_calls"]):
            sol = system.call(j)
            sync()
            marks.append((f"warm call {j}", time.time()))
    route = sol.path
    del sol
    setup_s = time.time() - t_start
    parts = ", ".join(f"{name} {t - prev:.3f}" for (name, t), prev in
                      zip(marks, [t_start] + [t for _, t in marks]))
    log(f"cell {cell.name}: route {route}; set-up {setup_s:.3f} s ({parts})")
    for w in caught:
        log(f"declined route: {w.message}")

    run = Run(cell=cell, system=system)
    prof = profiler() if trace else None
    if prof is not None:
        prof.start()
    sampler = window(run, seconds, seed, trace, sync)
    if prof is not None:
        prof.stop()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    kind = torch.cuda.get_device_name(0) if cuda else "cpu"
    card = power_limit() if cuda else "cpu"
    B = mix["batch"]
    log(f"{run.n_calls} calls of {B} trajectories in {run.window_s:.3f} s; "
        f"peak device memory {peak} B ({card})")

    metrics = {}
    device_info = {"platform": "gpu" if cuda else "cpu", "kind": kind,
                   "count": cell.chips, "memory_peak_bytes": peak}
    breakdown = None
    if trace:
        t_read = time.time()
        run.trace = Trace(prof, run.window_s)
        del prof
        log(f"trace: {run.trace.n_events} events read in "
            f"{time.time() - t_read:.3f} s")
        device_info.update(busy_s=run.trace.busy_s, window_s=run.window_s)
        breakdown = {"device_ops": run.trace.device_ops(),
                     "idle_gaps": run.trace.idle_gaps()}
        for m in cell.per_layer:
            try:
                value = manifest.module("metrics", m["name"]).read(run)
            except Exception as exc:  # a reader's fault leaves its metric out
                log(f"per-layer metric {m['name']} failed: {exc!r}")
                continue
            if value is None:
                log(f"per-layer metric {m['name']}: nothing to read")
                continue
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
            log(f"{m['name']} = {value} {m['unit']} ({card})")
    else:
        walls_ms = np.asarray(run.walls) * 1e3
        known = {"traj_per_s": run.n_calls * B / run.window_s,
                 "solve_ms_p95": float(np.percentile(walls_ms, 95)),
                 "setup_s": setup_s}
        for m in cell.end_to_end:   # a split metric: its quantity's name
            metrics[m["name"]] = {"value": known[m["name"].split(".")[0]],
                                  "unit": m["unit"]}
        log(f"solve wall median {float(np.median(walls_ms))} ms, p95 "
            f"{known['solve_ms_p95']} ms over {run.n_calls} calls")

    # the output check, with the program's state freed
    system.stepper = None
    if cuda:
        torch.cuda.empty_cache()
    numbers = manifest.module("references", conf["reference"]).check_numbers(
        system, sampler.kept)
    numbers["not_done"] = run.failed
    limits = mix["limits"]
    checks = {k: {"value": v, "limit": limits.get(k)}
              for k, v in numbers.items()}
    correct = all(c["limit"] is not None and c["value"] <= c["limit"]
                  for c in checks.values())
    line = {"correct": correct, "attempted": run.n_calls * B,
            "failed": run.failed, "metrics": metrics, "device": device_info}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = {k: {"value": _finite(c["value"]), "limit": c["limit"]}
                      for k, c in checks.items()}
    check_lines = [f"check {k}: {_finite(c['value'])} (limit {c['limit']}; "
                   f"{len(sampler.kept)} calls judged)"
                   for k, c in checks.items()]
    return line, check_lines


def _finite(v):
    """A number for JSON: a non-finite reading as the string 'inf'."""
    return v if isinstance(v, int) or math.isfinite(v) else "inf"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    try:
        cell = manifest.cell(manifest.load(), args.workload)
    except (KeyError, FileNotFoundError) as exc:
        log(f"no such cell: {exc}")
        return 2
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell.chips):
        log(f"cell {cell.name} needs {cell.chips} CUDA card(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
            "; no result")
        return 2
    marks = [("python and torch import", T_TORCH),
             ("manifest and card check", time.time())]
    line, check_lines = run_cell(cell, args.seed, args.seconds,
                                 bool(args.trace), "cuda", T_START,
                                 marks=marks)
    found = loaded_forbidden()
    if found:
        log(f"loaded in this process: {', '.join(found)}; no result")
        return 3
    print(json.dumps(line), flush=True)
    for text in check_lines:
        print(text, file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

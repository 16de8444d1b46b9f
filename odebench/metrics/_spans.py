"""What the readers of the port's own spans share
(``vec_ode_tpu_torch.telemetry``): the spans of the traced window, each
with the top-level span it lies in."""

SYNC = "vec_ode.sync."


def window(run):
    """The port's spans of the traced window as (index, span, index of its
    top-level span), for spans of an ``ensemble_solve`` call whose
    top-level span meets the trace's host range (spans of an earlier
    profile in the same process are left out). None where there is no
    trace, the port records no spans (a port without telemetry), none lie
    in the window, or some were dropped."""
    if run.trace is None or not run.trace.host:
        return None
    try:
        from vec_ode_tpu_torch import telemetry
    except ImportError:
        return None
    if telemetry.dropped():
        return None
    spans = telemetry.spans()
    lo = run.trace.host[0][0] * 1e3                      # us -> ns
    hi = max(h[1] for h in run.trace.host) * 1e3
    roots, out = [], []
    for i, s in enumerate(spans):
        r = i if s.parent < 0 else roots[s.parent]
        roots.append(r)
        top = spans[r]
        if (s.call >= 0 and s.end_ns >= 0 and top.end_ns >= lo
                and top.start_ns <= hi):
            out.append((i, s, r))
    return out or None


def seconds(s) -> float:
    return (s.end_ns - s.start_ns) * 1e-9


def n_calls(spans) -> int:
    return len({s.call for _, s, _ in spans})

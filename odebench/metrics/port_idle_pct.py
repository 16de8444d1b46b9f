"""The device's idle time inside the port's calls, % of the traced
window: the gaps between the device's activity intervals that lie in a
top-level span of an ``ensemble_solve`` (layer: the device).
``device_idle_pct`` less this is the caller's share. Moves
traj_per_s."""

from ..trace import merged
from ._spans import window


def overlap(a, b) -> float:
    """The length of the intersection of two sorted lists of disjoint
    (start, end) intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def read(run):
    spans = window(run)
    if spans is None or not run.trace.intervals:
        return None
    busy = merged(run.trace.intervals)
    gaps = [(e0, s1) for (_, e0), (s1, _) in zip(busy, busy[1:])]
    port = merged((s.start_ns * 1e-3, s.end_ns * 1e-3)       # ns -> us
                  for i, s, r in spans if i == r)
    return 100.0 * overlap(gaps, port) * 1e-6 / run.window_s

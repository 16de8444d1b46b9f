"""The share of host-driver iterations that the host began to enqueue
while the device still ran work queued before them, %: the
``vec_ode.driver.step`` spans of the traced window whose start lies in
the device's activity, over every ``vec_ode.driver.step`` span (layer:
the ensemble entry and host driver, ``driver.resume``). A loop that
reads its condition before each iteration has drained the device there
and reads 0; one that reads it an iteration late counts the iterations
begun while the last one's step kernel still ran, and not those begun
after the device had gone idle. Moves traj_per_s.host_paced."""

import bisect

from ..trace import merged
from ._spans import window

STEP = "vec_ode.driver.step"


def read(run):
    spans = window(run)
    if spans is None or not run.trace.intervals:
        return None
    starts = [s.start_ns * 1e-3 for i, s, r in spans             # ns -> us
              if i == r and s.name == STEP]
    if not starts:
        return None
    busy = merged(run.trace.intervals)
    lo = [b[0] for b in busy]
    ahead = 0
    for t in starts:
        j = bisect.bisect_right(lo, t) - 1
        ahead += j >= 0 and busy[j][1] > t
    return 100.0 * ahead / len(starts)

"""Device activities (kernels, copies, fills) a host-driver iteration:
every activity of the traced window over its ``vec_ode.driver.step``
spans (layer: the ensemble entry and host driver). Moves
traj_per_s.host_paced."""

from ._spans import window

STEP = "vec_ode.driver.step"


def read(run):
    spans = window(run)
    if spans is None or not run.trace.intervals:
        return None
    steps = sum(1 for i, s, r in spans if i == r and s.name == STEP)
    if not steps:
        return None
    return sum(n for n, _ in run.trace.by_name.values()) / steps

"""The host driver's self time an iteration, ms: the mean over the
``vec_ode.driver.step`` spans of the traced window of each one's
duration less the reads of the device nested in it (layer: the ensemble
entry and host driver, ``driver.resume``). Moves
traj_per_s.host_paced."""

from ._spans import SYNC, seconds, window

STEP = "vec_ode.driver.step"


def read(run):
    spans = window(run)
    if spans is None:
        return None
    steps = {i: s for i, s, r in spans if i == r and s.name == STEP}
    if not steps:
        return None
    nested = sum(seconds(s) for i, s, r in spans
                 if i != r and r in steps and s.name.startswith(SYNC))
    return (sum(seconds(s) for s in steps.values()) - nested) \
        / len(steps) * 1e3

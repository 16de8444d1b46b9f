"""Reads of the device by the host a call: the ``vec_ode.sync.*`` spans
of the traced window over its ``ensemble_solve`` calls (layer: the
ensemble entry and host driver). Moves traj_per_s."""

from ._spans import SYNC, n_calls, window


def read(run):
    spans = window(run)
    if spans is None:
        return None
    n = sum(1 for _, s, _ in spans if s.name.startswith(SYNC))
    return n / n_calls(spans)

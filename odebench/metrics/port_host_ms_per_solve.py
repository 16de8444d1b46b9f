"""The port's own host time a call, ms: the top-level spans of each
``ensemble_solve`` (``vec_ode.entry``, ``.loop.launch``, ``.driver.*``,
``.solution``, top-level reads) less every read of the device
(``vec_ode.sync.*``), over the calls of the traced window: host work not
blocked on the card (layer: the ensemble entry and host driver). Moves
traj_per_s."""

from ._spans import SYNC, n_calls, seconds, window


def read(run):
    spans = window(run)
    if spans is None:
        return None
    top = sum(seconds(s) for i, s, r in spans if i == r)
    syncs = sum(seconds(s) for _, s, _ in spans if s.name.startswith(SYNC))
    return (top - syncs) / n_calls(spans) * 1e3

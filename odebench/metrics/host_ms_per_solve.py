"""Host time a call, ms: the calls' walls minus the device's busy time
in them, over the calls of the traced window (layer: the ensemble entry
and host driver, ``parallel/ensemble.py``, ``driver.py``). Moves
traj_per_s."""


def read(run):
    if run.trace is None or not run.n_calls:
        return None
    return (sum(run.walls) - run.trace.busy_s) / run.n_calls * 1e3

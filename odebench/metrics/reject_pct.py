"""Rejected over attempted steps, %, summed over every trajectory of
every call of the window, from ``Solution.n_accept`` / ``n_reject``
(layer: the controller, ``controller.py``). Moves traj_per_s."""


def read(run):
    attempted = run.accepts + run.rejects
    if not attempted:
        return None
    return 100.0 * run.rejects / attempted

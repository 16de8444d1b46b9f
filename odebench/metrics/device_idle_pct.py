"""The device's idle share of the traced window, %: 1 minus the union of
its activity intervals over the window (layer: the device, one H100).
Moves traj_per_s."""


def read(run):
    if run.trace is None or run.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.window_s)

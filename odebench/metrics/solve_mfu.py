"""The whole solve's share of the card's FP32 peak, %: the least
operations of every call of the window (the configuration's count:
``counts/fused_loop_rk.py`` or ``counts/fused_loop_chain.py``) over the
window's seconds at 67 TFLOP/s (layer: the device, one H100). It bounds
the kernels' roofline shares whichever kernel runs the work. Moves
traj_per_s."""

from ..peaks import FP32_FLOP_S


def read(run):
    if run.trace is None or not run.n_calls:
        return None
    return 100.0 * run.system.solve_flop(run) / (run.window_s * FP32_FLOP_S)

"""The loop kernel K2 with the chain step K5 (``ops/fused_loop.py`` →
``csrc/fused_loop.cu``, ``chain_step.cuh``) against its roofline, %: the
least time of the work the window's calls needed (each row's steps and
their Taylor passes, ``counts/fused_loop_chain.py``) over K2's device
time in the trace. Nothing when K2 did not run. Moves traj_per_s."""

from ..counts import load
from ..peaks import bound


def read(run):
    if run.trace is None:
        return None
    launches, seconds = run.trace.kernels("fused_loop_kernel")
    if not launches:
        return None
    sysm = run.system
    nbytes = load("fused_loop_chain").solve_bytes(sysm.mix["batch"],
                                                  2 * sysm.config["d"])
    ms, _ = bound(sysm.solve_flop(run), launches * nbytes)
    return 100.0 * ms * 1e-3 / seconds

"""The loop kernel K2 with the RK step K3 (``ops/fused_loop.py`` →
``csrc/fused_loop.cu``, ``rk_step.cuh``) against its roofline, %: the
least time of the work the window's calls needed (every row's accepted
plus rejected steps, ``counts/fused_loop_rk.py``) over K2's device time
in the trace. Nothing when K2 did not run. Moves traj_per_s.host_paced."""

from ..counts import load
from ..peaks import bound


def read(run):
    if run.trace is None:
        return None
    launches, seconds = run.trace.kernels("fused_loop_kernel")
    if not launches:
        return None
    sysm = run.system
    c, mix = sysm.config, sysm.mix
    _, nbytes = load("fused_loop_rk").flop_bytes(
        0, mix["batch"], 2 * c["d"], c["stages"], len(mix["save_at"]) + 2, 4)
    ms, _ = bound(sysm.solve_flop(run), launches * nbytes)
    return 100.0 * ms * 1e-3 / seconds

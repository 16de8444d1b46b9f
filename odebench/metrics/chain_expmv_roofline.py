"""The chain step kernel K4 (``ops/expmv.py`` → ``csrc/chain_expmv.cu``)
against its roofline, %: the least time of the work the window's calls
needed (each row's steps and their Taylor passes,
``counts/fused_loop_chain.py``; the bytes of a launch,
``counts/chain_expmv.py``) over K4's device time in the trace. Nothing
when K4 did not run. Moves traj_per_s.host_paced."""

from ..counts import load
from ..peaks import bound


def read(run):
    if run.trace is None:
        return None
    launches, seconds = run.trace.kernels("chain_expmv_kernel")
    if not launches:
        return None
    sysm = run.system
    nbytes = load("chain_expmv").launch_bytes(sysm.mix["batch"],
                                              2 * sysm.config["d"])
    ms, _ = bound(sysm.solve_flop(run), launches * nbytes)
    return 100.0 * ms * 1e-3 / seconds

"""The loop kernel K2 with the RK step K3 (``csrc/fused_loop.cu`` over
``csrc/rk_step.cuh``): ``chip_smoke.k2_bound``, frozen.

The least work of one solve: the stage products of every step the data
needs (accepted and rejected, summed over rows: the port's ``n_accept``
and ``n_reject``), each stage one (D, D) product of the widened state
with the two operator terms, and the carries, the state, the saves and
the operators moved once.
"""

from __future__ import annotations

from ..peaks import bound


def flop_bytes(steps: int, B: int, D: int, stages: int, n_grid: int,
               nbytes: int) -> tuple:
    """(operations, bytes) of one solve of B rows of width D (the widened
    real state, 2d), ``steps`` accepted plus rejected steps in all, an
    ``stages``-stage tableau, a grid of ``n_grid`` points (t0, the saves,
    tf), ``nbytes`` per element."""
    flop = steps * 2 * stages * D * 2 * D
    moved = (nbytes * (2 * B * (5 + D) + (n_grid - 2) * B * D + 2 * D * D
                       + n_grid) + 2 * 4 * B * 8)
    return flop, moved


def bound_ms(steps: int, B: int, D: int, stages: int, n_grid: int,
             nbytes: int) -> tuple:
    """The least time of one solve (ms) and what bounds it."""
    return bound(*flop_bytes(steps, B, D, stages, n_grid, nbytes))

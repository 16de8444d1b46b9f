"""``syncs_per_solve`` in the host-paced cells (rkf45-2k-saves-loop,
magnus4-16k-step), where it moves traj_per_s.host_paced: the same
reader."""

from .syncs_per_solve import read  # noqa: F401

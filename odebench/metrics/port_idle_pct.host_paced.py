"""``port_idle_pct`` in the host-paced cells (rkf45-2k-saves-loop,
magnus4-16k-step), where it moves traj_per_s.host_paced: the same
reader."""

from .port_idle_pct import read  # noqa: F401

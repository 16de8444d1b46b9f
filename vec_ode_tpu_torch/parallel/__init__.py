"""Ensembles of independent trajectories, on one device or sharded over a
``torch.distributed`` DeviceMesh, and one large linear ODE with its state
sharded over a mesh axis (``state_parallel``)."""

from .ensemble import (cost_sorted_permutation, ensemble_mesh,
                       ensemble_solve, ensemble_solve_compact,
                       inverse_permutation, shard_batch, step_efficiency)
from .state_parallel import (ensemble_solve_state_sharded, local_rows,
                             mesh_2d, solve_linear_state_sharded)

__all__ = ["ensemble_solve", "ensemble_solve_compact",
           "cost_sorted_permutation", "inverse_permutation", "ensemble_mesh",
           "shard_batch", "step_efficiency", "local_rows",
           "solve_linear_state_sharded", "ensemble_solve_state_sharded",
           "mesh_2d"]

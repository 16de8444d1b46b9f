"""Ensembles of independent trajectories on one device."""

from .ensemble import (cost_sorted_permutation, ensemble_solve,
                       ensemble_solve_compact, inverse_permutation,
                       step_efficiency)

__all__ = ["cost_sorted_permutation", "ensemble_solve",
           "ensemble_solve_compact", "inverse_permutation",
           "step_efficiency"]

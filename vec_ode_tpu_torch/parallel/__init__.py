"""Ensembles of independent trajectories."""

from .ensemble import ensemble_solve

__all__ = ["ensemble_solve"]

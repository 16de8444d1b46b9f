"""Utilities around the solvers: checkpointing of the driver's carry."""

from .checkpointing import load_state, save_state

__all__ = ["load_state", "save_state"]

"""Problem/model library."""

from .quantum import DrivenDense, LandauZener

__all__ = ["DrivenDense", "LandauZener"]

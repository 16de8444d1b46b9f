"""Problem/model library."""

from .quantum import DrivenDense, LandauZener, PulseControl

__all__ = ["DrivenDense", "LandauZener", "PulseControl"]

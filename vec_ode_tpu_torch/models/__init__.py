"""Problem/model library."""

from .quantum import DrivenDense, LandauZener, Lindblad, PulseControl

__all__ = ["DrivenDense", "LandauZener", "Lindblad", "PulseControl"]

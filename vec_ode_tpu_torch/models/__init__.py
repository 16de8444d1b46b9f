"""Problem/model library."""

from .chains import TightBindingChain
from .linear import DecayDiag, LinearConstant, stable_dense_matrix
from .nonlinear import Brusselator, LotkaVolterra, VanDerPol
from .quantum import DrivenDense, LandauZener, Lindblad, PulseControl

__all__ = [
    "LinearConstant",
    "DecayDiag",
    "stable_dense_matrix",
    "VanDerPol",
    "LotkaVolterra",
    "Brusselator",
    "LandauZener",
    "DrivenDense",
    "PulseControl",
    "Lindblad",
    "TightBindingChain",
]

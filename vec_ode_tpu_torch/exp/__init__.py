"""Exponential integrators (the modulated-operator fast path of
``vec_ode_tpu/exp``)."""

from .modulated import (CoeffForm, MagnusModulated4, MidpointModulated,
                        ModulatedOperator, modulated_exp_apply)

__all__ = [
    "CoeffForm",
    "MagnusModulated4",
    "MidpointModulated",
    "ModulatedOperator",
    "modulated_exp_apply",
]

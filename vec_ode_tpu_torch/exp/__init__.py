"""Exponential integrators, the counterpart of ``vec_ode_tpu/exp``: the
modulated-operator fast path (with ``auto_modulated``, which recovers it
from a black-box operator), the generic steppers (Magnus, CFM, split
solvers) over the split leaves, and the composite splits."""

from .auto import auto_modulated
from .cfm import CFM, CFM4, CFM4_BLANES17, cfm_exp, cfm_step
from .leaves import (AntiHermitianCplxSplit, AntiHermitianSplit,
                     DenseCplxSplit, DenseSplit, DiagonalCplxSplit,
                     DiagonalSplit)
from .magnus import (ExpMidpoint, Magnus4, Magnus6, magnus4_step,
                     magnus6_step, midpoint_step)
from .modulated import (CFM4Modulated, CFMModulated, CfmTable, ChebForm,
                        CoeffForm,
                        MagnusModulated4, MagnusModulated6,
                        MidpointModulated, ModulatedOperator,
                        modulated_exp_apply)
from .protocol import ExponentialSplit, index_u
from .split_solvers import (SplitCFM, SplitMidpoint, split_cfm_step,
                            split_midpoint_step)
from .splits import (CommutativeSplit, RKNR4Split, SemiComplexO4Split,
                     StrangSplit, TripleJumpSplit)

__all__ = [
    "AntiHermitianCplxSplit",
    "AntiHermitianSplit",
    "CFM",
    "CFM4",
    "CFM4_BLANES17",
    "CFM4Modulated",
    "CommutativeSplit",
    "RKNR4Split",
    "SemiComplexO4Split",
    "StrangSplit",
    "TripleJumpSplit",
    "CFMModulated",
    "CfmTable",
    "ChebForm",
    "CoeffForm",
    "DenseCplxSplit",
    "DenseSplit",
    "DiagonalCplxSplit",
    "DiagonalSplit",
    "ExpMidpoint",
    "ExponentialSplit",
    "Magnus4",
    "Magnus6",
    "MagnusModulated4",
    "MagnusModulated6",
    "MidpointModulated",
    "ModulatedOperator",
    "SplitCFM",
    "SplitMidpoint",
    "cfm_exp",
    "cfm_step",
    "index_u",
    "auto_modulated",
    "magnus4_step",
    "magnus6_step",
    "midpoint_step",
    "modulated_exp_apply",
    "split_cfm_step",
    "split_midpoint_step",
]

"""Complex pairs and the fused steps (with their CUDA kernels)."""

from .cplx import Cplx, cmatmul, embed, extract, from_complex, to_complex
from .expmv import CoeffForm, fused_chain_apply, torch_chain_step
from .fused_rk import FusedModulatedLinearRK, fused_rk_step, torch_rk_step

__all__ = [
    "Cplx",
    "CoeffForm",
    "cmatmul",
    "embed",
    "extract",
    "fused_chain_apply",
    "torch_chain_step",
    "from_complex",
    "to_complex",
    "FusedModulatedLinearRK",
    "fused_rk_step",
    "torch_rk_step",
]

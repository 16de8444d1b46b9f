"""Complex pairs and the fused step (with its CUDA kernel)."""

from .cplx import Cplx, embed, from_complex, to_complex
from .fused_rk import FusedModulatedLinearRK, fused_rk_step, torch_rk_step

__all__ = [
    "Cplx",
    "embed",
    "from_complex",
    "to_complex",
    "FusedModulatedLinearRK",
    "fused_rk_step",
    "torch_rk_step",
]

"""Complex pairs, the matrix exponential and the fused steps (with their
CUDA kernels)."""

from .cplx import (Cplx, apply_embedded, cabs2, cconj, cexp, cexpm,
                   cexpm1, cexpm_apply, cmatmul, cmatvec, cscale, cscale_any,
                   embed, extract, from_complex, to_complex)
from .dense_chains import (ChainTable, Exponent, fused_dense_chain_apply,
                           torch_dense_chains)
from .expm import expm, expm_apply, expm_frechet, expm_m1
from .expmv import (ChebForm, CoeffForm, fused_chain_apply,
                    torch_chain_step)
from .fused_rk import FusedModulatedLinearRK, fused_rk_step, torch_rk_step

__all__ = [
    "ChainTable",
    "ChebForm",
    "CoeffForm",
    "Cplx",
    "Exponent",
    "FusedModulatedLinearRK",
    "apply_embedded",
    "cabs2",
    "cconj",
    "cexp",
    "cexpm",
    "cexpm1",
    "cexpm_apply",
    "cmatmul",
    "cmatvec",
    "cscale",
    "cscale_any",
    "embed",
    "expm",
    "expm_apply",
    "expm_frechet",
    "expm_m1",
    "extract",
    "from_complex",
    "fused_chain_apply",
    "fused_dense_chain_apply",
    "fused_rk_step",
    "to_complex",
    "torch_chain_step",
    "torch_dense_chains",
    "torch_rk_step",
]

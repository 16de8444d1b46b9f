"""Carrying problems and results across from the JAX package as numpy
arrays, so both sides solve the same inputs and compare field by field."""

from __future__ import annotations

import numpy as np
import torch
from torch.utils import _pytree as pytree

from .ops.cplx import Cplx
from .ops.fused_rk import FusedModulatedLinearRK
from .tableaus import RKF45


def stepper_from_numpy(M0, M1, w, *, tableau=RKF45, advance_lower=True,
                       device="cuda", dtype=torch.float64):
    """A ``FusedModulatedLinearRK`` over the embedded (2d, 2d) matrices as
    the JAX package's ``FusedModulatedLinearRK.from_driven_dense`` builds
    them (``np.asarray(stepper.M0)``), with the drive cos(w t), on the
    card unless ``device`` names another."""
    return FusedModulatedLinearRK(
        M0=torch.as_tensor(np.asarray(M0), dtype=dtype, device=device),
        M1=torch.as_tensor(np.asarray(M1), dtype=dtype, device=device),
        w=float(w), tableau=tableau, advance_lower=advance_lower,
    )


def state_from_numpy(re, im, *, device="cuda",
                     dtype=torch.float64) -> Cplx:
    """A Cplx state from numpy (re, im) parts, on the card unless
    ``device`` names another."""
    return Cplx(torch.as_tensor(np.asarray(re), dtype=dtype, device=device),
                torch.as_tensor(np.asarray(im), dtype=dtype, device=device))


def solution_to_numpy(sol) -> dict:
    """The Solution's array fields as numpy arrays (Cplx fields as Cplx of
    arrays), keyed by field name, plus ``path``."""
    def conv(v):
        return pytree.tree_map(lambda a: a.detach().cpu().numpy(), v)

    keys = ("ts", "ys", "t_final", "y_final", "status", "n_accept",
            "n_reject", "n_iters", "h_final")
    out = {k: conv(getattr(sol, k)) for k in keys}
    out["path"] = sol.path
    return out

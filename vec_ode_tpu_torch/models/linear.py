"""Linear models dx/dt = A x with closed-form solutions, the counterpart
of ``vec_ode_tpu/models/linear.py`` (BASELINE config 1). The numpy
constructor is the JAX package's, so a seed gives the same matrix."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def stable_dense_matrix(d: int, seed: int = 0, dtype=torch.float64,
                        device="cuda"):
    """Random stable matrix A = -(I + W W^T / d) / 2 + 0.3 (S - S^T): its
    spectrum lies in the left half plane. A tensor on the card unless
    ``device`` names another; ``dtype=None`` returns the numpy f64 array."""
    rng = np.random.default_rng(seed)
    W = rng.standard_normal((d, d))
    S = rng.standard_normal((d, d))
    A = -(np.eye(d) + W @ W.T / d) * 0.5 + (S - S.T) * 0.3
    if dtype is None:
        return A
    return torch.as_tensor(A, dtype=dtype, device=device)


@dataclasses.dataclass(frozen=True)
class LinearConstant:
    """dx/dt = A x with constant A (a tensor); exact solution exp(A t)
    x0."""

    A: torch.Tensor

    def rhs(self, t, y):
        return torch.einsum("ij,...j->...i", self.A, y)

    def op(self, t):
        return self.A

    def exact(self, t, y0):
        """exp(A t) y0 for one state or a batch of them."""
        t = torch.as_tensor(t, dtype=self.A.dtype, device=self.A.device)
        return torch.einsum("ij,...j->...i",
                            torch.linalg.matrix_exp(self.A * t), y0)


@dataclasses.dataclass(frozen=True)
class DecayDiag:
    """Diagonal decay y_i' = rates_i y_i (``rates`` a tensor)."""

    rates: torch.Tensor

    def rhs(self, t, y):
        return self.rates * y

    def op(self, t):
        return self.rates  # the DiagonalSplit leaf

    def exact(self, t, y0):
        return y0 * torch.exp(self.rates * t)

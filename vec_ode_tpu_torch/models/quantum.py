"""Quantum model family (the part of ``vec_ode_tpu/models/quantum.py`` the
ensemble path uses)."""

from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass(frozen=True)
class DrivenDense:
    """Driven dense Hamiltonian H(t) = H0 + cos(w t) V, d-dimensional,
    with H0 and V host-side complex numpy arrays. ``make`` is the JAX
    package's numpy code, so a seed gives bit-identical H0, V and w."""

    H0: np.ndarray
    V: np.ndarray
    w: float = 1.0

    @staticmethod
    def make(d: int = 64, seed: int = 0, w: float = 1.0):
        rng = np.random.default_rng(seed)
        M = rng.standard_normal((d, d)) + 1j * rng.standard_normal((d, d))
        H0 = (M + M.conj().T) / (2 * math.sqrt(d))
        N = rng.standard_normal((d, d)) + 1j * rng.standard_normal((d, d))
        V = (N + N.conj().T) / (2 * math.sqrt(d))
        return DrivenDense(H0=H0, V=V, w=w)

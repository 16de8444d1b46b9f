"""The declared drive and coefficient forms that the kernels sample
in-kernel, where the JAX package traces a callable into Pallas:
:class:`CoeffForm` (c_k(t) = a_k + b_k t + c_k cos(w_k t)) and
:class:`ChebForm` (a Chebyshev series on [lo, hi], the fit of
``exp.auto_modulated``). The chain kernels (K4, K5) take K of them as
coefficient functions, the RK kernels (K1, K3) one as the drive u(t).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

# the declared forms, as the kernels' form_kind reads them
FORMS = {"coeff": 0, "cheb": 1}


@dataclasses.dataclass(frozen=True)
class CoeffForm:
    """Declared coefficient functions c_k(t) = a_k + b_k t + c_k cos(w_k t),
    k < K, which a kernel evaluates in-kernel at its quadrature nodes (it
    cannot run a Python ``coeff_fn``). The terms whose factor is zero are
    left out and the rest added in the order a, b t, c cos(w t), with
    w t rounded before the cosine, so that ``DrivenDense.modulated``
    ([1, cos(w t)]) and ``LandauZener.modulated`` ([v t, delta]) give the
    JAX package's ``coeff_cols`` in the state's type."""

    a: tuple
    b: tuple
    c: tuple
    w: tuple

    def __post_init__(self):
        cols = [tuple(float(v) for v in getattr(self, f))
                for f in ("a", "b", "c", "w")]
        if len({len(col) for col in cols}) != 1 or not cols[0]:
            raise ValueError("CoeffForm: a, b, c and w need one entry per "
                             "basis term")
        for f, col in zip(("a", "b", "c", "w"), cols):
            object.__setattr__(self, f, col)

    @property
    def n_terms(self) -> int:
        return len(self.a)

    def sample(self, t: torch.Tensor) -> torch.Tensor:
        """The coefficients at times ``t`` (...,): a (..., K) tensor in t's
        type."""
        cols = []
        for a, b, c, w in zip(self.a, self.b, self.c, self.w):
            col = torch.full_like(t, a) if a != 0.0 else None
            if b != 0.0:
                col = b * t if col is None else col + b * t
            if c != 0.0:
                ct = c * torch.cos(w * t)
                col = ct if col is None else col + ct
            cols.append(torch.zeros_like(t) if col is None else col)
        return torch.stack(cols, dim=-1)

    def kernel_array(self) -> list:
        """(a_k, b_k, c_k, w_k) per term, flat, as the kernels read it."""
        return [v for k in range(self.n_terms)
                for v in (self.a[k], self.b[k], self.c[k], self.w[k])]


@dataclasses.dataclass(frozen=True)
class ChebForm:
    """Declared coefficient functions as Chebyshev series on [lo, hi]:
    c_k(t) = sum_j series[j][k] T_j(u), u = (2 t - (lo + hi)) / (hi - lo),
    the port of ``exp/auto.py``'s ``coeff_cols_fn`` (the fit of
    ``exp.auto_modulated``), which a kernel samples in-kernel. ``series``
    is (n, K) float64 (numpy ``chebfit``'s layout). :meth:`sample` runs
    JAX's Clenshaw in its order, in t's type: u = (2 t - (lo + hi)) *
    (1 / (hi - lo)) with lo + hi and 1 / (hi - lo) folded in float64 and
    rounded once; then per term b1, b2 = ((2 u) b1 - b2) + c_j, b1 for j =
    n - 1 .. 1 and c_k = (u b1 - b2) + c_0, every coefficient rounded once
    from float64. No term is skipped (u 0 still carries a NaN). The series
    is valid on [lo, hi] only."""

    series: tuple
    lo: float
    hi: float

    def __post_init__(self):
        a = np.asarray(self.series, np.float64)
        if a.ndim != 2 or a.shape[0] < 1 or a.shape[1] < 1:
            raise ValueError("ChebForm: series must be (n, K) with n, K >= "
                             f"1, got shape {a.shape}")
        lo, hi = float(self.lo), float(self.hi)
        if not (math.isfinite(lo) and math.isfinite(hi)) or lo == hi:
            raise ValueError(f"ChebForm: [lo, hi] must be a finite interval,"
                             f" got [{lo}, {hi}]")
        object.__setattr__(self, "series",
                           tuple(tuple(float(v) for v in row) for row in a))
        object.__setattr__(self, "lo", lo)
        object.__setattr__(self, "hi", hi)

    @property
    def n_terms(self) -> int:
        return len(self.series[0])

    @property
    def n_coeffs(self) -> int:
        """n: the series' length per term."""
        return len(self.series)

    def folded(self) -> tuple:
        """(lo + hi, 1 / (hi - lo)) in float64, as the kernels read them."""
        return self.lo + self.hi, 1.0 / (self.hi - self.lo)

    def sample(self, t: torch.Tensor) -> torch.Tensor:
        """The coefficients at times ``t`` (...,): a (..., K) tensor in t's
        type."""
        mid, inv = self.folded()
        coef = torch.tensor(self.series, dtype=torch.float64).to(
            device=t.device, dtype=t.dtype)
        u = ((2.0 * t - t.new_tensor(mid)) * t.new_tensor(inv))[..., None]
        u2 = 2.0 * u
        b1 = b2 = torch.zeros_like(u)
        for j in range(self.n_coeffs - 1, 0, -1):
            b1, b2 = (u2 * b1 - b2) + coef[j], b1
        return (u * b1 - b2) + coef[0]

    def kernel_table(self, dtype, device) -> torch.Tensor:
        """The series as the loop kernel reads it: (K, n) contiguous in
        ``dtype`` on ``device``, each coefficient rounded once."""
        return torch.tensor(self.series, dtype=torch.float64).T.to(
            device=device, dtype=dtype).contiguous()

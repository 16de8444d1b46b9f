"""Concrete exponential-split leaves, the counterpart of
``vec_ode_tpu/exp/leaves.py``:

* :class:`DenseSplit`: L is a dense (..., d, d) matrix; exp is the batched
  scaling-and-squaring ``ops.expm.expm``; apply is a (batched) matvec.
* :class:`DiagonalSplit`: L is the diagonal (..., d); all elementwise.
* :class:`AntiHermitianSplit`: L = -i H dt with H Hermitian; exp by
  eigendecomposition, unitary up to eigh accuracy (complex tensors).
* ``DenseCplxSplit``, ``DiagonalCplxSplit``, ``AntiHermitianCplxSplit``:
  the same on ``Cplx`` real pairs; dense propagators are embedded real
  (..., 2d, 2d) matrices.

The generic steppers batch natively over the two dense leaves
(``supports_batched_dense``; ``exp/dense_fast.py``).
"""

from __future__ import annotations

import dataclasses
import math
import numbers

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..ops import cplx as cp
from ..ops.expm import expm, expm_frechet, expm_m1
from .protocol import ExponentialSplit


def _check_max_squarings(v):
    """The operator function belongs to the solver, not the leaf;
    DenseSplit(Ht) would otherwise silently bind Ht to this field."""
    if not isinstance(v, numbers.Integral):
        raise TypeError(
            "max_squarings must be an int; split leaves take no operator "
            "argument — pass the operator function to the solver instead "
            f"(got {type(v).__name__})")


def cp_embed(L):
    """The real ring embedding of a Cplx operator (``ops.cplx.embed``)."""
    from ..ops import cplx as cp

    return cp.embed(L)


def _matvec(U, x):
    return (U @ x[..., None])[..., 0]


def _skew_parts(M):
    """(V, theta, M V) of a real skew-symmetric M: -M^2 = V diag(theta^2)
    V^T, symmetric PSD."""
    theta2, V = torch.linalg.eigh(-(M @ M))
    return V, torch.sqrt(torch.clamp(theta2, min=0.0)), M @ V


class _SkewExpm(torch.autograd.Function):
    """exp of a real skew-symmetric M by one symmetric eigh: exp(M) =
    cos(P) + M sinc(P), P = sqrt(-M^2); orthogonal up to eigh accuracy.

    Its own backward: the embedding makes every eigenvalue of -M^2 at
    least doubly degenerate, so eigh's derivative (which divides by
    eigenvalue gaps) is ill-posed on every input. The backward is the
    exact Fréchet adjoint L*(M, G) = L(M^T, G) by the block exponential."""

    generate_vmap_rule = True

    @staticmethod
    def forward(M):
        V, theta, MV = _skew_parts(M)
        # sin(theta) / theta, safe at 0
        sinc = torch.sinc(theta / math.pi)
        return (V * torch.cos(theta)[..., None, :]
                + MV * sinc[..., None, :]) @ V.transpose(-1, -2)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[0])

    @staticmethod
    def backward(ctx, G):
        (M,) = ctx.saved_tensors
        return expm_frechet(M.transpose(-1, -2), G)


def _skew_expm(M):
    return _SkewExpm.apply(M)


def _skew_expm_m1(M):
    """exp(M) - I for skew-symmetric M without the I-subtraction:
    (cos(P) - I) + M sinc(P) with cos(t) - 1 = -2 sin^2(t/2), so every
    term is O(|M|)."""
    V, theta, MV = _skew_parts(M)
    half = torch.sin(0.5 * theta)
    sinc = torch.sinc(theta / math.pi)
    return (V * (-2.0 * half * half)[..., None, :]
            + MV * sinc[..., None, :]) @ V.transpose(-1, -2)


@dataclasses.dataclass(frozen=True)
class DenseSplit(ExponentialSplit):
    """Dense-matrix operator leaf. L: (..., d, d). U: (..., d, d)."""

    max_squarings: int = 16

    supports_batched_dense = True

    def __post_init__(self):
        _check_max_squarings(self.max_squarings)

    def exp(self, L):
        return expm(L, max_squarings=self.max_squarings)

    def exp_m1(self, L):
        return expm_m1(L, max_squarings=self.max_squarings)

    def map_exp(self, U, x):
        return _matvec(U, x)

    def commutator(self, La, Lb):
        return La @ Lb - Lb @ La

    def apply_l(self, L, x):
        return _matvec(L, x)


@dataclasses.dataclass(frozen=True)
class DiagonalSplit(ExponentialSplit):
    """Diagonal operator leaf. L: (..., d) diagonal entries. U: (..., d)."""

    def exp(self, L):
        return torch.exp(L)

    def exp_m1(self, L):
        return torch.expm1(L)

    def map_exp(self, U, x):
        return U * x

    def commutator(self, La, Lb):
        return torch.zeros_like(La)

    def apply_l(self, L, x):
        return L * x


class _CplxSplitBase(ExponentialSplit):
    """Operator algebra shared by the real-pair complex splits: operators
    and states are ``Cplx`` pairs, scalings go through ``cscale_any``
    (complex python coefficients, real tensor dt), and dense propagators
    are embedded real (..., 2d, 2d) matrices applied with one widened real
    matvec."""

    # states are Cplx (re, im) pairs; dense_fast widens them to (B, 2d)
    is_cplx_split = True

    def map_exp(self, U, x):
        return cp.apply_embedded(U, x)

    def commutator(self, La, Lb):
        return cp.cmatmul(La, Lb) - cp.cmatmul(Lb, La)

    def apply_l(self, L, x):
        return cp.cmatvec(L, x)

    def scale_l(self, L, k):
        return cp.cscale_any(L, k)

    def add_l(self, La, Lb):
        return La + Lb

    def lincomb_l(self, Ls, ks):
        acc = cp.cscale_any(Ls[0], ks[0])
        for L, k in zip(Ls[1:], ks[1:]):
            acc = acc + cp.cscale_any(L, k)
        return acc

    def multi_exp(self, L, ks):
        scaled = [cp.cscale_any(L, k) for k in np.asarray(ks)]
        return self.exp(cp.Cplx(torch.stack([s.re for s in scaled]),
                                torch.stack([s.im for s in scaled])))


@dataclasses.dataclass(frozen=True)
class DenseCplxSplit(_CplxSplitBase):
    """Dense complex-matrix leaf in real-pair representation. L: Cplx of
    (..., d, d); exp by the real ring embedding (one real (2d, 2d) expm),
    kept embedded so that applying it is one widened real matvec."""

    max_squarings: int = 16

    supports_batched_dense = True

    def __post_init__(self):
        _check_max_squarings(self.max_squarings)

    def exp(self, L):
        return expm(cp.embed(L), max_squarings=self.max_squarings)

    def exp_m1(self, L):
        return expm_m1(cp.embed(L), max_squarings=self.max_squarings)


@dataclasses.dataclass(frozen=True)
class DiagonalCplxSplit(_CplxSplitBase):
    """Diagonal complex leaf in real-pair representation. L: Cplx (..., d)."""

    def exp(self, L):
        return cp.cexp(L)

    def exp_m1(self, L):
        return cp.cexpm1(L)

    def map_exp(self, U, x):
        return U * x

    def commutator(self, La, Lb):
        return pytree.tree_map(torch.zeros_like, La)

    def apply_l(self, L, x):
        return L * x


@dataclasses.dataclass(frozen=True)
class AntiHermitianCplxSplit(_CplxSplitBase):
    """Unitary anti-Hermitian leaf in real-pair representation: for
    anti-Hermitian L (e.g. -i dt H, H Hermitian) the embedding is
    skew-symmetric, so exp(M) = cos(P) + M sinc(P), P = sqrt(-M^2), by one
    real eigh and three real products, orthogonal up to eigh accuracy.
    Only for real rescalings: complex coefficients break anti-Hermiticity
    and are rejected (use DenseCplxSplit there)."""

    def exp(self, L):
        return _skew_expm(cp.embed(L))

    def exp_m1(self, L):
        return _skew_expm_m1(cp.embed(L))

    def _reject_complex(self, k):
        bad = (isinstance(k, (complex, np.complexfloating))
               and not isinstance(k, numbers.Real))
        if not bad:
            if isinstance(k, torch.Tensor):
                bad = k.is_complex()
            else:
                try:
                    bad = np.iscomplexobj(np.asarray(k))
                except (TypeError, ValueError):
                    bad = False
        if bad:
            raise ValueError(
                "AntiHermitianCplxSplit requires real rescalings: complex "
                "coefficients break anti-Hermiticity — use DenseCplxSplit "
                "for those")

    def scale_l(self, L, k):
        self._reject_complex(k)
        return super().scale_l(L, k)

    def multi_exp(self, L, ks):
        self._reject_complex(ks)
        return super().multi_exp(L, ks)


@dataclasses.dataclass(frozen=True)
class AntiHermitianSplit(ExponentialSplit):
    """Anti-Hermitian operator leaf on complex tensors (L^H = -L), e.g.
    L = -i dt H(t): exp(L) = V diag(e^{-i w}) V^H where i L = V diag(w)
    V^H is Hermitian, unitary up to eigh accuracy."""

    def _eig(self, L):
        w, V = torch.linalg.eigh(1j * L)
        return w, V

    def exp(self, L):
        w, V = self._eig(L)
        phase = torch.exp(-1j * w.to(L.dtype))
        return (V * phase[..., None, :]) @ V.transpose(-1, -2).conj()

    def exp_m1(self, L):
        # e^{-iw} - 1 = -2 sin^2(w/2) - i sin(w): O(|w|) termwise
        w, V = self._eig(L)
        half = torch.sin(0.5 * w)
        phase_m1 = torch.complex(-2.0 * half * half, -torch.sin(w))
        return ((V * phase_m1.to(L.dtype)[..., None, :])
                @ V.transpose(-1, -2).conj())

    def map_exp(self, U, x):
        return _matvec(U, x)

    def commutator(self, La, Lb):
        return La @ Lb - Lb @ La

    def apply_l(self, L, x):
        return _matvec(L, x)

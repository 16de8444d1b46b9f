"""Quadrature utilities, the counterpart of ``vec_ode_tpu/quad.py``: the
Gauss-Legendre node and weight tables on [0, 1] (``tableaus.
GAUSS_LEGENDRE``), function quadrature over the nodes as one
``torch.func.vmap`` batch, and the first-order Magnus averaged operator.
Plain torch, no kernel; the results may be any pytree of tensors (a
``Cplx`` pair too)."""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from .tableaus import GAUSS_LEGENDRE

__all__ = ["gauss_legendre", "fixed_quad", "trapezoid", "averaged_operator"]


def gauss_legendre(n: int) -> Tuple[np.ndarray, np.ndarray]:
    """(nodes, weights) of the n-point Gauss-Legendre rule on [0, 1], n =
    1 .. 5."""
    if n not in GAUSS_LEGENDRE:
        raise ValueError(f"gauss_legendre: unsupported point count {n}")
    return GAUSS_LEGENDRE[n]


def _weighted_sum(w, n: int):
    """sum_i w_i leaf[i] over a leaf's leading node axis."""
    def comb(leaf):
        ws = torch.as_tensor(w, dtype=leaf.dtype, device=leaf.device)
        return torch.sum(ws.reshape((n,) + (1,) * (leaf.ndim - 1)) * leaf,
                         dim=0)
    return comb


def fixed_quad(f: Callable, a, b, n: int = 2):
    """int_a^b f(t) dt by the n-point Gauss-Legendre rule; f maps a scalar
    time to a pytree of tensors, evaluated at the nodes as one vmapped
    batch."""
    c, w = gauss_legendre(n)
    a = torch.as_tensor(a)
    span = torch.as_tensor(b) - a
    ts = torch.stack([a + float(ci) * span for ci in c])
    comb = _weighted_sum(w, n)
    return pytree.tree_map(lambda leaf: comb(leaf) * span.to(leaf.dtype),
                           torch.func.vmap(f)(ts))


def trapezoid(f: Callable, a, b, n: int = 64):
    """The composite trapezoid rule with n panels over [a, b]."""
    a = torch.as_tensor(a)
    span = torch.as_tensor(b) - a
    grid = torch.linspace(0.0, 1.0, n + 1, dtype=torch.promote_types(
        span.dtype, torch.get_default_dtype()), device=span.device)
    vals = torch.func.vmap(f)(a + span * grid)

    def comb(leaf):
        h = (span / n).to(leaf.dtype)
        return h * (0.5 * leaf[0] + torch.sum(leaf[1:-1], dim=0)
                    + 0.5 * leaf[-1])

    return pytree.tree_map(comb, vals)


def averaged_operator(op_fn: Callable, t, dt, n: int = 2):
    """(1 / dt) int_t^{t+dt} A(s) ds by the n-point Gauss-Legendre rule:
    the first-order Magnus averaged operator."""
    c, w = gauss_legendre(n)
    t, dt = torch.as_tensor(t), torch.as_tensor(dt)
    ts = torch.stack([t + float(ci) * dt for ci in c])
    return pytree.tree_map(_weighted_sum(w, n), torch.func.vmap(op_fn)(ts))

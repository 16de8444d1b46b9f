"""Nonlinear models (BASELINE config 2), the counterpart of
``vec_ode_tpu/models/nonlinear.py``: Van der Pol, Lotka-Volterra and the
Brusselator, over states (..., 2)."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class VanDerPol:
    """x'' - mu (1 - x^2) x' + x = 0 as the system y = (x, v)."""

    mu: float = 1.0

    def rhs(self, t, y):
        x, v = y[..., 0], y[..., 1]
        return torch.stack([v, self.mu * (1.0 - x * x) * v - x], dim=-1)


@dataclasses.dataclass(frozen=True)
class LotkaVolterra:
    """Predator-prey: u' = a u - b u v, v' = -c v + d u v, with the
    conserved V = d u - c ln u + b v - a ln v."""

    a: float = 1.5
    b: float = 1.0
    c: float = 3.0
    d: float = 1.0

    def rhs(self, t, y):
        u, v = y[..., 0], y[..., 1]
        return torch.stack([self.a * u - self.b * u * v,
                            -self.c * v + self.d * u * v], dim=-1)

    def invariant(self, y):
        u, v = y[..., 0], y[..., 1]
        return (self.d * u - self.c * torch.log(u)
                + self.b * v - self.a * torch.log(v))


@dataclasses.dataclass(frozen=True)
class Brusselator:
    """u' = A + u^2 v - (B + 1) u, v' = B u - u^2 v."""

    A: float = 1.0
    B: float = 3.0

    def rhs(self, t, y):
        u, v = y[..., 0], y[..., 1]
        return torch.stack([self.A + u * u * v - (self.B + 1.0) * u,
                            self.B * u - u * u * v], dim=-1)

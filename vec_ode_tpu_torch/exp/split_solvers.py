"""Split-operator solvers for dx/dt = (A(t) + B(t)) x, the counterpart of
``vec_ode_tpu/exp/split_solvers.py``. The operator-assembly callback is
``ops_fn(t) -> (La, Lb)``.

``split_midpoint_step`` is the Strang midpoint e^{A dt/2} e^{B dt}
e^{A dt/2} with midpoint sampling; ``strict_reference_compat=True``
reproduces the reference crate's literal behaviour (B at half weight,
sampling at t) for parity experiments. ``split_cfm_step`` is the BAB
commutator-free step over a split.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..ops.dense_chains import ChainTable, Exponent
from . import dense_fast as df
from .cfm import cfm_exp
from .magnus import _DenseBatchedStepper, as_time, sample_nodes
from .protocol import ExponentialSplit


class _SplitBatched(_DenseBatchedStepper):
    """Batched-execution surface for the split solvers: engages when BOTH
    sub-splits are dense leaves of the same representation; the whole
    factor palindrome then runs as one chain per step
    (exp/dense_fast.py)."""

    @property
    def split(self):
        # state widening conventions follow sp_a (both match, enforced)
        return self.sp_a

    def _dense(self) -> bool:
        return (
            getattr(self.sp_a, "supports_batched_dense", False)
            and getattr(self.sp_b, "supports_batched_dense", False)
            and getattr(self.sp_a, "is_cplx_split", False)
            == getattr(self.sp_b, "is_cplx_split", False)
        )

    @property
    def is_batched(self) -> bool:
        if self.batched is not None:
            if self.batched and not self._dense():
                raise ValueError(
                    "batched=True requires BOTH sub-splits to be dense "
                    "leaves of the same representation (DenseSplit / "
                    "DenseCplxSplit)")
            return self.batched
        return self._dense()

    def _pair_node_ops(self, assemble, t_nodes):
        """The embedded samples (2 n, B, D, D) at the node times: the A
        parts of every node, then the B parts, from one stacked
        assemble."""
        la, lb = assemble(torch.cat(t_nodes))
        E = torch.cat([df.embed_node(self.sp_a, la),
                       df.embed_node(self.sp_b, lb)])
        return E.reshape(2 * len(t_nodes), -1, *E.shape[1:])


def split_midpoint_table(strict: bool) -> ChainTable:
    """Nodes (A, B): e^{A dt/2} e^{w_b B dt} e^{A dt/2}, w_b = 1/2 under
    ``strict`` (the reference's half weight)."""
    w_b = 0.5 if strict else 1.0
    return ChainTable(2, [[Exponent((0.5, 0.0)), Exponent((0.0, w_b)),
                           Exponent((0.5, 0.0))]])


def split_cfm_table(rho, sigma) -> ChainTable:
    """Nodes (A_0..A_{J-1}, B_0..B_{J-1}): the BAB factor sequence
    expB(sigma_0), expA(rho_0), ..., expA(rho_{s-1}), expB(sigma_s)."""
    rho, sigma = np.asarray(rho, np.float64), np.asarray(sigma, np.float64)
    J = rho.shape[1]
    zeros = (0.0,) * J
    rows = []
    for i in range(rho.shape[0]):
        rows.append(Exponent(zeros + tuple(sigma[i])))
        rows.append(Exponent(tuple(rho[i]) + zeros))
    rows.append(Exponent(zeros + tuple(sigma[-1])))
    return ChainTable(2 * J, [rows])


def split_midpoint_step(ops_fn, sp_a, sp_b, t, x, dt, *,
                        strict_reference_compat=False):
    """Strang-type split midpoint step."""
    t, dt = as_time(t), as_time(dt)
    if strict_reference_compat:
        la, lb = ops_fn(t)                       # the reference samples at t
        b_weight = 0.5 * dt                      # and halves B's weight
    else:
        la, lb = ops_fn(t + 0.5 * dt)            # midpoint sampling
        b_weight = dt
    ua = sp_a.exp(sp_a.scale_l(la, 0.5 * dt))
    ub = sp_b.exp(sp_b.scale_l(lb, b_weight))
    y = sp_a.map_exp(ua, x)
    y = sp_b.map_exp(ub, y)
    y = sp_a.map_exp(ua, y)
    return y, None


def _check_split_cfm(rho, sigma, c):
    if rho.ndim != 2 or sigma.ndim != 2:
        raise ValueError(
            "split_cfm: rho and sigma must be 2-D (rows of quadrature "
            f"coefficients); got shapes {rho.shape} and {sigma.shape} — "
            "wrap a single row as ((...),)")
    if rho.shape[1] != len(c) or sigma.shape[1] != len(c):
        raise ValueError("split_cfm: incompatible array dimensions")
    if sigma.shape[0] != rho.shape[0] + 1:
        raise ValueError("split_cfm: sigma must have one more row than rho")


def split_cfm_step(ops_fn, sp_a, sp_b, t, x, dt, rho, sigma, c):
    """BAB CFM step over a split.

    rho: (s, k) A-coefficients; sigma: (s+1, k) B-coefficients; c: (k,)
    nodes. x <- expB(sigma[s]) expA(rho[s-1]) ... expB(sigma[1])
    expA(rho[0]) expB(sigma[0]) x, each exponent dt * sum_j coeff[j]
    L(t_j)."""
    rho, sigma, c = np.asarray(rho), np.asarray(sigma), np.asarray(c)
    _check_split_cfm(rho, sigma, c)
    t, dt = as_time(t), as_time(dt)
    nodes = sample_nodes(ops_fn, [t + float(ci) * dt for ci in c])
    va = [n[0] for n in nodes]
    vb = [n[1] for n in nodes]
    y = x
    for i in range(rho.shape[0]):
        y = cfm_exp(sp_b, y, dt, vb, sigma[i])
        y = cfm_exp(sp_a, y, dt, va, rho[i])
    y = cfm_exp(sp_b, y, dt, vb, sigma[-1])
    return y, None


@dataclasses.dataclass(frozen=True)
class SplitMidpoint(_SplitBatched):
    """Fixed-step split midpoint. Over dense pairs, ensembles execute
    natively batched (see _SplitBatched)."""

    sp_a: ExponentialSplit
    sp_b: ExponentialSplit
    strict_reference_compat: bool = False
    ops_fn: Callable = None
    batched: Optional[bool] = None   # None = auto (see _SplitBatched)
    max_squarings: int = 16

    nfev_per_step = 1

    def make_step_fn(self, ops_fn=None, params=None):
        fn = ops_fn if ops_fn is not None else self.ops_fn
        assemble = self._assembler(fn, params)
        strict = self.strict_reference_compat
        table = split_midpoint_table(strict)

        def step_fn(t, x, dt):
            if self._batched_mode(t):
                ts = t if strict else t + 0.5 * dt
                return df.run_batched_chains(
                    self.sp_a, x, dt, self._pair_node_ops(assemble, [ts]),
                    table, adaptive=False,
                    max_squarings=self.max_squarings)
            self._scalar_guard(params)
            return split_midpoint_step(fn, self.sp_a, self.sp_b, t, x, dt,
                                       strict_reference_compat=strict)

        return step_fn


@dataclasses.dataclass(frozen=True)
class SplitCFM(_SplitBatched):
    """CFM-over-splits stepper. Over dense pairs, ensembles execute
    natively batched (see _SplitBatched)."""

    sp_a: ExponentialSplit
    sp_b: ExponentialSplit
    rho: tuple
    sigma: tuple
    c: tuple
    ops_fn: Callable = None
    batched: Optional[bool] = None   # None = auto (see _SplitBatched)
    max_squarings: int = 16

    @property
    def nfev_per_step(self) -> int:
        return len(self.c)

    def make_step_fn(self, ops_fn=None, params=None):
        fn = ops_fn if ops_fn is not None else self.ops_fn
        assemble = self._assembler(fn, params)
        rho, sigma, c = (np.asarray(a) for a in (self.rho, self.sigma,
                                                 self.c))
        _check_split_cfm(rho, sigma, c)
        table = split_cfm_table(rho, sigma)

        def step_fn(t, x, dt):
            if self._batched_mode(t):
                ts = [t + float(cj) * dt for cj in c]
                return df.run_batched_chains(
                    self.sp_a, x, dt, self._pair_node_ops(assemble, ts),
                    table, adaptive=False,
                    max_squarings=self.max_squarings)
            self._scalar_guard(params)
            return split_cfm_step(fn, self.sp_a, self.sp_b, t, x, dt,
                                  self.rho, self.sigma, self.c)

        return step_fn

"""Commutator-free Magnus (CFM) steppers, the counterpart of
``vec_ode_tpu/exp/cfm.py``. A CFM step samples A(t) at quadrature nodes
t + c_j dt and applies s exponentials of linear combinations of the
samples:

    x_i = exp(dt * sum_j alpha[i][j] A(t_j)) x_{i-1}

The adaptive pair runs a lower-order pass (``alpha_err``) from the same
samples, err = x_err - xf.

Coefficient sets:
  * CFM4: alpha = CFM_R4_J2_GL (2 exponentials x 2 Gauss-Legendre nodes,
    order 4), alpha_err = CFM_R2_J1_GL (1 exponential, order 2).
  * CFM4_BLANES17: alpha = BLANES17_R4_J4 (4 exponentials x 3 nodes) with
    a one-exponential order-2 error pass.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np

from .. import comp, lc
from .. import tableaus as tb
from ..ops.dense_chains import ChainTable, Exponent
from . import dense_fast as df
from .magnus import _DenseBatchedStepper, as_time, sample_nodes
from .protocol import ExponentialSplit, index_u


def cfm_exp(split, x, dt, samples, a_row):
    """One CFM exponential: x <- exp(dt * sum_j a_j M_j) x. ``samples`` is
    a list of operator pytrees (A at the quadrature nodes)."""
    k = split.lincomb_l(samples, list(a_row))
    return split.map_exp(split.exp(split.scale_l(k, dt)), x)


def cfm_step(op_fn, split: ExponentialSplit, t, x, dt, alpha: np.ndarray,
             c: np.ndarray, alpha_err: Optional[np.ndarray]):
    """s-exponential CFM step with optional embedded error pass. Every
    exponential's operator depends only on the quadrature samples, so all
    s + s_err exponentials come from ONE stacked ``exp_many`` and only the
    propagator applications run in sequence."""
    t, dt = as_time(t), as_time(dt)
    alpha = np.asarray(alpha)
    samples = sample_nodes(op_fn, [t + float(ci) * dt for ci in np.asarray(c)])

    def row_op(a_row):
        return split.scale_l(split.lincomb_l(samples, list(a_row)), dt)

    n_main = alpha.shape[0]
    rows = [row_op(alpha[i]) for i in range(n_main)]
    if alpha_err is not None:
        alpha_err = np.asarray(alpha_err)
        rows += [row_op(alpha_err[i]) for i in range(alpha_err.shape[0])]
    u_all = split.exp_many(rows) if len(rows) > 1 else None

    def u_at(i):
        return index_u(u_all, i) if u_all is not None else split.exp(rows[0])

    xf = x
    for i in range(n_main):
        xf = split.map_exp(u_at(i), xf)
    if alpha_err is None:
        return xf, None
    xe = x
    for i in range(alpha_err.shape[0]):
        xe = split.map_exp(u_at(n_main + i), xe)
    return xf, lc.sub(xe, xf)


def cfm_step_comp(op_fn, split: ExponentialSplit, t, x, dt, alpha, c,
                  alpha_err, lo):
    """Compensated CFM step (``comp.py``): the main and the error chains
    in increment form over ``exp_m1``, the estimate their difference, the
    advance folded into the (x, lo) pair."""
    t, dt = as_time(t), as_time(dt)
    alpha = np.asarray(alpha)
    samples = sample_nodes(op_fn, [t + float(ci) * dt for ci in np.asarray(c)])

    def row_op(a_row):
        return split.scale_l(split.lincomb_l(samples, list(a_row)), dt)

    n_main = alpha.shape[0]
    rows = [row_op(alpha[i]) for i in range(n_main)]
    if alpha_err is not None:
        alpha_err = np.asarray(alpha_err)
        rows += [row_op(alpha_err[i]) for i in range(alpha_err.shape[0])]
    phis = split.exp_many_m1(rows) if len(rows) > 1 else None

    def phi_at(i):
        return (index_u(phis, i) if phis is not None
                else split.exp_m1(rows[0]))

    D = comp.chain_increment(split.map_exp,
                             [phi_at(i) for i in range(n_main)], x)
    err = None
    if alpha_err is not None:
        De = comp.chain_increment(
            split.map_exp,
            [phi_at(n_main + i) for i in range(alpha_err.shape[0])], x)
        err = lc.sub(De, D)
    hi, lo2 = comp.update(x, lo, D)
    return hi, err, lo2


def cfm_table(alpha, alpha_err=None) -> ChainTable:
    """Chain 0 the rows of ``alpha``, chain 1 the rows of ``alpha_err``,
    each row one exponent dt * sum_j a_j M_j. The chains may differ in
    length (no zero-row padding); an all-zero row stays the exponent 0."""
    alpha = np.asarray(alpha, np.float64)
    chains = [[Exponent(row) for row in alpha]]
    if alpha_err is not None:
        chains.append([Exponent(row)
                       for row in np.asarray(alpha_err, np.float64)])
    return ChainTable(alpha.shape[1], chains)


@dataclasses.dataclass(frozen=True)
class CFM(_DenseBatchedStepper):
    """Generic CFM stepper from coefficient matrices.

    alpha: (s, k), s exponentials over k quadrature samples.
    c: (k,), quadrature nodes on [0, 1].
    alpha_err: optional (s_err, k) embedded lower-order pass.

    Over a dense split, ensembles execute natively batched (see
    exp/magnus.py:_DenseBatchedStepper)."""

    split: ExponentialSplit
    alpha: tuple
    c: tuple
    alpha_err: Optional[tuple] = None
    op_fn: Callable = None
    batched: Optional[bool] = None   # None = auto (see _DenseBatchedStepper)
    max_squarings: int = 16
    norm: Optional[object] = None    # declared WeightedNorm (batched tier)
    compensated: bool = False        # double-word state pair (comp.py)

    def __post_init__(self):
        self._check_fields()

    @property
    def nfev_per_step(self) -> int:
        return len(self.c)

    def make_step_fn(self, op_fn=None, params=None):
        fn = op_fn if op_fn is not None else self.op_fn
        assemble = self._assembler(fn, params)
        alpha = np.asarray(self.alpha)
        c = np.asarray(self.c)
        alpha_err = (None if self.alpha_err is None
                     else np.asarray(self.alpha_err))
        table = cfm_table(alpha, alpha_err)

        def step_core(t, x, dt, lo=None):
            if self._batched_mode(t):
                ts = [t + float(cj) * dt for cj in c]
                return df.run_batched_chains(
                    self.split, x, dt, self._node_ops(assemble, ts), table,
                    adaptive=alpha_err is not None,
                    max_squarings=self.max_squarings,
                    wnorm=self._wnorm_parts(x), lo=lo)
            self._scalar_guard(params)
            if lo is not None:
                return cfm_step_comp(fn, self.split, t, x, dt, alpha, c,
                                     alpha_err, lo)
            return cfm_step(fn, self.split, t, x, dt, alpha, c, alpha_err)

        return self._wrap_comp(step_core)


def _tupled(a):
    return tuple(map(tuple, np.asarray(a)))


def CFM4(split: ExponentialSplit, op_fn: Callable = None, *,
         adaptive: bool = True, **kw) -> CFM:
    """The order 4/2 pair on 2-node Gauss-Legendre. ``adaptive=False``
    drops the error pass. Extra kwargs (batched / max_squarings /
    norm) pass through to :class:`CFM`."""
    return CFM(
        split=split,
        alpha=_tupled(tb.CFM_R4_J2_GL),
        c=tuple(tb.C_GAUSS_LEGENDRE_4),
        alpha_err=_tupled(tb.CFM_R2_J1_GL) if adaptive else None,
        op_fn=op_fn,
        **kw,
    )


def CFM4_BLANES17(split: ExponentialSplit, op_fn: Callable = None, *,
                  adaptive: bool = True, **kw) -> CFM:
    """Blanes' 4-exponential order-4 CFM on 3-node Gauss-Legendre, with an
    order-2 error pass of one exponential of the full 3-node quadrature
    of A (weights 5/18, 4/9, 5/18)."""
    return CFM(
        split=split,
        alpha=_tupled(tb.BLANES17_R4_J4),
        c=tuple(tb.C_GAUSS_LEGENDRE_6),
        alpha_err=_tupled(np.array([[5 / 18, 4 / 9, 5 / 18]]))
        if adaptive
        else None,
        op_fn=op_fn,
        **kw,
    )

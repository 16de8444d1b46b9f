"""Operator-splitting combinators, the counterpart of
``vec_ode_tpu/exp/splits.py``. Each composes two child splits over the
direct-sum operator L = (La, Lb), a tuple: ``exp`` returns a tuple of
child propagators (stacked by a child's ``multi_exp`` where a sequence
has several weights) and ``map_exp`` applies the factor sequence:

* :class:`CommutativeSplit`: U = (UA, UB), x -> UB UA x;
* :class:`StrangSplit`: e^{B/2} e^{A} e^{B/2};
* :class:`SemiComplexO4Split`: the 9-factor palindrome with complex B
  weights;
* :class:`TripleJumpSplit`: the 7-factor complex triple jump;
* :class:`RKNR4Split`: the 13-factor real RKN order-4 sequence.

The coefficients are ``tableaus.RKN_O4_*``, ``TJ_O4_*`` and
``SEMI_COMPLEX_O4_*``. A composite operator cannot be batched per
trajectory, so the generic steppers over these splits run on the scalar
tier (``api.solve_linear``) and on the vmapped tier of
``ensemble_solve``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.utils import _pytree as pytree

from .. import lc
from .. import tableaus as tb
from .protocol import ExponentialSplit, index_u


def _stack(us):
    return pytree.tree_map(lambda *xs: torch.stack(xs), *us)


@dataclasses.dataclass(frozen=True)
class _Pair(ExponentialSplit):
    sp_a: ExponentialSplit
    sp_b: ExponentialSplit

    def scale_l(self, L, k):
        la, lb = L
        return (self.sp_a.scale_l(la, k), self.sp_b.scale_l(lb, k))

    def add_l(self, La, Lb):
        return (self.sp_a.add_l(La[0], Lb[0]), self.sp_b.add_l(La[1], Lb[1]))

    def commutator(self, La, Lb):
        # the direct sum of the children's commutators
        return (self.sp_a.commutator(La[0], Lb[0]),
                self.sp_b.commutator(La[1], Lb[1]))

    def apply_l(self, L, x):
        # the direct-sum operator acts as the SUM of its parts: (A + B) x
        la, lb = L
        return lc.add(self.sp_a.apply_l(la, x), self.sp_b.apply_l(lb, x))

    def multi_exp(self, L, ks):
        # one exponential per scaling: the protocol's stacked default would
        # put a nested child's own stacking axis in front of this one
        return _stack([self.exp(self.scale_l(L, k)) for k in np.asarray(ks)])

    def exp_many(self, Ls):
        # per operator, for the same reason as multi_exp
        return _stack([self.exp(L) for L in Ls])


class CommutativeSplit(_Pair):
    """exp(A + B) = exp(A) exp(B) for commuting A, B."""

    def exp(self, L):
        la, lb = L
        return (self.sp_a.exp(la), self.sp_b.exp(lb))

    def map_exp(self, U, x):
        ua, ub = U
        return self.sp_b.map_exp(ub, self.sp_a.map_exp(ua, x))

    def multi_exp(self, L, ks):
        la, lb = L
        return (self.sp_a.multi_exp(la, ks), self.sp_b.multi_exp(lb, ks))


class StrangSplit(_Pair):
    """Strang composition e^{B/2} e^{A} e^{B/2}."""

    def exp(self, L):
        la, lb = L
        return (self.sp_a.exp(la),
                self.sp_b.exp(self.sp_b.scale_l(lb, 0.5)))

    def map_exp(self, U, x):
        ua, ub = U
        y = self.sp_a.map_exp(ua, self.sp_b.map_exp(ub, x))
        return self.sp_b.map_exp(ub, y)

    def multi_exp(self, L, ks):
        la, lb = L
        return (self.sp_a.multi_exp(la, ks),
                self.sp_b.multi_exp(self.sp_b.scale_l(lb, 0.5), ks))


class SemiComplexO4Split(_Pair):
    """Semi-complex order 4: four equal A factors (1/4 each) interleaved
    with the complex-weight B palindrome b0 b1 b2 b1 b0."""

    def exp(self, L):
        la, lb = L
        ua = self.sp_a.exp(self.sp_a.scale_l(la, 0.25))
        ub = self.sp_b.multi_exp(lb, tb.SEMI_COMPLEX_O4_B)   # stacked (3, ..)
        return (ua, ub)

    def map_exp(self, U, x):
        ua, ub = U
        b = [index_u(ub, k) for k in range(3)]
        y = self.sp_a.map_exp(ua, self.sp_b.map_exp(b[0], x))
        y = self.sp_a.map_exp(ua, self.sp_b.map_exp(b[1], y))
        y = self.sp_a.map_exp(ua, self.sp_b.map_exp(b[2], y))
        y = self.sp_a.map_exp(ua, self.sp_b.map_exp(b[1], y))
        return self.sp_b.map_exp(b[0], y)


class TripleJumpSplit(_Pair):
    """Complex triple-jump order 4."""

    def exp(self, L):
        la, lb = L
        return (self.sp_a.multi_exp(la, tb.TJ_O4_A),    # stacked (2, ...)
                self.sp_b.multi_exp(lb, tb.TJ_O4_B))    # stacked (2, ...)

    def map_exp(self, U, x):
        ua, ub = U
        a = [index_u(ua, k) for k in range(2)]
        b = [index_u(ub, k) for k in range(2)]
        y = self.sp_a.map_exp(a[0], self.sp_b.map_exp(b[0], x))
        y = self.sp_a.map_exp(a[1], self.sp_b.map_exp(b[1], y))
        y = self.sp_a.map_exp(a[0], self.sp_b.map_exp(b[1], y))
        return self.sp_b.map_exp(b[0], y)


class RKNR4Split(_Pair):
    """Blanes-Moan RKN order 4 (BAB), 13 factors."""

    def exp(self, L):
        la, lb = L
        return (self.sp_a.multi_exp(la, tb.RKN_O4_A),   # stacked (3, ...)
                self.sp_b.multi_exp(lb, tb.RKN_O4_B))   # stacked (4, ...)

    def map_exp(self, U, x):
        ua, ub = U
        a = [index_u(ua, k) for k in range(3)]
        b = [index_u(ub, k) for k in range(4)]
        y = self.sp_a.map_exp(a[0], self.sp_b.map_exp(b[0], x))
        y = self.sp_a.map_exp(a[1], self.sp_b.map_exp(b[1], y))
        y = self.sp_a.map_exp(a[2], self.sp_b.map_exp(b[2], y))
        y = self.sp_a.map_exp(a[2], self.sp_b.map_exp(b[3], y))
        y = self.sp_a.map_exp(a[1], self.sp_b.map_exp(b[2], y))
        y = self.sp_a.map_exp(a[0], self.sp_b.map_exp(b[1], y))
        return self.sp_b.map_exp(b[0], y)

"""Compensated (double-word) state arithmetic, the counterpart of
``vec_ode_tpu/comp.py``.

The state is carried as a renormalized pair (hi, lo) with fl(hi + lo) ==
hi. Steppers compute the per-step INCREMENT dy (never the full next
state), whose rounding is O(eps |dy|), and fold it into the pair with
TwoSum and a renormalization, so that n steps in float32 do not drift by
~n eps |y|. Exponential steppers run their chains in increment form over
``ops.expm.expm_m1`` (phi = e^O - I), and their embedded error estimates
become differences of increments, whose noise floor is eps |dy| instead
of eps |y|.

The ``lo`` word rides the driver's stepper carry (``step_fn(t, x, dt, lo)
-> (x_next, err, lo_next)``): the driver, events, norms and the save grid
see the plain ``hi`` state; a rejected step leaves the carry as it was.

Eager torch runs each operation as written and rounds it on its own (it
neither reassociates nor contracts a product and a sum into an FMA), so
the transforms hold. Nothing here may go through ``torch.compile`` or a
fused kernel that could contract them.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch
from torch.utils import _pytree as pytree

from . import lc

Pytree = Any


def two_sum(a, b):
    """Knuth's TwoSum: s = fl(a + b) and the exact residual e, a + b == s
    + e, for any magnitudes; branchless, 6 operations."""
    s = a + b
    bp = s - a
    e = (a - (s - bp)) + (b - bp)
    return s, e


def _update_leaf(hi, lo, d):
    """Fold the increment d into the pair: TwoSum, then renormalize
    (Fast2Sum), hi the correctly rounded value of the running sum."""
    s, e = two_sum(hi, d)
    lo = lo + e
    hi2 = s + lo
    lo2 = lo - (hi2 - s)
    return hi2, lo2


def update(hi: Pytree, lo: Pytree, d: Pytree) -> Tuple[Pytree, Pytree]:
    """(hi, lo) <- (hi, lo) + d over matching pytrees; fl(hi' + lo') ==
    hi'."""
    h_leaves, spec = pytree.tree_flatten(hi)
    pairs = [_update_leaf(h, l, dd) for h, l, dd in
             zip(h_leaves, pytree.tree_leaves(lo), pytree.tree_leaves(d))]
    return (pytree.tree_unflatten([p[0] for p in pairs], spec),
            pytree.tree_unflatten([p[1] for p in pairs], spec))


def zero_lo(x: Pytree) -> Pytree:
    """The initial residual word: zeros shaped like the state."""
    return pytree.tree_map(torch.zeros_like, x)


def chain_increment(map_exp, phis, x: Pytree) -> Pytree:
    """The increment D = U_n ... U_1 x - x of a propagator chain with U_i
    = I + phi_i, as D <- D + phi_i (x + D), i = 1..n: every term is
    O(|D|), so the rounding of x + D enters only times |phi| ~ |dy| / |y|.
    ``map_exp(phi, v)`` applies one phi (a split's propagator action)."""
    D = map_exp(phis[0], x)
    for phi in phis[1:]:
        D = lc.add(D, map_exp(phi, lc.add(x, D)))
    return D

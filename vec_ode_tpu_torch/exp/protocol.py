"""The exponential-split operator protocol, the counterpart of
``vec_ode_tpu/exp/protocol.py``: an ``ExponentialSplit`` knows how to
exponentiate a linear operator L and apply the propagator U to a state x.

Splits are stateless dataclasses of pure functions; operators and
propagators are tensors or pytrees of tensors (``Cplx`` pairs).
``multi_exp`` and ``exp_many`` stack their operators on a new leading
axis and take ONE batched exponential; ``index_u`` selects a result.
"""

from __future__ import annotations

from typing import Any

import torch
from torch.utils import _pytree as pytree

from .. import lc

Pytree = Any


class ExponentialSplit:
    """Base protocol. L: operator pytree. U: propagator pytree."""

    def exp(self, L: Pytree) -> Pytree:
        raise NotImplementedError

    def map_exp(self, U: Pytree, x: Pytree) -> Pytree:
        raise NotImplementedError

    def scale_l(self, L: Pytree, k) -> Pytree:
        """k * L."""
        return lc.scale(L, k)

    def add_l(self, La: Pytree, Lb: Pytree) -> Pytree:
        return lc.add(La, Lb)

    def lincomb_l(self, Ls, ks) -> Pytree:
        return lc.lincomb(Ls, ks)

    def multi_exp(self, L: Pytree, ks) -> Pytree:
        """Stacked exp(k_i * L) for a vector of scalings ks: the rescaled
        operators on a new leading axis, one batched exponential. The
        operator keeps its width; complex scalings make a real operator
        complex of the same width."""
        def stack_leaf(a):
            k = torch.as_tensor(ks, device=a.device)
            ld = a.dtype
            if k.is_complex() and not a.is_complex():
                ld = (torch.complex64 if torch.finfo(ld).bits == 32
                      else torch.complex128)
            k = k.reshape(k.shape + (1,) * a.ndim).to(ld)
            return k * a[None].to(ld)

        return self.exp(pytree.tree_map(stack_leaf, L))

    def exp_many(self, Ls) -> Pytree:
        """Stacked exp of several same-structure operators: one batched
        exponential over a new leading axis (len(Ls)); select results with
        :func:`index_u`. The steppers that need k propagators per step
        (Magnus-4's pair, CFM's rows) use it."""
        stacked = pytree.tree_map(lambda *leaves: torch.stack(leaves), *Ls)
        return self.exp(stacked)

    def exp_m1(self, L: Pytree) -> Pytree:
        """phi = exp(L) - I with relative accuracy (no I-subtraction), in
        a propagator's representation, so ``map_exp(phi, x)`` is the state
        increment (U - I) x."""
        raise NotImplementedError(
            f"{type(self).__name__} does not define exp_m1 — the "
            "increment form needs a dense, diagonal or anti-Hermitian leaf")

    def exp_many_m1(self, Ls) -> Pytree:
        """Stacked :meth:`exp_m1` of several same-structure operators."""
        stacked = pytree.tree_map(lambda *leaves: torch.stack(leaves), *Ls)
        return self.exp_m1(stacked)

    def commutator(self, La: Pytree, Lb: Pytree) -> Pytree:
        """[La, Lb]."""
        raise NotImplementedError(
            f"{type(self).__name__} does not define a commutator")

    def apply_l(self, L: Pytree, x: Pytree) -> Pytree:
        """L @ x, the operator action itself (dx/dt at state x)."""
        raise NotImplementedError(
            f"{type(self).__name__} does not define apply_l")


def index_u(U: Pytree, k: int) -> Pytree:
    """Select the k-th propagator from a stacked multi_exp result."""
    return pytree.tree_map(lambda a: a[k], U)

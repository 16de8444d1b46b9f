"""Vector-space helpers over states that are tensors or ``Cplx`` pairs
(the parts of ``vec_ode_tpu/lc.py`` the batched driver uses)."""

from __future__ import annotations

import torch
from torch.utils import _pytree as pytree


def norm_l2(v) -> torch.Tensor:
    """Flat L2 norm over all leaves."""
    return torch.sqrt(sum(torch.sum(a * a) for a in pytree.tree_leaves(v)))


def norm_l2_batched(v) -> torch.Tensor:
    """Per-trajectory L2 norm: reduce every axis of each leaf except the
    leading batch axis."""
    acc = None
    for a in pytree.tree_leaves(v):
        s = torch.sum(a * a, dim=tuple(range(1, a.ndim)))
        acc = s if acc is None else acc + s
    return torch.sqrt(acc)


def tree_where(mask: torch.Tensor, a, b):
    """Select ``a`` where ``mask`` else ``b``, leaf by leaf, broadcasting
    the (batched) mask against each leaf's leading axes."""

    def sel(x, y):
        extra = x.ndim - mask.ndim
        if extra < 0:
            raise ValueError(
                f"tree_where: leaf of shape {tuple(x.shape)} has lower rank "
                f"than the mask {tuple(mask.shape)}; batched selects need "
                "every leaf to carry the batch axes"
            )
        return torch.where(mask.reshape(mask.shape + (1,) * extra), x, y)

    return pytree.tree_map(sel, a, b)

"""Checkpoint and resume for long runs, the counterpart of
``vec_ode_tpu/utils/checkpointing.py``: the driver's carry
(``driver.IntState``) is a pytree of tensors, so it is saved leaf by leaf
with ``torch.save`` and ``driver.resume`` continues from the loaded one.
The tensors are saved as they lie (their device and type with them) and
loaded onto the template's device.
"""

from __future__ import annotations

import pathlib
from typing import Optional

import torch
from torch.utils import _pytree as pytree

from ..driver import IntState


def _ckpt_path(path) -> pathlib.Path:
    """APPEND ``.pt`` (``with_suffix`` would replace a dotted name's tail:
    'ckpt.step100' and 'ckpt.step200' would collide on 'ckpt.pt'), as the
    JAX package's ``_npz_path`` appends ``.npz``."""
    path = pathlib.Path(path)
    if path.suffix == ".pt":
        return path
    return pathlib.Path(str(path) + ".pt")


def save_state(path, state: IntState) -> None:
    """Persist an integration carry: its leaves, in order, with
    ``torch.save``."""
    leaves = pytree.tree_leaves(state)
    torch.save({"leaves": [a.detach() if isinstance(a, torch.Tensor) else a
                           for a in leaves]}, _ckpt_path(path))


def load_state(path, like: Optional[IntState] = None) -> IntState:
    """Restore a carry saved by :func:`save_state` into the structure of
    the template ``like`` (an ``IntState`` of the same solve, e.g. from
    ``driver.init_state``), each leaf in the template's type and on its
    device; a different number of leaves raises."""
    if like is None:
        raise ValueError("load_state requires a template `like` (an "
                         "IntState of the same structure)")
    leaves = torch.load(_ckpt_path(path), map_location="cpu",
                        weights_only=True)["leaves"]
    like_leaves, spec = pytree.tree_flatten(like)
    if len(leaves) != len(like_leaves):
        raise ValueError(
            f"checkpoint has {len(leaves)} leaves but the template has "
            f"{len(like_leaves)}: structure mismatch")
    return pytree.tree_unflatten(
        [a.to(device=ref.device, dtype=ref.dtype)
         if isinstance(ref, torch.Tensor) else a
         for a, ref in zip(leaves, like_leaves)], spec)

"""Vector-space helpers over pytree states (tensors, ``Cplx`` pairs,
tuples, dicts): scale, add, sub, axpy, lincomb, ``zeros_like``, the l2 /
max / rms norms, ``vdot``, ``tree_where``, and the declared error norm
``WeightedNorm`` with ``TracedNorm`` / ``try_trace_norm`` for opaque
norms (the counterpart of ``vec_ode_tpu/lc.py``). The norms
are real for complex leaves: they reduce |a|^2 = real(a conj(a))."""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch
from torch.utils import _pytree as pytree


def _match_scalar(k, leaf):
    """A coefficient aligned with a leaf: python scalars pass through; a
    tensor is cast to the leaf's dtype (an f64 time step never widens an
    f32 state) and a batched one (leading batch axes only) gets trailing
    axes so that it scales per trajectory."""
    if isinstance(k, (int, float, complex)):
        return k
    k = torch.as_tensor(k, device=leaf.device)
    if k.dtype != leaf.dtype:
        k = k.to(leaf.dtype)
    if 0 < k.ndim < leaf.ndim:
        k = k.reshape(k.shape + (1,) * (leaf.ndim - k.ndim))
    return k


def scale(v, k):
    """k * v."""
    return pytree.tree_map(lambda a: a * _match_scalar(k, a), v)


def add(v, u):
    """v + u."""
    return pytree.tree_map(torch.add, v, u)


def sub(v, u):
    """v - u."""
    return pytree.tree_map(torch.sub, v, u)


def axpy(k, u, v):
    """v + k * u."""
    return pytree.tree_map(lambda a, b: a + _match_scalar(k, b) * b, v, u)


def lincomb(vs, ks):
    """sum_i ks[i] * vs[i] over same-structure pytrees, summed in order."""
    if len(vs) == 0 or len(ks) == 0:
        raise ValueError("lincomb: sequences cannot be empty")
    if len(vs) != len(ks):
        raise ValueError("lincomb: sequences must be the same length")

    def leaf_comb(*leaves):
        acc = leaves[0] * _match_scalar(ks[0], leaves[0])
        for k, leaf in zip(ks[1:], leaves[1:]):
            acc = acc + _match_scalar(k, leaf) * leaf
        return acc

    return pytree.tree_map(leaf_comb, *vs)


def zeros_like(v):
    return pytree.tree_map(torch.zeros_like, v)


def _abs2(a: torch.Tensor) -> torch.Tensor:
    """|a|^2, real: a * a for a real leaf (the same bits as before complex
    leaves were taken), real(a conj(a)) for a complex one."""
    return torch.real(a * torch.conj(a)) if a.is_complex() else a * a


def _reduce_leaves(v, leaf_fn, combine):
    vals = [leaf_fn(a) for a in pytree.tree_leaves(v)]
    acc = vals[0]
    for x in vals[1:]:
        acc = combine(acc, x)
    return acc


def norm_l2(v) -> torch.Tensor:
    """Flat L2 norm over all leaves (real, also for complex leaves)."""
    return torch.sqrt(_reduce_leaves(v, lambda a: torch.sum(_abs2(a)),
                                     torch.add))


def norm_max(v) -> torch.Tensor:
    """max |v_i| over all leaves."""
    return _reduce_leaves(v, lambda a: torch.amax(torch.abs(a)),
                          torch.maximum)


def norm_l2_batched(v) -> torch.Tensor:
    """Per-trajectory L2 norm: reduce every axis of each leaf except the
    leading batch axis."""
    acc = None
    for a in pytree.tree_leaves(v):
        # torch reads an empty dim tuple as "every axis": a (B,) leaf is
        # one value a trajectory and takes no reduction
        axes = tuple(range(1, a.ndim))
        s = torch.sum(_abs2(a), dim=axes) if axes else _abs2(a)
        acc = s if acc is None else acc + s
    return torch.sqrt(acc)


def norm_rms(v) -> torch.Tensor:
    """RMS norm: L2 / sqrt(n), n the number of entries over all leaves."""
    n = sum(a.numel() for a in pytree.tree_leaves(v))
    n2 = norm_l2(v)
    return n2 / torch.sqrt(torch.tensor(float(n), dtype=n2.dtype,
                                        device=n2.device))


def vdot(u, v) -> torch.Tensor:
    """<u, v> with conjugation on u, summed over all leaves."""
    return _reduce_leaves(
        pytree.tree_map(lambda a, b: torch.sum(torch.conj(a) * b), u, v),
        lambda a: a, torch.add)


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


@dataclasses.dataclass(frozen=True)
class WeightedNorm:
    """A declared error norm that the kernels execute natively: weighted
    l2 / rms / max over the REAL components of the state (a ``Cplx``
    state's re and im blocks share the weights).

    kind: "l2"  -> sqrt(sum (w e)^2)
          "rms" -> l2 / sqrt(n_real_components)
          "max" -> max |w e|

    ``weights``: None (all ones), one array broadcast against each leaf's
    trailing axis (stored as a tuple so the declaration stays hashable),
    or a pytree matching the error's structure, one array per leaf (kept
    as it is; the kernels cannot lay it out, so the natively batched
    steppers refuse it, as the JAX package's do). Callable per trajectory;
    ``.batched`` reduces per trajectory over a leading batch axis.
    """

    kind: str = "l2"
    weights: Any = None

    def __post_init__(self):
        if self.kind not in ("l2", "rms", "max"):
            raise ValueError(
                f"WeightedNorm kind must be l2|rms|max, got {self.kind!r}")
        if self.weights is None:
            return
        try:
            w = np.asarray(self.weights, np.float64)
        except (TypeError, ValueError):
            return  # a pytree of per-leaf arrays stays as it is
        if w.ndim == 1:
            object.__setattr__(self, "weights", tuple(w.tolist()))
        elif w.ndim == 0:
            object.__setattr__(self, "weights", float(w))

    def _flat(self) -> bool:
        """Whether the weights are one array (a tuple of floats) or one
        number, broadcast to every leaf, rather than a pytree."""
        w = self.weights
        return isinstance(w, float) or (isinstance(w, tuple) and all(
            isinstance(v, float) for v in w))

    def _weighted_leaves(self, err):
        """(the weighted leaves, the leaves): pytree weights leaf by leaf
        where their structure matches the error's, else one array
        broadcast to every leaf."""
        leaves = pytree.tree_leaves(err)
        if self.weights is None:
            return leaves, leaves

        def mul(a, w):
            return a * torch.as_tensor(np.asarray(w) if not isinstance(
                w, torch.Tensor) else w, dtype=a.dtype, device=a.device)

        if not self._flat():
            try:
                return pytree.tree_leaves(
                    pytree.tree_map(mul, err, self.weights)), leaves
            except (ValueError, TypeError, RuntimeError):
                pass  # not a matching pytree: broadcast
        w = self.weights
        return [mul(a, w) for a in leaves], leaves

    def _reduce(self, err, batch_ndim: int) -> torch.Tensor:
        wl, leaves = self._weighted_leaves(err)

        def reduce(op, a):
            # torch reads an empty dim tuple as "every axis"
            axes = tuple(range(batch_ndim, a.ndim))
            return op(a, dim=axes) if axes else a

        if self.kind == "max":
            out = None
            for a in wl:
                v = reduce(torch.amax, torch.abs(a))
                out = v if out is None else torch.maximum(out, v)
            return out
        ss = None
        for a in wl:
            s = reduce(torch.sum, a * a)
            ss = s if ss is None else ss + s
        if self.kind == "rms":
            ss = ss / sum(math.prod(a.shape[batch_ndim:]) for a in leaves)
        return torch.sqrt(ss)

    def __call__(self, err) -> torch.Tensor:
        return self._reduce(err, 0)

    def batched(self, err) -> torch.Tensor:
        return self._reduce(err, 1)

    def kernel_parts(self, d_part: int, n_parts: int):
        """(w_row, post, kind) for the kernels' widened-real layout: a
        numpy (1, n_parts*d_part) row or None, a constant post-factor, and
        the reduction kind ("l2" or "max"). None when the weights cannot be
        laid out (not one array of length ``d_part``)."""
        if self.weights is None:
            row = None
        else:
            if not self._flat() or isinstance(self.weights, float):
                return None
            w = np.asarray(self.weights, np.float64)
            if w.shape[0] != d_part:
                return None
            row = np.concatenate([w] * n_parts)[None, :]
        post = (1.0 / math.sqrt(n_parts * d_part) if self.kind == "rms"
                else 1.0)
        return row, post, ("max" if self.kind == "max" else "l2")

    def same_as(self, other) -> bool:
        """Whether ``other`` declares the same norm (pytree weights compare
        by identity, as their arrays do not compare to one truth value)."""
        try:
            return bool(self == other)
        except (RuntimeError, ValueError, TypeError):
            return self is other


class TracedNorm:
    """An opaque per-trajectory error-norm callable promoted to the
    batched tier, the counterpart of ``vec_ode_tpu.lc.TracedNorm``:
    ``ensemble_solve`` probes an opaque ``error_norm=`` with
    :func:`try_trace_norm` and, where it maps to a scalar per trajectory,
    installs it here in a natively batched stepper's ``norm`` slot. No
    kernel runs a Python callable, so such a stepper runs its plain twin
    step on the tensors' device and applies the norm there."""

    __slots__ = ("fn",)

    def __init__(self, fn):
        if not callable(fn):
            raise TypeError(f"TracedNorm needs a callable, got {fn!r}")
        self.fn = fn

    def __call__(self, err):
        return self.fn(err)

    def batched(self, err):
        return torch.func.vmap(self.fn)(err)


def try_trace_norm(fn, example_err):
    """Probe ``fn`` (a per-trajectory error-norm callable) on the shapes
    and types of one trajectory's error ``example_err`` (a pytree of
    tensors, which is not read): under ``torch.func.vmap`` over a batch of
    two zero copies, on the CPU and, failing that, on the meta device, so
    that the probe launches nothing on the card and leaves nothing there.
    Returns a :class:`TracedNorm` where it maps to one scalar per
    trajectory, else None (the caller keeps its fallback paths)."""
    for device in ("cpu", "meta"):
        probe = pytree.tree_map(
            lambda a: torch.zeros((2,) + tuple(a.shape), dtype=a.dtype,
                                  device=device), example_err)
        try:
            out = torch.func.vmap(fn)(probe)
        except Exception:  # noqa: BLE001 - any failure means "not traceable"
            continue
        if isinstance(out, torch.Tensor) and tuple(out.shape) == (2,):
            return TracedNorm(fn)
        return None
    return None


def apply_weighted_norm(dv: torch.Tensor, wnorm, axis: int = -1):
    """post * ||w_row * dv|| with kind l2|max over ``axis``: the plain
    executor of a ``WeightedNorm.kernel_parts`` declaration
    ``(w_row, post, kind)``, the plain l2 norm for ``wnorm=None``, or a
    callable ``wnorm`` (a ``TracedNorm``'s executor over the widened error
    rows, built by the steppers) applied to ``dv`` as it is."""
    if wnorm is None:
        return torch.sqrt(torch.sum(dv * dv, dim=axis))
    if callable(wnorm):
        return wnorm(dv)
    w_row, post, kind = wnorm
    if w_row is not None:
        dv = dv * torch.as_tensor(w_row, dtype=dv.dtype,
                                  device=dv.device).reshape(-1)
    e = (torch.amax(torch.abs(dv), dim=axis) if kind == "max"
         else torch.sqrt(torch.sum(dv * dv, dim=axis)))
    return e if post == 1.0 else e * post

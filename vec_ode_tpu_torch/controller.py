"""Adaptive step-size controller, the torch counterpart of
``vec_ode_tpu/controller.py`` with the same semantics:

    f       = rtol / ||err||
    fp_lim  = clip(alpha * f**(1/order), min_factor, max_factor)
    new_h   = clip(fp_lim * h, min_dt, max_dt)
    accept  = f > 1

``atol`` is stored but ignored by the accept test unless
``scaled_error=True``; ``order`` defaults to 3.0 (the reference's exponent
for every solver). NaN error norms reject and shrink by ``min_factor``.
All functions are elementwise over tensors, so one call decides a whole
batch of trajectories.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch.utils import _pytree as pytree


@dataclasses.dataclass(frozen=True)
class StepControl:
    """Static controller configuration (same fields and defaults as the
    JAX package's ``StepControl``)."""

    rtol: float = 1.0e-4
    atol: float = 1.0e-6
    alpha: float = 0.9
    order: float = 3.0
    min_factor: float = 0.3
    max_factor: float = 2.0
    min_dt: float = 1.0e-6
    max_dt: float = 1.0
    scaled_error: bool = False   # use err/(atol + rtol*|x|) as the measure
    max_steps: int = 1_000_000
    # consecutive rejects before ERR_STALLED; 0 = never
    max_reject_streak: int = 0
    # reference-exact end test |rem| <= eps (unscaled); the default scales
    # eps by max(1, |t|)
    strict_end_test: bool = False
    # PI (Gustafsson) control: h *= alpha * f^kI * (f/f_prev)^kP with
    # kI = 0.7/pi_order, kP = 0.4/pi_order; pure I-term after a reject
    pi: bool = False
    pi_order: float = 5.0
    # carry t as a compensated (hi, lo) pair (driver.comp_time_advance);
    # False accumulates t += dt plainly, as the reference does
    time_compensated: bool = True

    def __post_init__(self):
        if self.rtol <= 0 or self.atol <= 0:
            raise ValueError(
                f"Invalid tolerances: atol={self.atol}, rtol={self.rtol}"
            )
        if self.min_dt <= 0 or self.max_dt <= 0 or self.max_dt <= self.min_dt:
            raise ValueError(
                f"Invalid step range: ({self.min_dt}, {self.max_dt})"
            )

    def init_h(self) -> float:
        """Default initial step: sqrt(min_dt * max_dt)."""
        return math.sqrt(self.min_dt * self.max_dt)


def check_h0(h0, ctl: StepControl, adaptive: bool):
    """In adaptive mode a given h0 (scalar or per-trajectory (B,) values)
    must be finite and lie inside [min_dt, max_dt]. Returns the (defaulted)
    h0."""
    if h0 is None:
        return ctl.init_h()
    if not adaptive:
        return h0
    arr = (h0.detach().cpu().numpy() if isinstance(h0, torch.Tensor)
           else np.asarray(h0))
    if arr.dtype.kind in "fi" and arr.size and (
        (~np.isfinite(arr.astype(np.float64))).any()
        or (arr < ctl.min_dt).any() or (arr > ctl.max_dt).any()
    ):
        raise ValueError(
            f"Step {h0} is not inside the range "
            f"({ctl.min_dt}, {ctl.max_dt})"
        )
    return h0


def _scalar(v: float, like: torch.Tensor) -> torch.Tensor:
    # a 0-d CPU tensor: it rounds v to ``like``'s dtype, as jnp.asarray
    # does, and enters CUDA ops as a kernel argument (no copy, no sync)
    return torch.tensor(v, dtype=like.dtype)


def controller_update(h: torch.Tensor, err_norm: torch.Tensor,
                      ctl: StepControl, prev_err_norm=None,
                      prev_rejected=None):
    """One controller decision per element. Returns (new_h, accept).

    The guards are those of the JAX package, in the same order, so NaN,
    inf and zero error norms give the same decisions: err = 0 gives
    f = inf (accept, growth capped at max_factor); NaN rejects.
    """
    # JAX promotes rtol (h's dtype) against the norm's dtype; a 0-d torch
    # tensor would not, so the norms are cast to the promoted dtype first
    dtype = torch.promote_types(h.dtype, err_norm.dtype)
    rtol = torch.tensor(ctl.rtol, dtype=dtype)
    f = rtol / err_norm.to(dtype)
    if ctl.pi and prev_err_norm is not None:
        kI = _scalar(0.7 / ctl.pi_order, f)
        kP = _scalar(0.4 / ctl.pi_order, f)
        f_prev = rtol / prev_err_norm.to(dtype)
        # first step / zero history: neutral proportional term
        f_prev = torch.where(torch.isfinite(f_prev) & (f_prev > 0),
                             f_prev, f)
        ratio = torch.clamp(f / f_prev, 1e-8, 1e8)
        # f = inf on both sides gives inf/inf = NaN: neutral term
        ratio = torch.where(torch.isnan(ratio), 1.0, ratio)
        alpha = _scalar(ctl.alpha, f)
        fp_pi = alpha * torch.pow(f, kI) * torch.pow(ratio, kP)
        fp_i = alpha * torch.pow(f, _scalar(1.0 / ctl.pi_order, f))
        if prev_rejected is not None:
            fp = torch.where(prev_rejected, fp_i, fp_pi)
        else:
            fp = fp_pi
    else:
        fp = _scalar(ctl.alpha, f) * torch.pow(f, _scalar(1.0 / ctl.order, f))
    fp_lim = torch.clamp(fp, ctl.min_factor, ctl.max_factor)
    bad = torch.isnan(f)
    fp_lim = torch.where(bad, ctl.min_factor, fp_lim)
    new_h = torch.clamp(fp_lim * h, ctl.min_dt, ctl.max_dt)
    accept = ~bad & (f > 1.0)
    return new_h, accept


def error_measure(err_norm_fn, x, x_next, err, ctl: StepControl):
    """The value the controller compares against rtol: ``||err||``, or with
    ``scaled_error`` ``||err / (atol + rtol*max(|x|, |x_next|))|| * rtol``,
    leaf by leaf over the state's pytree."""
    if not ctl.scaled_error:
        return err_norm_fn(err)

    def scale(e, a, b):
        return e / (ctl.atol + ctl.rtol * torch.maximum(a.abs(), b.abs()))

    return err_norm_fn(pytree.tree_map(scale, err, x, x_next)) * ctl.rtol


def end_tolerance(t_ref: torch.Tensor, strict: bool = False) -> torch.Tensor:
    """Absolute tolerance of the 'remaining time is zero' test: eps of
    ``t_ref``'s dtype, scaled by max(1, |t_ref|) unless ``strict``."""
    eps = torch.finfo(t_ref.dtype).eps
    if strict:
        return torch.full_like(t_ref, eps)
    return 4.0 * eps * torch.clamp(t_ref.abs(), min=1.0)

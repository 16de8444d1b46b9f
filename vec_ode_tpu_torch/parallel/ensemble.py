"""Ensemble propagation: many independent trajectories in one batched
driver loop (the natively batched, unsharded branch of
``vec_ode_tpu/parallel/ensemble.py:ensemble_solve``)."""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.utils import _pytree as pytree

from .. import lc
from ..controller import StepControl, check_h0
from ..driver import Solution, integrate, make_grid


def ensemble_solve(
    rhs_or_op: Optional[Callable],
    y0_batch,
    t0,
    tf,
    *,
    stepper=None,
    h0: Optional[float] = None,
    adaptive: bool = True,
    ctl: StepControl = StepControl(),
    save_at=None,
    error_norm: Callable = lc.norm_l2,
    time_dtype: Optional[torch.dtype] = None,
    mesh=None,
    axis_name: str = "traj",
    method: str = "while",
    params=None,
    events=None,
    dense: bool = False,
) -> Solution:
    """Integrate a batch of independent trajectories (leading axis of every
    leaf of ``y0_batch``) with a natively batched ``stepper`` such as
    ``ops.fused_rk.FusedModulatedLinearRK``: one driver loop over the
    whole batch, on ``y0_batch``'s device.

    The signature is the JAX package's. What this port does not run yet
    raises ``NotImplementedError`` naming its ROADMAP item. ``time_dtype``
    defaults to float64 (the JAX package's default under x64); ``h0`` may
    be per-trajectory (B,). ``axis_name`` belongs to ``mesh``.
    """
    if stepper is None or not getattr(stepper, "is_batched", False):
        raise NotImplementedError(
            "only natively batched steppers are ported (e.g. "
            "FusedModulatedLinearRK); the generic RungeKutta tier is "
            "ROADMAP queue 1, items 6 and 9")
    if mesh is not None:
        raise NotImplementedError(
            "mesh=: sharded ensembles are ROADMAP slice 7, queue 1 item 27")
    if method != "while":
        raise NotImplementedError(
            f"method={method!r}: the scan driver is ROADMAP slice 6, "
            "queue 1 item 22")
    if params is not None:
        raise NotImplementedError(
            "params=: per-trajectory parameters arrive with the vmapped "
            "tier, ROADMAP queue 1 item 9")
    if events is not None:
        raise NotImplementedError(
            "events=: events are ROADMAP slice 3, queue 1 item 12")
    if dense:
        raise NotImplementedError(
            "dense=True: dense output is ROADMAP slice 3, queue 1 item 13")
    if error_norm is not lc.norm_l2:
        raise NotImplementedError(
            "error_norm=: declared and traced norms are ROADMAP slice 3 "
            "and queue 1 items 3 and 26")
    if ctl.scaled_error:
        raise ValueError(
            "scaled_error with a norm-returning stepper requires the fused "
            "loop kernel (ROADMAP slice 3, kernel K2), which is not ported")

    leaves = pytree.tree_leaves(y0_batch)
    b = leaves[0].shape[0]
    device = leaves[0].device
    if time_dtype is None:
        time_dtype = torch.float64
    t_grid = make_grid(t0, tf, save_at, dtype=time_dtype, device=device)
    h0 = check_h0(h0, ctl, adaptive)
    step_fn = stepper.make_step_fn(rhs_or_op)
    sol = integrate(step_fn, y0_batch, t_grid, h0, adaptive=adaptive,
                    ctl=ctl, error_norm=stepper.error_norm,
                    batch_shape=(b,))
    sol.path = stepper.step_path(y0_batch)
    # the shared save grid, per trajectory (as the JAX package returns it)
    sol.ts = t_grid.expand(b, t_grid.shape[0])
    return sol

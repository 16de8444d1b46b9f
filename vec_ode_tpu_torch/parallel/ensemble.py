"""Ensemble propagation: many independent trajectories in one batched
solve (the natively batched, unsharded branch of
``vec_ode_tpu/parallel/ensemble.py:ensemble_solve``): the whole loop in
one kernel launch where the stepper's ``fused_loop_solve`` takes the
configuration, else one driver loop over per-step launches."""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
from torch.utils import _pytree as pytree

from .. import lc
from ..controller import StepControl, check_h0
from ..driver import Solution, integrate, make_grid
from ..events import as_event_config


def _install_norm(stepper, error_norm):
    """The stepper with a declared ``lc.WeightedNorm`` installed as its
    ``norm`` (its kernels and plain step execute it), as the JAX package's
    ``ensemble_solve`` does for norm-returning steppers."""
    declares = dataclasses.is_dataclass(stepper) and any(
        f.name == "norm" for f in dataclasses.fields(stepper))
    if not declares:
        raise NotImplementedError(
            "error_norm=: only steppers that declare a norm take a "
            "WeightedNorm; vector-returning batched steppers are ROADMAP "
            "queue 1 item 9")
    existing = stepper.norm
    if existing is None:
        return dataclasses.replace(stepper, norm=error_norm)
    if existing != error_norm:
        raise ValueError(
            "stepper already declares a different norm= than the "
            "error_norm= passed to ensemble_solve")
    return stepper


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
    leaf of ``y0_batch``) with a natively batched ``stepper``
    (``ops.fused_rk.FusedModulatedLinearRK``, ``exp.MidpointModulated``,
    ``exp.MagnusModulated4``, ``exp.MagnusModulated6``,
    ``exp.CFMModulated`` / ``CFM4Modulated``, or a generic exponential
    stepper over a
    dense leaf: ``exp.ExpMidpoint``, ``Magnus4``, ``Magnus6``, ``CFM``,
    ``SplitMidpoint``, ``SplitCFM``), on ``y0_batch``'s device.

    ``rhs_or_op`` is the generic steppers' operator assembly ``op_fn(t)``
    for ONE trajectory (scalar time in, operator out; the steppers vmap it
    over the batch), or None for a stepper that embeds its operator. With
    ``params`` (a pytree with the same leading batch axis) the signature
    becomes ``op_fn(t, p)``, so an ensemble can sweep model parameters;
    only steppers with ``supports_batched_params`` take it.

    The stepper's ``fused_loop_solve`` runs the whole loop (adaptive, or
    fixed steps with ``adaptive=False``) in one launch of the CUDA loop
    kernel where it takes the configuration; where it declines (returns
    None), one driver loop runs over the whole batch with a kernel launch
    per step on the card, or the plain torch step on the CPU.
    ``Solution.path`` names the path taken.

    ``events`` (an ``events.EventConfig``, an ``Event``, a callable or a
    sequence of them) locates event crossings: declared observables run
    in the loop kernel, opaque callables in the host driver (the
    ``Solution.event_*`` fields). ``dense=True`` makes the interior
    ``save_at`` times free-running interpolated saves: the loop kernel
    records the crossing steps' endpoints, else the host driver's
    ``dense.integrate_interp`` runs; the path name gains ``-dense``.
    ``dense=True`` with events needs the loop kernel.

    The signature is the JAX package's. ``error_norm`` may be a declared
    ``lc.WeightedNorm`` (installed as the stepper's ``norm``).
    ``scaled_error`` needs the loop kernel (a norm-returning stepper's
    errors cannot be rescaled by the driver) and raises ``ValueError``
    where it declines. What this port does not run yet raises
    ``NotImplementedError`` naming its ROADMAP item. ``time_dtype``
    defaults to float64 (the JAX package's default under x64); ``h0`` may
    be per-trajectory (B,). ``axis_name`` belongs to ``mesh``.
    """
    if stepper is None or not getattr(stepper, "is_batched", False):
        raise NotImplementedError(
            "only natively batched steppers are ported "
            "(FusedModulatedLinearRK, the modulated steppers "
            "MidpointModulated, MagnusModulated4, MagnusModulated6, "
            "CFMModulated, and the generic exponential steppers over "
            "DenseSplit / DenseCplxSplit); the vmapped tier (the generic "
            "RungeKutta stepper, exponential steppers with batched=False or "
            "over another split) is ROADMAP queue 1, items 6 and 9"
            + ("; its dense output (solve_ivp_dense / solve_linear_dense) "
               "is item 13" if dense else ""))
    if mesh is not None:
        raise NotImplementedError(
            "mesh=: sharded ensembles are ROADMAP slice 7, queue 1 item 27")
    if method != "while":
        raise NotImplementedError(
            f"method={method!r}: the scan driver is ROADMAP slice 6, "
            "queue 1 item 22")
    if params is not None and not getattr(stepper, "supports_batched_params",
                                          False):
        raise ValueError(
            "params is unsupported for this natively batched stepper (it "
            "embeds its own operator)")
    event_cfg = as_event_config(events)
    if isinstance(error_norm, lc.WeightedNorm):
        if ctl.scaled_error:
            raise ValueError(
                "scaled_error and a WeightedNorm are mutually exclusive "
                "(both redefine the error measure)")
        stepper = _install_norm(stepper, error_norm)
    elif error_norm is not lc.norm_l2:
        raise NotImplementedError(
            "error_norm=: opaque norm callables are ROADMAP queue 1 item "
            "26; declare an lc.WeightedNorm")

    leaves = pytree.tree_leaves(y0_batch)
    b = leaves[0].shape[0]
    device = leaves[0].device
    if time_dtype is None:
        time_dtype = torch.float64
    t_grid = make_grid(t0, tf, save_at, dtype=time_dtype, device=device)
    h0 = check_h0(h0, ctl, adaptive)

    fused = getattr(stepper, "fused_loop_solve", None)
    if fused is not None:
        kw = {}
        if event_cfg is not None:
            kw["events"] = event_cfg
        if dense:
            kw["dense"] = True
        sol = fused(y0_batch, t_grid, h0, ctl=ctl, adaptive=adaptive, **kw)
        if sol is not None:
            return sol
    if ctl.scaled_error:
        if fused is None and getattr(stepper, "auto_batched", False):
            # the JAX package runs this call on the vmapped path, where
            # the driver holds the error vector
            raise NotImplementedError(
                "scaled_error with an auto-batched generic exponential "
                "stepper runs on the vmapped tier, ROADMAP queue 1 item 9")
        raise ValueError(
            "scaled_error with a norm-returning stepper requires the fused "
            "loop kernel, which did not engage for this configuration (see "
            "the stepper's fused_loop_solve: e.g. the time dtype must be "
            "the state's)")
    if params is None:
        step_fn = stepper.make_step_fn(rhs_or_op)
    else:
        step_fn = stepper.make_step_fn(rhs_or_op, params=params)
    if dense:
        if event_cfg is not None:
            raise ValueError(
                "dense=True with events= needs the fused loop kernel, which "
                "did not engage for this configuration (the dense driver "
                "carries no event state; see fused_loop_solve eligibility)")
        sol = _batched_dense_fallback(
            stepper, step_fn, y0_batch, t_grid, h0, adaptive=adaptive,
            ctl=ctl, batch_shape=(b,))
    else:
        sol = integrate(step_fn, y0_batch, t_grid, h0, adaptive=adaptive,
                        ctl=ctl, error_norm=stepper.error_norm,
                        batch_shape=(b,), event_cfg=event_cfg)
        sol.path = stepper.step_path(y0_batch)
    # the shared save grid, per trajectory (as the JAX package returns it)
    sol.ts = t_grid.expand(b, t_grid.shape[0])
    return sol


def _batched_dense_fallback(stepper, fn, y0, t_grid, h0, *, adaptive, ctl,
                            batch_shape) -> Solution:
    """The host driver's dense tier for a natively batched stepper:
    free-running ``dense.integrate_interp`` with cubic-Hermite saves whose
    endpoint slopes are the stepper's ``hermite_slope``, or the operator
    action A(t) x of its ``ModulatedOperator``."""
    from ..dense import integrate_interp

    slope = getattr(stepper, "hermite_slope", None)
    if slope is None:
        op = getattr(stepper, "op", None)
        if op is None or not hasattr(op, "coeff_fn"):
            raise ValueError(
                "dense=True on a natively-batched stepper needs its "
                "ModulatedOperator (or a hermite_slope method) for the "
                "Hermite endpoint slopes; for generic exp steppers pass "
                "batched=False (the vmapped dense driver computes slopes "
                "from the split)")
        from ..exp.modulated import operator_slope

        def slope(t, x):
            return operator_slope(op, t, x)

    def sfd(t, x, dt):
        xn, err = fn(t, x, dt)
        return xn, err, (slope(t, x), slope(t + dt, xn))

    sol = integrate_interp(sfd, y0, t_grid, h0, adaptive=adaptive, ctl=ctl,
                           error_norm=stepper.error_norm,
                           batch_shape=batch_shape)
    sol.path = stepper.step_path(y0) + "-dense"
    return sol

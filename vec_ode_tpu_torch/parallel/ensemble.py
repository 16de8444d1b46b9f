"""Ensemble propagation: many independent trajectories in one solve (the
unsharded branches of ``vec_ode_tpu/parallel/ensemble.py:
ensemble_solve``):

* natively batched steppers: the whole loop in one kernel launch where
  the stepper's ``fused_loop_solve`` takes the configuration, else one
  driver loop over per-step launches;
* the vmapped tier (the generic ``rk.RungeKutta``, ``stepper=None``, and
  exponential steppers with ``batched=False`` or over a split that cannot
  batch): one batched driver loop whose step is ``torch.func.vmap`` of
  the per-trajectory step over (t, x, dt) (and ``params`` and the
  stepper's carry); the driver's lane masking gives each trajectory the
  branch sequence that the JAX package's vmapped ``while_loop`` gives it.
  ``dense=True`` there is one batched ``dense.integrate_interp`` over the
  vmapped per-trajectory dense step.

``method="scan"`` runs the host driver on every tier (exactly
``ctl.max_steps`` iterations, no read of the device), so a natively
batched stepper skips its whole-loop kernel and launches its step kernel
once an iteration, as the JAX package skips ``fused_loop_solve``.
"""

from __future__ import annotations

import dataclasses
import functools
import inspect
from typing import Callable, Optional

import torch
from torch.utils import _pytree as pytree

from .. import lc
from ..controller import StepControl, check_h0
from ..driver import Solution, integrate, make_grid
from ..events import as_event_config
from ..rk import RungeKutta


def _declares_norm(stepper) -> bool:
    return dataclasses.is_dataclass(stepper) and any(
        f.name == "norm" for f in dataclasses.fields(stepper))


def _install_norm(stepper, error_norm):
    """The stepper with a declared ``lc.WeightedNorm`` installed as its
    ``norm`` (its kernels and plain step execute it), as the JAX package's
    ``ensemble_solve`` does for norm-returning steppers."""
    if not _declares_norm(stepper):
        raise ValueError(
            "this stepper computes its own per-trajectory error norms and "
            "declares no norm=; pass batched=False for the vmapped tier, "
            "which applies error_norm= per trajectory")
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
    remat_levels: int = 0,
    grad_safe: bool = False,
) -> Solution:
    """Integrate a batch of independent trajectories (leading axis of every
    leaf of ``y0_batch``) on ``y0_batch``'s device.

    ``rhs_or_op`` is the per-trajectory RHS ``f(t, y)`` (RK steppers) or
    operator assembly ``op_fn(t)`` (exponential steppers), unbatched: the
    steppers map it over the batch. With ``params`` (a pytree with the
    same leading batch axis) the signature becomes ``f(t, y, p)`` /
    ``op_fn(t, p)``, so an ensemble can sweep model parameters. None for a
    stepper that embeds its operator.

    Natively batched steppers (``ops.fused_rk.FusedModulatedLinearRK``,
    the modulated ``exp.MidpointModulated`` / ``MagnusModulated4`` /
    ``MagnusModulated6`` / ``CFMModulated``, and the generic exponential
    steppers over ``DenseSplit`` / ``DenseCplxSplit``) run the whole loop
    in one launch of the CUDA loop kernel where their ``fused_loop_solve``
    takes the configuration, else one driver loop over the whole batch
    with a kernel launch per step on the card, or the plain torch step on
    the CPU. Every other stepper (``stepper=None``, i.e. ``RungeKutta()``;
    ``batched=False``; a split that cannot batch) runs the vmapped tier:
    one driver loop over ``torch.func.vmap`` of the per-trajectory step,
    with ``error_norm`` applied per trajectory (``lc.norm_l2``, a declared
    ``lc.WeightedNorm`` or an opaque callable), ``scaled_error``, opaque
    event callables and per-trajectory ``h0``; an auto-batched generic
    stepper takes it too where its batched conventions cannot express the
    call (``scaled_error``, which needs the error vector).
    ``Solution.path`` names the path taken (``"torch-driver"`` on the
    vmapped tier, on either device).

    ``events`` (an ``events.EventConfig``, an ``Event``, a callable or a
    sequence of them) locates event crossings: declared observables run
    in the loop kernel, opaque callables in the host driver (the
    ``Solution.event_*`` fields). ``dense=True`` makes the interior
    ``save_at`` times free-running interpolated saves on the batched
    steppers: the loop kernel records the crossing steps' endpoints, else
    the host driver's ``dense.integrate_interp`` runs; the path name gains
    ``-dense``. On the vmapped tier ``dense=True`` interpolates from the
    RK stage slopes (``p_dense``) or cubic Hermite, as
    ``dense.solve_ivp_dense`` / ``solve_linear_dense`` do per trajectory.
    ``dense=True`` with events needs the loop kernel.

    ``method="scan"`` runs exactly ``ctl.max_steps`` driver iterations
    with no read of the device, on every tier (never the whole-loop
    kernel); autograd differentiates it. ``remat_levels`` and
    ``grad_safe`` are ``driver.integrate``'s, passed to every driver loop
    but the dense one (the JAX package's ``ensemble_solve`` has neither:
    its callers differentiate a jitted solve).

    The signature is the JAX package's, with those two added.
    ``time_dtype`` defaults to float64 (the JAX package's default under
    x64); ``h0`` may be per-trajectory (B,). What this port does not run
    yet raises ``NotImplementedError`` naming its ROADMAP item: ``mesh=``
    (27), opaque norms on natively batched steppers (26).
    """
    if mesh is not None:
        raise NotImplementedError(
            "mesh=: sharded ensembles are ROADMAP slice 7, queue 1 item 27")
    if dense and (remat_levels or grad_safe):
        raise ValueError("dense=True: the dense driver takes neither "
                         "remat_levels nor grad_safe")
    if stepper is None:
        stepper = RungeKutta()
    event_cfg = as_event_config(events)
    use_batched = bool(getattr(stepper, "is_batched", False))
    auto = bool(getattr(stepper, "auto_batched", False))
    if use_batched and auto and (
            (ctl.scaled_error
             and getattr(stepper, "fused_loop_solve", None) is None)
            or (isinstance(error_norm, lc.WeightedNorm)
                and not _declares_norm(stepper))):
        # the JAX package keeps the vmapped tier for calls that an
        # auto-batched stepper's batched conventions cannot express
        use_batched = False

    leaves = pytree.tree_leaves(y0_batch)
    b = leaves[0].shape[0]
    device = leaves[0].device
    if time_dtype is None:
        time_dtype = torch.float64
    t_grid = make_grid(t0, tf, save_at, dtype=time_dtype, device=device)
    h0 = check_h0(h0, ctl, adaptive)
    loop = dict(method=method, remat_levels=remat_levels,
                grad_safe=grad_safe)
    if not use_batched:
        sol = _vmapped_solve(rhs_or_op, y0_batch, t_grid, h0,
                             stepper=stepper, adaptive=adaptive, ctl=ctl,
                             error_norm=error_norm, params=params,
                             event_cfg=event_cfg, dense=dense, loop=loop)
        sol.ts = t_grid.expand(b, t_grid.shape[0])
        return sol

    if params is not None and not getattr(stepper, "supports_batched_params",
                                          False):
        raise ValueError(
            "params is unsupported for this natively batched stepper (it "
            "embeds its own operator)")
    if isinstance(error_norm, lc.WeightedNorm):
        if ctl.scaled_error:
            raise ValueError(
                "scaled_error and a WeightedNorm are mutually exclusive "
                "(both redefine the error measure)")
        stepper = _install_norm(stepper, error_norm)
    elif error_norm is not lc.norm_l2:
        raise NotImplementedError(
            "error_norm=: opaque norm callables on natively batched "
            "steppers are ROADMAP queue 1 item 26; declare an "
            "lc.WeightedNorm")

    fused = getattr(stepper, "fused_loop_solve", None)
    if fused is not None and method == "while" and not grad_safe:
        kw = {}
        if event_cfg is not None:
            kw["events"] = event_cfg
        if dense:
            kw["dense"] = True
        sol = fused(y0_batch, t_grid, h0, ctl=ctl, adaptive=adaptive, **kw)
        if sol is not None:
            return sol
    if ctl.scaled_error:
        raise ValueError(
            "scaled_error with a norm-returning stepper requires the fused "
            "loop kernel, which did not engage for this configuration (see "
            "the stepper's fused_loop_solve: e.g. the time dtype must be "
            "the state's; generic exponential steppers take batched=False "
            "for the vmapped tier)")
    if params is None:
        step_fn = stepper.make_step_fn(rhs_or_op)
    else:
        step_fn = stepper.make_step_fn(rhs_or_op, params=params)
    # a batched stepper's carry seed is shape-polymorphic over the batch
    init_cf = (stepper.make_init_carry(rhs_or_op)
               if getattr(stepper, "has_carry", False) else None)
    if dense:
        if event_cfg is not None:
            raise ValueError(
                "dense=True with events= needs the fused loop kernel, which "
                "did not engage for this configuration (the dense driver "
                "carries no event state; see fused_loop_solve eligibility)")
        sol = _batched_dense_fallback(
            stepper, step_fn, y0_batch, t_grid, h0, adaptive=adaptive,
            ctl=ctl, method=method, batch_shape=(b,), init_carry_fn=init_cf)
    else:
        sol = integrate(step_fn, y0_batch, t_grid, h0, adaptive=adaptive,
                        ctl=ctl, error_norm=stepper.error_norm,
                        batch_shape=(b,), init_carry_fn=init_cf,
                        event_cfg=event_cfg, **loop)
        sol.path = stepper.step_path(y0_batch)
    # the shared save grid, per trajectory (as the JAX package returns it)
    sol.ts = t_grid.expand(b, t_grid.shape[0])
    return sol


def _check_arity(fn: Callable, takes_state: bool) -> None:
    """With ``params`` the callable takes (t, y, p) (RK) or (t, p)
    (exponential steppers), as the JAX package checks it."""
    want = 3 if takes_state else 2
    try:
        n_args = len(inspect.signature(fn).parameters)
    except (TypeError, ValueError):
        n_args = want
    if n_args != want:
        sig = "(t, y, p)" if takes_state else "(t, p)"
        raise ValueError(
            f"with params, this stepper expects rhs_or_op{sig}; got a "
            f"{n_args}-parameter callable")


def _batched_norm(error_norm: Callable) -> Callable:
    """A per-trajectory error norm over the batch: ``lc.norm_l2`` as
    ``lc.norm_l2_batched``, a declared ``WeightedNorm`` by its ``.batched``
    form, any other callable through ``torch.func.vmap``."""
    if error_norm is lc.norm_l2:
        return lc.norm_l2_batched
    if isinstance(error_norm, lc.WeightedNorm):
        return error_norm.batched
    return torch.func.vmap(error_norm)


def _vmapped_solve(rhs_or_op, y0_batch, t_grid, h0, *, stepper, adaptive,
                   ctl, error_norm, params, event_cfg, dense,
                   loop) -> Solution:
    """The vmapped tier: one batched driver loop over ``torch.func.vmap``
    of the per-trajectory step, its carry seeded by the vmapped
    ``make_init_carry`` (FSAL); with ``dense`` one batched
    ``dense.integrate_interp`` over the vmapped per-trajectory dense step.
    A missing error estimate crosses the vmap as an empty tuple."""
    from ..dense import integrate_interp, linear_slope, rk_dense_step

    takes_state = bool(getattr(stepper, "takes_state", False))
    if params is not None:
        _check_arity(rhs_or_op, takes_state)

    def fn_of(p):
        if p is None:
            return rhs_or_op
        return ((lambda tt, y: rhs_or_op(tt, y, p)) if takes_state
                else (lambda tt: rhs_or_op(tt, p)))

    interp = {}
    if dense:
        if event_cfg is not None:
            raise ValueError(
                "dense=True with events= needs the fused loop kernel "
                "(batched modulated steppers); the vmapped dense driver "
                "carries no event state")
        if takes_state and not isinstance(stepper, RungeKutta):
            raise ValueError("dense=True supports RungeKutta and exp "
                             "steppers on the vmapped tier")
        if getattr(stepper, "compensated", False):
            raise ValueError(
                "dense=True has no compensated variant (the dense driver "
                "carries no lo word); use compensated=False")
        if takes_state:
            # the JAX package's solve_ivp_dense per trajectory
            def make(p):
                return rk_dense_step(fn_of(p), stepper.tableau,
                                     stepper.advance_lower)[:2]

            _, init, kind = rk_dense_step(rhs_or_op, stepper.tableau,
                                          stepper.advance_lower)
            has_init = init is not None
            interp = dict(interp_kind=kind, tab=stepper.tableau)
        else:
            # solve_linear_dense per trajectory: Hermite over A(t) x
            def make(p):
                op_fn = fn_of(p)
                slope = linear_slope(stepper, op_fn)
                inner = stepper.make_step_fn(op_fn)

                def step_dense(t, x, dt):
                    x_next, err = inner(t, x, dt)
                    return x_next, err, (slope(t, x), slope(t + dt, x_next))

                return step_dense, None

            has_init = False
    else:
        has_init = bool(getattr(stepper, "has_carry", False))

        def make(p):
            fn = fn_of(p)
            return (stepper.make_step_fn(fn),
                    stepper.make_init_carry(fn) if has_init else None)

    def single(p, t, x, dt, *carry):
        out = make(p)[0](t, x, dt, *carry)
        return (out[0], () if out[1] is None else out[1]) + tuple(out[2:])

    def single_init(p, t, x):
        return make(p)[1](t, x)

    if params is None:
        mapped = torch.func.vmap(functools.partial(single, None))
        mapped_init = torch.func.vmap(functools.partial(single_init, None))
        args = ()
    else:
        mapped = torch.func.vmap(single)
        mapped_init = torch.func.vmap(single_init)
        args = (params,)

    def step_fn(t, x, dt, *carry):
        out = mapped(*args, t, x, dt, *carry)
        err = out[1] if pytree.tree_leaves(out[1]) else None
        return (out[0], err) + tuple(out[2:])

    b = pytree.tree_leaves(y0_batch)[0].shape[0]
    init_carry_fn = None
    if has_init:
        def init_carry_fn(t0, x0):
            return mapped_init(*args, t0.expand(b), x0)

    enorm = _batched_norm(error_norm)
    if dense:
        sol = integrate_interp(step_fn, y0_batch, t_grid, h0,
                               adaptive=adaptive, ctl=ctl, error_norm=enorm,
                               method=loop["method"], batch_shape=(b,),
                               init_carry_fn=init_carry_fn, **interp)
    else:
        sol = integrate(step_fn, y0_batch, t_grid, h0, adaptive=adaptive,
                        ctl=ctl, error_norm=enorm, batch_shape=(b,),
                        init_carry_fn=init_carry_fn, event_cfg=event_cfg,
                        **loop)
    sol.path = "torch-driver"
    return sol


def _batched_dense_fallback(stepper, fn, y0, t_grid, h0, *, adaptive, ctl,
                            batch_shape, method="while",
                            init_carry_fn=None) -> Solution:
    """The host driver's dense tier for a natively batched stepper:
    free-running ``dense.integrate_interp`` with cubic-Hermite saves whose
    endpoint slopes are the stepper's ``hermite_slope``, or the operator
    action A(t) x of its ``ModulatedOperator``; a stepper with a carry
    threads it (``init_carry_fn``)."""
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

    if init_carry_fn is not None:
        def sfd(t, x, dt, carry):
            xn, err, c2 = fn(t, x, dt, carry)
            return xn, err, (slope(t, x), slope(t + dt, xn)), c2
    else:
        def sfd(t, x, dt):
            xn, err = fn(t, x, dt)
            return xn, err, (slope(t, x), slope(t + dt, xn))

    sol = integrate_interp(sfd, y0, t_grid, h0, adaptive=adaptive, ctl=ctl,
                           error_norm=stepper.error_norm, method=method,
                           batch_shape=batch_shape,
                           init_carry_fn=init_carry_fn)
    sol.path = stepper.step_path(y0) + "-dense"
    return sol

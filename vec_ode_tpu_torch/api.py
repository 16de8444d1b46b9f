"""The front door: one solve of one problem, the counterpart of
``vec_ode_tpu/api.py``.

* :func:`solve_ivp`: nonlinear dx/dt = f(t, y) over any pytree state with
  an RK stepper (default Fehlberg RKF45);
* :func:`solve_linear`: dx/dt = A(t) x with an exponential stepper
  (``exp.ExpMidpoint``, ``Magnus4``, ``CFM4``, ..., the split solvers and
  the composite splits of ``exp.splits``).

Both run the driver's scalar carry (``driver.integrate`` with
``batch_shape=()``) where ``y0`` lies, with ``lc.norm_l2`` as the default
error norm; ``Solution.path`` is ``"torch-driver"``. Backward integration
(tf < t0) runs by time reversal: s in [0, t0 - tf] with the negated,
mirrored callable, save times and event functions mirrored too, and the
result mapped back to user time. ``method="scan"`` (exactly
``ctl.max_steps`` iterations, which autograd differentiates), with
``remat_levels`` and ``grad_safe``, runs as ``driver.integrate`` runs it;
a stepper with a carry (the FSAL slope) seeds it at (t0, y0).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

from . import lc
from .controller import StepControl, check_h0
from .driver import Solution, integrate, make_grid
from .rk import RungeKutta

Pytree = Any


def _as_state(y0: Pytree, device) -> Pytree:
    """Leaves as tensors: numpy arrays and python numbers are taken as
    numpy would (python floats as float64), on the device of y0's tensor
    leaves where it has any and on ``device`` where it has none."""
    tensors = [a for a in pytree.tree_leaves(y0)
               if isinstance(a, torch.Tensor)]
    if tensors:
        device = tensors[0].device
    return pytree.tree_map(
        lambda a: a if isinstance(a, torch.Tensor)
        else torch.as_tensor(np.asarray(a), device=device), y0)


def _device_of(y0: Pytree) -> torch.device:
    return pytree.tree_leaves(y0)[0].device


def _time_dtype(t0, tf) -> torch.dtype:
    """float64 for python endpoints (the JAX package's default under
    x64); a tensor endpoint's floating dtype otherwise."""
    dt = None
    for t in (t0, tf):
        if isinstance(t, torch.Tensor) and t.is_floating_point():
            dt = t.dtype if dt is None else torch.promote_types(dt, t.dtype)
    return torch.float64 if dt is None else dt


def _is_backward(t0, tf) -> bool:
    """True iff tf < t0 (python numbers or tensors)."""
    return bool(torch.as_tensor(tf) < torch.as_tensor(t0))


def _reverse_setup(fn, t0, tf, save_at, negate):
    """The time-reversal transform: integrate s in [0, t0 - tf] with the
    negated, time-mirrored callable. Returns (fn', t0', tf', save_at',
    t0_orig)."""
    t0_orig = float(t0)
    fn2 = negate(fn, t0_orig)
    if save_at is not None:
        if isinstance(save_at, torch.Tensor):
            save_at = save_at.detach().cpu().numpy()
        save_at = t0_orig - np.asarray(save_at, np.float64)[::-1]
    return fn2, 0.0, t0_orig - float(tf), save_at, t0_orig


def _reverse_result(sol: Solution, t0_orig: float) -> Solution:
    """A time-reversed Solution in user time: ts and ys flipped, t_final
    and the event times mapped back."""
    ev_kw = {}
    if sol.event_t is not None:
        # never-found events hold +inf; -inf in user time keeps "not
        # found" on the unreachable side
        ev_kw["event_t"] = torch.where(sol.event_found,
                                       t0_orig - sol.event_t, -torch.inf)
    if sol.event_t_k is not None:
        # slot s stays the (s+1)-th crossing along the integration
        # direction (backward from t0)
        ev_kw["event_t_k"] = torch.where(torch.isfinite(sol.event_t_k),
                                         t0_orig - sol.event_t_k, -torch.inf)
    return dataclasses.replace(
        sol,
        ts=torch.flip(t0_orig - sol.ts, dims=(0,)),
        ys=pytree.tree_map(lambda a: torch.flip(a, dims=(0,)), sol.ys),
        t_final=t0_orig - sol.t_final,
        **ev_kw)


def _reverse_events(cfg, t0_orig: float):
    """Event functions mirrored for the reversed solve: g'(s, y) = g(t0 -
    s, y), a rising crossing in user time a falling one in reversed
    time."""
    evs = tuple(
        dataclasses.replace(e, fn=(lambda s, y, _f=e.fn: _f(t0_orig - s, y)),
                            direction=-e.direction)
        for e in cfg.events)
    return dataclasses.replace(cfg, events=evs)


def _attach_nfev(sol: Solution, stepper) -> Solution:
    """RHS evaluations: attempted steps x evaluations an attempt, plus the
    stepper's one-time evaluations."""
    n = getattr(stepper, "nfev_per_step", None)
    if n is None:
        return sol
    n0 = int(getattr(stepper, "nfev_init", 0))
    return dataclasses.replace(
        sol, n_rhs_evals=n0 + (sol.n_accept + sol.n_reject) * int(n))


def _solve(fn, t0, tf, y0, *, stepper, h0, adaptive, ctl, save_at,
           error_norm, time_dtype, method, events, negate, device,
           remat_levels=0, grad_safe=False) -> Solution:
    from .events import as_event_config

    y0 = _as_state(y0, device)
    if time_dtype is None:
        time_dtype = _time_dtype(t0, tf)
    event_cfg = as_event_config(events)
    backward = _is_backward(t0, tf)
    if backward:
        if event_cfg is not None:
            event_cfg = _reverse_events(event_cfg, float(t0))
        fn, t0, tf, save_at, t0_orig = _reverse_setup(fn, t0, tf, save_at,
                                                      negate)
    t_grid = make_grid(t0, tf, save_at, dtype=time_dtype,
                       device=_device_of(y0))
    h0 = check_h0(h0, ctl, adaptive)
    init_carry_fn = (stepper.make_init_carry(fn)
                     if getattr(stepper, "has_carry", False) else None)
    sol = integrate(stepper.make_step_fn(fn), y0, t_grid, h0,
                    adaptive=adaptive, ctl=ctl, error_norm=error_norm,
                    method=method, init_carry_fn=init_carry_fn,
                    event_cfg=event_cfg, remat_levels=remat_levels,
                    grad_safe=grad_safe)
    sol = _attach_nfev(sol, stepper)
    if backward:
        sol = _reverse_result(sol, t0_orig)
    return sol


def solve_ivp(f: Callable, t0, tf, y0: Pytree, *, stepper=None,
              h0: Optional[float] = None, adaptive: bool = True,
              ctl: StepControl = StepControl(), save_at=None,
              error_norm: Callable = lc.norm_l2, time_dtype=None,
              method: str = "while", events=None, remat_levels: int = 0,
              grad_safe: bool = False, device="cuda") -> Solution:
    """Integrate dx/dt = f(t, y) from t0 to tf.

    ``f(t, y) -> dy/dt`` over a pytree of tensors (tensors, ``Cplx``
    pairs, tuples, dicts; real or complex). ``stepper`` defaults to
    ``RungeKutta()`` (RKF45). ``save_at`` holds interior output times,
    which the driver lands on exactly. ``h0`` defaults to sqrt(min_dt
    max_dt). ``time_dtype`` defaults to float64, or the endpoints' dtype
    when they are tensors.

    The solve runs where ``y0`` lies. Leaves that are not tensors (python
    numbers, numpy arrays) join y0's tensor leaves, or go on ``device``
    (the card unless ``device="cpu"``) where y0 has none.

    ``events``: an ``events.Event`` (or a callable g(t, y) -> scalar), a
    sequence of them, or an ``EventConfig``; the crossings are reported in
    ``Solution.event_t`` / ``event_found`` / ``event_y`` / ``event_t_k`` /
    ``event_count``, and a terminal event ends the solve with status
    ``DONE_EVENT``. ``Solution.n_rhs_evals`` counts the RHS evaluations.

    ``method="scan"`` runs exactly ``ctl.max_steps`` iterations (pick it
    tight) with no read of the device, and autograd differentiates it;
    ``remat_levels`` (nested ``torch.utils.checkpoint``) and
    ``grad_safe`` (overflow-safe rejects) are ``driver.integrate``'s.
    """
    if stepper is None:
        stepper = RungeKutta()
    return _solve(f, t0, tf, y0, stepper=stepper, h0=h0, adaptive=adaptive,
                  ctl=ctl, save_at=save_at, error_norm=error_norm,
                  time_dtype=time_dtype, method=method, events=events,
                  remat_levels=remat_levels, grad_safe=grad_safe,
                  device=device, negate=lambda fn, t0o: (
                      lambda s, y: lc.scale(fn(t0o - s, y), -1.0)))


def solve_linear(op_fn: Callable, t0, tf, y0: Pytree, *, stepper,
                 h0: Optional[float] = None, adaptive: bool = False,
                 ctl: StepControl = StepControl(), save_at=None,
                 error_norm: Callable = lc.norm_l2, time_dtype=None,
                 method: str = "while", events=None, remat_levels: int = 0,
                 grad_safe: bool = False, device="cuda") -> Solution:
    """Integrate the linear system dx/dt = A(t) x with an exponential
    stepper. ``op_fn(t) -> L`` assembles the operator at one time (the
    steppers call it under ``torch.func.vmap`` over their quadrature
    nodes); a split solver's returns the pair (La, Lb). Backward
    integration reverses the operator: B(s) = -A(t0 - s). ``device``,
    ``method``, ``remat_levels`` and ``grad_safe`` are :func:`solve_ivp`'s
    (``device`` places only leaves of y0 that are not tensors)."""
    return _solve(op_fn, t0, tf, y0, stepper=stepper, h0=h0,
                  adaptive=adaptive, ctl=ctl, save_at=save_at,
                  error_norm=error_norm, time_dtype=time_dtype,
                  method=method, events=events, device=device,
                  remat_levels=remat_levels, grad_safe=grad_safe,
                  negate=lambda fn, t0o: (
                      lambda s: lc.scale(fn(t0o - s), -1.0)))

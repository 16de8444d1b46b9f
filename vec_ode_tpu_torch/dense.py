"""Dense output: interpolated saves without hitting the grid, the
counterpart of ``vec_ode_tpu/dense.py``.

The controller runs free (only tf truncates a step) and every save time
a step crosses is filled from that step's own data:

* tableaus with dense coefficients (``p_dense``: DOPRI5, BOSH32)
  advancing the b solution use their continuous extension from the stage
  slopes, y(t + theta dt) = y0 + dt theta sum_j K_j P_j(theta), at no
  extra RHS evaluation (``interp_kind="p_dense"``);
* otherwise the cubic Hermite interpolant of (x, f) at both step ends
  (``"hermite"``); FSAL tableaus get the right-end slope free, others
  pay one more evaluation an attempt.

:func:`integrate_interp` runs on the scalar carry or a natively batched
one, with ``method="while"`` or ``"scan"`` (autograd differentiates the
latter) and the stepper's carry (FSAL). :func:`solve_ivp_dense` and
:func:`solve_linear_dense` are the front doors. The loop kernel records
the crossing steps' endpoints instead (``ops/fused_loop.py``) and
:func:`hermite_from_endpoints` evaluates all of them in one batch.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Optional

import torch
from torch.utils import _pytree as pytree

from . import lc
from .controller import StepControl, controller_update, end_tolerance
from .driver import (DONE, ERR_MAX_STEPS, ERR_STALLED, RUNNING, SCAN_GUARD,
                     Solution, _default_norm, _run_scan, comp_time_advance,
                     init_state, make_grid, masked_measure)

Pytree = Any


def _hermite_basis(th):
    """The four cubic Hermite basis polynomials on [0, 1]."""
    h00 = 2 * th**3 - 3 * th**2 + 1
    h10 = th**3 - 2 * th**2 + th
    h01 = -2 * th**3 + 3 * th**2
    h11 = th**3 - th**2
    return h00, h10, h01, h11


def hermite_from_endpoints(t_eval, td, dtd, x0, x1, slope_fn):
    """Cubic Hermite values at ``t_eval`` (n,) from recorded crossing
    steps, every slot in one batch: ``td`` / ``dtd`` (B, n) the crossing
    step's entry time and dt (t_entry = +inf marks a slot never crossed,
    which comes back zero); ``x0`` / ``x1`` (n, B, D) the step's entry and
    exit states; ``slope_fn(t, x)`` maps ((M,), (M, D)) to (M, D).
    Returns (n, B, D)."""
    n, B, _ = x0.shape
    tdT, dtdT = td.T, dtd.T                         # (n, B)
    rec = torch.isfinite(tdT)
    t_safe = torch.where(rec, tdT, 0.0)
    dt_safe = torch.where(rec & (dtdT > 0), dtdT, 1.0)
    # a poisoned (NaN) lane must not leak through the zero-weight branch
    x0 = torch.where(rec[..., None], x0, 0.0)
    x1 = torch.where(rec[..., None], x1, 0.0)
    th = torch.clamp((t_eval[:, None] - t_safe) / dt_safe, 0.0, 1.0)

    def flat_slope(t, xw):
        return slope_fn(t.reshape(-1),
                        xw.reshape(n * B, -1)).reshape(xw.shape)

    f0 = flat_slope(t_safe, x0)
    f1 = flat_slope(t_safe + dt_safe, x1)
    h00, h10, h01, h11 = _hermite_basis(th)
    yw = (h00[..., None] * x0 + (h10 * dt_safe)[..., None] * f0
          + h01[..., None] * x1 + (h11 * dt_safe)[..., None] * f1)
    return torch.where(rec[..., None], yw, 0.0)


def hermite_cubic(x0: Pytree, x1: Pytree, f0: Pytree, f1: Pytree, dt,
                  theta):
    """Cubic Hermite interpolant on [0, 1] with endpoint values and
    slopes."""
    h00, h10, h01, h11 = _hermite_basis(theta)

    def leaf(a, b, fa, fb):
        hdt = lc._match_scalar(dt, a)
        return (lc._match_scalar(h00, a) * a
                + lc._match_scalar(h10, a) * hdt * fa
                + lc._match_scalar(h01, a) * b
                + lc._match_scalar(h11, a) * hdt * fb)

    return pytree.tree_map(leaf, x0, x1, f0, f1)


def _grid_match(s, leaf_ndim):
    """A batch + (n_grid,) field shaped to broadcast against a batch +
    (n_grid,) + suffix leaf."""
    return s.reshape(s.shape + (1,) * (leaf_ndim - s.ndim))




def _interp_crossed(interp_kind, tab, x0, x1, idata, dt, theta, bn):
    """The interpolant at every grid time at once: theta batch +
    (n_grid,), leaves batch + suffix; returns batch + (n_grid,) + suffix
    leaves. ``"p_dense"``: ``idata`` is the stage slopes K, ``tab`` their
    tableau; ``"hermite"``: ``idata`` is (f0, f1)."""
    if interp_kind == "p_dense":
        P = tab.p_dense
        s, q = P.shape
        polys = [sum(float(P[j, k]) * theta**k
                     for k in range(q) if P[j, k] != 0.0)
                 for j in range(s)]
        dt_th = dt[..., None] * theta

        def leaf_p(a, *K):
            ae = a.unsqueeze(bn)
            acc = None
            for j in range(s):
                if isinstance(polys[j], (int, float)) and polys[j] == 0:
                    continue
                term = _grid_match(polys[j], ae.ndim) * K[j].unsqueeze(bn)
                acc = term if acc is None else acc + term
            return ae + _grid_match(dt_th, ae.ndim) * acc

        return pytree.tree_map(leaf_p, x0, *idata)
    if interp_kind != "hermite":
        raise ValueError(f"unknown interp_kind {interp_kind!r}")
    f0, f1 = idata
    h00, h10, h01, h11 = _hermite_basis(theta)
    hdt = dt[..., None] * torch.ones_like(theta)

    def leaf(a, b, fa, fb):
        ae = a.unsqueeze(bn)
        nd = ae.ndim
        return (_grid_match(h00, nd) * ae
                + _grid_match(h10 * hdt, nd) * fa.unsqueeze(bn)
                + _grid_match(h01, nd) * b.unsqueeze(bn)
                + _grid_match(h11 * hdt, nd) * fb.unsqueeze(bn))

    return pytree.tree_map(leaf, x0, x1, f0, f1)


def _dense_step(state, step_fn_dense: Callable, *, adaptive: bool,
                ctl: StepControl, error_norm: Callable, interp_kind: str,
                tab):
    """One free-running iteration (``dense._dense_step`` of the JAX
    package): only tf truncates dt, and the save times an accepted step
    crosses are recorded by interpolation. ``step_fn_dense(t, x, dt) ->
    (x_next, err, idata)``, or ``(t, x, dt, carry) -> (x_next, err, idata,
    carry_next)`` where ``state.carry`` is not empty."""
    t_grid = state.ts_grid
    n_grid = t_grid.shape[0]
    bn = state.t.ndim
    running = state.status == RUNNING

    tf = t_grid[-1]
    rem = (tf - state.t) - state.t_lo
    at_end = rem.abs() <= end_tolerance(tf, ctl.strict_end_test)
    stepping = running & ~at_end
    # dt = 0 on masked lanes keeps discarded evaluations finite
    dt = torch.where(stepping, torch.minimum(state.h, rem), 0.0)

    has_carry = len(pytree.tree_leaves(state.carry)) > 0
    if has_carry:
        x_next, err, idata, carry_next = step_fn_dense(state.t, state.x, dt,
                                                       state.carry)
    else:
        x_next, err, idata = step_fn_dense(state.t, state.x, dt)

    if adaptive:
        if err is None:
            raise ValueError("adaptive integration requires an error estimate")
        measure = masked_measure(error_norm, state.x, x_next, err, ctl,
                                 stepping)
        new_h, accept = controller_update(
            state.h, measure, ctl, prev_err_norm=state.err_norm,
            prev_rejected=state.reject_streak > 0)
    else:
        measure = state.err_norm
        new_h, accept = state.h, torch.ones_like(stepping)

    do_advance = stepping & accept
    do_reject = stepping & ~accept
    if ctl.time_compensated:
        t_new, t_lo_new = comp_time_advance(state.t, state.t_lo, dt)
    else:
        t_new, t_lo_new = state.t + dt, state.t_lo

    # every save time this accepted step crosses (index 0 records x0,
    # index n_grid - 1 is landed on exactly)
    tol = end_tolerance(t_grid)
    slot0 = ((torch.arange(n_grid, device=t_grid.device) == 0)
             & (state.n_iters == 0)[..., None] & running[..., None])
    crossed = (do_advance[..., None]
               & (t_grid > state.t[..., None] + tol)
               & (t_grid <= t_new[..., None] + tol)) | slot0
    # a double where: masked lanes carry dt = 0
    safe_dt = torch.where(dt > 0, dt, 1.0)
    theta = torch.clamp((t_grid - state.t[..., None]) / safe_dt[..., None],
                        0.0, 1.0)
    interp = _interp_crossed(interp_kind, tab, state.x, x_next, idata, dt,
                             theta, bn)

    # slot 0 records x0 directly: a first trial that overflowed would
    # poison theta = 0 through the interpolant as 0 * inf = NaN
    def record(buf, val, x0leaf):
        m = _grid_match(crossed, buf.ndim)
        m0 = _grid_match(slot0, buf.ndim)
        return torch.where(m0, x0leaf.unsqueeze(bn),
                           torch.where(m, val.to(buf.dtype), buf))

    ys = pytree.tree_map(record, state.ys, interp, state.x)

    t = torch.where(do_advance, t_new, state.t)
    t_lo = torch.where(do_advance, t_lo_new, state.t_lo)
    x = lc.tree_where(do_advance, x_next, state.x)
    carry = (lc.tree_where(do_advance, carry_next, state.carry)
             if has_carry else state.carry)
    if adaptive:
        prev_h = torch.where(stepping, state.h, state.prev_h)
        h = torch.where(stepping, new_h.to(state.h.dtype), state.h)
    else:
        prev_h, h = state.prev_h, state.h
    tgt_idx = (t_grid <= t[..., None] + end_tolerance(t_grid)).sum(
        -1).to(torch.int32)

    status = torch.where(running & at_end, DONE, state.status)
    n_iters = state.n_iters + running.to(torch.int32)
    status = torch.where((status == RUNNING) & (n_iters >= ctl.max_steps),
                         ERR_MAX_STEPS, status)
    streak = torch.where(do_reject, state.reject_streak + 1,
                         torch.where(do_advance, 0, state.reject_streak))
    if ctl.max_reject_streak > 0:
        status = torch.where(
            (status == RUNNING) & (streak >= ctl.max_reject_streak),
            ERR_STALLED, status)

    return state._replace(
        t=t, t_lo=t_lo, x=x, h=h, prev_h=prev_h, tgt_idx=tgt_idx,
        status=status,
        err_norm=torch.where(stepping, measure.to(state.err_norm.dtype),
                             state.err_norm),
        n_accept=state.n_accept + do_advance.to(torch.int32),
        n_reject=state.n_reject + do_reject.to(torch.int32),
        n_iters=n_iters, reject_streak=streak, ys=ys, carry=carry)


def integrate_interp(step_fn_dense: Callable, x0: Pytree,
                     t_grid: torch.Tensor, h0, *, adaptive: bool = True,
                     ctl: StepControl = StepControl(),
                     error_norm: Optional[Callable] = None,
                     interp_kind: str = "hermite", tab=None,
                     method: str = "while", batch_shape: tuple = (),
                     init_carry_fn: Optional[Callable] = None) -> Solution:
    """Free-running integration with interpolated saves at ``t_grid``:
    the step sequence is the one a solve without save points takes.
    ``step_fn_dense(t, x, dt) -> (x_next, err, idata)`` gives the
    interpolant's data (the stage slopes K for ``interp_kind="p_dense"``
    over ``tab``, the endpoint slopes (f0, f1) for ``"hermite"``);
    ``init_carry_fn(t0, x0)`` seeds a stepper carry, threaded as
    ``step_fn_dense(t, x, dt, carry) -> (..., carry_next)``.
    ``batch_shape`` builds a natively batched carry (``error_norm``
    defaults to ``lc.norm_l2`` on the scalar carry, ``norm_l2_batched``
    on a batched one). ``method="scan"`` runs exactly ``ctl.max_steps``
    iterations with no read of the device, as ``driver.integrate`` does.
    tf is landed on exactly: the last slot holds the true state where the
    trajectory reached it and keeps its recorded value elsewhere (zero if
    never reached)."""
    if error_norm is None:
        error_norm = _default_norm(bool(batch_shape))
    carry0 = () if init_carry_fn is None else init_carry_fn(t_grid[0], x0)
    state = init_state(x0, t_grid, h0, batch_shape, stepper_carry=carry0)
    body = functools.partial(
        _dense_step, step_fn_dense=step_fn_dense, adaptive=adaptive,
        ctl=ctl, error_norm=error_norm, interp_kind=interp_kind, tab=tab)
    if method == "while":
        while bool((state.status == RUNNING).any()):
            state = body(state)
    elif method == "scan":
        if ctl.max_steps > SCAN_GUARD:
            raise ValueError(
                f"method='scan' runs EXACTLY ctl.max_steps={ctl.max_steps} "
                "iterations; set a tight StepControl.max_steps")
        state = _run_scan(body, state, [ctl.max_steps])
    else:
        raise ValueError(f"unknown integrate_interp method: {method!r}")

    bn = state.t.ndim
    done = state.status == DONE

    def overwrite_last(buf, leaf):
        m = done.reshape(done.shape + (1,) * (leaf.ndim - bn))
        last = torch.where(m, leaf, buf.select(bn, buf.shape[bn] - 1))
        return torch.cat([buf.narrow(bn, 0, buf.shape[bn] - 1),
                          last.unsqueeze(bn)], dim=bn)

    return Solution(
        ts=state.ts_grid,
        ys=pytree.tree_map(overwrite_last, state.ys, state.x),
        t_final=state.t,
        y_final=state.x,
        status=state.status,
        n_accept=state.n_accept,
        n_reject=state.n_reject,
        n_iters=state.n_iters,
        h_final=state.h,
    )


def rk_dense_step(f: Callable, tableau, advance_lower: bool):
    """The dense step of an RK tableau and its carry seed, as
    :func:`solve_ivp_dense` builds them: (step_fn_dense, init_carry_fn or
    None, interp_kind). FSAL tableaus advancing the b solution thread the
    last stage (K is the p_dense data, or its ends the Hermite slopes);
    the others pay one evaluation for the Hermite right-end slope where
    they have no p_dense."""
    from .rk import rk_step_stages

    use_p = tableau.p_dense is not None and not advance_lower
    use_fsal = tableau.is_fsal and not advance_lower
    interp_kind = "p_dense" if use_p else "hermite"
    if use_fsal:
        def step_fn_dense(t, x, dt, k0):
            x_next, err, K, _ = rk_step_stages(
                f, t, x, dt, tableau, advance_lower=False, k0=k0)
            idata = tuple(K) if use_p else (K[0], K[-1])
            return x_next, err, idata, K[-1]

        return step_fn_dense, (lambda t, x: f(t, x)), interp_kind

    def step_fn_dense(t, x, dt):
        x_next, err, K, _ = rk_step_stages(f, t, x, dt, tableau,
                                           advance_lower=advance_lower)
        # without FSAL the right-end slope is a real extra evaluation
        # (K[-1] sits at x_b, not at the advanced lower solution)
        idata = tuple(K) if use_p else (K[0], f(t + dt, x_next))
        return x_next, err, idata

    return step_fn_dense, None, interp_kind


def solve_ivp_dense(f: Callable, t0, tf, y0: Pytree, *, tableau=None,
                    h0=None, adaptive: bool = True,
                    ctl: StepControl = StepControl(), save_at=None,
                    error_norm: Callable = lc.norm_l2, time_dtype=None,
                    advance_lower: Optional[bool] = None,
                    method: str = "while", batch_shape: tuple = (),
                    device="cuda") -> Solution:
    """``api.solve_ivp`` with interpolated (non-perturbing) saves.

    Tableaus with dense coefficients advancing the b solution use their
    continuous extension from the stage slopes (no extra RHS evaluation,
    FSAL reuse included); the others cubic Hermite, whose right-end slope
    costs one extra evaluation an attempt unless the tableau is FSAL.
    ``tableau`` defaults to RKF45; ``advance_lower`` to True (the
    reference's semantics) for a tableau without dense coefficients and
    to False for one with them, whose interpolant needs it.
    ``batch_shape`` runs a batched ``f`` on a natively batched carry (pass
    a per-trajectory ``error_norm``). The solve runs where ``y0`` lies;
    ``device`` places leaves that are not tensors, as in
    ``api.solve_ivp``."""
    from .api import _as_state, _device_of, _time_dtype
    from .tableaus import RKF45

    if tableau is None:
        tableau = RKF45
    if advance_lower is None:
        advance_lower = tableau.p_dense is None
    y0 = _as_state(y0, device)
    if time_dtype is None:
        time_dtype = _time_dtype(t0, tf)
    t_grid = make_grid(t0, tf, save_at, dtype=time_dtype,
                       device=_device_of(y0))
    if h0 is None:
        h0 = ctl.init_h()
    step_fn_dense, init_carry_fn, interp_kind = rk_dense_step(
        f, tableau, advance_lower)
    return integrate_interp(
        step_fn_dense, y0, t_grid, h0, adaptive=adaptive, ctl=ctl,
        error_norm=error_norm, interp_kind=interp_kind, tab=tableau,
        method=method, batch_shape=batch_shape, init_carry_fn=init_carry_fn)


def linear_slope(stepper, op_fn: Optional[Callable]) -> Callable:
    """The slope A(t) x of an exponential stepper's problem, for the
    Hermite interpolant: a split-pair solver's (La, Lb) through both
    splits, a stepper's split through ``apply_l``, a modulated stepper's
    operator through ``op.assemble``."""
    if hasattr(stepper, "sp_a"):
        # split-pair solvers also expose ``split`` (= sp_a), but their
        # op_fn yields the pair (La, Lb)
        from .exp.splits import _Pair

        pair = _Pair(stepper.sp_a, stepper.sp_b)
        return lambda t, x: pair.apply_l(op_fn(t), x)
    split = getattr(stepper, "split", None)
    if split is not None:
        return lambda t, x: split.apply_l(op_fn(t), x)
    op = getattr(stepper, "op", None)
    if op is not None:
        from .ops.cplx import Cplx, cmatvec

        def slope(t, x):
            A = op.assemble(t)
            if isinstance(A, Cplx):
                return cmatvec(A, x)
            return torch.einsum("...ij,...j->...i", A, x)

        return slope
    raise ValueError("stepper must carry its split(s) for dense output slopes")


def solve_linear_dense(op_fn: Optional[Callable], t0, tf, y0: Pytree, *,
                       stepper, h0=None, adaptive: bool = False,
                       ctl: StepControl = StepControl(), save_at=None,
                       error_norm: Callable = lc.norm_l2, time_dtype=None,
                       method: str = "while", device="cuda") -> Solution:
    """``api.solve_linear`` with interpolated saves: the Hermite endpoint
    slopes are dx/dt = A(t) x (:func:`linear_slope`). ``stepper`` is an
    exponential stepper with its split (``ExpMidpoint``, ``Magnus4``,
    ``CFM4``, ...), a split-pair solver (``SplitMidpoint``, whose op_fn
    yields (La, Lb)) or a modulated stepper (op_fn None)."""
    from .api import _as_state, _device_of, _time_dtype

    y0 = _as_state(y0, device)
    if time_dtype is None:
        time_dtype = _time_dtype(t0, tf)
    t_grid = make_grid(t0, tf, save_at, dtype=time_dtype,
                       device=_device_of(y0))
    if h0 is None:
        h0 = ctl.init_h()
    slope = linear_slope(stepper, op_fn)
    inner = stepper.make_step_fn(op_fn)

    def step_fn_dense(t, x, dt):
        x_next, err = inner(t, x, dt)
        return x_next, err, (slope(t, x), slope(t + dt, x_next))

    return integrate_interp(
        step_fn_dense, y0, t_grid, h0, adaptive=adaptive, ctl=ctl,
        error_norm=error_norm, interp_kind="hermite", method=method)

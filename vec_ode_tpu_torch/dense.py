"""Dense output: interpolated saves without hitting the grid, the
counterpart of ``vec_ode_tpu/dense.py`` (its cubic-Hermite kind on the
natively batched carry).

The controller runs free (only tf truncates a step) and every save time
a step crosses is filled from that step's own data: the cubic Hermite
interpolant of (x, f) at both ends. The loop kernel records the crossing
steps' endpoints instead (``ops/fused_loop.py``) and
:func:`hermite_from_endpoints` evaluates all of them in one batch.

Not here: ``solve_ivp_dense`` / ``solve_linear_dense`` and the RK
stage-interpolation kinds, which run on the scalar and vmapped tiers
(ROADMAP queue 1 item 13).
"""

from __future__ import annotations

from typing import Any, Callable

import torch
from torch.utils import _pytree as pytree

from . import lc
from .controller import (StepControl, controller_update, end_tolerance,
                         error_measure)
from .driver import (DONE, ERR_MAX_STEPS, ERR_STALLED, RUNNING, Solution,
                     comp_time_advance, init_state)

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


def _interp_crossed(x0, x1, idata, dt, theta, bn):
    """The Hermite interpolant at every grid time at once: theta batch +
    (n_grid,), leaves batch + suffix; returns batch + (n_grid,) + suffix
    leaves."""
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
                ctl: StepControl, error_norm: Callable):
    """One free-running iteration (``dense._dense_step`` of the JAX
    package, Hermite kind): only tf truncates dt, and the save times an
    accepted step crosses are recorded by interpolation."""
    t_grid = state.ts_grid
    n_grid = t_grid.shape[0]
    bn = state.t.ndim
    running = state.status == RUNNING

    tf = t_grid[-1]
    rem = (tf - state.t) - state.t_lo
    at_end = rem.abs() <= end_tolerance(tf, ctl.strict_end_test)
    stepping = running & ~at_end
    dt = torch.where(stepping, torch.minimum(state.h, rem), 0.0)

    x_next, err, idata = step_fn_dense(state.t, state.x, dt)

    if adaptive:
        if err is None:
            raise ValueError("adaptive integration requires an error estimate")
        err_safe = lc.tree_where(stepping, err,
                                 pytree.tree_map(torch.ones_like, err))
        measure = error_measure(error_norm, state.x, x_next, err_safe, ctl)
        measure = torch.where(stepping, measure, 1.0)
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
    safe_dt = torch.where(dt > 0, dt, 1.0)
    theta = torch.clamp((t_grid - state.t[..., None]) / safe_dt[..., None],
                        0.0, 1.0)
    interp = _interp_crossed(state.x, x_next, idata, dt, theta, bn)

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
        n_iters=n_iters, reject_streak=streak, ys=ys)


def integrate_interp(step_fn_dense: Callable, x0: Pytree,
                     t_grid: torch.Tensor, h0, *, adaptive: bool = True,
                     ctl: StepControl = StepControl(),
                     error_norm: Callable = lc.norm_l2_batched,
                     batch_shape: tuple) -> Solution:
    """Free-running integration over the natively batched carry with
    cubic-Hermite saves at ``t_grid``: the step sequence is the one a
    solve without save points takes. ``step_fn_dense(t, x, dt) ->
    (x_next, err, (f0, f1))`` gives the step's endpoint slopes. tf is
    landed on exactly: the last slot holds the true state where the
    trajectory reached it and keeps its recorded value elsewhere (zero if
    never reached)."""
    state = init_state(x0, t_grid, h0, batch_shape)
    while bool((state.status == RUNNING).any()):
        state = _dense_step(state, step_fn_dense, adaptive=adaptive,
                            ctl=ctl, error_norm=error_norm)

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

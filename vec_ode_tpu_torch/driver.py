"""The integration driver: the step-control state machine of
``vec_ode_tpu/driver.py`` (``step_once`` / ``integrate``) in eager torch,
over one trajectory (``batch_shape=()``, the scalar carry) or a natively
batched carry.

Each iteration computes boolean masks per trajectory (stepping /
at-checkpoint / at-end / accept) and applies ``where``-selected updates,
exactly as the JAX driver does, so the two agree per trajectory on
status, counters and the sequence of accepted and rejected steps. The
loop itself is a Python ``while`` whose condition reads one bool from the
device per iteration.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch
from torch.utils import _pytree as pytree

from . import lc
from .controller import (StepControl, controller_update, end_tolerance,
                         error_measure)

Pytree = Any

# Status codes (terminal loop states).
RUNNING = 0
DONE = 1
ERR_MAX_STEPS = 2
ERR_STALLED = 3   # reject streak reached StepControl.max_reject_streak
ERR_BAD_GRID = 4  # negative remaining time (misordered grid)
DONE_EVENT = 5    # a terminal event was located (events.py)


def comp_time_advance(t, t_lo, dt):
    """Compensated (double-word) time accumulation: TwoSum of (t, dt)
    folded into the residual word ``t_lo`` and renormalized (Fast2Sum), so
    the hi word stays the correctly rounded running sum. Bitwise the same
    operations as the JAX package's ``comp_time_advance``."""
    s = t + dt
    bp = s - t
    e_lo = (t - (s - bp)) + (dt - bp)
    lo = t_lo + e_lo
    hi = s + lo
    lo = lo - (hi - s)
    return hi, lo


# Event codes: which branch the last iteration took.
EVT_NONE = 0
EVT_STEP = 1     # accepted step
EVT_CHKPT = 2    # save-grid hit
EVT_REJECT = 3   # rejected step
EVT_END = 4      # end reached


class IntState(NamedTuple):
    """Loop carry; every per-trajectory field has the leading batch axes
    (none for the scalar carry)."""

    t: torch.Tensor
    t_lo: torch.Tensor    # residual word of the compensated (hi, lo) time
    x: Pytree
    h: torch.Tensor       # current trial step size
    prev_h: torch.Tensor  # last step size before the controller update
    tgt_idx: torch.Tensor  # cursor into the save grid
    status: torch.Tensor
    last_event: torch.Tensor
    err_norm: torch.Tensor  # most recent error measure
    n_accept: torch.Tensor
    n_reject: torch.Tensor
    n_iters: torch.Tensor
    reject_streak: torch.Tensor
    ys: Pytree            # (B, n_grid, ...) states recorded on the grid
    ts_grid: torch.Tensor  # (n_grid,) save grid, [0] = t0, [-1] = tf
    ev: Pytree = ()       # events.EventState, or () without events


def make_grid(t0, tf, save_at=None, dtype=torch.float64, device="cuda"):
    """The save grid [t0, *save_at, tf], on the card unless ``device``
    names another. ``save_at`` must be strictly increasing and strictly
    inside (t0, tf)."""
    t0 = torch.as_tensor(t0, dtype=dtype, device=device).reshape(1)
    tf = torch.as_tensor(tf, dtype=dtype, device=device).reshape(1)
    if save_at is None:
        return torch.cat([t0, tf])
    save_at = torch.as_tensor(save_at, dtype=dtype, device=device).reshape(-1)
    lo, hi = float(t0), float(tf)
    if save_at.numel() and (
        bool((save_at <= lo).any()) or bool((save_at >= hi).any())
        or bool((torch.diff(save_at) <= 0).any())
    ):
        raise ValueError(
            f"save_at must be strictly increasing and strictly inside "
            f"({lo}, {hi}); got {save_at.tolist()}"
        )
    return torch.cat([t0, save_at, tf])


def init_state(x0: Pytree, t_grid: torch.Tensor, h0,
               batch_shape: tuple = (), event_state: Pytree = ()) -> IntState:
    """The loop carry at t0. Every leaf of ``x0`` carries the leading
    ``batch_shape`` (``()``: one trajectory); ``h0`` is a scalar or
    per-trajectory;
    ``event_state`` is an ``events.EventState`` or ()."""
    tdt, dev = t_grid.dtype, t_grid.device
    n_grid = t_grid.shape[0]
    t0 = t_grid[0].expand(batch_shape).clone()
    h0 = torch.as_tensor(h0, dtype=tdt, device=dev).expand(
        batch_shape).clone()
    nb = len(batch_shape)
    ys = pytree.tree_map(
        lambda a: torch.zeros(batch_shape + (n_grid,) + a.shape[nb:],
                              dtype=a.dtype, device=a.device),
        x0,
    )
    zero_i = torch.zeros(batch_shape, dtype=torch.int32, device=dev)
    return IntState(
        t=t0,
        t_lo=torch.zeros(batch_shape, dtype=tdt, device=dev),
        x=x0,
        h=h0,
        prev_h=h0,
        tgt_idx=zero_i,
        status=zero_i,
        last_event=zero_i,
        err_norm=torch.zeros(batch_shape, dtype=tdt, device=dev),
        n_accept=zero_i,
        n_reject=zero_i,
        n_iters=zero_i,
        reject_streak=zero_i,
        ys=ys,
        ts_grid=t_grid,
        ev=event_state,
    )


def _default_norm(batched: bool) -> Callable:
    return lc.norm_l2_batched if batched else lc.norm_l2


def step_once(state: IntState, step_fn: Callable, *, adaptive: bool,
              ctl: StepControl, error_norm: Optional[Callable] = None,
              record_ys: bool = True, event_cfg=None) -> IntState:
    """One driver iteration over one trajectory or the whole batch (the
    JAX ``step_once``, without ``grad_safe``).

    ``step_fn(t, x, dt) -> (x_next, err)`` is called on every iteration;
    lanes that do not step get dt = 0, and their results are discarded
    (the scalar JAX driver skips the call on such iterations instead: the
    same result, one evaluation fewer). ``err`` may be None for a stepper
    with no error estimate, which adaptive mode refuses. ``error_norm``
    reduces ``err`` per trajectory (default ``lc.norm_l2`` for the scalar
    carry, ``lc.norm_l2_batched`` for a batched one; the identity for
    steppers that return norms already). ``record_ys=False`` skips
    recording the save grid.
    ``event_cfg`` (an ``events.EventConfig``, with ``state.ev`` its state)
    runs the event search as step control: a search vetoes the advance
    before it is applied, and its step size overrides the controller's
    after the grid-hit restore.
    """
    if error_norm is None:
        error_norm = _default_norm(state.t.ndim > 0)
    t_grid = state.ts_grid
    n_grid = t_grid.shape[0]
    running = state.status == RUNNING

    # consult the save grid: remaining time to the next grid point
    idx = torch.clamp(state.tgt_idx, max=n_grid - 1)
    chk_t = t_grid[idx.long()]
    # compensated remaining time subtracts the residual word too
    rem = (chk_t - state.t) - state.t_lo
    at_grid = rem.abs() <= end_tolerance(chk_t, ctl.strict_end_test)
    past_end = state.tgt_idx >= n_grid - 1
    is_end = running & at_grid & past_end
    is_chkpt = running & at_grid & ~past_end
    bad_grid = running & ~at_grid & (rem < 0)
    stepping = running & ~at_grid & ~bad_grid
    # masked-out lanes step with dt = 0 (a no-op step)
    dt = torch.where(stepping, torch.minimum(state.h, rem), 0.0)

    x_next, err = step_fn(state.t, state.x, dt)

    if adaptive:
        if err is None:
            raise ValueError("adaptive integration requires an error estimate")
        # masked lanes get a unit error and a unit measure: their h and
        # accept are discarded below
        err_safe = lc.tree_where(
            stepping, err, pytree.tree_map(torch.ones_like, err))
        measure = error_measure(error_norm, state.x, x_next, err_safe, ctl)
        if measure.ndim != stepping.ndim:
            raise ValueError(
                "error_norm reduced a batched state to shape "
                f"{tuple(measure.shape)} but the batch is "
                f"{tuple(stepping.shape)}; use a PER-TRAJECTORY norm "
                "(lc.norm_l2_batched)"
            )
        measure = torch.where(stepping, measure, 1.0)
        new_h, accept = controller_update(
            state.h, measure, ctl, prev_err_norm=state.err_norm,
            prev_rejected=state.reject_streak > 0,
        )
    else:
        measure = state.err_norm
        new_h, accept = state.h, torch.ones_like(stepping)

    has_events = (event_cfg is not None
                  and len(pytree.tree_leaves(state.ev)) > 0)
    if has_events:
        from .events import event_step

        eo = event_step(event_cfg, state.ev, state.t, dt, state.x, x_next,
                        stepping, accept)
        accept = eo.accept

    do_advance = stepping & accept
    do_reject = stepping & ~accept

    if ctl.time_compensated:
        t_hi, t_lo_new = comp_time_advance(state.t, state.t_lo, dt)
        t = torch.where(do_advance, t_hi, state.t)
        t_lo = torch.where(do_advance, t_lo_new, state.t_lo)
    else:
        t = torch.where(do_advance, state.t + dt, state.t)
        t_lo = state.t_lo
    x = lc.tree_where(do_advance, x_next, state.x)

    # the step size is updated on every attempted step ...
    if adaptive:
        prev_h = torch.where(stepping, state.h, state.prev_h)
        h = torch.where(stepping, new_h.to(state.h.dtype), state.h)
    else:
        prev_h, h = state.prev_h, state.h
    # ... and a grid hit restores the pre-truncation step
    hit_grid = at_grid & running
    h = torch.where(hit_grid, prev_h, h)
    tgt_idx = torch.where(hit_grid, state.tgt_idx + 1, state.tgt_idx)
    if has_events:
        # the search overrides the controller's h; a locate restores the
        # pre-search step
        h = torch.where(eo.search, eo.h_override.to(h.dtype), h)
        h = torch.where(eo.restore_h, eo.h_entry.to(h.dtype), h)
        prev_h = torch.where(eo.restore_h, eo.h_entry.to(h.dtype), prev_h)

    if record_ys:
        hit = (torch.arange(n_grid, device=idx.device) == idx[..., None]) \
            & hit_grid[..., None]                        # (B, n_grid)

        def record(buf, leaf):
            m = hit.reshape(hit.shape + (1,) * (leaf.ndim - idx.ndim))
            return torch.where(m, leaf.unsqueeze(idx.ndim), buf)

        ys = pytree.tree_map(record, state.ys, state.x)
    else:
        ys = state.ys

    status = torch.where(is_end, DONE, state.status)
    status = torch.where(bad_grid, ERR_BAD_GRID, status)
    n_iters = state.n_iters + running.to(torch.int32)
    status = torch.where((status == RUNNING) & (n_iters >= ctl.max_steps),
                         ERR_MAX_STEPS, status)
    # search iterations are not numerical rejections
    true_reject = do_reject & ~eo.search if has_events else do_reject
    if has_events:
        status = torch.where(eo.terminal_hit, DONE_EVENT, status)
    streak = torch.where(
        true_reject, state.reject_streak + 1,
        torch.where(do_advance, 0, state.reject_streak),
    )
    if ctl.max_reject_streak > 0:
        status = torch.where(
            (status == RUNNING) & (streak >= ctl.max_reject_streak),
            ERR_STALLED, status,
        )

    event = torch.full_like(state.last_event, EVT_NONE)
    event = torch.where(do_advance, EVT_STEP, event)
    event = torch.where(do_reject, EVT_REJECT, event)
    event = torch.where(is_chkpt, EVT_CHKPT, event)
    event = torch.where(is_end, EVT_END, event)

    return IntState(
        t=t,
        t_lo=t_lo,
        x=x,
        h=h,
        prev_h=prev_h,
        tgt_idx=tgt_idx,
        status=status,
        last_event=event,
        err_norm=torch.where(stepping, measure.to(state.err_norm.dtype),
                             state.err_norm),
        n_accept=state.n_accept + do_advance.to(torch.int32),
        n_reject=state.n_reject + true_reject.to(torch.int32),
        n_iters=n_iters,
        reject_streak=streak,
        ys=ys,
        ts_grid=state.ts_grid,
        ev=eo.ev_next if has_events else state.ev,
    )


@dataclasses.dataclass
class Solution:
    """Integration result, with the fields of the JAX package's
    ``Solution``. ``ts``/``ys`` follow the save grid.

    ``path`` names the execution path that produced the result:
    ``"torch-driver"`` (this module's driver over a plain torch step),
    ``"torch-driver+cuda-step"`` (the same driver, each step one launch of
    the hand-written CUDA kernel in ``ops/fused_rk.py``),
    ``"cuda-loop-persistent"`` (the whole loop in one launch of the CUDA
    loop kernel in ``ops/fused_loop.py``), ``"cuda-loop-chunked"`` (the
    same kernel, a launch per chunk of iterations) or ``"torch-loop"``
    (that kernel's plain twin, which the modulated exponential steppers
    run on CPU tensors)."""

    ts: torch.Tensor
    ys: Pytree
    t_final: torch.Tensor
    y_final: Pytree
    status: torch.Tensor
    n_accept: torch.Tensor
    n_reject: torch.Tensor
    n_iters: torch.Tensor
    h_final: torch.Tensor
    n_rhs_evals: Optional[torch.Tensor] = None
    event_t: Optional[torch.Tensor] = None
    event_found: Optional[torch.Tensor] = None
    event_y: Optional[Pytree] = None
    event_t_k: Optional[torch.Tensor] = None
    event_count: Optional[torch.Tensor] = None
    path: str = "torch-driver"

    @property
    def success(self):
        return (self.status == DONE) | (self.status == DONE_EVENT)

    def __repr__(self):
        def fmt(v):
            if isinstance(v, torch.Tensor) and v.ndim:
                return f"<{v.dtype}{list(v.shape)}>"
            return str(v)

        leaves = pytree.tree_leaves(self.ys)
        ys_s = fmt(leaves[0]) if leaves else "<empty>"
        return (
            f"Solution(status={fmt(self.status)}, t_final={fmt(self.t_final)},"
            f" n_accept={fmt(self.n_accept)}, n_reject={fmt(self.n_reject)},"
            f" h_final={fmt(self.h_final)}, ys={ys_s}, path={self.path!r})"
        )


_SCAN = ("method='scan', grad_safe and remat_levels (gradients through "
         "the driver) are ROADMAP queue 1 item 22")


def integrate(step_fn: Callable, x0: Pytree, t_grid: torch.Tensor, h0, *,
              adaptive: bool = True, ctl: StepControl = StepControl(),
              error_norm: Optional[Callable] = None,
              method: str = "while", batch_shape: tuple = (),
              event_cfg=None, remat_levels: int = 0,
              grad_safe: bool = False) -> Solution:
    """Run the loop over [t_grid[0], t_grid[-1]] until no trajectory is
    RUNNING: one trajectory for ``batch_shape=()``, else a natively
    batched carry; ``event_cfg`` (``events.EventConfig``) locates events
    on the way. ``remat_levels`` and ``grad_safe`` raise
    ``NotImplementedError`` (item 22)."""
    if remat_levels or grad_safe:
        raise NotImplementedError(_SCAN)
    ev0 = ()
    if event_cfg is not None:
        from .events import init_event_state

        ev0 = init_event_state(event_cfg, t_grid[0].expand(batch_shape), x0,
                               batch_shape=batch_shape)
    state = init_state(x0, t_grid, h0, batch_shape, event_state=ev0)
    return resume(state, step_fn, adaptive=adaptive, ctl=ctl,
                  error_norm=error_norm, method=method, event_cfg=event_cfg)


def resume(state: IntState, step_fn: Callable, *, adaptive: bool = True,
           ctl: StepControl = StepControl(),
           error_norm: Optional[Callable] = None,
           method: str = "while", event_cfg=None) -> Solution:
    """Continue integration from an existing carry.

    On the default [t0, tf] grid the loop records nothing: ys is rebuilt
    afterwards as [x0, x_final], with the final slot left as it was for
    trajectories that did not reach the end (the JAX driver does the
    same)."""
    if method != "while":
        raise NotImplementedError(f"method={method!r}: {_SCAN}")
    bn = state.t.ndim
    if error_norm is None:
        error_norm = _default_norm(bn > 0)
    elide_ys = state.ts_grid.shape[0] == 2
    init_x, init_ys, init_tgt = state.x, state.ys, state.tgt_idx

    # one host sync per iteration: the loop's condition
    while bool((state.status == RUNNING).any()):
        state = step_once(state, step_fn, adaptive=adaptive, ctl=ctl,
                          error_norm=error_norm, record_ys=not elide_ys,
                          event_cfg=event_cfg)

    ys = state.ys
    if elide_ys:
        ys0 = lc.tree_where(init_tgt == 0, init_x,
                            pytree.tree_map(lambda a: a.select(bn, 0),
                                            init_ys))
        ys1 = lc.tree_where(state.tgt_idx >= 2, state.x,
                            pytree.tree_map(lambda a: a.select(bn, 1),
                                            init_ys))
        ys = pytree.tree_map(lambda a, b: torch.stack([a, b], dim=bn),
                             ys0, ys1)
    ev_kw = {}
    if event_cfg is not None and len(pytree.tree_leaves(state.ev)) > 0:
        ev_kw = dict(
            event_t=state.ev.t_ev[..., 0],
            event_found=state.ev.found,
            event_y=state.ev.y_ev if event_cfg.record_y else None,
            event_t_k=state.ev.t_ev,
            event_count=state.ev.count,
        )
    return Solution(
        ts=state.ts_grid,
        ys=ys,
        t_final=state.t,
        y_final=state.x,
        status=state.status,
        n_accept=state.n_accept,
        n_reject=state.n_reject,
        n_iters=state.n_iters,
        h_final=state.h,
        **ev_kw,
    )

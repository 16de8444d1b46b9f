"""The integration driver: the step-control state machine of
``vec_ode_tpu/driver.py`` (``step_once`` / ``integrate``) in eager torch,
over one trajectory (``batch_shape=()``, the scalar carry) or a natively
batched carry.

Each iteration computes boolean masks per trajectory (stepping /
at-checkpoint / at-end / accept) and applies ``where``-selected updates,
exactly as the JAX driver does, so the two agree per trajectory on
status, counters and the sequence of accepted and rejected steps. Two
loops run the iteration: ``method="while"``, a Python ``while`` whose
condition reads one bool from the device per iteration (on a CUDA card
where the device is the slower side, one iteration late, so that the
next iteration is queued while the card runs the last), and
``method="scan"``, exactly ``ctl.max_steps`` iterations with no read of
the device at all (lanes no longer RUNNING step with dt = 0 and keep
their state), which autograd differentiates, ``remat_levels`` nesting it
under ``torch.utils.checkpoint``.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import time
from typing import Any, Callable, NamedTuple, Optional

import torch
from torch.utils import _pytree as pytree
from torch.utils.checkpoint import checkpoint

from . import lc, telemetry
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
    carry: Pytree = ()    # the stepper's carry (e.g. the FSAL slope), or ()
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
    lo, hi = telemetry.read("grid", t0), telemetry.read("grid", tf)
    if save_at.numel() and (
        telemetry.read("grid", (save_at <= lo).any())
        or telemetry.read("grid", (save_at >= hi).any())
        or telemetry.read("grid", (torch.diff(save_at) <= 0).any())
    ):
        raise ValueError(
            f"save_at must be strictly increasing and strictly inside "
            f"({lo}, {hi}); got {save_at.tolist()}"
        )
    return torch.cat([t0, save_at, tf])


def init_state(x0: Pytree, t_grid: torch.Tensor, h0,
               batch_shape: tuple = (), stepper_carry: Pytree = (),
               event_state: Pytree = ()) -> IntState:
    """The loop carry at t0. Every leaf of ``x0`` carries the leading
    ``batch_shape`` (``()``: one trajectory); ``h0`` is a scalar or
    per-trajectory; ``stepper_carry`` is the stepper's carry at (t0, x0)
    or (); ``event_state`` is an ``events.EventState`` or ()."""
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
        carry=stepper_carry,
        ev=event_state,
    )


def _default_norm(batched: bool) -> Callable:
    return lc.norm_l2_batched if batched else lc.norm_l2


def masked_measure(error_norm: Callable, x, x_next, err, ctl: StepControl,
                   valid: torch.Tensor) -> torch.Tensor:
    """The controller's error measure, 1 on lanes that are not ``valid``.
    Masked lanes get a unit error and a unit measure (a double where): a
    zero error's norm has a NaN derivative and f = rtol / 0 an infinite
    one. Under autograd a valid lane whose error is exactly zero (a step
    so short that its stages agree to the last bit, which the JAX
    package's fused arithmetic rounds to a tiny nonzero instead) keeps
    its measure 0, f = inf, with no gradient through it, for the same
    reason."""
    ones = pytree.tree_map(torch.ones_like, err)
    measure = error_measure(error_norm, x, x_next,
                            lc.tree_where(valid, err, ones), ctl)
    if torch.is_grad_enabled() and any(
            a.requires_grad for a in pytree.tree_leaves(err)):
        exact = valid & (measure.detach() == 0)
        measure = torch.where(exact, measure.detach(), error_measure(
            error_norm, x, x_next, lc.tree_where(valid & ~exact, err, ones),
            ctl))
    return torch.where(valid, measure, 1.0)


def _check_batched(state: IntState, batched) -> int:
    """The carry's batch rank; ``batched`` (None: taken from the carry)
    must agree with it."""
    bn = state.t.ndim
    if batched is not None and bool(batched) != (bn > 0):
        raise ValueError(
            f"batched={batched!r} disagrees with the carry: state.t has "
            f"shape {tuple(state.t.shape)} (init_state's batch_shape)")
    return bn


def _detached(tree: Pytree) -> Pytree:
    return pytree.tree_map(
        lambda a: a.detach() if isinstance(a, torch.Tensor) else a, tree)


def step_once(state: IntState, step_fn: Callable, *, adaptive: bool,
              ctl: StepControl, error_norm: Optional[Callable] = None,
              batched: Optional[bool] = None, record_ys: bool = True,
              event_cfg=None, grad_safe: bool = False) -> IntState:
    """One driver iteration over one trajectory or the whole batch (the
    JAX ``step_once``).

    ``step_fn(t, x, dt) -> (x_next, err)`` is called on every iteration,
    or ``step_fn(t, x, dt, carry) -> (x_next, err, carry_next)`` where
    ``state.carry`` is not empty (the carry advances only with the
    state); lanes that do not step get dt = 0, and their results are
    discarded (the scalar JAX driver skips the call on such iterations
    instead: the same result, one evaluation fewer). ``err`` may be None
    for a stepper with no error estimate, which adaptive mode refuses.
    ``error_norm`` reduces ``err`` per trajectory (default ``lc.norm_l2``
    for the scalar carry, ``lc.norm_l2_batched`` for a batched one; the
    identity for steppers that return norms already). ``batched`` is
    checked against the carry (``state.t.ndim``). ``record_ys=False``
    skips recording the save grid.
    ``event_cfg`` (an ``events.EventConfig``, with ``state.ev`` its state)
    runs the event search as step control: a search vetoes the advance
    before it is applied, and its step size overrides the controller's
    after the grid-hit restore.

    ``grad_safe=True`` (adaptive only) decides accept / reject on a pass
    outside autograd and re-runs the stepper with dt = 0 on rejected
    lanes, so that a rejected trial which overflowed never enters the
    backward pass (0 cotangent x inf = NaN); the controller is then
    recomputed with gradients on the accepted lanes, which keeps their
    step-size sensitivity. It costs a second stepper evaluation.
    """
    bn = _check_batched(state, batched)
    if error_norm is None:
        error_norm = _default_norm(bn > 0)
    t_grid = state.ts_grid
    n_grid = t_grid.shape[0]
    running = state.status == RUNNING

    # consult the save grid: remaining time to the next grid point
    idx = torch.clamp(state.tgt_idx, max=n_grid - 1)
    chk_t = t_grid.index_select(0, idx.reshape(-1).long()).reshape(idx.shape)
    # compensated remaining time subtracts the residual word too
    rem = (chk_t - state.t) - state.t_lo
    at_grid = rem.abs() <= end_tolerance(chk_t, ctl.strict_end_test)
    past_end = state.tgt_idx >= n_grid - 1
    is_end = running & at_grid & past_end
    is_chkpt = running & at_grid & ~past_end
    bad_grid = running & ~at_grid & (rem < 0)
    stepping = running & ~at_grid & ~bad_grid
    # masked-out lanes step with dt = 0 (a no-op step), which keeps their
    # discarded evaluations finite for the backward pass
    dt = torch.where(stepping, torch.minimum(state.h, rem), 0.0)

    has_carry = len(pytree.tree_leaves(state.carry)) > 0

    def call_step(t, x, dt_, carry):
        if has_carry:
            return step_fn(t, x, dt_, carry)
        x_next_, err_ = step_fn(t, x, dt_)
        return x_next_, err_, ()

    def controller_block(x_next_c, err_c, x_ref, prev_err, valid):
        if err_c is None:
            raise ValueError("adaptive integration requires an error estimate")
        measure_c = masked_measure(error_norm, x_ref, x_next_c, err_c, ctl,
                                   valid)
        if measure_c.ndim != stepping.ndim:
            raise ValueError(
                "error_norm reduced a batched state to shape "
                f"{tuple(measure_c.shape)} but the batch is "
                f"{tuple(stepping.shape)}; use a PER-TRAJECTORY norm "
                "(lc.norm_l2_batched)"
            )
        new_h_c, accept_c = controller_update(
            state.h, measure_c, ctl, prev_err_norm=prev_err,
            prev_rejected=state.reject_streak > 0,
        )
        return measure_c, new_h_c, accept_c

    if adaptive and grad_safe:
        # the decision pass: no autograd on its inputs or outputs, so an
        # overflowed trial leaves no trace in the backward pass; the
        # controller reads state.h with its gradient, as the JAX
        # package's does
        with torch.no_grad():
            x_dec, err_dec, _ = call_step(*_detached(
                (state.t, state.x, dt, state.carry)))
        measure_dec, new_h_dec, accept = controller_block(
            x_dec, err_dec, _detached(state.x), state.err_norm.detach(),
            stepping)
        dt = torch.where(accept & stepping, dt, 0.0)
    x_next, err, carry_next = call_step(state.t, state.x, dt, state.carry)

    if adaptive and grad_safe:
        # accepted lanes recompute the same values with gradients; the
        # rejected ones keep the decision pass's
        measure2, new_h2, _ = controller_block(
            x_next, err, state.x, state.err_norm, accept & stepping)
        measure = torch.where(accept, measure2, measure_dec)
        new_h = torch.where(accept, new_h2, new_h_dec)
    elif adaptive:
        measure, new_h, accept = controller_block(
            x_next, err, state.x, state.err_norm, stepping)
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
    # the stepper's carry advances only with the state: on a reject or a
    # no-op the old carry (e.g. the FSAL slope f(t, x)) still holds
    carry = (lc.tree_where(do_advance, carry_next, state.carry)
             if has_carry else state.carry)

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
        carry=carry,
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


SCAN_GUARD = 65536


def scan_lengths(max_steps: int, remat_levels: int = 0) -> list:
    """The iteration counts of the nested scan levels, outermost first:
    ``[max_steps]`` without remat; with ``remat_levels = k`` k + 1 levels
    of about max_steps^(1/(k+1)) each, trimmed level by level while the
    product stays >= max_steps (the JAX package's rule; the extra
    iterations are no-ops that still pay a stepper evaluation)."""
    if remat_levels <= 0:
        return [int(max_steps)]
    L = int(remat_levels) + 1
    n = max(2, math.ceil(max_steps ** (1.0 / L)))
    lengths = [n] * L
    for i in range(L):
        while (lengths[i] > 1
               and (math.prod(lengths) // lengths[i])
               * (lengths[i] - 1) >= max_steps):
            lengths[i] -= 1
    return lengths


def _checkpointed(fn: Callable, state: IntState) -> IntState:
    """``fn(state)`` under ``torch.utils.checkpoint``: the floating
    tensors of the carry are its arguments, the integer ones (status,
    counters) ride along in the closure; the backward pass recomputes
    ``fn`` from the arguments instead of keeping its intermediates."""
    leaves, spec = pytree.tree_flatten(state)
    pos = [i for i, a in enumerate(leaves)
           if isinstance(a, torch.Tensor)
           and (a.is_floating_point() or a.is_complex())]

    def run(*floats):
        ls = list(leaves)
        for i, a in zip(pos, floats):
            ls[i] = a
        return tuple(pytree.tree_leaves(fn(pytree.tree_unflatten(ls, spec))))

    out = checkpoint(run, *[leaves[i] for i in pos], use_reentrant=False,
                     preserve_rng_state=False)
    return pytree.tree_unflatten(list(out), spec)


def _run_scan(body: Callable, state: IntState, lengths) -> IntState:
    """``prod(lengths)`` iterations of ``body``; every level inside the
    outermost runs under :func:`_checkpointed`. Nothing reads the device
    to decide a branch."""
    if len(lengths) == 1:
        for _ in range(lengths[0]):
            state = body(state)
        return state
    inner = functools.partial(_run_scan, body, lengths=lengths[1:])
    for _ in range(lengths[0]):
        state = _checkpointed(inner, state)
    return state


# the share of an iteration's enqueuing time that a read of the condition
# after it must wait for the device before the loop runs ahead
AHEAD_WAIT_SHARE = 0.5
# iterations the latest ``method="while"`` loop enqueued past its last and
# dropped: 1 where it ended running ahead, else 0
last_dropped = 0


class _Conditions:
    """The loop's condition on its way to the host. On a CUDA carry each
    one is copied without blocking into one of two pinned host slots and
    an event is recorded after the copy, so that reading it waits for
    that copy alone; elsewhere it is read where it lies."""

    def __init__(self, device: torch.device):
        self.events = None
        if device.type == "cuda":
            self.stream = torch.cuda.current_stream(device)
            self.slots = torch.empty(2, dtype=torch.bool, pin_memory=True)
            self.events = (torch.cuda.Event(), torch.cuda.Event())

    def post(self, k: int, state: IntState):
        """Enqueue the condition of the carry after ``k`` iterations."""
        cond = (state.status == RUNNING).any()
        if self.events is None:
            return cond, None
        slot, done = self.slots[k % 2], self.events[k % 2]
        slot.copy_(cond, non_blocking=True)
        done.record(self.stream)
        return slot, done

    @staticmethod
    def read(posted) -> bool:
        return telemetry.read("driver_cond", *posted)


def _lockstep() -> bool:
    """Whether other ranks of a process group may run the same loop: a
    body may then hold collectives, which pair only if every rank runs as
    many iterations."""
    import torch.distributed as dist

    return (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1)


def _pays_ahead(device: torch.device, waited: float,
                enqueued: float) -> bool:
    """Whether the loop should enqueue each next iteration before it
    reads the condition that admits it: on a CUDA device, where the read
    after an iteration waited for the device at least
    ``AHEAD_WAIT_SHARE`` of the time the host took to enqueue that
    iteration (``waited``, ``enqueued``, seconds). Running ahead hides
    about that wait an iteration and costs one dropped iteration a solve;
    where the device keeps up with the host, or the iteration itself
    waits for the device (a copy from host memory, a read of a value),
    the read waits little and running ahead would only add the dropped
    iteration. A CPU carry has no queue to run ahead on."""
    return device.type == "cuda" and waited >= AHEAD_WAIT_SHARE * enqueued


def _run_while(body: Callable, state: IntState) -> IntState:
    """``body`` while any trajectory is RUNNING, one read of the condition
    an iteration. The loop reads the condition before each iteration
    until :func:`_pays_ahead` finds, at a read, that the device is the
    slower side; from then on it reads it one iteration late: iteration
    k + 1 is enqueued from carry k before the condition of carry k is
    read, so the device has it queued when it finishes iteration k (so
    ``body`` must not write into its input carry). Either way the carry
    returned is the first whose condition reads false, and the condition
    is read as often; running ahead, the iteration enqueued from that
    carry is dropped (``last_dropped``). An error raised while enqueuing
    an iteration surfaces only if the condition that admits it reads
    true. Ranks of a process group never run ahead, so that each runs
    the same iterations."""
    global last_dropped
    last_dropped = 0
    device = state.status.device
    lockstep = _lockstep()
    conds = _Conditions(device)
    posted = conds.post(0, state)
    ahead, enqueued, it = False, math.inf, 0
    while True:
        admitted = not ahead
        if admitted:
            t0 = time.perf_counter()
            if not conds.read(posted):
                return state
            ahead = not lockstep and _pays_ahead(
                device, time.perf_counter() - t0, enqueued)
        t0 = time.perf_counter()
        try:
            with telemetry.span("vec_ode.driver.step", it):
                nxt = body(state)
                posted_nxt = conds.post(it + 1, nxt)
        except Exception:
            if not admitted and not conds.read(posted):
                last_dropped = 1
                return state
            raise
        enqueued = time.perf_counter() - t0
        if not admitted and not conds.read(posted):
            last_dropped = 1
            return state
        state, posted = nxt, posted_nxt
        it += 1


def integrate(step_fn: Callable, x0: Pytree, t_grid: torch.Tensor, h0, *,
              adaptive: bool = True, ctl: StepControl = StepControl(),
              error_norm: Optional[Callable] = None,
              method: str = "while", batch_shape: tuple = (),
              init_carry_fn: Optional[Callable] = None,
              event_cfg=None, remat_levels: int = 0,
              grad_safe: bool = False) -> Solution:
    """Run the loop over [t_grid[0], t_grid[-1]]: one trajectory for
    ``batch_shape=()``, else a natively batched carry; ``event_cfg``
    (``events.EventConfig``) locates events on the way.
    ``init_carry_fn(t0, x0)`` seeds a stepper carry threaded through the
    loop as ``step_fn(t, x, dt, carry) -> (x_next, err, carry_next)``
    (e.g. the FSAL first-stage slope, ``rk.RungeKutta.make_init_carry``).

    ``method="while"`` runs until no trajectory is RUNNING (one read of
    the device per iteration). ``method="scan"`` runs exactly
    ``ctl.max_steps`` iterations with no read of the device, so pick a
    tight ``max_steps``: autograd differentiates it. ``remat_levels=k``
    (scan only) nests k + 1 levels (:func:`scan_lengths`), each inner one
    under ``torch.utils.checkpoint``: the backward pass keeps the carries
    at level boundaries and recomputes the rest, and the 65536-iteration
    guard is lifted. ``grad_safe``: see :func:`step_once`."""
    with telemetry.span("vec_ode.driver.init"):
        carry0 = (() if init_carry_fn is None
                  else init_carry_fn(t_grid[0], x0))
        ev0 = ()
        if event_cfg is not None:
            from .events import init_event_state

            ev0 = init_event_state(event_cfg, t_grid[0].expand(batch_shape),
                                   x0, batch_shape=batch_shape)
        state = init_state(x0, t_grid, h0, batch_shape, stepper_carry=carry0,
                           event_state=ev0)
    return resume(state, step_fn, adaptive=adaptive, ctl=ctl,
                  error_norm=error_norm, method=method,
                  batched=bool(batch_shape), event_cfg=event_cfg,
                  remat_levels=remat_levels, grad_safe=grad_safe)


def resume(state: IntState, step_fn: Callable, *, adaptive: bool = True,
           ctl: StepControl = StepControl(),
           error_norm: Optional[Callable] = None,
           method: str = "while", batched: Optional[bool] = None,
           event_cfg=None, remat_levels: int = 0,
           grad_safe: bool = False) -> Solution:
    """Continue integration from an existing carry (the save-grid cursor,
    step size, counters and stepper carry carry over); ``method``,
    ``remat_levels`` and ``grad_safe`` as in :func:`integrate`,
    ``batched`` checked against the carry.

    On the default [t0, tf] grid the loop records nothing: ys is rebuilt
    afterwards as [x0, x_final], with the final slot left as it was for
    trajectories that did not reach the end (the JAX driver does the
    same).

    ``method="while"`` on a CUDA carry reads its condition one iteration
    late once the device is the slower side (:func:`_run_while`). It then
    enqueues one iteration past the last and drops it: ``step_fn``, and
    the callables it calls (an RHS, an ``op_fn``, a drive's
    ``coeff_fn``), run once more than the iterations, at each
    trajectory's final time with dt = 0, and nothing of that iteration
    reaches the ``Solution``."""
    bn = _check_batched(state, batched)
    if error_norm is None:
        error_norm = _default_norm(bn > 0)
    elide_ys = state.ts_grid.shape[0] == 2
    init_x, init_ys, init_tgt = state.x, state.ys, state.tgt_idx
    body = functools.partial(
        step_once, step_fn=step_fn, adaptive=adaptive, ctl=ctl,
        error_norm=error_norm, record_ys=not elide_ys, event_cfg=event_cfg,
        grad_safe=grad_safe)

    if method == "while":
        if remat_levels > 0:
            raise ValueError(
                "remat_levels only applies to method='scan' (reverse-mode "
                "checkpointing of a fixed-length scan); the default "
                "while-loop driver is not reverse-differentiable")
        # one host sync per iteration: the loop's condition, read one
        # iteration late where the device is the slower side
        state = _run_while(body, state)
    elif method == "scan":
        if ctl.max_steps > SCAN_GUARD and remat_levels == 0:
            raise ValueError(
                f"method='scan' runs EXACTLY ctl.max_steps={ctl.max_steps} "
                "iterations (every one pays a stepper evaluation). Set a "
                "tight StepControl.max_steps (the default 1,000,000 is a "
                "while-loop safety cap, not a scan length), or pass "
                "remat_levels >= 1 for checkpointed O(T^(1/(k+1))) memory.")
        state = _run_scan(body, state, scan_lengths(ctl.max_steps,
                                                    remat_levels))
    else:
        raise ValueError(f"unknown integrate method: {method!r}")

    with telemetry.span("vec_ode.solution"):
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

"""Event detection: locate roots of g(t, x(t)) during integration, the
counterpart of ``vec_ode_tpu/events.py``.

An event crossing is handled like a rejected step: when g changes sign
across an accepted trial step, the driver vetoes the advance and retries
from the same (t, x) with h = clip(theta, 0.1, 0.9) dt, theta = g0 / (g0
- g1) the regula-falsi estimate of the crossing inside the bracket, until
dt <= t_tol; then the step is accepted and the event recorded at t +
theta dt. Search iterations count neither as rejects nor toward the
reject streak, and the pre-search step size is restored after a locate.

Per :class:`Event`: the first ``EventConfig.max_crossings`` (K) crossings
in the requested ``direction`` are located (``Solution.event_t_k``, (B, E,
K)); every further one is counted (``Solution.event_count``).
``terminal=True`` ends the trajectory with ``DONE_EVENT`` at the first
located crossing, ``terminal=n`` at the n-th (n <= K). A zero of g at t0
is not a crossing.

Event functions are per-trajectory callables g(t, x) -> scalar, run by
the host driver (``driver.step_once``) through ``torch.func.vmap`` over
the batch, or declared observables (:class:`LinearObservable`,
:class:`QuadraticObservable`), which are callables too and which the loop
kernel (``ops/fused_loop.py``) also runs: it takes declared forms only,
so an opaque callable sends the solve to the host driver.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

Pytree = Any


@dataclasses.dataclass(frozen=True)
class Event:
    """One event function g(t, x) -> scalar per trajectory.

    ``direction``: +1 rising crossings only (g: - to +), -1 falling only,
    0 both. ``terminal``: False, True (= 1: end at the first crossing) or
    an int n >= 1 (end at the n-th; needs ``EventConfig.max_crossings >=
    n``)."""

    fn: Callable
    direction: int = 0
    terminal: Any = False

    def __post_init__(self):
        if self.direction not in (-1, 0, 1):
            raise ValueError(f"direction must be -1/0/+1, got {self.direction}")
        if isinstance(self.terminal, bool):
            pass
        elif isinstance(self.terminal, int):
            if self.terminal < 1:
                raise ValueError(
                    f"integer terminal must be >= 1, got {self.terminal}")
        else:
            raise TypeError(
                f"terminal must be bool or int, got "
                f"{type(self.terminal).__name__}")

    @property
    def terminal_count(self) -> int:
        """0 = non-terminal; n >= 1 = terminate at the n-th crossing."""
        if isinstance(self.terminal, bool):
            return 1 if self.terminal else 0
        return int(self.terminal)


def _as_f64_vec(w):
    a = np.asarray(w, np.float64)
    if a.ndim != 1:
        raise ValueError(f"observable coefficients must be 1-D, got "
                         f"shape {a.shape}")
    return a


def _coeffs(vals, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.asarray(vals), dtype=like.dtype,
                           device=like.device)


@dataclasses.dataclass(frozen=True)
class LinearObservable:
    """g(t, x) = <w, x> - c over the state's real components: ``w`` has
    length d for a real state of dim d, and 2d over the widened [re | im]
    layout for a ``Cplx`` pair."""

    w: Any
    c: float = 0.0

    kernel_kind = "lin"

    def __post_init__(self):
        object.__setattr__(self, "w", tuple(_as_f64_vec(self.w)))

    def __call__(self, t, x):
        if hasattr(x, "re"):   # Cplx pair: widened [re | im] layout
            d = x.re.shape[-1]
            if len(self.w) != 2 * d:
                raise ValueError(
                    f"LinearObservable on a complex state needs w of "
                    f"length 2*{d} over [re | im], got {len(self.w)}")
            wre = _coeffs(self.w[:d], x.re)
            wim = _coeffs(self.w[d:], x.re)
            return ((wre * x.re).sum(-1) + (wim * x.im).sum(-1)) - self.c
        return (_coeffs(self.w, x) * x).sum(-1) - self.c

    def kernel_row(self, d_part: int, n_parts: int):
        """Base (D,) row over the kernels' widened-real layout, or None."""
        w = np.asarray(self.w)
        return w if w.shape[0] == d_part * n_parts else None


@dataclasses.dataclass(frozen=True)
class QuadraticObservable:
    """g(t, x) = sum_i q_i |x_i|^2 - c (a diagonal quadratic form; the re
    and im blocks of a ``Cplx`` pair share q)."""

    q: Any
    c: float = 0.0

    kernel_kind = "quad"

    def __post_init__(self):
        object.__setattr__(self, "q", tuple(_as_f64_vec(self.q)))

    def __call__(self, t, x):
        if hasattr(x, "re"):
            if len(self.q) != x.re.shape[-1]:
                raise ValueError(
                    f"QuadraticObservable q length {len(self.q)} != state "
                    f"dim {x.re.shape[-1]}")
            qa = _coeffs(self.q, x.re)
            return (qa * (x.re * x.re + x.im * x.im)).sum(-1) - self.c
        return (_coeffs(self.q, x) * x * x).sum(-1) - self.c

    def kernel_row(self, d_part: int, n_parts: int):
        """Base (D,) row (q tiled over the re/im blocks), or None."""
        q = np.asarray(self.q)
        if q.shape[0] != d_part:
            return None
        return np.concatenate([q] * n_parts)


@dataclasses.dataclass(frozen=True)
class EventConfig:
    """The events of a solve and the bracket search's time tolerance.

    ``t_tol``: absolute tolerance of a located time (default 64 eps(time
    dtype) max(1, |t|)). ``record_y=False`` skips storing the state at the
    first crossing. ``max_crossings`` (K <= 64): located crossings per
    event; further ones are counted only."""

    events: tuple
    t_tol: Optional[float] = None
    record_y: bool = True
    max_crossings: int = 1

    def __post_init__(self):
        if not self.events:
            raise ValueError("EventConfig needs at least one Event")
        for e in self.events:
            if not isinstance(e, Event):
                raise TypeError(f"expected Event, got {type(e).__name__}")
        k = self.max_crossings
        if not isinstance(k, int) or k < 1:
            raise ValueError(f"max_crossings must be an int >= 1, got {k!r}")
        if k > 64:
            raise ValueError(
                f"max_crossings={k} > 64: record that many crossings with "
                "a dense save grid instead")
        for e in self.events:
            if e.terminal_count > k:
                raise ValueError(
                    f"terminal={e.terminal_count} needs max_crossings >= "
                    f"{e.terminal_count} (got {k}): the terminating "
                    "crossing must be a located one")

    @property
    def n(self) -> int:
        return len(self.events)

    def _int_row(self, vals, like: torch.Tensor) -> torch.Tensor:
        return torch.tensor(vals, dtype=torch.int32, device=like.device)

    def directions(self, like: torch.Tensor) -> torch.Tensor:
        return self._int_row([e.direction for e in self.events], like)

    def terminal_counts(self, like: torch.Tensor) -> torch.Tensor:
        """Per-event terminating crossing number (0 = non-terminal)."""
        return self._int_row([e.terminal_count for e in self.events], like)

    def time_tol(self, t: torch.Tensor) -> torch.Tensor:
        if self.t_tol is not None:
            return torch.full_like(t, self.t_tol)
        eps = torch.finfo(t.dtype).eps
        return 64.0 * eps * torch.clamp(t.abs(), min=1.0)

    def kernel_spec(self, d_part: int, n_parts: int):
        """The :class:`KernelEvents` of this config over a (d_part x
        n_parts)-widened state, or None when an event is not a declared
        observable the kernel can lay out (the loop kernel runs no Python
        callable)."""
        rows, kinds = [], []
        for e in self.events:
            kind = getattr(e.fn, "kernel_kind", None)
            row = None if kind is None else e.fn.kernel_row(d_part, n_parts)
            if row is None:
                return None
            rows.append(row)
            kinds.append(kind)
        return KernelEvents(
            n=self.n, kinds=tuple(kinds),
            dirs=tuple(e.direction for e in self.events),
            terminal=tuple(e.terminal_count for e in self.events),
            offsets=tuple(float(e.fn.c) for e in self.events),
            rows=np.stack(rows),
            t_tol=None if self.t_tol is None else float(self.t_tol),
            record_y=bool(self.record_y), k=int(self.max_crossings))

    def evaluate(self, t: torch.Tensor, x: Pytree) -> torch.Tensor:
        """Stacked g values, shape ``t.shape + (E,)``, in t's dtype.
        Declared observables reduce over the last axis directly; any other
        callable runs per trajectory, through ``torch.func.vmap`` over each
        leading axis of ``t``."""
        cols = []
        for e in self.events:
            if getattr(e.fn, "kernel_kind", None) is not None:
                g = e.fn(t, x)
            else:
                f = e.fn
                for _ in range(t.ndim):
                    f = torch.func.vmap(f)
                g = f(t, x)
            cols.append(torch.as_tensor(g).to(t.dtype).expand(t.shape))
        return torch.stack(cols, dim=-1)


@dataclasses.dataclass(frozen=True)
class KernelEvents:
    """The loop kernel's rendering of an :class:`EventConfig` (made by
    :meth:`EventConfig.kernel_spec`): per-event reduction rows over the
    widened-real state layout and the crossing / terminal data. Declared
    kinds only: ``"lin"`` (g = sum row x - c) and ``"quad"`` (g = sum row
    x^2 - c)."""

    n: int
    kinds: tuple          # "lin" | "quad"
    dirs: tuple           # -1 | 0 | +1
    terminal: tuple       # 0 = non-terminal, n >= 1 = stop at the n-th
    offsets: tuple        # c per event
    rows: Any             # numpy (E, D)
    t_tol: Optional[float]
    record_y: bool
    k: int = 1            # located-crossing slots per event


def as_event_config(events) -> Optional[EventConfig]:
    """Normalise ``events=``: None, an EventConfig, one Event or callable,
    or a sequence of them (bare callables get the default direction and
    terminal)."""
    if events is None:
        return None
    if isinstance(events, EventConfig):
        return events
    if isinstance(events, Event) or callable(events):
        events = [events]
    return EventConfig(events=tuple(
        e if isinstance(e, Event) else Event(e) for e in events))


class EventState(NamedTuple):
    """Per-trajectory event bookkeeping in the driver's carry."""

    g_prev: torch.Tensor     # (B, E) g at the current (t, x)
    t_ev: torch.Tensor       # (B, E, K) located times, inf until found
    found: torch.Tensor      # (B, E) bool
    searching: torch.Tensor  # (B,) bool: inside a bracket search
    h_entry: torch.Tensor    # (B,) pre-search step size
    count: torch.Tensor      # (B, E) int32: all matching crossings seen
    y_ev: Pytree = ()        # (B, E) + state: the first crossing's state


def init_event_state(cfg: EventConfig, t0: torch.Tensor, x0: Pytree,
                     batch_shape: tuple = ()) -> EventState:
    g0 = cfg.evaluate(t0, x0)
    tdt, dev = t0.dtype, t0.device
    shape = batch_shape + (cfg.n,)
    y_ev: Pytree = ()
    if cfg.record_y:
        nb = len(batch_shape)
        y_ev = pytree.tree_map(
            lambda a: torch.zeros(batch_shape + (cfg.n,) + a.shape[nb:],
                                  dtype=a.dtype, device=a.device), x0)
    return EventState(
        g_prev=g0,
        t_ev=torch.full(shape + (cfg.max_crossings,), torch.inf, dtype=tdt,
                        device=dev),
        found=torch.zeros(shape, dtype=torch.bool, device=dev),
        searching=torch.zeros(batch_shape, dtype=torch.bool, device=dev),
        h_entry=torch.zeros(batch_shape, dtype=tdt, device=dev),
        count=torch.zeros(shape, dtype=torch.int32, device=dev),
        y_ev=y_ev,
    )


class EventStepOut(NamedTuple):
    """What the driver splices into its masked update (see step_once)."""

    accept: torch.Tensor       # accept mask with the search vetoes applied
    search: torch.Tensor       # (B,) lanes re-bracketing this iteration
    h_override: torch.Tensor   # step size of the search lanes
    restore_h: torch.Tensor    # (B,) lanes restoring h_entry after a locate
    h_entry: torch.Tensor
    terminal_hit: torch.Tensor  # (B,) a terminal event was located
    ev_next: EventState


def event_step(cfg: EventConfig, ev: EventState, t, dt, x, x_next, stepping,
               accept) -> EventStepOut:
    """One driver iteration's event logic (``events.event_step`` of the
    JAX package, line for line): masked arithmetic over the batch."""
    g_next = cfg.evaluate(t + dt, x_next)
    d = cfg.directions(t)
    rising = (ev.g_prev < 0) & (g_next >= 0)
    falling = (ev.g_prev > 0) & (g_next <= 0)
    crossed = torch.where(d > 0, rising,
                          torch.where(d < 0, falling, rising | falling))

    live = stepping & accept
    k = cfg.max_crossings
    active = crossed & live[..., None] & (ev.count < k)
    any_active = active.any(-1)

    denom = ev.g_prev - g_next
    theta = ev.g_prev / torch.where(denom == 0, torch.ones_like(denom), denom)
    theta = torch.clamp(theta, 0.0, 1.0)
    theta_a = torch.where(active, theta, 1.0)
    theta_min = theta_a.amin(-1)

    tol = cfg.time_tol(t)
    tight = dt <= tol
    locate = any_active & tight
    search = any_active & ~tight

    accept = accept & ~search
    h_override = torch.maximum(torch.clamp(theta_min, 0.1, 0.9) * dt,
                               0.25 * tol)
    entering = search & ~ev.searching
    h_entry = torch.where(entering, dt.to(ev.h_entry.dtype), ev.h_entry)
    restore_h = locate & ev.searching
    searching = (ev.searching | search) & ~locate

    rec = active & locate[..., None]
    t_loc = t[..., None] + theta * dt[..., None]
    slot = (torch.arange(k, device=t.device) == ev.count[..., None].long()) \
        & rec[..., None]
    t_ev = torch.where(slot, t_loc[..., None], ev.t_ev)
    found = ev.found | rec
    terminal_hit = (rec & (ev.count + 1 >= cfg.terminal_counts(t))
                    & (cfg.terminal_counts(t) > 0)).any(-1)

    y_ev = ev.y_ev
    if cfg.record_y and len(pytree.tree_leaves(ev.y_ev)) > 0:
        nb = t.ndim
        rec_y = rec & (ev.count == 0)

        def record(buf, a, b):
            extra = buf.ndim - nb - 1
            th = theta.reshape(theta.shape + (1,) * extra).to(buf.dtype)
            m = rec_y.reshape(rec_y.shape + (1,) * extra)
            ae, be = a.unsqueeze(nb), b.unsqueeze(nb)
            return torch.where(m, ae + th * (be - ae), buf)

        y_ev = pytree.tree_map(record, ev.y_ev, x, x_next)

    adv = stepping & accept
    g_prev = torch.where(adv[..., None], g_next, ev.g_prev)
    count = ev.count + (crossed & adv[..., None]).to(torch.int32)

    return EventStepOut(
        accept=accept, search=search, h_override=h_override,
        restore_h=restore_h, h_entry=h_entry, terminal_hit=terminal_hit,
        ev_next=EventState(g_prev=g_prev, t_ev=t_ev, found=found,
                           searching=searching, h_entry=h_entry, count=count,
                           y_ev=y_ev))

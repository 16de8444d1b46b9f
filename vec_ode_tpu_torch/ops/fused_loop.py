"""The whole driver loop in one kernel launch, the counterpart of
``vec_ode_tpu/ops/pallas_loop.py``.

One launch of the hand-written CUDA kernel ``csrc/fused_loop.cu`` runs
every trajectory's driver iterations on the card: the step with its error
measure, the controller (I or PI, ``scaled_error``, ``strict_end_test``)
or fixed steps (``adaptive=False``), compensated time, the save-grid hits,
counters, status and reject streak. Persistent (``chunk=None``: each tile
of trajectories runs until none of its rows is RUNNING) or chunked
(``chunk`` iterations per launch).

* The step is declared, not injected (JAX passes a step builder's
  callable; a hand-written kernel takes a declaration):
  :class:`RKStep`, the embedded RK step of the modulated-linear stepper
  (``csrc/rk_step.cuh``, shared with the per-step kernel K1), or
  :class:`ChainStep`, the chain-exponential step of the modulated
  exponential steppers (``csrc/chain_step.cuh``, shared with the per-step
  kernel K4), whose coefficients the kernel samples from a declared
  ``CoeffForm`` or ``ChebForm`` at its quadrature nodes.
* :func:`fused_loop_chunk` is the kernel's wrapper; for CPU tensors it
  runs :func:`torch_fused_loop`, for CUDA tensors it launches or raises.
  ``fused_loop_chunk.launches`` counts the launches.
* :func:`torch_fused_loop` is the plain twin: the same iteration over the
  whole batch in torch, on the same carries, with the step's ``plain``.
* :func:`fused_loop_integrate` sets up the carries and runs a whole solve.
* Events (``pallas_loop.py:354-449``): declared observables
  (``events.KernelEvents``, kinds ``"lin"`` and ``"quad"``) evaluated at
  every trial point, the crossing test, the regula-falsi search run as
  step control, K located times per event, the first crossing's state,
  the crossing counter and ``DONE_EVENT``.
* Dense output (``pallas_loop.py:455-474``): on the bare [t0, tf] grid the
  controller runs free, and the accepted step that crosses an interior
  dense time records its entry and exit states and its (t, dt);
  ``dense.hermite_from_endpoints`` evaluates them afterwards.

Carries, per trajectory (``pallas_loop.py:60-62``): floats (B, N_F)
[t, h, prev_h, err_norm, t_lo] in the state's type; int32 (B, N_I)
[tgt, status, event, n_accept, n_reject, n_iters, streak, bits]; the
widened state (B, 2d) = [re | im]; the interior saves (n_grid - 2, B, 2d),
updated in place. ``bits`` is always 0: the event state has carries of
its own (:class:`EventCarry`, :class:`DenseCarry`), updated in place like
the saves. The event column of a trajectory that stopped before its
tile's last iteration reads EVT_NONE, as in the JAX kernel, so it depends
on the tiling; every other carry does not.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import NamedTuple, Optional, Union

import torch

from .. import telemetry
from ..controller import StepControl, controller_update, end_tolerance
from ..driver import (DONE, DONE_EVENT, ERR_BAD_GRID, ERR_MAX_STEPS,
                      ERR_STALLED, EVT_CHKPT, EVT_END, EVT_NONE, EVT_REJECT,
                      EVT_STEP, RUNNING, comp_time_advance)
from ..events import KernelEvents
from ..tableaus import RKF45, ButcherTableau
from . import _build
from .expmv import (GEMM_CN, LOOP_THREADS, CfmTable, ChebForm, CoeffForm,
                    chain_params, check_chain_operands, gemm_dp,
                    has_error_estimate, node_times, torch_chain_step)
from .fused_rk import (MAX_STAGES, check_kernel_inputs, cos_drive,
                       cos_frequency, drive_fn, is_declared, kernel_drive,
                       kernel_norm_args, kernel_operands, rk_smem_bytes,
                       torch_rk_step, wnorm_on)

N_F = 5   # float carry columns: t, h, prev_h, err_norm, t_lo
N_I = 8   # int carry columns: tgt, status, event, n_acc, n_rej, n_it,
          # streak, bits (event bits; 0 without events)

# The JAX package runs unpacked batches above this size on the per-step
# path (pallas_rk.py:385). It decides only which path runs, not what is
# computed; the port keeps it until the card's own times move it.
LOOP_MAX_BATCH = 2048
# the RK step in the loop kernel (csrc/fused_loop.cu: RK_LOOP_RM,
# rk_loop_plan): rows a thread, and the plan's keys
RK_LOOP_RM = 2
RK_LOOP_PLAN_KEYS = ("rm", "ks", "tile", "threads", "smem", "resident")

_INT_MAX = 2**31 - 1


@dataclasses.dataclass(frozen=True)
class RKStep:
    """The step the loop kernel runs: dx/dt = (M0 + u(t) M1) x over the
    widened state, with ``tableau``, the declared drive ``u_fn`` (a
    one-term ``CoeffForm`` or ``ChebForm``, whose series is put beside the
    operators once; ``w=`` is the shorthand for cos(w t)), and the error
    measure ``scaled=(atol, rtol)`` (scaled_error) or ``wnorm=(w_row, post,
    kind)`` (``lc.WeightedNorm.kernel_parts``) or plain l2."""

    M0: torch.Tensor        # (2d, 2d), in the state's type and device
    M1: torch.Tensor
    u_fn: Union[CoeffForm, ChebForm, None] = None
    tableau: ButcherTableau = RKF45
    advance_lower: bool = True
    scaled: Optional[tuple] = None
    wnorm: Optional[tuple] = None
    w: dataclasses.InitVar[Optional[float]] = None

    def __post_init__(self, w):
        if self.u_fn is None and w is None:
            raise TypeError("RKStep: missing the drive: pass u_fn= or w=")
        if self.u_fn is None:   # u_fn decides where both are given
            object.__setattr__(self, "u_fn", cos_drive(w))
        if not is_declared(self.u_fn):
            raise TypeError("RKStep: the loop kernel takes a declared drive "
                            "(a one-term CoeffForm or ChebForm)")
        object.__setattr__(self, "drive",
                           kernel_drive(self.u_fn, self.M0)
                           if self.M0.is_cuda else None)

    def plain(self, t, dt, xw):
        """The step in plain torch (``torch_rk_step``)."""
        return torch_rk_step(t, dt, xw, self.M0, self.M1,
                             u_fn=drive_fn(self.u_fn), tab=self.tableau,
                             advance_lower=self.advance_lower,
                             wnorm=self.wnorm, scaled=self.scaled)

    @property
    def has_err(self) -> bool:
        return self.tableau.b_err is not None


RKStep.w = property(lambda self: cos_frequency(self.u_fn))


@dataclasses.dataclass(frozen=True)
class ChainStep:
    """The chain-exponential step the loop kernel runs (the counterpart of
    ``pallas_loop.make_chain_step_builder``, K5): the coefficients
    ``form`` (a :class:`~.expmv.CoeffForm` or :class:`~.expmv.ChebForm`,
    whose series is put beside ``mt`` once) sampled at the quadrature
    nodes of ``recipe``
    (``ops/expmv.node_times``; ``table`` the :class:`~.expmv.CfmTable` of
    the ``"cfm"`` recipe), the recipe's C chains of R coefficient rows
    over the working basis (stacked as ``mt`` = [M_0^T | ... ], (D, K'D),
    with the terms' 1-norms ``norms``), each row scaled per trajectory,
    the degree-``m`` Taylor chains, and the error measure of chain1 -
    chain0 or of ``magnus4_fast``: ``scaled=(atol, rtol)``
    (scaled_error) or ``wnorm=(w_row, post, kind)`` or plain l2."""

    mt: torch.Tensor        # (D, K'D), in the state's type and device
    norms: tuple            # K' floats (ops/expmv.basis_norms)
    form: Union[CoeffForm, ChebForm]
    recipe: str
    C: int
    m: int
    theta: float
    max_squarings: int = 16
    scaled: Optional[tuple] = None
    wnorm: Optional[tuple] = None
    table: Optional[CfmTable] = None

    def __post_init__(self):
        object.__setattr__(
            self, "cheb", self.form.kernel_table(self.mt.dtype, self.mt.device)
            if isinstance(self.form, ChebForm) else None)

    def plain(self, t, dt, xw):
        """The step in plain torch (``torch_chain_step``)."""
        samples = [self.form.sample(tn) for tn in
                   node_times(self.recipe, t, dt, self.C, self.table)]
        return torch_chain_step(
            samples, dt, xw, self.mt, self.norms, recipe=self.recipe,
            C=self.C, m=self.m, theta=self.theta,
            max_squarings=self.max_squarings, wnorm=self.wnorm,
            scaled=self.scaled, table=self.table)

    @property
    def has_err(self) -> bool:
        return has_error_estimate(self.recipe, self.C)


class EventCarry(NamedTuple):
    """The loop's event state, updated in place by each launch: g at the
    current point, the located times (inf until found), the crossing
    counter, the found flags, the search flag and the pre-search step,
    and the first crossing's state (None with ``record_y=False``)."""

    g_prev: torch.Tensor      # (B, E), the state's type
    t_ev: torch.Tensor        # (B, E, K)
    count: torch.Tensor       # (B, E) int32
    found: torch.Tensor       # (B, E) int32, 0 or 1
    searching: torch.Tensor   # (B,) int32, 0 or 1
    h_entry: torch.Tensor     # (B,)
    y_ev: Optional[torch.Tensor]  # (E, B, D) or None


class DenseCarry(NamedTuple):
    """The loop's dense-output recordings, updated in place: per interior
    dense time j the entry time and dt of the step that crossed it (inf
    and 0 until crossed) and its entry / exit states ``dx[2 j]`` /
    ``dx[2 j + 1]``."""

    times: torch.Tensor       # (n,) the dense times, the state's type
    td: torch.Tensor          # (B, n)
    dtd: torch.Tensor         # (B, n)
    dx: torch.Tensor          # (2n, B, D)


def row_reduce(v: torch.Tensor) -> torch.Tensor:
    """sum over the last axis of (B, D) in the loop kernel's order: column
    group cg (of ceil(D / 4)) sums columns cg, cg + ncg, cg + 2 ncg,
    cg + 3 ncg, then the groups are added in order."""
    B, D = v.shape
    ncg = (D + 3) // 4
    vp = torch.nn.functional.pad(v, (0, 4 * ncg - D)).reshape(B, 4, ncg)
    part = ((vp[:, 0] + vp[:, 1]) + vp[:, 2]) + vp[:, 3]
    acc = part[:, 0]
    for g in range(1, ncg):
        acc = acc + part[:, g]
    return acc


def event_params(events: KernelEvents, like: torch.Tensor):
    """The events' rows (E, D) and (E, 4) [kind (0 lin, 1 quad),
    direction, terminal n, offset c] in ``like``'s type and device, as the
    kernel reads them."""
    rows = torch.as_tensor(events.rows, dtype=like.dtype, device=like.device)
    par = torch.tensor(
        [[float(k == "quad"), float(d), float(n), c] for k, d, n, c in
         zip(events.kinds, events.dirs, events.terminal, events.offsets)],
        dtype=like.dtype, device=like.device)
    return rows.contiguous(), par


def event_values(events: KernelEvents, rows, x: torch.Tensor):
    """g of every event at the widened states x (B, D): (B, E), summed in
    the kernel's order."""
    cols = []
    for e, kind in enumerate(events.kinds):
        src = x if kind == "lin" else x * x
        cols.append(row_reduce(src * rows[e]) - events.offsets[e])
    return torch.stack(cols, dim=1)


def init_event_carry(events: KernelEvents, x0: torch.Tensor) -> EventCarry:
    """The event carry at t0 for the widened states ``x0`` (B, D)."""
    B, D = x0.shape
    E, K = events.n, events.k
    dtype, dev = x0.dtype, x0.device
    rows, _ = event_params(events, x0)
    zi = dict(dtype=torch.int32, device=dev)
    return EventCarry(
        g_prev=event_values(events, rows, x0).contiguous(),
        t_ev=torch.full((B, E, K), torch.inf, dtype=dtype, device=dev),
        count=torch.zeros(B, E, **zi), found=torch.zeros(B, E, **zi),
        searching=torch.zeros(B, **zi),
        h_entry=torch.zeros(B, dtype=dtype, device=dev),
        y_ev=(torch.zeros(E, B, D, dtype=dtype, device=dev)
              if events.record_y else None))


def init_dense_carry(times, x0: torch.Tensor) -> DenseCarry:
    """The dense carry for the interior dense ``times`` (n,) and the
    widened states ``x0`` (B, D)."""
    B, D = x0.shape
    times = torch.as_tensor(times).to(dtype=x0.dtype, device=x0.device)
    n = times.shape[0]
    kw = dict(dtype=x0.dtype, device=x0.device)
    return DenseCarry(times=times.contiguous(),
                      td=torch.full((B, n), torch.inf, **kw),
                      dtd=torch.zeros(B, n, **kw),
                      dx=torch.zeros(2 * n, B, D, **kw))


def torch_fused_loop(t_grid, fs, ist, x, saves, step, *, ctl: StepControl,
                     iters: Optional[int] = None, adaptive: bool = True,
                     events: Optional[KernelEvents] = None,
                     ev: Optional[EventCarry] = None,
                     dense: Optional[DenseCarry] = None):
    """Plain twin of the loop kernel: ``iters`` driver iterations of the
    whole batch (None: until no trajectory is RUNNING), line for line
    ``pallas_loop._make_loop_kernel.iteration``; ``adaptive=False`` takes
    fixed steps (every stepping row accepts, h changes only at the
    grid-hit restore). ``events`` with its carry ``ev`` runs the event
    search, ``dense`` records the dense-output endpoints. Returns (fs,
    ist, x, saves); ``saves``, ``ev`` and ``dense`` are updated in
    place."""
    n_grid = t_grid.shape[0]
    t, h, prev_h, err_prev, t_lo = fs.unbind(1)
    tgt, status, event, n_acc, n_rej, n_it, streak, bits = ist.unbind(1)
    eps = torch.finfo(x.dtype).eps
    if events is not None:
        rows, _ = event_params(events, x)
        E, K = events.n, events.k
        dirs, terms = events.dirs, events.terminal
        g_prev, t_ev, count = (a.clone() for a in ev[:3])
        found, searching = ev.found != 0, ev.searching != 0
        h_entry = ev.h_entry.clone()
        slots = torch.arange(K, device=x.device)
    if dense is not None:
        td, dtd = dense.td.clone(), dense.dtd.clone()
    it = 0
    while bool((status == RUNNING).any()) and (iters is None or it < iters):
        running = status == RUNNING
        chk_t = t_grid[torch.clamp(tgt, max=n_grid - 1).long()]
        rem = (chk_t - t) - t_lo
        at_grid = rem.abs() <= end_tolerance(chk_t, ctl.strict_end_test)
        past_end = tgt >= n_grid - 1
        is_end = running & at_grid & past_end
        is_chk = running & at_grid & ~past_end
        bad = running & ~at_grid & (rem < 0)
        stepping = running & ~at_grid & ~bad
        dt = torch.where(stepping, torch.minimum(h, rem), 0.0)

        y, err = step.plain(t, dt, x)
        if adaptive:
            new_h, accept = controller_update(h, err, ctl,
                                              prev_err_norm=err_prev,
                                              prev_rejected=streak > 0)
        else:
            new_h, accept = h, torch.ones_like(stepping)

        if events is not None:
            # pallas_loop.py:354-449: g at the trial point, the crossing
            # test, regula falsi as step control
            g_next = event_values(events, rows, y)
            rising = (g_prev < 0) & (g_next >= 0)
            falling = (g_prev > 0) & (g_next <= 0)
            d = torch.tensor(dirs, device=x.device)
            crossed = torch.where(d > 0, rising,
                                  torch.where(d < 0, falling,
                                              rising | falling))
            active = crossed & (stepping & accept)[:, None] & (count < K)
            denom = g_prev - g_next
            theta = g_prev / torch.where(denom == 0.0,
                                         torch.ones_like(denom), denom)
            theta = torch.clamp(theta, 0.0, 1.0)
            theta_min = torch.where(active, theta, 1.0).amin(1)
            any_active = active.any(1)
            if events.t_tol is not None:
                tol_ev = torch.full_like(t, events.t_tol)
            else:
                tol_ev = 64.0 * eps * torch.clamp(t.abs(), min=1.0)
            tight = dt <= tol_ev
            locate = any_active & tight
            search = any_active & ~tight
            accept = accept & ~search
            h_override = torch.maximum(torch.clamp(theta_min, 0.1, 0.9) * dt,
                                       0.25 * tol_ev)
            entering = search & ~searching
            h_entry = torch.where(entering, dt, h_entry)
            restore_h = locate & searching
            searching = (searching | search) & ~locate
            rec = active & locate[:, None]
            t_loc = t[:, None] + theta * dt[:, None]
            t_ev = torch.where((slots == count[..., None].long())
                               & rec[..., None], t_loc[..., None], t_ev)
            found = found | rec
            n_term = torch.tensor(terms, device=x.device)
            terminal_hit = (rec & (n_term > 0)
                            & (count + 1 >= n_term)).any(1)
            if ev.y_ev is not None:
                # the state at the FIRST crossing only
                rec_y = rec & (count == 0)
                for e in range(E):
                    ev.y_ev[e] = torch.where(
                        rec_y[:, e, None],
                        x + theta[:, e, None] * (y - x), ev.y_ev[e])
            adv_ev = stepping & accept
            g_prev = torch.where(adv_ev[:, None], g_next, g_prev)
            count = count + (crossed & adv_ev[:, None]).to(torch.int32)

        adv = stepping & accept
        rej = stepping & ~accept
        # event-search iterations are not numerical rejections
        true_rej = rej & ~search if events is not None else rej
        hit = at_grid & running

        if dense is not None:
            # pallas_loop.py:455-474: the crossing test against the
            # post-advance time (the compensated hi word)
            if ctl.time_compensated:
                s_ = t + dt
                bp = s_ - t
                e_lo = (t - (s_ - bp)) + (dt - bp)
                t_new = s_ + (t_lo + e_lo)
            else:
                t_new = t + dt
            for j in range(dense.times.shape[0]):
                tgj = dense.times[j]
                tolj = 4.0 * eps * torch.clamp(tgj.abs(), min=1.0)
                cr = adv & (tgj > t + tolj) & (tgj <= t_new + tolj)
                dense.dx[2 * j] = torch.where(cr[:, None], x,
                                              dense.dx[2 * j])
                dense.dx[2 * j + 1] = torch.where(cr[:, None], y,
                                                  dense.dx[2 * j + 1])
                td[:, j] = torch.where(cr, t, td[:, j])
                dtd[:, j] = torch.where(cr, dt, dtd[:, j])

        # interior saves: the state at the grid hit, before the advance
        for g in range(n_grid - 2):
            saves[g] = torch.where((hit & (tgt == g + 1))[:, None], x,
                                   saves[g])
        if ctl.time_compensated:
            hi, lo = comp_time_advance(t, t_lo, dt)
            t = torch.where(adv, hi, t)
            t_lo = torch.where(adv, lo, t_lo)
        else:
            t = torch.where(adv, t + dt, t)
        x = torch.where(adv[:, None], y, x)
        if adaptive:
            prev_h = torch.where(stepping, h, prev_h)
            h = torch.where(stepping, new_h, h)
        h = torch.where(hit, prev_h, h)
        if events is not None:
            h = torch.where(search, h_override, h)
            h = torch.where(restore_h, h_entry, h)
            prev_h = torch.where(restore_h, h_entry, prev_h)
        tgt = tgt + hit.to(torch.int32)

        status = torch.where(is_end, DONE, status)
        status = torch.where(bad, ERR_BAD_GRID, status)
        n_it = n_it + running.to(torch.int32)
        status = torch.where((status == RUNNING) & (n_it >= ctl.max_steps),
                             ERR_MAX_STEPS, status)
        if events is not None:
            status = torch.where(terminal_hit, DONE_EVENT, status)
        streak = torch.where(true_rej, streak + 1,
                             torch.where(adv, 0, streak))
        if ctl.max_reject_streak > 0:
            status = torch.where(
                (status == RUNNING) & (streak >= ctl.max_reject_streak),
                ERR_STALLED, status)
        event = torch.where(
            is_end, EVT_END, torch.where(
                is_chk, EVT_CHKPT, torch.where(
                    rej, EVT_REJECT, torch.where(adv, EVT_STEP, EVT_NONE))))
        event = event.to(torch.int32)
        if adaptive:
            err_prev = torch.where(stepping, err, err_prev)
        n_acc = n_acc + adv.to(torch.int32)
        n_rej = n_rej + true_rej.to(torch.int32)
        it += 1
    if events is not None:
        for dst, src in ((ev.g_prev, g_prev), (ev.t_ev, t_ev),
                         (ev.count, count), (ev.found, found),
                         (ev.searching, searching), (ev.h_entry, h_entry)):
            dst.copy_(src)
    if dense is not None:
        dense.td.copy_(td)
        dense.dtd.copy_(dtd)
    fs = torch.stack([t, h, prev_h, err_prev, t_lo], dim=1)
    ist = torch.stack([tgt, status, event, n_acc, n_rej, n_it, streak,
                       torch.zeros_like(bits)], dim=1)
    return fs, ist, x, saves


def rk_loop_plan(B: int, D: int, s: int, elem: int, extra: bool = False,
                 n_sm: int = 132, max_smem: int = 232448) -> dict:
    """The RK step's plan in the loop kernel (csrc/fused_loop.cu:
    rk_loop_plan) for B rows of width D and s stages in elements of
    ``elem`` bytes: RK_LOOP_RM rows a thread, the stages in registers in
    f32 (ks = MAX_STAGES) and in shared memory in f64 (ks = 0); rows a
    block as the chain step's (``expmv.loop_plan``: the largest power of
    two up to 256 whose threads fit LOOP_THREADS, whose three (tile, D)
    slots take at most 96 KB and whose shared memory with the operator
    streamed and the events / dense switch on fits, halved while the batch
    gives fewer than two blocks per SM, down to 16); the operator resident
    where the block holds it at that tile. ``extra`` gives the shared
    memory of that instantiation. Keyed as RK_LOOP_PLAN_KEYS."""
    ncg = gemm_dp(D) // GEMM_CN
    ks = MAX_STAGES if elem == 4 else 0

    def smem(tile, res, ext):
        return (rk_smem_bytes(tile, D, s, elem, ks == 0, res)
                + (2 * tile * D + (4 if ext else 3) * tile) * elem
                + tile * 4)

    tile = 256
    while tile > RK_LOOP_RM and (
            tile > LOOP_THREADS
            or (tile // RK_LOOP_RM) * ncg > LOOP_THREADS
            or 3 * tile * D * elem > 96 * 1024
            or smem(tile, False, True) > max_smem):
        tile //= 2
    while tile > 16 and -(-B // tile) < 2 * n_sm:
        tile //= 2
    res = smem(tile, True, True) <= max_smem
    items = (tile // RK_LOOP_RM) * ncg
    return dict(rm=RK_LOOP_RM, ks=ks, tile=tile,
                threads=-(-max(items, tile) // 32) * 32,
                smem=smem(tile, res, extra), resident=int(res))


def kernel_rk_loop_plan(B: int, D: int, s: int, dtype,
                        extra: bool = False) -> dict:
    """The RK step's plan the loop kernel launches with on the current
    card (``vec_ode_fused_loop_rk_plan``), keyed as RK_LOOP_PLAN_KEYS."""
    out = (ctypes.c_longlong * len(RK_LOOP_PLAN_KEYS))()
    fn = _kernel_lib().vec_ode_fused_loop_rk_plan
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_longlong)]
    rc = fn(B, D, s, 4 if dtype == torch.float32 else 8, int(extra), out)
    if rc != 0:
        raise RuntimeError(f"fused_loop_chunk: the plan query failed with "
                           f"CUDA error {rc}")
    return dict(zip(RK_LOOP_PLAN_KEYS, (int(v) for v in out)))


@functools.cache
def _kernel_lib() -> ctypes.CDLL:
    """The loop kernel's library, built on first use, with its entry
    points' argument types set."""
    lib = _build.load("fused_loop")
    vp, ci, cd = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    pd, pv = ctypes.POINTER(cd), ctypes.POINTER(vp)
    for fn in (lib.vec_ode_fused_loop_f32, lib.vec_ode_fused_loop_f64):
        fn.restype = ci
        fn.argtypes = [vp, ci, vp, vp, vp, vp, vp, vp, vp, ci, ci, vp, pd,
                       ci, ci, pd, vp, vp, cd, ci, pd, ci, ci, pv, pd, vp]
    for fn in (lib.vec_ode_fused_loop_chain_f32,
               lib.vec_ode_fused_loop_chain_f64):
        fn.restype = ci
        fn.argtypes = [vp, ci, vp, vp, vp, vp, vp, vp, vp, ci, ci, vp, pd,
                       vp, vp, cd, ci, pd, ci, ci, pv, pd, vp]
    return lib


def _ctl_array(ctl: StepControl, scaled: bool):
    """The controller as the kernel reads it (``launch`` in
    csrc/fused_loop.cu): float64 values in host memory."""
    vals = (ctl.rtol, ctl.atol, ctl.alpha, 1.0 / ctl.order, ctl.min_factor,
            ctl.max_factor, ctl.min_dt, ctl.max_dt, 0.7 / ctl.pi_order,
            0.4 / ctl.pi_order, 1.0 / ctl.pi_order,
            min(int(ctl.max_steps), _INT_MAX),
            min(int(ctl.max_reject_streak), _INT_MAX), int(ctl.pi),
            int(ctl.time_compensated), int(ctl.strict_end_test), int(scaled))
    return (ctypes.c_double * len(vals))(*vals)


def _check_carries(t_grid, fs, ist, x, saves) -> None:
    B, D = x.shape
    n_grid = t_grid.shape[0] if t_grid.ndim == 1 else 0
    want = dict(t_grid=((n_grid,), x.dtype), fs=((B, N_F), x.dtype),
                ist=((B, N_I), torch.int32),
                saves=((max(n_grid - 2, 0), B, D), x.dtype))
    got = dict(t_grid=t_grid, fs=fs, ist=ist, saves=saves)
    if n_grid < 2:
        raise ValueError(
            f"fused_loop_chunk: t_grid must be (n_grid,) with n_grid >= 2, "
            f"got {tuple(t_grid.shape)}")
    for name, (shape, dtype) in want.items():
        a = got[name]
        if a.device != x.device:
            raise ValueError(
                f"fused_loop_chunk: {name} is on {a.device}, x on {x.device}")
        if a.dtype != dtype:
            raise TypeError(f"fused_loop_chunk: {name} is {a.dtype}, "
                            f"the kernel takes {dtype}")
        if tuple(a.shape) != shape:
            raise ValueError(f"fused_loop_chunk: {name} must be {shape}, "
                             f"got {tuple(a.shape)}")
        if not a.is_contiguous():
            raise ValueError(f"fused_loop_chunk: {name} must be contiguous")


def _check_extras(events, ev, dense, x, n_grid) -> None:
    """The event and dense carries as the kernel takes them."""
    B, D = x.shape
    if (events is None) != (ev is None):
        raise ValueError("fused_loop_chunk: events and ev come together")
    want = {}
    if events is not None:
        E, K = events.n, events.k
        want.update(g_prev=(ev.g_prev, (B, E), x.dtype),
                    t_ev=(ev.t_ev, (B, E, K), x.dtype),
                    count=(ev.count, (B, E), torch.int32),
                    found=(ev.found, (B, E), torch.int32),
                    searching=(ev.searching, (B,), torch.int32),
                    h_entry=(ev.h_entry, (B,), x.dtype))
        if events.record_y:
            if ev.y_ev is None:
                raise ValueError("fused_loop_chunk: record_y needs ev.y_ev")
            want["y_ev"] = (ev.y_ev, (E, B, D), x.dtype)
    if dense is not None:
        if n_grid != 2:
            raise ValueError(
                "fused_loop_chunk: dense output is free-running: the grid "
                f"must be [t0, tf] (got {n_grid} points)")
        n = dense.times.shape[0]
        want.update(times=(dense.times, (n,), x.dtype),
                    td=(dense.td, (B, n), x.dtype),
                    dtd=(dense.dtd, (B, n), x.dtype),
                    dx=(dense.dx, (2 * n, B, D), x.dtype))
    for name, (a, shape, dtype) in want.items():
        if a.device != x.device or a.dtype != dtype:
            raise TypeError(f"fused_loop_chunk: {name} is {a.dtype} on "
                            f"{a.device}, the kernel takes {dtype} on "
                            f"{x.device}")
        if tuple(a.shape) != shape or not a.is_contiguous():
            raise ValueError(f"fused_loop_chunk: {name} must be a contiguous "
                             f"{shape}, got {tuple(a.shape)}")


def _extra_args(events, ev, dense, x):
    """The kernel's event and dense arguments: an array of 15 device
    pointers and 6 float64 values [n_ev, K, record_y, has t_tol, t_tol,
    n_dense] in host memory (both None when neither is on), and the
    tensors that must outlive the launch."""
    if events is None and dense is None:
        return None, None, ()
    keep, ptrs = [], [None] * 15
    par = [0.0] * 6
    if events is not None:
        rows, evp = event_params(events, x)
        g_new = torch.empty_like(ev.g_prev)
        th_rec = torch.empty_like(ev.g_prev)
        keep += [rows, evp, g_new, th_rec]
        for i, a in enumerate((rows, evp, ev.g_prev, ev.t_ev, ev.count,
                               ev.found, ev.searching, ev.h_entry, ev.y_ev,
                               g_new, th_rec)):
            ptrs[i] = None if a is None else a.data_ptr()
        par[:5] = [events.n, events.k, int(events.record_y),
                   int(events.t_tol is not None),
                   0.0 if events.t_tol is None else events.t_tol]
    if dense is not None:
        for i, a in enumerate(dense, start=11):
            ptrs[i] = a.data_ptr()
        par[5] = dense.times.shape[0]
    return ((ctypes.c_void_p * 15)(*ptrs), (ctypes.c_double * 6)(*par),
            keep)


def fused_loop_chunk(t_grid, fs, ist, x, saves, step, *, ctl: StepControl,
                     chunk: Optional[int] = None, adaptive: bool = True,
                     events: Optional[KernelEvents] = None,
                     ev: Optional[EventCarry] = None,
                     dense: Optional[DenseCarry] = None):
    """Advance every trajectory by ``chunk`` driver iterations in one
    launch of the loop kernel, or with ``chunk=None`` until it leaves
    RUNNING (persistent), with the declared ``step`` (:class:`RKStep` or
    :class:`ChainStep`); ``adaptive=False`` takes fixed steps; ``events``
    (declared observables) with their carry ``ev`` locate events, and
    ``dense`` records the dense-output endpoints (a [t0, tf] grid).
    Returns (fs, ist, x, saves); ``saves``, ``ev`` and ``dense`` are
    updated in place.

    CUDA tensors go to the kernel (float32 or float64, D <= 512,
    contiguous carries; RK tableaus of at most 7 stages, chain steps over
    at most 8 basis terms, 4 exponentials per chain and 8 nodes; any
    number of events and dense times); anything else it does not take
    raises. CPU tensors run :func:`torch_fused_loop`.
    """
    if chunk is not None and chunk < 1:
        raise ValueError(f"fused_loop_chunk: chunk must be >= 1, got {chunk}")
    if adaptive and not step.has_err:
        raise ValueError(
            "fused_loop_chunk: the step has no error estimate (no embedded "
            "pair, or a chain step with C = 1); adaptive=True needs one")
    if step.scaled is not None and step.wnorm is not None:
        raise ValueError("fused_loop_chunk: scaled and wnorm are mutually "
                         "exclusive")
    ops = ((step.M0, step.M1) if isinstance(step, RKStep) else (step.mt,))
    _check_extras(events, ev, dense, x, t_grid.shape[0])
    if all(a.device.type == "cpu" for a in (t_grid, fs, ist, x, saves, *ops)):
        return torch_fused_loop(t_grid, fs, ist, x, saves, step, ctl=ctl,
                                iters=chunk, adaptive=adaptive, events=events,
                                ev=ev, dense=dense)
    wn = wnorm_on(step.wnorm, x)
    w_row = None if wn is None else wn[0]
    _build.refuse_grad("fused_loop_chunk", t_grid, fs, x, saves, *ops, w_row,
                       getattr(step, "cheb", None))
    B, D = x.shape
    lib = _kernel_lib()
    f32 = x.dtype == torch.float32
    if isinstance(step, RKStep):
        mt, tab_c = kernel_operands(step.M0, step.M1, step.tableau)
        check_kernel_inputs("fused_loop_chunk", x, mt, w_row)
        fn = lib.vec_ode_fused_loop_f32 if f32 else lib.vec_ode_fused_loop_f64
        drive = step.drive
        if drive is None or (drive.cheb is not None and (
                drive.cheb.device != x.device or drive.cheb.dtype != x.dtype)):
            drive = kernel_drive(step.u_fn, x)
        step_args = (mt.data_ptr(), tab_c, step.tableau.stages,
                     int(step.advance_lower), drive.params,
                     None if drive.cheb is None else drive.cheb.data_ptr())
    else:
        K0 = step.form.n_terms
        Kp = check_chain_operands("fused_loop_chunk", x, step.mt, step.norms,
                                  K0, step.recipe, step.C, w_row,
                                  step.table)
        fn = (lib.vec_ode_fused_loop_chain_f32 if f32
              else lib.vec_ode_fused_loop_chain_f64)
        step_args = (step.mt.data_ptr(),
                     chain_params(step.recipe, step.C, K0, Kp, step.m,
                                  step.theta, step.max_squarings, step.norms,
                                  step.form, step.table),
                     None if step.cheb is None else step.cheb.data_ptr())
    _check_carries(t_grid, fs, ist, x, saves)
    ex_ptrs, ex_par, keep = _extra_args(events, ev, dense, x)
    fs_out, ist_out, x_out = (torch.empty_like(a) for a in (fs, ist, x))
    with torch.cuda.device(x.device):
        rc = fn(t_grid.data_ptr(), t_grid.shape[0], fs.data_ptr(),
                ist.data_ptr(), x.data_ptr(), fs_out.data_ptr(),
                ist_out.data_ptr(), x_out.data_ptr(), saves.data_ptr(), B, D,
                *step_args, *kernel_norm_args(wn),
                _ctl_array(ctl, step.scaled is not None),
                0 if chunk is None else int(chunk), int(adaptive),
                ex_ptrs, ex_par,
                torch.cuda.current_stream(x.device).cuda_stream)
    del keep
    if rc != 0:
        raise RuntimeError(
            f"fused_loop_chunk: kernel launch failed with CUDA error {rc}")
    fused_loop_chunk.launches += 1
    return fs_out, ist_out, x_out, saves


fused_loop_chunk.launches = 0


def init_carries(t_grid, x0, h0):
    """The carries at t0 for the widened state ``x0`` (B, 2d), with ``h0``
    a scalar or per trajectory (B,): (t_grid in x0's type, fs = [t0, h0,
    h0, 0, 0] (``pallas_loop.py:1385-1391``), ist = 0, x0, zero saves)."""
    B, D = x0.shape
    dtype, dev = x0.dtype, x0.device
    t_grid = t_grid.to(device=dev, dtype=dtype)
    n_grid = t_grid.shape[0]
    h = torch.as_tensor(h0, dtype=dtype, device=dev)
    h = h.reshape(()).expand(B) if h.numel() == 1 else h.reshape(B)
    zero = torch.zeros(B, dtype=dtype, device=dev)
    fs = torch.stack([t_grid[0].expand(B), h, h, zero, zero], dim=1)
    ist = torch.zeros(B, N_I, dtype=torch.int32, device=dev)
    saves = torch.zeros(max(n_grid - 2, 0), B, D, dtype=dtype, device=dev)
    return t_grid, fs, ist, x0.contiguous(), saves


def fused_loop_integrate(t_grid, x0, h0, step, *, ctl: StepControl,
                         chunk: int = 8, persistent: bool = False,
                         adaptive: bool = True,
                         events: Optional[KernelEvents] = None,
                         dense_times=None):
    """A whole solve over [t_grid[0], t_grid[-1]] from the widened state
    ``x0`` (B, D): one persistent launch, or launches of ``chunk``
    iterations until no trajectory is RUNNING (one host sync each).
    ``h0`` is a scalar or per trajectory (B,). Interior grid times are hit
    exactly and recorded. Returns the final (fs, ist, x, saves).

    ``events`` (declared observables) locates events; ``dense_times``
    (n,) are interior dense-output times of the bare [t0, tf] grid: the
    controller runs free and the grid cursor starts past t0, as
    ``dense._dense_step`` has no t0 iteration (``pallas_loop.py:1433``).
    With either, the return grows the final :class:`EventCarry` (or None)
    and :class:`DenseCarry` (or None)."""
    with telemetry.span("vec_ode.loop.launch"):
        t_grid, fs, ist, x, saves = init_carries(t_grid, x0, h0)
        ev = None if events is None else init_event_carry(events, x)
        dn = None
        if dense_times is not None:
            dn = init_dense_carry(dense_times, x)
            ist[:, 0] = 1
        kw = dict(ctl=ctl, adaptive=adaptive, events=events, ev=ev, dense=dn)
        out = fs, ist, x, saves
        if persistent:
            out = fused_loop_chunk(t_grid, *out, step, **kw)
    if not persistent:
        while telemetry.read("loop_cond", (out[1][:, 1] == RUNNING).any()):
            with telemetry.span("vec_ode.loop.launch"):
                out = fused_loop_chunk(t_grid, *out, step, chunk=chunk, **kw)
    if events is None and dn is None:
        return out
    return (*out, ev, dn)


def loop_solution(t_grid, x0w, out, *, path: str, unwiden, slope=None):
    """The ``Solution`` of a :func:`fused_loop_integrate` run from the
    widened states ``x0w`` over the caller's grid ``t_grid`` (for dense
    output [t0, *dense times, tf]): ys = [x0, the interior saves or the
    Hermite values of the dense recordings (``slope(t, xw)``: the widened
    endpoint slopes), the final state where the trajectory reached tf else
    0], the counters, and the event fields. ``unwiden`` maps widened
    (..., D) rows to the caller's state; dense output appends ``-dense``
    to ``path``."""
    from ..dense import hermite_from_endpoints
    from ..driver import Solution

    with telemetry.span("vec_ode.solution"):
        fs, ist, x, saves = out[:4]
        ev, dn = out[4:] if len(out) > 4 else (None, None)
        B = x.shape[0]
        n_grid = t_grid.shape[0]
        if dn is not None:
            interior = hermite_from_endpoints(t_grid[1:-1], dn.td, dn.dtd,
                                              dn.dx[0::2], dn.dx[1::2], slope)
            n_grid_k = 2
        else:
            interior, n_grid_k = saves, n_grid
        reached = (ist[:, 0] >= n_grid_k)[:, None, None]
        yw = torch.cat([x0w[:, None], interior.transpose(0, 1),
                        torch.where(reached, x[:, None],
                                    torch.zeros_like(x[:, None]))], dim=1)
        ev_kw = {}
        if ev is not None:
            ev_kw = dict(event_t=ev.t_ev[..., 0], event_found=ev.found != 0,
                         event_y=(None if ev.y_ev is None
                                  else unwiden(ev.y_ev.transpose(0, 1))),
                         event_t_k=ev.t_ev, event_count=ev.count)
        return Solution(
            ts=t_grid.expand(B, n_grid), ys=unwiden(yw), t_final=fs[:, 0],
            y_final=unwiden(x), status=ist[:, 1], n_accept=ist[:, 3],
            n_reject=ist[:, 4], n_iters=ist[:, 5], h_final=fs[:, 1],
            path=path + ("-dense" if dn is not None else ""), **ev_kw)

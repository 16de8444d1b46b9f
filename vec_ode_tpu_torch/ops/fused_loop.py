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
  ``CoeffForm`` at its quadrature nodes.
* :func:`fused_loop_chunk` is the kernel's wrapper; for CPU tensors it
  runs :func:`torch_fused_loop`, for CUDA tensors it launches or raises.
  ``fused_loop_chunk.launches`` counts the launches.
* :func:`torch_fused_loop` is the plain twin: the same iteration over the
  whole batch in torch, on the same carries, with the step's ``plain``.
* :func:`fused_loop_integrate` sets up the carries and runs a whole solve.

Carries, per trajectory (``pallas_loop.py:60-62``): floats (B, N_F)
[t, h, prev_h, err_norm, t_lo] in the state's type; int32 (B, N_I)
[tgt, status, event, n_accept, n_reject, n_iters, streak, bits]; the
widened state (B, 2d) = [re | im]; the interior saves (n_grid - 2, B, 2d),
updated in place. Without events ``bits`` is 0. The event column of a
trajectory that stopped before its tile's last iteration reads EVT_NONE,
as in the JAX kernel, so it depends on the tiling; every other carry
does not.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional

import torch

from ..controller import StepControl, controller_update, end_tolerance
from ..driver import (DONE, ERR_BAD_GRID, ERR_MAX_STEPS, ERR_STALLED,
                      EVT_CHKPT, EVT_END, EVT_NONE, EVT_REJECT, EVT_STEP,
                      RUNNING, comp_time_advance)
from ..tableaus import RKF45, ButcherTableau
from . import _build
from .expmv import (CfmTable, CoeffForm, chain_params, check_chain_operands,
                    has_error_estimate, node_times, torch_chain_step)
from .fused_rk import (check_kernel_inputs, kernel_norm_args,
                       kernel_operands, torch_rk_step, wnorm_on)

N_F = 5   # float carry columns: t, h, prev_h, err_norm, t_lo
N_I = 8   # int carry columns: tgt, status, event, n_acc, n_rej, n_it,
          # streak, bits (event bits; 0 without events)

# The JAX package runs unpacked batches above this size on the per-step
# path (pallas_rk.py:385). It decides only which path runs, not what is
# computed; the port keeps it until the card's own times move it.
LOOP_MAX_BATCH = 2048

_INT_MAX = 2**31 - 1


@dataclasses.dataclass(frozen=True)
class RKStep:
    """The step the loop kernel runs: dx/dt = (M0 + cos(w t) M1) x over
    the widened state, with ``tableau``, and the error measure
    ``scaled=(atol, rtol)`` (scaled_error) or ``wnorm=(w_row, post,
    kind)`` (``lc.WeightedNorm.kernel_parts``) or plain l2."""

    M0: torch.Tensor        # (2d, 2d), in the state's type and device
    M1: torch.Tensor
    w: float
    tableau: ButcherTableau = RKF45
    advance_lower: bool = True
    scaled: Optional[tuple] = None
    wnorm: Optional[tuple] = None

    def plain(self, t, dt, xw):
        """The step in plain torch (``torch_rk_step``)."""
        return torch_rk_step(t, dt, xw, self.M0, self.M1,
                             u_fn=lambda ti: torch.cos(self.w * ti),
                             tab=self.tableau,
                             advance_lower=self.advance_lower,
                             wnorm=self.wnorm, scaled=self.scaled)

    @property
    def has_err(self) -> bool:
        return self.tableau.b_err is not None


@dataclasses.dataclass(frozen=True)
class ChainStep:
    """The chain-exponential step the loop kernel runs (the counterpart of
    ``pallas_loop.make_chain_step_builder``, K5): the coefficients
    ``form`` sampled at the quadrature nodes of ``recipe``
    (``ops/expmv.node_times``; ``table`` the :class:`~.expmv.CfmTable` of
    the ``"cfm"`` recipe), the recipe's C chains of R coefficient rows
    over the working basis (stacked as ``mt`` = [M_0^T | ... ], (D, K'D),
    with the terms' 1-norms ``norms``), each row scaled per trajectory,
    the degree-``m`` Taylor chains, and the error measure of chain1 -
    chain0 or of ``magnus4_fast``: ``scaled=(atol, rtol)``
    (scaled_error) or ``wnorm=(w_row, post, kind)`` or plain l2."""

    mt: torch.Tensor        # (D, K'D), in the state's type and device
    norms: tuple            # K' floats (ops/expmv.basis_norms)
    form: CoeffForm
    recipe: str
    C: int
    m: int
    theta: float
    max_squarings: int = 16
    scaled: Optional[tuple] = None
    wnorm: Optional[tuple] = None
    table: Optional[CfmTable] = None

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


def torch_fused_loop(t_grid, fs, ist, x, saves, step, *, ctl: StepControl,
                     iters: Optional[int] = None, adaptive: bool = True):
    """Plain twin of the loop kernel: ``iters`` driver iterations of the
    whole batch (None: until no trajectory is RUNNING), line for line
    ``pallas_loop._make_loop_kernel.iteration`` without events or dense
    output; ``adaptive=False`` takes fixed steps (every stepping row
    accepts, h changes only at the grid-hit restore). Returns (fs, ist, x,
    saves); ``saves`` is updated in place."""
    n_grid = t_grid.shape[0]
    t, h, prev_h, err_prev, t_lo = fs.unbind(1)
    tgt, status, event, n_acc, n_rej, n_it, streak, bits = ist.unbind(1)
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
        adv = stepping & accept
        rej = stepping & ~accept
        hit = at_grid & running

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
        tgt = tgt + hit.to(torch.int32)

        status = torch.where(is_end, DONE, status)
        status = torch.where(bad, ERR_BAD_GRID, status)
        n_it = n_it + running.to(torch.int32)
        status = torch.where((status == RUNNING) & (n_it >= ctl.max_steps),
                             ERR_MAX_STEPS, status)
        streak = torch.where(rej, streak + 1, torch.where(adv, 0, streak))
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
        n_rej = n_rej + rej.to(torch.int32)
        it += 1
    fs = torch.stack([t, h, prev_h, err_prev, t_lo], dim=1)
    ist = torch.stack([tgt, status, event, n_acc, n_rej, n_it, streak,
                       torch.zeros_like(bits)], dim=1)
    return fs, ist, x, saves


@functools.cache
def _kernel_lib() -> ctypes.CDLL:
    """The loop kernel's library, built on first use, with its entry
    points' argument types set."""
    lib = _build.load("fused_loop")
    vp, ci, cd = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    pd = ctypes.POINTER(cd)
    for fn in (lib.vec_ode_fused_loop_f32, lib.vec_ode_fused_loop_f64):
        fn.restype = ci
        fn.argtypes = [vp, ci, vp, vp, vp, vp, vp, vp, vp, ci, ci, vp, pd,
                       ci, ci, cd, vp, cd, ci, pd, ci, ci, vp]
    for fn in (lib.vec_ode_fused_loop_chain_f32,
               lib.vec_ode_fused_loop_chain_f64):
        fn.restype = ci
        fn.argtypes = [vp, ci, vp, vp, vp, vp, vp, vp, vp, ci, ci, vp, pd,
                       vp, cd, ci, pd, ci, ci, vp]
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


def fused_loop_chunk(t_grid, fs, ist, x, saves, step, *, ctl: StepControl,
                     chunk: Optional[int] = None, adaptive: bool = True):
    """Advance every trajectory by ``chunk`` driver iterations in one
    launch of the loop kernel, or with ``chunk=None`` until it leaves
    RUNNING (persistent), with the declared ``step`` (:class:`RKStep` or
    :class:`ChainStep`); ``adaptive=False`` takes fixed steps. Returns
    (fs, ist, x, saves); ``saves`` is updated in place.

    CUDA tensors go to the kernel (float32 or float64, D <= 512,
    contiguous carries; RK tableaus of at most 7 stages, chain steps over
    at most 2 basis terms, 4 exponentials per chain and 8 nodes); anything
    else it does not take raises. CPU
    tensors run :func:`torch_fused_loop`.
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
    if all(a.device.type == "cpu" for a in (t_grid, fs, ist, x, saves, *ops)):
        return torch_fused_loop(t_grid, fs, ist, x, saves, step, ctl=ctl,
                                iters=chunk, adaptive=adaptive)
    wn = wnorm_on(step.wnorm, x)
    w_row = None if wn is None else wn[0]
    B, D = x.shape
    lib = _kernel_lib()
    f32 = x.dtype == torch.float32
    if isinstance(step, RKStep):
        mt, tab_c = kernel_operands(step.M0, step.M1, step.tableau)
        check_kernel_inputs("fused_loop_chunk", x, mt, w_row)
        fn = lib.vec_ode_fused_loop_f32 if f32 else lib.vec_ode_fused_loop_f64
        step_args = (mt.data_ptr(), tab_c, step.tableau.stages,
                     int(step.advance_lower), float(step.w))
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
                                  step.form, step.table))
    _check_carries(t_grid, fs, ist, x, saves)
    fs_out, ist_out, x_out = (torch.empty_like(a) for a in (fs, ist, x))
    with torch.cuda.device(x.device):
        rc = fn(t_grid.data_ptr(), t_grid.shape[0], fs.data_ptr(),
                ist.data_ptr(), x.data_ptr(), fs_out.data_ptr(),
                ist_out.data_ptr(), x_out.data_ptr(), saves.data_ptr(), B, D,
                *step_args, *kernel_norm_args(wn),
                _ctl_array(ctl, step.scaled is not None),
                0 if chunk is None else int(chunk), int(adaptive),
                torch.cuda.current_stream(x.device).cuda_stream)
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
                         adaptive: bool = True):
    """A whole solve over [t_grid[0], t_grid[-1]] from the widened state
    ``x0`` (B, D): one persistent launch, or launches of ``chunk``
    iterations until no trajectory is RUNNING (one host sync each).
    ``h0`` is a scalar or per trajectory (B,). Interior grid times are hit
    exactly and recorded. Returns the final (fs, ist, x, saves)."""
    t_grid, fs, ist, x, saves = init_carries(t_grid, x0, h0)
    if persistent:
        return fused_loop_chunk(t_grid, fs, ist, x, saves, step, ctl=ctl,
                                adaptive=adaptive)
    while bool((ist[:, 1] == RUNNING).any()):
        fs, ist, x, saves = fused_loop_chunk(t_grid, fs, ist, x, saves, step,
                                             ctl=ctl, chunk=chunk,
                                             adaptive=adaptive)
    return fs, ist, x, saves

"""Differentiation: the O(1)-memory reversible adjoint for modulated linear
ODEs dx/dt = (sum_k coeff_fn(t, theta)[k] basis[k]) x, the counterpart of
``vec_ode_tpu/diff.py:141-1186``.

The forward keeps no autograd graph and stores only its result; the
backward reconstructs the trajectory with inverse propagators instead of
storing it (exactly stable for norm-preserving operators, the quantum
control case; ``anchor_every`` re-anchors dissipative ones), transports
the state cotangent by transposed-basis exponential actions, and forms
each row's coefficient cotangents by the Fréchet recurrence of
``ops/adjoint.py``. These are the gradients of the DISCRETE scheme. The
row table (every exponential's coefficients over the working basis) is
recomputed in the backward with autograd on, and ONE
``torch.autograd.grad`` of it gives the theta, t0 and tf cotangents of
all rows at once.

The exponential actions are the adjoint kernels of ``ops/adjoint.py``:
on CUDA tensors a fixed-step solve is one launch of K7
(``adjoint_sweep_fwd``) forward and one of K8 (``adjoint_sweep_bwd``)
backward (one of each per segment with ``save_at_steps`` or
``anchor_every``), the adaptive backward one launch of K6
(``adjoint_bwd``) per recorded iteration, and the adaptive forward one
launch of the chain kernel K4 per iteration; on CPU tensors their plain
twins run. There is no other executor and no option for one.

Each ``jax.custom_vjp`` of the JAX package is a ``torch.autograd.Function``
here. ``theta`` is a tensor or a tuple, list or dict of tensors (flattened
in ``torch.utils._pytree`` order); every cotangent takes its primal's
dtype. Times given as Python numbers are made on the state's device:
float64 for the fixed-step solvers (the JAX package's 64-bit mode), and
for the adaptive one the type of the solve, the promotion of the state's
type with that of every time given as a tensor (a Python number is weak,
as in JAX).

Not ported: ``basis_grad=True`` (``make_adjoint_basis_solver``, gradients
with respect to the basis, no kernel) and the dense adjoint
(``adjoint_solve_dense``), ROADMAP queue 1 item 23; the adaptive adjoint
at order 6 and with ``scheme="cfm4"``, which need ``MagnusModulated6`` /
``CFM4Modulated`` (ROADMAP slice 4b); ``solve_for_grad`` (item 22) and
``fit_loop`` (item 24).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

from . import tableaus as tb
from .controller import StepControl
from .driver import DONE, RUNNING, init_state, step_once
from .exp.magnus import _B2, _C_MID
# Yoshida triple-jump sub-steps: composing the symmetric Magnus-4 step
# over [g1, 1 - 2 g1, g1] dt, g1 = 1 / (2 - 2^(1/5)), raises the order to 6
from .exp.magnus import _SUB_LEN as _YOSHIDA_LEN
from .exp.magnus import _SUB_OFF as _YOSHIDA_OFF
from .exp.modulated import (MagnusModulated4, ModulatedOperator,
                            _real_basis, _taylor_params, _unwiden, _widen)
from .ops.adjoint import adjoint_bwd, adjoint_sweep_bwd, adjoint_sweep_fwd
from .ops.cplx import Cplx
from .ops.expmv import basis_norms, stacked_basis, stacked_transpose

Pytree = Any

__all__ = ["adjoint_solve", "adjoint_solve_adaptive", "make_adjoint_solver",
           "make_adjoint_saves_solver", "make_adjoint_cfm_solver",
           "make_adaptive_adjoint_solver", "rows_per_step"]


def _magnus_cols(coeff_fn, K0, pairs, order, theta, t, dt):
    """One step's exponent coefficients over the (extended) working basis.
    order 2: dt g(t + dt/2); order 4: [w1, w2] by the Magnus-4 formulas
    over the two Gauss-Legendre nodes, w2 on the commutator extension."""
    if order == 2:
        return dt * coeff_fn(t + 0.5 * dt, theta)
    tm = t + 0.5 * dt
    g1 = coeff_fn(tm - _C_MID * dt, theta)
    g2 = coeff_fn(tm + _C_MID * dt, theta)
    w1 = 0.5 * dt * (g1 + g2)
    if pairs:
        j = [p[0] for p in pairs]
        k = [p[1] for p in pairs]
        w2 = (_B2 * dt * dt) * (g1[..., j] * g2[..., k]
                                - g1[..., k] * g2[..., j])
        return torch.cat([w1, w2], dim=-1)
    return w1


@dataclasses.dataclass(eq=False)
class _Core:
    """What the adjoint solvers share: the real working basis W (K', D, D)
    (with the commutator extension at orders 4 and 6), the original basis
    size K0, the per-row coefficient formulas ``cols(theta, t, dt)`` and
    the kernels' operands per (device, dtype)."""

    W: torch.Tensor
    K0: int
    pairs: list
    cols: Callable
    m: Optional[int]
    max_squarings: int
    _ops: dict = dataclasses.field(default_factory=dict)

    @property
    def Kp(self) -> int:
        return self.W.shape[0]

    @property
    def D(self) -> int:
        return self.W.shape[1]

    def operands(self, x):
        """(mt, ms, norms, m, theta) for states like x: the stacked basis
        for W v and for W^T v, the K' 1-norms as floats and the Taylor
        degree and threshold of x's type; made once per (device, dtype)."""
        key = (x.device, x.dtype)
        if key not in self._ops:
            W = self.W.to(device=x.device, dtype=x.dtype)
            m, theta = _taylor_params(x.dtype, self.m)
            self._ops[key] = (stacked_transpose(W), stacked_basis(W),
                              basis_norms(W), m, theta)
        return self._ops[key]


def _adjoint_core(basis, coeff_fn, *, order, m=None, max_squarings=16):
    """The shared machinery of the solvers (see :class:`_Core`). Order 6
    (Yoshida-composed Magnus-4) shares the order-4 row formulas; its three
    rows per step come from the row builder."""
    if order not in (2, 4, 6):
        raise ValueError(f"order must be 2, 4 or 6, got {order}")
    K0 = (basis.re if isinstance(basis, Cplx) else basis).shape[0]
    if order in (4, 6):
        ext, pairs = ModulatedOperator(basis, None).commutator_extension()
        W = _real_basis(ext)
    else:
        W, pairs = _real_basis(basis), []
    cols = functools.partial(_magnus_cols, coeff_fn, K0, pairs, min(order, 4))
    return _Core(W=W, K0=K0, pairs=pairs, cols=cols, m=m,
                 max_squarings=max_squarings)


def rows_per_step(order: int) -> int:
    return 3 if order == 6 else 1


def _make_rows_all(cols, order, n_steps):
    """rows(theta, t0, tf) -> (R, K'): every exponential row of the whole
    fixed-step solve, t_n = t0 + n dt with dt = (tf - t0) / n_steps, the
    formulas vmapped over the rows. Orders 2 and 4 give one row per step,
    order 6 the three Yoshida sub-rows."""

    def rows(theta, t0, tf):
        dt = (tf - t0) / n_steps
        ns = torch.arange(n_steps, dtype=t0.dtype, device=t0.device)
        if order == 6:
            off = torch.tensor(_YOSHIDA_OFF, dtype=t0.dtype, device=t0.device)
            ln = torch.tensor(_YOSHIDA_LEN, dtype=t0.dtype, device=t0.device)
            t_r = (t0 + ns[:, None] * dt + off * dt).reshape(-1)
            dt_r = (ln * dt).expand(n_steps, 3).reshape(-1)
        else:
            t_r = t0 + ns * dt
            dt_r = dt.expand(t_r.shape)
        return torch.func.vmap(lambda t_, d_: cols(theta, t_, d_))(t_r, dt_r)

    return rows


def _make_rows_all_multi(multi_cols, rps, n_steps):
    """rows(theta, t0, tf) -> (n_steps * rps, K') for schemes whose rows
    share the step's samples (CFM); ``multi_cols(theta, t, dt) -> (rps,
    K')``."""

    def rows(theta, t0, tf):
        dt = (tf - t0) / n_steps
        ns = torch.arange(n_steps, dtype=t0.dtype, device=t0.device)
        out = torch.func.vmap(lambda t_: multi_cols(theta, t_, dt))(
            t0 + ns * dt)
        return out.reshape(n_steps * rps, out.shape[-1])

    return rows


def _flat(core, y):
    """y (..., D) as a contiguous (B, D) batch."""
    return y.reshape(-1, core.D).contiguous()


def _rows_forward(core, c_all, y0w):
    """The R exponentials of c_all (R, K') applied in order to y0w: one
    launch of K7 (its twin on CPU tensors)."""
    x = _flat(core, y0w)
    mt, _, norms, m, theta = core.operands(x)
    y = adjoint_sweep_fwd(c_all.to(x.dtype).contiguous(), x, mt, norms, m=m,
                          theta=theta, max_squarings=core.max_squarings)
    return y.reshape(y0w.shape)


def _rows_backward(core, c_all, yf, ybar):
    """The reverse sweep over c_all (R, K') from the final state and its
    cotangent: one launch of K8 (its twin on CPU tensors). Returns (a0,
    cbar (R, K') summed over the batch)."""
    x = _flat(core, yf)
    a = _flat(core, ybar.to(x.dtype))
    mt, ms, norms, m, theta = core.operands(x)
    a0, cb = adjoint_sweep_bwd(c_all.to(x.dtype).contiguous(), x, a, mt, ms,
                               norms, m=m, theta=theta,
                               max_squarings=core.max_squarings)
    return a0.reshape(yf.shape), cb


def _bwd_row(core, c, x_next, a_next):
    """One reverse row with per-lane rows c (B, K') on (B, D) states: one
    launch of K6 (its twin on CPU tensors). Returns (x_n, a_n, cbar (B,
    K')), cbar in c's type."""
    x = _flat(core, x_next)
    a = _flat(core, a_next.to(x.dtype))
    mt, ms, norms, m, theta = core.operands(x)
    x_n, a_n, cb = adjoint_bwd(c.to(x.dtype).contiguous(), x, a, mt, ms,
                               norms, m=m, theta=theta,
                               max_squarings=core.max_squarings)
    return x_n.reshape(x_next.shape), a_n.reshape(a_next.shape), \
        cb.to(c.dtype)


def _theta_leaves(theta, device):
    """theta's leaves as tensors (a Python number becomes a float64 tensor
    on ``device``) and the tree spec."""
    leaves, spec = pytree.tree_flatten(theta)
    leaves = [v if isinstance(v, torch.Tensor)
              else torch.tensor(v, dtype=torch.float64, device=device)
              for v in leaves]
    return leaves, spec


def _fixed_times(t0, tf, device):
    """t0, tf as 0-dim tensors: a tensor keeps its type; a Python number
    takes the other's type, float64 when both are numbers."""
    ref = next((t.dtype for t in (t0, tf) if isinstance(t, torch.Tensor)),
               torch.float64)
    return tuple(t if isinstance(t, torch.Tensor)
                 else torch.tensor(t, dtype=ref, device=device)
                 for t in (t0, tf))


def _grads_of(out, wrt, needs, cotangent):
    """autograd.grad of ``out`` against the tensors of ``wrt`` whose
    ``needs`` is set, with zeros where ``out`` does not depend on one;
    None where nothing is needed."""
    picked = [v for v, n in zip(wrt, needs) if n]
    got = iter(torch.autograd.grad(out, picked, grad_outputs=cotangent,
                                   allow_unused=True)
               if picked and out.requires_grad else [None] * len(picked))
    res = []
    for v, n in zip(wrt, needs):
        g = next(got) if n else None
        res.append(torch.zeros_like(v) if n and g is None else g)
    return res


def _recompute(leaves, spec, times, needs):
    """Detached copies of theta's leaves and the times, each requiring
    grad where its cotangent is needed, and theta rebuilt from them."""
    lv = [v.detach().requires_grad_(bool(n)) for v, n in
          zip(leaves, needs[len(times):])]
    ts = [t.detach().requires_grad_(bool(n)) for t, n in zip(times, needs)]
    return lv, ts, pytree.tree_unflatten(lv, spec)


@dataclasses.dataclass(eq=False)
class _FixedPlan:
    """A fixed-step adjoint: the row builder, and the forward (c_all, y0w)
    -> out and backward (c_all, out, out_bar) -> (a0, cbar (R, K')) over
    the rows."""

    spec: Any
    rows: Callable
    forward: Callable
    backward: Callable


class _FixedStepAdjoint(torch.autograd.Function):
    """apply(plan, y0w, t0, tf, *theta_leaves) -> the plan's output (the
    final state, or the saved states)."""

    @staticmethod
    def forward(ctx, plan, y0w, t0, tf, *leaves):
        theta = pytree.tree_unflatten(list(leaves), plan.spec)
        out = plan.forward(plan.rows(theta, t0, tf), y0w)
        ctx.plan = plan
        ctx.save_for_backward(out, t0, tf, *leaves)
        return out

    @staticmethod
    def backward(ctx, out_bar):
        out, t0, tf, *leaves = ctx.saved_tensors
        plan = ctx.plan
        needs = ctx.needs_input_grad
        with torch.enable_grad():
            lv, (t0g, tfg), theta = _recompute(leaves, plan.spec, (t0, tf),
                                               needs[2:])
            c_all = plan.rows(theta, t0g, tfg)
        a0, cb = plan.backward(c_all.detach(), out, out_bar)
        grads = _grads_of(c_all, [t0g, tfg, *lv], needs[2:],
                          cb.to(c_all.dtype))
        return (None, a0 if needs[1] else None, *grads)


def _solver(rows_all, forward, backward):
    def solve(theta, y0w, t0, tf):
        leaves, spec = _theta_leaves(theta, y0w.device)
        t0, tf = _fixed_times(t0, tf, y0w.device)
        plan = _FixedPlan(spec, rows_all, forward, backward)
        return _FixedStepAdjoint.apply(plan, y0w, t0, tf, *leaves)

    return solve


def make_adjoint_solver(basis, coeff_fn: Callable, *, n_steps: int,
                        order: int = 4, m: Optional[int] = None,
                        max_squarings: int = 16):
    """``solve(theta, y0w, t0, tf) -> y_final_w`` over the WIDENED real
    state (..., D), differentiable with respect to theta, y0w, t0 and tf
    with O(1) memory.

    ``basis``: a Cplx (K, d, d) or real (K, D, D) basis, constant here;
    ``coeff_fn(t, theta) -> (K,)`` real coefficients, called on 0-dim
    times under ``torch.func.vmap``. Fixed-step Magnus scheme: order 2 the
    exponential midpoint, order 4 Magnus-4 on the commutator-extended
    basis, order 6 the Yoshida triple jump of the symmetric Magnus-4 step
    (three rows per step). The forward is one K7 launch over all rows;
    the backward one K8 launch (reconstruction x_n = e^{-M_n} x_{n+1},
    transport a_n = e^{M_n^T} a_{n+1}, cbar_k = <a_{n+1}, D_{W_k}
    e^{M_n} x_n>) and one autograd.grad of the recomputed rows. Exact for
    the discrete scheme up to the Taylor truncation (~eps) and the
    reconstruction drift (~n_steps eps for norm-preserving operators)."""
    core = _adjoint_core(basis, coeff_fn, order=order, m=m,
                         max_squarings=max_squarings)
    rows_all = _make_rows_all(core.cols, order, n_steps)
    return _solver(rows_all,
                   lambda c_all, y0w: _rows_forward(core, c_all, y0w),
                   lambda c_all, yf, ybar: _rows_backward(core, c_all, yf,
                                                          ybar))


def make_adjoint_saves_solver(basis, coeff_fn: Callable, *, n_steps: int,
                              save_at_steps, order: int = 4,
                              m: Optional[int] = None,
                              max_squarings: int = 16):
    """Trajectory losses: ``solve(theta, y0w, t0, tf) -> ys``, the states
    at the step indices ``save_at_steps`` (strictly increasing ints in
    [1, n_steps]) stacked on a new leading axis (S, ...), with O(S)
    memory. The solve runs to the last save (dt is still (tf - t0) /
    n_steps): one K7 launch per segment. The backward walks the segments
    in reverse, one K8 launch each, injecting each save's cotangent as it
    crosses it and re-anchoring the reconstruction on the saved state."""
    core = _adjoint_core(basis, coeff_fn, order=order, m=m,
                         max_squarings=max_squarings)
    saves = tuple(int(s) for s in save_at_steps)
    bounds = (0,) + saves
    if (not saves or saves[-1] > n_steps
            or any(b <= a for a, b in zip(bounds[:-1], bounds[1:]))):
        raise ValueError(
            "save_at_steps must be strictly increasing ints in "
            f"[1, n_steps={n_steps}]; got {saves}")
    rps = rows_per_step(order)
    rb = tuple(b * rps for b in bounds)
    rows_all = _make_rows_all(core.cols, order, n_steps)

    def forward(c_all, y0w):
        parts, x = [], y0w
        for a, b in zip(rb[:-1], rb[1:]):
            x = _rows_forward(core, c_all[a:b], x)
            parts.append(x)
        return torch.stack(parts)

    def backward(c_all, ys, ysbar):
        # segment j's backward starts from its anchor ys[j] with the
        # cotangent transported from segment j + 1 plus ysbar[j]
        a_in = torch.zeros_like(ysbar[-1])
        chunks = [None] * len(saves)
        for j in range(len(saves) - 1, -1, -1):
            a_in, chunks[j] = _rows_backward(core, c_all[rb[j]:rb[j + 1]],
                                             ys[j], a_in + ysbar[j])
        rest = c_all.new_zeros((c_all.shape[0] - rb[-1], core.Kp))
        return a_in, torch.cat([*chunks, rest.to(chunks[0].dtype)])

    return _solver(rows_all, forward, backward)


def make_adjoint_cfm_solver(basis, coeff_fn: Callable, *, n_steps: int,
                            alpha=None, c=None, m: Optional[int] = None,
                            max_squarings: int = 16):
    """The fixed-step adjoint over COMMUTATOR-FREE Magnus rows c_i = dt
    sum_j alpha[i, j] g(t + c_j dt) on the un-extended basis; by default
    the order-4 scheme CFM_R4_J2_GL over the Gauss-Legendre nodes. ``solve
    (theta, y0w, t0, tf) -> y_final_w`` as :func:`make_adjoint_solver`."""
    if alpha is None:
        alpha = tb.CFM_R4_J2_GL
    if c is None:
        c = tb.C_GAUSS_LEGENDRE_4
    alpha = np.asarray(alpha, np.float64)
    c_nodes = tuple(float(cj) for cj in np.asarray(c))
    if alpha.ndim != 2 or alpha.shape[1] != len(c_nodes):
        raise ValueError(
            f"alpha must be (s, {len(c_nodes)}); got {alpha.shape}")
    # the order-2 core: the un-extended basis, no commutator directions
    core = _adjoint_core(basis, coeff_fn, order=2, m=m,
                         max_squarings=max_squarings)
    s_rows = alpha.shape[0]

    def multi_cols(theta, t, dt):
        gs = [coeff_fn(t + cj * dt, theta) for cj in c_nodes]
        rows = []
        for i in range(s_rows):
            acc = None
            for j, g in enumerate(gs):
                if alpha[i, j] == 0.0:
                    continue
                term = float(alpha[i, j]) * g
                acc = term if acc is None else acc + term
            rows.append(dt * (acc if acc is not None
                              else torch.zeros_like(gs[0])))
        return torch.stack(rows)

    rows_all = _make_rows_all_multi(multi_cols, s_rows, n_steps)
    return _solver(rows_all,
                   lambda c_all, y0w: _rows_forward(core, c_all, y0w),
                   lambda c_all, yf, ybar: _rows_backward(core, c_all, yf,
                                                          ybar))


@dataclasses.dataclass(eq=False)
class _AdaptivePlan:
    spec: Any
    core: _Core
    basis: Any
    coeff_fn: Callable
    ctl: StepControl


def _adaptive_forward(plan, theta, y0w, t0, tf, h0):
    """The adaptive driver forward (``driver.step_once`` with
    ``MagnusModulated4`` over coeff_fn(., theta)): one chain-kernel launch
    per iteration on the card. Records the per-iteration times only and
    stops at the first iteration with no lane RUNNING (the JAX package
    runs all ``ctl.max_steps``; its later rows have dt = 0, are the
    identity and add nothing to any cotangent). Returns (y_final_w,
    status, ts (n_it + 1, B))."""
    if y0w.ndim != 2:
        raise ValueError(
            "the adaptive adjoint needs a BATCHED state: y0 with a leading "
            f"trajectory axis, widened to (B, 2d); got ndim={y0w.ndim}. For "
            "a single trajectory add a length-1 batch axis (y0[None]).")
    core, ctl = plan.core, plan.ctl
    is_cplx = isinstance(plan.basis, Cplx)
    op = ModulatedOperator(plan.basis, lambda t: plan.coeff_fn(t, theta),
                           ext_basis=core.W)
    stepper = MagnusModulated4(op, adaptive=True, m=core.m,
                               max_squarings=core.max_squarings)
    step_fn = stepper.make_step_fn()
    B = y0w.shape[0]
    state = init_state(_unwiden(y0w, is_cplx), torch.stack([t0, tf]), h0,
                       batch_shape=(B,))
    ts = [state.t]
    for _ in range(ctl.max_steps):
        if not bool((state.status == RUNNING).any()):
            break
        state = step_once(state, step_fn, adaptive=True, ctl=ctl,
                          error_norm=stepper.error_norm, record_ys=False)
        ts.append(state.t)
    return _widen(state.x, is_cplx), state.status, torch.stack(ts)


class _AdaptiveAdjoint(torch.autograd.Function):
    """apply(plan, y0w, t0, tf, h0, *theta_leaves) -> (y_final_w,
    status)."""

    @staticmethod
    def forward(ctx, plan, y0w, t0, tf, h0, *leaves):
        theta = pytree.tree_unflatten(list(leaves), plan.spec)
        yfw, status, ts_all = _adaptive_forward(plan, theta, y0w, t0, tf, h0)
        ctx.mark_non_differentiable(status)
        ctx.plan = plan
        ctx.save_for_backward(yfw, ts_all, t0, tf, h0, *leaves)
        return yfw, status

    @staticmethod
    def backward(ctx, ybar, _status_bar):
        yfw, ts_all, t0, tf, h0, *leaves = ctx.saved_tensors
        plan, core = ctx.plan, ctx.plan.core
        needs = ctx.needs_input_grad
        n_it, B = ts_all.shape[0] - 1, ts_all.shape[1]
        ybar = ybar.to(yfw.dtype)
        with torch.enable_grad():
            lv, _, theta = _recompute(leaves, plan.spec, (), needs[5:])
            # the (n_it, B, K') rows of every recorded iteration at once:
            # the same sum as one vjp per iteration, in another order;
            # rows with dt = 0 are zero
            t_r = ts_all[:-1].reshape(-1)
            dt_r = (ts_all[1:] - ts_all[:-1]).reshape(-1)
            rows = torch.func.vmap(lambda t_, d_: core.cols(theta, t_, d_))(
                t_r, dt_r).reshape(n_it, B, core.Kp)
        rk = rows.detach().to(yfw.dtype).contiguous()
        cbs = torch.empty_like(rk)
        x, a = yfw, ybar
        for r in range(n_it - 1, -1, -1):   # one K6 launch per iteration
            x, a, cbs[r] = _bwd_row(core, rk[r], x, a)
        grads = _grads_of(rows, lv, needs[5:], cbs.to(rows.dtype))

        # the endpoints by the continuous adjoint identity dL/dtf =
        # <a(tf), A(tf) x(tf)>, dL/dt0 = -<a(t0), A(t0) x(t0)>, per-lane
        # final times (the frozen step sequence has no endpoint dependence
        # of its own); h0 shapes the frozen sequence: its cotangent is 0
        theta0 = pytree.tree_unflatten([v.detach() for v in leaves],
                                       plan.spec)

        def a_times_x(t_b, xw):
            g = torch.func.vmap(lambda t: plan.coeff_fn(t, theta0))(t_b)
            dt = torch.promote_types(torch.promote_types(g.dtype, xw.dtype),
                                     core.W.dtype)
            return torch.einsum("bk,kij,bj->bi", g.to(dt),
                                core.W[:core.K0].to(device=xw.device,
                                                    dtype=dt), xw.to(dt))

        tf_bar = torch.sum(ybar * a_times_x(ts_all[-1], yfw))
        t0_bar = -torch.sum(a * a_times_x(ts_all[0], x))
        return (None, a if needs[1] else None,
                t0_bar.to(t0.dtype) if needs[2] else None,
                tf_bar.to(tf.dtype) if needs[3] else None,
                torch.zeros_like(h0) if needs[4] else None, *grads)


def make_adaptive_adjoint_solver(basis, coeff_fn: Callable, *,
                                 ctl: StepControl, order: int = 4,
                                 scheme: str = "magnus",
                                 m: Optional[int] = None,
                                 max_squarings: int = 16):
    """The adaptive adjoint, Magnus order 4: ``solve(theta, y0w, t0, tf,
    h0) -> (y_final_w, status)`` runs the adaptive driver forward
    (``step_once`` semantics with ``MagnusModulated4``, at most
    ``ctl.max_steps`` iterations), recording only the per-iteration times,
    and replays the step sequence in reverse, one K6 launch per recorded
    iteration (the frozen-step-sequence discrete adjoint: the step sizes
    are constants in theta). Iterations that did not advance have dt = 0:
    the identity, with a zero coefficient Jacobian, so a rejected trial
    never reaches the gradient. ``coeff_fn`` must take batched times (B,)
    -> (B, K) (the steppers sample it so). ``status`` holds the driver's
    codes per lane; a lane that ran out of ``ctl.max_steps`` holds a
    mid-integration state (see :func:`adjoint_solve_adaptive`)."""
    if scheme not in ("magnus", "cfm4"):
        raise ValueError(f"scheme must be 'magnus' or 'cfm4', got {scheme}")
    if scheme == "cfm4":
        raise NotImplementedError(
            "the adaptive adjoint with scheme='cfm4' needs CFM4Modulated, "
            "ROADMAP slice 4b")
    if order not in (4, 6):
        raise ValueError(
            f"adaptive adjoint order must be 4 or 6, got {order}")
    if order == 6:
        raise NotImplementedError(
            "the adaptive adjoint at order 6 needs MagnusModulated6, "
            "ROADMAP slice 4b")
    core = _adjoint_core(basis, coeff_fn, order=4, m=m,
                         max_squarings=max_squarings)

    def solve(theta, y0w, t0, tf, h0):
        leaves, spec = _theta_leaves(theta, y0w.device)
        tdt = y0w.dtype
        for v in (t0, tf, h0):
            if isinstance(v, torch.Tensor):
                tdt = torch.promote_types(tdt, v.dtype)
        t0, tf, h0 = (v if isinstance(v, torch.Tensor)
                      else torch.tensor(v, dtype=tdt, device=y0w.device)
                      for v in (t0, tf, h0))
        plan = _AdaptivePlan(spec, core, basis, coeff_fn, ctl)
        # one time type for the solve; the cotangents keep their own
        return _AdaptiveAdjoint.apply(plan, y0w, t0.to(tdt), tf.to(tdt),
                                      h0.to(tdt), *leaves)

    return solve


def adjoint_solve_adaptive(basis, coeff_fn: Callable, theta: Pytree, y0,
                           t0, tf, *, ctl: StepControl, order: int = 4,
                           scheme: str = "magnus", h0=None,
                           m: Optional[int] = None, max_squarings: int = 16,
                           return_status: bool = False):
    """Terminal state of the ADAPTIVE Magnus-4 solve of dx/dt =
    A(t; theta) x, differentiable with respect to theta, y0, t0 and tf with
    O(iterations x B) scalar memory (see
    :func:`make_adaptive_adjoint_solver`). Lanes that do not reach tf
    within ``ctl.max_steps`` iterations are NaN-poisoned, so that a loss
    never trains on a truncated solve; ``return_status=True`` returns
    (y_final, status) instead, unpoisoned. ``y0``: Cplx or real, with a
    leading batch axis."""
    solver = make_adaptive_adjoint_solver(
        basis, coeff_fn, ctl=ctl, order=order, scheme=scheme, m=m,
        max_squarings=max_squarings)
    if h0 is None:
        h0 = ctl.init_h()
    is_cplx = isinstance(y0, Cplx)
    yfw, status = solver(theta, _widen(y0, is_cplx), t0, tf, h0)
    if return_status:
        return _unwiden(yfw, is_cplx), status
    ok = (status == DONE)[:, None]
    yfw = torch.where(ok, yfw, yfw.new_tensor(float("nan")))
    return _unwiden(yfw, is_cplx)


def adjoint_solve(basis, coeff_fn: Callable, theta: Pytree, y0, t0, tf,
                  n_steps: int, *, order: int = 4, m: Optional[int] = None,
                  max_squarings: int = 16, save_at_steps=None,
                  basis_grad: bool = False,
                  anchor_every: Optional[int] = None):
    """Terminal state of dx/dt = (sum_k coeff_fn(t, theta)[k] basis[k]) x
    after ``n_steps`` fixed Magnus steps, differentiable with respect to
    theta, y0, t0 and tf with O(1) memory (:func:`make_adjoint_solver`).

    ``save_at_steps`` (strictly increasing ints in [1, n_steps]) returns
    the states at those steps instead, stacked on a new leading axis
    (:func:`make_adjoint_saves_solver`). ``anchor_every=k`` stores the
    state every k steps and starts each backward segment from its anchor,
    for dissipative operators whose reconstruction by inverse propagators
    amplifies rounding (~e^{2 gamma T}); pick k with gamma k dt <~ 1.
    ``basis_grad=True`` raises ``NotImplementedError`` (ROADMAP queue 1
    item 23). ``basis`` and ``y0`` may be Cplx; the widening is ordinary
    differentiable concatenation outside the adjoint."""
    is_cplx = isinstance(y0, Cplx)
    kw = dict(order=order, m=m, max_squarings=max_squarings)
    if anchor_every is not None:
        if save_at_steps is not None or basis_grad:
            raise ValueError(
                "anchor_every composes with neither save_at_steps (saves "
                "are anchors already) nor basis_grad")
        k = int(anchor_every)
        if k < 1:
            raise ValueError(f"anchor_every must be >= 1, got {anchor_every}")
        anchors = tuple(range(k, n_steps, k)) + (n_steps,)
        solver = make_adjoint_saves_solver(
            basis, coeff_fn, n_steps=n_steps, save_at_steps=anchors, **kw)
        return _unwiden(solver(theta, _widen(y0, is_cplx), t0, tf)[-1],
                        is_cplx)
    if basis_grad:
        raise NotImplementedError(
            "basis_grad=True (gradients with respect to the basis, "
            "make_adjoint_basis_solver) is ROADMAP queue 1 item 23")
    if save_at_steps is not None:
        solver = make_adjoint_saves_solver(
            basis, coeff_fn, n_steps=n_steps, save_at_steps=save_at_steps,
            **kw)
    else:
        solver = make_adjoint_solver(basis, coeff_fn, n_steps=n_steps, **kw)
    return _unwiden(solver(theta, _widen(y0, is_cplx), t0, tf), is_cplx)

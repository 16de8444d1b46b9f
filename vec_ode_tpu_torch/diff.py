"""Differentiation: gradients through the driver (:func:`solve_for_grad`,
:func:`grad_terminal`, :func:`value_and_grad_terminal`: autograd through
``method="scan"``), the O(1)-memory reversible adjoint for modulated
linear ODEs dx/dt = (sum_k coeff_fn(t, theta)[k] basis[k]) x, and for
black-box operators, and the optimisation loop over it: the counterpart
of ``vec_ode_tpu/diff.py``.

Gradients through the driver run no hand-written kernel: the step
functions they differentiate are plain torch (the kernel wrappers refuse
inputs that require grad), as the JAX package's run XLA and never
Pallas.

The forward keeps no autograd graph and stores only its result; the
backward reconstructs the trajectory with inverse propagators instead of
storing it (exactly stable for norm-preserving operators, the quantum
control case; ``anchor_every`` re-anchors dissipative ones), transports
the state cotangent by transposed-basis exponential actions, and forms
each row's coefficient cotangents by the Fréchet recurrence of
``ops/adjoint.py``. These are the gradients of the DISCRETE scheme. The
row table (every exponential's coefficients over the working basis) is
recomputed in the backward, and ONE ``torch.func.vjp`` of it gives the
theta, t0 and tf cotangents of all rows at once.

The exponential actions are the adjoint kernels of ``ops/adjoint.py``:
on CUDA tensors a fixed-step solve is one launch of K7
(``adjoint_sweep_fwd``) forward and one of K8 (``adjoint_sweep_bwd``)
backward (one of each per segment with ``save_at_steps`` or
``anchor_every``), the adaptive backward one launch of K6
(``adjoint_bwd``) per recorded iteration, and the adaptive forward one
launch of the chain kernel K4 per iteration; on CPU tensors their plain
twins run. There is no other executor and no option for one. The
basis-gradient solver (``basis_grad=True``) runs K7 forward and K6 per
row backward; the dense adjoint (``adjoint_solve_dense``) has no kernel
(``ops/expm``, as the JAX package's runs XLA's expm).

The Functions take ``setup_context`` and call the kernels through the
custom operators of ``ops/adjoint.py``, so ``torch.func.vmap`` of
``torch.func.grad`` maps them over pulses (theta batched): the fixed-step
one by the generated vmap rule (each operator runs the mapped samples in
turn, one launch each), the adaptive one by its own rule (each sample's
forward in turn). The basis-gradient one does not vmap.

Each ``jax.custom_vjp`` of the JAX package is a ``torch.autograd.Function``
here. ``theta`` is a tensor or a tuple, list or dict of tensors (flattened
in ``torch.utils._pytree`` order); every cotangent takes its primal's
dtype. Times given as Python numbers are made on the state's device:
float64 for the fixed-step solvers (the JAX package's 64-bit mode), and
for the adaptive one the type of the solve, the promotion of the state's
type with that of every time given as a tensor (a Python number is weak,
as in JAX).

``fit_loop`` runs eagerly over ``torch.optim``; the JAX package's ``jit``
and ``unroll`` are XLA compile options with no counterpart.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

from . import tableaus as tb
from .controller import StepControl
from .driver import (DONE, RUNNING, Solution, init_state, integrate,
                     make_grid, step_once)
from .exp.magnus import _B2, _C_MID
# Yoshida triple-jump sub-steps: composing the symmetric Magnus-4 step
# over [g1, 1 - 2 g1, g1] dt, g1 = 1 / (2 - 2^(1/5)), raises the order to 6
from .exp.magnus import _SUB_LEN as _YOSHIDA_LEN
from .exp.magnus import _SUB_OFF as _YOSHIDA_OFF
from .exp.modulated import (CFM4Modulated, MagnusModulated4,
                            MagnusModulated6, ModulatedOperator, _real_basis,
                            _taylor_params, _unwiden, _widen)
from .ops.adjoint import row_op, sweep_bwd_op, sweep_fwd_op
from .ops.cplx import Cplx, embed
from .ops.expm import expm, expm_frechet
from .ops.expmv import (basis_norms, pairs_of, stacked_basis,
                        stacked_transpose)

Pytree = Any

__all__ = ["solve_for_grad", "grad_terminal", "value_and_grad_terminal",
           "adjoint_solve", "adjoint_solve_adaptive", "make_adjoint_solver",
           "make_adjoint_saves_solver", "make_adjoint_cfm_solver",
           "make_adaptive_adjoint_solver", "make_adjoint_basis_solver",
           "make_adjoint_dense_solver", "adjoint_solve_dense", "FitResult",
           "make_fit_loop", "fit_loop", "rows_per_step"]


def solve_for_grad(step_fn_factory: Callable, params: Pytree, y0: Pytree,
                   t0, tf, h0, *, adaptive: bool = False,
                   ctl: StepControl = StepControl(max_steps=4096),
                   remat: bool = False, remat_levels: int = 0,
                   grad_safe: Optional[bool] = None, device="cuda",
                   **kw) -> Solution:
    """A solve that autograd differentiates: ``step_fn_factory(params) ->
    step_fn``, run by the scan driver (exactly ``ctl.max_steps``
    iterations: pick it tight). Its Solution's tensors carry gradients
    with respect to ``params`` and ``y0``.

    ``remat=True`` runs each step under ``torch.utils.checkpoint``
    (recomputed in the backward pass instead of stored);
    ``remat_levels=k`` nests the scan k + 1 levels deep
    (``driver.integrate``). ``grad_safe`` (default: on for adaptive runs)
    decides accept / reject outside autograd, so a rejected trial that
    overflowed cannot NaN the gradient. The solve runs where ``y0`` lies
    (``device`` places leaves that are not tensors); ``kw`` goes to
    ``driver.integrate``."""
    from torch.utils.checkpoint import checkpoint

    from .api import _as_state, _device_of, _time_dtype

    step_fn = step_fn_factory(params)
    if remat:
        inner = step_fn

        def step_fn(*args):
            return checkpoint(inner, *args, use_reentrant=False,
                              preserve_rng_state=False)
    if grad_safe is None:
        grad_safe = bool(adaptive)
    y0 = _as_state(y0, device)
    t_grid = make_grid(t0, tf, dtype=_time_dtype(t0, tf),
                       device=_device_of(y0))
    return integrate(step_fn, y0, t_grid, h0, adaptive=adaptive, ctl=ctl,
                     method="scan", remat_levels=remat_levels,
                     grad_safe=grad_safe, **kw)


def _terminal_value_and_grad(loss_fn, step_fn_factory, y0, t0, tf, h0, kw,
                             params):
    """(loss_fn(y_final), its gradient over the ``params`` pytree): python
    and numpy leaves become float tensors on y0's device."""
    from .api import _as_state, _device_of

    y0 = _as_state(y0, kw.get("device", "cuda"))
    dev = _device_of(y0)
    leaves, spec = pytree.tree_flatten(params)
    leaves = [(a.detach() if isinstance(a, torch.Tensor)
               else torch.as_tensor(np.asarray(a, np.float64), device=dev)
               ).requires_grad_() for a in leaves]
    with torch.enable_grad():
        sol = solve_for_grad(step_fn_factory,
                             pytree.tree_unflatten(leaves, spec), y0, t0, tf,
                             h0, **kw)
        value = loss_fn(sol.y_final)
        grads = torch.autograd.grad(value, leaves, allow_unused=True)
    grads = [torch.zeros_like(a) if g is None else g
             for g, a in zip(grads, leaves)]
    return value.detach(), pytree.tree_unflatten(grads, spec)


def grad_terminal(loss_fn: Callable, step_fn_factory: Callable, y0: Pytree,
                  t0, tf, h0, **kw) -> Callable:
    """``grad(params)``: the gradient of ``loss_fn(y_final)`` with respect
    to the stepper's parameters (a pytree) through the whole solve
    (:func:`solve_for_grad`, which takes ``kw``)."""
    return lambda params: _terminal_value_and_grad(
        loss_fn, step_fn_factory, y0, t0, tf, h0, kw, params)[1]


def value_and_grad_terminal(loss_fn: Callable, step_fn_factory: Callable,
                            y0: Pytree, t0, tf, h0, **kw) -> Callable:
    """``value_and_grad(params) -> (loss_fn(y_final), gradient)``: as
    :func:`grad_terminal`, with the loss's value."""
    return functools.partial(_terminal_value_and_grad, loss_fn,
                             step_fn_factory, y0, t0, tf, h0, kw)


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

    def on(self, W):
        """This core over the working basis W: the autograd Functions take
        W as an input, so that a basis made under a ``torch.func``
        transform reaches them unwrapped."""
        return dataclasses.replace(self, W=W, _ops={})

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
    """y (..., D) as a contiguous (B, D) batch, detached: the kernels'
    operators are not differentiable, the Functions around them are."""
    return y.detach().reshape(-1, core.D).contiguous()


def _rows_of(c, dtype):
    return c.detach().to(dtype).contiguous()


def _rows_forward(core, c_all, y0w):
    """The R exponentials of c_all (R, K') applied in order to y0w: one
    launch of K7 (its twin on CPU tensors)."""
    x = _flat(core, y0w)
    mt, _, norms, m, theta = core.operands(x)
    y = sweep_fwd_op(_rows_of(c_all, x.dtype), x, mt.detach(), list(norms),
                     m, theta, core.max_squarings)
    return y.reshape(y0w.shape)


def _rows_backward(core, c_all, yf, ybar):
    """The reverse sweep over c_all (R, K') from the final state and its
    cotangent: one launch of K8 (its twin on CPU tensors). Returns (a0,
    cbar (R, K') summed over the batch)."""
    x = _flat(core, yf)
    a = _flat(core, ybar.to(x.dtype))
    mt, ms, norms, m, theta = core.operands(x)
    a0, cb = sweep_bwd_op(_rows_of(c_all, x.dtype), x, a, mt.detach(),
                          ms.detach(), list(norms), m, theta,
                          core.max_squarings)
    return a0.reshape(yf.shape), cb


def _bwd_row(core, c, x_next, a_next):
    """One reverse row with per-lane rows c (B, K') on (B, D) states: one
    launch of K6 (its twin on CPU tensors). Returns (x_n, a_n, cbar (B,
    K')), cbar in c's type."""
    x = _flat(core, x_next)
    a = _flat(core, a_next.to(x.dtype))
    mt, ms, norms, m, theta = core.operands(x)
    x_n, a_n, cb = row_op(_rows_of(c, x.dtype), x, a, mt.detach(),
                          ms.detach(), list(norms), m, theta,
                          core.max_squarings)
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


def _rows_vjp(rows, spec, args, leaves):
    """(rows(theta, *args), vjp) by ``torch.func.vjp`` over args and
    theta's leaves: ``vjp(cotangent)`` gives their cotangents in that
    order. A function transform, so the backwards below compose with
    ``torch.func.vmap`` and ``grad`` (autograd.grad inside a backward does
    not)."""
    n = len(args)

    def f(*xs):
        return rows(pytree.tree_unflatten(list(xs[n:]), spec), *xs[:n])

    return torch.func.vjp(f, *args, *leaves)


def _needed(grads, needs):
    """The cotangents whose ``needs`` is set, None for the others."""
    return [g if n else None for g, n in zip(grads, needs)]


@dataclasses.dataclass(eq=False)
class _FixedPlan:
    """A fixed-step adjoint: the core, the row builder, and the forward
    (core, c_all, y0w) -> out and backward (core, c_all, out, out_bar) ->
    (a0, cbar (R, K')) over the rows."""

    spec: Any
    core: _Core
    rows: Callable
    forward: Callable
    backward: Callable


class _FixedStepAdjoint(torch.autograd.Function):
    """apply(plan, W, y0w, t0, tf, *theta_leaves) -> the plan's output (the
    final state, or the saved states) over the working basis W. Its
    forward and backward are torch operations and the kernels' operators
    (``ops/adjoint.py``), so ``torch.func.vmap`` maps them (over pulses:
    each operator runs the mapped samples in turn)."""

    generate_vmap_rule = True

    @staticmethod
    def forward(plan, W, y0w, t0, tf, *leaves):
        theta = pytree.tree_unflatten(list(leaves), plan.spec)
        return plan.forward(plan.core.on(W), plan.rows(theta, t0, tf), y0w)

    @staticmethod
    def setup_context(ctx, inputs, output):
        plan, W, _, t0, tf, *leaves = inputs
        # the basis is an input, a constant of the solve: held, not saved
        ctx.plan, ctx.W = plan, W
        ctx.save_for_backward(output, t0, tf, *leaves)

    @staticmethod
    def backward(ctx, out_bar):
        out, t0, tf, *leaves = ctx.saved_tensors
        plan, W = ctx.plan, ctx.W
        needs = ctx.needs_input_grad
        c_all, vjp = _rows_vjp(plan.rows, plan.spec, (t0, tf), leaves)
        a0, cb = plan.backward(plan.core.on(W), c_all, out, out_bar)
        grads = _needed(vjp(cb.to(c_all.dtype)), needs[3:])
        return (None, None, a0 if needs[2] else None, *grads)


def _solver(core, rows_all, forward=_rows_forward, backward=_rows_backward):
    def solve(theta, y0w, t0, tf):
        leaves, spec = _theta_leaves(theta, y0w.device)
        t0, tf = _fixed_times(t0, tf, y0w.device)
        plan = _FixedPlan(spec, core, rows_all, forward, backward)
        return _FixedStepAdjoint.apply(plan, core.W, y0w, t0, tf, *leaves)

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
    return _solver(core, _make_rows_all(core.cols, order, n_steps))


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

    def forward(core, c_all, y0w):
        parts, x = [], y0w
        for a, b in zip(rb[:-1], rb[1:]):
            x = _rows_forward(core, c_all[a:b], x)
            parts.append(x)
        return torch.stack(parts)

    def backward(core, c_all, ys, ysbar):
        # segment j's backward starts from its anchor ys[j] with the
        # cotangent transported from segment j + 1 plus ysbar[j]
        a_in = torch.zeros_like(ysbar[-1])
        chunks = [None] * len(saves)
        for j in range(len(saves) - 1, -1, -1):
            a_in, chunks[j] = _rows_backward(core, c_all[rb[j]:rb[j + 1]],
                                             ys[j], a_in + ysbar[j])
        rest = c_all.new_zeros((c_all.shape[0] - rb[-1], core.Kp))
        return a_in, torch.cat([*chunks, rest.to(chunks[0].dtype)])

    return _solver(core, rows_all, forward, backward)


def _cfm_multi_cols(coeff_fn, alpha, c_nodes):
    """multi_cols(theta, t, dt) -> (s, K0): the CFM rows dt sum_j alpha[i,
    j] g(t + c_j dt), the zero alphas left out and the sum taken in j
    order (the kernels' order, ops/expmv.chain_rows)."""
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

    return multi_cols


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
    return _solver(core, _make_rows_all_multi(
        _cfm_multi_cols(coeff_fn, alpha, c_nodes), alpha.shape[0], n_steps))


def _extend_w(W0, pairs):
    """The real working basis W0 (K0, D, D) followed by the commutators
    [W0_j, W0_k] of ``pairs``: the differentiable counterpart of
    ``ModulatedOperator.commutator_extension`` (``vec_ode_tpu/diff.py:
    _extend_w``)."""
    if not pairs:
        return W0
    comms = [W0[j] @ W0[k] - W0[k] @ W0[j] for j, k in pairs]
    return torch.cat([W0, torch.stack(comms)])


@dataclasses.dataclass(eq=False)
class _BasisPlan:
    """A basis-gradient adjoint: the rows over the extended basis and
    ``core(W_ext)``, the adjoint core over a given working basis."""

    spec: Any
    pairs: list
    rows: Callable
    m: Optional[int]
    max_squarings: int

    def core(self, W_ext):
        return _Core(W=W_ext, K0=W_ext.shape[0] - len(self.pairs),
                     pairs=self.pairs, cols=None, m=self.m,
                     max_squarings=self.max_squarings)


class _BasisAdjoint(torch.autograd.Function):
    """apply(plan, y0w, t0, tf, W0, *theta_leaves) -> y_final_w. Forward:
    one K7 launch over W_ext = _extend_w(W0). Backward: per row, in
    reverse, one K6 launch (the row broadcast to the batch) reconstructs
    x_r and transports a_r (its cbar is not used); G_r = sum_b a_{r+1,b}
    x_{r,b}^T; one batched Fréchet adjoint Gbar_r = L(M_r^T, G_r) gives
    the coefficient cotangents <W_k, Gbar_r> and the basis cotangent
    sum_r c_{r,k} Gbar_r, through _extend_w's vjp to W0. Memory O(R D^2)
    for the stacked G_r. Not mapped by ``torch.func.vmap`` (the Fréchet
    adjoint reads its squaring count on the host)."""

    @staticmethod
    def forward(plan, y0w, t0, tf, W0, *leaves):
        theta = pytree.tree_unflatten(list(leaves), plan.spec)
        return _rows_forward(plan.core(_extend_w(W0, plan.pairs)),
                             plan.rows(theta, t0, tf), y0w)

    @staticmethod
    def setup_context(ctx, inputs, output):
        plan, _, t0, tf, W0, *leaves = inputs
        ctx.plan = plan
        ctx.save_for_backward(output, t0, tf, W0, *leaves)

    @staticmethod
    def backward(ctx, ybar):
        yf, t0, tf, W0, *leaves = ctx.saved_tensors
        plan = ctx.plan
        needs = ctx.needs_input_grad
        W_ext, ext_vjp = torch.func.vjp(lambda w: _extend_w(w, plan.pairs),
                                        W0)
        c_all, rows_vjp = _rows_vjp(plan.rows, plan.spec, (t0, tf), leaves)
        core = plan.core(W_ext)
        x, a = _flat(core, yf), _flat(core, ybar.to(yf.dtype))
        B, R = x.shape[0], c_all.shape[0]
        ck = c_all.to(x.dtype)
        G = [None] * R
        for r in range(R - 1, -1, -1):
            x_n, a_n, _ = _bwd_row(core, ck[r].expand(B, core.Kp), x, a)
            G[r] = torch.einsum("bi,bj->ij", a, x_n)
            x, a = x_n, a_n
        G_all = torch.stack(G) if G else x.new_zeros((0, core.D, core.D))
        M_all = torch.einsum("rk,kij->rij", c_all.to(W_ext.dtype), W_ext)
        Gbar = expm_frechet(M_all.transpose(-1, -2), G_all,
                            max_squarings=plan.max_squarings)
        cb_all = torch.einsum("kij,rij->rk", W_ext, Gbar)
        wext_bar = torch.einsum("rk,rij->kij", c_all.to(Gbar.dtype), Gbar)
        (w0_bar,) = ext_vjp(wext_bar.to(W_ext.dtype))
        t0_bar, tf_bar, *grads = _needed(rows_vjp(cb_all.to(c_all.dtype)),
                                         needs[2:4] + needs[5:])
        return (None, a.reshape(yf.shape) if needs[1] else None, t0_bar,
                tf_bar, w0_bar if needs[4] else None, *grads)


def make_adjoint_basis_solver(basis, coeff_fn: Callable, *, n_steps: int,
                              order: int = 4, m: Optional[int] = None,
                              max_squarings: int = 16):
    """Like :func:`make_adjoint_solver`, but ALSO differentiable with
    respect to the basis matrices (Hamiltonian learning): ``solve(theta,
    y0w, t0, tf, W0) -> y_final_w`` with ``W0`` the (K0, D, D) REAL
    working basis (``exp.modulated._real_basis(basis)``: for a Cplx basis
    the ring embedding, plain differentiable concatenation outside, so
    gradients reach the Cplx pair). ``basis`` gives K0 only. Forward: one
    K7 launch over the commutator-extended W0; backward (see
    :class:`_BasisAdjoint`): one K6 launch a row and one batched Fréchet
    adjoint, O(n_steps D^2) memory."""
    if order not in (2, 4, 6):
        raise ValueError(f"order must be 2, 4 or 6, got {order}")
    K0 = (basis.re if isinstance(basis, Cplx) else basis).shape[0]
    pairs = pairs_of(K0) if order in (4, 6) else []
    cols = functools.partial(_magnus_cols, coeff_fn, K0, pairs, min(order, 4))
    rows_all = _make_rows_all(cols, order, n_steps)

    def solve(theta, y0w, t0, tf, W0):
        leaves, spec = _theta_leaves(theta, y0w.device)
        t0, tf = _fixed_times(t0, tf, y0w.device)
        plan = _BasisPlan(spec, pairs, rows_all, m, max_squarings)
        return _BasisAdjoint.apply(plan, y0w, t0, tf, W0, *leaves)

    return solve


@dataclasses.dataclass(eq=False)
class _AdaptivePlan:
    """An adaptive adjoint: the core, the forward stepper's class (over
    an operator on the core's working basis) and ``step_rows(theta, t,
    dt) -> (n_sub, K')``, the exponentials of one recorded step in
    order."""

    spec: Any
    core: _Core
    basis: Any
    coeff_fn: Callable
    ctl: StepControl
    stepper: Callable
    step_rows: Callable


def _adaptive_forward(plan, core, theta, y0w, t0, tf, h0):
    """The adaptive driver forward (``driver.step_once`` with the plan's
    stepper, ``MagnusModulated4`` / ``MagnusModulated6`` /
    ``CFM4Modulated`` over coeff_fn(., theta)): one chain-kernel launch
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
    ctl = plan.ctl
    is_cplx = isinstance(plan.basis, Cplx)
    op = ModulatedOperator(plan.basis, lambda t: plan.coeff_fn(t, theta),
                           ext_basis=core.W)
    stepper = plan.stepper(op, adaptive=True, m=core.m,
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
    """apply(plan, W, y0w, t0, tf, h0, *theta_leaves) -> (y_final_w,
    status, ts (n_it + 1, B)) over the working basis W, the recorded times
    non-differentiable. Its vmap rule
    runs the forward per mapped sample (the adaptive driver reads its
    state on the host) and pads each sample's times to the longest with
    its final times, rows with dt = 0: the identity, with a zero
    coefficient Jacobian, as the JAX package's rows past the last
    iteration; the backward is torch operations and K6's operator."""

    @staticmethod
    def forward(plan, W, y0w, t0, tf, h0, *leaves):
        theta = pytree.tree_unflatten(list(leaves), plan.spec)
        return _adaptive_forward(plan, plan.core.on(W), theta, y0w, t0, tf,
                                 h0)

    @staticmethod
    def setup_context(ctx, inputs, output):
        plan, W, _, t0, tf, h0, *leaves = inputs
        yfw, status, ts_all = output
        ctx.mark_non_differentiable(status, ts_all)
        ctx.plan, ctx.W = plan, W
        ctx.save_for_backward(yfw, ts_all, t0, tf, h0, *leaves)

    @staticmethod
    def vmap(info, in_dims, plan, *args):
        outs = []
        for i in range(info.batch_size):
            sample = [a.select(d, i) if d is not None else a
                      for a, d in zip(args, in_dims[1:])]
            outs.append(_AdaptiveAdjoint.forward(plan, *sample))
        n = max(o[2].shape[0] for o in outs)
        ts = [torch.cat([o[2], o[2][-1:].expand(n - o[2].shape[0], -1)])
              for o in outs]
        return ((torch.stack([o[0] for o in outs]),
                 torch.stack([o[1] for o in outs]), torch.stack(ts)),
                (0, 0, 0))

    @staticmethod
    def backward(ctx, ybar, _status_bar, _ts_bar):
        yfw, ts_all, t0, tf, h0, *leaves = ctx.saved_tensors
        plan = ctx.plan
        core = plan.core.on(ctx.W)
        needs = ctx.needs_input_grad
        n_it, B = ts_all.shape[0] - 1, ts_all.shape[1]
        ybar = ybar.to(yfw.dtype)
        # the (n_it, n_sub, B, K') rows of every recorded iteration at
        # once: the same sum as one vjp per iteration, in another order;
        # rows with dt = 0 are zero
        t_r = ts_all[:-1].reshape(-1)
        dt_r = (ts_all[1:] - ts_all[:-1]).reshape(-1)

        def all_rows(theta):
            rows = torch.func.vmap(
                lambda t_, d_: plan.step_rows(theta, t_, d_))(t_r, dt_r)
            return rows.reshape(n_it, B, -1, core.Kp).transpose(1, 2)

        rows, vjp = _rows_vjp(all_rows, plan.spec, (), leaves)
        rk = rows.to(yfw.dtype).contiguous()
        cbs = []
        x, a = yfw, ybar
        # one K6 launch per exponential, the steps and their sub-rows in
        # reverse
        for r in range(n_it - 1, -1, -1):
            for j in range(rk.shape[1] - 1, -1, -1):
                x, a, cb = _bwd_row(core, rk[r, j], x, a)
                cbs.append(cb)
        cbs = torch.stack(cbs[::-1]).reshape(rk.shape) if cbs else \
            torch.zeros_like(rk)
        grads = _needed(vjp(cbs.to(rows.dtype)), needs[6:])

        # the endpoints by the continuous adjoint identity dL/dtf =
        # <a(tf), A(tf) x(tf)>, dL/dt0 = -<a(t0), A(t0) x(t0)>, per-lane
        # final times (the frozen step sequence has no endpoint dependence
        # of its own); h0 shapes the frozen sequence: its cotangent is 0
        theta0 = pytree.tree_unflatten(list(leaves), plan.spec)

        def a_times_x(t_b, xw):
            g = torch.func.vmap(lambda t: plan.coeff_fn(t, theta0))(t_b)
            dt = torch.promote_types(torch.promote_types(g.dtype, xw.dtype),
                                     core.W.dtype)
            return torch.einsum("bk,kij,bj->bi", g.to(dt),
                                core.W[:core.K0].to(device=xw.device,
                                                    dtype=dt), xw.to(dt))

        tf_bar = torch.sum(ybar * a_times_x(ts_all[-1], yfw))
        t0_bar = -torch.sum(a * a_times_x(ts_all[0], x))
        return (None, None, a if needs[2] else None,
                t0_bar.to(t0.dtype) if needs[3] else None,
                tf_bar.to(tf.dtype) if needs[4] else None,
                torch.zeros_like(h0) if needs[5] else None, *grads)


def _adaptive_scheme(basis, coeff_fn: Callable, *, order: int = 4,
                    scheme: str = "magnus", m: Optional[int] = None,
                    max_squarings: int = 16):
    """(core, stepper class, step_rows) of the adaptive adjoint:
    ``step_rows(theta, t, dt) -> (n_sub, K')`` gives the exponentials of
    one recorded step in order (the Magnus-4 row; the three Yoshida
    sub-rows of order 6; the two CFM-4 rows on the un-extended basis), the
    rows the backward replays."""
    if scheme not in ("magnus", "cfm4"):
        raise ValueError(f"scheme must be 'magnus' or 'cfm4', got {scheme}")
    if scheme == "cfm4":
        # CFM rows live on the un-extended basis (the order-2 core)
        core = _adjoint_core(basis, coeff_fn, order=2, m=m,
                             max_squarings=max_squarings)
        return core, CFM4Modulated, _cfm_multi_cols(
            coeff_fn, np.asarray(tb.CFM_R4_J2_GL, np.float64),
            tuple(float(cj) for cj in tb.C_GAUSS_LEGENDRE_4))
    if order not in (4, 6):
        raise ValueError(
            f"adaptive adjoint order must be 4 or 6, got {order}")
    core = _adjoint_core(basis, coeff_fn, order=order, m=m,
                         max_squarings=max_squarings)
    # order 6 replays the three Yoshida sub-rows of each step
    subs = (tuple(zip(_YOSHIDA_OFF, _YOSHIDA_LEN)) if order == 6
            else ((0.0, 1.0),))

    def step_rows(theta, t, dt):
        return torch.stack([core.cols(theta, t + o * dt, ln * dt)
                            for o, ln in subs])

    return core, (MagnusModulated6 if order == 6 else MagnusModulated4), \
        step_rows


def make_adaptive_adjoint_solver(basis, coeff_fn: Callable, *,
                                 ctl: StepControl, order: int = 4,
                                 scheme: str = "magnus",
                                 m: Optional[int] = None,
                                 max_squarings: int = 16):
    """The adaptive adjoint: ``solve(theta, y0w, t0, tf, h0) ->
    (y_final_w, status)`` runs the adaptive driver forward (``step_once``
    semantics, at most ``ctl.max_steps`` iterations) with
    ``MagnusModulated4`` (order 4), ``MagnusModulated6`` (order 6) or
    ``CFM4Modulated`` (``scheme="cfm4"``, the un-extended basis), recording
    only the per-iteration times, and replays the step sequence in
    reverse: per recorded iteration its exponentials in reverse, one K6
    launch each (the Magnus-4 row; the three Yoshida sub-rows; the two CFM
    rows). This is the frozen-step-sequence discrete adjoint: the step
    sizes are constants in theta. Iterations that did not advance have
    dt = 0: the identity, with a zero coefficient Jacobian, so a rejected
    trial never reaches the gradient. ``coeff_fn`` must take batched times
    (B,) -> (B, K) (the steppers sample it so). ``status`` holds the
    driver's codes per lane; a lane that ran out of ``ctl.max_steps``
    holds a mid-integration state (see :func:`adjoint_solve_adaptive`)."""
    core, stepper, step_rows = _adaptive_scheme(
        basis, coeff_fn, order=order, scheme=scheme, m=m,
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
        plan = _AdaptivePlan(spec, core, basis, coeff_fn, ctl, stepper,
                             step_rows)
        # one time type for the solve; the cotangents keep their own
        yfw, status, _ = _AdaptiveAdjoint.apply(
            plan, core.W, y0w, t0.to(tdt), tf.to(tdt), h0.to(tdt), *leaves)
        return yfw, status

    return solve


def adjoint_solve_adaptive(basis, coeff_fn: Callable, theta: Pytree, y0,
                           t0, tf, *, ctl: StepControl, order: int = 4,
                           scheme: str = "magnus", h0=None,
                           m: Optional[int] = None, max_squarings: int = 16,
                           return_status: bool = False):
    """Terminal state of the ADAPTIVE solve of dx/dt = A(t; theta) x
    (Magnus order 4 or 6, or ``scheme="cfm4"``), differentiable with respect to theta, y0, t0 and tf with
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
    ``basis_grad=True`` makes the result differentiable with respect to
    the basis matrices too (:func:`make_adjoint_basis_solver`; O(n_steps
    D^2) backward memory; not with ``save_at_steps``). ``basis`` and
    ``y0`` may be Cplx; the widening is ordinary differentiable
    concatenation outside the adjoint."""
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
        if save_at_steps is not None:
            raise ValueError("basis_grad with save_at_steps is unsupported")
        solver = make_adjoint_basis_solver(basis, coeff_fn, n_steps=n_steps,
                                           **kw)
        # the embedding is differentiable concatenation outside the
        # adjoint: gradients reach a Cplx basis pair
        return _unwiden(solver(theta, _widen(y0, is_cplx), t0, tf,
                               _real_basis(basis)), is_cplx)
    if save_at_steps is not None:
        solver = make_adjoint_saves_solver(
            basis, coeff_fn, n_steps=n_steps, save_at_steps=save_at_steps,
            **kw)
    else:
        solver = make_adjoint_solver(basis, coeff_fn, n_steps=n_steps, **kw)
    return _unwiden(solver(theta, _widen(y0, is_cplx), t0, tf), is_cplx)


# -- the reversible adjoint for black-box dense operators -------------------

@dataclasses.dataclass(eq=False)
class _DensePlan:
    """A dense-operator adjoint: the theta spec, the row map
    ``row_map(theta, t0, tf, r, x)`` = e^{Omega_r} x, ``omega(theta, t0,
    tf, r)`` and the segments [s0, s1) of rows (one without anchors)."""

    spec: Any
    row_map: Callable
    omega: Callable
    segs: list
    max_squarings: int


class _DenseAdjoint(torch.autograd.Function):
    """apply(plan, y0w, t0, tf, *theta_leaves) -> (y_final_w, the earlier
    segments' end states), the anchors non-differentiable."""

    @staticmethod
    def forward(plan, y0w, t0, tf, *leaves):
        theta = pytree.tree_unflatten(list(leaves), plan.spec)
        x, anchors = y0w, []
        for s0, s1 in plan.segs:
            for r in range(s0, s1):
                x = plan.row_map(theta, t0, tf, r, x)
            anchors.append(x)
        return (anchors[-1], *anchors[:-1])

    @staticmethod
    def setup_context(ctx, inputs, output):
        plan, _, t0, tf, *leaves = inputs
        ctx.mark_non_differentiable(*output[1:])
        ctx.plan, ctx.n_leaves = plan, len(leaves)
        ctx.save_for_backward(t0, tf, *leaves, *output[1:], output[0])

    @staticmethod
    def backward(ctx, ybar, *_anchor_bars):
        t0, tf, *rest = ctx.saved_tensors
        leaves, anchors = rest[:ctx.n_leaves], rest[ctx.n_leaves:]
        plan = ctx.plan
        needs = ctx.needs_input_grad
        theta = pytree.tree_unflatten(list(leaves), plan.spec)
        n = len(leaves)
        acc = [torch.zeros_like(v) for v in (t0, tf, *leaves)]
        a = ybar
        for (s0, s1), x in reversed(list(zip(plan.segs, anchors))):
            # each segment re-anchors the reconstruction on its stored end
            for r in range(s1 - 1, s0 - 1, -1):
                om = plan.omega(theta, t0, tf, r)
                x = _mv(expm(-om, max_squarings=plan.max_squarings), x)

                def f(t0_, tf_, x_, *lv, r=r):
                    return plan.row_map(
                        pytree.tree_unflatten(list(lv), plan.spec), t0_, tf_,
                        r, x_)

                _, vjp = torch.func.vjp(f, t0, tf, x, *leaves)
                t0_b, tf_b, a, *lb = vjp(a)
                acc = [g + b for g, b in zip(acc, (t0_b, tf_b, *lb))]
        t0_bar, tf_bar, *grads = _needed(acc, needs[2:4] + needs[4:4 + n])
        return (None, a if needs[1] else None, t0_bar, tf_bar, *grads)


def _mv(P, x):
    """P x over the trailing axis of x (..., D)."""
    return torch.einsum("ij,...j->...i", P, x)


def make_adjoint_dense_solver(op_fn: Callable, *, n_steps: int,
                              order: int = 4, max_squarings: int = 16,
                              anchor_every: Optional[int] = None):
    """``solve(theta, y0w, t0, tf) -> y_final_w`` for a BLACK-BOX operator
    ``op_fn(t, theta) -> A``, a real (D, D) tensor or a Cplx (d, d) (ring
    embedded inside the differentiated assembly), with an O(1)-memory
    reversible-adjoint backward with respect to theta, y0w, t0 and tf.

    Fixed-step Magnus exponents per row: order 2 the exponential midpoint,
    order 4 Magnus-4 over the Gauss-Legendre pair and its commutator,
    order 6 the Yoshida triple jump of the symmetric order-4 step (three
    rows a step), each row e^{Omega_r} by ``ops/expm.expm`` (its own
    squaring count). The backward recomputes Omega_r from ``op_fn``,
    reconstructs x_r = e^{-Omega_r} x_{r+1} and takes the row's vjp
    (``torch.func.vjp`` through ``expm``'s Fréchet-adjoint backward) for
    a_r and the theta, t0, tf cotangents. ``anchor_every=k`` stores the
    state every k steps and starts each backward segment from it (for
    dissipative operators). ``y0w`` may carry leading batch axes, which
    broadcast against the shared exponents. No hand kernel: the JAX
    package's counterpart runs XLA's expm, no Pallas kernel."""
    if order not in (2, 4, 6):
        raise ValueError(f"order must be 2, 4 or 6, got {order}")
    if anchor_every is not None and int(anchor_every) < 1:
        raise ValueError(f"anchor_every must be >= 1, got {anchor_every}")
    rps = rows_per_step(order)
    R = n_steps * rps
    seg = R if anchor_every is None else int(anchor_every) * rps
    segs = [(s0, min(s0 + seg, R)) for s0 in range(0, R, seg)]

    def assemble(t, theta):
        A = op_fn(t, theta)
        return embed(A) if isinstance(A, Cplx) else A

    def row_td(t0, tf, r):
        dt = (tf - t0) / n_steps
        if order == 6:
            n, j = divmod(r, rps)
            return (t0 + n * dt) + _YOSHIDA_OFF[j] * dt, _YOSHIDA_LEN[j] * dt
        return t0 + r * dt, dt

    def omega(theta, t0, tf, r):
        t_r, dt_r = row_td(t0, tf, r)
        if order == 2:
            return dt_r * assemble(t_r + 0.5 * dt_r, theta)
        t_mid = t_r + 0.5 * dt_r
        A1 = assemble(t_mid - _C_MID * dt_r, theta)
        A2 = assemble(t_mid + _C_MID * dt_r, theta)
        comm = A1 @ A2 - A2 @ A1
        return 0.5 * dt_r * (A1 + A2) + (_B2 * dt_r * dt_r) * comm

    def row_map(theta, t0, tf, r, x):
        return _mv(expm(omega(theta, t0, tf, r),
                        max_squarings=max_squarings), x)

    def solve(theta, y0w, t0, tf):
        leaves, spec = _theta_leaves(theta, y0w.device)
        t0, tf = _fixed_times(t0, tf, y0w.device)
        plan = _DensePlan(spec, row_map, omega, segs, max_squarings)
        return _DenseAdjoint.apply(plan, y0w, t0, tf, *leaves)[0]

    return solve


def adjoint_solve_dense(op_fn: Callable, theta: Pytree, y0, t0, tf,
                        n_steps: int, *, order: int = 4,
                        max_squarings: int = 16,
                        anchor_every: Optional[int] = None):
    """Terminal state of dx/dt = A(t; theta) x for a black-box operator
    ``op_fn(t, theta)`` (real or Cplx) after ``n_steps`` fixed Magnus
    steps, differentiable with respect to theta, y0, t0 and tf with O(1)
    memory in n_steps (:func:`make_adjoint_dense_solver`; for a modulated
    operator :func:`adjoint_solve` runs the hand kernels and is much
    faster). ``y0``: Cplx or real."""
    solver = make_adjoint_dense_solver(op_fn, n_steps=n_steps, order=order,
                                       max_squarings=max_squarings,
                                       anchor_every=anchor_every)
    is_cplx = isinstance(y0, Cplx)
    return _unwiden(solver(theta, _widen(y0, is_cplx), t0, tf), is_cplx)


# -- optimisation loops --------------------------------------------------

class FitResult(NamedTuple):
    """What :func:`fit_loop` returns. ``losses[i]`` is the loss at the
    PRE-update parameters of iteration i (``losses[0]`` at theta0); with
    ``tol`` the entries past ``n_done`` are NaN. ``opt_state`` is the
    optimizer (its state inside). ``aux`` stacks the loss's auxiliary
    output per iteration under ``has_aux`` (None under ``tol``)."""

    params: Any
    opt_state: Any
    losses: torch.Tensor
    n_done: int
    aux: Any = None


def make_fit_loop(loss_fn: Callable, optimizer: Callable, *, n_iters: int,
                  has_aux: bool = False, tol: Optional[float] = None,
                  verbose_every: int = 0):
    """``fit(theta0, *args) -> FitResult``: ``n_iters`` iterations of the
    loss's value and gradient (``torch.autograd.grad``) and one optimizer
    step. ``loss_fn(theta, *args) -> scalar`` (or ``(scalar, aux)`` with
    ``has_aux``), theta a tensor or a pytree of tensors; ``optimizer`` a
    factory ``params -> torch.optim.Optimizer`` over the list of theta's
    leaves (copies; theta0 is not changed), e.g. ``lambda p:
    torch.optim.Adam(p, lr=0.2)``; ``*args`` pass through. ``tol`` stops
    after the first iteration whose loss is <= tol (its update applied).
    ``verbose_every=k`` prints the iteration and loss every k iterations.
    The JAX package's ``jit`` and ``unroll`` are XLA compile options and
    have no counterpart: the loop runs eagerly, one host read of the loss
    an iteration only under ``tol`` or ``verbose_every``."""
    if n_iters < 1:
        raise ValueError(f"n_iters must be >= 1, got {n_iters}")

    def fit(theta0, *args):
        leaves0, spec = pytree.tree_flatten(theta0)
        leaves = [v.detach().clone().requires_grad_(True) for v in leaves0]
        opt = optimizer(leaves)
        losses, auxes, n_done = [], [], 0
        for i in range(n_iters):
            out = loss_fn(pytree.tree_unflatten(leaves, spec), *args)
            v, aux = out if has_aux else (out, None)
            grads = torch.autograd.grad(v, leaves, allow_unused=True)
            for p, g in zip(leaves, grads):
                p.grad = torch.zeros_like(p) if g is None else g
            opt.step()
            losses.append(v.detach())
            if has_aux and tol is None:
                auxes.append(pytree.tree_map(
                    lambda t: t.detach() if isinstance(t, torch.Tensor)
                    else torch.as_tensor(t), aux))
            n_done = i + 1
            if verbose_every > 0 and i % verbose_every == 0:
                print(f"fit_loop iter {i}  loss {float(v)}", flush=True)
            if tol is not None and float(v) <= tol:
                break
        hist = torch.stack(losses)
        if n_done < n_iters:
            hist = torch.cat([hist, hist.new_full((n_iters - n_done,),
                                                  float("nan"))])
        params = pytree.tree_unflatten([p.detach() for p in leaves], spec)
        stacked = (pytree.tree_map(lambda *xs: torch.stack(xs), *auxes)
                   if auxes else None)
        return FitResult(params, opt, hist, n_done, stacked)

    return fit


def fit_loop(loss_fn: Callable, theta0: Pytree, *args, optimizer: Callable,
             n_iters: int, has_aux: bool = False, tol: Optional[float] = None,
             verbose_every: int = 0) -> FitResult:
    """``n_iters`` optimizer iterations of ``loss_fn`` from ``theta0`` (see
    :func:`make_fit_loop`)."""
    fit = make_fit_loop(loss_fn, optimizer, n_iters=n_iters, has_aux=has_aux,
                        tol=tol, verbose_every=verbose_every)
    return fit(theta0, *args)

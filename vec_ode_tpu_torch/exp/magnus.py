"""Exponential midpoint (Magnus-2), adaptive Magnus-4 and Magnus-6 steppers
for dx/dt = A(t) x, the counterpart of ``vec_ode_tpu/exp/magnus.py``.

The user supplies an operator-assembly function ``op_fn(t) -> L`` (scalar
time in, operator pytree out); steps that need several time samples
``torch.func.vmap`` it over the quadrature nodes.

* ``midpoint_step``, ``magnus4_step``, ``magnus6_step``: one step of one
  trajectory over any ``ExponentialSplit`` (the scalar tier's steps).
* ``ExpMidpoint``, ``Magnus4``, ``Magnus6``: the steppers. Over a dense
  leaf (``DenseSplit`` / ``DenseCplxSplit``) they are natively batched
  for ``parallel.ensemble_solve``: each declares its step as a
  ``ChainTable`` and runs it through ``exp/dense_fast.run_batched_chains``
  (the fused kernel K9, which also takes a declared ``WeightedNorm``).

The adaptive error is the actual error vector e^{Omega_1} x0 - e^{Omega} x0
of the order-2 against the order-4 propagator (the batched tier returns
its per-trajectory norm).

``compensated=True`` (``comp.py``) carries the state as a double-word
pair: the advance is the increment D = (e^Omega - I) x from
``exp_m1``, folded in by TwoSum, the error a difference of increments,
the ``lo`` word riding the stepper carry. The batched tier then runs
``dense_fast.run_batched_chains(lo=...)``'s compensated executor (torch on
the tensors' device, no kernel), as the JAX package runs it on XLA.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch
from torch.utils import _pytree as pytree

from .. import comp, lc
from ..ops.dense_chains import ChainTable, Exponent
from . import dense_fast as df
from .protocol import ExponentialSplit, index_u

# Gauss-Legendre 2-node half-offset: 1/(2 sqrt(3)).
_C_MID = 0.5 / math.sqrt(3.0)
# Magnus-4 commutator weight: -sqrt(3)/12.
_B2 = -math.sqrt(3.0) / 12.0
# Yoshida triple jump: the symmetric Magnus-4 step composed over
# [g1, 1 - 2 g1, g1] dt with g1 = 1 / (2 - 2^{1/5}) has order 6.
_G1 = 1.0 / (2.0 - 2.0 ** 0.2)
_SUB_OFF = (0.0, _G1, 1.0 - _G1)
_SUB_LEN = (_G1, 1.0 - 2.0 * _G1, _G1)

def as_time(t) -> torch.Tensor:
    """A time or step as a tensor: tensors pass, python numbers become
    float64 (the time type's default)."""
    return t if isinstance(t, torch.Tensor) else torch.tensor(
        t, dtype=torch.float64)


def sample_nodes(op_fn, t_nodes):
    """op_fn at each of the stacked node times: a list of operator
    pytrees, from one vmapped call."""
    l_nodes = torch.func.vmap(op_fn)(torch.stack(t_nodes))
    return [pytree.tree_map(lambda a, j=j: a[j], l_nodes)
            for j in range(len(t_nodes))]


def midpoint_step(op_fn, split: ExponentialSplit, t, x, dt):
    """xf = exp(dt A(t + dt/2)) x."""
    t, dt = as_time(t), as_time(dt)
    u = split.exp(split.scale_l(op_fn(t + 0.5 * dt), dt))
    return split.map_exp(u, x), None


def midpoint_step_comp(op_fn, split: ExponentialSplit, t, x, dt, lo):
    """Compensated exponential midpoint: the increment D = (e^{dt A} - I) x
    from ``exp_m1``, folded into the (x, lo) pair."""
    t, dt = as_time(t), as_time(dt)
    phi = split.exp_m1(split.scale_l(op_fn(t + 0.5 * dt), dt))
    hi, lo2 = comp.update(x, lo, split.map_exp(phi, x))
    return hi, None, lo2


def _m4_omega(op_fn, split: ExponentialSplit, t, dt):
    """The Magnus-4 exponent over [t, t + dt] (two Gauss-Legendre nodes):
    (Omega, w1, w2) with Omega = w1 + w2, the order-2 part and the
    commutator term."""
    t, dt = as_time(t), as_time(dt)
    t_mid = t + 0.5 * dt
    l1, l2 = sample_nodes(op_fn, [t_mid - _C_MID * dt, t_mid + _C_MID * dt])
    w2 = split.scale_l(split.commutator(l1, l2), _B2 * dt * dt)
    w1 = split.scale_l(split.add_l(l1, l2), 0.5 * dt)
    return split.add_l(w1, w2), w1, w2


def magnus4_step(op_fn, split: ExponentialSplit, t, x, dt, *,
                 adaptive: bool = True, fast_error: bool = False):
    """4th-order Magnus with two Gauss-Legendre nodes:

    Omega = (A1 + A2) dt/2 - (sqrt(3)/12) dt^2 [A1, A2]
    xf = e^{Omega} x0;  err = e^{Omega_1} x0 - xf with Omega_1 the order-2
    part, both exponentials from one stacked ``exp_many``.
    ``adaptive=False`` skips the comparison propagator (err = None);
    ``fast_error`` estimates the gap as w2 xf (its leading term) instead:
    the same order with another constant, so the accept/reject sequence
    differs from the pair's."""
    omega, w1, w2 = _m4_omega(op_fn, split, t, dt)
    if not adaptive:
        return split.map_exp(split.exp(omega), x), None
    if fast_error:
        xf = split.map_exp(split.exp(omega), x)
        return xf, split.apply_l(w2, xf)
    u_pair = split.exp_many([omega, w1])
    xf = split.map_exp(index_u(u_pair, 0), x)
    return xf, lc.sub(split.map_exp(index_u(u_pair, 1), x), xf)


def magnus4_step_comp(op_fn, split: ExponentialSplit, t, x, dt, lo, *,
                      adaptive: bool = True, fast_error: bool = False):
    """Compensated Magnus-4: the advance D = (e^Omega - I) x folded into
    the (x, lo) pair; the estimate the difference of increments
    (e^{Omega_1} - I) x - D (``fast_error``: w2 on the advanced hi)."""
    omega, w1, w2 = _m4_omega(op_fn, split, t, dt)
    if not adaptive or fast_error:
        D = split.map_exp(split.exp_m1(omega), x)
        hi, lo2 = comp.update(x, lo, D)
        err = split.apply_l(w2, hi) if (adaptive and fast_error) else None
        return hi, err, lo2
    phis = split.exp_many_m1([omega, w1])
    D = split.map_exp(index_u(phis, 0), x)
    err = lc.sub(split.map_exp(index_u(phis, 1), x), D)
    hi, lo2 = comp.update(x, lo, D)
    return hi, err, lo2


def magnus6_step_comp(op_fn, split: ExponentialSplit, t, x, dt, lo, *,
                      adaptive: bool = True):
    """Compensated Magnus-6: the triple jump in increment form
    (``comp.chain_increment``), the order-4 comparison an increment
    difference."""
    t, dt = as_time(t), as_time(dt)
    omegas = [_m4_omega(op_fn, split, t + o * dt, g * dt)[0]
              for o, g in zip(_SUB_OFF, _SUB_LEN)]
    if adaptive:
        omegas.append(_m4_omega(op_fn, split, t, dt)[0])
    phis = split.exp_many_m1(omegas)
    D = comp.chain_increment(split.map_exp,
                             [index_u(phis, i) for i in range(3)], x)
    err = None
    if adaptive:
        err = lc.sub(split.map_exp(index_u(phis, 3), x), D)
    hi, lo2 = comp.update(x, lo, D)
    return hi, err, lo2


def magnus6_step(op_fn, split: ExponentialSplit, t, x, dt, *,
                 adaptive: bool = True):
    """6th-order step: the Yoshida triple jump of the symmetric Magnus-4
    step, xf = e^{Omega(t + (1-g1) dt, g1 dt)} e^{Omega(t + g1 dt,
    (1-2 g1) dt)} e^{Omega(t, g1 dt)} x, with err = e^{Omega(t, dt)} x - xf
    (the plain order-4 step as the embedded comparison); all exponentials
    from one stacked ``exp_many``."""
    t, dt = as_time(t), as_time(dt)
    omegas = [_m4_omega(op_fn, split, t + o * dt, g * dt)[0]
              for o, g in zip(_SUB_OFF, _SUB_LEN)]
    if adaptive:
        omegas.append(_m4_omega(op_fn, split, t, dt)[0])
    us = split.exp_many(omegas)
    xf = x
    for i in range(3):
        xf = split.map_exp(index_u(us, i), xf)
    if not adaptive:
        return xf, None
    return xf, lc.sub(split.map_exp(index_u(us, 3), x), xf)


def _m4_exponent(a: int, b: int, n_nodes: int, length: float = 1.0):
    """The Magnus-4 exponent over a sub-interval of ``length`` dt whose two
    Gauss-Legendre samples are nodes a and b."""
    lin = [0.0] * n_nodes
    lin[a] = lin[b] = 0.5 * length
    return Exponent(lin, ((a, b, _B2 * length * length),))


def midpoint_table() -> ChainTable:
    return ChainTable(1, [[Exponent((1.0,))]])


def magnus4_table(pair: bool) -> ChainTable:
    """Chain 0 the order-4 exponent; with ``pair`` chain 1 its order-2
    part."""
    main = [_m4_exponent(0, 1, 2)]
    return ChainTable(2, [main, [Exponent((0.5, 0.5))]] if pair else [main])


def magnus6_table(adaptive: bool) -> ChainTable:
    """Chain 0 the three sub-interval Magnus-4 exponents over nodes
    (0, 1), (2, 3), (4, 5); with ``adaptive`` chain 1 the full-interval
    Magnus-4 exponent over nodes (6, 7)."""
    n = 8 if adaptive else 6
    main = [_m4_exponent(2 * i, 2 * i + 1, n, _SUB_LEN[i]) for i in range(3)]
    return ChainTable(n, [main, [_m4_exponent(6, 7, n)]] if adaptive
                      else [main])


def gl2_times(t, dt, offset: float = 0.0, length: float = 1.0) -> list:
    """The two Gauss-Legendre node times of the sub-interval
    [t + offset dt, t + (offset + length) dt]."""
    tm = t + (offset + 0.5 * length) * dt
    return [tm - _C_MID * length * dt, tm + _C_MID * length * dt]


class _DenseBatchedStepper:
    """The batched-execution surface the generic exponential steppers
    share. Over a dense leaf (``supports_batched_dense``) the stepper is
    natively batched (``is_batched``): the ensemble driver hands it
    batched (t, x, dt), the step's chains run on the fused kernel, and
    the step returns the per-trajectory error NORM
    (``error_norm`` = identity). ``batched=False`` asks for the vmapped
    scalar path. ``compensated=True``: the residual word ``lo`` rides the
    stepper carry (``step_fn(t, x, dt, lo) -> (x_next, err, lo)``)."""

    error_norm = staticmethod(lambda e: e)
    # ensemble_solve params support: op_fn(t, p) vmapped over (t, params)
    supports_batched_params = True

    def _check_fields(self):
        norm = getattr(self, "norm", None)
        if norm is not None and not isinstance(
                norm, (lc.WeightedNorm, lc.TracedNorm)):
            raise TypeError(
                "norm=: a declared lc.WeightedNorm or an lc.TracedNorm; "
                "opaque callables go through error_norm=")

    @property
    def has_carry(self) -> bool:
        return bool(getattr(self, "compensated", False))

    def make_init_carry(self, fn=None, params=None):
        """The compensated tier's carry at (t0, x0): the zero ``lo``."""
        return lambda t, x: comp.zero_lo(x)

    def _wrap_comp(self, step_core):
        """The step function of the stepper's tier: with ``compensated``
        it takes and returns the ``lo`` carry."""
        if getattr(self, "compensated", False):
            return lambda t, x, dt, lo: step_core(t, x, dt, lo)
        return lambda t, x, dt: step_core(t, x, dt)

    def _wnorm_parts(self, x):
        """kernel_parts of the declared ``norm`` (lc.WeightedNorm) over
        this split's widened layout, the widened executor of an
        ``lc.TracedNorm`` (a callable, which only the twin runs), or
        None."""
        wn = getattr(self, "norm", None)
        if wn is None:
            return None
        if isinstance(wn, lc.TracedNorm):
            split = self.split

            def traced_exec(dv):
                err = df.unwiden(split, dv)
                return wn(err) if dv.ndim == 1 else wn.batched(err)

            return traced_exec
        parts = df.split_parts(self.split, x)
        kp = wn.kernel_parts(parts[0].shape[-1], len(parts))
        if kp is None:
            raise ValueError(
                "WeightedNorm.weights must be a single per-(complex-)"
                f"component array of length {parts[0].shape[-1]} for the "
                "batched dense tier")
        return kp

    def _assembler(self, fn, params):
        """Batched node assembly: the scalar-contract callback vmapped
        over per-trajectory times (and params, when given). The steppers
        stack ALL quadrature nodes into one call (times of length
        n_nodes B), so per-trajectory params tile to match."""
        if params is None:
            return lambda tv: torch.func.vmap(fn)(tv)
        pb = pytree.tree_leaves(params)[0].shape[0]

        def assemble(tv):
            rep = tv.shape[0] // pb
            p = params if rep == 1 else pytree.tree_map(
                lambda a: torch.cat([a] * rep), params)
            return torch.func.vmap(fn)(tv, p)

        return assemble

    def _node_ops(self, assemble, t_nodes):
        """The embedded samples (n_nodes, B, D, D) at the node times (each
        (B,)), from one stacked assemble."""
        E = df.embed_node(self.split, assemble(torch.cat(t_nodes)))
        return E.reshape(len(t_nodes), -1, *E.shape[1:])

    def _dense(self) -> bool:
        return bool(getattr(self.split, "supports_batched_dense", False))

    @property
    def is_batched(self) -> bool:
        if self.batched is not None:
            if self.batched and not self._dense():
                raise ValueError(
                    "batched=True requires a dense split (DenseSplit / "
                    f"DenseCplxSplit); {type(self.split).__name__} cannot "
                    "batch per-trajectory operators")
            return self.batched
        return self._dense()

    # ensemble_solve tells an AUTO-batched stepper apart from an explicit
    # batched=True where the batched conventions conflict with the call
    @property
    def auto_batched(self) -> bool:
        return self.batched is None

    def _batched_mode(self, t) -> bool:
        return (isinstance(t, torch.Tensor) and t.ndim >= 1
                and self.is_batched and self._dense())

    def step_path(self, y0) -> str:
        """The per-step path's tag for ``Solution.path``: the host driver
        with one K9 launch per iteration on the card, the kernel's twin on
        CPU tensors; on the card a traced norm runs the twin
        (``+twin-step``) and the compensated tier its torch executor
        (``+comp-step``), as the JAX package runs it on XLA."""
        if not pytree.tree_leaves(y0)[0].is_cuda:
            return "torch-driver"
        if getattr(self, "compensated", False):
            return "torch-driver+comp-step"
        if isinstance(getattr(self, "norm", None), lc.TracedNorm):
            return "torch-driver+twin-step"
        return "torch-driver+cuda-step"

    def _scalar_guard(self, params):
        if params is not None:
            raise ValueError("params requires the batched driver")
        if getattr(self, "norm", None) is not None:
            raise ValueError(
                "norm= runs on the batched dense tier; the scalar path "
                "takes the norm via error_norm=")


@dataclasses.dataclass(frozen=True)
class ExpMidpoint(_DenseBatchedStepper):
    """Fixed-step exponential midpoint. Order 2, no error estimate."""

    split: ExponentialSplit
    op_fn: Callable = None  # or the argument of make_step_fn
    batched: Optional[bool] = None   # None = auto (see _DenseBatchedStepper)
    max_squarings: int = 16
    compensated: bool = False        # double-word state pair (comp.py)

    nfev_per_step = 1

    def __post_init__(self):
        self._check_fields()

    def make_step_fn(self, op_fn=None, params=None):
        fn = op_fn if op_fn is not None else self.op_fn
        assemble = self._assembler(fn, params)
        table = midpoint_table()

        def step_core(t, x, dt, lo=None):
            if self._batched_mode(t):
                return df.run_batched_chains(
                    self.split, x, dt,
                    self._node_ops(assemble, [t + 0.5 * dt]), table,
                    adaptive=False, max_squarings=self.max_squarings, lo=lo)
            self._scalar_guard(params)
            if lo is not None:
                return midpoint_step_comp(fn, self.split, t, x, dt, lo)
            return midpoint_step(fn, self.split, t, x, dt)

        return self._wrap_comp(step_core)


@dataclasses.dataclass(frozen=True)
class Magnus4(_DenseBatchedStepper):
    """Adaptive Magnus-4. ``adaptive=False`` skips the order-2 comparison
    propagator (one exponential per step). ``fast_error`` estimates the
    error as w2 xf (the commutator term on the advanced state) instead of
    propagating the comparison exponential: one exponential per adaptive
    step, the same order with another constant. ``norm``: a declared
    ``lc.WeightedNorm`` (batched tier only)."""

    split: ExponentialSplit
    op_fn: Callable = None
    adaptive: bool = True
    batched: Optional[bool] = None   # None = auto (see _DenseBatchedStepper)
    max_squarings: int = 16
    norm: Optional[object] = None
    fast_error: bool = False
    compensated: bool = False        # double-word state pair (comp.py)

    nfev_per_step = 2

    def __post_init__(self):
        self._check_fields()

    def make_step_fn(self, op_fn=None, params=None):
        fn = op_fn if op_fn is not None else self.op_fn
        assemble = self._assembler(fn, params)
        fast = self.adaptive and self.fast_error
        table = magnus4_table(pair=self.adaptive and not fast)

        def batched_step(t, x, dt, lo):
            node_ops = self._node_ops(assemble, gl2_times(t, dt))
            wnorm = self._wnorm_parts(x)
            out = df.run_batched_chains(
                self.split, x, dt, node_ops, table,
                adaptive=self.adaptive and not fast,
                max_squarings=self.max_squarings,
                wnorm=None if fast else wnorm, lo=lo)
            if not fast:
                return out
            y = out[0]
            yw = df.widen(df.split_parts(self.split, y))
            E1, E2 = node_ops.to(yw.dtype)
            dt3 = dt.to(yw.dtype)[:, None, None]
            w2 = ((_B2 * dt3) * dt3) * (E1 @ E2 - E2 @ E1)
            dv = (w2 @ yw[..., None])[..., 0]
            return (y, lc.apply_weighted_norm(dv, wnorm)) + tuple(out[2:])

        def step_core(t, x, dt, lo=None):
            if self._batched_mode(t):
                return batched_step(t, x, dt, lo)
            self._scalar_guard(params)
            if lo is not None:
                return magnus4_step_comp(fn, self.split, t, x, dt, lo,
                                         adaptive=self.adaptive,
                                         fast_error=self.fast_error)
            return magnus4_step(fn, self.split, t, x, dt,
                                adaptive=self.adaptive,
                                fast_error=self.fast_error)

        return self._wrap_comp(step_core)


@dataclasses.dataclass(frozen=True)
class Magnus6(_DenseBatchedStepper):
    """Adaptive Magnus-6: the Yoshida triple-jump composition of the
    symmetric Magnus-4 step, embedded against the plain Magnus-4 step over
    the full interval (err = x4 - x6). Order 6 at 3 exponentials per step
    (4 adaptive)."""

    split: ExponentialSplit
    op_fn: Callable = None
    adaptive: bool = True
    batched: Optional[bool] = None   # None = auto (see _DenseBatchedStepper)
    max_squarings: int = 16
    norm: Optional[object] = None    # declared WeightedNorm (batched tier)
    compensated: bool = False        # double-word state pair (comp.py)

    def __post_init__(self):
        self._check_fields()

    @property
    def nfev_per_step(self) -> int:
        # 3 sub-interval GL2 pairs + the full-interval pair when adaptive
        return 8 if self.adaptive else 6

    def make_step_fn(self, op_fn=None, params=None):
        fn = op_fn if op_fn is not None else self.op_fn
        assemble = self._assembler(fn, params)
        table = magnus6_table(self.adaptive)
        spans = list(zip(_SUB_OFF, _SUB_LEN))
        if self.adaptive:
            spans.append((0.0, 1.0))

        def step_core(t, x, dt, lo=None):
            if self._batched_mode(t):
                ts = [tn for o, ln in spans for tn in gl2_times(t, dt, o, ln)]
                return df.run_batched_chains(
                    self.split, x, dt, self._node_ops(assemble, ts), table,
                    adaptive=self.adaptive,
                    max_squarings=self.max_squarings,
                    wnorm=self._wnorm_parts(x), lo=lo)
            self._scalar_guard(params)
            if lo is not None:
                return magnus6_step_comp(fn, self.split, t, x, dt, lo,
                                         adaptive=self.adaptive)
            return magnus6_step(fn, self.split, t, x, dt,
                                adaptive=self.adaptive)

        return self._wrap_comp(step_core)

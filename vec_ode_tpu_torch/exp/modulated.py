"""Modulated-operator exponential integrators: A(t) = sum_k c_k(t) M_k, the
counterpart of ``vec_ode_tpu/exp/modulated.py``.

The operator is K shared basis matrices M_k (real-pair complex or real)
and a coefficient function c(t) -> (K,). Every exponent a Magnus step
needs is a linear combination of the basis, for Magnus-4 extended by the
commutators [M_j, M_k] made once at stepper construction, so the
propagator is never formed: e^Omega x is a scaled Taylor action whose
every term is one shared (B, D) @ (D, K'D) product
(``ops/expmv.py``).

* :class:`ModulatedOperator`: the basis, the coefficient function
  ``coeff_fn`` and optionally its declared form (``CoeffForm``, or the
  ``ChebForm`` that ``exp.auto_modulated`` fits), which the whole-loop
  kernel samples in-kernel.
* :class:`MidpointModulated` (exponential midpoint, fixed steps),
  :class:`MagnusModulated4` (Magnus-4 with its order-2 comparison chain,
  or ``fast_error``), :class:`MagnusModulated6` (the Yoshida triple jump
  of Magnus-4, three exponentials per step, with the full-interval
  Magnus-4 row as its comparison) and :class:`CFMModulated` /
  :func:`CFM4Modulated` (commutator-free Magnus over a declared
  ``CfmTable``): natively batched steppers for
  ``parallel.ensemble_solve``. Their per-step path runs the chain kernel
  K4 (``ops/expmv.fused_chain_apply``) on CUDA tensors and its twin on CPU
  tensors; ``fused_loop_solve`` runs the whole loop in the loop kernel
  (``ops/fused_loop.py``, the chain step K5) where the operator declares
  its form, and the loop's plain twin on CPU tensors.

Scaling: one squaring count per trajectory and chain row (see
``ops/expmv.scale_rows``); the JAX package's XLA tier takes one per
batch, its Pallas kernels one per tile. The results differ by rounding.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional, Union

import torch

from .. import lc
from .. import tableaus as tb
from ..config import _decline
from ..ops.cplx import Cplx, cmatmul, embed
from ..ops.expmv import (CfmTable, ChebForm, CoeffForm, basis_norms,
                         fused_chain_apply, has_error_estimate,
                         n_working_terms, node_times, pairs_of, scale_rows,
                         stacked_transpose, torch_chain_expmv,
                         torch_chain_step)

__all__ = ["ModulatedOperator", "CoeffForm", "ChebForm", "CfmTable",
           "MidpointModulated", "MagnusModulated4", "MagnusModulated6",
           "CFMModulated", "CFM4Modulated", "modulated_exp_apply"]

# Taylor-action (degree, theta) per dtype (exp/modulated.py:53): the
# smallest degree whose remainder |e^t - T_m(t)| at |t| <= theta sits well
# under the dtype's eps (f32: m=8 gives 2.3e-10 at 0.35; f64: m=12 gives
# 2.4e-18 at 0.25)
_TAYLOR_CFG = {32: (8, 0.35), 64: (12, 0.25)}


def _taylor_params(dtype, m=None, theta=None):
    """Resolve (m, theta) for a dtype; an explicit m gets a theta making
    the truncation error ~eps for that degree."""
    bits = torch.finfo(dtype).bits
    m_def, theta_def = _TAYLOR_CFG[bits]
    if m is None:
        m = m_def
    if theta is None:
        if m == m_def:
            theta = theta_def
        else:
            eps = 2.0 ** (-(23 if bits == 32 else 52))
            lo, hi = 1e-6, 10.0
            for _ in range(60):
                mid = 0.5 * (lo + hi)
                r = sum(mid ** k / math.factorial(k)
                        for k in range(m + 1, m + 30))
                lo, hi = (mid, hi) if r < 0.25 * eps else (lo, mid)
            theta = lo
    return m, theta


def _real_basis(basis) -> torch.Tensor:
    """(K, D, D) real working basis: ring-embed a Cplx basis, pass a real
    one through."""
    return embed(basis) if isinstance(basis, Cplx) else basis


def _widen(x, is_cplx: bool) -> torch.Tensor:
    return torch.cat([x.re, x.im], dim=-1) if is_cplx else x


def _unwiden(xw, is_cplx: bool):
    if is_cplx:
        d = xw.shape[-1] // 2
        return Cplx(xw[..., :d], xw[..., d:])
    return xw


@dataclasses.dataclass(frozen=True)
class ModulatedOperator:
    """A(t) = sum_k coeff_fn(t)[k] * basis[k].

    ``basis``: a Cplx of (K, d, d) (real-pair complex) or a real (K, D, D)
    tensor. ``coeff_fn``: t (...,) -> (..., K) REAL coefficients (complex
    structure belongs in the basis, e.g. M = -i H). ``form``: the declared
    :class:`~vec_ode_tpu_torch.ops.expmv.CoeffForm` or
    :class:`~vec_ode_tpu_torch.ops.expmv.ChebForm` of ``coeff_fn``, which
    the whole-loop kernel samples in-kernel (the JAX package's
    ``coeff_cols_fn``); None leaves the per-step path. ``ext_basis``: the
    commutator-extended working basis (K + K(K-1)/2, D, D) when it was
    made elsewhere (``convert.modulated_from_numpy``), else None.
    """

    basis: Any
    coeff_fn: Callable
    form: Optional[Union[CoeffForm, ChebForm]] = None
    ext_basis: Optional[torch.Tensor] = None

    @property
    def is_cplx(self) -> bool:
        return isinstance(self.basis, Cplx)

    @property
    def n_terms(self) -> int:
        return (self.basis.re if self.is_cplx else self.basis).shape[0]

    def assemble(self, t):
        """Dense A(t), the generic-path and test view of this operator."""
        c = self.coeff_fn(torch.as_tensor(t))
        if self.is_cplx:
            return Cplx(torch.einsum("...k,kij->...ij", c, self.basis.re),
                        torch.einsum("...k,kij->...ij", c, self.basis.im))
        return torch.einsum("...k,kij->...ij", c, self.basis)

    def commutator_extension(self):
        """(extended_basis, pairs): the basis followed by the K(K-1)/2
        commutators C_jk = [M_j, M_k], j < k, made once at stepper
        construction."""
        pairs = pairs_of(self.n_terms)
        if self.is_cplx:
            def take(i):
                return Cplx(self.basis.re[i], self.basis.im[i])

            comms = [Cplx(c1.re - c2.re, c1.im - c2.im) for c1, c2 in
                     ((cmatmul(take(j), take(k)), cmatmul(take(k), take(j)))
                      for j, k in pairs)]
            ext = Cplx(torch.cat([self.basis.re, *(c.re[None]
                                                   for c in comms)]),
                       torch.cat([self.basis.im, *(c.im[None]
                                                   for c in comms)]))
        else:
            comms = [self.basis[j] @ self.basis[k]
                     - self.basis[k] @ self.basis[j] for j, k in pairs]
            ext = torch.cat([self.basis, *(c[None] for c in comms)])
        return ext, pairs


def modulated_exp_apply(basis_w, coeffs, xw, *, m: Optional[int] = None,
                        max_squarings: int = 16,
                        theta: Optional[float] = None):
    """y = exp(sum_k coeffs[b, k] basis_w[k]) xw[b] without forming the
    exponent or its propagator: basis_w (K, D, D) real, coeffs (B, K), xw
    (B, D). Scaling per trajectory (``ops/expmv.scale_rows``), then the
    Taylor action."""
    dtype = xw.dtype
    m, theta = _taylor_params(dtype, m, theta)
    basis_w = basis_w.to(dtype)
    cs, n_pass = scale_rows(coeffs.to(dtype)[:, None, None],
                            basis_norms(basis_w), theta, max_squarings)
    return torch_chain_expmv(cs, n_pass, xw, stacked_transpose(basis_w),
                             m=m)[0]


def operator_slope(op: ModulatedOperator, t, x):
    """The slope A(t) x = sum_k c_k(t) M_k x of ``op`` for a batch: ``t``
    (B,), ``x`` a Cplx pair or real tensor with a leading batch axis (the
    dense-output Hermite endpoints)."""
    xw = _widen(x, op.is_cplx)
    basis_w = _real_basis(op.basis).to(device=xw.device, dtype=xw.dtype)
    c = op.coeff_fn(t).to(xw.dtype)
    return _unwiden(torch.einsum("bk,kij,bj->bi", c, basis_w, xw),
                    op.is_cplx)


def _stepper_wnorm(stepper, d_part: int, n_parts: int):
    """(w_row, post, kind) of the stepper's declared ``norm``
    (lc.WeightedNorm) over the kernels' widened-real layout, the widened
    executor of an ``lc.TracedNorm`` (which only the twin runs), or None.
    Raises for weights the batched layout cannot express."""
    wn = getattr(stepper, "norm", None)
    if wn is None:
        return None
    if isinstance(wn, lc.TracedNorm):
        if n_parts == 1:
            return wn.batched
        return lambda dv: wn.batched(Cplx(dv[..., :d_part], dv[..., d_part:]))
    kp = wn.kernel_parts(d_part, n_parts)
    if kp is None:
        raise ValueError(
            "WeightedNorm.weights must be a single per-(complex-)component "
            f"array of length {d_part} for the batched tiers")
    return kp


def _check_norm(norm):
    if norm is not None and not isinstance(norm,
                                           (lc.WeightedNorm, lc.TracedNorm)):
        raise TypeError(
            "norm=: a declared lc.WeightedNorm or an lc.TracedNorm; "
            "ensemble_solve promotes an opaque error_norm= callable to the "
            "latter (lc.try_trace_norm)")


def _traced(stepper) -> bool:
    return isinstance(getattr(stepper, "norm", None), lc.TracedNorm)


def _modulated_step_path(self, y0) -> str:
    """Execution-path tag of the per-step path for ``Solution.path``: K4
    on the card, its twin there under a traced norm (no kernel runs a
    Python callable), the twin on the CPU."""
    leaf = y0.re if isinstance(y0, Cplx) else y0
    if not leaf.is_cuda:
        return "torch-driver"
    return "torch-driver+twin-step" if _traced(self) else \
        "torch-driver+cuda-step"


class _ChainStepper:
    """What the modulated steppers share: the working basis and its kernel
    operands per (device, dtype), the per-step function over
    ``fused_chain_apply`` and the whole-loop solve over ``ChainStep``.
    Subclasses set ``_recipe`` / ``_chains`` / ``_adaptive`` and
    ``_basis_w``, and the ``"cfm"`` recipe its ``_table``."""

    is_batched = True
    _table = None
    # err comes back as a per-trajectory NORM (computed in the step), not an
    # error vector: the driver applies error_norm = identity
    error_norm = staticmethod(lambda e: e)
    step_path = _modulated_step_path

    def _operands(self, device, dtype):
        """(stacked basis (D, K'D) in the state's type and device, its K'
        1-norms as floats), made once per (device, dtype)."""
        key = (device, dtype)
        cache = self._cache
        if key not in cache:
            bw = self._basis_w.to(device=device, dtype=dtype)
            cache[key] = (stacked_transpose(bw), basis_norms(bw))
        return cache[key]

    def _wnorm_of(self, x):
        leaf = x.re if self.op.is_cplx else x
        return _stepper_wnorm(self, leaf.shape[-1], 2 if self.op.is_cplx
                              else 1)

    def make_step_fn(self, rhs=None):
        if rhs is not None:
            raise ValueError(
                f"{type(self).__name__} embeds its own operator; pass "
                "rhs=None")
        recipe, C, table = self._recipe, self._chains, self._table
        coeff_fn, is_cplx = self.op.coeff_fn, self.op.is_cplx
        has_err = has_error_estimate(recipe, C)

        def step_fn(t, x, dt):
            xw = _widen(x, is_cplx)
            single = xw.ndim == 1
            if single:
                # one trajectory on the scalar carry: a batch of one
                xw, t, dt = xw[None], t.reshape(1), dt.reshape(1)
            elif dt.ndim == 0:
                # a (B, d) state on the scalar carry: one t and dt for all
                t, dt = t.expand(xw.shape[0]), dt.expand(xw.shape[0])
            mt, norms = self._operands(xw.device, xw.dtype)
            m, theta = _taylor_params(xw.dtype, self.m)
            samples = [coeff_fn(tn).to(xw.dtype).contiguous()
                       for tn in node_times(recipe, t, dt, C, table)]
            # a traced norm runs the twin on the tensors' device
            run = torch_chain_step if _traced(self) else fused_chain_apply
            y, err = run(
                samples, dt.to(xw.dtype).contiguous(), xw, mt, norms,
                recipe=recipe, C=C, m=m, theta=theta,
                max_squarings=self.max_squarings,
                wnorm=self._wnorm_of(x) if has_err else None, table=table)
            if single:
                y, err = y[0], err[0]
            # no error estimate -> None makes the adaptive driver raise
            # instead of accepting on a zero estimate
            return _unwiden(y, is_cplx), (err if has_err else None)

        return step_fn

    def fused_loop_solve(self, y0, t_grid, h0, *, ctl, adaptive: bool,
                         chunk: int = 8, persistent=None, events=None,
                         dense: bool = False):
        """The whole loop (stepper, controller or fixed steps, counters,
        save grid) in one launch of the loop kernel with the chain step
        K5 (``persistent=False``: launches of ``chunk`` iterations), the
        port of ``_fused_loop_run`` without lane packing, windows or caps.
        CUDA tensors take the kernel (path ``cuda-loop-persistent`` /
        ``cuda-loop-chunked``), CPU tensors its plain twin
        (``torch-loop``). ``events`` (an ``events.EventConfig`` of
        declared observables) run in the loop; ``dense=True`` runs it on
        the bare [t0, tf] with the interior grid times as dense-output
        times, then one batched Hermite pass with the operator's slope
        A(t) x (``_fused_dense_interp``; path suffix ``-dense``).

        Returns None where the JAX package declines for a reason that is
        not TPU layout, so that the caller runs the per-step path: an
        adaptivity other than the stepper's, an operator without a
        declared form, a state that is not (B, d), a time dtype other
        than the state's, or an event that is not a declared observable
        (the kernel runs no Python callable)."""
        from ..ops.fused_loop import (ChainStep, fused_loop_integrate,
                                      loop_solution)

        if adaptive != self._adaptive:
            return _decline("adaptive= differs from the stepper's")
        if self.op.form is None:
            return _decline("the operator declares no CoeffForm / "
                            "ChebForm coefficient form")
        if _traced(self):
            return _decline("a traced error norm: the loop kernel takes "
                            "a declared WeightedNorm")
        is_cplx = self.op.is_cplx
        leaf = y0.re if is_cplx else y0
        if leaf.ndim != 2:
            return _decline("the state is not (B, d)")
        if t_grid.dtype != leaf.dtype:
            return _decline(f"time dtype {t_grid.dtype} is not the state's "
                            f"{leaf.dtype}")
        ev_spec = None
        if events is not None:
            ev_spec = events.kernel_spec(leaf.shape[-1], 2 if is_cplx else 1)
            if ev_spec is None:
                return _decline("events= has an opaque callable; the loop "
                                "kernel takes declared observables")
        dense = dense and t_grid.shape[0] > 2
        wnorm = None
        if getattr(self, "norm", None) is not None:
            if ctl.scaled_error:
                raise ValueError(
                    "scaled_error and a declared WeightedNorm are "
                    "mutually exclusive (both redefine the controller's "
                    "error measure)")
            wnorm = self._wnorm_of(y0)
        dtype, dev = leaf.dtype, leaf.device
        mt, norms = self._operands(dev, dtype)
        m, theta = _taylor_params(dtype, self.m)
        step = ChainStep(
            mt=mt, norms=norms, form=self.op.form, recipe=self._recipe,
            C=self._chains, m=m, theta=theta,
            max_squarings=self.max_squarings,
            scaled=(ctl.atol, ctl.rtol) if ctl.scaled_error else None,
            wnorm=wnorm, table=self._table)
        persistent = persistent is None or persistent
        x0 = _widen(y0, is_cplx)
        out = fused_loop_integrate(
            t_grid[[0, -1]] if dense else t_grid, x0, h0, step, ctl=ctl,
            chunk=chunk, persistent=persistent, adaptive=adaptive,
            events=ev_spec, dense_times=t_grid[1:-1] if dense else None)
        if not leaf.is_cuda:
            path = "torch-loop"
        else:
            path = ("cuda-loop-persistent" if persistent
                    else "cuda-loop-chunked")

        def slope(t, xw):
            return _widen(operator_slope(self.op, t, _unwiden(xw, is_cplx)),
                          is_cplx)

        return loop_solution(t_grid, x0, out, path=path, slope=slope,
                             unwiden=lambda xw: _unwiden(xw, is_cplx))


def _extended_basis(op: ModulatedOperator) -> torch.Tensor:
    """The commutator-extended real working basis of the Magnus recipes
    (made once per stepper, or taken from ``op.ext_basis``)."""
    if op.ext_basis is not None:
        ext_w = op.ext_basis
    else:
        ext_w = _real_basis(op.commutator_extension()[0])
    if ext_w.shape[0] != n_working_terms("magnus4", op.n_terms):
        raise ValueError(
            f"the extended basis has {ext_w.shape[0]} terms, Magnus-4 "
            f"on {op.n_terms} basis terms needs "
            f"{n_working_terms('magnus4', op.n_terms)}")
    return ext_w


def _set(stepper, **values) -> None:
    """Set the derived fields of a frozen stepper."""
    for name, value in values.items():
        object.__setattr__(stepper, name, value)


@dataclasses.dataclass(frozen=True)
class MidpointModulated(_ChainStepper):
    """Exponential midpoint (Magnus-2) on a modulated operator: the
    propagator action e^{dt A(t + dt/2)} x by the shared-basis Taylor
    action; fixed steps only (no error estimate)."""

    op: ModulatedOperator
    m: Optional[int] = None          # Taylor degree; None = dtype default
    max_squarings: int = 16

    nfev_per_step = 1
    _recipe = "midpoint"
    _chains = 1
    _adaptive = False

    def __post_init__(self):
        _set(self, _basis_w=_real_basis(self.op.basis), _cache={})


@dataclasses.dataclass(frozen=True)
class MagnusModulated4(_ChainStepper):
    """Magnus-4 on a modulated operator: the per-step commutator
    [A(t1), A(t2)] collapses onto the precomputed commutator basis, and the
    order-4 and order-2 propagator actions run as two chains of one
    shared-basis Taylor action (``adaptive``); ``fast_error`` estimates the
    error as (sum_k w2_k C_k) y on the advanced state instead of the
    second chain. ``norm``: a declared ``lc.WeightedNorm``."""

    op: ModulatedOperator
    adaptive: bool = True
    m: Optional[int] = None          # Taylor degree; None = dtype default
    max_squarings: int = 16
    norm: Optional[Any] = None
    fast_error: bool = False

    nfev_per_step = 2

    def __post_init__(self):
        _check_norm(self.norm)
        fast = self.adaptive and self.fast_error
        _set(self, _basis_w=_extended_basis(self.op), _cache={},
             _recipe="magnus4_fast" if fast else "magnus4",
             _chains=2 if self.adaptive and not fast else 1,
             _adaptive=self.adaptive)


@dataclasses.dataclass(frozen=True)
class MagnusModulated6(_ChainStepper):
    """Magnus-6 on a modulated operator: the Yoshida triple jump of the
    symmetric Magnus-4 step over [g1, 1 - 2 g1, g1] dt, three
    exponentials per step over the commutator-extended basis (one chain
    of three rows). ``adaptive``: the comparison chain is the full
    interval's Magnus-4 row followed by two declared identity rows, which
    the kernels skip (an order 6(4) pair; 8 samples a step, 6 without).
    At f32 its estimate has a noise floor near 1e-7: an rtol below it
    rejects every step and ends in ``ERR_MAX_STEPS`` with a finite state.
    ``norm``: a declared ``lc.WeightedNorm``."""

    op: ModulatedOperator
    adaptive: bool = True
    m: Optional[int] = None          # Taylor degree; None = dtype default
    max_squarings: int = 16
    norm: Optional[Any] = None

    @property
    def nfev_per_step(self) -> int:
        return 8 if self.adaptive else 6

    def __post_init__(self):
        _check_norm(self.norm)
        _set(self, _basis_w=_extended_basis(self.op), _cache={},
             _recipe="magnus6", _chains=2 if self.adaptive else 1,
             _adaptive=self.adaptive)


@dataclasses.dataclass(frozen=True)
class CFMModulated(_ChainStepper):
    """Commutator-free Magnus on a modulated operator: each exponential is
    a basis combination dt sum_j alpha[i, j] c(t + c_j dt) over the
    un-extended basis, applied in row order (x_i = e^{rho_i} x_{i-1});
    ``alpha_err`` (at most as many rows) gives the embedded comparison
    chain, padded with zero rows, and makes the stepper adaptive. The
    scheme is declared as an ``ops.expmv.CfmTable``, which the kernels and
    the twin read. ``norm``: a declared ``lc.WeightedNorm``."""

    op: ModulatedOperator
    alpha: tuple
    c: tuple
    alpha_err: Optional[tuple] = None
    m: Optional[int] = None          # Taylor degree; None = dtype default
    max_squarings: int = 16
    norm: Optional[Any] = None

    @property
    def nfev_per_step(self) -> int:
        return len(self.c)

    def __post_init__(self):
        _check_norm(self.norm)
        table = CfmTable(self.alpha, self.c, self.alpha_err)
        adaptive = table.alpha_err is not None
        _set(self, alpha=table.alpha, c=table.c, alpha_err=table.alpha_err,
             _basis_w=_real_basis(self.op.basis), _cache={}, _recipe="cfm",
             _chains=2 if adaptive else 1, _adaptive=adaptive, _table=table)


def CFM4Modulated(op: ModulatedOperator, *, adaptive: bool = True,
                  m: Optional[int] = None, max_squarings: int = 16,
                  norm: Optional[Any] = None) -> CFMModulated:
    """The reference's ExpCFMSolver configuration on the modulated path:
    the order-4 scheme CFM_R4_J2_GL on the 2-node Gauss-Legendre nodes,
    with the order-2 CFM_R2_J1_GL as its comparison chain when
    ``adaptive``."""
    return CFMModulated(
        op=op, alpha=tb.CFM_R4_J2_GL, c=tb.C_GAUSS_LEGENDRE_4,
        alpha_err=tb.CFM_R2_J1_GL if adaptive else None, m=m,
        max_squarings=max_squarings, norm=norm)

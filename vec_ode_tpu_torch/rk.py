"""Explicit Runge-Kutta steppers over pytree states, the counterpart of
``vec_ode_tpu/rk.py``.

The stage loop is unrolled in Python, the stage combinations are
``lc.lincomb`` expressions and the RHS ``f(t, y)`` is any torch callable
over the state's pytree, so for batched linear systems the stage
evaluations are matrix products. The same semantics as the JAX package:

* with an embedded pair the step advances the b_err (lower-order)
  solution (``advance_lower=True``), and the error estimate is err = dt
  sum (b_i - b_err_i) K_i, computed directly from the weight difference;
* ``RungeKutta(embedded=False)`` advances the b solution with no estimate;
* zero tableau entries are skipped, as the JAX package skips them, so the
  stage sums round alike.

FSAL tableaus (DOPRI5, BOSH32) advancing the b solution reuse the last
stage of an accepted step as the next step's first (:func:`rk_step_fsal`),
through the driver's stepper carry: s - 1 RHS evaluations an attempt and
one to seed the carry. ``compensated=True`` carries the state as a
double-word pair (``comp.py``): the step's increment, summed from the
stages and never taken by subtraction, is folded into (x, lo) by TwoSum,
the ``lo`` word riding the same carry (with FSAL the carry is (k0, lo)).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

from . import comp, lc
from .tableaus import RKF45, ButcherTableau

Pytree = Any


def rk_step(f: Callable, t, x0: Pytree, dt, tab: ButcherTableau, *,
            embedded: bool = True,
            advance_lower: bool = True) -> Tuple[Pytree, Optional[Pytree]]:
    """One explicit RK step: stages K_i = f(t + c_i dt, x0 + dt sum_j a_ij
    K_j), x_b = x0 + dt sum b_i K_i. Returns (x_next, err), err None when
    the tableau has no embedded pair or ``embedded=False``."""
    x_next, err, _, _ = rk_step_stages(f, t, x0, dt, tab, embedded=embedded,
                                       advance_lower=advance_lower)
    return x_next, err


def rk_step_stages(f: Callable, t, x0: Pytree, dt, tab: ButcherTableau, *,
                   embedded: bool = True, advance_lower: bool = True,
                   k0: Optional[Pytree] = None):
    """Like :func:`rk_step`, but also returns the stage slopes K and the
    advanced increment x_next - x0 (from the weighted stage sum, never by
    subtraction). ``k0`` supplies the first stage; with it
    ``advance_lower`` must be False."""
    if k0 is not None and advance_lower:
        raise ValueError("FSAL stage reuse requires advance_lower=False")
    s = tab.stages
    K = [None] * s
    K[0] = f(t, x0) if k0 is None else k0
    for i in range(1, s):
        ti = t + float(tab.c[i]) * dt
        idx = [j for j in range(i) if tab.a[i, j] != 0.0]
        if idx:
            incr = lc.lincomb([K[j] for j in idx],
                              [float(tab.a[i, j]) for j in idx])
            xi = lc.axpy(dt, incr, x0)
        else:
            xi = x0
        K[i] = f(ti, xi)

    bidx = [j for j in range(s) if tab.b[j] != 0.0]
    incr_b = lc.scale(
        lc.lincomb([K[j] for j in bidx], [float(tab.b[j]) for j in bidx]),
        dt)
    x_b = lc.add(x0, incr_b)
    if not embedded or tab.b_err is None:
        return x_b, None, K, incr_b
    db = tab.b - tab.b_err
    eidx = [j for j in range(s) if db[j] != 0.0]
    err = lc.scale(
        lc.lincomb([K[j] for j in eidx], [float(db[j]) for j in eidx]), dt)
    if advance_lower:
        return lc.sub(x_b, err), err, K, lc.sub(incr_b, err)
    return x_b, err, K, incr_b


def rk_step_fsal(f: Callable, t, x0: Pytree, dt, tab: ButcherTableau,
                 k0: Pytree, *, embedded: bool = True):
    """FSAL variant of :func:`rk_step`: the first stage K[0] = f(t, x0)
    comes from the carry (the last accepted step's last stage) and the
    last stage K[s-1] = f(t + dt, x_b) is returned as the next carry, so
    an attempt costs s - 1 RHS evaluations. Needs an FSAL tableau and
    advances the b solution (the last stage sits at x_b). Returns
    (x_b, err, K[s-1])."""
    x_b, err, K, _ = rk_step_stages(f, t, x0, dt, tab, embedded=embedded,
                                    advance_lower=False, k0=k0)
    return x_b, err, K[-1]


@dataclasses.dataclass(frozen=True)
class RungeKutta:
    """Stepper factory for the driver over any :class:`ButcherTableau`
    (``RungeKutta(RKF45)`` is the reference's RK45 solver). The RHS is
    ``f(t, y)`` (``takes_state``), so ``ensemble_solve`` maps
    per-trajectory ``params`` as ``f(t, y, p)``.

    ``fsal`` (None: on for an FSAL tableau advancing the b solution)
    threads the last stage through the driver's stepper carry
    (``has_carry``, ``make_init_carry``); ``fsal=False`` runs an FSAL
    tableau with every stage evaluated. ``compensated=True`` folds each
    step's increment into a double-word (x, lo) pair (``comp.update``),
    ``lo`` riding the stepper carry."""

    tableau: ButcherTableau = RKF45
    advance_lower: bool = True
    embedded: bool = True
    fsal: Optional[bool] = None
    compensated: bool = False

    takes_state = True

    def __post_init__(self):
        self.use_fsal  # raises on fsal=True where FSAL cannot apply

    @property
    def use_fsal(self) -> bool:
        auto = self.tableau.is_fsal and not self.advance_lower
        if self.fsal is None:
            return auto
        if self.fsal and not auto:
            raise ValueError(
                "fsal=True requires an FSAL tableau (c[-1]=1, a[-1]=b) and "
                "advance_lower=False (the reused stage sits at x_b)")
        return self.fsal

    @property
    def has_carry(self) -> bool:
        return self.use_fsal or self.compensated

    @property
    def nfev_per_step(self) -> int:
        return self.tableau.stages - (1 if self.use_fsal else 0)

    @property
    def nfev_init(self) -> int:
        return 1 if self.use_fsal else 0

    def make_init_carry(self, f: Callable) -> Callable:
        """The carry at (t0, x0): the first stage slope f(t0, x0), the zero
        residual word, or both as (k0, lo)."""
        if self.use_fsal and self.compensated:
            return lambda t, x: (f(t, x), comp.zero_lo(x))
        if self.compensated:
            return lambda t, x: comp.zero_lo(x)
        return f

    def make_step_fn(self, f: Callable) -> Callable:
        if self.use_fsal and self.compensated:
            def step_fn_fsal_comp(t, x, dt, carry):
                k0, lo = carry
                _, err, K, incr = rk_step_stages(
                    f, t, x, dt, self.tableau, k0=k0,
                    embedded=self.embedded, advance_lower=False)
                hi, lo2 = comp.update(x, lo, incr)
                return hi, err, (K[-1], lo2)

            return step_fn_fsal_comp

        if self.compensated:
            def step_fn_comp(t, x, dt, lo):
                _, err, _, incr = rk_step_stages(
                    f, t, x, dt, self.tableau, embedded=self.embedded,
                    advance_lower=self.advance_lower)
                hi, lo2 = comp.update(x, lo, incr)
                return hi, err, lo2

            return step_fn_comp

        if self.use_fsal:
            def step_fn_fsal(t, x, dt, k0):
                return rk_step_fsal(f, t, x, dt, self.tableau, k0,
                                    embedded=self.embedded)

            return step_fn_fsal

        def step_fn(t, x, dt):
            return rk_step(f, t, x, dt, self.tableau, embedded=self.embedded,
                           advance_lower=self.advance_lower)

        return step_fn

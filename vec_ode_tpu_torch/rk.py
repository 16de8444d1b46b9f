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

The FSAL slope reuse and the compensated (double-word) state carry live
in the driver's stepper carry, which is not ported (ROADMAP queue 1 item
25): a ``RungeKutta`` that would use either raises ``NotImplementedError``
rather than run without it (which would change ``n_rhs_evals`` and the
bits).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

from . import lc
from .tableaus import RKF45, ButcherTableau

Pytree = Any

_CARRY = ("the driver's stepper carry (FSAL slope reuse, the compensated "
          "state) is ROADMAP queue 1 item 25")


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


@dataclasses.dataclass(frozen=True)
class RungeKutta:
    """Stepper factory for the driver over any :class:`ButcherTableau`
    (``RungeKutta(RKF45)`` is the reference's RK45 solver). The RHS is
    ``f(t, y)`` (``takes_state``), so ``ensemble_solve`` maps
    per-trajectory ``params`` as ``f(t, y, p)``.

    ``fsal`` (None: on for an FSAL tableau advancing the b solution) and
    ``compensated`` need the driver's stepper carry and raise
    ``NotImplementedError`` (ROADMAP queue 1 item 25); ``fsal=False`` runs
    an FSAL tableau with every stage evaluated."""

    tableau: ButcherTableau = RKF45
    advance_lower: bool = True
    embedded: bool = True
    fsal: Optional[bool] = None
    compensated: bool = False

    takes_state = True

    def __post_init__(self):
        if self.compensated:
            raise NotImplementedError(f"RungeKutta(compensated=True): "
                                      f"{_CARRY}")
        if self.use_fsal:
            raise NotImplementedError(
                f"RungeKutta over the FSAL tableau {self.tableau.name!r} "
                f"advancing the b solution reuses the last stage: "
                f"{_CARRY}; pass fsal=False to evaluate every stage")

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
    def nfev_per_step(self) -> int:
        return self.tableau.stages

    nfev_init = 0

    def make_step_fn(self, f: Callable) -> Callable:
        def step_fn(t, x, dt):
            return rk_step(f, t, x, dt, self.tableau, embedded=self.embedded,
                           advance_lower=self.advance_lower)

        return step_fn

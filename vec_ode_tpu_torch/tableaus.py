"""Butcher tableaus (numpy only).

A copy of the tables in ``vec_ode_tpu/tableaus.py``: importing that module
would run ``vec_ode_tpu/__init__.py`` and so import jax, which this package
never does. ``tests/test_torch_tableaus.py`` pins every table here to the
JAX package's, entry for entry.

The reference's "RK45" is the **Fehlberg RKF45** pair, with b = 5th-order
weights and b_err = 4th-order weights. a, b, b_err and c are stored
unpacked.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class ButcherTableau:
    """Explicit Butcher tableau.

    a: (s, s) strictly lower-triangular stage matrix.
    b: (s,) advance weights.
    c: (s,) nodes.
    b_err: optional (s,) embedded weights for the error pair.

    Reference parity (``base/rk.rs:90-155`` + SURVEY §2.3(2)): for an embedded
    pair the reference *advances the b_err (lower-order) solution* in adaptive
    mode and uses err = x_b - x_berr; with ``no_adaptive()`` it advances b.
    The stepper honors that convention (``advance_lower`` in
    ``ops/fused_rk.py``).
    """

    name: str
    a: np.ndarray
    b: np.ndarray
    c: np.ndarray
    b_err: Optional[np.ndarray] = None
    order: int = 0         # order of the b weights
    err_order: int = 0     # order of the b_err weights (0 if none)
    # optional dense-output interpolant: (s, q) matrix P with
    # y(t + theta*dt) = y0 + dt * theta * sum_j K_j * sum_q P[j, q] theta^q
    # (the standard continuous-extension form; scipy stores the same P).
    # Valid for the ADVANCED b solution (endpoints match at theta = 1).
    p_dense: Optional[np.ndarray] = None
    dense_order: int = 0   # local accuracy order of the interpolant

    @property
    def stages(self) -> int:
        return len(self.b)

    @property
    def is_fsal(self) -> bool:
        """First-Same-As-Last: the last stage is evaluated at (t+dt, x_b)
        (c_s = 1, a[s-1, :] = b), so an ACCEPTED step's last slope is the
        next step's first stage — 1 fewer RHS eval per step when advancing
        the b solution (DOPRI5, BOSH32)."""
        return bool(
            self.c[-1] == 1.0 and np.allclose(self.a[-1, :], self.b)
        )

    def __post_init__(self):
        s = self.stages
        assert self.a.shape == (s, s)
        assert self.c.shape == (s,)
        if self.b_err is not None:
            assert self.b_err.shape == (s,)


def _tab(name, a, b, c, b_err=None, order=0, err_order=0, p_dense=None,
         dense_order=0):
    return ButcherTableau(
        name=name,
        a=np.asarray(a, dtype=np.float64),
        b=np.asarray(b, dtype=np.float64),
        c=np.asarray(c, dtype=np.float64),
        b_err=None if b_err is None else np.asarray(b_err, dtype=np.float64),
        order=order,
        err_order=err_order,
        p_dense=None if p_dense is None else np.asarray(p_dense, np.float64),
        dense_order=dense_order,
    )


# --- Fehlberg RKF45 (reference dat/mod.rs:9-27, exact expressions) ----------
# NOTE a genuine reference bug (beyond SURVEY §2.3): dat/mod.rs:19 has
# a[5][2] = -3544/2526 where Fehlberg's tableau reads -3544/2565. The typo
# breaks the row-sum consistency of stage 6 and degrades the b (5th-order)
# combination to ~O(dt^2) local accuracy. The reference survives because
# b_err[5] = 0: the *advanced* (4th-order) solution never touches K6, so only
# the error estimate is inflated (the controller just takes conservative
# steps). We default to the corrected tableau (RKF45) and keep the
# reference-exact one (RKF45_REFERENCE) for bit-parity experiments.
RKF45_REFERENCE = _tab(
    "rkf45_reference",
    a=[
        [0, 0, 0, 0, 0, 0],
        [1 / 4, 0, 0, 0, 0, 0],
        [3 / 32, 9 / 32, 0, 0, 0, 0],
        [1932 / 2197, -7200 / 2197, 7296 / 2197, 0, 0, 0],
        [439 / 216, -8, 3680 / 513, -845 / 4104, 0, 0],
        [-8 / 27, 2, -3544 / 2526, 1859 / 4104, -11 / 40, 0],
    ],
    b=[16 / 135, 0, 6656 / 12825, 28561 / 56430, -9 / 50, 2 / 55],
    b_err=[25 / 216, 0, 1408 / 2565, 2197 / 4104, -1 / 5, 0],
    c=[0, 1 / 4, 3 / 8, 12 / 13, 1, 1 / 2],
    order=5,
    err_order=4,
)

_a_fixed = RKF45_REFERENCE.a.copy()
_a_fixed[5][2] = -3544 / 2565
RKF45 = _tab(
    "rkf45",
    a=_a_fixed,
    b=RKF45_REFERENCE.b,
    b_err=RKF45_REFERENCE.b_err,
    c=RKF45_REFERENCE.c,
    order=5,
    err_order=4,
)

# --- Classic fixed-step RK4 --------------------------------------------------
RK4 = _tab(
    "rk4",
    a=[
        [0, 0, 0, 0],
        [1 / 2, 0, 0, 0],
        [0, 1 / 2, 0, 0],
        [0, 0, 1, 0],
    ],
    b=[1 / 6, 1 / 3, 1 / 3, 1 / 6],
    c=[0, 1 / 2, 1 / 2, 1],
    order=4,
)

# --- Heun / midpoint / Euler (cheap fixed steppers) -------------------------
EULER = _tab("euler", a=[[0]], b=[1], c=[0], order=1)
MIDPOINT_RK2 = _tab(
    "midpoint_rk2", a=[[0, 0], [1 / 2, 0]], b=[0, 1], c=[0, 1 / 2], order=2
)
HEUN_RK2 = _tab(
    "heun_rk2", a=[[0, 0], [1, 0]], b=[1 / 2, 1 / 2], c=[0, 1], order=2
)

# --- Dormand-Prince 5(4) (FSAL; see rk.rk_step_fsal) ------------------------
DOPRI5 = _tab(
    "dopri5",
    a=[
        [0, 0, 0, 0, 0, 0, 0],
        [1 / 5, 0, 0, 0, 0, 0, 0],
        [3 / 40, 9 / 40, 0, 0, 0, 0, 0],
        [44 / 45, -56 / 15, 32 / 9, 0, 0, 0, 0],
        [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729, 0, 0, 0],
        [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656, 0, 0],
        [35 / 384, 0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0],
    ],
    b=[35 / 384, 0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0],
    b_err=[
        5179 / 57600, 0, 7571 / 16695, 393 / 640,
        -92097 / 339200, 187 / 2100, 1 / 40,
    ],
    c=[0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1, 1],
    order=5,
    err_order=4,
    # order-4 continuous extension (Shampine 1986, the interpolant scipy's
    # RK45 ships): published constants, valid for the b (5th-order) advance
    p_dense=[
        [1, -8048581381 / 2820520608, 8663915743 / 2820520608,
         -12715105075 / 11282082432],
        [0, 0, 0, 0],
        [0, 131558114200 / 32700410799, -68118460800 / 10900136933,
         87487479700 / 32700410799],
        [0, -1754552775 / 470086768, 14199869525 / 1410260304,
         -10690763975 / 1880347072],
        [0, 127303824393 / 49829197408, -318862633887 / 49829197408,
         701980252875 / 199316789632],
        [0, -282668133 / 205662961, 2019193451 / 616988883,
         -1453857185 / 822651844],
        [0, 40617522 / 29380423, -110615467 / 29380423,
         69997945 / 29380423],
    ],
    dense_order=4,
)

# --- Bogacki-Shampine 3(2) ---------------------------------------------------
BOSH32 = _tab(
    "bosh32",
    a=[
        [0, 0, 0, 0],
        [1 / 2, 0, 0, 0],
        [0, 3 / 4, 0, 0],
        [2 / 9, 1 / 3, 4 / 9, 0],
    ],
    b=[2 / 9, 1 / 3, 4 / 9, 0],
    b_err=[7 / 24, 1 / 4, 1 / 3, 1 / 8],
    c=[0, 1 / 2, 3 / 4, 1],
    order=3,
    err_order=2,
    # order-3 continuous extension (Bogacki & Shampine; scipy's RK23 P)
    p_dense=[
        [1, -4 / 3, 5 / 9],
        [0, 1, -2 / 3],
        [0, 4 / 3, -8 / 9],
        [0, -1, 1],
    ],
    dense_order=3,
)

# --- Cash-Karp 5(4) ----------------------------------------------------------
CASH_KARP = _tab(
    "cash_karp",
    a=[
        [0, 0, 0, 0, 0, 0],
        [1 / 5, 0, 0, 0, 0, 0],
        [3 / 40, 9 / 40, 0, 0, 0, 0],
        [3 / 10, -9 / 10, 6 / 5, 0, 0, 0],
        [-11 / 54, 5 / 2, -70 / 27, 35 / 27, 0, 0],
        [1631 / 55296, 175 / 512, 575 / 13824, 44275 / 110592, 253 / 4096, 0],
    ],
    b=[37 / 378, 0, 250 / 621, 125 / 594, 0, 512 / 1771],
    b_err=[
        2825 / 27648, 0, 18575 / 48384, 13525 / 55296, 277 / 14336, 1 / 4,
    ],
    c=[0, 1 / 5, 3 / 10, 3 / 5, 1, 7 / 8],
    order=5,
    err_order=4,
)

TABLEAUS = {
    t.name: t
    for t in [
        RKF45, RKF45_REFERENCE, RK4, EULER, MIDPOINT_RK2, HEUN_RK2,
        DOPRI5, BOSH32, CASH_KARP,
    ]
}


# --- Gauss-Legendre quadrature nodes ------------------------------------------
# 2-node Gauss-Legendre on [0, 1]: 1/2 -/+ 1/(2 sqrt(3)).
C_GAUSS_LEGENDRE_4 = np.array(
    [0.5 - 0.5 / math.sqrt(3.0), 0.5 + 0.5 / math.sqrt(3.0)], dtype=np.float64
)

# 3-node Gauss-Legendre on [0, 1].
C_GAUSS_LEGENDRE_6 = np.array(
    [0.5 - 0.5 * math.sqrt(3.0 / 5.0), 0.5, 0.5 + 0.5 * math.sqrt(3.0 / 5.0)],
    dtype=np.float64,
)

# Gauss-Legendre nodes and weights on [0, 1] by point count (quad.py's table;
# copies of vec_ode_tpu/quad.py:25-60).
_S65 = math.sqrt(6.0 / 5.0)
_S107 = math.sqrt(10.0 / 7.0)
GAUSS_LEGENDRE = {
    1: (np.array([0.5]), np.array([1.0])),
    2: (C_GAUSS_LEGENDRE_4, np.array([0.5, 0.5])),
    3: (C_GAUSS_LEGENDRE_6, np.array([5.0 / 18.0, 4.0 / 9.0, 5.0 / 18.0])),
    4: (np.array([0.5 - 0.5 * math.sqrt(3.0 / 7.0 + 2.0 / 7.0 * _S65),
                  0.5 - 0.5 * math.sqrt(3.0 / 7.0 - 2.0 / 7.0 * _S65),
                  0.5 + 0.5 * math.sqrt(3.0 / 7.0 - 2.0 / 7.0 * _S65),
                  0.5 + 0.5 * math.sqrt(3.0 / 7.0 + 2.0 / 7.0 * _S65)]),
        np.array([(18.0 - math.sqrt(30.0)) / 72.0,
                  (18.0 + math.sqrt(30.0)) / 72.0,
                  (18.0 + math.sqrt(30.0)) / 72.0,
                  (18.0 - math.sqrt(30.0)) / 72.0])),
    5: (np.array([0.5 - 0.5 / 3.0 * math.sqrt(5.0 + 2.0 * _S107),
                  0.5 - 0.5 / 3.0 * math.sqrt(5.0 - 2.0 * _S107),
                  0.5,
                  0.5 + 0.5 / 3.0 * math.sqrt(5.0 - 2.0 * _S107),
                  0.5 + 0.5 / 3.0 * math.sqrt(5.0 + 2.0 * _S107)]),
        np.array([(322.0 - 13.0 * math.sqrt(70.0)) / 1800.0,
                  (322.0 + 13.0 * math.sqrt(70.0)) / 1800.0,
                  128.0 / 450.0,
                  (322.0 + 13.0 * math.sqrt(70.0)) / 1800.0,
                  (322.0 - 13.0 * math.sqrt(70.0)) / 1800.0])),
}

# --- Operator-splitting coefficients (copies of vec_ode_tpu/tableaus.py:
# 259-290) --------------------------------------------------------------------
# Blanes & Moan (2002) RKN order-4, BAB convention.
RKN_O4_A = np.array(
    [0.209515106613362, -0.143851773179818, 0.434336666566456],
    dtype=np.float64,
)
RKN_O4_B = np.array(
    [0.0792036964311957, 0.353172906049774, -0.0420650803577195,
     0.21937695575349958],
    dtype=np.float64,
)

# Complex triple-jump order-4.
TJ_O4_A = np.array(
    [0.32439640402017118298 + 0.13458627249080669679j,
     0.35120719195965763405 - 0.26917254498161339358j],
    dtype=np.complex128,
)
TJ_O4_B = np.array(
    [0.16219820201008559149 + 0.06729313624540334839j,
     0.33780179798991440851 - 0.06729313624540334839j],
    dtype=np.complex128,
)

# Semi-complex order-4.
SEMI_COMPLEX_O4_A = np.array([0.25 + 0.0j, 0.25 + 0.0j], dtype=np.complex128)
SEMI_COMPLEX_O4_B = np.array(
    [0.1 - 1j / 30.0, 4.0 / 15.0 + 2j / 15.0, 4.0 / 15.0 - 1j / 5.0],
    dtype=np.complex128,
)

# --- Commutator-free Magnus coefficient matrices -------------------------------
# Rows = exponentials, columns = Gauss-Legendre samples of A(t).
CFM_R2_J1_GL = np.array([[0.5, 0.5]], dtype=np.float64)               # 1 exp, order 2
CFM_R4_J2_GL = np.array(                                              # 2 exps, order 4
    [[0.53867513459481288225, -0.038675134594812882255],
     [-0.038675134594812882255, 0.53867513459481288225]],
    dtype=np.float64,
)
BLANES17_R4_J4 = np.array(                                            # 4 exps, order 4
    [[0.2463347584748155, -0.0469610812011527, 0.0119511881315244],
     [0.0622500005170514, 0.2691833034233750, -0.0427581693456134],
     [-0.0427581693456134, 0.2691833034233750, 0.0622500005170514],
     [0.0119511881315244, -0.0469610812011527, 0.2463347584748155]],
    dtype=np.float64,
)

"""The chain-exponential action for modulated operators, the counterpart of
``vec_ode_tpu/ops/pallas_expmv.py``.

For each trajectory b and chain c it computes
y[b, c] = e^{A(rows[b, c, R-1])} ... e^{A(rows[b, c, 0])} x[b] with
A(row) = sum_k row[k] M_k over a shared working basis M_k (R sequential
exponentials per chain, C <= 2 chains), by scaling and a degree-m Taylor
chain whose every term is one (B, D) @ (D, K'D) product with the stacked
basis.

* :class:`CoeffForm` and :class:`ChebForm` declare the coefficient
  functions a kernel samples in-kernel: c_k(t) = a_k + b_k t + c_k
  cos(w_k t), or a Chebyshev series on [lo, hi] (the fit of
  ``exp.auto_modulated``).
* :func:`chain_rows` is the declared row recipe that the kernels build
  from raw inputs (node samples and dt) where the JAX package passes a
  ``cols_builder`` callback: ``"midpoint"``, ``"magnus4"`` (C = 2: the
  order-4 row and the order-2 comparison row; C = 1 without an error
  estimate), ``"magnus4_fast"`` (``fast_error``: C = 1 and the error
  (sum_k w2_k C_k) y on the advanced state), ``"magnus6"`` (the three
  Yoshida sub-interval Magnus-4 rows; C = 2 adds the comparison chain
  [full-interval Magnus-4 row, identity, identity], whose identity rows
  are skipped) and ``"cfm"`` (the alpha rows of a declared
  :class:`CfmTable` over its nodes; C = 2 adds the alpha_err rows padded
  with zero rows, which are run).
* :func:`scale_rows` is the scaling rule of the port: ONE squaring count
  per trajectory, chain and row, from that row's 1-norm bound
  sum_k |c_k| ||M_k||_1, s = 0 for a non-finite bound (the JAX package's
  XLA rule); the JAX tiers take one count per batch (XLA) or per kernel
  tile (Pallas), which differs from this only by rounding.
* :func:`torch_chain_step` is the plain twin of one whole step (rows,
  scaling, chains, error measure), the counterpart of ``chain_expmv_xla``
  with the stepper's arithmetic around it.
* :func:`fused_chain_apply` is the wrapper of the hand-written CUDA kernel
  ``csrc/chain_expmv.cu`` (K4): CPU tensors run the twin, CUDA tensors
  launch the kernel or raise. ``fused_chain_apply.launches`` counts the
  launches. K4 and the loop kernel's chain step K5 run one product body
  for every K' (``csrc/chain_step.cuh`` over ``csrc/gemm_tile.cuh``): per
  basis term a tiled product of the transposed term with M_k^T streamed
  through a cp.async ring (or resident in shared memory), folded at once
  in k order. K4 launches it on one of two routes, tiled or, where that
  gives fewer blocks than SMs, a thread-block cluster per tile sharing
  the term through distributed shared memory; :func:`chain_plan` mirrors
  the choice, :func:`chain_smem_bytes` the shared memory and
  :func:`loop_plan` K5's tile in the loop kernel. The routes give the
  same bits.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Optional, Sequence

import numpy as np
import torch

from . import _build
from .forms import FORMS, ChebForm, CoeffForm  # noqa: F401 (re-exported)
from .fused_rk import MAX_WIDTH, _step_error_measure, kernel_norm_args

# Gauss-Legendre 2-node half-offset 1/(2 sqrt 3) and the Magnus-4
# commutator weight -sqrt(3)/12: copies of vec_ode_tpu/exp/magnus.py:29-31
_C_MID = 0.5 / math.sqrt(3.0)
_B2 = -math.sqrt(3.0) / 12.0
# the Yoshida triple jump [g1, 1 - 2 g1, g1] dt, g1 = 1 / (2 - 2^(1/5)):
# copies of vec_ode_tpu/exp/magnus.py:35-37
_G1 = 1.0 / (2.0 - 2.0 ** 0.2)
_SUB_OFF = (0.0, _G1, 1.0 - _G1)
_SUB_LEN = (_G1, 1.0 - 2.0 * _G1, _G1)

RECIPES = {"midpoint": 0, "magnus4": 1, "magnus4_fast": 2, "magnus6": 3,
           "cfm": 4}
# the kernels' limits (csrc/chain_step.cuh): at most MAX_K0 basis terms
# (exp.auto_modulated's default k_max), so a working basis of at most
# MAX_KP = 36 terms (K0, plus their K0 (K0 - 1) / 2 commutators for the
# Magnus recipes), at most MAX_R exponentials per chain and MAX_NODES
# quadrature nodes per step (BLANES17_R4_J4 has 4 rows; MAGNUS6 samples 8
# nodes)
MAX_K0 = 8
MAX_KP = MAX_K0 + MAX_K0 * (MAX_K0 - 1) // 2
MAX_R = 4
MAX_NODES = 8
@dataclasses.dataclass(frozen=True)
class CfmTable:
    """A commutator-free Magnus scheme as the kernels read it, in place of
    the JAX package's ``cols_builder`` closure: the quadrature nodes ``c``
    (J,) on [0, 1], the main chain's rows ``alpha`` (R, J) and, for an
    error estimate, the comparison chain's rows ``alpha_err`` (n_err, J),
    n_err <= R. Row i of a chain is dt sum_j alpha[i][j] g(t + c_j dt),
    summed in j order with the zero alphas left out (the JAX kernels'
    order); the comparison chain is padded to R rows with zero rows."""

    alpha: tuple
    c: tuple
    alpha_err: Optional[tuple] = None

    def __post_init__(self):
        c = tuple(float(v) for v in np.asarray(self.c, np.float64).ravel())
        mats = []
        for name in ("alpha", "alpha_err"):
            a = getattr(self, name)
            if a is None:
                mats.append(None)
                continue
            a = np.asarray(a, np.float64)
            if a.ndim != 2 or a.shape[1] != len(c) or a.shape[0] < 1:
                raise ValueError(f"CfmTable: {name} must be (rows, "
                                 f"{len(c)}), got {a.shape}")
            mats.append(tuple(tuple(float(v) for v in row) for row in a))
        if not c:
            raise ValueError("CfmTable: at least one node")
        alpha, alpha_err = mats
        if alpha_err is not None and len(alpha_err) > len(alpha):
            raise ValueError(
                "error chain longer than the main chain is unsupported "
                f"({len(alpha_err)} > {len(alpha)})")
        for name, value in (("alpha", alpha), ("c", c),
                            ("alpha_err", alpha_err)):
            object.__setattr__(self, name, value)

    @property
    def n_rows(self) -> int:
        return len(self.alpha)

    @property
    def n_err(self) -> int:
        return 0 if self.alpha_err is None else len(self.alpha_err)


def pairs_of(K0: int) -> list:
    """The commutator pairs (j, k), j < k, in the order of the extended
    basis (``ModulatedOperator.commutator_extension``)."""
    return [(j, k) for j in range(K0) for k in range(j + 1, K0)]


def n_working_terms(recipe: str, K0: int) -> int:
    """K': the basis terms a recipe's rows span."""
    return K0 if recipe in ("midpoint", "cfm") else K0 + len(pairs_of(K0))


def check_recipe(recipe: str, C: int, table: Optional[CfmTable] = None
                 ) -> None:
    if recipe not in RECIPES:
        raise ValueError(f"unknown chain recipe {recipe!r}; one of "
                         f"{sorted(RECIPES)}")
    if (recipe == "cfm") != (table is not None):
        raise ValueError("the recipe 'cfm', and only it, takes a CfmTable")
    if recipe == "cfm" and not isinstance(table, CfmTable):
        raise TypeError(f"recipe 'cfm' takes a CfmTable, got {table!r}")
    if recipe == "cfm":
        want = 2 if table.alpha_err is not None else 1
        if C != want:
            raise ValueError(f"recipe 'cfm' takes C = {want} for a table "
                             + ("with" if want == 2 else "without")
                             + f" alpha_err, got C = {C}")
        return
    two = recipe in ("magnus4", "magnus6")
    if C not in (1, 2) or (C == 2 and not two):
        raise ValueError(f"recipe {recipe!r} takes C = 1"
                         + (" or 2" if two else "") + f", got C = {C}")


def has_error_estimate(recipe: str, C: int) -> bool:
    """Whether a recipe's step estimates its error: two chains, or
    ``magnus4_fast``."""
    return C == 2 or recipe == "magnus4_fast"


def n_rows(recipe: str, table: Optional[CfmTable] = None) -> int:
    """R: the exponentials per chain."""
    if recipe == "magnus6":
        return 3
    return table.n_rows if recipe == "cfm" else 1


def identity_rows(recipe: str, C: int) -> frozenset:
    """The declared identity rows (c, r), which the kernels and the twin
    skip: the Magnus-6 comparison chain's rows 1 and 2."""
    if recipe == "magnus6" and C == 2:
        return frozenset({(1, 1), (1, 2)})
    return frozenset()


def n_nodes(recipe: str, C: int = 1, table: Optional[CfmTable] = None
            ) -> int:
    """The quadrature nodes of one step (:func:`node_times`)."""
    return len(node_times(recipe, 0.0, 1.0, C, table))


def node_times(recipe: str, t, dt, C: int = 1,
               table: Optional[CfmTable] = None) -> list:
    """The quadrature nodes of one step from t over dt, in the JAX
    package's arithmetic (exp/modulated.py's step_fn and step_cols, the
    Python constants folded in f64 and rounded once to t's type):
    midpoint tm = t + dt/2; Magnus-4 the two Gauss-Legendre nodes
    tm -/+ _C_MID dt; Magnus-6 per sub-interval (off, ln)
    tm_i -/+ (_C_MID ln) dt with tm_i = t + (off + ln/2) dt, and for C = 2
    the full interval's two nodes; CFM t + c_j dt."""
    if recipe == "cfm":
        return [t + cj * dt for cj in table.c]
    if recipe == "magnus6":
        out = []
        for off, ln in zip(_SUB_OFF, _SUB_LEN):
            tm = t + (off + 0.5 * ln) * dt
            out += [tm - _C_MID * ln * dt, tm + _C_MID * ln * dt]
        if C == 1:
            return out
        return out + node_times("magnus4", t, dt)
    tm = t + 0.5 * dt
    if recipe == "midpoint":
        return [tm]
    return [tm - _C_MID * dt, tm + _C_MID * dt]


def _m4_row(ga, gb, dts):
    """The Magnus-4 row [w1, w2] over (ga, gb) (B, K0) and the step dts
    (B, 1): w1 = (dts/2)(ga + gb), w2 = (_B2 dts dts)(ga_j gb_k -
    ga_k gb_j) on the commutator pairs."""
    w1 = 0.5 * dts * (ga + gb)
    pairs = pairs_of(ga.shape[1])
    if not pairs:
        return w1
    j = [p[0] for p in pairs]
    k = [p[1] for p in pairs]
    w2 = (_B2 * dts * dts) * (ga[:, j] * gb[:, k] - ga[:, k] * gb[:, j])
    return torch.cat([w1, w2], dim=1)


def _cfm_rows(mat, samples, dt1, R):
    """dt sum_j mat[i][j] g_j per row i < len(mat), the zero entries left
    out and the sum taken in j order (the JAX kernels' order; its XLA
    tier forms the same rows with one einsum), then zero rows up to R."""
    rows = []
    for i in range(R):
        acc = None
        for a, g in zip(mat[i] if i < len(mat) else (), samples):
            if a == 0.0:
                continue
            term = a * g
            acc = term if acc is None else acc + term
        rows.append(torch.zeros_like(samples[0]) if acc is None
                    else dt1 * acc)
    return torch.stack(rows, dim=1)


def chain_rows(recipe: str, samples: Sequence[torch.Tensor], dt, C: int,
               table: Optional[CfmTable] = None):
    """Coefficient rows (B, C, R, K') from the node samples (each (B, K0),
    in :func:`node_times` order) and dt (B,), in the JAX package's
    arithmetic order: midpoint dt g; Magnus-4 chain 0 = [w1, w2] of
    :func:`_m4_row`, chain 1 (C = 2) = [w1, 0]; Magnus-6 chain 0 = the
    three sub-interval rows over (ln dt), chain 1 = [the full interval's
    row, 0, 0] (rows 1 and 2 are :func:`identity_rows`); CFM the alpha
    rows of :func:`_cfm_rows` and the alpha_err rows padded with zero
    rows."""
    dt1 = dt[:, None]
    if recipe == "midpoint":
        return (dt1 * samples[0])[:, None, None]
    if recipe == "cfm":
        R = table.n_rows
        main = _cfm_rows(table.alpha, samples, dt1, R)
        if C == 1:
            return main[:, None]
        return torch.stack([main, _cfm_rows(table.alpha_err, samples, dt1,
                                            R)], 1)
    if recipe == "magnus6":
        main = torch.stack([_m4_row(samples[2 * i], samples[2 * i + 1],
                                    float(_SUB_LEN[i]) * dt1)
                            for i in range(3)], 1)
        if C == 1:
            return main[:, None]
        full = _m4_row(samples[6], samples[7], dt1)
        zero = torch.zeros_like(full)
        return torch.stack([main, torch.stack([full, zero, zero], 1)], 1)
    g1, g2 = samples[0], samples[1]
    main = _m4_row(g1, g2, dt1)
    if C == 1:
        return main[:, None, None]
    K0 = g1.shape[1]
    lower = torch.cat([main[:, :K0], torch.zeros_like(main[:, K0:])], 1)
    return torch.stack([main, lower], 1)[:, :, None]


def scale_rows(rows, norms, theta: float, max_squarings: int):
    """The port's scaling rule: per trajectory and chain row, the bound
    sum_k |c_k| ||M_k||_1 (summed in k order; ``norms`` the K' 1-norms)
    gives the least s >= 0 with
    bound / theta <= 2^s, at most ``max_squarings``; a non-finite bound
    gives s = 0 (its NaN still reaches the result, so the controller
    rejects). Returns (rows / 2^s, 2^s as int32), s found exactly with
    frexp as the kernels do."""
    bound = None
    for k in range(rows.shape[-1]):
        term = rows[..., k].abs() * norms[k]
        bound = term if bound is None else bound + term
    ratio = bound / theta
    mant, expo = torch.frexp(ratio)
    s = expo - (mant == 0.5).to(expo.dtype)
    s = torch.where(torch.isfinite(bound) & (ratio > 1.0),
                    torch.clamp(s, 0, max_squarings), 0)
    n_pass = torch.bitwise_left_shift(torch.ones_like(s), s).to(torch.int32)
    # 1 / 2^s is exact
    return rows * (1.0 / n_pass.to(rows.dtype))[..., None], n_pass


def torch_chain_expmv(cs, n_pass, xw, mt, *, m: int,
                      identity: frozenset = frozenset()) -> list:
    """Plain twin of the chain action: for each chain c, the rows r in
    order, row (c, r) n_pass[b, c, r] passes of the degree-m Taylor
    polynomial of sum_k cs[b, c, r, k] M_k on the running state (xw[b] at
    r = 0), each term one (B, D) @ (D, K'D) product with ``mt`` =
    [M_0^T | ... | M_{K'-1}^T], combined in k order and divided by the
    term's index (chain_expmv_xla's arithmetic). Rows past their pass
    count keep their value; the rows of ``identity`` are skipped. Returns
    the C results (B, D)."""
    D = xw.shape[1]
    outs = []
    for c in range(cs.shape[1]):
        v = xw
        for r in range(cs.shape[2]):
            if (c, r) in identity:
                continue
            csc, npc = cs[:, c, r], n_pass[:, c, r]
            for p in range(int(npc.max())):
                acc = term = v
                for kk in range(1, m + 1):
                    mv = term @ mt
                    w = None
                    for k in range(csc.shape[1]):
                        part = csc[:, k:k + 1] * mv[:, k * D:(k + 1) * D]
                        w = part if w is None else w + part
                    term = w / kk
                    acc = acc + term
                v = torch.where((npc > p)[:, None], acc, v)
        outs.append(v)
    return outs


def torch_chain_step(samples, dt, xw, mt, norms, *, recipe: str, C: int,
                     m: int, theta: float, max_squarings: int = 16,
                     wnorm=None, scaled=None,
                     table: Optional[CfmTable] = None):
    """One whole chain step in plain torch, what the kernels compute: the
    rows of ``recipe`` from the node ``samples`` and dt, the per-row
    scaling, the chains from xw, and the error measure of
    ``fused_rk._step_error_measure`` (``scaled=(atol, rtol)`` or a declared
    ``wnorm``) of chain1 - chain0 (C = 2) or of ``magnus4_fast``'s
    (sum_{k >= K0} w2_k M_k) y. Returns (y (B, D), err (B,) or None)."""
    rows = chain_rows(recipe, samples, dt, C, table)
    cs, n_pass = scale_rows(rows, norms, theta, max_squarings)
    outs = torch_chain_expmv(cs, n_pass, xw, mt, m=m,
                             identity=identity_rows(recipe, C))
    y = outs[0]
    if C == 2:
        dv = outs[1] - y
    elif recipe == "magnus4_fast":
        D, K0 = xw.shape[1], samples[0].shape[1]
        mv = y @ mt
        dv = None
        for k in range(K0, rows.shape[-1]):
            part = rows[:, 0, 0, k:k + 1] * mv[:, k * D:(k + 1) * D]
            dv = part if dv is None else dv + part
        if dv is None:
            dv = torch.zeros_like(y)
    else:
        return y, None
    return y, _step_error_measure(dv, xw, y, wnorm=wnorm, scaled=scaled)


def basis_norms(basis_w: torch.Tensor) -> tuple:
    """||M_k||_1 (max column sum) of each (D, D) working basis term, as
    floats (exact in the basis' type): computed once per basis, so that no
    launch copies them back from the card."""
    return tuple(torch.amax(torch.sum(torch.abs(basis_w), dim=-2),
                            dim=-1).tolist())


def stacked_transpose(basis_w: torch.Tensor) -> torch.Tensor:
    """[M_0^T | ... | M_{K'-1}^T], (D, K'D) contiguous: for each
    contraction index one contiguous row, as the kernels read it."""
    Kp, D, _ = basis_w.shape
    return basis_w.permute(2, 0, 1).reshape(D, Kp * D).contiguous()


def stacked_basis(basis_w: torch.Tensor) -> torch.Tensor:
    """[M_0 | ... | M_{K'-1}], (D, K'D) contiguous: the operand of the
    transposed action v -> M_k^T v in the same product as
    :func:`stacked_transpose` (row j holds M_k[j, :]), so no transposed
    copy of the basis is made."""
    Kp, D, _ = basis_w.shape
    return basis_w.permute(1, 0, 2).reshape(D, Kp * D).contiguous()


@functools.cache
def _kernel_lib() -> ctypes.CDLL:
    """K4's library, built on first use, with its entry points' argument
    types set."""
    lib = _build.load("chain_expmv")
    vp, ci, cd = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    for fn in (lib.vec_ode_chain_expmv_f32, lib.vec_ode_chain_expmv_f64):
        fn.restype = ci
        fn.argtypes = [vp, vp, vp, vp, vp, vp, ci, ci, ctypes.POINTER(cd),
                       vp, cd, ci, vp]
    return lib


# the tiled products of csrc/gemm_tile.cuh (K4, K5 and K7): threads a block
# at most, columns per thread, a panel's bytes, panels in the ring,
# contraction rows a panel at most, K4's tiled rows per thread by type
GEMM_THREADS = 256
GEMM_CN = 4
GEMM_PANEL_BYTES = 16384
GEMM_STAGES = 3
GEMM_MAX_JC = 32
GEMM_RM = {4: 8, 8: 4}
# K4's cluster route (csrc/chain_expmv.cu): blocks a cluster at most, the
# outputs a thread (rows, columns), rows a cluster at most
CLUSTER_MAX = 4
CLUSTER_RM, CLUSTER_CN = 1, 2
CLUSTER_TILE = 16
# the loop kernel's chain step (csrc/fused_loop.cu): rows a thread, threads
# a block at most
LOOP_RM = 4
LOOP_THREADS = 256


def _align16(n: int) -> int:
    return (n + 15) // 16 * 16


def gemm_dp(D: int) -> int:
    """A right operand's padded row in shared memory (gemm_tile.cuh)."""
    return (D + GEMM_CN - 1) // GEMM_CN * GEMM_CN


def gemm_jc(D: int, elem: int) -> int:
    """Contraction rows of a panel of a right operand D columns wide, for
    elements of ``elem`` bytes."""
    jc = GEMM_PANEL_BYTES // (gemm_dp(D) * elem) // 8 * 8
    return min(max(jc, 8), GEMM_MAX_JC)


def ring_resident(D: int, Kp: int, dc: int, elem: int) -> bool:
    """Whether a block's basis slice (dc of each M_k^T's D columns, K'
    terms) stays resident in shared memory: when it takes no more than the
    ring (gemm_tile.cuh)."""
    return Kp * D * gemm_dp(dc) * elem <= GEMM_STAGES * GEMM_PANEL_BYTES


def ring_bytes(D: int, Kp: int, dc: int, elem: int) -> int:
    """Bytes of a block's basis in shared memory: resident or the ring."""
    if ring_resident(D, Kp, dc, elem):
        return Kp * D * gemm_dp(dc) * elem
    return GEMM_STAGES * gemm_jc(dc, elem) * gemm_dp(dc) * elem


def chain_smem_bytes(tile: int, D: int, dc: int, elem: int, recipe: str,
                     C: int, K0: int, table: Optional[CfmTable] = None,
                     cluster: bool = False, with_dt: bool = True) -> int:
    """Shared memory of the chain step's scratch for ``tile`` rows of
    which a block owns ``dc`` columns (csrc/chain_step.cuh: ChainLayout):
    the term (twice where it alternates: on the cluster route or with the
    basis resident), the basis, the scaled rows, magnus4_fast's unscaled
    rows, the node samples, dt (K4 keeps it there), the pass counts."""
    nr = C * n_rows(recipe, table)
    kp = n_working_terms(recipe, K0)
    J = n_nodes(recipe, C, table)
    nbuf = 2 if cluster or ring_resident(D, kp, dc, elem) else 1
    parts = [nbuf * D * tile * elem, ring_bytes(D, kp, dc, elem),
             nr * tile * kp * elem,
             tile * kp * elem if recipe == "magnus4_fast" else 0,
             J * tile * K0 * elem, tile * elem if with_dt else 0,
             nr * tile * 4]
    return sum(_align16(p) for p in parts)


def gemm_tile(B: int, D: int, elem: int, recipe: str, C: int, K0: int,
              table: Optional[CfmTable] = None, n_sm: int = 132,
              max_smem: int = 232448) -> int:
    """Rows per block of K4's tiled route (chain_expmv.cu: chain_plan) on a
    card of ``n_sm`` SMs with ``max_smem`` bytes of shared memory a block
    (an H100's by default)."""
    rm, ncg = GEMM_RM[elem], gemm_dp(D) // GEMM_CN
    tile = 128
    while tile > rm and ((tile // rm) * ncg > GEMM_THREADS
                         or chain_smem_bytes(tile, D, D, elem, recipe, C,
                                             K0, table) > max_smem):
        tile //= 2
    while tile > 16 and -(-B // tile) < n_sm:
        tile //= 2
    return tile


def chain_plan(B: int, D: int, elem: int, recipe: str, C: int, K0: int,
               table: Optional[CfmTable] = None, n_sm: int = 132,
               max_smem: int = 232448) -> dict:
    """K4's launch plan (chain_expmv.cu: chain_plan): the tiled route
    (:func:`gemm_tile`) unless it gives fewer blocks than SMs, then the
    cluster route: dc = ceil(D / CLUSTER_MAX) columns a block (rounded up
    to CLUSTER_CN), n = ceil(D / dc) >= 2 blocks a tile, and tiles of the
    largest power of two up to CLUSTER_TILE rows that fits, halved while
    the clusters' blocks are fewer than SMs. Returns the route, n, tile,
    dc, rows and columns a thread, threads, blocks, shared memory a block
    and whether the basis stays resident."""
    kp = n_working_terms(recipe, K0)
    tile = gemm_tile(B, D, elem, recipe, C, K0, table, n_sm, max_smem)
    dc = -(-(-(-D // CLUSTER_MAX)) // CLUSTER_CN) * CLUSTER_CN
    n = -(-D // dc)
    if -(-B // tile) >= n_sm or n < 2:
        rm, cn, n, dc, cluster = GEMM_RM[elem], GEMM_CN, 1, D, False
    else:
        rm, cn, cluster = CLUSTER_RM, CLUSTER_CN, True
        ncl = -(-dc // cn)
        tile = CLUSTER_TILE
        while tile > rm and ((tile // rm) * ncl > GEMM_THREADS
                             or chain_smem_bytes(tile, D, dc, elem, recipe, C,
                                                 K0, table, True)
                             > max_smem):
            tile //= 2
        while tile > rm and -(-B // tile) * n < n_sm:
            tile //= 2
    items = (tile // rm) * -(-dc // cn)
    return dict(route="cluster" if cluster else "tiled", n=n, tile=tile,
                dc=dc, rm=rm, cn=cn, threads=-(-items // 32) * 32,
                blocks=-(-B // tile) * n,
                smem=chain_smem_bytes(tile, D, dc, elem, recipe, C, K0,
                                      table, cluster),
                resident=ring_resident(D, kp, dc, elem))


def loop_plan(B: int, D: int, elem: int, recipe: str, C: int, K0: int,
              table: Optional[CfmTable] = None, extra: bool = False,
              n_sm: int = 132, max_smem: int = 232448) -> dict:
    """The loop kernel's chain-step tile and shared memory a block
    (fused_loop.cu: chain_tile with loop_smem, sized with its events / dense
    switch on; ``extra`` gives the shared memory of that instantiation):
    the largest power of two up to 256 rows whose threads fit LOOP_THREADS,
    whose three (tile, D) slots take at most 96 KB and whose shared memory
    fits, halved while the batch gives fewer than two blocks per SM, down
    to 16."""
    ncg = gemm_dp(D) // GEMM_CN

    def smem(tile, ext):
        return (chain_smem_bytes(tile, D, D, elem, recipe, C, K0, table,
                                 with_dt=False)
                + (2 * tile * D + (4 if ext else 3) * tile) * elem + tile * 4)

    tile = 256
    while tile > LOOP_RM and (tile > LOOP_THREADS
                              or (tile // LOOP_RM) * ncg > LOOP_THREADS
                              or 3 * tile * D * elem > 96 * 1024
                              or smem(tile, True) > max_smem):
        tile //= 2
    while tile > 16 and -(-B // tile) < 2 * n_sm:
        tile //= 2
    return dict(tile=tile, smem=smem(tile, extra),
                resident=ring_resident(D, n_working_terms(recipe, K0), D,
                                       elem))


# the layout of the parameter array (parse_chain_params and the P_*
# offsets in csrc/chain_step.cuh): 16 header values, then fixed-size blocks
_P_NORMS = 16
_P_SUB = _P_NORMS + MAX_KP
_P_NODES = _P_SUB + 9
_P_ALPHA = _P_NODES + MAX_NODES
_P_ALPHA_ERR = _P_ALPHA + MAX_R * MAX_NODES
_P_FORM = _P_ALPHA_ERR + MAX_R * MAX_NODES
_P_LEN = _P_FORM + 4 * MAX_K0


def chain_params(recipe: str, C: int, K0: int, Kp: int, m: int,
                 theta: float, max_squarings: int, norms: Sequence[float],
                 form=None, table: Optional[CfmTable] = None):
    """The chain step's parameters as the kernels read them (``ChainParams``
    in csrc/chain_step.cuh): float64 values in host memory, the Python
    constants of the node and row arithmetic folded here in f64 (the
    kernels round each once to the state's type, as the JAX package's
    weak-typed constants are). ``form``: a :class:`CoeffForm` (its four
    values per term), a :class:`ChebForm` (its kind, length and folded
    interval; the series itself goes to the loop kernel as a device
    table) or None (the per-step kernel samples nothing)."""
    R = n_rows(recipe, table)
    vals = [0.0] * _P_LEN
    vals[:12] = [K0, Kp, RECIPES[recipe], C, R, n_nodes(recipe, C, table),
                 m, max_squarings, theta, _C_MID, _B2,
                 0 if table is None else table.n_err]
    if isinstance(form, ChebForm):
        vals[12:16] = [FORMS["cheb"], form.n_coeffs, *form.folded()]
    vals[_P_NORMS:_P_NORMS + len(norms)] = norms
    for i, (off, ln) in enumerate(zip(_SUB_OFF, _SUB_LEN)):
        vals[_P_SUB + 3 * i:_P_SUB + 3 * i + 3] = [off + 0.5 * ln,
                                                   _C_MID * ln, ln]
    if table is not None:
        vals[_P_NODES:_P_NODES + len(table.c)] = table.c
        for at, mat in ((_P_ALPHA, table.alpha),
                        (_P_ALPHA_ERR, table.alpha_err or ())):
            for i, row in enumerate(mat):
                vals[at + i * MAX_NODES:at + i * MAX_NODES + len(row)] = row
    if isinstance(form, CoeffForm):
        vals[_P_FORM:_P_FORM + 4 * form.n_terms] = form.kernel_array()
    return (ctypes.c_double * _P_LEN)(*vals)


def check_chain_operands(kernel: str, xw, mt, norms, K0: int, recipe: str,
                         C: int, w_row=None,
                         table: Optional[CfmTable] = None) -> int:
    """Raise on what the chain kernels do not take; returns K'."""
    check_recipe(recipe, C, table)
    if xw.device.type != "cuda":
        raise ValueError(f"{kernel}: unsupported device {xw.device}")
    if xw.dtype not in (torch.float32, torch.float64):
        raise TypeError(
            f"{kernel}: the kernel takes float32 or float64, not {xw.dtype}")
    if xw.ndim != 2 or xw.shape[0] < 1:
        raise ValueError(f"{kernel}: xw must be (B, D) with B >= 1, got "
                         f"{tuple(xw.shape)}")
    D = xw.shape[1]
    if D > MAX_WIDTH:
        raise ValueError(f"{kernel}: state width {D} exceeds the kernel's "
                         f"maximum {MAX_WIDTH}")
    if not 1 <= K0 <= MAX_K0:
        raise ValueError(f"{kernel}: the kernel takes 1 to {MAX_K0} basis "
                         f"terms, got {K0}")
    R, J = n_rows(recipe, table), n_nodes(recipe, C, table)
    if R > MAX_R or J > MAX_NODES:
        raise ValueError(
            f"{kernel}: the kernel takes at most {MAX_R} exponentials per "
            f"chain and {MAX_NODES} quadrature nodes, got {R} and {J}")
    Kp = n_working_terms(recipe, K0)
    if mt.shape != (D, Kp * D):
        raise ValueError(f"{kernel}: the stacked basis must be ({D}, "
                         f"{Kp * D}) for {K0} terms, got {tuple(mt.shape)}")
    if len(norms) != Kp:
        raise ValueError(f"{kernel}: norms must hold {Kp} values, got "
                         f"{len(norms)}")
    named = {"mt": mt} if w_row is None else {"mt": mt, "w_row": w_row}
    for name, a in named.items():
        if a.device != xw.device or a.dtype != xw.dtype:
            raise TypeError(f"{kernel}: {name} is {a.dtype} on {a.device}, "
                            f"xw is {xw.dtype} on {xw.device}")
        if not a.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be contiguous")
    if not xw.is_contiguous():
        raise ValueError(f"{kernel}: xw must be contiguous")
    if w_row is not None and w_row.shape != (D,):
        raise ValueError(f"{kernel}: the weight row must be ({D},), got "
                         f"{tuple(w_row.shape)}")
    return Kp


def fused_chain_apply(samples, dt, xw, mt, norms, *, recipe: str, C: int,
                      m: int, theta: float, max_squarings: int = 16,
                      wnorm=None, table: Optional[CfmTable] = None):
    """One chain step (K4) over the whole ensemble: ``samples`` are the
    coefficients at the recipe's nodes (:func:`node_times`), a sequence
    of (B, K0) tensors or one (n_nodes, B, K0) tensor; dt (B,); xw (B, D)
    the widened state; ``mt`` the stacked basis of
    :func:`stacked_transpose` and ``norms`` its terms' 1-norms
    (:func:`basis_norms`, floats); ``wnorm`` a declared norm ``(w_row,
    post, kind)`` or None for l2; ``table`` the :class:`CfmTable` of the
    ``"cfm"`` recipe. Returns (y (B, D), err (B,)); err is zero without an
    error estimate.

    CUDA tensors go to the kernel (float32 or float64, D <= 512, at most
    8 basis terms, 4 exponentials per chain and 8 nodes); anything else it
    does not take raises. CPU tensors run :func:`torch_chain_step`."""
    check_recipe(recipe, C, table)
    want = n_nodes(recipe, C, table)
    if len(samples) != want:
        raise ValueError(f"fused_chain_apply: recipe {recipe!r} samples "
                         f"{want} node(s), got {len(samples)}")
    if all(a.device.type == "cpu" for a in (*samples, dt, xw, mt)):
        y, err = torch_chain_step(
            [g.to(xw.dtype) for g in samples], dt.to(xw.dtype), xw, mt,
            norms, recipe=recipe, C=C, m=m, theta=theta,
            max_squarings=max_squarings, wnorm=wnorm, table=table)
        return y, (torch.zeros_like(dt, dtype=xw.dtype) if err is None
                   else err)
    from .fused_rk import wnorm_on

    wn = wnorm_on(wnorm, xw)
    B, D = xw.shape
    g = samples if isinstance(samples, torch.Tensor) else torch.stack(
        list(samples))
    K0 = g.shape[-1]
    Kp = check_chain_operands("fused_chain_apply", xw, mt, norms, K0,
                              recipe, C, None if wn is None else wn[0],
                              table)
    for name, a, shape in (("samples", g, (want, B, K0)), ("dt", dt, (B,))):
        if a.device != xw.device or a.dtype != xw.dtype:
            raise TypeError(f"fused_chain_apply: {name} is {a.dtype} on "
                            f"{a.device}, xw is {xw.dtype} on {xw.device}")
        if tuple(a.shape) != shape or not a.is_contiguous():
            raise ValueError(f"fused_chain_apply: {name} must be a "
                             f"contiguous {shape}, got {tuple(a.shape)}")
    _build.refuse_grad("fused_chain_apply", g, dt, xw, mt)
    lib = _kernel_lib()
    fn = (lib.vec_ode_chain_expmv_f32 if xw.dtype == torch.float32
          else lib.vec_ode_chain_expmv_f64)
    y = torch.empty_like(xw)
    err = torch.empty_like(dt)
    with torch.cuda.device(xw.device):
        rc = fn(g.data_ptr(), dt.data_ptr(), xw.data_ptr(), mt.data_ptr(),
                y.data_ptr(), err.data_ptr(), B, D,
                chain_params(recipe, C, K0, Kp, m, theta, max_squarings,
                             norms, table=table),
                *kernel_norm_args(wn),
                torch.cuda.current_stream(xw.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"fused_chain_apply: kernel launch failed with CUDA error {rc}")
    fused_chain_apply.launches += 1
    return y, err


fused_chain_apply.launches = 0

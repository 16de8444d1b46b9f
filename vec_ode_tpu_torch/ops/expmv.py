"""The chain-exponential action for modulated operators, the counterpart of
``vec_ode_tpu/ops/pallas_expmv.py``.

For each trajectory b and chain c it computes y[b, c] = e^{A(rows[b, c])} x[b]
with A(row) = sum_k row[k] M_k over a shared working basis M_k (one row per
chain: R = 1), by scaling and a degree-m Taylor chain whose every term is
one (B, D) @ (D, K'D) product with the stacked basis.

* :class:`CoeffForm` declares the coefficient functions a kernel samples
  in-kernel: c_k(t) = a_k + b_k t + c_k cos(w_k t).
* :func:`chain_rows` is the declared row recipe that the kernels build
  from raw inputs (node samples and dt) where the JAX package passes a
  ``cols_builder`` callback: ``"midpoint"``, ``"magnus4"`` (C = 2: the
  order-4 row and the order-2 comparison row; C = 1 without an error
  estimate) and ``"magnus4_fast"`` (``fast_error``: C = 1 and the error
  (sum_k w2_k C_k) y on the advanced state).
* :func:`scale_rows` is the scaling rule of the port: ONE squaring count
  per trajectory and chain row, from that row's 1-norm bound
  sum_k |c_k| ||M_k||_1, s = 0 for a non-finite bound (the JAX package's
  XLA rule); the JAX tiers take one count per batch (XLA) or per kernel
  tile (Pallas), which differs from this only by rounding.
* :func:`torch_chain_step` is the plain twin of one whole step (rows,
  scaling, chains, error measure), the counterpart of ``chain_expmv_xla``
  with the stepper's arithmetic around it.
* :func:`fused_chain_apply` is the wrapper of the hand-written CUDA kernel
  ``csrc/chain_expmv.cu`` (K4): CPU tensors run the twin, CUDA tensors
  launch the kernel or raise. ``fused_chain_apply.launches`` counts the
  launches.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Optional, Sequence

import torch

from . import _build
from .fused_rk import MAX_WIDTH, _step_error_measure, kernel_norm_args

# Gauss-Legendre 2-node half-offset 1/(2 sqrt 3) and the Magnus-4
# commutator weight -sqrt(3)/12: copies of vec_ode_tpu/exp/magnus.py:29-31
_C_MID = 0.5 / math.sqrt(3.0)
_B2 = -math.sqrt(3.0) / 12.0

RECIPES = {"midpoint": 0, "magnus4": 1, "magnus4_fast": 2}
# the kernels' limit (csrc/chain_step.cuh): at most MAX_K0 basis terms, so
# a working basis of at most 3 terms (K0, plus their K0 (K0 - 1) / 2
# commutators for the Magnus recipes); both models have two
MAX_K0 = 2


@dataclasses.dataclass(frozen=True)
class CoeffForm:
    """Declared coefficient functions c_k(t) = a_k + b_k t + c_k cos(w_k t),
    k < K, which a kernel evaluates in-kernel at its quadrature nodes (it
    cannot run a Python ``coeff_fn``). The terms whose factor is zero are
    left out and the rest added in the order a, b t, c cos(w t), with
    w t rounded before the cosine, so that ``DrivenDense.modulated``
    ([1, cos(w t)]) and ``LandauZener.modulated`` ([v t, delta]) give the
    JAX package's ``coeff_cols`` in the state's type."""

    a: tuple
    b: tuple
    c: tuple
    w: tuple

    def __post_init__(self):
        cols = [tuple(float(v) for v in getattr(self, f))
                for f in ("a", "b", "c", "w")]
        if len({len(col) for col in cols}) != 1 or not cols[0]:
            raise ValueError("CoeffForm: a, b, c and w need one entry per "
                             "basis term")
        for f, col in zip(("a", "b", "c", "w"), cols):
            object.__setattr__(self, f, col)

    @property
    def n_terms(self) -> int:
        return len(self.a)

    def sample(self, t: torch.Tensor) -> torch.Tensor:
        """The coefficients at times ``t`` (...,): a (..., K) tensor in t's
        type."""
        cols = []
        for a, b, c, w in zip(self.a, self.b, self.c, self.w):
            col = torch.full_like(t, a) if a != 0.0 else None
            if b != 0.0:
                col = b * t if col is None else col + b * t
            if c != 0.0:
                ct = c * torch.cos(w * t)
                col = ct if col is None else col + ct
            cols.append(torch.zeros_like(t) if col is None else col)
        return torch.stack(cols, dim=-1)

    def kernel_array(self) -> list:
        """(a_k, b_k, c_k, w_k) per term, flat, as the kernels read it."""
        return [v for k in range(self.n_terms)
                for v in (self.a[k], self.b[k], self.c[k], self.w[k])]


def pairs_of(K0: int) -> list:
    """The commutator pairs (j, k), j < k, in the order of the extended
    basis (``ModulatedOperator.commutator_extension``)."""
    return [(j, k) for j in range(K0) for k in range(j + 1, K0)]


def n_working_terms(recipe: str, K0: int) -> int:
    """K': the basis terms a recipe's rows span."""
    return K0 if recipe == "midpoint" else K0 + len(pairs_of(K0))


def check_recipe(recipe: str, C: int) -> None:
    if recipe not in RECIPES:
        raise ValueError(f"unknown chain recipe {recipe!r}; one of "
                         f"{sorted(RECIPES)}")
    if C not in (1, 2) or (C == 2 and recipe != "magnus4"):
        raise ValueError(f"recipe {recipe!r} takes C = 1"
                         + (" or 2" if recipe == "magnus4" else "")
                         + f", got C = {C}")


def has_error_estimate(recipe: str, C: int) -> bool:
    """Whether a recipe's step estimates its error: two chains, or
    ``magnus4_fast``."""
    return C == 2 or recipe == "magnus4_fast"


def node_times(recipe: str, t, dt) -> list:
    """The quadrature nodes of one step from t over dt: the midpoint
    t + dt/2, or the two Gauss-Legendre nodes tm -/+ _C_MID dt around
    tm = t + dt/2 (exp/modulated.py's step_fn and step_cols)."""
    tm = t + 0.5 * dt
    if recipe == "midpoint":
        return [tm]
    return [tm - _C_MID * dt, tm + _C_MID * dt]


def chain_rows(recipe: str, samples: Sequence[torch.Tensor], dt, C: int):
    """Coefficient rows (B, C, K') from the node samples (each (B, K0)) and
    dt (B,), in the JAX package's arithmetic order: midpoint dt g;
    Magnus-4 w1 = (dt/2)(g1 + g2) and w2 = (_B2 dt dt)(g1_j g2_k -
    g1_k g2_j), chain 0 = [w1, w2], chain 1 (C = 2) = [w1, 0]."""
    dt1 = dt[:, None]
    if recipe == "midpoint":
        return (dt1 * samples[0])[:, None]
    g1, g2 = samples
    w1 = 0.5 * dt1 * (g1 + g2)
    pairs = pairs_of(g1.shape[1])
    if pairs:
        j = [p[0] for p in pairs]
        k = [p[1] for p in pairs]
        w2 = (_B2 * dt1 * dt1) * (g1[:, j] * g2[:, k] - g1[:, k] * g2[:, j])
    else:
        w2 = w1[:, :0]
    main = torch.cat([w1, w2], dim=1)
    if C == 1:
        return main[:, None]
    return torch.stack([main, torch.cat([w1, torch.zeros_like(w2)], 1)], 1)


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


def torch_chain_expmv(cs, n_pass, xw, mt, *, m: int) -> list:
    """Plain twin of the chain action: for each chain c, n_pass[b, c]
    passes of the degree-m Taylor polynomial of sum_k cs[b, c, k] M_k on
    xw[b], each term one (B, D) @ (D, K'D) product with ``mt`` = [M_0^T |
    ... | M_{K'-1}^T], combined in k order and divided by the term's
    index (chain_expmv_xla's arithmetic). Rows past their pass count keep
    their value. Returns the C results (B, D)."""
    D = xw.shape[1]
    outs = []
    for c in range(cs.shape[1]):
        csc, npc = cs[:, c], n_pass[:, c]
        v = xw
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
                     wnorm=None, scaled=None):
    """One whole chain step in plain torch, what the kernels compute: the
    rows of ``recipe`` from the node ``samples`` and dt, the per-row
    scaling, the chains from xw, and the error measure of
    ``fused_rk._step_error_measure`` (``scaled=(atol, rtol)`` or a declared
    ``wnorm``) of chain1 - chain0 (C = 2) or of ``magnus4_fast``'s
    (sum_{k >= K0} w2_k M_k) y. Returns (y (B, D), err (B,) or None)."""
    rows = chain_rows(recipe, samples, dt, C)
    cs, n_pass = scale_rows(rows, norms, theta, max_squarings)
    outs = torch_chain_expmv(cs, n_pass, xw, mt, m=m)
    y = outs[0]
    if C == 2:
        dv = outs[1] - y
    elif recipe == "magnus4_fast":
        D, K0 = xw.shape[1], samples[0].shape[1]
        mv = y @ mt
        dv = None
        for k in range(K0, rows.shape[-1]):
            part = rows[:, 0, k:k + 1] * mv[:, k * D:(k + 1) * D]
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
        fn.argtypes = [vp, vp, vp, vp, vp, vp, vp, ci, ci,
                       ctypes.POINTER(cd), vp, cd, ci, vp]
    return lib


def chain_params(recipe: str, C: int, K0: int, Kp: int, m: int,
                 theta: float, max_squarings: int, norms: Sequence[float],
                 form: Optional[CoeffForm] = None):
    """The chain step's parameters as the kernels read them (``ChainParams``
    in csrc/chain_step.cuh): float64 values in host memory."""
    vals = [K0, Kp, RECIPES[recipe], C, m, max_squarings, theta, _C_MID, _B2,
            *norms]
    if form is not None:
        vals += form.kernel_array()
    return (ctypes.c_double * len(vals))(*vals)


def check_chain_operands(kernel: str, xw, mt, norms, K0: int, recipe: str,
                         C: int, w_row=None) -> int:
    """Raise on what the chain kernels do not take; returns K'."""
    check_recipe(recipe, C)
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


def fused_chain_apply(samples: Sequence[torch.Tensor], dt, xw, mt, norms, *,
                      recipe: str, C: int, m: int, theta: float,
                      max_squarings: int = 16, wnorm=None):
    """One chain step (K4) over the whole ensemble: ``samples`` are the
    coefficients at the recipe's nodes (:func:`node_times`), each (B, K0);
    dt (B,); xw (B, D) the widened state; ``mt`` the stacked basis of
    :func:`stacked_transpose` and ``norms`` its terms' 1-norms
    (:func:`basis_norms`, floats); ``wnorm``
    a declared norm ``(w_row, post, kind)`` or None for l2. Returns
    (y (B, D), err (B,)); err is zero without an error estimate.

    CUDA tensors go to the kernel (float32 or float64, D <= 512, at most
    2 basis terms); anything else it does not take raises. CPU tensors run
    :func:`torch_chain_step`."""
    check_recipe(recipe, C)
    n_nodes = 1 if recipe == "midpoint" else 2
    if len(samples) != n_nodes:
        raise ValueError(f"fused_chain_apply: recipe {recipe!r} samples "
                         f"{n_nodes} node(s), got {len(samples)}")
    if all(a.device.type == "cpu" for a in (*samples, dt, xw, mt)):
        y, err = torch_chain_step(
            [g.to(xw.dtype) for g in samples], dt.to(xw.dtype), xw, mt,
            norms, recipe=recipe, C=C, m=m, theta=theta,
            max_squarings=max_squarings, wnorm=wnorm)
        return y, (torch.zeros_like(dt, dtype=xw.dtype) if err is None
                   else err)
    from .fused_rk import wnorm_on

    wn = wnorm_on(wnorm, xw)
    B, D = xw.shape
    K0 = samples[0].shape[-1]
    Kp = check_chain_operands("fused_chain_apply", xw, mt, norms, K0,
                              recipe, C, None if wn is None else wn[0])
    for name, a, shape in (*((f"samples[{i}]", g, (B, K0))
                             for i, g in enumerate(samples)),
                           ("dt", dt, (B,))):
        if a.device != xw.device or a.dtype != xw.dtype:
            raise TypeError(f"fused_chain_apply: {name} is {a.dtype} on "
                            f"{a.device}, xw is {xw.dtype} on {xw.device}")
        if tuple(a.shape) != shape or not a.is_contiguous():
            raise ValueError(f"fused_chain_apply: {name} must be a "
                             f"contiguous {shape}, got {tuple(a.shape)}")
    lib = _kernel_lib()
    fn = (lib.vec_ode_chain_expmv_f32 if xw.dtype == torch.float32
          else lib.vec_ode_chain_expmv_f64)
    y = torch.empty_like(xw)
    err = torch.empty_like(dt)
    with torch.cuda.device(xw.device):
        rc = fn(samples[0].data_ptr(),
                samples[1].data_ptr() if n_nodes == 2 else None,
                dt.data_ptr(), xw.data_ptr(), mt.data_ptr(), y.data_ptr(),
                err.data_ptr(), B, D,
                chain_params(recipe, C, K0, Kp, m, theta, max_squarings,
                             norms),
                *kernel_norm_args(wn),
                torch.cuda.current_stream(xw.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"fused_chain_apply: kernel launch failed with CUDA error {rc}")
    fused_chain_apply.launches += 1
    return y, err


fused_chain_apply.launches = 0

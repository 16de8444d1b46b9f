"""Structure recovery for black-box operator callbacks, the counterpart of
``vec_ode_tpu/exp/auto.py``.

The reference's exponential solvers see only an opaque callback
``op_fn(t) -> A(t)`` (magnus.rs:32, cfm.rs:54). Most physical operators
live in a small matrix subspace, A(t) = sum_k c_k(t) M_k with K small.
:func:`auto_modulated` recovers that structure from the black box alone:
it samples A(t) at probe times, takes the SVD of the samples over the
real vector space of (re, im) matrix pairs, keeps the numerical row space
and checks it at held-out times. It returns a
:class:`~vec_ode_tpu_torch.exp.modulated.ModulatedOperator` whose
``coeff_fn`` projects A(t) onto the recovered orthonormal basis, so the
shared-basis steppers (``MagnusModulated4``, ``CFM4Modulated``, ...) run
over the chain kernel K4 per step; and, where a Chebyshev fit of the
coefficients reconstructs A(t) at held-out times, a declared
:class:`~vec_ode_tpu_torch.ops.expmv.ChebForm` that the loop kernel
samples in-kernel (K2 with K5). Where the structure is not there it
returns None, and the caller keeps the generic dense steppers (K9).

Setup runs on the host in numpy float64, line for line as the JAX
package: the same probe grid and golden-ratio validation times, SVD, rank
rule, held-out validation, Chebyshev-Gauss fit, 1e-12 tail truncation and
refit validation, so both packages recover the same K (and the same basis
up to a sign per direction) from the same callback.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..ops.cplx import Cplx
from ..ops.expmv import ChebForm
from .modulated import ModulatedOperator

__all__ = ["auto_modulated"]

_PHI = 0.6180339887498949


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.float64)


def _vec_host(L, is_cplx: bool) -> np.ndarray:
    """vec(A) as float64: [re | im] flattened for a Cplx pair."""
    if is_cplx:
        return np.concatenate([_host(L.re).ravel(), _host(L.im).ravel()])
    return _host(L).ravel()


def _vec_rows(L, is_cplx: bool, n: int) -> torch.Tensor:
    """vec(A) of n stacked operators (n, d, d): (n, n_vec)."""
    if is_cplx:
        return torch.cat([L.re.reshape(n, -1), L.im.reshape(n, -1)], dim=1)
    return L.reshape(n, -1)


def _check_no_tf32(v: torch.Tensor) -> None:
    if (v.is_cuda and v.dtype == torch.float32
            and torch.backends.cuda.matmul.allow_tf32):
        raise RuntimeError(
            "auto_modulated: the projection onto the recovered basis needs "
            "IEEE float32 products; set "
            "torch.backends.cuda.matmul.allow_tf32 = False")


def auto_modulated(op_fn: Callable, t0: float, tf: float, *,
                   k_max: int = 8, n_probe: Optional[int] = None,
                   rank_tol: float = 1e-7, validate_tol: float = 1e-5,
                   dtype=None, fit_cols: bool = True, cols_deg: int = 64,
                   cols_tol: Optional[float] = None,
                   device="cuda") -> Optional[ModulatedOperator]:
    """Recover A(t) = sum_k c_k(t) M_k from a black-box ``op_fn(t) -> L``
    (L a Cplx (d, d) pair or a real (d, d) tensor; t a Python float at
    setup, a tensor under ``torch.func.vmap`` in ``coeff_fn``).

    Returns a ModulatedOperator whose basis (in ``dtype``, default the
    samples' type, on ``device``, the card unless it names another) is
    the recovered orthonormal directions, or None when the operator's
    range over [t0, tf] is not numerically inside a subspace of at most
    ``k_max`` matrices (or is zero, or not finite): keep the generic
    dense stepper then. ``coeff_fn(t)`` evaluates ``op_fn`` at the times
    (one ``torch.func.vmap`` over the stacked times) and projects: one
    (N, n_vec) @ (n_vec, K) product in IEEE float32 or float64 (it raises
    where TF32 is enabled for float32 products).

    ``fit_cols=True`` also fits each recovered coefficient over [t0, tf]
    by a Chebyshev series of degree ``cols_deg`` (the tail below 1e-12 of
    the largest coefficient cut) and, only if the refit operator
    reconstructs ``op_fn`` at held-out times to ``cols_tol`` (default
    ``validate_tol``), declares it as the operator's ``form``, a
    :class:`ChebForm` valid on [t0, tf] only, which sends the solve to
    the whole-loop kernel; a failed fit leaves ``form=None`` and the
    per-step path. Runs ``op_fn`` on the host at setup: call it once,
    outside any loop."""
    if n_probe is None:
        n_probe = 2 * k_max + 8
    t0f, tff = float(t0), float(tf)
    # probe grid: uniform, and golden-ratio offsets held out for the
    # validation (an equispaced grid alone can alias periodic coefficients)
    ts_fit = np.linspace(t0f, tff, n_probe)
    ts_val = t0f + ((np.arange(1, k_max + 5) * _PHI) % 1.0) * (tff - t0f)

    sample0 = op_fn(float(ts_fit[0]))
    is_cplx = isinstance(sample0, Cplx)
    leaf = torch.as_tensor(sample0.re if is_cplx else sample0)
    if dtype is None:
        dtype = leaf.dtype
    d = leaf.shape[-1]

    S = np.stack([_vec_host(sample0, is_cplx)]
                 + [_vec_host(op_fn(float(t)), is_cplx) for t in ts_fit[1:]])
    if not np.all(np.isfinite(S)):
        return None
    _, sig, Vt = np.linalg.svd(S, full_matrices=False)
    if sig.size == 0 or sig[0] == 0.0:
        return None  # the zero operator: nothing to modulate
    K = int(np.sum(sig > rank_tol * sig[0]))
    if K == 0 or K > k_max:
        return None
    V = Vt[:K]  # (K, n_vec), orthonormal rows

    # the projection must reconstruct A(t) at the held-out times
    for t in ts_val:
        v = _vec_host(op_fn(float(t)), is_cplx)
        nrm = np.linalg.norm(v)
        if nrm == 0.0:
            continue
        resid = np.linalg.norm(v - V.T @ (V @ v)) / nrm
        if not np.isfinite(resid) or resid > validate_tol:
            return None

    def tensor(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)

    if is_cplx:
        basis = Cplx(tensor(V[:, :d * d].reshape(K, d, d)),
                     tensor(V[:, d * d:].reshape(K, d, d)))
    else:
        basis = tensor(V.reshape(K, d, d))
    V_t = tensor(V.T)  # (n_vec, K)

    def coeff_fn(t):
        if isinstance(t, torch.Tensor) and t.ndim > 0:
            flat = t.reshape(-1)
            L = torch.func.vmap(op_fn)(flat)
            v = _vec_rows(L, is_cplx, flat.shape[0]).to(dtype)
            _check_no_tf32(v)
            return (v @ V_t).reshape(*t.shape, K)
        v = _vec_rows(op_fn(t), is_cplx, 1).to(dtype)
        _check_no_tf32(v)
        return (v @ V_t)[0]

    form = None
    if fit_cols:
        form = _fit_coeff_cols(
            op_fn, V, t0f, tff, is_cplx, deg=cols_deg,
            tol=validate_tol if cols_tol is None else cols_tol)
    return ModulatedOperator(basis=basis, coeff_fn=coeff_fn, form=form)


def _fit_coeff_cols(op_fn, V, t0f, tff, is_cplx, *, deg,
                    tol) -> Optional[ChebForm]:
    """The Chebyshev fit of the projected coefficients c(t) = V vec(A(t))
    over [t0, tf] at Chebyshev-Gauss points, as a declared ChebForm, or
    None when the refit operator does not reconstruct ``op_fn`` at
    held-out times to ``tol`` (or the samples are not finite)."""
    from numpy.polynomial import chebyshev as _cheb

    n_fit = max(2 * deg + 2, 96)
    u_fit = np.cos(np.pi * (2 * np.arange(n_fit) + 1) / (2 * n_fit))
    ts = 0.5 * (t0f + tff) + 0.5 * (tff - t0f) * u_fit
    C = np.stack([V @ _vec_host(op_fn(float(t)), is_cplx) for t in ts])
    if not np.all(np.isfinite(C)):
        return None
    series = _cheb.chebfit(u_fit, C, deg)  # (deg + 1, K)
    # cut the tail: keep the terms above roundoff of the largest
    mags = np.max(np.abs(series), axis=1)
    keep = np.nonzero(mags > 1e-12 * max(mags.max(), 1e-300))[0]
    series = series[:1] if keep.size == 0 else series[:keep[-1] + 1]
    # held-out validation of the refit operator, at golden-ratio times
    scale = 0.0
    for t in t0f + ((np.arange(1, deg // 2 + 6) * _PHI) % 1.0) * (tff - t0f):
        v = _vec_host(op_fn(float(t)), is_cplx)
        u = (2.0 * t - (t0f + tff)) / (tff - t0f)
        c_fit = _cheb.chebval(u, series)  # (K,)
        resid = np.linalg.norm(v - V.T @ c_fit)
        nrm = np.linalg.norm(v)
        scale = max(scale, nrm)
        if nrm > 0.0 and (not np.isfinite(resid) or resid > tol * nrm):
            return None
    if scale == 0.0:
        return None
    return ChebForm(series, t0f, tff)

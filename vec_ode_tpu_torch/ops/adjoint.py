"""The reversible adjoint's exponential actions, the counterpart of
``vec_ode_tpu/ops/pallas_expmv.py:320-664``.

One reverse row of the adjoint over a shared working basis W_k, with
A = sum_k c_k W_k, takes the state x_{n+1} and its cotangent a_{n+1} to

    x_n   = e^{-A} x_{n+1}                    (reconstruction)
    a_n   = e^{A^T} a_{n+1}                   (cotangent transport)
    cbar_k = <a_{n+1}, D_{W_k} e^{A} x_n>      (coefficient cotangents)

The Fréchet derivatives come from the block-triangular recurrence of
``_adjoint_row_chains`` (``pallas_expmv.py:347-417``): for the augmented
vector (u_k; w) one Taylor term is u_k' = (A u_k + 2^-s W_k w) / j with
the w-chain w' = (A w) / j shared by all K' directions, so a term costs
K'^2 + K' actions (the w-chain's K' actions serve both), not the (2D)-wide
embedding of ``vec_ode_tpu/diff.py:703-716``.

Scaling follows the port's rule (``ops/expmv.scale_rows``): one squaring
count per row (per trajectory and row for per-lane rows), from the bound
sum_k |c_k| ||W_k||_1 alone; the Fréchet series is linear in its
direction, so the direction adds nothing to the count
(``_adjoint_row_scaling``, ``pallas_expmv.py:330-344``). The TPU sweep
kernels' single count over all rows (``_global_scaling``) is not copied:
the JAX package's XLA path takes one count per row too.

Three kernels, each a wrapper and a plain twin with the kernel's
arithmetic (K6 and K8: every Taylor term one (B, D) @ (D, K'D) product
with ``mt`` = [W_0^T | ...] for W v, or ``ms`` = [W_0 | ...] for W^T v;
the K' actions combined in k order and divided by the term's index):

* K6 :func:`adjoint_bwd` (twin :func:`torch_adjoint_row`): one reverse
  row with per-lane coefficients (B, K');
* K7 :func:`adjoint_sweep_fwd` (twin :func:`torch_adjoint_sweep_fwd`):
  all R rows of a fixed-step forward, y = e^{A_{R-1}} ... e^{A_0} x; the
  rows are shared by the batch, so each row's exponent A^T = sum_k cs_k
  W_k^T is formed once (:func:`_exponent`, k order) and every Taylor term
  is one (B, D) @ (D, D) product with it (the TPU kernel's sum of K'
  actions, to rounding);
* K8 :func:`adjoint_sweep_bwd` (twin :func:`torch_adjoint_sweep_bwd`):
  the whole reverse sweep, a0 and the batch-summed cbar (R, K').

CPU tensors run the twin; CUDA tensors launch the kernel of
``csrc/adjoint.cu`` or raise. Each wrapper counts its launches
(``.launches``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

from . import _build
from .expmv import (GEMM_CN, GEMM_RM, GEMM_THREADS, _align16, gemm_dp,
                    gemm_jc, scale_rows)
from .fused_rk import MAX_WIDTH

# the kernels' limit on the working basis (csrc/adjoint_row.cuh:
# ADJ_MAX_KP): K' = 3 for one control at order 4, 6 for two
MAX_KP = 6


def _combine(coeffs, mv, D: int):
    """sum_k coeffs[:, k] * mv[:, kD:(k+1)D], in k order."""
    w = None
    for k in range(coeffs.shape[1]):
        part = coeffs[:, k:k + 1] * mv[:, k * D:(k + 1) * D]
        w = part if w is None else w + part
    return w


def _taylor_chain(v, coeffs, mat, n_pass, m: int):
    """n_pass[b] passes of the degree-m Taylor polynomial of sum_k
    coeffs[b, k] M_k on v[b], ``mat`` the stacked operand of the action;
    rows past their count keep their value."""
    D = v.shape[1]
    for p in range(int(n_pass.max())):
        acc = term = v
        for j in range(1, m + 1):
            term = _combine(coeffs, term @ mat, D) / j
            acc = acc + term
        v = torch.where((n_pass > p)[:, None], acc, v)
    return v


def _frechet_chains(x_n, cs, scale, mt, n_pass, m: int) -> list:
    """u_k = D_{W_k} e^{A} x_n for every k by the shared-w recurrence (see
    the module note), cs the scaled rows (B, K'), scale = 2^-s (B,)."""
    B, D = x_n.shape
    Kp = cs.shape[1]
    us = [torch.zeros_like(x_n) for _ in range(Kp)]
    w = x_n
    for p in range(int(n_pass.max())):
        acc_u, term_u = list(us), list(us)
        acc_w = term_w = w
        for j in range(1, m + 1):
            mw = term_w @ mt
            new_u = []
            for k in range(Kp):
                base = _combine(cs, term_u[k] @ mt, D)
                base = base + scale[:, None] * mw[:, k * D:(k + 1) * D]
                new_u.append(base / j)
            term_w = _combine(cs, mw, D) / j
            acc_w = acc_w + term_w
            acc_u = [acc_u[k] + new_u[k] for k in range(Kp)]
            term_u = new_u
        live = (n_pass > p)[:, None]
        us = [torch.where(live, acc_u[k], us[k]) for k in range(Kp)]
        w = torch.where(live, acc_w, w)
    return us


def _row(cs, scale, n_pass, x, a, mt, ms, m: int):
    """One reverse row from the scaled rows cs (B, K'): (x_n, a_n, cbar
    (B, K')), cbar_k = <a, u_k> per lane."""
    x_n = _taylor_chain(x, -cs, mt, n_pass, m)
    a_n = _taylor_chain(a, cs, ms, n_pass, m)
    us = _frechet_chains(x_n, cs, scale, mt, n_pass, m)
    cb = torch.stack([(a * u).sum(-1) for u in us], dim=-1)
    return x_n, a_n, cb


def _scaled(c, norms, theta: float, max_squarings: int):
    """(c / 2^s, 2^-s, 2^s) per row of c (..., K') by the port's rule."""
    cs, n_pass = scale_rows(c[..., None, :], norms, theta, max_squarings)
    n_pass = n_pass[..., 0]
    return cs[..., 0, :], 1.0 / n_pass.to(c.dtype), n_pass


def torch_adjoint_row(c, x, a, mt, ms, norms, *, m: int, theta: float,
                      max_squarings: int = 16):
    """Plain twin of K6: one reverse row with per-lane rows c (B, K') on
    x, a (B, D); one squaring count per lane. Returns (x_n, a_n, cbar
    (B, K'))."""
    cs, scale, n_pass = _scaled(c, norms, theta, max_squarings)
    return _row(cs, scale, n_pass, x, a, mt, ms, m)


def _shared_rows(c_all, B: int, norms, theta, max_squarings):
    """The scaled rows of a sweep, each broadcast over the batch: a list
    of (cs (B, K'), scale (B,), n_pass (B,))."""
    cs, scale, n_pass = _scaled(c_all, norms, theta, max_squarings)
    return [(cs[r].expand(B, -1), scale[r].expand(B), n_pass[r].expand(B))
            for r in range(c_all.shape[0])]


def _exponent(cs, mt, D: int):
    """A^T = sum_k cs[k] W_k^T, (D, D), from ``mt``'s K' blocks in k order:
    the matrix K7 forms in shared memory, bit for bit."""
    at = None
    for k in range(cs.shape[0]):
        part = cs[k] * mt[:, k * D:(k + 1) * D]
        at = part if at is None else at + part
    return at


def torch_adjoint_sweep_fwd(c_all, x, mt, norms, *, m: int, theta: float,
                            max_squarings: int = 16):
    """Plain twin of K7: y = e^{A_{R-1}} ... e^{A_0} x with the rows c_all
    (R, K') shared by the batch x (B, D), one squaring count per row: per
    row its exponent (:func:`_exponent`), then 2^s passes of the degree-m
    Taylor polynomial, each term one product with it."""
    D = x.shape[1]
    cs, _, n_pass = _scaled(c_all, norms, theta, max_squarings)
    for r, passes in enumerate(n_pass.tolist()):
        at = _exponent(cs[r], mt, D)
        for _ in range(passes):
            acc = term = x
            for j in range(1, m + 1):
                term = (term @ at) / j
                acc = acc + term
            x = acc
    return x


def torch_adjoint_sweep_bwd(c_all, x_final, a_final, mt, ms, norms, *,
                            m: int, theta: float, max_squarings: int = 16):
    """Plain twin of K8: the reverse sweep over the rows c_all (R, K') from
    the final state and its cotangent (B, D). Returns (a0 (B, D), cbar
    (R, K') summed over the batch)."""
    rows = _shared_rows(c_all, x_final.shape[0], norms, theta,
                        max_squarings)
    x, a = x_final, a_final
    cbar = [None] * len(rows)
    for r in range(len(rows) - 1, -1, -1):
        x, a_n, cb = _row(*rows[r], x, a, mt, ms, m)
        cbar[r] = cb.sum(0)
        a = a_n
    if not cbar:
        return a, c_all.new_zeros((0, c_all.shape[-1]))
    return a, torch.stack(cbar)


@functools.cache
def _kernel_lib() -> ctypes.CDLL:
    """The library of K6, K7 and K8, built on first use, with its entry
    points' argument types set."""
    lib = _build.load("adjoint")
    vp, ci, cd = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    pd = ctypes.POINTER(cd)
    for t in ("f32", "f64"):
        fn = getattr(lib, f"vec_ode_adjoint_bwd_{t}")
        fn.restype = ci
        fn.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, ci, ci, ci, pd, ci,
                       cd, ci, vp]
        fn = getattr(lib, f"vec_ode_adjoint_sweep_fwd_{t}")
        fn.restype = ci
        fn.argtypes = [vp, ci, vp, vp, vp, ci, ci, ci, pd, ci, cd, ci, vp]
        fn = getattr(lib, f"vec_ode_adjoint_sweep_bwd_{t}")
        fn.restype = ci
        fn.argtypes = [vp, ci, vp, vp, vp, vp, vp, vp, ci, ci, ci, pd, ci,
                       cd, ci, vp]
    lib.vec_ode_adjoint_blocks.restype = ci
    lib.vec_ode_adjoint_blocks.argtypes = [ci, ci, ci, ci]
    return lib


# K7's plans and limits (csrc/adjoint.cu: SWEEP_*): both exponents in
# shared memory, one formed between rows, or panels formed every term
SWEEP_PLANS = ("double", "single", "panel")
SWEEP_PRODUCER_WARPS = 4
SWEEP_MAX_TILE = 64


def sweep_smem_bytes(plan: str, tile: int, ks: int, D: int,
                     elem: int) -> int:
    """K7's shared memory (csrc/adjoint.cu: SweepLayout): the exponent or
    its panel, the second exponent, the term rows of DP + 4 values, the
    partial products of ks - 1 contraction groups."""
    row, trow = gemm_dp(D) * elem, (gemm_dp(D) + GEMM_CN) * elem
    a = (gemm_jc(D, elem) if plan == "panel" else D) * row
    return (_align16(a) + (_align16(D * row) if plan == "double" else 0)
            + _align16(tile * trow) + _align16((ks - 1) * tile * trow))


def sweep_plan(B: int, D: int, elem: int, n_sm: int = 132,
               max_smem: int = 232448) -> dict:
    """K7's launch shape (csrc/adjoint.cu: sweep_shape) on a card of
    ``n_sm`` SMs with ``max_smem`` bytes of shared memory a block (an
    H100's by default): {plan, tile, rm, ks, threads, smem} (rm rows a
    thread, ks contraction groups), or None where no shape fits."""
    ncg = gemm_dp(D) // GEMM_CN
    rm_max = GEMM_RM[elem]
    tile = SWEEP_MAX_TILE
    while tile > 1 and -(-B // tile) < n_sm // 2:
        tile //= 2
    while True:
        rm = 1
        while rm < rm_max and rm < tile and (tile // rm) * ncg > GEMM_THREADS:
            rm *= 2
        per = (tile // rm) * ncg
        if per <= GEMM_THREADS:
            for plan in SWEEP_PLANS:
                ks = 1
                while (plan != "panel" and ks < 8
                       and 2 * ks * per <= GEMM_THREADS and D >= 32 * ks):
                    ks *= 2
                smem = sweep_smem_bytes(plan, tile, ks, D, elem)
                if smem <= max_smem:
                    nc = -(-ks * per // 32) * 32
                    if plan == "double":
                        nc += 32 * SWEEP_PRODUCER_WARPS
                    return dict(plan=plan, tile=tile, rm=rm, ks=ks,
                                threads=nc, smem=smem)
        if tile == 1:
            return None
        tile //= 2


def _check(kernel: str, x, mats: dict, norms, rows, n_rows: int) -> int:
    """Raise on what the adjoint kernels do not take; returns K'."""
    if x.device.type != "cuda":
        raise ValueError(f"{kernel}: unsupported device {x.device}")
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(
            f"{kernel}: the kernel takes float32 or float64, not {x.dtype}")
    if x.ndim != 2 or x.shape[0] < 1:
        raise ValueError(f"{kernel}: states must be (B, D) with B >= 1, got "
                         f"{tuple(x.shape)}")
    D = x.shape[1]
    Kp = rows.shape[-1]
    if not 1 <= D <= MAX_WIDTH or not 1 <= Kp <= MAX_KP:
        raise ValueError(
            f"{kernel}: the kernel takes a state width D <= {MAX_WIDTH} and "
            f"1 to {MAX_KP} basis terms, got D = {D}, K' = {Kp} (K' > "
            f"{MAX_KP}, an operator of four or more terms at order 4, is "
            "ROADMAP queue 2's 'K6, K' > 6')")
    if rows.shape != (n_rows, Kp):
        raise ValueError(f"{kernel}: the rows must be ({n_rows}, {Kp}), got "
                         f"{tuple(rows.shape)}")
    if len(norms) != Kp:
        raise ValueError(f"{kernel}: norms must hold {Kp} values, got "
                         f"{len(norms)}")
    for name, t in (("rows", rows), *mats.items()):
        if t.device != x.device or t.dtype != x.dtype:
            raise TypeError(f"{kernel}: {name} is {t.dtype} on {t.device}, "
                            f"the states are {x.dtype} on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be contiguous")
        if name in ("mt", "ms") and t.shape != (D, Kp * D):
            raise ValueError(f"{kernel}: {name} must be ({D}, {Kp * D}), "
                             f"got {tuple(t.shape)}")
        if name in ("x", "a") and t.shape != x.shape:
            raise ValueError(f"{kernel}: {name} must be {tuple(x.shape)}, "
                             f"got {tuple(t.shape)}")
    return Kp


def _raise_on(kernel: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(
            f"{kernel}: kernel launch failed with CUDA error {rc}")


def _on_cpu(*ts) -> bool:
    return all(t.device.type == "cpu" for t in ts)


def _params(norms: Sequence[float]):
    return (ctypes.c_double * len(norms))(*norms)


def adjoint_bwd(c, x_next, a_next, mt, ms, norms, *, m: int, theta: float,
                max_squarings: int = 16):
    """K6: one reverse row with per-lane rows c (B, K') on x_next, a_next
    (B, D); ``mt`` / ``ms`` from ``expmv.stacked_transpose`` /
    ``stacked_basis`` of the working basis, ``norms`` its K' 1-norms
    (floats). Returns (x_n, a_n, cbar (B, K')). CUDA tensors go to the
    kernel (float32 or float64, D <= 512, K' <= 6); CPU tensors run
    :func:`torch_adjoint_row`."""
    if _on_cpu(c, x_next, a_next, mt, ms):
        return torch_adjoint_row(c, x_next, a_next, mt, ms, norms, m=m,
                                 theta=theta, max_squarings=max_squarings)
    B = x_next.shape[0] if x_next.ndim == 2 else 0
    Kp = _check("adjoint_bwd", x_next, {"x": x_next, "a": a_next, "mt": mt,
                                        "ms": ms}, norms, c, B)
    D = x_next.shape[1]
    fn = getattr(_kernel_lib(), "vec_ode_adjoint_bwd_"
                 + ("f32" if x_next.dtype == torch.float32 else "f64"))
    x_n, a_n = torch.empty_like(x_next), torch.empty_like(a_next)
    cb = torch.empty_like(c)
    with torch.cuda.device(x_next.device):
        rc = fn(c.data_ptr(), x_next.data_ptr(), a_next.data_ptr(),
                mt.data_ptr(), ms.data_ptr(), x_n.data_ptr(), a_n.data_ptr(),
                cb.data_ptr(), B, D, Kp, _params(norms), m, theta,
                max_squarings,
                torch.cuda.current_stream(x_next.device).cuda_stream)
    _raise_on("adjoint_bwd", rc)
    adjoint_bwd.launches += 1
    return x_n, a_n, cb


adjoint_bwd.launches = 0


def adjoint_sweep_fwd(c_all, x, mt, norms, *, m: int, theta: float,
                      max_squarings: int = 16):
    """K7: all R rows c_all (R, K') of a fixed-step forward on x (B, D) in
    one launch (its shape: :func:`sweep_plan`). Returns y (B, D). CPU
    tensors run :func:`torch_adjoint_sweep_fwd`."""
    if _on_cpu(c_all, x, mt):
        return torch_adjoint_sweep_fwd(c_all, x, mt, norms, m=m, theta=theta,
                                       max_squarings=max_squarings)
    R = c_all.shape[0] if c_all.ndim == 2 else -1
    Kp = _check("adjoint_sweep_fwd", x, {"x": x, "mt": mt}, norms, c_all, R)
    B, D = x.shape
    fn = getattr(_kernel_lib(), "vec_ode_adjoint_sweep_fwd_"
                 + ("f32" if x.dtype == torch.float32 else "f64"))
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = fn(c_all.data_ptr(), R, x.data_ptr(), mt.data_ptr(),
                y.data_ptr(), B, D, Kp, _params(norms), m, theta,
                max_squarings, torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on("adjoint_sweep_fwd", rc)
    adjoint_sweep_fwd.launches += 1
    return y


adjoint_sweep_fwd.launches = 0


def adjoint_sweep_bwd(c_all, x_final, a_final, mt, ms, norms, *, m: int,
                      theta: float, max_squarings: int = 16):
    """K8: the whole reverse sweep over the rows c_all (R, K') in one
    launch, from the final state and its cotangent (B, D). Returns (a0
    (B, D), cbar (R, K')): each block writes its batch-summed (R, K')
    partial, and the partials are summed here in block order (no atomics:
    the result does not change from run to run). CPU tensors run
    :func:`torch_adjoint_sweep_bwd`."""
    if _on_cpu(c_all, x_final, a_final, mt, ms):
        return torch_adjoint_sweep_bwd(c_all, x_final, a_final, mt, ms,
                                       norms, m=m, theta=theta,
                                       max_squarings=max_squarings)
    R = c_all.shape[0] if c_all.ndim == 2 else -1
    Kp = _check("adjoint_sweep_bwd", x_final,
                {"x": x_final, "a": a_final, "mt": mt, "ms": ms}, norms,
                c_all, R)
    B, D = x_final.shape
    lib = _kernel_lib()
    is32 = x_final.dtype == torch.float32
    with torch.cuda.device(x_final.device):
        n_blocks = lib.vec_ode_adjoint_blocks(B, D, Kp, 4 if is32 else 8)
        if n_blocks <= 0:
            raise RuntimeError(f"adjoint_sweep_bwd: no launch shape for "
                               f"B={B}, D={D}, K'={Kp} (error {n_blocks})")
        a0 = torch.empty_like(a_final)
        part = torch.empty((n_blocks, R, Kp), dtype=x_final.dtype,
                           device=x_final.device)
        fn = getattr(lib, "vec_ode_adjoint_sweep_bwd_"
                     + ("f32" if is32 else "f64"))
        rc = fn(c_all.data_ptr(), R, x_final.data_ptr(), a_final.data_ptr(),
                mt.data_ptr(), ms.data_ptr(), a0.data_ptr(), part.data_ptr(),
                B, D, Kp, _params(norms), m, theta, max_squarings,
                torch.cuda.current_stream(x_final.device).cuda_stream)
    _raise_on("adjoint_sweep_bwd", rc)
    adjoint_sweep_bwd.launches += 1
    return a0, part.sum(0)


adjoint_sweep_bwd.launches = 0

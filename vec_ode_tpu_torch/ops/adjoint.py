"""The reversible adjoint's exponential actions, the counterpart of
``vec_ode_tpu/ops/pallas_expmv.py:320-664``.

One reverse row of the adjoint over a shared working basis W_k, with
A = sum_k c_k W_k, takes the state x_{n+1} and its cotangent a_{n+1} to

    x_n   = e^{-A} x_{n+1}                    (reconstruction)
    a_n   = e^{A^T} a_{n+1}                   (cotangent transport)
    cbar_k = <a_{n+1}, D_{W_k} e^{A} x_n>      (coefficient cotangents)

Scaling follows the port's rule (``ops/expmv.scale_rows``): one squaring
count per row (per trajectory and row for per-lane rows), from the bound
sum_k |c_k| ||W_k||_1 alone; the Fréchet series is linear in its
direction, so the direction adds nothing to the count
(``_adjoint_row_scaling``, ``pallas_expmv.py:330-344``). The TPU sweep
kernels' single count over all rows (``_global_scaling``) is not copied:
the JAX package's XLA path takes one count per row too.

Three kernels, each a wrapper and a plain twin with the kernel's
arithmetic:

* K6 :func:`adjoint_bwd` (twin :func:`torch_adjoint_row`): one reverse
  row with per-lane coefficients (B, K'), K' up to 36. The Fréchet terms
  come by pairing, not from the JAX kernel's block-triangular recurrence
  (``_adjoint_row_chains``, K'^2 + 3K' actions a term): with the Taylor
  terms alpha_i of the a chain's pass start z and t_l of v,
  <z, D_V T_m(A) v> = sum_{i + l <= m - 1} i! l! / (i + l + 1)!
  <alpha_i, V t_l>, and the a chain's pass j is paired with the x
  chain's state after j + 1 passes, whose next pass is the t chain (see
  ``csrc/adjoint_row.cuh``). Every Taylor term is one (B, D) @ (D, K'D)
  product per chain with ``mt`` = [W_0^T | ...] (x) or ``ms`` = [W_0 |
  ...] (a), the K' actions combined in k order and divided by the term's
  index: 2K' actions a term;
* K7 :func:`adjoint_sweep_fwd` (twin :func:`torch_adjoint_sweep_fwd`):
  all R rows of a fixed-step forward, y = e^{A_{R-1}} ... e^{A_0} x; the
  rows are shared by the batch, so each row's exponent A^T = sum_k cs_k
  W_k^T is formed once (:func:`_exponent`, k order) and every Taylor term
  is one (B, D) @ (D, D) product with it (the TPU kernel's sum of K'
  actions, to rounding);
* K8 :func:`adjoint_sweep_bwd` (twin :func:`torch_adjoint_sweep_bwd`):
  the whole reverse sweep, a0 and the batch-summed cbar (R, K'), over the
  same formed exponents: per term one product with -A^T (x), A^T (each
  u_k, plus 2^-s W_k w) and A (a), and the w chain's K' actions W_k w,
  which also give A w combined in k order: 2K' + 2 actions a term, each
  term scaled by RN(1/j). The Fréchet terms by the block-triangular
  recurrence: u_k' = (A u_k + 2^-s W_k w) / j with the w chain w' = (A w)
  / j shared by all K' directions. Past K' = BWD_GROUP_TERMS the kernel
  runs the u_k chains in term groups (:func:`bwd_group`), the w chain
  anew in each as one product with the formed exponent; the twin's w
  chain is then that product too.

All three take 1 to ROW_MAX_KP = 36 working terms (eight basis terms at
order 4), as K4 does.

CPU tensors run the twin; CUDA tensors launch the kernel of
``csrc/adjoint.cu`` or raise. Each wrapper counts its launches
(``.launches``).

``diff.py`` calls the three through custom operators (:data:`sweep_fwd_op`,
:data:`sweep_bwd_op`, :data:`row_op`), so that its autograd Functions
compose with ``torch.func``: a ctypes launch cannot run on functorch's
wrapped tensors, an operator's implementation gets plain ones. Each
operator's vmap rule runs the mapped samples one after another, each
with its own launch (P samples: P launches, P times the work of one).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import List, Sequence

import torch

from . import _build
from .expmv import (GEMM_CN, GEMM_RM, GEMM_STAGES, GEMM_THREADS, _align16,
                    gemm_dp, gemm_jc, ring_resident, scale_rows)
from .expmv import MAX_KP as ROW_MAX_KP
from .fused_rk import MAX_WIDTH


def _combine(coeffs, mv, D: int):
    """sum_k coeffs[:, k] * mv[:, kD:(k+1)D], in k order."""
    w = None
    for k in range(coeffs.shape[1]):
        part = coeffs[:, k:k + 1] * mv[:, k * D:(k + 1) * D]
        w = part if w is None else w + part
    return w


def _pair_coef(i: int, l: int, like):
    """i! l! / (i + l + 1)! in like's type: the denominator (i + l + 1)
    C(i + l, i), exact as a float, rounded once, then one division (the
    kernel's pair_coefs)."""
    den = like.new_tensor(float((i + l + 1) * math.comb(i + l, i)))
    return like.new_ones(()) / den


def _row(cs, scale, n_pass, x, a, mt, ms, m: int):
    """One reverse row from the scaled rows cs (B, K') by the pairing
    route (the module note, ``csrc/adjoint_row.cuh``): stage p runs the x
    chain's pass p and, from p = 1, the a chain's pass p - 1, pairing
    them at every term step s: the x side W_k T^x_{s-1} with g = (-1)^(s-1)
    sum_i c(i, s-1) alpha_i, the a side W_k^T alpha_{s-1} with g = sum_l
    c(s-1, l) (-1)^l T^x_l, over the first H terms of each pass. Returns
    (x_n, a_n, cbar (B, K'))."""
    B, D = x.shape
    Kp = cs.shape[1]
    H = (m - 1) // 2 + 1
    cb = x.new_zeros((B, Kp))
    acc_x, acc_a = x, a
    for p in range(int(n_pass.max()) + 1):
        a_on = p >= 1
        pair = (n_pass >= p)[:, None] & a_on
        sum_x, sum_a = acc_x, acc_a
        tx, ta = acc_x, acc_a
        hx, ha = [tx], [ta]
        for s in range(1, m + 1):
            yx = tx @ mt
            ya = ta @ ms if a_on else None
            if a_on:
                sides = []
                top = min(s - 2, m - s)
                if top >= 0:  # the x side
                    g = None
                    for i in range(top + 1):
                        t = _pair_coef(i, s - 1, x) * ha[i]
                        g = t if g is None else g + t
                    sides.append((-g if (s - 1) % 2 else g, yx))
                g = None
                for l in range(min(s - 1, m - s) + 1):  # the a side
                    coef = _pair_coef(s - 1, l, x)
                    t = (-coef if l % 2 else coef) * hx[l]
                    g = t if g is None else g + t
                sides.append((g, ya))
                for g, y in sides:
                    dots = (g[:, None, :] * y.view(B, Kp, D)).sum(-1)
                    cb = torch.where(pair, cb + dots, cb)
            tx = _combine(-cs, yx, D) / s
            sum_x = sum_x + tx
            if a_on:
                ta = _combine(cs, ya, D) / s
                sum_a = sum_a + ta
            if s < H:
                hx.append(tx)
                ha.append(ta)
        acc_x = torch.where((n_pass > p)[:, None], sum_x, acc_x)
        if a_on:
            acc_a = torch.where((n_pass > p - 1)[:, None], sum_a, acc_a)
    return acc_x, acc_a, cb * scale[:, None]


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
    the final state and its cotangent (B, D), one squaring count per row.
    Per row its exponent A^T (:func:`_exponent`), then 2^s passes of the
    degree-m Taylor polynomial per chain: x_n = e^{-A} x, each term a
    product with -A^T; then from u_k = 0, w = x_n and a side by side, per
    term u_k' = (u_k A^T + 2^-s W_k w) r_j, w' = (sum_k cs_k W_k w) r_j
    from the K' actions W_k w (``w @ mt``) and a' = (a A) r_j; cbar_k =
    <a, u_k> summed over the batch. Past K' = BWD_GROUP_TERMS, where the
    kernel runs the u_k chains in term groups, w' = (w A^T) r_j, one
    product with the exponent, as the kernel's w chain takes it. Each
    term is scaled by r_j = RN(1/j),
    the reciprocal rounded to the state's type, not divided by j (the
    kernel's IEEE divisions had cost a tenth of its time). Returns (a0
    (B, D), cbar (R, K'))."""
    B, D = x_final.shape
    Kp = c_all.shape[-1]
    cs, scale, n_pass = _scaled(c_all, norms, theta, max_squarings)
    grouped = Kp > BWD_GROUP_TERMS
    # the term scales RN(1/j), as the kernel rounds them
    rj = [None] + [x_final.new_ones(()) / j for j in range(1, m + 1)]
    x, a = x_final, a_final
    cbar = [None] * c_all.shape[0]
    for r in range(c_all.shape[0] - 1, -1, -1):
        at = _exponent(cs[r], mt, D)
        cs_b = cs[r].expand(B, Kp)
        passes = int(n_pass[r])
        for _ in range(passes):
            acc = term = x
            for j in range(1, m + 1):
                term = -(term @ at) * rj[j]
                acc = acc + term
            x = acc
        us, w, a_n = x.new_zeros((Kp, B, D)), x, a
        for _ in range(passes):
            acc_u = term_u = us
            acc_w = term_w = w
            acc_a = term_a = a_n
            for j in range(1, m + 1):
                mw = term_w @ mt
                dirs = mw.view(B, Kp, D).transpose(0, 1)
                term_u = ((term_u @ at) + scale[r] * dirs) * rj[j]
                term_w = ((term_w @ at) if grouped
                          else _combine(cs_b, mw, D)) * rj[j]
                term_a = (term_a @ at.T) * rj[j]
                acc_u, acc_w = acc_u + term_u, acc_w + term_w
                acc_a = acc_a + term_a
            us, w, a_n = acc_u, acc_w, acc_a
        cbar[r] = (a * us).sum(-1).sum(-1)
        a = a_n
    if not cbar:
        return a, c_all.new_zeros((0, Kp))
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
    lib.vec_ode_adjoint_row_plan.restype = ci
    lib.vec_ode_adjoint_row_plan.argtypes = [
        ci, ci, ci, ci, ci, ctypes.POINTER(ctypes.c_longlong)]
    return lib


# K6's plans and limits (csrc/adjoint_row.cuh: ROW_*): tiled, or a
# thread-block cluster a tile below the card's SM count of tiled blocks
ROW_MAX_LANES, ROW_CLUSTER_MAX, ROW_CLUSTER_LANES = 32, 4, 8
ROW_CLUSTER_RM, ROW_CLUSTER_CN = 1, 2
ROW_STAGE_BYTES = 16384
ROW_RM = {4: 4, 8: 2}
ROW_PLAN_KEYS = ("cluster", "n", "lanes", "dc", "threads", "smem",
                 "resident")


def row_hist(m: int) -> int:
    """The terms of each chain a pass of K6 keeps for the pairing."""
    return (m - 1) // 2 + 1


def pair_jc(width: int, elem: int) -> int:
    """Contraction rows of a stage of K6's streamed ring (csrc/
    adjoint_row.cuh: pair_jc): a multiple of 4 up to 32 whose two panels
    fill ROW_STAGE_BYTES, at least 4."""
    jc = ROW_STAGE_BYTES // (2 * gemm_dp(width) * elem) // 4 * 4
    return min(32, max(4, jc))


def row_smem_bytes(lanes: int, D: int, width: int, Kp: int, elem: int,
                   m: int) -> int:
    """K6's shared memory (csrc/adjoint_row.cuh: RowLayout): two term
    buffers (D, 2L), the first H terms of each chain at the block's
    columns, the ring of both operands (resident or GEMM_STAGES stages),
    the scaled rows and the block's cbar (L, K'), the pairing coefficients
    (m, m), 2^-s and the pass counts (L)."""
    dp, r2 = gemm_dp(width), 2 * lanes
    ring = (2 * Kp * D * dp * elem if ring_resident(D, Kp, width, elem)
            else GEMM_STAGES * 2 * pair_jc(width, elem) * dp * elem)
    return (_align16(2 * D * r2 * elem)
            + _align16(row_hist(m) * r2 * dp * elem) + _align16(ring) + 2 * _align16(lanes * Kp * elem)
            + _align16(m * m * elem) + _align16(lanes * elem)
            + _align16(lanes * 4))


def row_plan(B: int, D: int, Kp: int, elem: int, m: int, n_sm: int = 132,
             max_smem: int = 232448) -> dict:
    """K6's launch plan (csrc/adjoint.cu: row_plan) on a card of ``n_sm``
    SMs with ``max_smem`` bytes of shared memory a block (an H100's by
    default): the tiled route (lanes a block the largest power of two up
    to ROW_MAX_LANES whose threads and shared memory fit, halved while the
    batch gives fewer blocks than SMs, down to RM) unless it gives fewer
    blocks than SMs, then the cluster route (dc = ceil(D / ROW_CLUSTER_MAX)
    columns a block, rounded up to ROW_CLUSTER_CN, n = ceil(D / dc) >= 2
    blocks a tile, lanes the largest power of two up to ROW_CLUSTER_LANES
    that fits, halved while the clusters' blocks are fewer than SMs).
    Returns {route, cluster, n, lanes, dc, rm, cn, threads, blocks, smem,
    resident}, or None where the shape does not fit."""
    rm, ncg = ROW_RM[elem], gemm_dp(D) // GEMM_CN
    lanes = ROW_MAX_LANES
    while lanes > rm and ((2 * lanes // rm) * ncg > GEMM_THREADS
                          or row_smem_bytes(lanes, D, D, Kp, elem, m)
                          > max_smem):
        lanes //= 2
    while lanes > rm and -(-B // lanes) < n_sm:
        lanes //= 2
    dc = -(-(-(-D // ROW_CLUSTER_MAX)) // ROW_CLUSTER_CN) * ROW_CLUSTER_CN
    n = -(-D // dc)
    if -(-B // lanes) >= n_sm or n < 2:
        cn, n, dc, cluster = GEMM_CN, 1, D, False
        items = (2 * lanes // rm) * ncg
    else:
        rm, cn, cluster = ROW_CLUSTER_RM, ROW_CLUSTER_CN, True
        ncl = -(-dc // cn)
        lanes = ROW_CLUSTER_LANES
        while lanes > 1 and (2 * lanes * ncl > GEMM_THREADS
                             or row_smem_bytes(lanes, D, dc, Kp, elem, m)
                             > max_smem):
            lanes //= 2
        while lanes > 1 and -(-B // lanes) * n < n_sm:
            lanes //= 2
        items = 2 * lanes * ncl
    threads = -(-items // 32) * 32
    smem = row_smem_bytes(lanes, D, dc, Kp, elem, m)
    if threads > GEMM_THREADS or smem > max_smem:
        return None
    return dict(route="cluster" if cluster else "tiled", cluster=int(cluster),
                n=n, lanes=lanes, dc=dc, rm=rm, cn=cn, threads=threads,
                blocks=-(-B // lanes) * n, smem=smem,
                resident=int(ring_resident(D, Kp, dc, elem)))


_row_plan_cached = functools.lru_cache(maxsize=256)(row_plan)


def kernel_row_plan(B: int, D: int, Kp: int, m: int, dtype) -> dict:
    """The plan K6 launches with on the current card
    (``vec_ode_adjoint_row_plan``), keyed as ROW_PLAN_KEYS."""
    out = (ctypes.c_longlong * len(ROW_PLAN_KEYS))()
    rc = _kernel_lib().vec_ode_adjoint_row_plan(
        B, D, Kp, m, 4 if dtype == torch.float32 else 8, out)
    if rc != 0:
        raise RuntimeError(f"adjoint_bwd: the plan query failed with CUDA "
                           f"error {rc}")
    return dict(zip(ROW_PLAN_KEYS, (int(v) for v in out)))


# K7's plans and limits (csrc/adjoint.cu: SWEEP_*): both exponents in
# shared memory, one formed between rows, or panels formed every term
SWEEP_PLANS = ("double", "single", "panel")
SWEEP_PRODUCER_WARPS = 4
SWEEP_MAX_TILE = 64


def sweep_smem_bytes(plan: str, tile: int, ks: int, D: int,
                     elem: int) -> int:
    """K7's shared memory (csrc/adjoint.cu: SweepLayout): the exponent or
    its panel, the second exponent, the term rows of DP + 4 values, the
    partial products of ks - 1 contraction groups, two slots of a scaled
    row (ROW_MAX_KP values each)."""
    row, trow = gemm_dp(D) * elem, (gemm_dp(D) + GEMM_CN) * elem
    a = (gemm_jc(D, elem) if plan == "panel" else D) * row
    return (_align16(a) + (_align16(D * row) if plan == "double" else 0)
            + _align16(tile * trow) + _align16((ks - 1) * tile * trow)
            + 2 * _align16(ROW_MAX_KP * elem))


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


# K8's plans and limits (csrc/adjoint.cu: BWD_*): the exponent and the
# ring of mt's rows in shared memory, the exponent formed between rows, or
# panels of A^T and A formed every term
BWD_PLANS = ("buffer", "panel")
BWD_THREADS, BWD_WIDE_THREADS = 512, 1024
BWD_MAX_TILE, BWD_MAX_GROUPS = 64, 8
BWD_STAGES, BWD_RING_BYTES = 3, 24576
BWD_GROUP_TERMS = 6
BWD_RM_MAX = {4: 4, 8: 2}


def bwd_group(Kp: int) -> int:
    """The terms of one of K8's term groups (csrc/adjoint.cu: bwd_group):
    K' itself up to BWD_GROUP_TERMS (one group), else K' split evenly
    into ceil(K' / BWD_GROUP_TERMS) groups."""
    ng = -(-Kp // BWD_GROUP_TERMS)
    return -(-Kp // ng)


def bwd_as(D: int) -> int:
    """K8's exponent row (csrc/adjoint.cu: bwd_as): DP values where DP / 4
    is odd, else DP + 4."""
    dp = gemm_dp(D)
    return dp if (dp // GEMM_CN) % 2 else dp + GEMM_CN


def bwd_jw(D: int, G: int, elem: int, ks: int) -> int:
    """Rows of ``mt`` a stage of K8's ring carries (csrc/adjoint.cu:
    bwd_jw): a multiple of 4 up to 32 with a term group's G blocks of DP
    values within BWD_RING_BYTES, at least 4 for each of the ks
    contraction groups."""
    jw = min(32, BWD_RING_BYTES // (G * gemm_dp(D) * elem) // 4 * 4)
    return max(jw, 4 * ks)


def bwd_smem_bytes(plan: str, tile: int, Kp: int, D: int, elem: int,
                   ks: int = 1, ks1: int = 1) -> int:
    """K8's shared memory (csrc/adjoint.cu: BwdLayout) over term groups of
    G = bwd_group(K') terms, nch = 1 (one group) or 2 chains beside them:
    the exponent (D, AS) or two panels (jc, DP); 2G + 5 slabs of (tile,
    TS) values (TS = DP at D > 124, else DP + 4) and the later contraction
    groups' partial products ((ks - 1) (2G + nch)); for the buffer plan the
    ring of BWD_STAGES stages of (jw, G DP); the row's K' coefficients."""
    G = bwd_group(Kp)
    nch = 2 if G < Kp else 1
    ts = gemm_dp(D) + (0 if gemm_dp(D) // GEMM_CN >= 32 else GEMM_CN)
    slab = _align16(tile * ts * elem)
    nred = max((ks - 1) * (2 * G + nch), ks1 - 1 - (2 * G + 2))
    if plan == "panel":
        exp = 2 * _align16(gemm_jc(D, elem) * gemm_dp(D) * elem)
    else:
        exp = _align16(D * bwd_as(D) * elem) + BWD_STAGES * _align16(
            bwd_jw(D, G, elem, ks) * G * gemm_dp(D) * elem)
    return exp + (2 * G + 5 + nred) * slab + _align16(Kp * elem)


def bwd_plan(B: int, D: int, Kp: int, elem: int, n_sm: int = 132,
             max_smem: int = 232448) -> dict:
    """K8's launch shape (csrc/adjoint.cu: bwd_shape) on a card of ``n_sm``
    SMs with ``max_smem`` bytes of shared memory a block (an H100's by
    default): {plan, tile, rm, ks, ks1, G, threads, smem, blocks} (rm rows
    a thread, ks and ks1 contraction groups in phases 2 and 1, G terms a
    term group), or None where no shape fits."""
    ncg = gemm_dp(D) // GEMM_CN
    G = bwd_group(Kp)
    nch = 2 if G < Kp else 1
    start = BWD_MAX_TILE
    while start > 1 and -(-B // start) < n_sm // 2:
        start //= 2
    for plan in BWD_PLANS:
        tile = start
        while True:
            rm = min(tile, BWD_RM_MAX[elem])
            cap = BWD_THREADS
            per = tile // rm * ncg
            items = (G + nch) * per
            ks = 1
            while (plan == "buffer" and ks < BWD_MAX_GROUPS
                   and 2 * ks * items <= cap and D >= 64 * ks):
                ks *= 2
            while ks >= 1:
                threads = -(-ks * items // 32) * 32
                ks1 = (min(BWD_MAX_GROUPS, threads // per)
                       if plan == "buffer" else 1)
                smem = bwd_smem_bytes(plan, tile, Kp, D, elem, ks, ks1)
                if smem <= max_smem and (threads <= cap or (
                        tile == 1 and threads <= BWD_WIDE_THREADS)):
                    return dict(plan=plan, tile=tile, rm=rm, ks=ks, ks1=ks1,
                                G=G, threads=threads, smem=smem,
                                blocks=-(-B // tile))
                ks //= 2
            if tile == 1:
                break
            tile //= 2
    return None


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
    if not 1 <= D <= MAX_WIDTH or not 1 <= Kp <= ROW_MAX_KP:
        raise ValueError(
            f"{kernel}: the kernel takes a state width D <= {MAX_WIDTH} and "
            f"1 to {ROW_MAX_KP} basis terms, got D = {D}, K' = {Kp}")
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
    kernel (float32 or float64, D <= 512, K' <= 36; its plan:
    :func:`row_plan`); CPU tensors run :func:`torch_adjoint_row`."""
    if _on_cpu(c, x_next, a_next, mt, ms):
        return torch_adjoint_row(c, x_next, a_next, mt, ms, norms, m=m,
                                 theta=theta, max_squarings=max_squarings)
    B = x_next.shape[0] if x_next.ndim == 2 else 0
    Kp = _check("adjoint_bwd", x_next, {"x": x_next, "a": a_next, "mt": mt,
                                        "ms": ms}, norms, c, B)
    D = x_next.shape[1]
    if _row_plan_cached(B, D, Kp, x_next.element_size(), m) is None:
        raise ValueError(f"adjoint_bwd: no launch shape fits D = {D}, K' = "
                         f"{Kp} at Taylor degree m = {m}")
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
    launch (its shape: :func:`bwd_plan`), from the final state and its
    cotangent (B, D). Returns (a0 (B, D), cbar (R, K')): each block writes
    its batch-summed (R, K') partial, and the partials are summed here in
    block order (no atomics: the result does not change from run to run).
    CPU tensors run :func:`torch_adjoint_sweep_bwd`."""
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


def _fresh(out, *inputs):
    """out, copied where it is one of the inputs (the twins return the
    state itself when there are no rows): an operator's outputs may not
    alias its inputs."""
    return out.clone() if any(out is t for t in inputs) else out


def _looped(op, n_out: int):
    """A vmap rule that runs ``op`` on each mapped sample in turn (its
    tensors sliced contiguous, unmapped arguments as they are) and stacks
    the results on a new leading axis."""

    def rule(info, in_dims, *args):
        outs = []
        for i in range(info.batch_size):
            outs.append(op(*(a.select(d, i).contiguous()
                             if isinstance(a, torch.Tensor) and d is not None
                             else a for a, d in zip(args, in_dims))))
        if n_out == 1:
            return torch.stack(outs), 0
        return tuple(torch.stack(o) for o in zip(*outs)), (0,) * n_out

    return rule


@torch.library.custom_op("vec_ode_tpu_torch::adjoint_sweep_fwd",
                         mutates_args=())
def sweep_fwd_op(c_all: torch.Tensor, x: torch.Tensor, mt: torch.Tensor,
                 norms: List[float], m: int, theta: float,
                 max_squarings: int) -> torch.Tensor:
    """:func:`adjoint_sweep_fwd` as an operator."""
    return _fresh(adjoint_sweep_fwd(c_all, x, mt, norms, m=m, theta=theta,
                                    max_squarings=max_squarings), x)


@sweep_fwd_op.register_fake
def _(c_all, x, mt, norms, m, theta, max_squarings):
    return torch.empty_like(x)


sweep_fwd_op.register_vmap(_looped(sweep_fwd_op, 1))


@torch.library.custom_op("vec_ode_tpu_torch::adjoint_sweep_bwd",
                         mutates_args=())
def sweep_bwd_op(c_all: torch.Tensor, x_final: torch.Tensor,
                 a_final: torch.Tensor, mt: torch.Tensor, ms: torch.Tensor,
                 norms: List[float], m: int, theta: float,
                 max_squarings: int) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`adjoint_sweep_bwd` as an operator."""
    a0, cb = adjoint_sweep_bwd(c_all, x_final, a_final, mt, ms, norms, m=m,
                               theta=theta, max_squarings=max_squarings)
    return _fresh(a0, x_final, a_final), cb


@sweep_bwd_op.register_fake
def _(c_all, x_final, a_final, mt, ms, norms, m, theta, max_squarings):
    return torch.empty_like(a_final), c_all.new_empty(c_all.shape)


sweep_bwd_op.register_vmap(_looped(sweep_bwd_op, 2))


@torch.library.custom_op("vec_ode_tpu_torch::adjoint_bwd", mutates_args=())
def row_op(c: torch.Tensor, x_next: torch.Tensor, a_next: torch.Tensor,
           mt: torch.Tensor, ms: torch.Tensor, norms: List[float], m: int,
           theta: float, max_squarings: int
           ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`adjoint_bwd` as an operator."""
    x_n, a_n, cb = adjoint_bwd(c, x_next, a_next, mt, ms, norms, m=m,
                               theta=theta, max_squarings=max_squarings)
    return _fresh(x_n, x_next), _fresh(a_n, a_next), cb


@row_op.register_fake
def _(c, x_next, a_next, mt, ms, norms, m, theta, max_squarings):
    return (torch.empty_like(x_next), torch.empty_like(a_next),
            torch.empty_like(c))


row_op.register_vmap(_looped(row_op, 3))

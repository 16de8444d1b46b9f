"""Natively batched execution for the generic dense exponential steppers,
the counterpart of ``vec_ode_tpu/exp/dense_fast.py``.

The generic steppers take a black-box operator callback; under an
adaptive ensemble every trajectory carries its own time, so the samples
A_b(t_i) are per-trajectory dense matrices with no shared structure. One
``torch.func.vmap`` of the callback over the stacked node times assembles
them (the callback itself stays scalar-time), and
:func:`run_batched_chains` runs the step's declared chains
(``ops.dense_chains.ChainTable``) on the fused kernel K9
(``ops.dense_chains.fused_dense_chain_apply``: in-kernel commutators,
scaling, propagators, chain application and the error norm, l2 or a
declared ``WeightedNorm``; its plain twin on CPU tensors).

:func:`run_stacked_chains` computes the same step the way the JAX
package's default executor does: ALL chain exponents as ONE stacked batched
``ops.expm.expm`` (batch-uniform squaring count, ``torch.matmul``), then
the sequential matvecs. No stepper calls it: it is the reference the tests
hold the steppers to and the library yardstick of K9's timings.

The steppers in exp/magnus.py, exp/cfm.py and exp/split_solvers.py call
into this module when their split is a dense leaf
(``supports_batched_dense``) and the driver hands them batched
(t, x, dt).
"""

from __future__ import annotations

import torch

from .. import lc
from ..ops.cplx import Cplx, embed
from ..ops.dense_chains import (ChainTable, fused_dense_chain_apply,
                                torch_dense_chains)
from ..ops.expm import expm, expm_m1
from .protocol import ExponentialSplit

# (PS degree, theta) per dtype: degree 12 costs the same five products as
# degree 8 but admits theta = 1.0 in f32 (truncation ~4e-10, under f32
# eps), so adaptive steps with dt * ||A|| <~ 1 pay no squaring; f64 keeps
# the tight theta for ~eps truncation (2.4e-18 at 0.25).
_PS_CFG = {32: (12, 1.0), 64: (12, 0.25)}

def ps_params(dtype):
    return _PS_CFG[torch.finfo(dtype).bits]


def _is_cplx(split) -> bool:
    return bool(getattr(split, "is_cplx_split", False))


def split_parts(split, x):
    """State as real parts: (re, im) for Cplx splits, (x,) for real."""
    return (x.re, x.im) if _is_cplx(split) else (x,)


def split_unparts(split, parts):
    return Cplx(*parts) if _is_cplx(split) else parts[0]


def embed_node(split, L):
    """Per-trajectory operator samples -> real working matrices
    (..., D, D)."""
    return embed(L) if _is_cplx(split) else L


def widen(parts):
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)


def unwiden(split, yw):
    if _is_cplx(split):
        d = yw.shape[-1] // 2
        return Cplx(yw[..., :d], yw[..., d:])
    return yw


def run_batched_chains(split: ExponentialSplit, x, dt, node_ops,
                       table: ChainTable, *, adaptive: bool,
                       max_squarings: int = 16, wnorm=None, lo=None):
    """Execute the declared chains on the fused kernel (its twin on CPU
    tensors). ``node_ops`` (n_nodes, B, D, D): the embedded operator
    samples; dt (B,). Returns (y, err_norm or None) with err a
    PER-TRAJECTORY NORM (the batched driver uses error_norm = identity).

    ``wnorm = (w_row, post, kind)`` (lc.WeightedNorm.kernel_parts) is a
    declared error norm over the widened layout, which K9 computes; a
    callable ``wnorm`` (an ``lc.TracedNorm``'s executor) runs the twin
    ``torch_dense_chains`` on the tensors' device, which applies it.

    ``lo`` (the state's residual word) selects the compensated tier
    (:func:`_run_batched_chains_comp`), which returns (y, err_norm,
    lo_next) and runs torch, never K9, as the JAX package runs it on XLA:
    no kernel has an increment form."""
    parts = split_parts(split, x)
    dtype = parts[0].dtype
    m, theta = ps_params(dtype)
    if lo is not None:
        return _run_batched_chains_comp(
            split, parts, lo, dt, node_ops, table, adaptive=adaptive,
            max_squarings=max_squarings, wnorm=wnorm)
    run = torch_dense_chains if callable(wnorm) else fused_dense_chain_apply
    y, e = run(table, node_ops.to(dtype), dt.to(dtype).contiguous(),
               widen(parts).contiguous(), m=m, theta=theta,
               max_squarings=max_squarings, wnorm=wnorm)
    return unwiden(split, y), (e if adaptive else None)


def _run_batched_chains_comp(split, parts, lo, dt, node_ops,
                             table: ChainTable, *, adaptive: bool,
                             max_squarings: int, wnorm):
    """The compensated executor: one stacked batched ``ops.expm.expm_m1``
    of every chain exponent (one host sync for its squaring count, as
    ``expm``), the chains in increment form D <- D + phi_i (x + D), the
    error the difference of the two chains' increments, and TwoSum of the
    advance into the (x, lo) pair, all on the widened real layout."""
    from .. import comp

    xw = widen(parts)
    lo_w = widen(split_parts(split, lo))
    chains = table.exponents(node_ops.to(xw.dtype), dt.to(xw.dtype))
    Phi = expm_m1(torch.stack([W for chain in chains for W in chain]),
                  max_squarings=max_squarings)

    def increment(idx0, chain_len):
        D = (Phi[idx0] @ xw[..., None])[..., 0]
        for i in range(1, chain_len):
            D = D + (Phi[idx0 + i] @ (xw + D)[..., None])[..., 0]
        return D

    D = increment(0, len(chains[0]))
    e = None
    if len(chains) >= 2 and adaptive:
        e = lc.apply_weighted_norm(
            increment(len(chains[0]), len(chains[1])) - D, wnorm)
    hi2, lo2 = comp._update_leaf(xw, lo_w, D)
    return unwiden(split, hi2), e, unwiden(split, lo2)


def run_stacked_chains(split: ExponentialSplit, x, dt, node_ops,
                       table: ChainTable, *, adaptive: bool,
                       max_squarings: int = 16, wnorm=None):
    """The same step as :func:`run_batched_chains` by one batched ``expm``
    of ALL chain exponents, then the cheap sequential matvecs. Stacked
    (K, B, D, D), not concatenated to (K B, D, D), as the JAX package lays
    it out."""
    parts = split_parts(split, x)
    xw = widen(parts)
    chains = table.exponents(node_ops.to(parts[0].dtype), dt)
    U = expm(torch.stack([W for chain in chains for W in chain]),
             max_squarings=max_squarings)

    if all(len(c) == 1 for c in chains):
        # every chain is a single propagator: apply them all in one
        # batched matvec over the stacked U
        ys = (U @ xw[None, :, :, None])[..., 0]
        y = ys[0]
        if len(chains) < 2:
            return unwiden(split, y), None
        e = lc.apply_weighted_norm(ys[1] - y, wnorm)
        return unwiden(split, y), (e if adaptive else None)

    def apply_chain(idx0, chain_len, v):
        for i in range(chain_len):
            v = (U[idx0 + i] @ v[..., None])[..., 0]
        return v

    y = apply_chain(0, len(chains[0]), xw)
    if len(chains) < 2:
        return unwiden(split, y), None
    ev = apply_chain(len(chains[0]), len(chains[1]), xw)
    e = lc.apply_weighted_norm(ev - y, wnorm)
    return unwiden(split, y), (e if adaptive else None)

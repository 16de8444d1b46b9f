"""Batched matrix exponential, the counterpart of ``vec_ode_tpu/ops/expm.py``.

Scaling and squaring for real (and, on the CPU, complex) matrices
(..., d, d): the degree-12 Taylor polynomial in Paterson-Stockmeyer form
(five products, no solve) for float32, Padé-13 with ``torch.linalg.solve``
for float64. These are batched products outside any kernel, so they are
``torch.matmul``.

The squaring count is ONE scalar for the whole stack, from the largest
1-norm over it (non-finite norms left out, so one NaN matrix does not take
the others' squarings away). Under ``torch.func.vmap`` the count is one
per mapped sample, from that sample's own stack, as ``jax.vmap`` of the
JAX package's ``expm`` gives it; the samples are squared together up to
the largest count, each masked past its own. The loop over it needs the
count on the host: every call of ``expm`` / ``expm_m1`` /
``expm_frechet`` costs one host sync (``int(s)``), a vmapped call too. The alternative without a sync, always running
``max_squarings`` masked squarings, costs up to 16 products of d^3 per call
where a step of the integrators needs none or a few; the port chose the
sync. The host driver reads one flag from the card per iteration anyway.

:func:`squaring_count` is the port's scaling rule (the least s >= 0 with
norm / theta <= 2^s, found exactly with frexp), :func:`taylor_ps` the
Paterson-Stockmeyer polynomial; the dense chain twin
(``ops/dense_chains.py``) uses both per trajectory.
"""

from __future__ import annotations

import math

import torch

# Padé-13 coefficients (Higham 2005, "The scaling and squaring method for
# the matrix exponential revisited"): standard published constants.
_PADE13_B = (
    64764752532480000.0,
    32382376266240000.0,
    7771770303897600.0,
    1187353796428800.0,
    129060195264000.0,
    10559470521600.0,
    670442572800.0,
    33522128640.0,
    1323241920.0,
    40840800.0,
    960960.0,
    16380.0,
    182.0,
    1.0,
)

# theta_13: the 1-norm below which Padé-13 is accurate at unit scaling, and
# its float32 analog
_THETA13 = 5.371920351148152
_THETA13_F32 = 4.25
# degree-12 truncation e^t - T12(t) at |t| <= 1 is ~4e-10, below f32 eps
_THETA_TAYLOR12 = 1.0

_FACT = [1.0 / math.factorial(k) for k in range(13)]


def squaring_count(norm: torch.Tensor, theta: float,
                   max_squarings: int) -> torch.Tensor:
    """The least s >= 0 with norm / theta <= 2^s, at most ``max_squarings``,
    elementwise as int64; s = 0 where norm / theta is not finite. Exact:
    the exponent comes from frexp, not from a rounded log2."""
    ratio = norm / theta
    mant, expo = torch.frexp(ratio)
    s = expo - (mant == 0.5).to(expo.dtype)
    s = torch.where(torch.isfinite(ratio) & (ratio > 1.0),
                    torch.clamp(s, 0, max_squarings), 0)
    return s.to(torch.int64)


def one_norm(A: torch.Tensor) -> torch.Tensor:
    """The matrix 1-norm (largest column sum of magnitudes) per matrix."""
    return torch.amax(torch.sum(torch.abs(A), dim=-2), dim=-1)


def _eye_like(A: torch.Tensor) -> torch.Tensor:
    return torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)


def taylor_ps(As: torch.Tensor, m: int = 12,
              minus_one: bool = False) -> torch.Tensor:
    """T_m(As) by Paterson-Stockmeyer over As^1..As^4: five products for m
    in {8, 12}. p(A) = B0 + A4 (B1 + A4 (B2 + A4 B3)) with B_j = sum_{i<4}
    A^i / (4j + i)!. ``minus_one`` drops the identity of B0, so the result
    is e^A - I with every term O(|A|) (m = 12 only)."""
    if m not in (8, 12):
        raise ValueError(f"PS propagator supports m in {{8, 12}}, got {m}")
    if minus_one and m != 12:
        raise ValueError("the increment form is the degree-12 polynomial")
    c = _FACT
    ident = _eye_like(As)
    A2 = As @ As
    A3 = A2 @ As
    A4 = A3 @ As

    def block(j):
        return (c[4 * j] * ident + c[4 * j + 1] * As
                + c[4 * j + 2] * A2 + c[4 * j + 3] * A3)

    if m == 8:
        return block(0) + A4 @ (block(1) + c[8] * A4)
    acc = block(2) + c[12] * A4          # B2 + A4 B3 (B3 = c12 I only)
    acc = block(1) + A4 @ acc
    blk0 = As + c[2] * A2 + c[3] * A3 if minus_one else block(0)
    return blk0 + A4 @ acc


def _pade13(A, A2, A4, A6, ident):
    b = _PADE13_B
    U = A @ (A6 @ (b[13] * A6 + b[11] * A4 + b[9] * A2)
             + b[7] * A6 + b[5] * A4 + b[3] * A2 + b[1] * ident)
    V = (A6 @ (b[12] * A6 + b[10] * A4 + b[8] * A2)
         + b[6] * A6 + b[4] * A4 + b[2] * A2 + b[0] * ident)
    return U, V


def _expm_impl(A: torch.Tensor, max_squarings: int, method: str = "auto",
               minus_one: bool = False, lead: int = 0) -> torch.Tensor:
    """``lead``: the number of leading axes whose entries (samples) take a
    squaring count each, from the largest 1-norm over the sample's own
    stack (0: one count for the whole stack)."""
    if A.ndim < 2 or A.shape[-2] != A.shape[-1]:
        raise ValueError(f"expm expects (..., d, d), got {tuple(A.shape)}")
    is_f64 = (A.real.dtype if A.is_complex() else A.dtype) == torch.float64
    if method == "auto":
        method = "pade13" if is_f64 else "taylor"
    if method not in ("pade13", "taylor"):
        raise ValueError(f"unknown expm method {method!r}")
    theta = {"pade13": _THETA13 if is_f64 else _THETA13_F32,
             "taylor": _THETA_TAYLOR12}[method]

    # one squaring count per sample (for the whole stack at lead = 0)
    norms = one_norm(A)
    norms = torch.where(torch.isfinite(norms), norms, 0.0)
    norms = norms.reshape(norms.shape[:lead] + (-1,))
    top = (norms.amax(-1) if norms.shape[-1] else
           norms.new_zeros(norms.shape[:-1]))
    s_each = squaring_count(top, theta, max_squarings)
    # read on the host: the squaring loop's length
    s = int(s_each.max()) if s_each.numel() else 0
    if lead:
        s_b = s_each.reshape(s_each.shape + (1,) * (A.ndim - lead))
        As = A * torch.pow(2.0, -s_b).to(A.dtype)
    else:
        As = A * 2.0 ** -s

    if method == "taylor":
        R = taylor_ps(As, 12, minus_one)
    else:
        A2 = As @ As
        A4 = A2 @ A2
        A6 = A4 @ A2
        U, V = _pade13(As, A2, A4, A6, _eye_like(As))
        # minus_one: Q^{-1} P - I = Q^{-1} (2 U) exactly
        R = torch.linalg.solve(V - U, 2.0 * U if minus_one else V + U)
    for k in range(s):
        # (I + phi)^2 - I = phi^2 + 2 phi: every term stays O(|phi|)
        Rk = R @ R + R + R if minus_one else R @ R
        R = torch.where(k < s_b, Rk, R) if lead else Rk
    return R


def expm_frechet(A: torch.Tensor, E: torch.Tensor, *,
                 max_squarings: int = 16,
                 method: str = "auto") -> torch.Tensor:
    """Fréchet derivative L(A, E) = d/ds expm(A + sE)|_0 by the block
    identity expm([[A, E], [0, A]]) = [[expm(A), L(A, E)], [0, expm(A)]].
    Plain differentiable torch, so second-order gradients work."""
    d = A.shape[-1]
    E = E.to(A.dtype)
    top = torch.cat([A, E], dim=-1)
    bot = torch.cat([torch.zeros_like(A), A], dim=-1)
    F = _expm_impl(torch.cat([top, bot], dim=-2), max_squarings, method)
    return F[..., :d, d:]


class _ExpmFn(torch.autograd.Function):
    """expm / expm_m1 with the exact Fréchet-adjoint backward: the adjoint
    of L(A, .) is L(A^H, .), since exp has real Taylor coefficients (Higham
    2008, ch. 10): one block (2d, 2d) expm per backward. Its vmap rule
    gives every mapped sample its own squaring count (``lead``)."""

    @staticmethod
    def forward(A, max_squarings, method, minus_one, lead):
        return _expm_impl(A, max_squarings, method, minus_one, lead)

    @staticmethod
    def setup_context(ctx, inputs, output):
        A, max_squarings, method, _, _ = inputs
        ctx.save_for_backward(A)
        ctx.max_squarings, ctx.method = max_squarings, method

    @staticmethod
    def backward(ctx, G):
        (A,) = ctx.saved_tensors
        AH = A.transpose(-1, -2).conj()
        return (expm_frechet(AH, G, max_squarings=ctx.max_squarings,
                             method=ctx.method), None, None, None, None)

    @staticmethod
    def vmap(info, in_dims, A, max_squarings, method, minus_one, lead):
        if in_dims[0] is None:
            return _ExpmFn.apply(A, max_squarings, method, minus_one,
                                 lead), None
        A = A.movedim(in_dims[0], 0)
        return _ExpmFn.apply(A, max_squarings, method, minus_one,
                             lead + 1), 0


def expm(A: torch.Tensor, *, max_squarings: int = 16,
         method: str = "auto") -> torch.Tensor:
    """Matrix exponential of (..., d, d) by scaling and squaring, with one
    squaring count for the whole stack (see the module's note on its host
    sync). ``max_squarings`` bounds the count; matrices needing more lose
    accuracy rather than erroring. method: "pade13" (needs a linear solve),
    "taylor" (degree-12 Paterson-Stockmeyer, products only, accurate to
    f32 eps) or "auto" (taylor for float32, pade13 for float64).
    Differentiable by the Fréchet adjoint; for forward sensitivities use
    :func:`expm_frechet`."""
    return _ExpmFn.apply(A, max_squarings, method, False, 0)


def expm_m1(A: torch.Tensor, *, max_squarings: int = 16,
            method: str = "auto") -> torch.Tensor:
    """phi = expm(A) - I without the subtraction (the matrix ``expm1``):
    the Taylor path drops the identity of block 0, the Padé path solves
    Q phi = 2 U, and the squaring is phi^2 + 2 phi, so for small |A| the
    result keeps relative accuracy."""
    return _ExpmFn.apply(A, max_squarings, method, True, 0)


def expm_apply(A: torch.Tensor, x: torch.Tensor, **kw) -> torch.Tensor:
    """exp(A) @ x for (..., d, d) A and (..., d) x."""
    return (expm(A, **kw) @ x[..., None])[..., 0]

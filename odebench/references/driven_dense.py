"""Plain reference of the driven dense configurations: the propagator of
dpsi/dt = -i H(t) psi, H(t) = H0 + cos(w t) V, from t0 to each judged
time, applied to the call's initial states.

The operator is shared by every trajectory, so one propagator U(t) per
judged time serves a whole call: fixed Magnus-4 steps (two Gauss nodes,
Omega = h/2 (A1 + A2) + (sqrt 3 / 12) h^2 [A2, A1]), each exponential by
Taylor series with scaling and squaring, on the real embedding
[[Re A, -Im A], [Im A, Re A]] of A = -i H. In float64 with ``steps``
steps per unit time the propagator is exact to ~1e-12 at these sizes.

``tf32=True`` computes the same in float32 with every product's operands
rounded to TF32 (10 mantissa bits, as the tensor cores take them): the
control, the reference in the next precision below what the
configurations state (float32 with TF32 off).

Imports only torch and the standard library: nothing of the port.
"""

from __future__ import annotations

import math

import torch

SQRT3 = math.sqrt(3.0)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to the nearest TF32 value (ties to even)."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


def _mm(tf32: bool):
    if not tf32:
        return torch.matmul
    return lambda a, b: torch.matmul(tf32_round(a), tf32_round(b))


def real_embed(A: torch.Tensor, dtype) -> torch.Tensor:
    """Complex (..., d, d) -> real (..., 2d, 2d) [[re, -im], [im, re]]."""
    re, im = A.real.to(dtype), A.imag.to(dtype)
    return torch.cat([torch.cat([re, -im], -1), torch.cat([im, re], -1)], -2)


def expm(X: torch.Tensor, mm, terms: int) -> torch.Tensor:
    """exp of each (n, n) of X: scaled to a 1-norm of at most 1/2, a
    Taylor series of ``terms`` terms, squared back."""
    norm = X.abs().sum(-2).amax()
    s = max(0, math.ceil(math.log2(max(float(norm), 1e-300) / 0.5)))
    X = X / 2.0 ** s
    eye = torch.eye(X.shape[-1], dtype=X.dtype, device=X.device)
    E = eye + X
    P = X
    for k in range(2, terms + 1):
        P = mm(P, X) / k
        E = E + P
    for _ in range(s):
        E = mm(E, E)
    return E


def propagators(H0, V, w: float, t0: float, times, steps: int = 1000,
                tf32: bool = False) -> torch.Tensor:
    """U(t) for each t of ``times`` (increasing, past t0), real embedded
    (n_times, 2d, 2d), by Magnus-4 steps of at most 1/``steps``."""
    dtype = torch.float32 if tf32 else torch.float64
    mm, terms = _mm(tf32), (10 if tf32 else 18)
    dev = H0.device
    H0c, Vc = H0.to(torch.complex128), V.to(torch.complex128)
    A0 = real_embed(-1j * H0c, dtype)
    A1 = real_embed(-1j * Vc, dtype)
    n2 = A0.shape[-1]
    U = torch.eye(n2, dtype=dtype, device=dev)
    out, t = [], float(t0)
    for tk in times:
        n = max(1, math.ceil((tk - t) * steps - 1e-9))
        h = (tk - t) / n
        left = t + h * torch.arange(n, dtype=torch.float64, device=dev)
        mid = left + 0.5 * h
        c1 = torch.cos(w * (mid - SQRT3 / 6 * h)).to(dtype)[:, None, None]
        c2 = torch.cos(w * (mid + SQRT3 / 6 * h)).to(dtype)[:, None, None]
        Aa, Ab = A0 + c1 * A1, A0 + c2 * A1
        omega = (0.5 * h) * (Aa + Ab) + (SQRT3 / 12 * h * h) * (
            mm(Ab, Aa) - mm(Aa, Ab))
        E = expm(omega, mm, terms)
        for j in range(n):
            U = mm(E[j], U)
        out.append(U)
        t = tk
    return torch.stack(out)


def states(U: torch.Tensor, psi0: torch.Tensor, tf32: bool = False,
           block: int = 4096) -> torch.Tensor:
    """psi(t) = U(t) psi0 for complex (B, d) ``psi0``: complex128 (B,
    n_times, d), in row blocks."""
    d, n_t = psi0.shape[-1], U.shape[0]
    mm = _mm(tf32)
    stacked = U.reshape(n_t * 2 * d, 2 * d).T               # (2d, T 2d)
    out = []
    for p in psi0.split(block):
        x = torch.cat([p.real, p.imag], -1).to(U.dtype)      # (b, 2d)
        y = mm(x, stacked).reshape(-1, n_t, 2 * d).double()
        out.append(torch.complex(y[..., :d], y[..., d:]))
    return torch.cat(out)


def check_numbers(system, kept, control: bool = False) -> dict:
    """The numbers the output check compares, over the kept calls
    ((index, Solution) pairs): ``max_err``, the largest 2-norm of a
    judged state's distance from the reference's (states are unit norm,
    so it is relative), over rows and judged times; a non-finite state
    reads inf. ``control=True`` judges the control in the port's place:
    the same calls' states by :func:`propagators` and :func:`states` in
    TF32."""
    times = system.check_times()
    c = system.config
    t0 = float(system.mix["t0"])
    U = propagators(system.H0, system.V, system.w, t0, times,
                    c["reference_steps"])
    Uc = (propagators(system.H0, system.V, system.w, t0, times,
                      c["reference_steps"], tf32=True) if control else None)
    worst = 0.0
    for i, sol in kept:
        psi0 = system.initial_states(i)
        ref = states(U, psi0)
        got = (states(Uc, psi0, tf32=True) if control
               else system.outputs(sol))
        err = torch.linalg.vector_norm(got - ref, dim=-1)
        if not bool(torch.isfinite(err).all()):
            return {"max_err": math.inf}
        worst = max(worst, float(err.max()))
    return {"max_err": worst}

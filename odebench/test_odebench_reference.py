"""The plain reference against closed forms, and the TF32 rounding of the
control (CPU)."""

from __future__ import annotations

import math

import torch

from odebench.references import driven_dense as ref
from odebench.systems.driven_dense import make_operators


def hermitian(d, seed):
    g = torch.Generator().manual_seed(seed)
    M = torch.complex(torch.randn(d, d, generator=g, dtype=torch.float64),
                      torch.randn(d, d, generator=g, dtype=torch.float64))
    return (M + M.conj().T) / (2 * math.sqrt(d))


def test_constant_hamiltonian_is_matrix_exp():
    d, H0 = 4, hermitian(4, 1)
    times = [0.25, 0.5, 1.0]
    U = ref.propagators(H0, torch.zeros_like(H0), 1.0, 0.0, times, 50)
    psi0 = torch.complex(torch.randn(3, d, dtype=torch.float64),
                         torch.randn(3, d, dtype=torch.float64))
    got = ref.states(U, psi0)
    for k, t in enumerate(times):
        want = psi0 @ torch.linalg.matrix_exp(-1j * H0 * t).T
        assert torch.allclose(got[:, k], want, atol=1e-12, rtol=0)


def test_driven_system_against_fine_rk4():
    """The Magnus-4 propagator against classical RK4 with 20 000 steps on
    dpsi/dt = -i (H0 + cos(w t) V) psi."""
    d, w = 6, 1.3
    H0, V = hermitian(d, 2), hermitian(d, 3)
    psi = torch.complex(torch.randn(2, d, dtype=torch.float64),
                        torch.randn(2, d, dtype=torch.float64))
    got = ref.states(ref.propagators(H0, V, w, 0.0, [1.0], 1000), psi)[:, 0]

    def f(t, y):
        return -1j * (y @ (H0 + math.cos(w * t) * V).T)

    n, y = 20000, psi.clone()
    h = 1.0 / n
    for i in range(n):
        t = i * h
        k1 = f(t, y)
        k2 = f(t + h / 2, y + h / 2 * k1)
        k3 = f(t + h / 2, y + h / 2 * k2)
        k4 = f(t + h, y + h * k3)
        y = y + h / 6 * (k1 + 2 * k2 + 2 * k3 + k4)
    assert float((got - y).abs().max()) < 1e-11


def test_propagator_is_orthogonal_and_converged():
    H0, V = make_operators(0, 64, "cpu")
    U1 = ref.propagators(H0, V, 1.0, 0.0, [0.5, 1.0], 1000)
    U2 = ref.propagators(H0, V, 1.0, 0.0, [0.5, 1.0], 2000)
    eye = torch.eye(128, dtype=torch.float64)
    assert float((U1[-1] @ U1[-1].T - eye).abs().max()) < 1e-12
    assert float((U1 - U2).abs().max()) < 1e-12


def test_tf32_round():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -1.0 - 2 ** -12,
                      3.0e-3], dtype=torch.float32)
    r = ref.tf32_round(x)
    # ties to even at 10 mantissa bits
    assert r[0] == 1.0 and r[1] == 1.0 and r[2] == 1.0 + 4 * 2 ** -11
    assert r[3] == -1.0
    assert abs(float(r[4]) - 3.0e-3) <= 3.0e-3 * 2 ** -11
    bits = r.view(torch.int32) & 0x1FFF
    assert int(bits.abs().sum()) == 0

"""The one traffic generator: what a cell's ``workloads/<cell>.json``
asks for, drawn from the seed.

A mix gives ``batch`` (trajectories a call), ``pool_batches`` (P: the
pool holds P batches of unit-norm initial states, call i takes batch
i mod P), ``t0`` / ``tf``, ``save_at`` (interior save times), ``drive``
(read by the system) and ``check_calls`` (how many of the window's calls
the output check judges, drawn from the seed). The loop is closed: one
caller, each call waited for before the next. Every seed draws the same
sizes; only the values differ.
"""

from __future__ import annotations

import numpy as np
import torch

SEED_MASK = (1 << 63) - 1


def generator(seed: int, device: str) -> torch.Generator:
    """A generator on ``device`` seeded from any whole number."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & SEED_MASK)
    return gen


def unit_states(gen: torch.Generator, n: int, d: int, device: str):
    """n unit-norm complex d-vectors (complex Gaussian, normalised),
    complex128 on ``device``."""
    z = torch.complex(
        torch.randn(n, d, generator=gen, dtype=torch.float64, device=device),
        torch.randn(n, d, generator=gen, dtype=torch.float64, device=device))
    return z / torch.linalg.vector_norm(z, dim=-1, keepdim=True)


class Sampler:
    """A uniform sample of ``k`` of the window's calls, drawn from the
    seed while the calls come (reservoir sampling): holds (index, result)
    pairs, the result kept as the port returned it."""

    def __init__(self, k: int, seed: int):
        self.k, self.kept = k, []
        self.rng = np.random.default_rng([int(seed) & SEED_MASK, 7])

    def offer(self, i: int, result) -> None:
        if len(self.kept) < self.k:
            self.kept.append((i, result))
            return
        j = int(self.rng.integers(0, i + 1))
        if j < self.k:
            self.kept[j] = (i, result)

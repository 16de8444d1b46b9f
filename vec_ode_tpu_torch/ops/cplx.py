"""Complex states as (re, im) pairs of real tensors, as in
``vec_ode_tpu/ops/cplx.py``. Keeping the pair (rather than torch's complex
dtypes) lets results compare field by field with the JAX package.

Matrices use the ring embedding z = x + iy <-> [[x, -y], [y, x]], so a
d-dim complex matvec is one real (2d)-wide product.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Cplx(NamedTuple):
    """Complex tensor as a (re, im) pair of real tensors."""

    re: torch.Tensor
    im: torch.Tensor

    @property
    def shape(self):
        return self.re.shape

    @property
    def dtype(self):
        return self.re.dtype


def from_complex(z, dtype=torch.float64, device="cuda") -> Cplx:
    """Split a complex numpy array or tensor into a real pair, on the card
    unless ``device`` names another."""
    if isinstance(z, torch.Tensor):
        return Cplx(z.real.to(device=device, dtype=dtype),
                    z.imag.to(device=device, dtype=dtype))
    z = np.asarray(z)
    return Cplx(torch.as_tensor(z.real, dtype=dtype, device=device),
                torch.as_tensor(z.imag, dtype=dtype, device=device))


def to_complex(c: Cplx) -> torch.Tensor:
    """Reassemble a complex tensor."""
    return torch.complex(c.re, c.im)


def embed(A: Cplx) -> torch.Tensor:
    """Ring embedding (..., d, d) Cplx -> (..., 2d, 2d) real:
    [[Ar, -Ai], [Ai, Ar]]."""
    top = torch.cat([A.re, -A.im], dim=-1)
    bot = torch.cat([A.im, A.re], dim=-1)
    return torch.cat([top, bot], dim=-2)


def extract(M: torch.Tensor) -> Cplx:
    """Inverse of :func:`embed` (reads the first block column)."""
    d = M.shape[-1] // 2
    return Cplx(M[..., :d, :d], M[..., d:, :d])


def cmatmul(A: Cplx, B: Cplx) -> Cplx:
    """Complex matmul via 3 real matmuls (the Karatsuba/Gauss trick, as the
    JAX package computes it)."""
    t1 = A.re @ B.re
    t2 = A.im @ B.im
    t3 = (A.re + A.im) @ (B.re + B.im)
    return Cplx(t1 - t2, t3 - t1 - t2)

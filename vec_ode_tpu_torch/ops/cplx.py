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


def _as_complex_scalar(o):
    """(re, im) floats if ``o`` is a complex-kind scalar (python complex or
    any np.complexfloating), else None."""
    if isinstance(o, (complex, np.complexfloating)):
        zc = complex(o)
        return zc.real, zc.imag
    return None


class Cplx(NamedTuple):
    """Complex tensor as a (re, im) pair of real tensors, with elementwise
    complex arithmetic (a bare tuple would concatenate under ``+``)."""

    re: torch.Tensor
    im: torch.Tensor

    # numpy must not consume a Cplx (a tuple) as an array-like: a numpy
    # scalar on the left of * defers to __rmul__ instead
    __array_ufunc__ = None

    @property
    def shape(self):
        return self.re.shape

    @property
    def dtype(self):
        return self.re.dtype

    def __add__(self, o):
        if isinstance(o, Cplx):
            return Cplx(self.re + o.re, self.im + o.im)
        z = _as_complex_scalar(o)
        if z is not None:
            return Cplx(self.re + z[0], self.im + z[1])
        return Cplx(self.re + o, self.im)

    def __sub__(self, o):
        if isinstance(o, Cplx):
            return Cplx(self.re - o.re, self.im - o.im)
        z = _as_complex_scalar(o)
        if z is not None:
            return Cplx(self.re - z[0], self.im - z[1])
        return Cplx(self.re - o, self.im)

    def __rsub__(self, o):
        return (-self).__add__(o)

    def __neg__(self):
        return Cplx(-self.re, -self.im)

    def __mul__(self, o):
        if isinstance(o, Cplx):
            return Cplx(self.re * o.re - self.im * o.im,
                        self.re * o.im + self.im * o.re)
        z = _as_complex_scalar(o)
        if z is not None:
            return cscale(self, complex(z[0], z[1]))
        return Cplx(self.re * o, self.im * o)

    __rmul__ = __mul__
    __radd__ = __add__


def cplx(re, im=None) -> Cplx:
    """A pair from its real part and, optionally, its imaginary part (zeros
    like ``re`` without one); tensors stay where they lie, anything else
    becomes a tensor on the CPU."""
    re = torch.as_tensor(re)
    return Cplx(re, torch.zeros_like(re) if im is None
                else torch.as_tensor(im, device=re.device))


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


def cconj(c: Cplx) -> Cplx:
    return Cplx(c.re, -c.im)


def cabs2(c: Cplx) -> torch.Tensor:
    return c.re * c.re + c.im * c.im


def cscale(c: Cplx, z) -> Cplx:
    """Multiply by a python / numpy complex scalar."""
    zr, zi = float(z.real), float(z.imag)
    if zi == 0.0:
        return Cplx(c.re * zr, c.im * zr)
    return Cplx(c.re * zr - c.im * zi, c.re * zi + c.im * zr)


def cscale_any(c: Cplx, z) -> Cplx:
    """Scale by a python / numpy scalar (real or complex), a real or
    complex tensor scalar (cast to the pair's dtype; a batched one scales
    per trajectory), or a scalar Cplx: the one entry point operator code
    uses."""
    if isinstance(z, Cplx):
        return c * z
    if isinstance(z, complex) or (isinstance(z, np.generic)
                                  and np.iscomplexobj(z)):
        return cscale(c, complex(z))
    if isinstance(z, (int, float)) or isinstance(z, np.generic):
        z = float(z)
        return Cplx(c.re * z, c.im * z)
    zt = torch.as_tensor(z, device=c.re.device)
    if 0 < zt.ndim < c.re.ndim:
        zt = zt.reshape(zt.shape + (1,) * (c.re.ndim - zt.ndim))
    if zt.is_complex():
        # a real cast would silently drop the imaginary part
        return c * Cplx(zt.real.to(c.re.dtype), zt.imag.to(c.re.dtype))
    zt = zt.to(c.re.dtype)
    return Cplx(c.re * zt, c.im * zt)


def apply_embedded(M: torch.Tensor, x: Cplx) -> Cplx:
    """Apply an embedded real (..., 2d, 2d) matrix to a Cplx vector with
    one widened real matvec."""
    xw = torch.cat([x.re, x.im], dim=-1)
    yw = (M @ xw[..., None])[..., 0]
    d = x.re.shape[-1]
    return Cplx(yw[..., :d], yw[..., d:])


def cmatvec(A: Cplx, x: Cplx) -> Cplx:
    """(..., d, d) Cplx @ (..., d) Cplx -> (..., d) Cplx, as one real
    product with the (2d, 2d) embedding."""
    return apply_embedded(embed(A), x)


def cexp(c: Cplx) -> Cplx:
    """Elementwise complex exp: e^{re} (cos im, sin im)."""
    m = torch.exp(c.re)
    return Cplx(m * torch.cos(c.im), m * torch.sin(c.im))


def cexpm1(c: Cplx) -> Cplx:
    """Elementwise complex expm1, e^z - 1 with relative accuracy for small
    |z|: re = expm1(a) cos b - 2 sin^2(b/2), im = e^a sin b."""
    half = torch.sin(0.5 * c.im)
    return Cplx(torch.expm1(c.re) * torch.cos(c.im) - 2.0 * half * half,
                torch.exp(c.re) * torch.sin(c.im))


def cexpm(A: Cplx, *, max_squarings: int = 16) -> Cplx:
    """Complex matrix exponential via the real ring embedding."""
    from .expm import expm

    return extract(expm(embed(A), max_squarings=max_squarings))


def cexpm_apply(A: Cplx, x: Cplx, **kw) -> Cplx:
    """exp(A) x for a (..., d, d) Cplx A and (..., d) Cplx x (``kw`` as
    :func:`cexpm`)."""
    return cmatvec(cexpm(A, **kw), x)

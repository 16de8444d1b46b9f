"""Carrying problems and results across from the JAX package as numpy
arrays, so both sides solve the same inputs and compare field by field."""

from __future__ import annotations

import numpy as np
import torch
from torch.utils import _pytree as pytree

from .exp.modulated import ModulatedOperator
from .models.quantum import PulseControl
from .ops.cplx import Cplx
from .ops.expmv import CoeffForm
from .ops.fused_rk import FusedModulatedLinearRK
from .tableaus import RKF45


def stepper_from_numpy(M0, M1, w, *, tableau=RKF45, advance_lower=True,
                       device="cuda", dtype=torch.float64):
    """A ``FusedModulatedLinearRK`` over the embedded (2d, 2d) matrices as
    the JAX package's ``FusedModulatedLinearRK.from_driven_dense`` builds
    them (``np.asarray(stepper.M0)``), with the drive cos(w t), on the
    card unless ``device`` names another."""
    return FusedModulatedLinearRK(
        M0=torch.as_tensor(np.asarray(M0), dtype=dtype, device=device),
        M1=torch.as_tensor(np.asarray(M1), dtype=dtype, device=device),
        w=float(w), tableau=tableau, advance_lower=advance_lower,
    )


def modulated_from_numpy(basis_re, basis_im, form: CoeffForm, *,
                         dtype=torch.float64, device="cuda",
                         ext_basis_w=None) -> ModulatedOperator:
    """A ``ModulatedOperator`` over the basis the JAX package's operator
    holds (``np.asarray(op.basis.re)``, ``.im``; ``basis_im=None`` for a
    real (K, D, D) basis) with the declared coefficient ``form`` as its
    ``coeff_fn``, on the card unless ``device`` names another.
    ``ext_basis_w``: the JAX stepper's commutator-extended working basis
    (``np.asarray(MagnusModulated4(...)._ext_basis_w)``), which Magnus-4
    then uses as it is, so that both packages step over identical
    matrices."""
    def tensor(a):  # a copy: arrays from jax are read-only
        return torch.as_tensor(np.array(a), dtype=dtype, device=device)

    basis = (tensor(basis_re) if basis_im is None
             else Cplx(tensor(basis_re), tensor(basis_im)))
    return ModulatedOperator(
        basis=basis, coeff_fn=form.sample, form=form,
        ext_basis=None if ext_basis_w is None else tensor(ext_basis_w))


def driven_op_from_numpy(H0, V, w, *, dtype=torch.float64, device="cuda"):
    """The generic steppers' ``op_fn(t) -> Cplx`` for A(t) = -i (H0 +
    cos(w t) V) from the JAX model's numpy ``H0``, ``V`` (complex (d, d))
    and ``w`` (``vec_ode_tpu.models.DrivenDense``), as
    ``DrivenDense.op_pair`` assembles it: -i (Hr + i Hi) = (Hi, -Hr), the
    cosine taken in ``dtype``. H0 and V are put on ``device`` (the card
    unless it names another) once; the callable runs under
    ``torch.func.vmap``."""
    H0 = state_from_numpy(np.real(H0), np.imag(H0), device=device,
                          dtype=dtype)
    V = state_from_numpy(np.real(V), np.imag(V), device=device, dtype=dtype)
    w = float(w)

    def op_fn(t):
        c = torch.cos(w * t.to(dtype))
        return Cplx(H0.im + c * V.im, -(H0.re + c * V.re))

    return op_fn


def pulse_control_from_numpy(H0, Hc, T, n_modes) -> PulseControl:
    """The port's ``PulseControl`` from a JAX ``PulseControl``'s fields
    (``np.asarray(pc.H0)``, ``pc.Hc``, ``pc.T``, ``pc.n_modes``)."""
    return PulseControl(H0=np.array(H0), Hc=np.array(Hc), T=float(T),
                        n_modes=int(n_modes))


def basis_from_numpy(re, im=None, *, dtype=torch.float64, device="cuda"):
    """A basis from numpy: a Cplx (K, d, d) from (re, im) (``np.asarray
    (basis.re)``, ``.im`` of a JAX Cplx basis), or a real (K, D, D) tensor
    when ``im`` is None, in ``dtype`` on the card unless ``device`` names
    another."""
    def tensor(a):  # a copy: arrays from jax are read-only
        return torch.as_tensor(np.array(a), dtype=dtype, device=device)

    return tensor(re) if im is None else Cplx(tensor(re), tensor(im))


def state_from_numpy(re, im, *, device="cuda",
                     dtype=torch.float64) -> Cplx:
    """A Cplx state from numpy (re, im) parts, on the card unless
    ``device`` names another."""
    return Cplx(torch.as_tensor(np.asarray(re), dtype=dtype, device=device),
                torch.as_tensor(np.asarray(im), dtype=dtype, device=device))


def solution_to_numpy(sol) -> dict:
    """The Solution's array fields as numpy arrays (Cplx fields as Cplx of
    arrays), keyed by field name, plus ``path``."""
    def conv(v):
        return pytree.tree_map(lambda a: a.detach().cpu().numpy(), v)

    keys = ("ts", "ys", "t_final", "y_final", "status", "n_accept",
            "n_reject", "n_iters", "h_final")
    out = {k: conv(getattr(sol, k)) for k in keys}
    out["path"] = sol.path
    return out

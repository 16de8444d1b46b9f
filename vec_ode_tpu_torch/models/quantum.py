"""Quantum model family (the part of ``vec_ode_tpu/models/quantum.py`` the
ensemble paths use): time-dependent Schrödinger problems
dpsi/dt = -i H(t) psi."""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class LandauZener:
    """2-level avoided crossing: H(t) = (v t) sigma_z / 2 + (delta / 2)
    sigma_x. Asymptotic transition probability (diabatic basis, sweep
    -T -> +T): P_LZ = exp(-pi delta^2 / (2 v))."""

    v: float = 1.0      # sweep rate
    delta: float = 0.5  # gap

    def hamiltonian(self, t) -> torch.Tensor:
        """H(t) as a complex128 tensor (..., 2, 2)."""
        sz = torch.tensor([[0.5, 0.0], [0.0, -0.5]], dtype=torch.complex128)
        sx = torch.tensor([[0.0, 0.5], [0.5, 0.0]], dtype=torch.complex128)
        td = torch.as_tensor(t, dtype=torch.float64)[..., None, None]
        return (self.v * td) * sz + self.delta * sx

    @property
    def p_transition(self) -> float:
        return math.exp(-math.pi * self.delta ** 2 / (2.0 * self.v))

    def modulated(self, dtype=torch.float32, device="cuda"):
        """A(t) = v t (-i sz) + delta (-i sx) as a ModulatedOperator with
        the declared form [v t, delta], on the card unless ``device`` names
        another."""
        from ..exp.modulated import CoeffForm, ModulatedOperator
        from ..ops.cplx import Cplx

        sz = torch.tensor([[0.5, 0.0], [0.0, -0.5]], dtype=dtype,
                          device=device)
        sx = torch.tensor([[0.0, 0.5], [0.5, 0.0]], dtype=dtype,
                          device=device)
        basis = Cplx(torch.zeros(2, 2, 2, dtype=dtype, device=device),
                     torch.stack([-sz, -sx]))
        form = CoeffForm(a=(0.0, self.delta), b=(self.v, 0.0),
                         c=(0.0, 0.0), w=(0.0, 0.0))
        return ModulatedOperator(basis=basis, coeff_fn=form.sample,
                                 form=form)


@dataclasses.dataclass(frozen=True)
class DrivenDense:
    """Driven dense Hamiltonian H(t) = H0 + cos(w t) V, d-dimensional,
    with H0 and V host-side complex numpy arrays. ``make`` is the JAX
    package's numpy code, so a seed gives bit-identical H0, V and w."""

    H0: np.ndarray
    V: np.ndarray
    w: float = 1.0

    def __post_init__(self):
        # op_pair's operators by (dtype, device), made at first use
        object.__setattr__(self, "_op_fns", {})

    @staticmethod
    def make(d: int = 64, seed: int = 0, w: float = 1.0):
        rng = np.random.default_rng(seed)
        M = rng.standard_normal((d, d)) + 1j * rng.standard_normal((d, d))
        H0 = (M + M.conj().T) / (2 * math.sqrt(d))
        N = rng.standard_normal((d, d)) + 1j * rng.standard_normal((d, d))
        V = (N + N.conj().T) / (2 * math.sqrt(d))
        return DrivenDense(H0=H0, V=V, w=w)

    @staticmethod
    def _time_on(t, device) -> torch.Tensor:
        """A time on ``device``: a python number is created there as
        float64; a tensor must already lie there."""
        device = torch.device(device)
        if not isinstance(t, torch.Tensor):
            return torch.tensor(t, dtype=torch.float64, device=device)
        if t.device.type != device.type or (
                device.index is not None and t.device.index != device.index):
            raise ValueError(
                f"DrivenDense: t lies on {t.device}, the operator was asked "
                f"for on {device}; pass device={str(t.device)!r}")
        return t

    def hamiltonian(self, t, dtype=torch.complex128,
                    device="cuda") -> torch.Tensor:
        """H(t) = H0 + cos(w t) V as a complex tensor, the cosine taken in
        float64, on the card unless ``device`` names another."""
        td = self._time_on(t, device).to(torch.float64)
        c = torch.cos(self.w * td).to(dtype)
        return (torch.as_tensor(self.H0, dtype=dtype, device=td.device)
                + c * torch.as_tensor(self.V, dtype=dtype, device=td.device))

    def op(self, t, device="cuda") -> torch.Tensor:
        """A(t) = -i H(t), complex128, on the card unless ``device`` names
        another."""
        return -1j * self.hamiltonian(t, device=device)

    def pair_parts(self, dtype=torch.float32, device="cuda"):
        """(H0, V) as Cplx pairs in the given real dtype, on the card
        unless ``device`` names another."""
        from ..ops.cplx import from_complex

        return (from_complex(self.H0, dtype, device=device),
                from_complex(self.V, dtype, device=device))

    def op_pair(self, t, dtype=torch.float32, device="cuda"):
        """A(t) = -i H(t) as a Cplx pair, -i (Hr + i Hi) = (Hi, -Hr), the
        cosine taken in ``dtype``, on the card unless ``device`` names
        another. Callable under ``torch.func.vmap``: the generic steppers'
        ``op_fn``. H0 and V go to the device once per (dtype, device) and
        stay there."""
        from ..convert import driven_op_from_numpy

        t = self._time_on(t, device)
        key = (dtype, t.device)
        if key not in self._op_fns:
            self._op_fns[key] = driven_op_from_numpy(
                self.H0, self.V, self.w, dtype=dtype, device=t.device)
        return self._op_fns[key](t)

    def modulated(self, dtype=torch.float32, device="cuda"):
        """A(t) = -i H0 + cos(w t) (-i V) as a ModulatedOperator with the
        declared form [1, cos(w t)], on the card unless ``device`` names
        another."""
        from ..exp.modulated import CoeffForm, ModulatedOperator
        from ..ops.cplx import Cplx

        H0, V = self.pair_parts(dtype, device)
        basis = Cplx(torch.stack([H0.im, V.im]),      # re(-iH) = im(H)
                     torch.stack([-H0.re, -V.re]))    # im(-iH) = -re(H)
        form = CoeffForm(a=(1.0, 0.0), b=(0.0, 0.0), c=(0.0, 1.0),
                         w=(0.0, float(self.w)))
        return ModulatedOperator(basis=basis, coeff_fn=form.sample,
                                 form=form)

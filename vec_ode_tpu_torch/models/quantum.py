"""Quantum model family (the part of ``vec_ode_tpu/models/quantum.py`` the
ensemble and adjoint paths use): time-dependent Schrödinger problems
dpsi/dt = -i H(t) psi, and open systems (Lindblad master equations) over
vectorised density matrices."""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


def _time_on(t, device, model: str) -> torch.Tensor:
    """A time on ``device``: a python number is created there as float64;
    a tensor must already lie there."""
    device = torch.device(device)
    if not isinstance(t, torch.Tensor):
        return torch.tensor(t, dtype=torch.float64, device=device)
    if t.device.type != device.type or (
            device.index is not None and t.device.index != device.index):
        raise ValueError(
            f"{model}: t lies on {t.device}, the operator was asked for on "
            f"{device}; pass device={str(t.device)!r}")
    return t


@dataclasses.dataclass(frozen=True)
class LandauZener:
    """2-level avoided crossing: H(t) = (v t) sigma_z / 2 + (delta / 2)
    sigma_x. Asymptotic transition probability (diabatic basis, sweep
    -T -> +T): P_LZ = exp(-pi delta^2 / (2 v))."""

    v: float = 1.0      # sweep rate
    delta: float = 0.5  # gap

    def hamiltonian(self, t) -> torch.Tensor:
        """H(t) as a complex128 tensor (..., 2, 2), where t lies (a python
        time on the CPU)."""
        td = torch.as_tensor(t, dtype=torch.float64)
        sz = torch.tensor([[0.5, 0.0], [0.0, -0.5]], dtype=torch.complex128,
                          device=td.device)
        sx = torch.tensor([[0.0, 0.5], [0.5, 0.0]], dtype=torch.complex128,
                          device=td.device)
        return (self.v * td[..., None, None]) * sz + self.delta * sx

    def op(self, t, device="cuda") -> torch.Tensor:
        """A(t) = -i H(t), complex128, on the card unless ``device`` names
        another."""
        return -1j * self.hamiltonian(_time_on(t, device, "LandauZener"))

    def op_pair(self, t, dtype=torch.float32, device="cuda"):
        """A(t) = -i H(t) as a Cplx pair, (0, -H) since H = v t sz + delta sx
        is real, in the JAX package's order ((t v) sz + delta sx, t taken in
        ``dtype``), on the card unless ``device`` names another. Callable
        under ``torch.func.vmap``: a black-box ``op_fn``."""
        from ..ops.cplx import Cplx

        t = _time_on(t, device, "LandauZener")
        sz = torch.tensor([[0.5, 0.0], [0.0, -0.5]], dtype=dtype,
                          device=t.device)
        sx = torch.tensor([[0.0, 0.5], [0.5, 0.0]], dtype=dtype,
                          device=t.device)
        H = t.to(dtype) * self.v * sz + self.delta * sx
        return Cplx(torch.zeros_like(H), -H)

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
        # the operators of op_pair, rhs and rhs_pair by (dtype, device),
        # made at first use
        object.__setattr__(self, "_op_fns", {})

    @staticmethod
    def make(d: int = 64, seed: int = 0, w: float = 1.0):
        rng = np.random.default_rng(seed)
        M = rng.standard_normal((d, d)) + 1j * rng.standard_normal((d, d))
        H0 = (M + M.conj().T) / (2 * math.sqrt(d))
        N = rng.standard_normal((d, d)) + 1j * rng.standard_normal((d, d))
        V = (N + N.conj().T) / (2 * math.sqrt(d))
        return DrivenDense(H0=H0, V=V, w=w)

    def hamiltonian(self, t, dtype=torch.complex128,
                    device="cuda") -> torch.Tensor:
        """H(t) = H0 + cos(w t) V as a complex tensor, the cosine taken in
        float64, on the card unless ``device`` names another."""
        td = _time_on(t, device, "DrivenDense").to(torch.float64)
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

        t = _time_on(t, device, "DrivenDense")
        return self._cached((dtype, t.device), lambda: driven_op_from_numpy(
            self.H0, self.V, self.w, dtype=dtype, device=t.device))(t)

    def _cached(self, key, make):
        """What ``make()`` returns, made once per key (the operators on
        each (dtype, device))."""
        if key not in self._op_fns:
            self._op_fns[key] = make()
        return self._op_fns[key]

    def rhs(self, t, psi):
        """dpsi/dt = -i H(t) psi on complex states (..., d): the operator
        in complex128 (the cosine in float64) on psi's device, the product
        in the promoted dtype. H0 and V go to the device once."""
        dev = psi.device
        td = _time_on(t, dev, "DrivenDense").to(torch.float64)
        H0, V = self._cached(("rhs", dev), lambda: (
            torch.as_tensor(self.H0, dtype=torch.complex128, device=dev),
            torch.as_tensor(self.V, dtype=torch.complex128, device=dev)))
        A = -1j * (H0 + torch.cos(self.w * td).to(torch.complex128) * V)
        dt = torch.promote_types(A.dtype, psi.dtype)
        return torch.einsum("ij,...j->...i", A.to(dt), psi.to(dt))

    def rhs_pair(self, t, psi, dtype=torch.float32):
        """dpsi/dt = -i H(t) psi on Cplx states (..., d), the ensemble RHS
        of the JAX package's flagship entry: the cosine taken in ``dtype``
        and applied to the V term's output, so that both terms are ONE
        product of the widened state [re | im] with the shared (2d, 4d)
        matrix [embed(-i H0)^T | embed(-i V)^T]; under ``torch.func.vmap``
        that is one (B, 2d) x (2d, 4d) GEMM a stage, no (B, d, d) operator.
        The matrix is made on psi's device once per (dtype, device)."""
        from ..ops.cplx import Cplx, embed, from_complex

        dev, d = psi.re.device, psi.re.shape[-1]

        def make():
            H0, V = (from_complex(m, dtype, device=dev)
                     for m in (self.H0, self.V))
            return torch.cat([embed(Cplx(H.im, -H.re)).T for H in (H0, V)],
                             dim=-1).contiguous()

        W = self._cached(("pair", dtype, dev), make)
        c = torch.cos(self.w * _time_on(t, dev, "DrivenDense").to(dtype))
        y = torch.cat([psi.re, psi.im], dim=-1) @ W
        cv = c * y[..., 2 * d:]
        # re and im each made contiguous, so that the stepper's stage sums
        # over them take torch's vectorised elementwise kernels
        return Cplx(y[..., :d] + cv[..., :d], y[..., d:2 * d] + cv[..., d:])

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


@dataclasses.dataclass(frozen=True)
class PulseControl:
    """Quantum optimal control (state transfer): H(t; theta) = H0 +
    u(t; theta) Hc with the sine-series pulse u(t; theta) = sum_j theta_j
    sin(j pi t / T), which vanishes at both ends. Maximising the transfer
    fidelity |<tgt|psi(T)>|^2 over theta is the workload of
    :func:`vec_ode_tpu_torch.diff.adjoint_solve`: many optimiser steps,
    each a full solve and an O(1)-memory gradient. H0 and Hc are host-side
    complex numpy arrays; ``make`` is the JAX package's numpy code, so a
    seed gives bit-identical matrices."""

    H0: np.ndarray          # (d, d) complex Hermitian drift
    Hc: np.ndarray          # (d, d) complex Hermitian control
    T: float = 3.0          # pulse duration
    n_modes: int = 4        # sine modes of the pulse

    def __post_init__(self):
        # basis_pair's bases by (dtype, device), made at first use
        object.__setattr__(self, "_bases", {})

    @staticmethod
    def make(d: int = 4, seed: int = 0, T: float = 3.0, n_modes: int = 4):
        rng = np.random.default_rng(seed)
        M = rng.standard_normal((d, d)) + 1j * rng.standard_normal((d, d))
        H0 = (M + M.conj().T) / (2 * math.sqrt(d))
        N = rng.standard_normal((d, d)) + 1j * rng.standard_normal((d, d))
        Hc = (N + N.conj().T) / (2 * math.sqrt(d))
        return PulseControl(H0=H0, Hc=Hc, T=T, n_modes=n_modes)

    def basis_pair(self, dtype=torch.float64, device="cuda"):
        """The Cplx (2, d, d) basis [-i H0, -i Hc], -i (Hr + i Hi) = (Hi,
        -Hr), on the card unless ``device`` names another; made once per
        (dtype, device)."""
        from ..ops.cplx import Cplx, from_complex

        key = (dtype, torch.device(device))
        if key not in self._bases:
            H0 = from_complex(self.H0, dtype, device=device)
            Hc = from_complex(self.Hc, dtype, device=device)
            self._bases[key] = Cplx(torch.stack([H0.im, Hc.im]),
                                    torch.stack([-H0.re, -Hc.re]))
        return self._bases[key]

    def coeff_fn(self, t, theta):
        """(..., 2) coefficients [1, u(t; theta)] for times t (...,),
        differentiable in theta and t; the operations in the JAX package's
        order (pi / T first). A Python time is taken in float64."""
        if not isinstance(t, torch.Tensor):
            t = torch.tensor(t, dtype=torch.float64, device=theta.device)
        j = torch.arange(1, self.n_modes + 1, dtype=theta.dtype,
                         device=theta.device)
        u = torch.sum(theta * torch.sin(j * (math.pi / self.T)
                                        * t[..., None]), dim=-1)
        return torch.stack([torch.ones_like(u), u], dim=-1)

    def pulse(self, t, theta):
        """u(t; theta) alone."""
        return self.coeff_fn(t, theta)[..., 1]

    @staticmethod
    def fidelity(psi, tgt):
        """|<tgt|psi>|^2 for Cplx states (trailing state axis)."""
        re = torch.sum(tgt.re * psi.re + tgt.im * psi.im, dim=-1)
        im = torch.sum(tgt.re * psi.im - tgt.im * psi.re, dim=-1)
        return re * re + im * im

    def infidelity(self, theta, psi0, tgt, *, n_steps=256, order=4,
                   dtype=torch.float64):
        """1 - the fidelity summed over the batch of the theta-controlled
        transfer psi0 -> tgt at t = T, differentiable through the
        O(1)-memory reversible adjoint; runs where psi0 lies."""
        from ..diff import adjoint_solve

        yf = adjoint_solve(self.basis_pair(dtype, psi0.re.device),
                           self.coeff_fn, theta, psi0, 0.0, self.T,
                           n_steps=n_steps, order=order)
        return 1.0 - torch.sum(self.fidelity(yf, tgt))

    def gate_infidelity(self, theta, U_target, *, n_steps=256, order=4,
                        dtype=torch.float64):
        """1 - |tr(U_target^dagger U(T; theta)) / d|^2, gate synthesis: the
        d basis columns go through the same adjoint solve as one batch;
        runs where theta lies."""
        from ..diff import adjoint_solve
        from ..ops.cplx import Cplx

        Ut = np.asarray(U_target)
        d = Ut.shape[-1]
        dev = theta.device
        cols0 = Cplx(torch.eye(d, dtype=dtype, device=dev),
                     torch.zeros((d, d), dtype=dtype, device=dev))
        yf = adjoint_solve(self.basis_pair(dtype, dev), self.coeff_fn,
                           theta, cols0, 0.0, self.T, n_steps=n_steps,
                           order=order)
        # yf rows are U(T) columns: yf[j] = U e_j; overlap tr(Ut^dagger U)/d
        Ur = torch.tensor(Ut.real, dtype=dtype, device=dev)
        Ui = torch.tensor(Ut.imag, dtype=dtype, device=dev)
        re = torch.sum(Ur.T * yf.re + Ui.T * yf.im) / d
        im = torch.sum(Ur.T * yf.im - Ui.T * yf.re) / d
        return 1.0 - (re * re + im * im)


@dataclasses.dataclass(frozen=True)
class Lindblad:
    """Open-system (Lindblad master equation) dynamics as a modulated
    linear ODE over vectorised density matrices:

        d rho / dt = -i [H0 + u(t) Hc, rho] + sum_j gamma_j D[L_j] rho,
        D[L] rho = L rho L^dagger - (L^dagger L rho + rho L^dagger L) / 2.

    Column-stacking vec(rho) turns every term into a d^2-dim
    superoperator, so A(t) = S_drift + u(t) S_ctrl has the shared-basis
    structure of the modulated steppers (K = 2 terms; at d = 8 the widened
    width 2 d^2 is 128). H0, Hc and the jump operators are host-side
    complex numpy arrays; ``make`` and the superoperators are the JAX
    package's numpy code, so a seed gives bit-identical matrices."""

    H0: np.ndarray                  # (d, d) complex Hermitian drift
    Hc: np.ndarray                  # (d, d) complex Hermitian control
    jumps: tuple                    # ((gamma_j, L_j (d, d) complex), ...)

    @staticmethod
    def make(d: int = 4, seed: int = 0, gamma: float = 0.1):
        """A random drift and control and one lowering-ladder jump."""
        rng = np.random.default_rng(seed)
        M = rng.standard_normal((d, d)) + 1j * rng.standard_normal((d, d))
        H0 = (M + M.conj().T) / (2 * math.sqrt(d))
        N = rng.standard_normal((d, d)) + 1j * rng.standard_normal((d, d))
        Hc = (N + N.conj().T) / (2 * math.sqrt(d))
        L = np.diag(np.ones(d - 1), k=1).astype(complex)
        return Lindblad(H0=H0, Hc=Hc, jumps=((gamma, L),))

    def _super_commutator(self, H):
        d = H.shape[0]
        eye = np.eye(d)
        return -1j * (np.kron(eye, H) - np.kron(H.T, eye))

    def _super_dissipator(self):
        d = self.H0.shape[0]
        eye = np.eye(d)
        S = np.zeros((d * d, d * d), complex)
        for g, L in self.jumps:
            LdL = L.conj().T @ L
            S += g * (np.kron(L.conj(), L)
                      - 0.5 * (np.kron(eye, LdL) + np.kron(LdL.T, eye)))
        return S

    def superop_basis(self, dtype=torch.float64, device="cuda"):
        """Cplx (2, d^2, d^2): [drift + dissipators, control commutator],
        on the card unless ``device`` names another."""
        from ..ops.cplx import Cplx

        S = np.stack([self._super_commutator(self.H0)
                      + self._super_dissipator(),
                      self._super_commutator(self.Hc)])
        return Cplx(torch.as_tensor(S.real, dtype=dtype, device=device),
                    torch.as_tensor(S.imag, dtype=dtype, device=device))

    def modulated(self, u_fn, dtype=torch.float32, device="cuda", form=None):
        """A(t) = S0 + u(t) S1 as a ModulatedOperator, on the card unless
        ``device`` names another. ``u_fn`` is the control envelope: a
        callable t -> u(t) (the operator then has no declared form and its
        solves take the per-step path, as the JAX package's do), or a
        one-term ``CoeffForm`` u(t) = a + b t + c cos(w t), which declares
        it, so that the whole loop runs in the loop kernel. ``form``
        declares a callable ``u_fn`` the same way (it must compute that
        form)."""
        from ..exp.modulated import CoeffForm, ModulatedOperator

        if isinstance(u_fn, CoeffForm):
            form = u_fn if form is None else form
        if form is not None and form.n_terms != 1:
            raise ValueError(f"Lindblad.modulated: the control's form has "
                             f"one term, got {form.n_terms}")
        op_form = None if form is None else CoeffForm(
            a=(1.0, form.a[0]), b=(0.0, form.b[0]), c=(0.0, form.c[0]),
            w=(0.0, form.w[0]))
        if isinstance(u_fn, CoeffForm):
            coeff = op_form.sample
        else:
            def coeff(t):
                return torch.stack([torch.ones_like(t), u_fn(t)], dim=-1)
        return ModulatedOperator(basis=self.superop_basis(dtype, device),
                                 coeff_fn=coeff, form=op_form)

    @staticmethod
    def vec_rho(rho, dtype=torch.float64, device="cuda"):
        """Density matrices (..., d, d) complex (numpy) -> a Cplx (...,
        d^2) column-stacked state (Fortran order, the Kronecker
        convention), on the card unless ``device`` names another."""
        from ..ops.cplx import from_complex

        r = np.asarray(rho)
        v = np.reshape(np.swapaxes(r, -1, -2), r.shape[:-2] + (-1,))
        return from_complex(v, dtype, device=device)

    @staticmethod
    def unvec_rho(v):
        """A Cplx (..., d^2) state -> complex numpy (..., d, d)."""
        z = v.re.detach().cpu().numpy() + 1j * v.im.detach().cpu().numpy()
        d = int(round(math.sqrt(z.shape[-1])))
        return np.swapaxes(z.reshape(z.shape[:-1] + (d, d)), -1, -2)

    @staticmethod
    def trace(v):
        """tr(rho) of Cplx (..., d^2) states, as (re, im) tensors: the sum
        of the diagonal entries, at column-stacked indices i (d + 1)."""
        d = int(round(math.sqrt(v.re.shape[-1])))
        diag = torch.arange(d, device=v.re.device) * (d + 1)
        return v.re[..., diag].sum(-1), v.im[..., diag].sum(-1)

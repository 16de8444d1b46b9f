"""Fused Runge-Kutta step for ensembles of dx/dt = (M0 + u(t) M1) x, the
counterpart of ``vec_ode_tpu/ops/pallas_rk.py``.

The workload is many independent trajectories of one linear system with
SHARED matrices M0, M1 and a per-trajectory scalar drive u(t), e.g. a
driven Hamiltonian H(t) = H0 + cos(w t) V in real-pair form. States are
``Cplx`` (B, d) pairs, widened to (B, 2d) = [re | im] inside the step.

* :func:`fused_rk_step` is the wrapper of the hand-written CUDA kernel
  ``csrc/fused_rk_step.cu``: the whole embedded step (all stages, the
  advance, the embedded error and its per-trajectory l2 norm) in one
  launch. It takes the declared drive u(t) = cos(w t).
* :func:`torch_rk_step` is its plain torch twin, the counterpart of
  ``xla_rk_step``. The wrapper runs it only for tensors on the CPU; for
  CUDA tensors it launches the kernel or raises.
* :func:`kernel_operands` and :func:`launch` are the wrapper's two
  halves: the stepper packs the operators and the tableau once per solve
  and launches with them at every step.
* :class:`FusedModulatedLinearRK` is the natively batched stepper the
  driver runs.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Callable, Optional

import numpy as np
import torch

from ..tableaus import RKF45, ButcherTableau
from . import _build
from .cplx import Cplx

# the kernel's limits (MAX_STAGES and MAX_WIDTH in csrc/fused_rk_step.cu)
MAX_STAGES = 7    # tableau stages
MAX_WIDTH = 512   # widened state width 2d (d <= 256)


def _row_matmul(x: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    """(B, 2d) @ M^T: the row convention of the JAX package's kernels."""
    return x @ M.T


def torch_rk_step(t, dt, xw, M0, M1, *, u_fn: Callable, tab=RKF45,
                  advance_lower: bool = True):
    """Plain torch batched RK step, the twin of ``xla_rk_step``: the same
    stage sums in the same order. Returns (x_next (B, 2d), err_norm (B,)),
    with err_norm None when the tableau has no embedded pair."""
    s = tab.stages
    dtc = dt[:, None]
    tc = t[:, None]

    def f(ti, xi):
        return _row_matmul(xi, M0) + u_fn(ti) * _row_matmul(xi, M1)

    K = [None] * s
    K[0] = f(tc, xw)
    for i in range(1, s):
        ti = tc + float(tab.c[i]) * dtc
        acc = None
        for j in range(i):
            if tab.a[i, j] == 0.0:
                continue
            term = float(tab.a[i, j]) * K[j]
            acc = term if acc is None else acc + term
        xi = xw if acc is None else xw + dtc * acc
        K[i] = f(ti, xi)
    x_b = xw + dtc * sum(float(tab.b[j]) * K[j] for j in range(s)
                         if tab.b[j] != 0.0)
    if tab.b_err is None:
        return x_b, None
    db = tab.b - tab.b_err
    err = dtc * sum(float(db[j]) * K[j] for j in range(s) if db[j] != 0.0)
    x_next = (x_b - err) if advance_lower else x_b
    return x_next, torch.sqrt(torch.sum(err * err, dim=1))


def _tableau_array(tab) -> np.ndarray:
    """a, b, b - b_err and c, zero-padded to MAX_STAGES, in the kernel's
    float64 layout."""
    s = tab.stages
    a = np.zeros((MAX_STAGES, MAX_STAGES))
    a[:s, :s] = tab.a
    b, db, c = np.zeros((3, MAX_STAGES))
    b[:s] = tab.b
    if tab.b_err is not None:
        db[:s] = tab.b - tab.b_err
    c[:s] = tab.c
    return np.concatenate([a.ravel(), b, db, c])


@functools.cache
def _kernel_lib() -> ctypes.CDLL:
    """The kernel library, built on first use, with its entry points'
    argument types set."""
    lib = _build.load("fused_rk_step")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.vec_ode_fused_rk_step_f32, lib.vec_ode_fused_rk_step_f64):
        fn.restype = ci
        fn.argtypes = [vp, vp, vp, vp, vp, vp, ci, ci,
                       ctypes.POINTER(ctypes.c_double), ci, ci, ci,
                       ctypes.c_double, vp]
    return lib


def _check_like(xw, **named) -> None:
    for name, a in named.items():
        if a.device != xw.device:
            raise ValueError(
                f"fused_rk_step: {name} is on {a.device}, xw on {xw.device}")
        if a.dtype != xw.dtype:
            raise TypeError(
                f"fused_rk_step: {name} is {a.dtype}, xw is {xw.dtype}")


def kernel_operands(M0, M1, tab):
    """What the kernel takes besides the state, made once per operator
    pair and tableau: MT = [M0^T | M1^T] as one contiguous (D, 2D) matrix
    (for each contraction index one contiguous row), and the tableau as a
    ctypes float64 array."""
    if tab.stages > MAX_STAGES:
        raise ValueError(
            f"fused_rk_step: tableau {tab.name} has {tab.stages} stages, "
            f"the kernel takes at most {MAX_STAGES}")
    arr = _tableau_array(tab)
    return (torch.cat([M0.T, M1.T], dim=1),
            (ctypes.c_double * arr.size)(*arr))


def launch(t, dt, xw, mt, tab_c, *, w: float, tab, advance_lower: bool):
    """Launch the kernel on CUDA tensors with operands from
    :func:`kernel_operands`; raises on anything the kernel does not take.
    Returns (x_next (B, D), err_norm (B,))."""
    if xw.device.type != "cuda":
        raise ValueError(f"fused_rk_step: unsupported device {xw.device}")
    _check_like(xw, t=t, dt=dt, mt=mt)
    if xw.dtype not in (torch.float32, torch.float64):
        raise TypeError(
            f"fused_rk_step: the kernel takes float32 or float64, "
            f"not {xw.dtype}")
    if xw.ndim != 2 or xw.shape[0] < 1:
        raise ValueError(
            f"fused_rk_step: xw must be (B, 2d) with B >= 1, "
            f"got {tuple(xw.shape)}")
    B, D = xw.shape
    if D > MAX_WIDTH:
        raise ValueError(
            f"fused_rk_step: state width 2d = {D} exceeds the kernel's "
            f"maximum {MAX_WIDTH}")
    if t.shape != (B,) or dt.shape != (B,):
        raise ValueError(
            f"fused_rk_step: t and dt must be ({B},), got "
            f"{tuple(t.shape)} and {tuple(dt.shape)}")
    if mt.shape != (D, 2 * D):
        raise ValueError(
            f"fused_rk_step: [M0^T | M1^T] must be ({D}, {2 * D}), got "
            f"{tuple(mt.shape)}")
    for name, a in dict(t=t, dt=dt, xw=xw, mt=mt).items():
        if not a.is_contiguous():
            raise ValueError(f"fused_rk_step: {name} must be contiguous")
    lib = _kernel_lib()
    fn = (lib.vec_ode_fused_rk_step_f32 if xw.dtype == torch.float32
          else lib.vec_ode_fused_rk_step_f64)
    x_out = torch.empty_like(xw)
    err_out = torch.empty_like(t)
    with torch.cuda.device(xw.device):
        rc = fn(t.data_ptr(), dt.data_ptr(), xw.data_ptr(), mt.data_ptr(),
                x_out.data_ptr(), err_out.data_ptr(), B, D, tab_c,
                tab.stages, int(tab.b_err is not None), int(advance_lower),
                float(w), torch.cuda.current_stream(xw.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"fused_rk_step: kernel launch failed with CUDA error {rc}")
    fused_rk_step.launches += 1
    return x_out, err_out


def fused_rk_step(t, dt, xw, M0, M1, *, w: float, tab=RKF45,
                  advance_lower: bool = True):
    """One fused RK step over the whole ensemble, with the drive
    u(t) = cos(w t).

    t, dt: (B,); xw: (B, 2d) widened state [re | im]; M0, M1: (2d, 2d),
    applied as xw @ M^T. Returns (x_next (B, 2d), err_norm (B,));
    err_norm is zero when the tableau has no embedded pair.

    CUDA tensors go to the kernel (float32 or float64, 2d <= MAX_WIDTH,
    at most MAX_STAGES stages); anything else it does not take raises.
    CPU tensors run :func:`torch_rk_step`. ``fused_rk_step.launches``
    counts the kernel's launches.
    """
    if all(a.device.type == "cpu" for a in (t, dt, xw, M0, M1)):
        x_next, err = torch_rk_step(
            t, dt, xw, M0, M1, u_fn=lambda ti: torch.cos(w * ti), tab=tab,
            advance_lower=advance_lower)
        return x_next, (torch.zeros_like(t) if err is None else err)
    _check_like(xw, M0=M0, M1=M1)
    D = xw.shape[-1]
    if M0.shape != (D, D) or M1.shape != (D, D):
        raise ValueError(
            f"fused_rk_step: M0 and M1 must be ({D}, {D}), got "
            f"{tuple(M0.shape)} and {tuple(M1.shape)}")
    return launch(t, dt, xw, *kernel_operands(M0, M1, tab), w=w, tab=tab,
                  advance_lower=advance_lower)


fused_rk_step.launches = 0


@dataclasses.dataclass(frozen=True)
class FusedModulatedLinearRK:
    """Natively batched stepper for dx/dt = (M0 + u(t) M1) x over Cplx
    pairs, with the declared drive u(t) = cos(w t): each driver iteration
    is one :func:`fused_rk_step`, which returns per-trajectory error norms
    (``error_norm`` is the identity)."""

    M0: torch.Tensor                 # (2d, 2d) embedded -i*H0 (or A0)
    M1: torch.Tensor                 # (2d, 2d) embedded -i*V (or A1)
    w: float                         # the drive u(t) = cos(w t)
    tableau: ButcherTableau = RKF45
    advance_lower: bool = True
    norm: Optional[object] = None    # declared error norm: not yet ported

    is_batched = True
    error_norm = staticmethod(lambda e: e)

    def __post_init__(self):
        if self.norm is not None:
            raise NotImplementedError(
                "norm=: declared error norms (lc.WeightedNorm) are not "
                "ported yet (ROADMAP slice 3, queue 1 item 3)")

    @property
    def nfev_per_step(self) -> int:
        return self.tableau.stages

    @staticmethod
    def from_driven_dense(model, dtype=torch.float32, device=None, **kw):
        """Build from a ``models.quantum.DrivenDense`` (H(t) = H0 +
        cos(wt) V): the same embedded matrices as the JAX package's
        ``from_driven_dense``, made by the same numpy code."""

        def embed_np(re, im):
            return np.block([[re, -im], [im, re]])

        np_dtype = torch.empty((), dtype=dtype).numpy().dtype
        H0r, H0i = model.H0.real.astype(np_dtype), model.H0.imag.astype(np_dtype)
        Vr, Vi = model.V.real.astype(np_dtype), model.V.imag.astype(np_dtype)
        # -i H = (Hi, -Hr) as a (re, im) pair
        M0 = torch.as_tensor(embed_np(H0i, -H0r), device=device)
        M1 = torch.as_tensor(embed_np(Vi, -Vr), device=device)
        return FusedModulatedLinearRK(M0=M0, M1=M1, w=float(model.w), **kw)

    def hermite_slope(self, t, x: Cplx) -> Cplx:
        """Endpoint slope f(t, x) = (M0 + u(t) M1) x (plain torch)."""
        xw = torch.cat([x.re, x.im], dim=-1)
        M0 = self.M0.to(device=xw.device, dtype=xw.dtype)
        M1 = self.M1.to(device=xw.device, dtype=xw.dtype)
        u = torch.cos(self.w * torch.as_tensor(t, dtype=xw.dtype,
                                               device=xw.device))[..., None]
        fw = _row_matmul(xw, M0) + u * _row_matmul(xw, M1)
        d = x.re.shape[-1]
        return Cplx(fw[..., :d], fw[..., d:])

    def step_path(self, y0: Cplx) -> str:
        """Execution-path tag for ``Solution.path``."""
        return ("torch-driver+cuda-step" if y0.re.is_cuda
                else "torch-driver")

    def make_step_fn(self, rhs=None):
        if rhs is not None:
            raise ValueError(
                "FusedModulatedLinearRK embeds its own RHS; pass rhs=None")
        has_err = self.tableau.b_err is not None
        tab, w, lower = self.tableau, self.w, self.advance_lower
        # per (device, dtype) of the state: the operators in its type and,
        # on a card, the kernel's operands, made once for the whole solve
        operands = {}

        def step_fn(t, x: Cplx, dt):
            d = x.re.shape[-1]
            xw = torch.cat([x.re, x.im], dim=-1)
            key = (xw.device, xw.dtype)
            if key not in operands:
                M0 = self.M0.to(device=xw.device, dtype=xw.dtype)
                M1 = self.M1.to(device=xw.device, dtype=xw.dtype)
                operands[key] = ((M0, M1) if xw.device.type == "cpu"
                                 else kernel_operands(M0, M1, tab))
            if xw.device.type == "cpu":
                ox, oe = fused_rk_step(t, dt, xw, *operands[key], w=w,
                                       tab=tab, advance_lower=lower)
            else:
                ox, oe = launch(t, dt, xw, *operands[key], w=w, tab=tab,
                                advance_lower=lower)
            # no embedded pair -> no error estimate: None makes the
            # adaptive driver raise instead of accepting on a zero estimate
            return Cplx(ox[..., :d], ox[..., d:]), (oe if has_err else None)

        return step_fn

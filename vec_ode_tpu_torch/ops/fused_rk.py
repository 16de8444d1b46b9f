"""Fused Runge-Kutta step for ensembles of dx/dt = (M0 + u(t) M1) x, the
counterpart of ``vec_ode_tpu/ops/pallas_rk.py``.

The workload is many independent trajectories of one linear system with
SHARED matrices M0, M1 and a per-trajectory scalar drive u(t), e.g. a
driven Hamiltonian H(t) = H0 + cos(w t) V in real-pair form. States are
``Cplx`` (B, d) pairs, widened to (B, 2d) = [re | im] inside the step.

* :func:`fused_rk_step` is the wrapper of the hand-written CUDA kernel
  ``csrc/fused_rk_step.cu``: the whole embedded step (all stages, the
  advance, the embedded error and its per-trajectory l2 or declared
  ``WeightedNorm`` norm) in one launch. It takes a declared drive u(t):
  a one-term :class:`~.forms.CoeffForm` (``w=`` is the shorthand for
  cos(w t), :func:`cos_drive`) or a one-term :class:`~.forms.ChebForm`,
  sampled in-kernel in the twins' order. A callable drive runs no kernel:
  the stepper runs the twin step on the tensors' device.
* :func:`torch_rk_step` is its plain torch twin, the counterpart of
  ``xla_rk_step``, and also of the step inside the whole-loop kernel
  (``scaled=``). The wrapper runs it only for tensors on the CPU; for CUDA
  tensors it launches the kernel or raises.
* :func:`kernel_operands` and :func:`launch` are the wrapper's two
  halves: the stepper packs the operators and the tableau once per solve
  and launches with them at every step.
* :func:`rk_plan` mirrors the kernel's launch plan (rows and stages a
  thread keeps in registers, rows a block, the operator resident and the
  blocks persistent, or streamed) and :func:`kernel_rk_plan` reads the
  plan the kernel launches with on the card; the loop kernel's RK step
  runs the same stage body (``csrc/rk_step.cuh``), with the same bits.
* :class:`FusedModulatedLinearRK` is the natively batched stepper the
  driver runs; its :meth:`~FusedModulatedLinearRK.fused_loop_solve` runs
  the whole adaptive loop in one launch of ``csrc/fused_loop.cu``
  (``ops/fused_loop.py``) where the JAX package takes its whole-loop path.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Callable, NamedTuple, Optional, Union

import numpy as np
import torch

from .. import lc, telemetry
from ..config import _decline
from ..tableaus import RKF45, ButcherTableau
from . import _build
from .cplx import Cplx
from .forms import FORMS, ChebForm, CoeffForm

# the kernel's limits (MAX_STAGES and MAX_WIDTH in csrc/numerics.cuh)
MAX_STAGES = 7    # tableau stages
MAX_WIDTH = 512   # widened state width 2d (d <= 256)
# K1's plan (csrc/fused_rk_step.cu: rk_plan): rows a block at most and, for
# small batches, at least; f32 with at most RK_KS_REG stages RK_RM_REG rows
# a thread, its stages in registers; else RK_RM rows a thread (f32: the 7
# stages in registers, f64: in shared memory)
RK_MAX_TILE, RK_MIN_TILE = 128, 8
RK_RM_REG, RK_KS_REG, RK_RM = 4, 6, 2
RK_PLAN_KEYS = ("rm", "ks", "tile", "threads", "blocks", "smem", "resident")


def _row_matmul(x: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    """(B, 2d) @ M^T: the row convention of the JAX package's kernels."""
    return x @ M.T


def cos_drive(w: float) -> CoeffForm:
    """The drive u(t) = cos(w t) as the declared one-term form (0, 0, 1,
    w): its sampler leaves out the zero terms and multiplies by c = 1, so
    it gives the bits of cos(w t) itself."""
    return CoeffForm(a=(0.0,), b=(0.0,), c=(1.0,), w=(float(w),))


def is_declared(u_fn) -> bool:
    """Whether a drive is a declared form a kernel samples (else a callable
    that only the twin step can run)."""
    return isinstance(u_fn, (CoeffForm, ChebForm))


def check_drive(u_fn) -> None:
    """Raise on what is not a drive: a one-term CoeffForm or ChebForm, or a
    torch callable t -> u(t)."""
    if is_declared(u_fn):
        if u_fn.n_terms != 1:
            raise ValueError(
                f"the RK drive is one function u(t); the declared form has "
                f"{u_fn.n_terms} terms")
    elif not callable(u_fn):
        raise TypeError(
            f"u_fn must be a one-term CoeffForm / ChebForm or a callable "
            f"t -> u(t), got {type(u_fn).__name__}")


def drive_fn(u_fn) -> Callable:
    """u(t) as the twins evaluate it: a declared form by its ``sample`` (in
    the kernels' order), a callable as it is."""
    if is_declared(u_fn):
        return lambda ti: u_fn.sample(ti)[..., 0]
    return u_fn


def cos_frequency(u_fn) -> Optional[float]:
    """w where the drive is the declared cos(w t) (:func:`cos_drive`), else
    None."""
    if (isinstance(u_fn, CoeffForm) and u_fn.n_terms == 1
            and (u_fn.a[0], u_fn.b[0], u_fn.c[0]) == (0.0, 0.0, 1.0)):
        return u_fn.w[0]
    return None


class KernelDrive(NamedTuple):
    """A declared drive as K1 and K2's RK step read it: the 8 float64
    values [kind, n, a, b, c, w, mid, inv] (csrc/numerics.cuh:
    parse_drive) and a ChebForm's (1, n) series on the card (None for a
    CoeffForm), made once per stepper and device."""

    params: ctypes.Array
    cheb: Optional[torch.Tensor]


def kernel_drive(u_fn, like: torch.Tensor) -> KernelDrive:
    """The kernel's drive arguments for a declared ``u_fn`` in ``like``'s
    type and on its device; a callable drive raises (no kernel runs a
    Python callable)."""
    check_drive(u_fn)
    if isinstance(u_fn, ChebForm):
        mid, inv = u_fn.folded()
        vals = [FORMS["cheb"], u_fn.n_coeffs, 0.0, 0.0, 0.0, 0.0, mid, inv]
        cheb = u_fn.kernel_table(like.dtype, like.device)
    elif isinstance(u_fn, CoeffForm):
        vals = [FORMS["coeff"], 0, u_fn.a[0], u_fn.b[0], u_fn.c[0],
                u_fn.w[0], 0.0, 0.0]
        cheb = None
    else:
        raise TypeError(
            "the RK kernels take a declared drive (a one-term CoeffForm or "
            "ChebForm); a callable u_fn runs the twin step (ROADMAP rule "
            "'Kernels take declared forms')")
    return KernelDrive((ctypes.c_double * 8)(*vals), cheb)


def _step_error_measure(err, xw, x_next, *, wnorm=None, scaled=None):
    """The per-row measure of the error vector ``err`` (B, 2d) that the
    kernels compute, in their order (``make_rk_step_builder``):
    ``scaled=(atol, rtol)`` divides by atol + rtol*max(|xw|, |x_next|);
    then ``wnorm=(w_row, post, kind)`` (``lc.WeightedNorm.kernel_parts``)
    multiplies by the weight row and reduces by l2 or max; then the
    scaled measure is multiplied by rtol, and last by post. Without either
    it is the plain per-row l2 norm; a callable ``wnorm`` (a
    ``TracedNorm``'s executor) takes the error rows as they are."""
    if callable(wnorm):
        return wnorm(err)
    if scaled is not None:
        atol, rtol = scaled
        err = err / (atol + rtol * torch.maximum(xw.abs(), x_next.abs()))
    w_row, post, kind = (None, 1.0, "l2") if wnorm is None else wnorm
    en = lc.apply_weighted_norm(err, (w_row, 1.0, kind), axis=1)
    if scaled is not None:
        en = en * scaled[1]
    return en if post == 1.0 else en * post


def torch_rk_step(t, dt, xw, M0, M1, *, u_fn: Callable, tab=RKF45,
                  advance_lower: bool = True, wnorm=None, scaled=None):
    """Plain torch batched RK step, the twin of ``xla_rk_step``: the same
    stage sums in the same order. Returns (x_next (B, 2d), err_norm (B,)),
    with err_norm None when the tableau has no embedded pair. ``wnorm`` and
    ``scaled`` select the error measure (:func:`_step_error_measure`)."""
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
    return x_next, _step_error_measure(err, xw, x_next, wnorm=wnorm,
                                       scaled=scaled)


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
    vp, ci, cd = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    for fn in (lib.vec_ode_fused_rk_step_f32, lib.vec_ode_fused_rk_step_f64):
        fn.restype = ci
        fn.argtypes = [vp, vp, vp, vp, vp, vp, ci, ci, ctypes.POINTER(cd),
                       ci, ci, ci, ctypes.POINTER(cd), vp, vp, cd, ci, vp]
    return lib


def rk_wc(ncl: int) -> int:
    """The column groups of 4 a warp of the RK step spans: the largest
    power of two up to 8 dividing ``ncl`` (csrc/rk_step.cuh: rk_wc)."""
    wc = 1
    while wc < 8 and ncl % (2 * wc) == 0:
        wc *= 2
    return wc


def rk_smem_bytes(tile: int, D: int, s: int, elem: int, kshared: bool,
                  resident: bool) -> int:
    """The RK step's shared memory (csrc/rk_step.cuh: RKLayout): the term
    buffers (two with the operator resident, one streamed), the operator
    (two panels of D x DP, or the ring), the drive's two slots of a value
    a row and, for ``kshared``, the s stage values of every thread."""
    # expmv imports this module: its mirror of csrc/gemm_tile.cuh is taken
    # at call time
    from .expmv import GEMM_STAGES, _align16, gemm_dp, gemm_jc
    dp = gemm_dp(D)
    ring = (2 * D * dp * elem if resident
            else GEMM_STAGES * gemm_jc(D, elem) * dp * elem)
    return (_align16((2 if resident else 1) * D * tile * elem)
            + _align16(ring) + _align16(2 * tile * elem)
            + (_align16(s * tile * dp * elem) if kshared else 0))


def rk_plan(B: int, D: int, s: int, elem: int, n_sm: int = 132,
            max_smem: int = 232448) -> dict:
    """K1's launch plan (csrc/fused_rk_step.cu: rk_plan) for B rows of
    width D and s stages in elements of ``elem`` bytes on a card of
    ``n_sm`` SMs with ``max_smem`` bytes of shared memory a block (an
    H100's by default): rows and stages in registers a thread, rows a
    block (the largest power of two up to RK_MAX_TILE whose microtiles
    fill at most 256 threads and whose shared memory with the operator
    streamed fits, halved while the batch gives fewer tiles than SMs, down
    to RK_MIN_TILE), the operator resident where the block holds it at
    that tile (then one persistent block an SM at most), else streamed
    (one block a tile). Keyed as RK_PLAN_KEYS."""
    from .expmv import GEMM_CN, GEMM_THREADS, gemm_dp
    reg4 = elem == 4 and s <= RK_KS_REG
    rm = RK_RM_REG if reg4 else RK_RM
    ks = (RK_KS_REG if reg4 else MAX_STAGES) if elem == 4 else 0
    ncl = gemm_dp(D) // GEMM_CN

    def smem(tile, res):
        return rk_smem_bytes(tile, D, s, elem, ks == 0, res)

    tile = RK_MAX_TILE
    while tile > rm and ((tile // rm) * ncl > GEMM_THREADS
                         or smem(tile, False) > max_smem):
        tile //= 2
    while tile > max(rm, RK_MIN_TILE) and -(-B // tile) < n_sm:
        tile //= 2
    n_tiles = -(-B // tile)
    res = smem(tile, True) <= max_smem
    return dict(rm=rm, ks=ks, tile=tile,
                threads=-(-((tile // rm) * ncl) // 32) * 32,
                blocks=min(n_tiles, n_sm) if res else n_tiles,
                smem=smem(tile, res), resident=int(res))


def kernel_rk_plan(B: int, D: int, s: int, dtype) -> dict:
    """The plan K1 launches with on the current card
    (``vec_ode_fused_rk_plan``), keyed as RK_PLAN_KEYS."""
    out = (ctypes.c_longlong * len(RK_PLAN_KEYS))()
    fn = _kernel_lib().vec_ode_fused_rk_plan
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_longlong)]
    rc = fn(B, D, s, 4 if dtype == torch.float32 else 8, out)
    if rc != 0:
        raise RuntimeError(f"fused_rk_step: the plan query failed with CUDA "
                           f"error {rc}")
    return dict(zip(RK_PLAN_KEYS, (int(v) for v in out)))


def check_kernel_inputs(kernel: str, xw, mt, w_row=None, **rows) -> None:
    """Raise on what the kernels do not take: a state ``xw`` (B, 2d) on a
    CUDA device in float32 or float64 with 2d <= MAX_WIDTH, the operators
    ``mt`` (2d, 4d), an optional weight row (2d,), and per-row tensors
    ``rows`` (B,), all on xw's device in its type and contiguous."""
    if xw.device.type != "cuda":
        raise ValueError(f"{kernel}: unsupported device {xw.device}")
    if xw.dtype not in (torch.float32, torch.float64):
        raise TypeError(
            f"{kernel}: the kernel takes float32 or float64, not {xw.dtype}")
    if xw.ndim != 2 or xw.shape[0] < 1:
        raise ValueError(
            f"{kernel}: xw must be (B, 2d) with B >= 1, got "
            f"{tuple(xw.shape)}")
    B, D = xw.shape
    if D > MAX_WIDTH:
        raise ValueError(
            f"{kernel}: state width 2d = {D} exceeds the kernel's maximum "
            f"{MAX_WIDTH}")
    named = dict(rows, xw=xw, mt=mt)
    if w_row is not None:
        named["w_row"] = w_row
    for name, a in named.items():
        if a.device != xw.device:
            raise ValueError(
                f"{kernel}: {name} is on {a.device}, xw on {xw.device}")
        if a.dtype != xw.dtype:
            raise TypeError(f"{kernel}: {name} is {a.dtype}, xw is {xw.dtype}")
        if not a.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be contiguous")
    for name, a in rows.items():
        if a.shape != (B,):
            raise ValueError(
                f"{kernel}: {name} must be ({B},), got {tuple(a.shape)}")
    if mt.shape != (D, 2 * D):
        raise ValueError(
            f"{kernel}: [M0^T | M1^T] must be ({D}, {2 * D}), got "
            f"{tuple(mt.shape)}")
    if w_row is not None and w_row.shape != (D,):
        raise ValueError(
            f"{kernel}: the weight row must be ({D},), got "
            f"{tuple(w_row.shape)}")


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


def wnorm_on(wnorm, like: torch.Tensor):
    """A ``kernel_parts`` declaration (w_row, post, kind) with its weight
    row as a (2d,) tensor on ``like``'s device in its type, as the kernels
    take it; None stays None."""
    if wnorm is None:
        return None
    w_row, post, kind = wnorm
    if w_row is not None:
        w_row = torch.as_tensor(w_row, dtype=like.dtype,
                                device=like.device).reshape(-1)
    return w_row, float(post), kind


def kernel_norm_args(wnorm):
    """(w_row pointer or None, post, kind_max) for a kernel launch."""
    w_row, post, kind = (None, 1.0, "l2") if wnorm is None else wnorm
    return (None if w_row is None else w_row.data_ptr(), float(post),
            int(kind == "max"))


def launch(t, dt, xw, mt, tab_c, *, drive: KernelDrive, tab,
           advance_lower: bool, wnorm=None):
    """Launch the kernel on CUDA tensors with operands from
    :func:`kernel_operands`, a drive from :func:`kernel_drive` and a
    declared norm from :func:`wnorm_on`; raises on anything the kernel
    does not take. Returns (x_next (B, D), err_norm (B,))."""
    check_kernel_inputs("fused_rk_step", xw, mt,
                        None if wnorm is None else wnorm[0], t=t, dt=dt)
    _build.refuse_grad("fused_rk_step", t, dt, xw, mt,
                       None if wnorm is None else wnorm[0], drive.cheb)
    if drive.cheb is not None and (drive.cheb.device != xw.device
                                   or drive.cheb.dtype != xw.dtype):
        raise TypeError(
            f"fused_rk_step: the drive's series is {drive.cheb.dtype} on "
            f"{drive.cheb.device}, xw {xw.dtype} on {xw.device}")
    B, D = xw.shape
    lib = _kernel_lib()
    fn = (lib.vec_ode_fused_rk_step_f32 if xw.dtype == torch.float32
          else lib.vec_ode_fused_rk_step_f64)
    x_out = torch.empty_like(xw)
    err_out = torch.empty_like(t)
    with torch.cuda.device(xw.device):
        rc = fn(t.data_ptr(), dt.data_ptr(), xw.data_ptr(), mt.data_ptr(),
                x_out.data_ptr(), err_out.data_ptr(), B, D, tab_c,
                tab.stages, int(tab.b_err is not None), int(advance_lower),
                drive.params,
                None if drive.cheb is None else drive.cheb.data_ptr(),
                *kernel_norm_args(wnorm),
                torch.cuda.current_stream(xw.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"fused_rk_step: kernel launch failed with CUDA error {rc}")
    fused_rk_step.launches += 1
    return x_out, err_out


def fused_rk_step(t, dt, xw, M0, M1, *, u_fn=None, w: Optional[float] = None,
                  tab=RKF45, advance_lower: bool = True, wnorm=None):
    """One fused RK step over the whole ensemble, with the drive ``u_fn``
    (a one-term ``CoeffForm`` or ``ChebForm``, or on CPU tensors any
    callable t -> u(t)) or its shorthand ``w``: u(t) = cos(w t).

    t, dt: (B,); xw: (B, 2d) widened state [re | im]; M0, M1: (2d, 2d),
    applied as xw @ M^T; ``wnorm``: a declared error norm
    ``(w_row, post, kind)`` (``lc.WeightedNorm.kernel_parts``) or None for
    l2. Returns (x_next (B, 2d), err_norm (B,)); err_norm is zero when the
    tableau has no embedded pair.

    CUDA tensors go to the kernel (float32 or float64, 2d <= MAX_WIDTH,
    at most MAX_STAGES stages, a declared drive); anything else it does
    not take raises. CPU tensors run :func:`torch_rk_step`.
    ``fused_rk_step.launches`` counts the kernel's launches.
    """
    if (u_fn is None) == (w is None):
        raise ValueError("fused_rk_step: pass exactly one of u_fn and w")
    if u_fn is None:
        u_fn = cos_drive(w)
    check_drive(u_fn)
    if all(a.device.type == "cpu" for a in (t, dt, xw, M0, M1)):
        x_next, err = torch_rk_step(
            t, dt, xw, M0, M1, u_fn=drive_fn(u_fn), tab=tab,
            advance_lower=advance_lower, wnorm=wnorm)
        return x_next, (torch.zeros_like(t) if err is None else err)
    D = xw.shape[-1]
    for name, m in (("M0", M0), ("M1", M1)):
        if m.device != xw.device:
            raise ValueError(
                f"fused_rk_step: {name} is on {m.device}, xw on {xw.device}")
        if m.dtype != xw.dtype:
            raise TypeError(
                f"fused_rk_step: {name} is {m.dtype}, xw is {xw.dtype}")
    if M0.shape != (D, D) or M1.shape != (D, D):
        raise ValueError(
            f"fused_rk_step: M0 and M1 must be ({D}, {D}), got "
            f"{tuple(M0.shape)} and {tuple(M1.shape)}")
    return launch(t, dt, xw, *kernel_operands(M0, M1, tab),
                  drive=kernel_drive(u_fn, xw), tab=tab,
                  advance_lower=advance_lower, wnorm=wnorm_on(wnorm, xw))


fused_rk_step.launches = 0


@dataclasses.dataclass(frozen=True)
class FusedModulatedLinearRK:
    """Natively batched stepper for dx/dt = (M0 + u(t) M1) x over Cplx
    pairs: each driver iteration is one :func:`fused_rk_step`, which
    returns per-trajectory error norms (``error_norm`` is the identity),
    or the whole adaptive loop runs in one launch (:meth:`fused_loop_solve`).

    ``u_fn`` is the drive, the JAX field's name: a one-term
    ``CoeffForm`` or ``ChebForm``, which both kernels sample in-kernel, or
    any torch callable t -> u(t), which no kernel can run: the stepper
    then runs the twin step :func:`torch_rk_step` on the tensors' device
    and the loop kernel declines (``Solution.path`` says which). ``w=`` is
    the shorthand for u(t) = cos(w t) (:func:`cos_drive`), and ``.w``
    reads it back (None for another drive; ``u_fn`` decides where both
    are given). ``norm``: a declared ``lc.WeightedNorm`` that both
    kernels and the twin execute, or an ``lc.TracedNorm``, which only the
    twin can apply (so it runs the twin step, as for a callable drive)."""

    M0: torch.Tensor                 # (2d, 2d) embedded -i*H0 (or A0)
    M1: torch.Tensor                 # (2d, 2d) embedded -i*V (or A1)
    u_fn: object = None              # the drive u(t)
    tableau: ButcherTableau = RKF45
    advance_lower: bool = True
    norm: Optional[object] = None    # WeightedNorm or TracedNorm
    w: dataclasses.InitVar[Optional[float]] = None  # shorthand: cos(w t)

    is_batched = True
    error_norm = staticmethod(lambda e: e)

    def __post_init__(self, w):
        if self.u_fn is None and w is None:
            raise TypeError("FusedModulatedLinearRK: missing the drive: "
                            "pass u_fn= or its cos(w t) shorthand w=")
        # dataclasses.replace passes .w back: the drive's own cos
        # frequency, or None
        # where both are given u_fn decides: dataclasses.replace passes
        # .w back beside a new u_fn
        if self.u_fn is None:
            object.__setattr__(self, "u_fn", cos_drive(w))
        check_drive(self.u_fn)
        if self.norm is not None and not isinstance(
                self.norm, (lc.WeightedNorm, lc.TracedNorm)):
            raise TypeError(
                "norm=: a declared lc.WeightedNorm or an lc.TracedNorm; "
                "ensemble_solve promotes an opaque error_norm= callable "
                "to the latter (lc.try_trace_norm)")
        # per (device, dtype) of the state: the operators, the declared
        # norm and, on a card, the kernel's operands and drive, made once
        object.__setattr__(self, "_operands", {})

    @property
    def twin_only(self) -> bool:
        """Whether the step runs its twin on every device: a callable
        drive or a traced norm, neither of which a kernel can run."""
        return (not is_declared(self.u_fn)
                or isinstance(self.norm, lc.TracedNorm))

    def _wnorm(self, d: int):
        """(w_row, post, kind) of the declared ``norm`` over the widened
        [re | im] layout (``lc.WeightedNorm.kernel_parts``), the widened
        executor of a ``TracedNorm``, or None. Raises for weights the
        batched layout cannot express."""
        if self.norm is None:
            return None
        if isinstance(self.norm, lc.TracedNorm):
            tn = self.norm
            return lambda dv: tn.batched(Cplx(dv[..., :d], dv[..., d:]))
        kp = self.norm.kernel_parts(d, 2)
        if kp is None:
            raise ValueError(
                "WeightedNorm.weights must be a single per-(complex-)"
                f"component array of length {d} for this batched stepper")
        return kp

    @property
    def nfev_per_step(self) -> int:
        return self.tableau.stages

    @staticmethod
    def from_driven_dense(model, dtype=torch.float32, device="cuda", **kw):
        """Build from a ``models.quantum.DrivenDense`` (H(t) = H0 +
        cos(wt) V): the same embedded matrices as the JAX package's
        ``from_driven_dense``, made by the same numpy code, on the card
        unless ``device`` names another, with the drive
        ``cos_drive(model.w)`` (``u_fn=`` in ``kw`` replaces it)."""

        def embed_np(re, im):
            return np.block([[re, -im], [im, re]])

        np_dtype = torch.empty((), dtype=dtype).numpy().dtype
        H0r, H0i = model.H0.real.astype(np_dtype), model.H0.imag.astype(np_dtype)
        Vr, Vi = model.V.real.astype(np_dtype), model.V.imag.astype(np_dtype)
        # -i H = (Hi, -Hr) as a (re, im) pair
        M0 = torch.as_tensor(embed_np(H0i, -H0r), device=device)
        M1 = torch.as_tensor(embed_np(Vi, -Vr), device=device)
        kw.setdefault("u_fn", cos_drive(model.w))
        return FusedModulatedLinearRK(M0=M0, M1=M1, **kw)

    def hermite_slope(self, t, x: Cplx) -> Cplx:
        """Endpoint slope f(t, x) = (M0 + u(t) M1) x (plain torch), the
        drive sampled as the twin samples it."""
        xw = torch.cat([x.re, x.im], dim=-1)
        M0 = self.M0.to(device=xw.device, dtype=xw.dtype)
        M1 = self.M1.to(device=xw.device, dtype=xw.dtype)
        tt = torch.as_tensor(t, dtype=xw.dtype, device=xw.device)
        u = drive_fn(self.u_fn)(tt)[..., None]
        fw = _row_matmul(xw, M0) + u * _row_matmul(xw, M1)
        d = x.re.shape[-1]
        return Cplx(fw[..., :d], fw[..., d:])

    def step_path(self, y0: Cplx) -> str:
        """Execution-path tag of the per-step path for ``Solution.path``:
        the step kernel on the card, or the twin step there where the
        drive or the norm is a callable."""
        if not y0.re.is_cuda:
            return "torch-driver"
        return ("torch-driver+twin-step" if self.twin_only
                else "torch-driver+cuda-step")

    def _ops_for(self, xw):
        key = (xw.device, xw.dtype)
        if key not in self._operands:
            d = xw.shape[-1] // 2
            M0 = self.M0.to(device=xw.device, dtype=xw.dtype)
            M1 = self.M1.to(device=xw.device, dtype=xw.dtype)
            wn = self._wnorm(d)
            if xw.device.type == "cpu" or self.twin_only:
                ops = ((M0, M1), None)
            else:
                ops = (kernel_operands(M0, M1, self.tableau),
                       kernel_drive(self.u_fn, xw))
            self._operands[key] = ops, (wn if callable(wn)
                                        else wnorm_on(wn, xw))
        return self._operands[key]

    def make_step_fn(self, rhs=None):
        if rhs is not None:
            raise ValueError(
                "FusedModulatedLinearRK embeds its own RHS; pass rhs=None")
        has_err = self.tableau.b_err is not None
        tab, lower = self.tableau, self.advance_lower
        u = drive_fn(self.u_fn)

        def step_fn(t, x: Cplx, dt):
            d = x.re.shape[-1]
            xw = torch.cat([x.re, x.im], dim=-1)
            (ops, drive), wn = self._ops_for(xw)
            if drive is None:
                # the twin: CPU tensors, a callable drive or a traced norm
                ox, oe = torch_rk_step(t, dt, xw, *ops, u_fn=u, tab=tab,
                                       advance_lower=lower, wnorm=wn)
            else:
                ox, oe = launch(t, dt, xw, *ops, drive=drive, tab=tab,
                                advance_lower=lower, wnorm=wn)
            # no embedded pair -> no error estimate: None makes the
            # adaptive driver raise instead of accepting on a zero estimate
            return Cplx(ox[..., :d], ox[..., d:]), (oe if has_err else None)

        return step_fn

    def fused_loop_solve(self, y0: Cplx, t_grid, h0, *, ctl, adaptive: bool,
                         chunk: int = 8, persistent=None, events=None,
                         dense: bool = False):
        """The whole adaptive loop in one launch of the CUDA loop kernel
        (``ops/fused_loop.py``; ``persistent=False``: launches of ``chunk``
        iterations): stages, embedded error, controller (I or PI,
        ``scaled_error``, ``strict_end_test``, compensated time), counters
        and the save-grid hits, the counterpart of the JAX stepper's
        ``fused_loop_solve``. ``events`` (an ``events.EventConfig`` of
        declared observables) run in the kernel; ``dense=True`` runs it on
        the bare [t0, tf] with the interior grid times as dense-output
        times, then one batched Hermite pass with :meth:`hermite_slope`.

        Returns None where the JAX package declines, so that the caller
        runs the per-step path: fixed steps or a tableau without an
        embedded pair, a state that is not (B, d), a time dtype other than
        the state's, more than ``LOOP_MAX_BATCH`` trajectories, tensors
        on the CPU (the JAX package declines off the TPU), an event that
        is not a declared observable, a callable drive or a traced norm
        (the kernel runs no Python callable); ``config.warn_on_fallback``
        names the rule on the card."""
        from .fused_loop import (LOOP_MAX_BATCH, RKStep,
                                 fused_loop_integrate, loop_solution)

        if not y0.re.is_cuda:
            return None
        if not adaptive or self.tableau.b_err is None:
            return _decline("fixed steps or no embedded pair")
        if y0.re.ndim != 2:
            return _decline("the state is not (B, d)")
        if not is_declared(self.u_fn):
            return _decline("a callable drive u_fn: the loop kernel takes "
                            "a declared CoeffForm or ChebForm")
        if isinstance(self.norm, lc.TracedNorm):
            return _decline("a traced error norm: the loop kernel takes "
                            "a declared WeightedNorm")
        B, d = y0.re.shape
        if B > LOOP_MAX_BATCH:
            return _decline(f"{B} trajectories > LOOP_MAX_BATCH = "
                            f"{LOOP_MAX_BATCH}")
        if t_grid.dtype != y0.re.dtype:
            return _decline(f"time dtype {t_grid.dtype} is not the state's "
                            f"{y0.re.dtype}")
        ev_spec = None
        if events is not None:
            ev_spec = events.kernel_spec(d, 2)
            if ev_spec is None:
                return _decline("events= has an opaque callable; the loop "
                                "kernel takes declared observables")
        dense = dense and t_grid.shape[0] > 2
        with telemetry.span("vec_ode.loop.launch"):
            wnorm = None
            if self.norm is not None:
                if ctl.scaled_error:
                    raise ValueError(
                        "scaled_error and a declared WeightedNorm are "
                        "mutually exclusive")
                wnorm = self._wnorm(d)
            dtype, dev = y0.re.dtype, y0.re.device
            step = RKStep(
                M0=self.M0.to(device=dev, dtype=dtype),
                M1=self.M1.to(device=dev, dtype=dtype), u_fn=self.u_fn,
                tableau=self.tableau, advance_lower=self.advance_lower,
                scaled=(ctl.atol, ctl.rtol) if ctl.scaled_error else None,
                wnorm=wnorm)
            persistent = persistent is None or persistent
            x0 = torch.cat([y0.re, y0.im], dim=1)
        out = fused_loop_integrate(
            t_grid[[0, -1]] if dense else t_grid, x0, h0, step, ctl=ctl,
            chunk=chunk, persistent=persistent, events=ev_spec,
            dense_times=t_grid[1:-1] if dense else None)

        def unwiden(xw):
            return Cplx(xw[..., :d], xw[..., d:])

        def slope(t, xw):
            f = self.hermite_slope(t, unwiden(xw))
            return torch.cat([f.re, f.im], dim=-1)

        return loop_solution(
            t_grid, x0, out, unwiden=unwiden, slope=slope,
            path="cuda-loop-persistent" if persistent else "cuda-loop-chunked")


def _cos_w(self) -> Optional[float]:
    """The frequency w of the drive cos(w t) (``from_driven_dense`` and
    the ``w=`` shorthand), None for any other drive."""
    return cos_frequency(self.u_fn)


# ``w=`` is an init-only shorthand; ``.w`` reads it back from the drive
FusedModulatedLinearRK.w = property(_cos_w)

"""Per-trajectory dense exponential chains, the counterpart of
``vec_ode_tpu/ops/pallas_dense.py``.

The generic exponential steppers take a black-box operator callback, so
every trajectory has its OWN dense operator samples M_q = A_b(t_q) and
nothing is shared across the batch. One step computes, per trajectory b,

    y[b]   = e^{W[b][0][R0-1]} ... e^{W[b][0][0]} x[b]          (chain 0)
    err[b] = || e^{W[b][1][..]} x[b] - y[b] ||                 (two chains)

(the l2 norm, or a declared ``lc.WeightedNorm``)

with every exponent of the one declared shape

    W = dt * sum_q lin[q] M_q
        + dt^2 * sum_k g_k (M_{p_k} M_{q_k} - M_{q_k} M_{p_k}).

* :class:`ChainTable` declares the chains: per chain and exponent the
  ``lin`` row over the nodes and its commutator terms ``(p, q, g)``. It
  takes the place of the JAX package's traced ``chain_builder`` callback
  (a hand-written kernel cannot run one), and it is what the kernel, its
  plain twin and the stacked reference (``exp/dense_fast.py``) all read.
* :func:`torch_dense_chains` is the plain twin with the kernel's
  arithmetic: table -> exponents, the squaring count per trajectory and
  exponent (``ops/expm.squaring_count``: the least s >= 0 with
  norm / theta <= 2^s, s = 0 for a non-finite norm), the
  Paterson-Stockmeyer polynomial, s squarings, the chain application and
  the error norm. The JAX kernel takes ceil(log2(.)) per trajectory and its
  XLA twin one count per batch; the results differ by rounding.
* :func:`fused_dense_chain_apply` is the wrapper of the hand-written CUDA
  kernel ``csrc/dense_chains.cu`` (K9): CPU tensors run the twin, CUDA
  tensors launch the kernel or raise.
  ``fused_dense_chain_apply.launches`` counts the launches.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Sequence

import torch

from .. import lc
from . import _build
from .expm import one_norm, squaring_count, taylor_ps
from .fused_rk import kernel_norm_args, wnorm_on

# the kernel's limits (csrc/dense_chains.cu)
MAX_DIM = 256
MAX_NODES = 8
MAX_EXPONENTS = 12
MAX_COMMS = 12
N_BUF = 6          # (D, D) scratch buffers per block


@dataclasses.dataclass(frozen=True)
class Exponent:
    """W = dt * sum_q lin[q] M_q + dt^2 * sum_k g_k [M_{p_k}, M_{q_k}]:
    ``lin`` one weight per node, ``comms`` the terms (p, q, g). An all-zero
    ``lin`` without terms is the exponent 0 (e^0 = I)."""

    lin: tuple
    comms: tuple = ()

    def __post_init__(self):
        object.__setattr__(self, "lin", tuple(float(a) for a in self.lin))
        object.__setattr__(self, "comms", tuple(
            (int(p), int(q), float(g)) for p, q, g in self.comms))


@dataclasses.dataclass(frozen=True)
class ChainTable:
    """The declared chains of one step over ``n_nodes`` operator samples:
    ``chains[c]`` the exponents of chain c in the order they are applied
    (x <- e^W x). Chain 0 advances the state; chain 1, where there is
    one, is the embedded comparison whose distance to chain 0 is the
    error. The chains may differ in length."""

    n_nodes: int
    chains: tuple

    def __post_init__(self):
        chains = tuple(tuple(chain) for chain in self.chains)
        object.__setattr__(self, "chains", chains)
        if len(chains) not in (1, 2) or not all(chains):
            raise ValueError("ChainTable: one or two chains of at least one "
                             "exponent each")
        for ex in self.exponents_flat:
            if len(ex.lin) != self.n_nodes:
                raise ValueError(
                    f"ChainTable: a lin row of {len(ex.lin)} weights over "
                    f"{self.n_nodes} nodes")
            for p, q, _ in ex.comms:
                if not (0 <= p < self.n_nodes and 0 <= q < self.n_nodes):
                    raise ValueError(
                        f"ChainTable: commutator nodes ({p}, {q}) outside "
                        f"the {self.n_nodes} nodes")

    @property
    def exponents_flat(self) -> tuple:
        return tuple(ex for chain in self.chains for ex in chain)

    @property
    def n_comms(self) -> int:
        return sum(len(ex.comms) for ex in self.exponents_flat)

    def exponents(self, node_ops: torch.Tensor, dt: torch.Tensor) -> list:
        """The exponents [C][R_c] as (B, D, D) tensors from the samples
        ``node_ops`` (n_nodes, B, D, D) and dt (B,), in the kernel's
        arithmetic order: the nonzero lin terms summed in node order and
        scaled by dt, then (g dt dt) times each commutator."""
        dt3 = dt.to(node_ops.dtype)[:, None, None]
        out = []
        for chain in self.chains:
            row = []
            for ex in chain:
                acc = None
                for q, a in enumerate(ex.lin):
                    if a == 0.0:
                        continue
                    term = a * node_ops[q]
                    acc = term if acc is None else acc + term
                if acc is None:
                    acc = torch.zeros_like(node_ops[0])
                W = dt3 * acc
                for p, q, g in ex.comms:
                    comm = (node_ops[p] @ node_ops[q]
                            - node_ops[q] @ node_ops[p])
                    W = W + ((g * dt3) * dt3) * comm
                row.append(W)
            out.append(row)
        return out

    def kernel_array(self, m: int, theta: float, max_squarings: int):
        """The table as the kernel reads it (``parse_table`` in
        csrc/dense_chains.cu): float64 values in host memory."""
        flat = self.exponents_flat
        n_exp = [len(chain) for chain in self.chains] + [0]
        vals = [self.n_nodes, len(self.chains), n_exp[0], n_exp[1], m,
                max_squarings, theta, self.n_comms]
        for ex in flat:
            vals += ex.lin
        for e, ex in enumerate(flat):
            for p, q, g in ex.comms:
                vals += [e, p, q, g]
        return (ctypes.c_double * len(vals))(*vals)


def torch_dense_chains(table: ChainTable, node_ops, dt, xw, *, m: int,
                       theta: float, max_squarings: int = 16, wnorm=None,
                       counts: list = None):
    """Plain twin of K9: per trajectory and exponent, scaling by its own
    1-norm, T_m by Paterson-Stockmeyer, its own number of squarings (rows
    past their count keep their value), then the chains applied to xw
    (B, D). Returns (y (B, D), err (B,) or None with one chain); err is
    the l2 distance of the two chains, or their distance in the declared
    norm ``wnorm = (w_row, post, kind)`` (``lc.WeightedNorm.kernel_parts``).
    ``counts``, if a list, receives each exponent's (B,) squaring counts."""
    chains = table.exponents(node_ops.to(xw.dtype), dt)
    outs = []
    for chain in chains:
        v = xw
        for W in chain:
            s = squaring_count(one_norm(W), theta, max_squarings)
            if counts is not None:
                counts.append(s)
            As = W * torch.ldexp(torch.ones_like(dt, dtype=W.dtype),
                                 -s)[:, None, None]
            P = taylor_ps(As, m)
            for i in range(int(s.max()) if s.numel() else 0):
                P = torch.where((s > i)[:, None, None], P @ P, P)
            v = (P @ v[..., None])[..., 0]
        outs.append(v)
    if len(outs) < 2:
        return outs[0], None
    return outs[0], lc.apply_weighted_norm(outs[1] - outs[0], wnorm)


@functools.cache
def _kernel_lib() -> ctypes.CDLL:
    """K9's library, built on first use, with its entry points' argument
    types set."""
    lib = _build.load("dense_chains")
    vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for fn in (lib.vec_ode_dense_chains_f32, lib.vec_ode_dense_chains_f64):
        fn.restype = ci
        fn.argtypes = [vp, ll, ll, vp, vp, vp, vp, vp, ci, ci, ci,
                       ctypes.POINTER(ctypes.c_double), ci, vp,
                       ctypes.c_double, ci, vp]
    for fn in (lib.vec_ode_dense_chains_blocks_f32,
               lib.vec_ode_dense_chains_blocks_f64):
        fn.restype = ci
        fn.argtypes = [ci]
    return lib


def check_table(table: ChainTable) -> None:
    """Raise on a table beyond the kernel's limits."""
    if table.n_nodes > MAX_NODES:
        raise ValueError(f"fused_dense_chain_apply: the kernel takes at most "
                         f"{MAX_NODES} operator samples per trajectory, got "
                         f"{table.n_nodes}")
    if len(table.exponents_flat) > MAX_EXPONENTS:
        raise ValueError(f"fused_dense_chain_apply: the kernel takes at most "
                         f"{MAX_EXPONENTS} exponents over both chains, got "
                         f"{len(table.exponents_flat)}")
    if table.n_comms > MAX_COMMS:
        raise ValueError(f"fused_dense_chain_apply: the kernel takes at most "
                         f"{MAX_COMMS} commutator terms, got {table.n_comms}")


def _grid_blocks(lib, xw) -> int:
    """Blocks of the persistent grid: what the card keeps resident, at most
    one per trajectory."""
    f32 = xw.dtype == torch.float32
    resident = (lib.vec_ode_dense_chains_blocks_f32 if f32
                else lib.vec_ode_dense_chains_blocks_f64)(xw.shape[0])
    if resident < 1:
        raise RuntimeError("fused_dense_chain_apply: the occupancy query "
                           f"failed with CUDA error {-resident}")
    return resident


def fused_dense_chain_apply(table: ChainTable, node_ops, dt, xw, *, m: int,
                            theta: float, max_squarings: int = 16,
                            wnorm=None):
    """One step of every trajectory (K9): ``node_ops`` (n_nodes, B, D, D)
    the operator samples (each (D, D) sample contiguous; the strides over
    nodes and trajectories free, but multiples of 16 bytes where D is a
    multiple of 128 and the kernel reads in 16-byte vectors), dt (B,), xw
    (B, D) the widened state. Returns (y (B, D), err (B,)); err is the
    distance of the two chains, l2 or in the declared norm ``wnorm =
    (w_row, post, kind)`` (``lc.WeightedNorm.kernel_parts``), and zero
    where the table has one.

    CUDA tensors go to the kernel (float32 or float64, D <= 256, at most 8
    samples, 12 exponents and 12 commutator terms); anything else it does
    not take raises. CPU tensors run :func:`torch_dense_chains`."""
    if m not in (8, 12):
        raise ValueError(f"PS propagator supports m in {{8, 12}}, got {m}")
    if node_ops.ndim != 4 or node_ops.shape[0] != table.n_nodes:
        raise ValueError(
            f"fused_dense_chain_apply: node_ops must be ({table.n_nodes}, B, "
            f"D, D), got {tuple(node_ops.shape)}")
    if all(a.device.type == "cpu" for a in (node_ops, dt, xw)):
        y, err = torch_dense_chains(table, node_ops, dt.to(xw.dtype), xw,
                                    m=m, theta=theta,
                                    max_squarings=max_squarings, wnorm=wnorm)
        return y, (torch.zeros_like(dt, dtype=xw.dtype) if err is None
                   else err)
    if xw.device.type != "cuda":
        raise ValueError(
            f"fused_dense_chain_apply: unsupported device {xw.device}")
    if xw.dtype not in (torch.float32, torch.float64):
        raise TypeError("fused_dense_chain_apply: the kernel takes float32 "
                        f"or float64, not {xw.dtype}")
    if xw.ndim != 2 or xw.shape[0] < 1 or not xw.is_contiguous():
        raise ValueError("fused_dense_chain_apply: xw must be a contiguous "
                         f"(B, D) with B >= 1, got {tuple(xw.shape)}")
    B, D = xw.shape
    if D > MAX_DIM:
        raise ValueError(f"fused_dense_chain_apply: state width {D} exceeds "
                         f"the kernel's maximum {MAX_DIM}")
    check_table(table)
    if not 0 <= max_squarings <= 64:
        raise ValueError("fused_dense_chain_apply: max_squarings must be in "
                         f"[0, 64], got {max_squarings}")
    for name, a, shape in (("node_ops", node_ops, (table.n_nodes, B, D, D)),
                           ("dt", dt, (B,))):
        if a.device != xw.device or a.dtype != xw.dtype:
            raise TypeError(f"fused_dense_chain_apply: {name} is {a.dtype} on "
                            f"{a.device}, xw is {xw.dtype} on {xw.device}")
        if tuple(a.shape) != shape:
            raise ValueError(f"fused_dense_chain_apply: {name} must be "
                             f"{shape}, got {tuple(a.shape)}")
    if not dt.is_contiguous():
        raise ValueError("fused_dense_chain_apply: dt must be contiguous")
    if D > 1 and (node_ops.stride(3) != 1 or node_ops.stride(2) != D):
        raise ValueError("fused_dense_chain_apply: each (D, D) sample of "
                         "node_ops must be contiguous")
    # where its product tiles are full (D a multiple of 128) the kernel
    # reads the samples in 16-byte vectors
    if D % 128 == 0 and any(
            v % 16 for v in (node_ops.data_ptr(),
                             node_ops.stride(0) * node_ops.element_size(),
                             node_ops.stride(1) * node_ops.element_size())):
        raise ValueError("fused_dense_chain_apply: node_ops must be aligned "
                         "to 16 bytes, with strides over nodes and "
                         "trajectories that are multiples of 16 bytes")
    wn = wnorm_on(wnorm, xw)
    if wn is not None and wn[0] is not None and wn[0].shape != (D,):
        raise ValueError(f"fused_dense_chain_apply: the norm's weight row "
                         f"must have {D} entries, got {tuple(wn[0].shape)}")
    lib = _kernel_lib()
    fn = (lib.vec_ode_dense_chains_f32 if xw.dtype == torch.float32
          else lib.vec_ode_dense_chains_f64)
    arr = table.kernel_array(m, theta, max_squarings)
    y = torch.empty_like(xw)
    err = torch.empty_like(dt)
    with torch.cuda.device(xw.device):
        n_blocks = _grid_blocks(lib, xw)
        scratch = torch.empty(n_blocks * N_BUF * D * D, dtype=xw.dtype,
                              device=xw.device)
        rc = fn(node_ops.data_ptr(), node_ops.stride(1), node_ops.stride(0),
                dt.data_ptr(), xw.data_ptr(), y.data_ptr(), err.data_ptr(),
                scratch.data_ptr(), n_blocks, B, D, arr, len(arr),
                *kernel_norm_args(wn),
                torch.cuda.current_stream(xw.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("fused_dense_chain_apply: kernel launch failed "
                           f"with CUDA error {rc}")
    fused_dense_chain_apply.launches += 1
    return y, err


fused_dense_chain_apply.launches = 0


def chain_products(table: ChainTable, counts: Sequence) -> int:
    """The (D, D) x (D, D) products one step of every trajectory takes: two
    per commutator term, and per exponent five for the polynomial and its
    squarings (``counts``: per exponent the (B,) counts of
    :func:`torch_dense_chains`), summed over the batch."""
    B = counts[0].shape[0]
    return (2 * table.n_comms * B
            + sum(5 * B + int(s.sum()) for s in counts))

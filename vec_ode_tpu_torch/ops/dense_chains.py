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
  exponent (:func:`scaling`: ``ops/expm.squaring_count``, the least s >= 0
  with norm / theta <= 2^s, s = 0 for a NaN norm and ``max_squarings`` for
  an infinite one), then per exponent the route of :func:`takes_actions`:
  2^s passes of the degree-m Taylor polynomial of 2^-s W applied to the
  running vector (one matrix-vector product a term), or, past the rule,
  the Paterson-Stockmeyer polynomial formed as a matrix, s squarings and
  one product; then the error norm. The JAX kernel takes ceil(log2(.)) per
  trajectory and its XLA twin one count per batch, and both form every
  propagator; the results differ by rounding.
* :func:`fused_dense_chain_apply` is the wrapper of the hand-written CUDA
  kernel ``csrc/dense_chains.cu`` (K9): CPU tensors run the twin, CUDA
  tensors launch the kernel or raise.
  ``fused_dense_chain_apply.launches`` counts the launches.
* :func:`dense_plan` mirrors the kernel's launch plan (the cluster, the
  rows of W a block keeps in shared memory, the grid) from the shape.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from .. import lc
from . import _build
from .expm import one_norm, squaring_count, taylor_ps
from .fused_rk import kernel_norm_args, wnorm_on

# the kernel's limits and launch constants (csrc/dense_chains.cu)
MAX_DIM = 256
MAX_NODES = 8
MAX_EXPONENTS = 12
MAX_COMMS = 12
THREADS = 256
JC = 8             # contraction indices a panel of a product
MAX_RC = 64        # rows a chunk of a product at most
MAX_CLUSTER = 8
RM = {4: 8, 8: 4}  # product rows a thread, by element size
MIN_BLOCKS = {4: 2, 8: 1}  # blocks an SM the launch bounds keep registers for
N_BUF = 6          # (D, D) scratch buffers a cluster, formed route
N_VEC = 5          # (D,) vectors a block
CN = 4             # columns a thread of a product; the vectors' rounding


def ps_products(m: int) -> int:
    """The formed route's products before its squarings:
    Paterson-Stockmeyer's five at m = 12 (``taylor_ps``), four at m = 8."""
    return 5 if m == 12 else 4


def takes_actions(s, m: int, D: int):
    """The route rule of csrc/dense_chains.cu (``takes_actions``): an
    exponent with squaring count s is applied as 2^s passes of m Taylor
    actions (2 D^2 each) while those cost less than the formed route's
    ``ps_products(m) + s`` products (2 D^3 each), in integer arithmetic.
    ``s`` an int or an integer tensor; returns a bool or a bool tensor."""
    if isinstance(s, torch.Tensor):
        s64 = s.to(torch.int64)
        lhs = torch.bitwise_left_shift(torch.ones_like(s64),
                                       torch.clamp(s64, 0, 30)) * m
        return (s64 < 31) & (lhs < (ps_products(m) + s64) * D)
    return s < 31 and (1 << s) * m < (ps_products(m) + s) * D


def scaling(W, theta: float, max_squarings: int):
    """The squaring count of each (D, D) in W: ``squaring_count`` of its
    1-norm (0 for a NaN norm), and ``max_squarings`` where norm / theta is
    infinite, as the kernel counts."""
    norm = one_norm(W)
    s = squaring_count(norm, theta, max_squarings)
    return torch.where(torch.isinf(norm / theta), max_squarings, s)


def _align16(nbytes: int) -> int:
    return -(-nbytes // 16) * 16


def _layout(D: int, elem: int, cs: int) -> dict:
    """csrc/dense_chains.cu's plan_with: the shape of a block of a cluster
    of ``cs`` blocks and its shared memory in bytes."""
    rows = -(-D // cs)
    dpr = -(-D // CN) * CN
    q = 128 // elem
    dp = -(-D // q) * q + 32 // elem
    ncg = dpr // CN
    nrg = min(THREADS // ncg, MAX_RC // RM[elem], -(-rows // RM[elem]))
    rc = nrg * RM[elem]
    tpr = 1
    while tpr * 2 <= THREADS // rows and tpr < 32:
        tpr *= 2
    smem = (_align16(rows * dp * elem)
            + _align16(2 * 2 * JC * (rc + 4 + dpr) * elem)
            + _align16(N_VEC * dpr * elem) + _align16(cs * dpr * elem)
            + _align16(THREADS * elem) + 16)
    return dict(cs=cs, rows=rows, rc=rc, dp=dp, tpr=tpr, smem=smem)


def dense_plan(B: int, D: int, elem: int, n_sm: int = 132,
               max_smem: int = 232448, smem_sm: int = 233472,
               reserved: int = 1024) -> dict:
    """K9's launch plan (csrc/dense_chains.cu: dense_plan, grid_clusters)
    on a card of ``n_sm`` SMs: the least cluster size ``cs`` in 1, 2, 4, 8
    whose blocks, each keeping ceil(D / cs) rows of the exponent W in
    shared memory, fit ``max_smem``; ``rows`` a block, ``rc`` rows a
    product chunk, ``dp`` W's padded row, ``tpr`` threads a row of a
    matrix-vector product, ``smem`` bytes a block; ``clusters`` of the
    persistent grid (what the SMs hold by shared memory, at most
    MIN_BLOCKS a SM, at most one per trajectory), ``blocks`` and the
    ``scratch`` values of the formed route. None where nothing fits."""
    cs = 1
    while cs <= MAX_CLUSTER and cs <= D:
        lay = _layout(D, elem, cs)
        if lay["smem"] <= max_smem:
            per_sm = max(1, min(MIN_BLOCKS[elem],
                                smem_sm // (lay["smem"] + reserved)))
            clusters = min(B, max(1, n_sm * per_sm // cs))
            return dict(lay, clusters=clusters, blocks=clusters * cs,
                        per_sm=per_sm, scratch=clusters * N_BUF * D * D)
        cs *= 2
    return None


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
    """Plain twin of K9: per trajectory and exponent, the squaring count of
    its own 1-norm (:func:`scaling`) and the route of
    :func:`takes_actions`: 2^s passes of T_m(2^-s W) on the running vector,
    each term (2^-s W term) / j added in order; or T_m(2^-s W) by
    Paterson-Stockmeyer, its own number of squarings (rows past their count
    keep their value) and one product. Then the chains applied to xw (B,
    D). Returns (y (B, D), err (B,) or None with one chain); err is the l2
    distance of the two chains, or their distance in the declared norm
    ``wnorm = (w_row, post, kind)`` (``lc.WeightedNorm.kernel_parts``).
    ``counts``, if a list, receives each exponent's (B,) squaring counts."""
    chains = table.exponents(node_ops.to(xw.dtype), dt)
    D = xw.shape[-1]
    outs = []
    for chain in chains:
        v = xw
        for W in chain:
            s = scaling(W, theta, max_squarings)
            if counts is not None:
                counts.append(s)
            As = W * torch.ldexp(torch.ones_like(dt, dtype=W.dtype),
                                 -s)[:, None, None]
            act = takes_actions(s, m, D)
            new = v
            if bool(act.any()):
                n_pass = torch.where(act, torch.bitwise_left_shift(
                    torch.ones_like(s), torch.clamp(s, 0, 30)), 0)
                for p in range(int(n_pass.max())):
                    acc = term = new
                    for j in range(1, m + 1):
                        term = (As @ term[..., None])[..., 0] / j
                        acc = acc + term
                    new = torch.where((n_pass > p)[:, None], acc, new)
            if not bool(act.all()):
                P = taylor_ps(As, m)
                sf = torch.where(act, 0, s)
                for i in range(int(sf.max())):
                    P = torch.where((sf > i)[:, None, None], P @ P, P)
                new = torch.where(act[:, None], new,
                                  (P @ v[..., None])[..., 0])
            v = new
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
        fn.argtypes = [vp, ll, ll, vp, vp, vp, vp, vp, ll, ci, ci,
                       ctypes.POINTER(ctypes.c_double), ci, vp,
                       ctypes.c_double, ci, vp]
    for fn in (lib.vec_ode_dense_chains_plan_f32,
               lib.vec_ode_dense_chains_plan_f64):
        fn.restype = ci
        fn.argtypes = [ci, ci, ctypes.POINTER(ctypes.c_longlong)]
    return lib


PLAN_KEYS = ("cs", "rows", "rc", "dp", "tpr", "smem", "clusters", "scratch")


def kernel_plan(B: int, D: int, dtype) -> dict:
    """The plan the kernel launches with on the current card
    (``vec_ode_dense_chains_plan_*``), keyed as :func:`dense_plan`."""
    return dict(_kernel_plan(B, D, dtype == torch.float32,
                             torch.cuda.current_device()))


@functools.lru_cache(maxsize=256)
def _kernel_plan(B: int, D: int, f32: bool, _device: int) -> tuple:
    lib = _kernel_lib()
    fn = (lib.vec_ode_dense_chains_plan_f32 if f32
          else lib.vec_ode_dense_chains_plan_f64)
    out = (ctypes.c_longlong * len(PLAN_KEYS))()
    rc = fn(B, D, out)
    if rc != 0:
        raise RuntimeError("fused_dense_chain_apply: the plan query failed "
                           f"with CUDA error {rc}")
    return tuple(zip(PLAN_KEYS, (int(v) for v in out)))


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


def fused_dense_chain_apply(table: ChainTable, node_ops, dt, xw, *, m: int,
                            theta: float, max_squarings: int = 16,
                            wnorm=None):
    """One step of every trajectory (K9): ``node_ops`` (n_nodes, B, D, D)
    the operator samples (each (D, D) sample contiguous, at any offset; the
    strides over nodes and trajectories free), dt (B,), xw
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
    wn = wnorm_on(wnorm, xw)
    if wn is not None and wn[0] is not None and wn[0].shape != (D,):
        raise ValueError(f"fused_dense_chain_apply: the norm's weight row "
                         f"must have {D} entries, got {tuple(wn[0].shape)}")
    _build.refuse_grad("fused_dense_chain_apply", node_ops, dt, xw,
                       None if wn is None else wn[0])
    lib = _kernel_lib()
    fn = (lib.vec_ode_dense_chains_f32 if xw.dtype == torch.float32
          else lib.vec_ode_dense_chains_f64)
    arr = table.kernel_array(m, theta, max_squarings)
    y = torch.empty_like(xw)
    err = torch.empty_like(dt)
    with torch.cuda.device(xw.device):
        # the formed route's buffers: untouched where every exponent takes
        # the actions
        n_scratch = kernel_plan(B, D, xw.dtype)["scratch"]
        scratch = torch.empty(n_scratch, dtype=xw.dtype, device=xw.device)
        rc = fn(node_ops.data_ptr(), node_ops.stride(1), node_ops.stride(0),
                dt.data_ptr(), xw.data_ptr(), y.data_ptr(), err.data_ptr(),
                scratch.data_ptr(), n_scratch, B, D, arr, len(arr),
                *kernel_norm_args(wn),
                torch.cuda.current_stream(xw.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("fused_dense_chain_apply: kernel launch failed "
                           f"with CUDA error {rc}")
    fused_dense_chain_apply.launches += 1
    return y, err


fused_dense_chain_apply.launches = 0

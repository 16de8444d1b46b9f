"""The dense chain step of the port on the CPU: the chain table and the
plain twin of K9 (``ops.dense_chains.torch_dense_chains``) against the JAX
package's ``dense_chains_xla`` and its Pallas kernel
``fused_dense_chain_apply`` in interpret mode, on the same numpy inputs
(the cases of tests/test_pallas_dense.py, at the Pallas kernel's gates
D = 128, B = 8, in f32); and every stepper's table and node assembly
against the exponents its JAX counterpart hands its executors.

Tolerances: the twin scales each trajectory by its own count found with
frexp, the Pallas kernel by ceil(log2) per trajectory and the XLA
reference by one count per batch, so f32 results agree to a few f32 ulp
of values of order 1: 2e-6 (1e-5 where a squaring count may differ). The
exponents in f64 agree to rounding, 1e-14 of their largest entry.
"""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vec_ode_tpu import exp as vexp
from vec_ode_tpu.exp import dense_fast as jdf
from vec_ode_tpu.models import DrivenDense as JDrivenDense
from vec_ode_tpu.ops import cplx as jcp
from vec_ode_tpu.ops.pallas_dense import _mm, dense_chains_xla
from vec_ode_tpu.ops.pallas_dense import \
    fused_dense_chain_apply as pallas_dense_chain_apply
from vec_ode_tpu.utils.prec import HIGHEST
from vec_ode_tpu_torch import convert
from vec_ode_tpu_torch import exp as texp
from vec_ode_tpu_torch.exp import cfm as tcfm
from vec_ode_tpu_torch.exp import dense_fast as tdf
from vec_ode_tpu_torch.exp import magnus as tmagnus
from vec_ode_tpu_torch.ops import cplx as tcp
from vec_ode_tpu_torch.ops import dense_chains as dc
from vec_ode_tpu_torch.ops.dense_chains import (ChainTable, Exponent,
                                                fused_dense_chain_apply,
                                                torch_dense_chains)

torch.set_num_threads(1)

B, D = 8, 128
PS = dict(m=12, theta=1.0)


def _rand_ops(n, scale=0.15, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, D, D)).astype(np.float32) * scale
            / D ** 0.5 for _ in range(n)]


def _x():
    return np.random.default_rng(1).standard_normal((B, D)).astype(np.float32)


def _twin(table, mats, dt, xw, **kw):
    y, e = torch_dense_chains(
        table, torch.as_tensor(np.stack(mats)), torch.as_tensor(dt),
        torch.as_tensor(xw), **{**PS, **kw})
    return y.numpy(), None if e is None else e.numpy()


def _pallas(mats, dt, xw, chains_fn):
    node_ops = jnp.stack([jnp.asarray(a) for a in mats], axis=1).reshape(
        B * len(mats) * D, D)
    (y,), e = pallas_dense_chain_apply(
        [jnp.asarray(dt)[:, None]], node_ops, (jnp.asarray(xw),), chains_fn,
        n_nodes=len(mats), interpret=True, **PS)
    return np.asarray(y), np.asarray(e)


def test_twin_matches_xla_and_pallas_on_a_magnus_like_pair():
    """Two chains with an in-kernel commutator."""
    A1, A2 = _rand_ops(2)
    xw = _x()
    dt = np.random.default_rng(2).uniform(0.05, 0.2, B).astype(np.float32)
    table = ChainTable(2, [[Exponent((0.5, 0.5), ((0, 1, 0.1),))],
                           [Exponent((0.5, 0.5))]])
    y, e = _twin(table, [A1, A2], dt, xw)

    def chains_fn(mats, scalars):
        M1, M2 = mats
        (dt_s,) = scalars[0]
        w1 = (0.5 * dt_s) * (M1 + M2)
        comm = _mm(M1, M2, HIGHEST) - _mm(M2, M1, HIGHEST)
        return [[w1 + (0.1 * dt_s * dt_s) * comm], [w1]]

    yk, ek = _pallas([A1, A2], dt, xw, chains_fn)
    dt3 = jnp.asarray(dt)[:, None, None]
    J1, J2 = jnp.asarray(A1), jnp.asarray(A2)
    w1 = 0.5 * dt3 * (J1 + J2)
    mmb = lambda a, b: jnp.matmul(a, b, precision=HIGHEST)  # noqa: E731
    omega = w1 + 0.1 * dt3 * dt3 * (mmb(J1, J2) - mmb(J2, J1))
    yx, ex = dense_chains_xla([[omega], [w1]], jnp.asarray(xw), **PS)
    for y_ref, e_ref in ((yk, ek), (np.asarray(yx), np.asarray(ex))):
        assert np.abs(y - y_ref).max() < 2e-6
        assert np.abs(e - e_ref).max() < 2e-6
    assert e.max() > 1e-4      # the comparison is not of zeros


def test_twin_unequal_chain_lengths():
    """The error chain is shorter than the main chain: no zero-row
    padding."""
    A1, A2 = _rand_ops(2, scale=0.3, seed=5)
    xw, dt = _x(), np.ones(B, np.float32)
    table = ChainTable(2, [[Exponent((0.3, 0.0)), Exponent((0.0, 0.3))],
                           [Exponent((0.15, 0.15))]])
    y, e = _twin(table, [A1, A2], dt, xw)

    def chains_fn(mats, scalars):
        M1, M2 = mats
        return [[0.3 * M1, 0.3 * M2], [0.15 * (M1 + M2)]]

    yk, ek = _pallas([A1, A2], dt, xw, chains_fn)
    J1, J2 = jnp.asarray(A1), jnp.asarray(A2)
    yx, ex = dense_chains_xla([[0.3 * J1, 0.3 * J2], [0.15 * (J1 + J2)]],
                              jnp.asarray(xw), **PS)
    for y_ref, e_ref in ((yk, ek), (np.asarray(yx), np.asarray(ex))):
        assert np.abs(y - y_ref).max() < 1e-5
        assert np.abs(e - e_ref).max() < 1e-5


def test_twin_large_norm_row_squares_by_its_own_count():
    """One row far past theta squares by its own count, and still matches
    the Pallas kernel and an f64 matrix exponential."""
    (W,) = _rand_ops(1)
    W[3] *= 40.0
    xw, dt = _x(), np.ones(B, np.float32)
    table = ChainTable(1, [[Exponent((1.0,))]])
    counts = []
    y, e = _twin(table, [W], dt, xw, counts=counts)
    assert e is None
    s = counts[0].numpy()
    # each row takes its own count: the boosted row 40x the norm, 5 more
    assert s[3] == np.delete(s, 3).max() + 5 and np.delete(s, 3).max() <= 1
    yk, _ = _pallas([W], dt, xw, lambda mats, scalars: [[mats[0]]])
    y_ref = np.einsum("bij,bj->bi", torch.linalg.matrix_exp(
        torch.as_tensor(W).double()).numpy(), xw.astype(np.float64))
    scale = np.maximum(np.abs(y_ref).max(axis=1), 1.0)
    assert (np.abs(y - y_ref).max(axis=1) / scale).max() < 2e-4
    assert (np.abs(y - yk).max(axis=1) / scale).max() < 1e-5


def test_twin_nan_row_stays_local():
    (W,) = _rand_ops(1)
    clean = W.copy()
    W[2] = np.nan
    xw, dt = _x(), np.ones(B, np.float32)
    table = ChainTable(1, [[Exponent((1.0,))], [Exponent((0.5,))]])
    y, e = _twin(table, [W], dt, xw)
    assert np.isnan(y[2]).all() and np.isnan(e[2])
    yc, ec = _twin(table, [clean], dt, xw)
    keep = np.arange(B) != 2
    np.testing.assert_array_equal(y[keep], yc[keep])
    np.testing.assert_array_equal(e[keep], ec[keep])
    yk, ek = _pallas([W], dt, xw,
                     lambda mats, scalars: [[mats[0]], [0.5 * mats[0]]])
    assert np.abs(y[keep] - yk[keep]).max() < 2e-6
    assert np.abs(e[keep] - ek[keep]).max() < 2e-6


WNORMS = {"l2_weighted": ("l2", True), "rms": ("rms", False),
          "rms_weighted": ("rms", True), "max": ("max", False),
          "max_weighted": ("max", True)}


@pytest.mark.parametrize("stacked", [False, True], ids=["twin", "stacked"])
@pytest.mark.parametrize("name", sorted(WNORMS))
def test_declared_norm_matches_jax(name, stacked):
    """A declared WeightedNorm measures the chains' distance in the twin
    (as in the kernel) and in the stacked reference; the JAX package's
    executor applies the same declaration. f64 at d = 8 complex, a
    Magnus-4 pair: y and err to 1e-13."""
    from vec_ode_tpu import lc as jlc
    from vec_ode_tpu_torch import lc

    kind, weighted = WNORMS[name]
    d, nb = 8, 5
    rng = np.random.default_rng(21)
    ops = rng.standard_normal((2, nb, 2 * d, 2 * d)) / (2 * d) ** 0.5
    dt = rng.uniform(0.05, 0.5, nb)
    psi = rng.standard_normal((nb, d)) + 1j * rng.standard_normal((nb, d))
    w = tuple(np.linspace(0.5, 2.0, d)) if weighted else None
    table = tmagnus.magnus4_table(pair=True)
    tkp = lc.WeightedNorm(kind, w).kernel_parts(d, 2)
    x = tcp.from_complex(psi, torch.float64, "cpu")
    if stacked:
        y, e = tdf.run_stacked_chains(
            texp.DenseCplxSplit(), x, torch.as_tensor(dt),
            torch.as_tensor(ops), table, adaptive=True, wnorm=tkp)
    else:
        y, e = tdf.run_batched_chains(
            texp.DenseCplxSplit(), x, torch.as_tensor(dt),
            torch.as_tensor(ops), table, adaptive=True, wnorm=tkp)

    chains = table.exponents(torch.as_tensor(ops), torch.as_tensor(dt))
    jy, je = jdf.run_batched_chains(
        vexp.DenseCplxSplit(), jcp.from_complex(psi, jnp.float64),
        jnp.asarray(dt), [jnp.asarray(a) for a in ops], None,
        lambda: [[jnp.asarray(W.numpy()) for W in c] for c in chains],
        adaptive=True, use_pallas=False, interpret=False,
        wnorm=jlc.WeightedNorm(kind, w).kernel_parts(d, 2))
    assert np.abs(y.re.numpy() - np.asarray(jy.re)).max() < 1e-13
    assert np.abs(y.im.numpy() - np.asarray(jy.im)).max() < 1e-13
    assert np.abs(e.numpy() - np.asarray(je)).max() < 1e-13
    # ... and it is not the plain l2 norm
    _, e2 = tdf.run_batched_chains(
        texp.DenseCplxSplit(), x, torch.as_tensor(dt), torch.as_tensor(ops),
        table, adaptive=True)
    assert np.abs(e.numpy() - e2.numpy()).max() > 1e-6


def test_declared_norm_keeps_a_nan_row_local():
    """The max reduction carries a NaN row's NaN and no other row's."""
    from vec_ode_tpu_torch import lc

    (W,) = _rand_ops(1)
    W[2] = np.nan
    xw, dt = _x(), np.ones(B, np.float32)
    table = ChainTable(1, [[Exponent((1.0,))], [Exponent((0.5,))]])
    for kind in ("max", "l2"):
        kp = lc.WeightedNorm(kind, tuple(np.linspace(1, 2, D // 2))
                             ).kernel_parts(D // 2, 2)
        _, e = _twin(table, [W], dt, xw, wnorm=kp)
        assert np.isnan(e[2]) and np.isfinite(np.delete(e, 2)).all()



def test_twin_f64_matches_matrix_exp():
    rng = np.random.default_rng(7)
    ops = rng.standard_normal((2, 5, 8, 8)) / 8 ** 0.5
    dt, xw = rng.uniform(0.05, 2.0, 5), rng.standard_normal((5, 8))
    table = tmagnus.magnus4_table(pair=True)
    y, e = torch_dense_chains(table, torch.as_tensor(ops),
                              torch.as_tensor(dt), torch.as_tensor(xw),
                              m=12, theta=0.25)
    W = table.exponents(torch.as_tensor(ops), torch.as_tensor(dt))
    ref = [(torch.linalg.matrix_exp(w[0]) @ torch.as_tensor(xw)[..., None]
            )[..., 0] for w in W]
    assert float((y - ref[0]).abs().max()) < 1e-13
    assert float((e - (ref[1] - ref[0]).norm(dim=-1)).abs().max()) < 1e-13


def test_wrapper_runs_the_twin_on_cpu_tensors_and_counts_nothing():
    rng = np.random.default_rng(8)
    table = tmagnus.magnus4_table(pair=False)
    ops = torch.as_tensor(rng.standard_normal((2, 4, 6, 6)) / 3)
    dt = torch.as_tensor(rng.uniform(0.01, 0.1, 4))
    xw = torch.as_tensor(rng.standard_normal((4, 6)))
    before = fused_dense_chain_apply.launches
    y, e = fused_dense_chain_apply(table, ops, dt, xw, m=12, theta=0.25)
    yt, et = torch_dense_chains(table, ops, dt, xw, m=12, theta=0.25)
    assert fused_dense_chain_apply.launches == before
    assert torch.equal(y, yt) and et is None
    assert torch.equal(e, torch.zeros(4, dtype=torch.float64))
    with pytest.raises(ValueError):
        fused_dense_chain_apply(table, ops[:1], dt, xw, m=12, theta=0.25)
    with pytest.raises(ValueError):
        fused_dense_chain_apply(table, ops, dt, xw, m=10, theta=0.25)


def test_table_validation_and_kernel_limits():
    with pytest.raises(ValueError):
        ChainTable(2, [[Exponent((1.0,))]])             # row too short
    with pytest.raises(ValueError):
        ChainTable(1, [[Exponent((1.0,), ((0, 1, 0.5),))]])   # node 1 of 1
    with pytest.raises(ValueError):
        ChainTable(1, [[Exponent((1.0,))], []])         # an empty chain
    with pytest.raises(ValueError):
        ChainTable(1, [[Exponent((1.0,))]] * 3)         # three chains
    dc.check_table(tmagnus.magnus6_table(True))
    with pytest.raises(ValueError):
        dc.check_table(ChainTable(9, [[Exponent((1.0,) * 9)]]))
    with pytest.raises(ValueError):
        dc.check_table(ChainTable(1, [[Exponent((1.0,))] * 13]))
    with pytest.raises(ValueError):
        dc.check_table(ChainTable(2, [[Exponent(
            (1.0, 1.0), ((0, 1, 0.1),) * 13)]]))


def test_kernel_array_layout():
    """The flat table as csrc/dense_chains.cu's parse_table reads it."""
    table = tmagnus.magnus4_table(pair=True)
    arr = table.kernel_array(12, 1.0, 16)
    assert isinstance(arr, ctypes.Array)
    assert list(arr) == [2, 2, 1, 1, 12, 16, 1.0, 1,
                         0.5, 0.5, 0.5, 0.5,
                         0, 0, 1, tmagnus._B2]
    arr6 = list(tmagnus.magnus6_table(True).kernel_array(12, 0.25, 8))
    assert arr6[:8] == [8, 2, 3, 1, 12, 8, 0.25, 4]
    assert len(arr6) == 8 + 4 * 8 + 4 * 4
    assert arr6[8 + 32:8 + 36] == [0, 0, 1, tmagnus._B2 * tmagnus._G1 ** 2]
    assert arr6[-4:-1] == [3, 6, 7]
    blanes = list(tcfm.cfm_table(np.eye(3), [[0.0, 0.0, 0.0]])
                  .kernel_array(8, 0.35, 16))
    assert blanes[:8] == [3, 2, 3, 1, 8, 16, 0.35, 0]
    assert blanes[-3:] == [0.0, 0.0, 0.0]       # an all-zero row stays


def test_zero_row_is_the_identity():
    rng = np.random.default_rng(9)
    ops = torch.as_tensor(rng.standard_normal((2, 3, 4, 4)))
    xw = torch.as_tensor(rng.standard_normal((3, 4)))
    table = tcfm.cfm_table([[0.0, 0.0]])
    y, _ = torch_dense_chains(table, ops, torch.ones(3, dtype=torch.float64),
                              xw, m=12, theta=0.25)
    assert torch.equal(y, xw)


# -- every stepper's table and node assembly against its JAX counterpart ----

D_S, B_S = 4, 5


def _split_ops(seed=11):
    rng = np.random.default_rng(seed)

    def herm():
        M = (rng.standard_normal((D_S, D_S))
             + 1j * rng.standard_normal((D_S, D_S)))
        return (M + M.conj().T) / (2 * np.sqrt(D_S))

    HA, HB = herm(), herm()
    parts = [HA.imag, -HA.real, HB.imag, -HB.real]
    jp = [jnp.asarray(a) for a in parts]
    tp = [torch.as_tensor(a.copy()) for a in parts]

    def jops(t):
        c = jnp.cos(1.3 * jnp.asarray(t))
        return (jcp.Cplx(jp[0] * c, jp[1] * c), jcp.Cplx(jp[2], jp[3]))

    def tops(t):
        c = torch.cos(1.3 * t)
        return (tcp.Cplx(tp[0] * c, tp[1] * c), tcp.Cplx(tp[2] + 0 * c,
                                                         tp[3] + 0 * c))

    return jops, tops


SPLIT_CFM = dict(rho=((0.5, 0.5),), sigma=((0.5, 0.0), (0.0, 0.5)),
                 c=(0.2113248654051871, 0.7886751345948129))
STEPPERS = {
    "midpoint": (lambda m, **kw: m.ExpMidpoint(m.DenseCplxSplit(), **kw),
                 False),
    "magnus4": (lambda m, **kw: m.Magnus4(m.DenseCplxSplit(), **kw), False),
    "magnus4_fixed": (lambda m, **kw: m.Magnus4(
        m.DenseCplxSplit(), adaptive=False, **kw), False),
    "magnus4_fast": (lambda m, **kw: m.Magnus4(
        m.DenseCplxSplit(), fast_error=True, **kw), False),
    "magnus6": (lambda m, **kw: m.Magnus6(m.DenseCplxSplit(), **kw), False),
    "magnus6_fixed": (lambda m, **kw: m.Magnus6(
        m.DenseCplxSplit(), adaptive=False, **kw), False),
    "cfm4": (lambda m, **kw: m.CFM4(m.DenseCplxSplit(), **kw), False),
    "cfm4_fixed": (lambda m, **kw: m.CFM4(
        m.DenseCplxSplit(), adaptive=False, **kw), False),
    "cfm4_blanes17": (lambda m, **kw: m.CFM4_BLANES17(
        m.DenseCplxSplit(), **kw), False),
    "split_midpoint": (lambda m, **kw: m.SplitMidpoint(
        m.DenseCplxSplit(), m.DenseCplxSplit(), **kw), True),
    "split_midpoint_strict": (lambda m, **kw: m.SplitMidpoint(
        m.DenseCplxSplit(), m.DenseCplxSplit(),
        strict_reference_compat=True, **kw), True),
    "split_cfm": (lambda m, **kw: m.SplitCFM(
        m.DenseCplxSplit(), m.DenseCplxSplit(), **SPLIT_CFM, **kw), True),
}


@pytest.mark.parametrize("name", sorted(STEPPERS))
def test_stepper_table_matches_jax_exponents(name, monkeypatch):
    """One batched step of each stepper in both packages with the
    executors replaced by a recorder: the port's node samples and its
    table's exponents equal the samples and ``xla_chains()`` exponents the
    JAX stepper hands ``run_batched_chains``."""
    make, is_split = STEPPERS[name]
    rng = np.random.default_rng(3)
    t = rng.uniform(0.0, 1.0, B_S)
    dt = rng.uniform(0.01, 0.2, B_S)
    psi = rng.standard_normal((B_S, D_S)) + 1j * rng.standard_normal(
        (B_S, D_S))
    if is_split:
        jop, top = _split_ops()
    else:
        model = JDrivenDense.make(d=D_S, seed=0)
        jop = lambda tt: model.op_pair(tt, jnp.float64)  # noqa: E731
        top = convert.driven_op_from_numpy(model.H0, model.V, model.w,
                                           dtype=torch.float64, device="cpu")
    seen = {}

    def jrecord(split, x, dt_, node_embedded, kernel_chain_builder,
                xla_chains, **kw):
        seen["j"] = ([np.asarray(e) for e in node_embedded],
                     [[np.asarray(w) for w in c] for c in xla_chains()], kw)
        return x, (jnp.zeros(B_S) if kw["adaptive"] else None)

    def trecord(split, x, dt_, node_ops, table, **kw):
        seen["t"] = (node_ops, table, kw)
        return x, (torch.zeros(B_S, dtype=torch.float64) if kw["adaptive"]
                   else None)

    monkeypatch.setattr(jdf, "run_batched_chains", jrecord)
    monkeypatch.setattr(tdf, "run_batched_chains", trecord)
    make(vexp).make_step_fn(jop)(
        jnp.asarray(t), jcp.from_complex(psi, jnp.float64), jnp.asarray(dt))
    make(texp).make_step_fn(top)(
        torch.as_tensor(t), tcp.from_complex(psi, torch.float64, "cpu"),
        torch.as_tensor(dt))
    j_nodes, j_chains, j_kw = seen["j"]
    node_ops, table, t_kw = seen["t"]
    assert t_kw["adaptive"] == j_kw["adaptive"]
    assert node_ops.shape == (len(j_nodes), B_S, 2 * D_S, 2 * D_S)
    assert table.n_nodes == len(j_nodes)
    for q, want in enumerate(j_nodes):
        assert np.abs(node_ops[q].numpy() - want).max() <= 1e-15
    chains = table.exponents(node_ops, torch.as_tensor(dt))
    assert [len(c) for c in chains] == [len(c) for c in j_chains]
    for got_c, want_c in zip(chains, j_chains):
        for got, want in zip(got_c, want_c):
            lim = 1e-14 * max(np.abs(want).max(), 1e-300)
            assert np.abs(got.numpy() - want).max() <= lim

"""K9's two routes on the CPU: the route rule (``ops.dense_chains.
takes_actions``, the integer rule of ``csrc/dense_chains.cu``) at its
crossover, the plain twin on each route against the JAX package's Pallas
kernel ``fused_dense_chain_apply`` in interpret mode and its XLA twin
``dense_chains_xla``, the two routes against each other in f64, the launch
plan's mirror (``ops.dense_chains.dense_plan``) against the CUDA source's
constants and the card's 227 KB, and K9's bound by the least work
(``chip_smoke.k9_flop_bytes``).

Inputs: skew-symmetric exponents (orthogonal propagators, so squarings do
not amplify), each trajectory's scaled to a set 1-norm, so every row of
an exponent takes the same squaring count in the twin (frexp), the Pallas
kernel (ceil(log2)) and the XLA twin (one count per batch). Tolerances:
the actions route and the formed route differ from the Pallas kernel's
Paterson-Stockmeyer products by rounding only: f32 2e-6 at s = 2, and, on
the formed route (s = 7 squarings), the 1e-5 of the row's scale that
test_torch_dense_chains.py holds a squaring row to; f64 1e-13 of the
state's scale (the two routes against each other up to s = 9, where 2^9
passes or nine squarings each round).
"""

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from vec_ode_tpu.ops.pallas_dense import dense_chains_xla
from vec_ode_tpu.ops.pallas_dense import \
    fused_dense_chain_apply as pallas_dense_chain_apply
from vec_ode_tpu_torch.exp import dense_fast as tdf
from vec_ode_tpu_torch.ops import dense_chains as dc
from vec_ode_tpu_torch.ops.dense_chains import (ChainTable, Exponent,
                                                torch_dense_chains)
from vec_ode_tpu_torch.ops.expm import taylor_ps

torch.set_num_threads(1)

CSRC = pathlib.Path(dc.__file__).parents[1] / "csrc"
B, D = 8, 128
# one node; chain 1 at 3/4 of chain 0's exponent, in the same squaring
# bracket (ratio 3 -> 2.25: s = 2; 100 -> 75: s = 7)
TABLE = ChainTable(1, [[Exponent((1.0,))], [Exponent((0.75,))]])
# the norm ratio per route; (m, theta) of the port per dtype
RATIO = {"actions": 3.0, "formed": 100.0}
NP_DTYPE = {torch.float32: np.float32, torch.float64: np.float64}


def _skew(ratio, theta, dtype, seed=0, n=B, d=D):
    """n skew-symmetric (d, d) matrices, each of 1-norm ratio * theta."""
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((n, d, d))
    W = G - np.swapaxes(G, 1, 2)
    W *= (ratio * theta / np.abs(W).sum(axis=1).max(axis=1))[:, None, None]
    return W.astype(NP_DTYPE[dtype])


def _x(dtype, n=B, d=D):
    return (np.random.default_rng(1).standard_normal((n, d))
            .astype(NP_DTYPE[dtype]))


# -- the route rule ---------------------------------------------------------

# (m, D): the largest s on the actions route, by hand from
# 2^s m < (ps_products(m) + s) D
CROSSOVER = {(12, 4): 0, (12, 64): 5, (12, 128): 6, (12, 256): 8,
             (8, 4): 1, (8, 64): 6, (8, 128): 7, (8, 256): 8}


@pytest.mark.parametrize("m,d", sorted(CROSSOVER))
def test_route_rule_at_its_crossover(m, d):
    s_max = CROSSOVER[(m, d)]
    for s in range(0, 65):
        want = s <= s_max
        assert dc.takes_actions(s, m, d) is want, s
        # the rule as the kernel writes it, in integer arithmetic
        assert (s < 31 and (1 << s) * m < (dc.ps_products(m) + s) * d) is want
    s = torch.arange(0, 65)
    assert torch.equal(dc.takes_actions(s, m, d), s <= s_max)


def test_route_rule_at_tiny_widths_forms_the_polynomial():
    """At D = 1 and 2 the five products cost less than 12 actions even
    without a squaring."""
    assert not dc.takes_actions(0, 12, 1) and not dc.takes_actions(0, 12, 2)
    assert dc.takes_actions(0, 12, 3) and dc.takes_actions(0, 8, 3)
    assert not dc.takes_actions(0, 8, 2)


def test_route_rule_is_the_sources():
    src = (CSRC / "dense_chains.cu").read_text()
    assert ("return s < 31 && (1LL << s) * m < (long long)(ps_products(m) "
            "+ s) * D;") in src
    assert "return m == 12 ? 5 : 4;" in src
    assert "getenv" not in src


# -- the twin on each route against the JAX package --------------------------

def _pallas(W, xw, m, theta):
    node_ops = jnp.asarray(W).reshape(B * D, D)
    (y,), e = pallas_dense_chain_apply(
        [jnp.ones((B, 1), W.dtype)], node_ops, (jnp.asarray(xw),),
        lambda mats, scalars: [[mats[0]], [0.75 * mats[0]]], n_nodes=1,
        interpret=True, m=m, theta=theta)
    return np.asarray(y), np.asarray(e)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("route", sorted(RATIO))
def test_twin_on_each_route_matches_pallas_and_xla(route, dtype):
    m, theta = tdf.ps_params(dtype)
    W, xw = _skew(RATIO[route], theta, dtype), _x(dtype)
    counts = []
    y, e = torch_dense_chains(TABLE, torch.as_tensor(W)[None],
                              torch.ones(B, dtype=dtype),
                              torch.as_tensor(xw), m=m, theta=theta,
                              counts=counts)
    want_s = {"actions": (2, 2), "formed": (7, 7)}[route]
    assert [set(s.tolist()) for s in counts] == [{want_s[0]}, {want_s[1]}]
    acts = [bool(dc.takes_actions(s, m, D).all()) for s in counts]
    assert acts == [route == "actions"] * 2
    y, e = y.numpy(), e.numpy()
    yx, ex = dense_chains_xla([[jnp.asarray(W)], [0.75 * jnp.asarray(W)]],
                              jnp.asarray(xw), m=m, theta=theta)
    refs = [(np.asarray(yx), np.asarray(ex))]
    if dtype == torch.float32:   # the Pallas kernel's gates: f32, D = 128
        refs.append(_pallas(W, xw, m, theta))
    if dtype == torch.float64:
        lim = 1e-13
    else:
        lim = 2e-6 if route == "actions" else 1e-5
    scale = max(float(np.abs(xw).max()), 1.0)
    for y_ref, e_ref in refs:
        assert np.abs(y - y_ref).max() / scale < lim
        assert np.abs(e - e_ref).max() / scale < lim
    # orthogonal propagators keep the state's length
    np.testing.assert_allclose(np.linalg.norm(y, axis=1),
                               np.linalg.norm(xw, axis=1),
                               rtol=1e-4 if dtype == torch.float32 else 1e-12)


def _by_actions(W, x, s, m):
    """x <- (T_m(2^-s W))^{2^s} x as 2^s passes of m actions."""
    As = W * 2.0 ** -s
    for _ in range(2 ** s):
        acc = term = x
        for j in range(1, m + 1):
            term = (As @ term[..., None])[..., 0] / j
            acc = acc + term
        x = acc
    return x


def _by_forming(W, x, s, m):
    """x <- (T_m(2^-s W))^{2^s} x with the polynomial formed and squared."""
    P = taylor_ps(W * 2.0 ** -s, m)
    for _ in range(s):
        P = P @ P
    return (P @ x[..., None])[..., 0]


@pytest.mark.parametrize("ratio,s", [(3.0, 2), (12.0, 4), (100.0, 7),
                                     (300.0, 9)])
def test_both_routes_agree_to_rounding_in_f64(ratio, s):
    """The same (T_m(2^-s W))^{2^s} x by both routes to 1e-13 of the
    state's scale, and the twin gives, bit for bit, the route the rule
    picks."""
    m, theta = tdf.ps_params(torch.float64)
    W = torch.as_tensor(_skew(ratio, theta, torch.float64, seed=3))
    x = torch.as_tensor(_x(torch.float64))
    acts, forms = _by_actions(W, x, s, m), _by_forming(W, x, s, m)
    assert float((acts - forms).abs().max()) < 1e-13 * float(x.abs().max())
    counts = []
    y, _ = torch_dense_chains(ChainTable(1, [[Exponent((1.0,))]]), W[None],
                              torch.ones(B, dtype=torch.float64), x, m=m,
                              theta=theta, counts=counts)
    assert set(counts[0].tolist()) == {s}
    picked = acts if dc.takes_actions(s, m, D) else forms
    assert torch.equal(y, picked)


def test_twin_routes_each_row_by_its_own_count():
    """One batch with rows on both routes: each row equals the one-row
    twin, and a NaN row and an infinite row (max_squarings) stay local."""
    m, theta = tdf.ps_params(torch.float64)
    W = np.concatenate([_skew(3.0, theta, torch.float64, n=3),
                        _skew(100.0, theta, torch.float64, n=3, seed=4)])
    W[4, 0, 0] = np.nan
    W[5, 1, 0] = np.inf
    x = _x(torch.float64, n=6)
    table = ChainTable(1, [[Exponent((1.0,))]])
    counts = []
    y, _ = torch_dense_chains(table, torch.as_tensor(W)[None],
                              torch.ones(6, dtype=torch.float64),
                              torch.as_tensor(x), m=m, theta=theta,
                              max_squarings=16, counts=counts)
    assert counts[0].tolist() == [2, 2, 2, 7, 0, 16]
    for b in (0, 3):
        yb, _ = torch_dense_chains(table, torch.as_tensor(W[b:b + 1])[None],
                                   torch.ones(1, dtype=torch.float64),
                                   torch.as_tensor(x[b:b + 1]), m=m,
                                   theta=theta)
        assert float((y[b] - yb[0]).abs().max()) < 1e-15
    assert bool(torch.isnan(y[4]).all()) and not bool(
        torch.isfinite(y[5]).all())
    assert bool(torch.isfinite(y[:4]).all())


# -- the launch plan's mirror ------------------------------------------------

def _ints(name: str) -> dict:
    """The constexpr ints of csrc/<name>."""
    out = {}
    for decl in re.findall(r"constexpr int ([A-Z_0-9]+ = [^;]*);",
                           (CSRC / name).read_text()):
        for part in decl.split(","):
            key, value = (v.strip() for v in part.split("="))
            if re.fullmatch(r"-?\d+", value):
                out[key] = int(value)
    return out


def test_plan_constants_match_the_source():
    k9 = _ints("dense_chains.cu")
    assert (k9["MAX_DIM"], k9["MAX_NODES"], k9["MAX_EXPONENTS"],
            k9["MAX_COMMS"]) == (dc.MAX_DIM, dc.MAX_NODES, dc.MAX_EXPONENTS,
                                 dc.MAX_COMMS)
    assert (k9["THREADS"], k9["JC"], k9["MAX_RC"], k9["MAX_CLUSTER"],
            k9["N_BUF"], k9["N_VEC"]) == (dc.THREADS, dc.JC, dc.MAX_RC,
                                          dc.MAX_CLUSTER, dc.N_BUF, dc.N_VEC)
    assert (k9["RM_F32"], k9["RM_F64"]) == (dc.RM[4], dc.RM[8])
    assert _ints("gemm_tile.cuh")["GEMM_CN"] == dc.CN


@pytest.mark.parametrize("elem", [4, 8])
@pytest.mark.parametrize("d", [1, 4, 8, 16, 64, 100, 128, 200, 256])
def test_plan_fits_the_card(d, elem):
    """Every width the kernel takes has a plan within an H100's 232 448
    bytes of shared memory a block, its threads covering the product
    chunks and W's rows."""
    for b in (1, 3, 256, 4096):
        p = dc.dense_plan(b, d, elem)
        assert p is not None and p["smem"] <= 232448
        assert p["cs"] in (1, 2, 4, 8) and p["rows"] * p["cs"] >= d
        assert p["rc"] <= dc.MAX_RC and p["rc"] % dc.RM[elem] == 0
        assert (p["dp"] * elem) % 128 == 32 and p["dp"] >= d
        assert 1 <= p["tpr"] <= 32 and p["tpr"] * p["rows"] <= dc.THREADS
        assert 1 <= p["clusters"] <= b
        assert p["scratch"] == p["clusters"] * dc.N_BUF * d * d
        # the smallest cluster that fits
        if p["cs"] > 1:
            assert dc._layout(d, elem, p["cs"] // 2)["smem"] > 232448


@pytest.mark.parametrize("elem", [4, 8])
@pytest.mark.parametrize("d", [128, 256])
@pytest.mark.parametrize("b", [256, 4096])
def test_plan_fills_the_card(b, d, elem):
    """At the generic path's 4096 and the JAX record's 256, at least one
    block an SM (132), and at D = 128 in f32 two a SM without a cluster."""
    p = dc.dense_plan(b, d, elem)
    assert p["blocks"] >= 132
    if (d, elem) == (128, 4):
        assert p["cs"] == 1 and p["per_sm"] == 2 and p["smem"] < 116 * 1024
        assert p["clusters"] == min(b, 264)
    if (d, elem) == (128, 8):
        assert p["cs"] == 1
    if d == 256:
        assert p["cs"] == (2 if elem == 4 else 4)


# -- K9's bound by the least work --------------------------------------------

def test_k9_bound_counts_the_least_work():
    """Per trajectory and exponent: its formation (n_nodes D^2), two
    products per commutator term, and the least of the formed route (5 + s
    products and a matrix-vector product) and 2^s m actions. D = 4, m = 12:
    products of 128, actions of 32."""
    table = ChainTable(2, [[Exponent((0.5, 0.5), ((0, 1, 0.1),)),
                            Exponent((0.0, 0.0))],
                           [Exponent((1.0, 0.0))]])
    counts = [torch.tensor([0, 3]), torch.tensor([0, 0]),
              torch.tensor([2, 2])]
    flop, nbytes = chip_smoke.k9_flop_bytes(table, counts, 2, 4, 4, m=12)
    # the commutator's exponent: s = 0 by actions (12 x 32), s = 3 formed
    # (8 x 128 + 32); formation 2 x 16 and the commutator 2 x 128, per row
    first = 384 + 1056 + 2 * (32 + 256)
    zero = 2 * 384 + 2 * 32          # the zero exponent: 12 actions a row
    third = 2 * 928 + 2 * 32         # s = 2 formed (7 x 128 + 32)
    assert flop == first + zero + third == 4768
    assert nbytes == 4 * (2 * 2 * 16 + 2 * 2 * 4 + 2 * 2)
    assert chip_smoke.k9_routes(table, counts, 12, 4) == (3, 3)

"""The chain step over 3 to 8 basis terms (K' up to 36 working terms with
the Magnus commutators) on the CPU: the port's step twin
(``ops/expmv.torch_chain_step``, under every modulated stepper's
``make_step_fn``) against the JAX package's step in its XLA tier and in
its Pallas kernel in interpret mode (``chain_expmv_pallas``), on every
recipe, in f64 on the same numpy inputs; and the parameter layout the
kernels read (``chain_params``: 36 norms, 8 forms, the Chebyshev header)
against ``csrc/chain_step.cuh``'s offsets. The kernels K4 and K5 against
this twin on a card: tests/test_torch_cuda.py."""

import functools
import math
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vec_ode_tpu import exp as vexp
from vec_ode_tpu import tableaus as jtb
from vec_ode_tpu.models import DrivenDense as JDrivenDense
from vec_ode_tpu.ops import cplx as jcp
from vec_ode_tpu_torch import exp as texp
from vec_ode_tpu_torch import tableaus as ttb
from vec_ode_tpu_torch.ops import cplx as tcp
from vec_ode_tpu_torch.ops import expmv

jax.config.update("jax_enable_x64", True)
torch.set_num_threads(1)

B = 6
BLANES_ERR = ((0.0, 1.0, 0.0),)
KINDS = ("midpoint", "magnus4", "magnus4_fast", "magnus6", "magnus6_fixed",
         "cfm4", "blanes")


def _coeffs(xp, t, K0):
    """[1, t, cos 2 pi t, sin 2 pi t, cos 4 pi t, sin 4 pi t, cos 6 pi t,
    sin 6 pi t][:K0] as (..., K0)."""
    cols = [xp.ones_like(t), t]
    for n in (1, 2, 3):
        a = (2.0 * math.pi * n) * t
        cols += [xp.cos(a), xp.sin(a)]
    return xp.stack(cols[:K0], -1)


@functools.cache
def _basis(K0, d):
    """-i H_k as (Im H, -Re H): DrivenDense(d, 0)'s H0 and DrivenDense(d,
    s)'s V, s = 1 .. K0 - 1."""
    H = np.stack([JDrivenDense.make(d=d, seed=0).H0] + [
        JDrivenDense.make(d=d, seed=s).V for s in range(1, K0)])
    return H.imag, -H.real


def _ops(K0, d):
    re, im = _basis(K0, d)
    jop = vexp.ModulatedOperator(
        basis=jcp.Cplx(jnp.asarray(re), jnp.asarray(im)),
        coeff_fn=lambda t: _coeffs(jnp, jnp.asarray(t), K0))
    top = texp.ModulatedOperator(
        basis=tcp.Cplx(torch.as_tensor(re), torch.as_tensor(im)),
        coeff_fn=lambda t: _coeffs(torch, t, K0))
    return jop, top


def _stepper(pkg, kind, op, **kw):
    if kind == "midpoint":
        return pkg.MidpointModulated(op, **kw)
    if kind.startswith("magnus4"):
        return pkg.MagnusModulated4(op, fast_error=kind == "magnus4_fast",
                                    **kw)
    if kind.startswith("magnus6"):
        return pkg.MagnusModulated6(op, adaptive=kind == "magnus6", **kw)
    if kind == "cfm4":
        return pkg.CFM4Modulated(op, **kw)
    tab = jtb if pkg is vexp else ttb
    return pkg.CFMModulated(
        op, alpha=tuple(map(tuple, tab.BLANES17_R4_J4)),
        c=tuple(tab.C_GAUSS_LEGENDRE_6), alpha_err=BLANES_ERR, **kw)


def _jax_step(stepper, inputs, backend=None):
    """The JAX stepper's step; ``backend="tpu"`` builds its Pallas branch
    (interpret mode) by stubbing the backend while the step is made."""
    orig = jax.default_backend
    try:
        if backend is not None:
            jax.default_backend = lambda: backend
        step = stepper.make_step_fn()
    finally:
        jax.default_backend = orig
    z, t, dt = inputs
    return step(jnp.asarray(t), jcp.from_complex(z, jnp.float64),
                jnp.asarray(dt))


def _inputs(d, seed=5, dt_range=(0.05, 0.2)):
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((B, d)) + 1j * rng.standard_normal((B, d))
    return z, rng.uniform(0.0, 1.0, B), rng.uniform(*dt_range, B)


def _check(kind, K0, d, tier):
    jop, top = _ops(K0, d)
    inputs = _inputs(d)
    if tier == "xla":
        jy, je = _jax_step(_stepper(vexp, kind, jop, use_pallas=False),
                           inputs)
    else:
        jy, je = _jax_step(_stepper(vexp, kind, jop, interpret=True),
                           inputs, backend="tpu")
    z, t, dt = inputs
    st = _stepper(texp, kind, top)
    assert st._basis_w.shape[0] == expmv.n_working_terms(st._recipe, K0)
    y, e = st.make_step_fn()(torch.as_tensor(t),
                             tcp.from_complex(z, torch.float64,
                                              device="cpu"),
                             torch.as_tensor(dt))
    want = np.concatenate([np.asarray(jy.re), np.asarray(jy.im)], -1)
    got = torch.cat([y.re, y.im], -1).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-13 * np.abs(want).max())
    assert (e is None) == (je is None)
    if je is not None:
        np.testing.assert_allclose(e.numpy(), np.asarray(je), rtol=1e-9,
                                   atol=1e-18)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("K0", [3, 5, 8])
def test_step_matches_jax_xla_step(K0, kind):
    """Every recipe at 3, 5 and 8 terms against the JAX XLA step (d = 4):
    states to 1e-13 of their scale, the error (a cancelling sum) to rtol
    1e-9 (ROADMAP queue 3)."""
    _check(kind, K0, 4, "xla")


@pytest.mark.parametrize("kind,K0", [("magnus4", 3), ("magnus4", 5),
                                     ("magnus4", 8), ("magnus4_fast", 8),
                                     ("magnus6", 8), ("magnus6_fixed", 3),
                                     ("cfm4", 8), ("blanes", 5),
                                     ("midpoint", 8)])
def test_step_matches_pallas_interpret(kind, K0):
    """The JAX Pallas step kernel (chain_expmv_pallas) in interpret mode,
    unpacked (d = 64, a widened width of 128), every recipe, over K' up
    to 36: the same limits."""
    _check(kind, K0, 64, "pallas")


def test_pairs_and_rows_follow_jax_order():
    """The commutator pairs in the JAX package's order (j < k, j outer),
    and the Magnus-4 row's commutator weights on them."""
    assert expmv.pairs_of(4) == [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3),
                                 (2, 3)]
    assert expmv.n_working_terms("magnus4", 8) == expmv.MAX_KP == 36
    assert expmv.n_working_terms("cfm", 8) == 8
    rng = np.random.default_rng(0)
    g1, g2 = (torch.as_tensor(rng.standard_normal((3, 5))) for _ in range(2))
    dt = torch.as_tensor(rng.uniform(0.1, 0.2, 3))
    rows = expmv.chain_rows("magnus4", [g1, g2], dt, 1)[:, 0, 0]
    assert rows.shape == (3, 15)
    for i, (j, k) in enumerate(expmv.pairs_of(5)):
        want = (expmv._B2 * dt * dt) * (g1[:, j] * g2[:, k]
                                         - g1[:, k] * g2[:, j])
        assert torch.equal(rows[:, 5 + i], want)


def _header_offsets() -> dict:
    """The P_* offsets and limits of csrc/chain_step.cuh, evaluated."""
    src = (pathlib.Path(expmv.__file__).parents[1] / "csrc"
           / "chain_step.cuh").read_text()
    env = {}
    for name in ("MAX_K0", "MAX_KP", "MAX_R", "MAX_NODES"):
        env[name] = int(re.search(rf"constexpr int {name} = (\d+);",
                                  src).group(1))
    decl = re.search(r"constexpr int (P_NORMS[^;]*);", src).group(1)
    for part in decl.split(","):
        name, expr = (s.strip() for s in part.split("="))
        env[name] = eval(expr, {}, env)
    return env


def test_parameter_layout_matches_the_kernels():
    """chain_params' offsets are the header's; 36 norms, 8 CoeffForm terms
    and a ChebForm's header round-trip through the array."""
    env = _header_offsets()
    assert env["MAX_K0"] == expmv.MAX_K0 and env["MAX_KP"] == expmv.MAX_KP
    for name in ("NORMS", "SUB", "NODES", "ALPHA", "ALPHA_ERR", "FORM"):
        assert env[f"P_{name}"] == getattr(expmv, f"_P_{name}"), name
    norms = [1.0 + 0.5 * k for k in range(36)]
    form = expmv.CoeffForm(a=tuple(range(8)), b=tuple(range(8, 16)),
                           c=tuple(range(16, 24)), w=tuple(range(24, 32)))
    vals = list(expmv.chain_params("magnus4", 2, 8, 36, 8, 0.35, 16, norms,
                                   form=form))
    assert len(vals) == expmv._P_LEN
    assert vals[:4] == [8, 36, expmv.RECIPES["magnus4"], 2]
    assert vals[12:16] == [expmv.FORMS["coeff"], 0, 0, 0]
    assert vals[expmv._P_NORMS:expmv._P_NORMS + 36] == norms
    assert vals[expmv._P_FORM:expmv._P_FORM + 32] == form.kernel_array()
    cheb = expmv.ChebForm(np.arange(12.0).reshape(4, 3), -20.0, 12.0)
    vals = list(expmv.chain_params("magnus4", 2, 3, 6, 8, 0.35, 16,
                                   norms[:6], form=cheb))
    assert vals[12:16] == [expmv.FORMS["cheb"], 4, -8.0, 1.0 / 32.0]
    assert vals[expmv._P_FORM:expmv._P_FORM + 32] == [0.0] * 32
    table = cheb.kernel_table(torch.float32, "cpu")
    assert table.shape == (3, 4) and table.is_contiguous()
    assert table[1].tolist() == [1.0, 4.0, 7.0, 10.0]


def test_cheb_form_is_the_clenshaw_sum():
    """ChebForm.sample is numpy's chebval of the series on the mapped
    time, to rounding."""
    rng = np.random.default_rng(2)
    series = rng.standard_normal((9, 4))
    form = expmv.ChebForm(series, -1.5, 2.5)
    t = np.linspace(-1.5, 2.5, 17)
    want = np.polynomial.chebyshev.chebval((2 * t - 1.0) / 4.0, series).T
    got = form.sample(torch.as_tensor(t)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-13)


def _gemm_constants() -> dict:
    """The constexpr ints of csrc/gemm_tile.cuh."""
    src = (pathlib.Path(expmv.__file__).parents[1] / "csrc"
           / "gemm_tile.cuh").read_text()
    out = {}
    for decl in re.findall(r"constexpr int (GEMM_[^;]*);", src):
        for part in decl.split(","):
            name, value = (v.strip() for v in part.split("="))
            out[name] = int(value)
    return out


# every recipe shape the kernels take, at its largest row count: (recipe,
# C, table)
_WIDEST_TABLE = expmv.CfmTable(alpha=np.ones((4, 8)), c=np.linspace(0, 1, 8),
                               alpha_err=np.ones((4, 8)))
_SHAPES = (("midpoint", 1, None), ("magnus4", 1, None), ("magnus4", 2, None),
           ("magnus4_fast", 1, None), ("magnus6", 1, None),
           ("magnus6", 2, None), ("cfm", 2, _WIDEST_TABLE))


def test_gemm_plan_matches_the_kernel_and_fits():
    """K4's tiled route: expmv's mirror of the launch plan reads
    gemm_tile.cuh's constants, and for every (type, D, K0, recipe) the
    wrapper accepts, the tile it picks at any batch runs at most
    GEMM_THREADS threads in at most 227 KB of shared memory, with whole
    rows per thread (the f32 tile at the path's 16384 x 128: 64 rows)."""
    env = _gemm_constants()
    for name in ("GEMM_THREADS", "GEMM_CN", "GEMM_PANEL_BYTES",
                 "GEMM_STAGES", "GEMM_MAX_JC"):
        assert env[name] == getattr(expmv, name), name
    assert expmv.GEMM_RM == {4: env["GEMM_RM_F32"], 8: env["GEMM_RM_F64"]}
    src = (pathlib.Path(expmv.__file__).parents[1] / "csrc"
           / "chain_expmv.cu").read_text()
    assert "ChainLayout<T>(tile, D, D, p, false, true).total > max_smem" in src
    assert expmv.gemm_tile(16384, 128, 4, "magnus4", 2, 8) == 64
    assert expmv.gemm_tile(16384, 128, 8, "magnus4", 2, 8) == 32
    for elem in (4, 8):
        rm = expmv.GEMM_RM[elem]
        for D in range(1, expmv.MAX_WIDTH + 1):
            ncg = expmv.gemm_dp(D) // expmv.GEMM_CN
            for K0 in range(1, expmv.MAX_K0 + 1):
                for recipe, C, table in _SHAPES:
                    for Bn in (1, 1 << 20):
                        tile = expmv.gemm_tile(Bn, D, elem, recipe, C, K0,
                                               table)
                        smem = expmv.chain_smem_bytes(tile, D, D, elem,
                                                      recipe, C, K0, table)
                        assert tile >= rm and tile % rm == 0, (D, K0)
                        assert (tile // rm) * ncg <= expmv.GEMM_THREADS
                        assert smem <= 232448, (elem, D, K0, recipe, smem)

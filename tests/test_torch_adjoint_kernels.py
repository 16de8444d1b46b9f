"""The plain twins of the adjoint kernels (vec_ode_tpu_torch/ops/adjoint.py:
K6 one reverse row, K7 the fixed-step forward sweep, K8 the reverse sweep)
against the JAX package on the same numpy inputs: its Pallas kernels in
interpret mode (f32, D = 128, B = 8, tile 8, at the tolerances of
tests/test_adjoint.py) and its XLA composition (f64, rtol 1e-10), and the
scaling count per row. The twins are what the kernels compute; the CUDA
kernels are held against them on a card (tests/test_torch_cuda.py)."""

import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vec_ode_tpu import diff as jdiff
from vec_ode_tpu.ops.pallas_expmv import (adjoint_bwd_pallas,
                                          adjoint_sweep_bwd_pallas,
                                          adjoint_sweep_fwd_pallas)
from vec_ode_tpu_torch.exp.modulated import modulated_exp_apply
from vec_ode_tpu_torch.ops import adjoint as tadj
from vec_ode_tpu_torch.ops.expmv import (basis_norms, scale_rows,
                                         stacked_basis, stacked_transpose)

jax.config.update("jax_enable_x64", True)


def _operands(W):
    return stacked_transpose(W), stacked_basis(W), basis_norms(W)


def _pallas_inputs(seed, B=8, D=128, Kp=3, R=5, scale=0.4):
    """The inputs of tests/test_adjoint.py's kernel checks (f32)."""
    rng = np.random.default_rng(seed)
    W = (rng.standard_normal((Kp, D, D)) / np.sqrt(D)).astype(np.float32)
    c = (rng.standard_normal((B, Kp)) * scale).astype(np.float32)
    c_all = (rng.standard_normal((R, Kp)) * 0.3).astype(np.float32)
    x = rng.standard_normal((B, D)).astype(np.float32)
    a = rng.standard_normal((B, D)).astype(np.float32)
    return W, c, c_all, x, a


def _t(a, dtype=torch.float32):
    return torch.tensor(np.asarray(a), dtype=dtype)


def test_row_twin_matches_pallas_interpret():
    """K6's twin against adjoint_bwd_pallas (per-lane rows past theta: the
    kernel takes one count per tile, the twin one per lane, which differs
    by truncation below f32 rounding); measured max |dx_n|, |da_n| ~1e-6,
    |dcbar| ~1e-5 against the test_adjoint.py tolerances 2e-5 / 2e-4."""
    W, c, _, x, a = _pallas_inputs(21)
    xk, ak, cbk = adjoint_bwd_pallas(jnp.asarray(c), jnp.asarray(x),
                                     jnp.asarray(a), jnp.asarray(W), m=8,
                                     theta=0.25, tile=8, interpret=True)
    mt, ms, norms = _operands(_t(W))
    xn, an, cb = tadj.torch_adjoint_row(_t(c), _t(x), _t(a), mt, ms, norms,
                                        m=8, theta=0.25)
    np.testing.assert_allclose(xn.numpy(), np.asarray(xk), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(an.numpy(), np.asarray(ak), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(cb.numpy(), np.asarray(cbk), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("Kp", [1, 2, 3, 4, 5, 6])
def test_sweep_twins_match_pallas_interpret(Kp):
    """K7's and K8's twins against the persistent sweep kernels (rows
    counted per row in the twins, over all rows in the kernels; K7's twin
    forms each row's exponent once, the kernel sums K' actions a term).
    The shared rows are scaled by 3 / K', so that their 1-norm bound, and
    with it the passes and the growth of the states over this non-normal
    basis, stays at K' = 3's (the inputs of K' = 3 are the unparametrised
    test's): measured <= 2.3e-5 for y (the sum-of-actions twin the same),
    ~1e-6 for a0, ~1e-5 for cbar against 3e-5 / 3e-4."""
    W, _, c_all, x, a = _pallas_inputs(23, Kp=Kp, scale=0.3)
    c_all = c_all * np.float32(3.0 / Kp)
    yk = adjoint_sweep_fwd_pallas(jnp.asarray(c_all), jnp.asarray(x),
                                  jnp.asarray(W), m=8, theta=0.25, tile=8,
                                  interpret=True)
    a0k, cbk = adjoint_sweep_bwd_pallas(jnp.asarray(c_all), yk,
                                        jnp.asarray(a), jnp.asarray(W), m=8,
                                        theta=0.25, tile=8, interpret=True)
    mt, ms, norms = _operands(_t(W))
    y = tadj.torch_adjoint_sweep_fwd(_t(c_all), _t(x), mt, norms, m=8,
                                     theta=0.25)
    np.testing.assert_allclose(y.numpy(), np.asarray(yk), rtol=3e-5,
                               atol=3e-5)
    a0, cb = tadj.torch_adjoint_sweep_bwd(_t(c_all), _t(np.asarray(yk)),
                                          _t(a), mt, ms, norms, m=8,
                                          theta=0.25)
    np.testing.assert_allclose(a0.numpy(), np.asarray(a0k), rtol=3e-5,
                               atol=3e-5)
    np.testing.assert_allclose(cb.numpy(), np.asarray(jnp.sum(cbk, 0)),
                               rtol=3e-4, atol=3e-4)


def _xla_core(W):
    """The JAX package's adjoint core over the real basis W (no commutator
    extension) on its XLA path."""
    return jdiff._adjoint_core(jnp.asarray(W), lambda t, th: None, order=2,
                               m=None, max_squarings=16, use_pallas=False)


def _f64_inputs(seed, B=5, D=6, Kp=3, R=4, scale=1.5, antisym=False):
    rng = np.random.default_rng(seed)
    W = rng.standard_normal((Kp, D, D)) / np.sqrt(D)
    if antisym:  # norm-preserving: the reconstruction is well conditioned
        W = W - np.swapaxes(W, -1, -2)
    c = rng.standard_normal((B, Kp)) * scale
    c_all = rng.standard_normal((R, Kp)) * scale
    x = rng.standard_normal((B, D))
    a = rng.standard_normal((B, D))
    return W, c, c_all, x, a


@pytest.mark.parametrize("Kp", [2, 6])
def test_row_twin_matches_xla_composition_f64(Kp):
    """K6's twin against diff._bwd_row on the XLA path (the (2D)-wide
    augmented embedding, one count per batch and a transposed basis) with
    rows past theta: the same function up to truncation below f64
    rounding; measured <= 4e-15 relative, held to rtol 1e-10."""
    W, c, _, x, a = _f64_inputs(31 + Kp, Kp=Kp)
    core = _xla_core(W)
    xr, ar, cr = jdiff._bwd_row(core, jnp.asarray(c), jnp.asarray(x),
                                jnp.asarray(a), reduce=False)
    mt, ms, norms = _operands(_t(W, torch.float64))
    xn, an, cb = tadj.torch_adjoint_row(
        _t(c, torch.float64), _t(x, torch.float64), _t(a, torch.float64),
        mt, ms, norms, m=12, theta=0.25)
    for got, ref in ((xn, xr), (an, ar), (cb, cr)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-10,
                                   atol=1e-12)


@pytest.mark.parametrize("Kp", [1, 2, 3, 4, 5, 6])
def test_sweep_twins_match_xla_composition_f64(Kp):
    """K7's and K8's twins against diff._rows_forward / _rows_backward on
    the XLA path (a scan of per-row actions), over a norm-preserving basis
    (a non-normal one amplifies the rounding of the reconstruction by
    e^{sum |A|}, in both packages alike); measured <= 3e-15 relative, held
    to rtol 1e-10."""
    W, _, c_all, x, a = _f64_inputs(41, Kp=Kp, R=6, antisym=True)
    core = _xla_core(W)
    yr = jdiff._rows_forward(core, jnp.asarray(c_all), jnp.asarray(x))
    a0r, cbr = jdiff._rows_backward(core, jnp.asarray(c_all), yr,
                                    jnp.asarray(a))
    mt, ms, norms = _operands(_t(W, torch.float64))
    ca = _t(c_all, torch.float64)
    y = tadj.torch_adjoint_sweep_fwd(ca, _t(x, torch.float64), mt, norms,
                                     m=12, theta=0.25)
    a0, cb = tadj.torch_adjoint_sweep_bwd(ca, y, _t(a, torch.float64), mt,
                                          ms, norms, m=12, theta=0.25)
    for got, ref in ((y, yr), (a0, a0r), (cb, cbr)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-10,
                                   atol=1e-12)


@pytest.mark.parametrize("Kp", [4, 5, 6])
def test_sweep_fwd_twin_matches_xla_at_the_unscaled_pallas_rows_f64(Kp):
    """K7's twin, which forms each row's exponent, against
    diff._rows_forward on the XLA path (a scan of per-row sums of K'
    actions) in f64 on test_sweep_twins_match_pallas_interpret's inputs
    without its 3 / K' scaling of the rows (non-normal basis, D = 128, up
    to 128 passes a row): measured <= 6e-16 relative to the largest entry,
    held to rtol 1e-10."""
    W, _, c_all, x, _ = _pallas_inputs(23, Kp=Kp, scale=0.3)
    W, c_all, x = (np.asarray(v, np.float64) for v in (W, c_all, x))
    yr = jdiff._rows_forward(_xla_core(W), jnp.asarray(c_all),
                             jnp.asarray(x))
    mt, _, norms = _operands(_t(W, torch.float64))
    ca = _t(c_all, torch.float64)
    assert int(scale_rows(ca[:, None], norms, 0.25, 16)[1].max()) >= 64
    y = tadj.torch_adjoint_sweep_fwd(ca, _t(x, torch.float64), mt, norms,
                                     m=12, theta=0.25)
    np.testing.assert_allclose(y.numpy(), np.asarray(yr), rtol=1e-10,
                               atol=1e-12)


def test_scaling_count_per_row_is_scale_rows():
    """One squaring count per lane and row, the port's rule: on rows past
    theta with counts that differ between lanes, the twin's reconstruction
    and transport are bitwise the per-trajectory action
    ``modulated_exp_apply`` (which counts by ``scale_rows``) of -c on W and
    of c on W^T (an antisymmetric basis, so that ||W^T||_1 = ||W||_1);
    the sweep's forward, which forms each shared row's exponent once, is
    bitwise R Taylor chains over sum_k (c_k / 2^s) W_k with scale_rows'
    counts, and R such actions to rounding (held to 1e-14)."""
    rng = np.random.default_rng(5)
    D, Kp, B = 6, 2, 6
    S = rng.standard_normal((Kp, D, D))
    W = _t(S - np.swapaxes(S, -1, -2), torch.float64)
    c = _t(rng.standard_normal((B, Kp)) * np.array([0.002, 0.02, 0.1, 0.5, 1,
                                                    2])[:, None],
           torch.float64)
    x = _t(rng.standard_normal((B, D)), torch.float64)
    a = _t(rng.standard_normal((B, D)), torch.float64)
    mt, ms, norms = _operands(W)
    _, n_pass = scale_rows(c[:, None], norms, 0.25, 16)
    assert int(n_pass.min()) == 1 and int(n_pass.max()) >= 32
    assert len(set(n_pass.flatten().tolist())) >= 4
    xn, an, _ = tadj.torch_adjoint_row(c, x, a, mt, ms, norms, m=12,
                                       theta=0.25)
    assert torch.equal(xn, modulated_exp_apply(W, -c, x))
    assert torch.equal(an, modulated_exp_apply(W.transpose(-1, -2), c, a))
    c_all = c[2:5]
    y = tadj.torch_adjoint_sweep_fwd(c_all, x, mt, norms, m=12, theta=0.25)
    ref, chain = x, x
    for r in range(c_all.shape[0]):
        ref = modulated_exp_apply(W, c_all[r].expand(B, Kp), ref)
        cs_r, n_r = scale_rows(c_all[r], norms, 0.25, 16)
        A = (cs_r[0] * W[0]).T + (cs_r[1] * W[1]).T
        for _ in range(int(n_r)):
            acc = term = chain
            for j in range(1, 13):
                term = (term @ A) / j
                acc = acc + term
            chain = acc
    assert torch.equal(y, chain)
    assert int(scale_rows(c_all, norms, 0.25, 16)[1].max()) > 1
    torch.testing.assert_close(y, ref, rtol=1e-14, atol=1e-14)


def test_wrappers_run_the_twins_on_cpu_tensors():
    """On CPU tensors the wrappers are the twins and count no launch."""
    W, c, c_all, x, a = _f64_inputs(51)
    W, c, c_all, x, a = (_t(v, torch.float64) for v in (W, c, c_all, x, a))
    mt, ms, norms = _operands(W)
    kw = dict(m=12, theta=0.25)
    before = (tadj.adjoint_bwd.launches, tadj.adjoint_sweep_fwd.launches,
              tadj.adjoint_sweep_bwd.launches)
    for got, ref in (
            (tadj.adjoint_bwd(c, x, a, mt, ms, norms, **kw),
             tadj.torch_adjoint_row(c, x, a, mt, ms, norms, **kw)),
            ((tadj.adjoint_sweep_fwd(c_all, x, mt, norms, **kw),),
             (tadj.torch_adjoint_sweep_fwd(c_all, x, mt, norms, **kw),)),
            (tadj.adjoint_sweep_bwd(c_all, x, a, mt, ms, norms, **kw),
             tadj.torch_adjoint_sweep_bwd(c_all, x, a, mt, ms, norms,
                                          **kw))):
        for g, r in zip(got, ref):
            assert torch.equal(g, r)
    assert (tadj.adjoint_bwd.launches, tadj.adjoint_sweep_fwd.launches,
            tadj.adjoint_sweep_bwd.launches) == before


def test_nan_state_stays_in_its_row():
    """A non-finite state in one trajectory reaches only its own row of
    x_n and a_n (a NaN row of c gives s = 0 and NaN in that lane only)."""
    W, c, _, x, a = _f64_inputs(61)
    W, c, x, a = (_t(v, torch.float64) for v in (W, c, x, a))
    x[1, 2] = float("nan")
    c[3, 0] = float("nan")
    mt, ms, norms = _operands(W)
    xn, an, cb = tadj.torch_adjoint_row(c, x, a, mt, ms, norms, m=12,
                                        theta=0.25)
    bad = torch.zeros(x.shape[0], dtype=torch.bool)
    bad[[1, 3]] = True
    assert bool(torch.isnan(xn[1]).all()) and bool(torch.isnan(xn[3]).all())
    assert bool(torch.isfinite(xn[~bad]).all())
    assert bool(torch.isfinite(an[~bad]).all())
    assert bool(torch.isfinite(cb[~bad]).all())


def test_sweep_plan_matches_the_kernel_and_fits():
    """K7's launch plan: ops/adjoint.py's mirror reads csrc/adjoint.cu's
    constants, and every (type, D, K') the wrapper accepts has a shape at
    every batch, its threads within GEMM_THREADS plus the producer warps,
    its shared memory within 227 KB (K' does not enter it: the exponent is
    formed, never the K' actions). The plans by shape: both exponents in
    f32 at D = 128 (2 trajectories a block at B = 256, 32 at 4096), one in
    f64 at D = 128, panels at D = 512."""
    src = (pathlib.Path(tadj.__file__).parents[1] / "csrc"
           / "adjoint.cu").read_text()
    consts = dict(re.findall(r"constexpr int (SWEEP_\w+) = (\d+);", src))
    assert int(consts["SWEEP_PRODUCER_WARPS"]) == tadj.SWEEP_PRODUCER_WARPS
    assert int(consts["SWEEP_MAX_TILE"]) == tadj.SWEEP_MAX_TILE
    plans = re.search(r"constexpr int SWEEP_DOUBLE = (\d+), SWEEP_SINGLE = "
                      r"(\d+), SWEEP_PANEL = (\d+);", src).groups()
    assert [int(v) for v in plans] == [0, 1, 2]
    assert tadj.SWEEP_PLANS == ("double", "single", "panel")
    want = {(256, 128, 4): ("double", 2), (4096, 128, 4): ("double", 32),
            (256, 128, 8): ("single", 2), (5, 512, 4): ("panel", 1),
            (5, 512, 8): ("panel", 1)}
    for (Bn, D, elem), (plan, tile) in want.items():
        got = tadj.sweep_plan(Bn, D, elem)
        assert (got["plan"], got["tile"]) == (plan, tile), (Bn, D, got)
    for elem in (4, 8):
        for D in range(1, tadj.MAX_WIDTH + 1):
            for Bn in (1, 256, 1 << 20):
                got = tadj.sweep_plan(Bn, D, elem)
                assert got is not None, (elem, D, Bn)
                assert got["smem"] <= 232448, (elem, D, got)
                assert got["threads"] <= tadj.GEMM_THREADS + 32 * \
                    tadj.SWEEP_PRODUCER_WARPS

"""The modulated exponential path of the port (exp/modulated.py,
ops/expmv.py) on the CPU: the operator, its declared coefficient forms,
the chain action and the Magnus-4 / midpoint steps against the JAX
package (``vec_ode_tpu.exp.modulated``) on the same numpy inputs, in f64
against its XLA step and in f32 against its Pallas step kernel in
interpret mode. The kernel K4 against the twin on a card:
tests/test_torch_cuda.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

from vec_ode_tpu import exp as vexp
from vec_ode_tpu import lc as jlc
from vec_ode_tpu.exp import magnus as jmagnus
from vec_ode_tpu.exp import modulated as jmodulated
from vec_ode_tpu.models import DrivenDense as JDrivenDense
from vec_ode_tpu.models import LandauZener as JLandauZener
from vec_ode_tpu.ops import cplx as jcp
from vec_ode_tpu_torch import convert, lc
from vec_ode_tpu_torch import exp as texp
from vec_ode_tpu_torch.exp import modulated as tmodulated
from vec_ode_tpu_torch.models import DrivenDense, LandauZener
from vec_ode_tpu_torch.ops import cplx as tcp
from vec_ode_tpu_torch.ops import expmv

torch.set_num_threads(1)

B, D = 16, 64
WEIGHTS = tuple(np.linspace(0.5, 2.0, D))


def _models(dtype):
    """(JAX operator, port operator) of DrivenDense(d=64, seed 0)."""
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    return (JDrivenDense.make(d=D, seed=0).modulated(jdt),
            DrivenDense.make(d=D, seed=0).modulated(dtype, device="cpu"))


def _step_inputs(dtype, seed=5):
    """States, t in [0, 1) and dt in [0.05, 0.15): steps long enough that
    every row's Magnus-4 error (a difference of two chains of the state's
    size) is above 1e-6 of the state, so its f64 rounding stays within
    1e-9 of it, and long enough to take squarings."""
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((B, D)) + 1j * rng.standard_normal((B, D))
    t = rng.uniform(0.0, 1.0, B)
    dt = rng.uniform(0.05, 0.15, B)
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    return ((jcp.from_complex(z, jdt), jnp.asarray(t, jdt),
             jnp.asarray(dt, jdt)),
            (tcp.from_complex(z, dtype, device="cpu"),
             torch.as_tensor(t, dtype=dtype), torch.as_tensor(dt, dtype=dtype)))


def _np(c):
    return np.concatenate([np.asarray(c.re), np.asarray(c.im)], axis=-1)


def test_constants_are_the_jax_packages():
    assert expmv._C_MID == jmagnus._C_MID and expmv._B2 == jmagnus._B2
    assert tmodulated._TAYLOR_CFG == jmodulated._TAYLOR_CFG
    for dtype, jdt in ((torch.float32, jnp.float32),
                       (torch.float64, jnp.float64)):
        for m in (None, 6, 10):
            assert (tmodulated._taylor_params(dtype, m)
                    == jmodulated._taylor_params(jdt, m))


def test_cmatmul_and_extract_match_jax():
    rng = np.random.default_rng(1)
    a, b = (rng.standard_normal((2, 8, 8)) + 1j * rng.standard_normal((2, 8, 8))
            for _ in range(2))
    j = jcp.cmatmul(jcp.from_complex(a[0]), jcp.from_complex(b[0]))
    t = tcp.cmatmul(tcp.from_complex(a[0], device="cpu"),
                    tcp.from_complex(b[0], device="cpu"))
    np.testing.assert_allclose(_np(t), _np(j), rtol=1e-14, atol=1e-14)
    M = tcp.embed(tcp.from_complex(a, device="cpu"))
    back = tcp.extract(M)
    assert torch.equal(back.re, torch.as_tensor(a.real))
    assert torch.equal(back.im, torch.as_tensor(a.imag))


@pytest.mark.parametrize("model", ["driven", "landau_zener"])
def test_commutator_extension_matches_jax(model):
    if model == "driven":
        jop, top = _models(torch.float64)
    else:
        jop = JLandauZener(v=2.0, delta=0.4).modulated(jnp.float64)
        top = LandauZener(v=2.0, delta=0.4).modulated(torch.float64,
                                                      device="cpu")
    jext, jpairs = jop.commutator_extension()
    text, tpairs = top.commutator_extension()
    assert tpairs == jpairs
    for part in ("re", "im"):
        want = np.asarray(getattr(jext, part))
        got = getattr(text, part).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-14,
                                   atol=1e-14 * np.abs(want).max())
    # the real-basis branch: the same commutators of the embedded basis
    real = texp.ModulatedOperator(tmodulated._real_basis(top.basis),
                                  top.coeff_fn)
    rext, _ = real.commutator_extension()
    np.testing.assert_allclose(rext.numpy(), tcp.embed(text).numpy(),
                               rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("model", ["driven", "landau_zener"])
def test_declared_forms_match_jax_coeff_cols(model, dtype):
    """The declared form gives the JAX package's ``coeff_cols`` bit for
    bit, except through the cosine: torch's and XLA's cos differ by one
    ulp on a few percent of f32 inputs (ROADMAP queue 3); there the
    argument w t is bitwise the JAX package's and the value is torch's
    cos of it, within one ulp of XLA's."""
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    if model == "driven":
        jop = JDrivenDense.make(d=D, seed=0).modulated(jdt)
        top = DrivenDense.make(d=D, seed=0).modulated(dtype, device="cpu")
    else:
        jop = JLandauZener(v=2.0, delta=0.4).modulated(jdt)
        top = LandauZener(v=2.0, delta=0.4).modulated(dtype, device="cpu")
    t = np.random.default_rng(2).uniform(-25.0, 25.0, 4096)
    want = np.stack([np.asarray(c) for c in
                     jop.coeff_cols_fn(jnp.asarray(t, jdt))], axis=-1)
    tt = torch.as_tensor(t, dtype=dtype)
    got = top.form.sample(tt).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    # the coeff_fn of the port's operator is the declared form
    assert np.array_equal(top.coeff_fn(tt).numpy(), got)
    form = top.form
    for k in range(form.n_terms):
        if form.c[k] == 0.0:
            assert np.array_equal(got[:, k], want[:, k]), k
            continue
        arg = (form.w[k] * tt).numpy()
        assert np.array_equal(arg, np.asarray(form.w[k]
                                              * jnp.asarray(t, jdt)))
        assert np.array_equal(got[:, k], form.c[k] * torch.cos(
            torch.as_tensor(arg)).numpy())
        np.testing.assert_array_max_ulp(got[:, k], want[:, k], maxulp=1)


def test_modulated_exp_apply_matches_jax_and_expm():
    """e^{sum_k c_k M_k} x over the commutator-extended basis, with
    coefficients up to a 1-norm bound of ~3 (up to four squarings)."""
    jop, top = _models(torch.float64)
    jext, _ = jop.commutator_extension()
    basis_w = np.array(jcp.embed(jext))                        # (3, 128, 128)
    rng = np.random.default_rng(4)
    coeffs = rng.standard_normal((B, 3)) * np.logspace(-3, -0.3, B)[:, None]
    xw = rng.standard_normal((B, 2 * D))
    want = np.asarray(jmodulated.modulated_exp_apply(
        jnp.asarray(basis_w), jnp.asarray(coeffs), jnp.asarray(xw)))
    got = texp.modulated_exp_apply(torch.as_tensor(basis_w),
                                   torch.as_tensor(coeffs),
                                   torch.as_tensor(xw)).numpy()
    scale = np.abs(xw).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * scale)
    for b in range(B):
        ref = scipy.linalg.expm(np.einsum("k,kij->ij", coeffs[b],
                                          basis_w)) @ xw[b]
        np.testing.assert_allclose(got[b], ref, rtol=0, atol=1e-12 * scale)


def test_scale_rows_rule():
    """One squaring count per row: the least s with bound / theta <= 2^s,
    found exactly; 0 for a non-finite bound; capped at max_squarings; the
    JAX package's XLA rule on every finite row."""
    theta = 0.25
    norms = torch.tensor([1.0, 2.0], dtype=torch.float64)
    bounds = [0.1, theta, 8 * theta, 8 * theta * (1 + 2 ** -50), 5.0, 1e9,
              float("nan"), float("inf")]
    rows = torch.tensor([[[b, 0.0]] for b in bounds], dtype=torch.float64)
    cs, n_pass = expmv.scale_rows(rows, norms, theta, 16)
    assert n_pass[:, 0].tolist() == [1, 1, 8, 16, 32, 2 ** 16, 1, 1]
    assert torch.equal(cs[:6, 0, 0], rows[:6, 0, 0] / n_pass[:6, 0])
    rng = np.random.default_rng(9)
    c = rng.standard_normal((64, 2)) * np.logspace(-3, 1, 64)[:, None]
    _, n_pass = expmv.scale_rows(torch.as_tensor(c)[:, None], norms, theta,
                                 16)
    for b in range(64):
        _, want = jmodulated._scale_chains(jnp.asarray(c[b]), jnp.asarray(
            [1.0, 2.0]), jnp.float64, 16, theta)
        assert int(n_pass[b, 0]) == int(want)


def _jax_step(stepper, jin, backend=None):
    """The JAX stepper's step on (y, t, dt); ``backend="tpu"`` builds its
    Pallas branch (interpret mode) by stubbing the backend while the step
    is made, as the JAX package's own tests do."""
    orig = jax.default_backend
    try:
        if backend is not None:
            jax.default_backend = lambda: backend
        step = stepper.make_step_fn()
    finally:
        jax.default_backend = orig
    y, t, dt = jin
    return step(t, y, dt)


NORMS = {"pair": None, "fast_error": None,
         "weighted_l2": ("l2", WEIGHTS), "weighted_max": ("max", None)}


@pytest.mark.parametrize("case", list(NORMS))
def test_magnus4_step_matches_jax_xla_step_f64(case):
    jop, top = _models(torch.float64)
    jin, tin = _step_inputs(torch.float64)
    kw = {"fast_error": case == "fast_error"}
    jnorm = tnorm = None
    if NORMS[case] is not None:
        jnorm, tnorm = (jlc.WeightedNorm(*NORMS[case]),
                        lc.WeightedNorm(*NORMS[case]))
    jy, je = _jax_step(vexp.MagnusModulated4(jop, use_pallas=False,
                                             norm=jnorm, **kw), jin)
    # the port on the JAX package's extended basis, and on its own
    ext = np.asarray(vexp.MagnusModulated4(jop, use_pallas=False)
                     ._ext_basis_w)
    shared = convert.modulated_from_numpy(
        np.asarray(jop.basis.re), np.asarray(jop.basis.im), top.form,
        dtype=torch.float64, device="cpu", ext_basis_w=ext)
    for op in (shared, top):
        st = texp.MagnusModulated4(op, norm=tnorm, **kw)
        y, e = st.make_step_fn()(tin[1], tin[0], tin[2])
        np.testing.assert_allclose(_np(y), _np(jy), rtol=1e-12, atol=1e-15)
        # the error is a difference (or a leading term) near rounding in
        # its last digits: rtol 1e-9 (ROADMAP queue 3)
        np.testing.assert_allclose(e.numpy(), np.asarray(je), rtol=1e-9,
                                   atol=1e-18)


@pytest.mark.parametrize("case", ["pair", "fast_error"])
def test_magnus4_step_matches_pallas_interpret_f32(case):
    jop, top = _models(torch.float32)
    jin, tin = _step_inputs(torch.float32)
    kw = {"fast_error": case == "fast_error"}
    jy, je = _jax_step(vexp.MagnusModulated4(jop, interpret=True, **kw), jin,
                       backend="tpu")
    y, e = texp.MagnusModulated4(top, **kw).make_step_fn()(tin[1], tin[0],
                                                           tin[2])
    # the JAX package's own Pallas-vs-XLA tolerances
    # (tests/test_modulated.py:304-309)
    np.testing.assert_allclose(_np(y), _np(jy), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(e.numpy(), np.asarray(je), rtol=2e-3,
                               atol=2e-7)


def test_midpoint_step_matches_jax():
    for dtype in (torch.float64, torch.float32):
        jop, top = _models(dtype)
        jin, tin = _step_inputs(dtype, seed=6)
        y, e = texp.MidpointModulated(top).make_step_fn()(tin[1], tin[0],
                                                          tin[2])
        assert e is None
        if dtype == torch.float64:
            jy, je = _jax_step(vexp.MidpointModulated(jop, use_pallas=False),
                               jin)
            np.testing.assert_allclose(_np(y), _np(jy), rtol=1e-12,
                                       atol=1e-15)
        else:
            jy, je = _jax_step(vexp.MidpointModulated(jop, interpret=True),
                               jin, backend="tpu")
            np.testing.assert_allclose(_np(y), _np(jy), rtol=2e-5, atol=2e-5)
        assert je is None


def test_chain_step_edges():
    """A row whose dt is 0 returns x exactly; a NaN state gives a NaN error
    (the comparison chain's zero commutator columns are still
    multiplied); the wrapper on CPU tensors runs the twin and counts no
    launch; unknown recipes raise."""
    _, top = _models(torch.float64)
    st = texp.MagnusModulated4(top)
    _, tin = _step_inputs(torch.float64)
    x, t, dt = tin
    dt = dt.clone()
    dt[3] = 0.0
    x = tcp.Cplx(x.re.clone(), x.im.clone())
    x.re[5, 0] = float("nan")
    before = expmv.fused_chain_apply.launches
    y, e = st.make_step_fn()(t, x, dt)
    assert expmv.fused_chain_apply.launches == before
    assert torch.equal(y.re[3], x.re[3]) and torch.equal(y.im[3], x.im[3])
    assert bool(torch.isnan(e[5])) and bool(torch.isfinite(e[:5]).all())
    mt, norms = st._operands(torch.device("cpu"), torch.float64)
    xw = torch.cat([x.re, x.im], 1)
    with pytest.raises(ValueError, match="recipe"):
        expmv.fused_chain_apply([t[:, None]], dt, xw, mt, norms,
                                recipe="magnus8", C=1, m=12, theta=0.25)
    with pytest.raises(ValueError, match="C = 1"):
        expmv.fused_chain_apply([t[:, None]], dt, xw, mt, norms,
                                recipe="midpoint", C=2, m=12, theta=0.25)
    with pytest.raises(TypeError, match="TracedNorm"):  # not a norm
        texp.MagnusModulated4(top, norm=lambda e: e)
    assert dataclasses.replace(st, fast_error=True)._recipe == "magnus4_fast"

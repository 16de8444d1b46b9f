"""The fused RK step of the port (ops/fused_rk.py) against the JAX
package's: the plain torch twin against ``xla_rk_step`` in f64, and the
wrapper against the Pallas kernel in interpret mode in f32. The CUDA
kernel against the plain twin on a card: tests/test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vec_ode_tpu import tableaus as jtab
from vec_ode_tpu.models import DrivenDense as JDrivenDense
from vec_ode_tpu.ops.pallas_rk import FusedModulatedLinearRK as JStepper
from vec_ode_tpu.ops.pallas_rk import fused_rk_step as pallas_rk_step
from vec_ode_tpu.ops.pallas_rk import xla_rk_step
from vec_ode_tpu_torch import tableaus as ttab
from vec_ode_tpu_torch.models import DrivenDense
from vec_ode_tpu_torch.ops import _build
from vec_ode_tpu_torch.ops.cplx import Cplx
from vec_ode_tpu_torch.ops.fused_rk import (FusedModulatedLinearRK,
                                            fused_rk_step, torch_rk_step)
from vec_ode_tpu_torch.parallel import ensemble_solve

torch.set_num_threads(1)

TABS = ["rkf45", "dopri5", "bosh32"]


def _problem(B, d, dtype, seed=3):
    """Embedded operators (as the JAX stepper builds them) and step inputs
    made with numpy."""
    jst = JStepper.from_driven_dense(JDrivenDense.make(d=d, seed=0),
                                     jnp.float64)
    rng = np.random.default_rng(seed)
    xw = (rng.standard_normal((B, 2 * d)) * 0.1).astype(dtype)
    t = rng.uniform(0, 1, B).astype(dtype)
    dt = rng.uniform(1e-3, 5e-2, B).astype(dtype)
    return (np.asarray(jst.M0, dtype), np.asarray(jst.M1, dtype),
            float(JDrivenDense.make(d=d, seed=0).w), t, dt, xw)


def _torch(*arrays):
    return [torch.as_tensor(a) for a in arrays]


@pytest.mark.parametrize("advance_lower", [True, False])
@pytest.mark.parametrize("tab", TABS)
@pytest.mark.parametrize("d", [64, 5])
def test_torch_step_matches_xla_step_f64(d, tab, advance_lower):
    M0, M1, w, t, dt, xw = _problem(8, d, np.float64)
    jx, je = xla_rk_step(
        jnp.asarray(t), jnp.asarray(dt), jnp.asarray(xw), jnp.asarray(M0),
        jnp.asarray(M1), u_fn=lambda ti: jnp.cos(w * ti),
        tab=jtab.TABLEAUS[tab], advance_lower=advance_lower)
    tx, te = torch_rk_step(
        *_torch(t, dt, xw, M0, M1), u_fn=lambda ti: torch.cos(w * ti),
        tab=ttab.TABLEAUS[tab], advance_lower=advance_lower)
    # the same stage sums in the same order; only the matmul summation
    # order differs between the two BLAS back ends. The error vector is a
    # cancelling sum dt * sum_j db_j K_j: a rounding of ~1e-17 in K (of
    # size ~1) leaves ~1e-19 absolute in err, whatever err's own size
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=1e-9,
                               atol=1e-18)


def test_wrapper_matches_pallas_interpret_f32():
    B, d = 256, 64
    M0, M1, w, _, _, xw = _problem(B, d, np.float32)
    t = np.linspace(0.0, 0.5, B, dtype=np.float32)
    dt = np.full((B,), 0.02, np.float32)
    px, pe = pallas_rk_step(
        jnp.asarray(t), jnp.asarray(dt), jnp.asarray(xw), jnp.asarray(M0),
        jnp.asarray(M1), u_fn=lambda ti: jnp.cos(w * ti), tile=256,
        interpret=True)
    before = fused_rk_step.launches
    tx, te = fused_rk_step(*_torch(t, dt, xw, M0, M1), w=w)
    # CPU tensors run the plain twin: no kernel launch, nothing built
    assert fused_rk_step.launches == before
    assert "fused_rk_step" not in _build._loaded
    # tolerances of the JAX package's own interpret-vs-XLA test
    np.testing.assert_allclose(tx.numpy(), np.asarray(px), atol=2e-6)
    np.testing.assert_allclose(te.numpy(), np.asarray(pe), rtol=2e-3,
                               atol=1e-10)


def test_wrapper_on_cpu_is_the_plain_step():
    M0, M1, w, t, dt, xw = _problem(32, 64, np.float64)
    args = _torch(t, dt, xw, M0, M1)
    fx, fe = fused_rk_step(*args, w=w, tab=ttab.DOPRI5, advance_lower=False)
    px, pe = torch_rk_step(*args, u_fn=lambda ti: torch.cos(w * ti),
                           tab=ttab.DOPRI5, advance_lower=False)
    assert torch.equal(fx, px) and torch.equal(fe, pe)


def test_rk4_has_zero_error_and_the_adaptive_driver_raises():
    M0, M1, w, t, dt, xw = _problem(8, 5, np.float64)
    args = _torch(t, dt, xw, M0, M1)
    x_plain, err = torch_rk_step(*args, u_fn=lambda ti: torch.cos(w * ti),
                                 tab=ttab.RK4)
    assert err is None
    x_k, err_k = fused_rk_step(*args, w=w, tab=ttab.RK4)
    assert torch.equal(err_k, torch.zeros(8, dtype=torch.float64))
    assert torch.equal(x_k, x_plain)

    st = FusedModulatedLinearRK(M0=args[3], M1=args[4], w=w,
                                tableau=ttab.RK4)
    y0 = Cplx(args[2][:, :5], args[2][:, 5:])
    with pytest.raises(ValueError, match="error estimate"):
        ensemble_solve(None, y0, 0.0, 0.1, stepper=st, h0=1e-2)
    sol = ensemble_solve(None, y0, 0.0, 0.1, stepper=st, h0=1e-2,
                         adaptive=False)
    assert int(sol.n_accept.min()) == 10


@pytest.mark.parametrize("tab", ["rkf45", "dopri5", "rk4"])
def test_step_fn_on_cpu_is_the_plain_step(tab):
    """The stepper's step casts its f64 operators to the state's f32 once
    and runs the plain step on CPU tensors, step after step."""
    M0, M1, w, t, dt, xw = _problem(16, 5, np.float32)
    st = FusedModulatedLinearRK(M0=torch.as_tensor(M0, dtype=torch.float64),
                                M1=torch.as_tensor(M1, dtype=torch.float64),
                                w=w, tableau=ttab.TABLEAUS[tab])
    step = st.make_step_fn()
    t, dt, xw, M0, M1 = _torch(t, dt, xw, M0, M1)
    want_x, want_e = torch_rk_step(t, dt, xw, M0, M1,
                                   u_fn=lambda ti: torch.cos(w * ti),
                                   tab=ttab.TABLEAUS[tab])
    before = fused_rk_step.launches
    for _ in range(2):
        y, e = step(t, Cplx(xw[:, :5], xw[:, 5:]), dt)
        assert torch.equal(torch.cat([y.re, y.im], dim=1), want_x)
        assert (e is None) if want_e is None else torch.equal(e, want_e)
    assert fused_rk_step.launches == before


def test_kernel_module_imports_without_nvcc():
    """The build is lazy: nothing is compiled or loaded at import, and the
    library lands in the repository's ignored build directory."""
    import importlib

    import vec_ode_tpu_torch.ops.fused_rk as fr

    importlib.reload(fr)
    assert "fused_rk_step" not in _build._loaded
    path = _build.library_path("fused_rk_step")
    assert path.parent == _build.BUILD_DIR
    assert _build.BUILD_DIR.parts[-2:] == ("build", "kernels")
    assert (_build.CSRC / "fused_rk_step.cu").exists()
    assert "-use_fast_math" not in " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert _build.build_log("fused_rk_step") == path.with_suffix(".log")


def test_library_name_follows_shared_headers(tmp_path, monkeypatch):
    """An edited shared header (csrc/*.cuh) gives every library a new
    name, so a stale build is never loaded."""
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include "step.cuh"\n')
    (tmp_path / "step.cuh").write_text("// v1\n")
    first = _build.library_path("k")
    assert _build.library_path("k") == first
    (tmp_path / "step.cuh").write_text("// v2\n")
    assert _build.library_path("k") != first


def test_stepper_declarations():
    M0 = torch.zeros(4, 4)
    with pytest.raises(TypeError, match="w"):   # the drive is declared
        FusedModulatedLinearRK(M0=M0, M1=M0)
    with pytest.raises(TypeError, match="TracedNorm"):  # not a norm
        FusedModulatedLinearRK(M0=M0, M1=M0, w=1.0, norm=object())
    st = FusedModulatedLinearRK(M0=M0, M1=M0, w=1.0, tableau=ttab.DOPRI5)
    assert st.nfev_per_step == 7 and st.is_batched
    with pytest.raises(ValueError, match="rhs=None"):
        st.make_step_fn(lambda t, y: y)


def test_from_driven_dense_matches_jax():
    model = DrivenDense.make(d=8, seed=5)
    jmodel = JDrivenDense.make(d=8, seed=5)
    np.testing.assert_array_equal(model.H0, jmodel.H0)
    np.testing.assert_array_equal(model.V, jmodel.V)
    assert model.w == jmodel.w
    for dtype, jdtype in ((torch.float32, jnp.float32),
                          (torch.float64, jnp.float64)):
        st = FusedModulatedLinearRK.from_driven_dense(model, dtype,
                                                      device="cpu")
        jst = JStepper.from_driven_dense(jmodel, jdtype)
        assert st.M0.dtype == dtype
        np.testing.assert_array_equal(st.M0.numpy(), np.asarray(jst.M0))
        np.testing.assert_array_equal(st.M1.numpy(), np.asarray(jst.M1))
        assert st.w == jmodel.w


def test_hermite_slope_matches_jax():
    jst = JStepper.from_driven_dense(JDrivenDense.make(d=6, seed=1),
                                     jnp.float64)
    st = FusedModulatedLinearRK.from_driven_dense(
        DrivenDense.make(d=6, seed=1), torch.float64, device="cpu")
    rng = np.random.default_rng(2)
    re, im = rng.standard_normal((2, 5, 6))
    t = rng.uniform(0, 1, 5)
    from vec_ode_tpu.ops.cplx import Cplx as JCplx

    want = jst.hermite_slope(jnp.asarray(t), JCplx(jnp.asarray(re),
                                                   jnp.asarray(im)))
    got = st.hermite_slope(torch.as_tensor(t), Cplx(*_torch(re, im)))
    np.testing.assert_allclose(got.re.numpy(), np.asarray(want.re),
                               atol=1e-13)
    np.testing.assert_allclose(got.im.numpy(), np.asarray(want.im),
                               atol=1e-13)


def test_cplx_helpers_match_jax():
    from vec_ode_tpu.ops import cplx as jcp
    from vec_ode_tpu_torch.ops import cplx as tcp

    rng = np.random.default_rng(4)
    z = rng.standard_normal((3, 4, 4)) + 1j * rng.standard_normal((3, 4, 4))
    c = tcp.from_complex(z, device="cpu")
    assert c.dtype == torch.float64 and c.shape == (3, 4, 4)
    np.testing.assert_array_equal(tcp.to_complex(c).numpy(), z)
    np.testing.assert_array_equal(
        tcp.from_complex(torch.as_tensor(z), torch.float32,
                         device="cpu").re.numpy(),
        z.real.astype(np.float32))
    np.testing.assert_array_equal(
        tcp.embed(c).numpy(),
        np.asarray(jcp.embed(jcp.from_complex(z, jnp.float64))))


NORMS = [("l2", None), ("l2", "ramp"), ("rms", "ramp"), ("max", None),
         ("max", "ramp")]


def _norm(kind, weights, d):
    from vec_ode_tpu import lc as jlc
    from vec_ode_tpu_torch import lc

    w = None if weights is None else tuple(np.linspace(0.5, 2.0, d))
    return lc.WeightedNorm(kind, w), jlc.WeightedNorm(kind, w)


@pytest.mark.parametrize("kind,weights", NORMS)
@pytest.mark.parametrize("d", [64, 5])
def test_torch_step_with_declared_norm_matches_xla_step_f64(d, kind,
                                                            weights):
    M0, M1, w, t, dt, xw = _problem(8, d, np.float64)
    tnorm, jnorm = _norm(kind, weights, d)
    jx, je = xla_rk_step(
        jnp.asarray(t), jnp.asarray(dt), jnp.asarray(xw), jnp.asarray(M0),
        jnp.asarray(M1), u_fn=lambda ti: jnp.cos(w * ti),
        wnorm=jnorm.kernel_parts(d, 2))
    tx, te = torch_rk_step(
        *_torch(t, dt, xw, M0, M1), u_fn=lambda ti: torch.cos(w * ti),
        wnorm=tnorm.kernel_parts(d, 2))
    # as test_torch_step_matches_xla_step_f64: the error vector is a
    # cancelling sum, its last digits follow the BLAS summation order
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=1e-9,
                               atol=1e-18)
    # the wrapper on CPU tensors is the same plain step
    fx, fe = fused_rk_step(*_torch(t, dt, xw, M0, M1), w=w,
                           wnorm=tnorm.kernel_parts(d, 2))
    assert torch.equal(fx, tx) and torch.equal(fe, te)


@pytest.mark.parametrize("advance_lower", [True, False])
def test_torch_step_scaled_error_matches_error_measure_f64(advance_lower):
    """``scaled=(atol, rtol)`` against the JAX package's
    ``controller.error_measure`` applied to the unreduced error vector
    (``xla_rk_step`` returns it for an identity norm executor)."""
    from vec_ode_tpu import controller as jc
    from vec_ode_tpu import lc as jlc
    import vec_ode_tpu as vo

    M0, M1, w, t, dt, xw = _problem(8, 64, np.float64)
    ctl = vo.StepControl(rtol=1e-6, atol=1e-9, scaled_error=True)
    args = (jnp.asarray(t), jnp.asarray(dt), jnp.asarray(xw),
            jnp.asarray(M0), jnp.asarray(M1))
    kw = dict(u_fn=lambda ti: jnp.cos(w * ti), advance_lower=advance_lower)
    jx, jerr = xla_rk_step(*args, wnorm=lambda dv: dv, **kw)
    want = jc.error_measure(jlc.norm_l2_batched, args[2], jx, jerr, ctl)
    tx, te = torch_rk_step(
        *_torch(t, dt, xw, M0, M1), u_fn=lambda ti: torch.cos(w * ti),
        advance_lower=advance_lower, scaled=(ctl.atol, ctl.rtol))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0,
                               atol=1e-12)
    # the unscaled test's floor of 1e-18 on the error vector, divided by
    # atol at the least and multiplied by rtol
    np.testing.assert_allclose(te.numpy(), np.asarray(want), rtol=1e-9,
                               atol=1e-18 * ctl.rtol / ctl.atol)
    # scaling at tiny atol on O(0.1) states makes the measure larger
    _, plain = torch_rk_step(*_torch(t, dt, xw, M0, M1),
                             u_fn=lambda ti: torch.cos(w * ti),
                             advance_lower=advance_lower)
    assert bool((te > plain).all())


def test_stepper_runs_a_declared_norm_on_the_cpu():
    from vec_ode_tpu_torch import lc

    M0, M1, w, t, dt, xw = _problem(16, 5, np.float64)
    norm = lc.WeightedNorm("max", tuple(np.linspace(1.0, 2.0, 5)))
    st = FusedModulatedLinearRK(M0=torch.as_tensor(M0),
                                M1=torch.as_tensor(M1), w=w, norm=norm)
    t, dt, xw = _torch(t, dt, xw)
    y, e = st.make_step_fn()(t, Cplx(xw[:, :5], xw[:, 5:]), dt)
    want_x, want_e = torch_rk_step(t, dt, xw, st.M0, st.M1,
                                   u_fn=lambda ti: torch.cos(w * ti),
                                   wnorm=norm.kernel_parts(5, 2))
    assert torch.equal(torch.cat([y.re, y.im], 1), want_x)
    assert torch.equal(e, want_e)
    bad = FusedModulatedLinearRK(M0=st.M0, M1=st.M1, w=w,
                                 norm=lc.WeightedNorm("l2", (1.0, 2.0)))
    with pytest.raises(ValueError, match="length 5"):
        bad.make_step_fn()(t, Cplx(xw[:, :5], xw[:, 5:]), dt)


def test_constructors_default_to_the_card():
    """Without ``device=`` the port's constructors put their tensors on
    the card; on a machine without one they raise instead of returning CPU
    tensors."""
    from vec_ode_tpu_torch import convert, driver
    from vec_ode_tpu_torch.ops.cplx import from_complex

    if torch.cuda.is_available():
        pytest.skip("this box has a card: the defaults succeed there")
    z = np.ones((2, 3), complex)
    for make in (lambda: from_complex(z),
                 lambda: from_complex(torch.as_tensor(z)),
                 lambda: FusedModulatedLinearRK.from_driven_dense(
                     DrivenDense.make(d=3, seed=0)),
                 lambda: convert.stepper_from_numpy(np.eye(6), np.eye(6),
                                                    1.0),
                 lambda: convert.state_from_numpy(z.real, z.imag),
                 lambda: driver.make_grid(0.0, 1.0)):
        with pytest.raises((RuntimeError, AssertionError),
                           match="CUDA|cuda|NVIDIA"):
            make()

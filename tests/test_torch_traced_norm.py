"""Opaque error norms on the batched tier (``lc.TracedNorm``,
``lc.try_trace_norm``) and ``config.warn_on_fallback``, the port's cases
of tests/test_traced_norm.py and tests/test_path.py, held against the JAX
package in f64 on the CPU. A hand-written l2 over the Cplx pair, passed
as ``error_norm=``, is probed and installed in a natively batched
stepper's ``norm`` slot, whose step then runs its twin (no kernel runs a
Python callable); vector-returning or untraceable callables keep the
vmapped tier or raise, as in the JAX package."""

import dataclasses
import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vec_ode_tpu as vo
from vec_ode_tpu import exp as jexp
from vec_ode_tpu import lc as jlc
from vec_ode_tpu.models import DrivenDense as JDrivenDense
from vec_ode_tpu.ops import cplx as jcp
from vec_ode_tpu.parallel import ensemble_solve as jensemble_solve
import vec_ode_tpu_torch as vt
from vec_ode_tpu_torch import config, lc
from vec_ode_tpu_torch import exp as texp
from vec_ode_tpu_torch.models import DrivenDense
from vec_ode_tpu_torch.ops import expmv
from vec_ode_tpu_torch.ops.cplx import Cplx, from_complex
from vec_ode_tpu_torch.ops.fused_rk import FusedModulatedLinearRK
from vec_ode_tpu_torch.parallel import ensemble_solve

torch.set_num_threads(1)

W = np.linspace(0.25, 3.0, 8)
CTL = dict(rtol=1e-7, min_dt=1e-6, max_dt=0.3)
B = 8


def _my_norm(err):
    """Weighted l2 over the Cplx pair, hand-written: traceable torch, but
    not a WeightedNorm declaration."""
    w = torch.as_tensor(W, dtype=err.re.dtype)
    return torch.sqrt(torch.sum((w * err.re) ** 2)
                      + torch.sum((w * err.im) ** 2))


def _j_my_norm(err):
    w = jnp.asarray(W, err.re.dtype)
    return jnp.sqrt(jnp.sum((w * err.re) ** 2) + jnp.sum((w * err.im) ** 2))


def _untraceable(err):
    return float(err.re.max())   # reads a value: fails under vmap


def _psi(n=B, seed=11, d=8):
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((n, d)) + 1j * rng.standard_normal((n, d))
    return z / np.linalg.norm(z, axis=-1, keepdims=True)


def _op(dtype=torch.float64):
    model = DrivenDense.make(d=8, seed=0)
    return lambda t: model.op_pair(t, dtype, device="cpu")


def _jop():
    model = JDrivenDense.make(d=8, seed=0)
    return lambda t: model.op_pair(t, jnp.float64)


STEPPERS = {
    "magnus4": (lambda lib, **kw: lib.Magnus4(lib.DenseCplxSplit(), **kw)),
    "magnus4_fast": (lambda lib, **kw: lib.Magnus4(
        lib.DenseCplxSplit(), fast_error=True, **kw)),
    "cfm4": (lambda lib, **kw: lib.CFM4(lib.DenseCplxSplit(), **kw)),
    "magnus6": (lambda lib, **kw: lib.Magnus6(lib.DenseCplxSplit(), **kw)),
}


def _solve(stepper, psi, norm, **kw):
    return ensemble_solve(_op(), from_complex(psi, device="cpu"), 0.0, 1.0,
                          stepper=stepper, error_norm=norm, h0=1e-2,
                          ctl=vt.StepControl(**CTL), **kw)


@functools.cache
def _jax_counts(name, batched, comp=False, norm="mine"):
    st = STEPPERS[name](jexp, batched=batched, compensated=comp)
    sol = jensemble_solve(
        _jop(), jcp.from_complex(_psi(), jnp.float64), 0.0, 1.0, stepper=st,
        error_norm=_j_my_norm if norm == "mine" else jlc.norm_l2, h0=1e-2,
        ctl=vo.StepControl(**CTL))
    return np.asarray(sol.n_accept), np.asarray(sol.n_reject), \
        np.asarray(sol.y_final.re)


def test_try_trace_norm_probe():
    """A norm mapping one trajectory's error to a scalar traces; a
    vector-returning callable or one that reads a value does not, on both
    sides; the probe reads only the example's shapes and types."""
    probe = Cplx(torch.zeros(8, dtype=torch.float64, device="meta"),
                 torch.zeros(8, dtype=torch.float64, device="meta"))
    assert isinstance(lc.try_trace_norm(_my_norm, probe), lc.TracedNorm)
    assert lc.try_trace_norm(lambda e: e.re, probe) is None
    assert lc.try_trace_norm(_untraceable, probe) is None
    assert isinstance(lc.try_trace_norm(
        _my_norm, from_complex(_psi(1)[0], device="cpu")), lc.TracedNorm)
    jprobe = jcp.Cplx(jax.ShapeDtypeStruct((8,), jnp.float64),
                      jax.ShapeDtypeStruct((8,), jnp.float64))
    assert isinstance(jlc.try_trace_norm(_j_my_norm, jprobe), jlc.TracedNorm)
    assert jlc.try_trace_norm(lambda e: e.re, jprobe) is None


def test_traced_norm_batched_executor_matches_direct():
    y = from_complex(_psi(5, seed=3), device="cpu")
    got = lc.TracedNorm(_my_norm).batched(y).numpy()
    want = [float(_my_norm(Cplx(y.re[i], y.im[i]))) for i in range(5)]
    jgot = jlc.TracedNorm(_j_my_norm).batched(
        jcp.from_complex(_psi(5, seed=3), jnp.float64))
    np.testing.assert_allclose(got, want, rtol=1e-12)
    np.testing.assert_allclose(got, np.asarray(jgot), rtol=1e-12)


def test_apply_weighted_norm_callable_hook():
    dv = np.random.default_rng(0).standard_normal((4, 6))
    got = lc.apply_weighted_norm(torch.as_tensor(dv),
                                 lambda d: torch.amax(d.abs(), dim=-1))
    jgot = jlc.apply_weighted_norm(jnp.asarray(dv),
                                   lambda d: jnp.max(jnp.abs(d), axis=-1))
    np.testing.assert_array_equal(got.numpy(), np.abs(dv).max(axis=1))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jgot))


@pytest.mark.parametrize("name", list(STEPPERS))
def test_traced_norm_keeps_batched_tier(name):
    """batched=True with an opaque norm: the traced norm keeps the batched
    tier and matches the vmapped tier (the driver applying the callable)
    and the JAX package's batched solve, step for step (f64)."""
    psi = _psi()
    sol_b = _solve(STEPPERS[name](texp, batched=True), psi, _my_norm)
    sol_v = _solve(STEPPERS[name](texp, batched=False), psi, _my_norm)
    assert sol_b.path == "torch-driver"
    np.testing.assert_array_equal(sol_b.n_accept.numpy(),
                                  sol_v.n_accept.numpy())
    np.testing.assert_array_equal(sol_b.n_reject.numpy(),
                                  sol_v.n_reject.numpy())
    np.testing.assert_allclose(sol_b.y_final.re.numpy(),
                               sol_v.y_final.re.numpy(), rtol=1e-10,
                               atol=1e-10)
    na, nr, yre = _jax_counts(name, True)
    np.testing.assert_array_equal(sol_b.n_accept.numpy(), na)
    np.testing.assert_array_equal(sol_b.n_reject.numpy(), nr)
    np.testing.assert_allclose(sol_b.y_final.re.numpy(), yre, atol=1e-10)


def test_traced_norm_matches_weighted_norm_semantics():
    """_my_norm is WeightedNorm("l2", W) written by hand: the same steps
    and, to rounding, the same states; the unweighted solve differs."""
    psi = _psi(seed=2)
    st = texp.Magnus4(texp.DenseCplxSplit())
    sol_t = _solve(st, psi, _my_norm)
    sol_d = _solve(st, psi, lc.WeightedNorm("l2", weights=W))
    np.testing.assert_array_equal(sol_t.n_accept.numpy(),
                                  sol_d.n_accept.numpy())
    np.testing.assert_allclose(sol_t.y_final.re.numpy(),
                               sol_d.y_final.re.numpy(), rtol=1e-12,
                               atol=1e-12)
    sol_u = _solve(st, psi, lc.norm_l2)
    assert (sol_t.n_accept != sol_u.n_accept).any()


def test_traced_norm_compensated_tier():
    """The traced norm on the compensated tier (difference of increments,
    the same widened layout): batched as the vmapped tier, and as the JAX
    package's compensated batched solve."""
    psi = _psi()
    sol = _solve(texp.Magnus4(texp.DenseCplxSplit(), compensated=True,
                              batched=True), psi, _my_norm)
    assert bool((sol.status == vt.DONE).all())
    sol_v = _solve(texp.Magnus4(texp.DenseCplxSplit(), compensated=True,
                                batched=False), psi, _my_norm)
    np.testing.assert_array_equal(sol.n_accept.numpy(),
                                  sol_v.n_accept.numpy())
    na, _, yre = _jax_counts("magnus4", True, comp=True)
    np.testing.assert_array_equal(sol.n_accept.numpy(), na)
    np.testing.assert_allclose(sol.y_final.re.numpy(), yre, atol=1e-10)


def test_traced_norm_modulated_stepper():
    """MagnusModulated4 (always batched) with the opaque norm: installed
    as a TracedNorm, its twin step applies it; the generic stepper's
    vmapped solve takes the same steps."""
    mod = DrivenDense.make(d=8, seed=0).modulated(torch.float64,
                                                  device="cpu")
    psi = _psi(4, seed=7)
    sol_m = ensemble_solve(None, from_complex(psi, device="cpu"), 0.0, 1.0,
                           stepper=texp.MagnusModulated4(mod),
                           error_norm=_my_norm, h0=1e-2,
                           ctl=vt.StepControl(**CTL))
    sol_g = _solve(texp.Magnus4(texp.DenseCplxSplit(), batched=False),
                   psi, _my_norm)
    assert sol_m.path == "torch-driver"
    np.testing.assert_array_equal(sol_m.n_accept.numpy(),
                                  sol_g.n_accept.numpy())
    np.testing.assert_allclose(sol_m.y_final.re.numpy(),
                               sol_g.y_final.re.numpy(), rtol=1e-8,
                               atol=1e-8)


def test_traced_norm_per_step_kernel_falls_through():
    """A stepper with a kernel runs its twin under a traced norm: no
    launch, the same steps as the declared l2 (f32, the JAX test's
    setting), and the path names the twin on the card."""
    model = DrivenDense.make(d=64, seed=0)
    mod = model.modulated(torch.float32, device="cpu")
    y0 = from_complex(_psi(8, seed=13, d=64), torch.float32, device="cpu")

    def norm64(err):
        return torch.sqrt(torch.sum(err.re ** 2) + torch.sum(err.im ** 2)
                          + 0.0)

    ctl = vt.StepControl(rtol=1e-4, min_dt=1e-5, max_dt=0.2, max_steps=500)
    kw = dict(h0=1e-2, ctl=ctl, time_dtype=torch.float32)
    st = dataclasses.replace(texp.MagnusModulated4(mod), norm=None)
    before = expmv.fused_chain_apply.launches
    sol_t = ensemble_solve(None, y0, 0.0, 0.5, stepper=st,
                           error_norm=norm64, **kw)
    sol_d = ensemble_solve(None, y0, 0.0, 0.5, stepper=st,
                           error_norm=lc.WeightedNorm("l2"), **kw)
    assert expmv.fused_chain_apply.launches == before
    np.testing.assert_array_equal(sol_t.n_accept.numpy(),
                                  sol_d.n_accept.numpy())
    np.testing.assert_allclose(sol_t.y_final.re.numpy(),
                               sol_d.y_final.re.numpy(), rtol=1e-6,
                               atol=1e-6)

    class OnCard:
        is_cuda = True

    traced = dataclasses.replace(st, norm=lc.TracedNorm(norm64))
    assert traced.step_path(Cplx(OnCard(), OnCard())) == \
        "torch-driver+twin-step"
    assert st.step_path(Cplx(OnCard(), OnCard())) == "torch-driver+cuda-step"
    rk = FusedModulatedLinearRK.from_driven_dense(model, device="cpu",
                                                  norm=lc.TracedNorm(norm64))
    assert rk.twin_only
    assert rk.step_path(Cplx(OnCard(), OnCard())) == "torch-driver+twin-step"


def test_fused_loop_declines_traced_norm():
    """The loop kernel runs no callable: with a TracedNorm installed,
    fused_loop_solve returns None and, opted in, names the rule."""
    mod = DrivenDense.make(d=8, seed=0).modulated(torch.float32,
                                                  device="cpu")
    y0 = from_complex(_psi(16, seed=21), torch.float32, device="cpu")
    st = texp.MagnusModulated4(mod, norm=lc.TracedNorm(_my_norm))
    grid = torch.tensor([0.0, 0.5], dtype=torch.float32)
    ctl = vt.StepControl(rtol=1e-4, min_dt=1e-5, max_dt=0.2, max_steps=500)
    config.warn_on_fallback = True
    try:
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            sol = st.fused_loop_solve(y0, grid, 1e-2, ctl=ctl, adaptive=True)
    finally:
        config.warn_on_fallback = False
    assert sol is None
    assert any("traced error norm" in str(w.message) for w in rec)


def test_untraceable_callable_keeps_legacy_paths():
    psi = _psi(4, seed=17)
    st = texp.Magnus4(texp.DenseCplxSplit(), batched=True)
    with pytest.raises(ValueError, match="OPAQUE"):
        _solve(st, psi, _untraceable)
    # an auto-batched stepper keeps the vmapped tier, where the callable
    # cannot run either
    with pytest.raises(Exception):
        _solve(texp.Magnus4(texp.DenseCplxSplit()), psi, _untraceable)


def test_scaled_error_skips_tracing():
    """scaled_error redefines the error measure: no tracing; batched=True
    raises, as in the JAX package."""
    psi = _psi(4, seed=19)
    st = texp.Magnus4(texp.DenseCplxSplit(), batched=True)
    with pytest.raises(ValueError, match="OPAQUE|scaled_error"):
        ensemble_solve(_op(), from_complex(psi, device="cpu"), 0.0, 1.0,
                       stepper=st, error_norm=_my_norm, h0=1e-2,
                       ctl=vt.StepControl(rtol=1e-6, atol=1e-10,
                                          scaled_error=True, min_dt=1e-6,
                                          max_dt=0.3))


def test_pytree_weights_on_the_vmapped_tier():
    """Pytree weights (one array per leaf) reduce leaf by leaf, as the JAX
    package's; the vmapped tier applies them."""
    w_tree = Cplx(np.arange(1.0, 9.0), np.full(8, 0.5))
    e = from_complex(_psi(1)[0], device="cpu")
    got = float(lc.WeightedNorm("l2", weights=w_tree)(e))
    jgot = float(jlc.WeightedNorm("l2", weights=jcp.Cplx(*w_tree))(
        jcp.from_complex(_psi(1)[0], jnp.float64)))
    ref = np.sqrt(((e.re.numpy() * w_tree.re) ** 2).sum()
                  + ((e.im.numpy() * 0.5) ** 2).sum())
    np.testing.assert_allclose(got, ref, rtol=1e-14)
    np.testing.assert_allclose(got, jgot, rtol=1e-14)
    wn = lc.WeightedNorm("l2", weights=w_tree)
    assert wn.kernel_parts(8, 2) is None and wn.same_as(wn)
    sol = _solve(texp.Magnus4(texp.DenseCplxSplit(), batched=False), _psi(),
                 wn)
    assert bool((sol.status == vt.DONE).all())
    # the batched tiers cannot lay it out
    mod = DrivenDense.make(d=8, seed=0).modulated(torch.float64,
                                                  device="cpu")
    with pytest.raises(ValueError, match="per-\\(complex-\\)component"):
        ensemble_solve(None, from_complex(_psi(), device="cpu"), 0.0, 1.0,
                       stepper=texp.CFM4Modulated(mod, norm=wn), h0=1e-2,
                       ctl=vt.StepControl(**CTL))


def test_warn_on_fallback_names_the_rule():
    """Opted in, a kernel path that declines names its rule (the JAX
    package's test_path case); off, nothing is said."""
    mod = DrivenDense.make(d=8, seed=0).modulated(torch.float32,
                                                  device="cpu")
    y0 = from_complex(_psi(16), torch.float32, device="cpu")
    st = texp.MagnusModulated4(mod)
    grid = torch.tensor([0.0, 0.1], dtype=torch.float32)
    ctl = vt.StepControl(rtol=1e-4, max_dt=0.05)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        assert st.fused_loop_solve(y0, grid, 1e-2, ctl=ctl,
                                   adaptive=False) is None
    assert not [w for w in rec if "vec_ode_tpu_torch" in str(w.message)]
    config.warn_on_fallback = True
    try:
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            assert st.fused_loop_solve(y0, grid, 1e-2, ctl=ctl,
                                       adaptive=False) is None
            assert st.fused_loop_solve(
                y0, grid.double(), 1e-2, ctl=ctl, adaptive=True) is None
            sol = st.fused_loop_solve(y0, grid, 1e-2, ctl=ctl,
                                      adaptive=True)
    finally:
        config.warn_on_fallback = False
    msgs = [str(w.message) for w in rec]
    assert any("adaptive" in m for m in msgs), msgs
    assert any("time dtype" in m for m in msgs), msgs
    assert len(msgs) == 2 and sol.path == "torch-loop"

"""The port's main path as a whole: ``vec_ode_tpu_torch.parallel.
ensemble_solve`` over the fused RKF45 stepper, against the JAX package's
``ensemble_solve`` (XLA driver, ``use_pallas=False``) on the same numpy
inputs, and against the native C++ oracle for a constant operator."""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vec_ode_tpu as vo
from vec_ode_tpu.models import DrivenDense as JDrivenDense
from vec_ode_tpu.ops import cplx as jcp
from vec_ode_tpu.ops.pallas_rk import FusedModulatedLinearRK as JStepper
from vec_ode_tpu.parallel import ensemble_solve as jax_ensemble_solve
from vec_ode_tpu.utils import oracle
import vec_ode_tpu_torch as vt
from vec_ode_tpu_torch import convert
from vec_ode_tpu_torch import exp as texp
from vec_ode_tpu_torch.parallel import ensemble_solve
from test_torch_rk import H_FINAL_TIGHT

torch.set_num_threads(1)

D = 64


def _problem(B, d=D, seed=42):
    """The main path's model and unit-norm initial states, both sides."""
    model = JDrivenDense.make(d=d, seed=0)
    jst = JStepper.from_driven_dense(model, jnp.float64)
    rng = np.random.default_rng(seed)
    psi = rng.standard_normal((B, d)) + 1j * rng.standard_normal((B, d))
    psi /= np.linalg.norm(psi, axis=-1, keepdims=True)
    return model, np.asarray(jst.M0), np.asarray(jst.M1), psi


def _solve_both(psi, M0, M1, w, dtype, ctl_kw, t0=0.0, tf=1.0, h0=1e-3,
                save_at=None):
    jdt = jnp.float64 if dtype == np.float64 else jnp.float32
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    jst = JStepper(M0=np.asarray(M0, dtype), M1=np.asarray(M1, dtype),
                   u_fn=lambda t: jnp.cos(w * t), use_pallas=False)
    want = jax_ensemble_solve(
        None, jcp.from_complex(psi, jdt), t0, tf, stepper=jst,
        ctl=vo.StepControl(**ctl_kw), h0=h0, save_at=save_at,
        time_dtype=jdt)
    st = convert.stepper_from_numpy(M0, M1, w, dtype=tdt, device="cpu")
    got = ensemble_solve(
        None, convert.state_from_numpy(psi.real, psi.imag, dtype=tdt,
                                       device="cpu"), t0,
        tf, stepper=st, ctl=vt.StepControl(**ctl_kw), h0=h0,
        save_at=save_at, time_dtype=tdt)
    return want, got, convert.solution_to_numpy(got)


COUNTERS = ("status", "n_accept", "n_reject", "n_iters")


@pytest.mark.parametrize("save_at", [None, (0.25, 0.5, 0.75)])
def test_f64_parity_with_jax(save_at):
    model, M0, M1, psi = _problem(16)
    want, got, g = _solve_both(
        psi, M0, M1, model.w, np.float64,
        dict(rtol=1e-8, min_dt=1e-6, max_dt=0.25), save_at=save_at)
    assert (g["status"] == vt.DONE).all()
    for k in COUNTERS:   # equal per trajectory
        np.testing.assert_array_equal(g[k], np.asarray(getattr(want, k)),
                                      err_msg=k)
    assert got.path == "torch-driver"
    for part in ("re", "im"):
        np.testing.assert_allclose(getattr(g["y_final"], part),
                                   np.asarray(getattr(want.y_final, part)),
                                   rtol=0, atol=1e-10)
        np.testing.assert_allclose(getattr(g["ys"], part),
                                   np.asarray(getattr(want.ys, part)),
                                   rtol=0, atol=1e-10)
    np.testing.assert_array_equal(g["ts"], np.asarray(want.ts))
    np.testing.assert_allclose(g["t_final"], np.asarray(want.t_final),
                               rtol=1e-12)
    # h_final = clip(alpha (rtol/err)^(1/3) h): err is a cancelling sum
    # whose last digits follow the BLAS summation order (~1e-10 relative),
    # and h carries a third of that
    np.testing.assert_allclose(g["h_final"], np.asarray(want.h_final),
                               rtol=1e-9)


def test_f32_parity_with_jax():
    model, M0, M1, psi = _problem(32)
    want, got, g = _solve_both(
        psi, M0, M1, model.w, np.float32,
        dict(rtol=1e-5, min_dt=1e-6, max_dt=0.25))
    assert (g["status"] == vt.DONE).all()
    assert (np.asarray(want.status) == vo.DONE).all()
    for k in ("n_accept", "n_reject", "n_iters"):
        diff = np.abs(g[k] - np.asarray(getattr(want, k)))
        assert diff.max() <= 2, k
        assert (diff == 0).mean() >= 0.9, k
    for part in ("re", "im"):
        np.testing.assert_allclose(getattr(g["y_final"], part),
                                   np.asarray(getattr(want.y_final, part)),
                                   rtol=0, atol=2e-5)
    assert g["y_final"].re.dtype == np.float32


def test_max_steps_gives_err_max_steps():
    model, M0, M1, psi = _problem(4)
    want, _, g = _solve_both(
        psi, M0, M1, model.w, np.float64,
        dict(rtol=1e-8, max_dt=0.25, max_steps=5))
    assert (g["status"] == vt.ERR_MAX_STEPS).all()
    for k in COUNTERS:
        np.testing.assert_array_equal(g[k], np.asarray(getattr(want, k)))
    # the end slot of ys stays empty for a trajectory that did not end
    assert (g["ys"].re[:, 1] == 0).all()
    np.testing.assert_array_equal(g["ys"].re[:, 0], psi.real)


def test_zero_length_interval_is_done_immediately():
    model, M0, M1, psi = _problem(3)
    _, _, g = _solve_both(psi, M0, M1, model.w, np.float64,
                          dict(rtol=1e-8), t0=0.5, tf=0.5)
    assert (g["status"] == vt.DONE).all()
    assert (g["n_accept"] == 0).all()
    np.testing.assert_array_equal(g["y_final"].re, psi.real)
    np.testing.assert_array_equal(g["y_final"].im, psi.imag)


@pytest.mark.parametrize("kw", [
    dict(h0=1e-9), dict(h0=0.5), dict(h0=float("nan")),
    dict(save_at=(0.5, 0.25)), dict(save_at=(1.5,)),
    # this stepper embeds its operator: no per-trajectory params (as in JAX)
    dict(params=np.ones(2)),
])
def test_bad_inputs_raise_value_error(kw):
    _, M0, M1, psi = _problem(2, d=3)
    st = convert.stepper_from_numpy(M0, M1, 1.0, device="cpu")
    y0 = convert.state_from_numpy(psi.real, psi.imag, device="cpu")
    kw = dict(dict(h0=1e-3), **kw)
    with pytest.raises(ValueError):
        ensemble_solve(None, y0, 0.0, 1.0, stepper=st,
                       ctl=vt.StepControl(max_dt=0.25), **kw)


@pytest.mark.parametrize("kw", [
    dict(mesh=object()),
    # method="scan" and dense output on the vmapped tier run
    # (tests/test_torch_scan.py, test_torch_dense_tiers.py); what is still
    # unported is refused under them too
    dict(method="scan", mesh=object()),
    dict(stepper=texp.Magnus4(texp.DenseCplxSplit(), batched=False),
         dense=True, mesh=object()),
    # an opaque norm on a natively batched stepper that does not map a
    # trajectory to a scalar: the JAX package's ValueError (a traceable
    # one runs, tests/test_torch_traced_norm.py)
    dict(error_norm=lambda e: e),
])
def test_unported_options_raise_not_implemented(kw):
    _, M0, M1, psi = _problem(2, d=3)
    kw = dict(dict(stepper=convert.stepper_from_numpy(M0, M1, 1.0,
                                                      device="cpu")), **kw)
    y0 = convert.state_from_numpy(psi.real, psi.imag, device="cpu")
    exc, match = ((ValueError, "OPAQUE") if "error_norm" in kw
                  else (NotImplementedError, "ROADMAP"))
    with pytest.raises(exc, match=match):
        ensemble_solve(None, y0, 0.0, 1.0, h0=1e-3, **kw)


# the calls the vmapped tier now runs, which raised before it was ported:
# stepper=None (RKF45 over a per-trajectory RHS), a generic exponential
# stepper asked not to batch, and scaled_error with an auto-batched one
VMAPPED = {
    "stepper_none": lambda lib: dict(stepper=None),
    "magnus4_unbatched": lambda lib: dict(stepper=lib.Magnus4(
        lib.DenseCplxSplit(), batched=False)),
    "magnus4_scaled_error": lambda lib: dict(stepper=lib.Magnus4(
        lib.DenseCplxSplit())),
}


@functools.cache
def _vmapped_want(name):
    model, _, _, psi = _problem(2, d=3)
    ctl = dict(rtol=1e-8, max_dt=0.25,
               scaled_error=name == "magnus4_scaled_error")
    if name == "stepper_none":
        fn = (lambda t, y: model.rhs_pair(t, y, jnp.float64))
    else:
        fn = (lambda t: model.op_pair(t, jnp.float64))
    from vec_ode_tpu import exp as vexp
    return jax_ensemble_solve(fn, jcp.from_complex(psi, jnp.float64), 0.0,
                              1.0, h0=1e-3, ctl=vo.StepControl(**ctl),
                              **VMAPPED[name](vexp))


@pytest.mark.parametrize("name", sorted(VMAPPED))
def test_vmapped_tier_calls_match_jax(name):
    model, _, _, psi = _problem(2, d=3)
    from vec_ode_tpu_torch.models import DrivenDense
    tmodel = DrivenDense(H0=np.array(model.H0), V=np.array(model.V),
                         w=model.w)
    ctl = dict(rtol=1e-8, max_dt=0.25,
               scaled_error=name == "magnus4_scaled_error")
    if name == "stepper_none":
        fn = (lambda t, y: tmodel.rhs_pair(t, y, torch.float64))
    else:
        fn = (lambda t: tmodel.op_pair(t, torch.float64, device="cpu"))
    got = ensemble_solve(fn, convert.state_from_numpy(psi.real, psi.imag,
                                                      device="cpu"),
                         0.0, 1.0, h0=1e-3, ctl=vt.StepControl(**ctl),
                         **VMAPPED[name](texp))
    want = _vmapped_want(name)
    assert got.path == "torch-driver"
    g = convert.solution_to_numpy(got)
    for k in COUNTERS:
        np.testing.assert_array_equal(g[k], np.asarray(getattr(want, k)),
                                      err_msg=k)
    for part in ("re", "im"):
        np.testing.assert_allclose(getattr(g["y_final"], part),
                                   np.asarray(getattr(want.y_final, part)),
                                   rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(g["h_final"], np.asarray(want.h_final),
                               rtol=H_FINAL_TIGHT)


def test_scaled_error_needs_the_loop_kernel():
    _, M0, M1, psi = _problem(2, d=3)
    with pytest.raises(ValueError, match="scaled_error"):
        ensemble_solve(None, convert.state_from_numpy(psi.real, psi.imag,
                                                      device="cpu"),
                       0.0, 1.0, stepper=convert.stepper_from_numpy(
                           M0, M1, 1.0, device="cpu"),
                       ctl=vt.StepControl(scaled_error=True), h0=1e-3)


def test_constant_operator_matches_native_oracle():
    """M1 = 0 leaves dx/dt = M0 x: each trajectory against the C++
    oracle's reference semantics (plain time, strict end test)."""
    _, M0, _, psi = _problem(4, d=16, seed=7)
    kw = dict(rtol=1e-8, min_dt=1e-6, max_dt=0.25)
    st = convert.stepper_from_numpy(M0, np.zeros_like(M0), 1.0,
                                    device="cpu")
    sol = ensemble_solve(
        None, convert.state_from_numpy(psi.real, psi.imag, device="cpu"),
        0.0, 1.0, stepper=st, h0=1e-3,
        ctl=vt.StepControl(time_compensated=False, strict_end_test=True,
                           **kw))
    g = convert.solution_to_numpy(sol)
    for i in range(psi.shape[0]):
        xw = np.concatenate([psi[i].real, psi[i].imag])
        ref = oracle.solve_linear_rkf45(M0, xw, 0.0, 1.0, 1e-3,
                                        strict_end=True, **kw)
        assert g["status"][i] == ref["status"] == vt.DONE
        assert g["n_accept"][i] == ref["n_accept"]
        assert g["n_reject"][i] == ref["n_reject"]
        assert g["n_iters"][i] == len(ref["events"])
        y = np.concatenate([g["y_final"].re[i], g["y_final"].im[i]])
        np.testing.assert_allclose(y, ref["y_final"], rtol=0, atol=1e-10)
        np.testing.assert_allclose(g["t_final"][i], ref["t_final"],
                                   rtol=1e-15)


def test_step_once_event_sequence_matches_jax():
    """Iteration by iteration, the batched driver takes the same branch
    (accept / reject / grid hit / end) with the same t and h."""
    import functools

    import jax

    from vec_ode_tpu import driver as jd
    from vec_ode_tpu_torch import driver as td

    model, M0, M1, psi = _problem(4, d=8)
    jst = JStepper(M0=M0, M1=M1, u_fn=lambda t: jnp.cos(model.w * t),
                   use_pallas=False)
    st = convert.stepper_from_numpy(M0, M1, model.w, device="cpu")
    kw = dict(rtol=1e-8, max_dt=0.25)
    jstep = jax.jit(functools.partial(
        jd.step_once, step_fn=jst.make_step_fn(), adaptive=True,
        ctl=vo.StepControl(**kw), error_norm=jst.error_norm, batched=True))
    grid = (0.0, 0.3, 1.0)
    js = jd.init_state(jcp.from_complex(psi, jnp.float64),
                       jnp.asarray(grid), 1e-3, batch_shape=(4,))
    ts = td.init_state(convert.state_from_numpy(psi.real, psi.imag,
                                                device="cpu"),
                       torch.tensor(grid, dtype=torch.float64), 1e-3,
                       batch_shape=(4,))
    tstep = st.make_step_fn()
    for _ in range(200):
        js = jstep(js)
        ts = td.step_once(ts, tstep, adaptive=True,
                          ctl=vt.StepControl(**kw), error_norm=st.error_norm)
        for k in ("last_event", "status", "tgt_idx", "n_accept",
                  "n_reject", "reject_streak"):
            np.testing.assert_array_equal(getattr(ts, k).numpy(),
                                          np.asarray(getattr(js, k)),
                                          err_msg=k)
        # h, and so t between grid points, carry the err norm's last
        # digits (see test_f64_parity_with_jax)
        np.testing.assert_allclose(ts.t.numpy(), np.asarray(js.t),
                                   rtol=1e-9)
        np.testing.assert_allclose(ts.h.numpy(), np.asarray(js.h),
                                   rtol=1e-9)
        if not bool((ts.status == vt.RUNNING).any()):
            break
    assert (ts.status == vt.DONE).all()
    np.testing.assert_allclose(ts.ys.re.numpy(), np.asarray(js.ys.re),
                               rtol=0, atol=1e-12)


def test_lc_helpers_match_jax():
    from vec_ode_tpu import lc as jlc
    from vec_ode_tpu_torch import lc as tlc
    from vec_ode_tpu_torch.ops.cplx import Cplx

    rng = np.random.default_rng(9)
    re, im = rng.standard_normal((2, 5, 3))
    mask = rng.integers(0, 2, 5).astype(bool)
    jx = jcp.Cplx(jnp.asarray(re), jnp.asarray(im))
    tx = Cplx(torch.as_tensor(re), torch.as_tensor(im))
    np.testing.assert_allclose(float(tlc.norm_l2(tx)),
                               float(jlc.norm_l2(jx)), rtol=1e-15)
    np.testing.assert_allclose(tlc.norm_l2_batched(tx).numpy(),
                               np.asarray(jlc.norm_l2_batched(jx)),
                               rtol=1e-15)
    sel = tlc.tree_where(torch.as_tensor(mask), tx,
                         Cplx(torch.zeros(5, 3, dtype=torch.float64),
                              torch.ones(5, 3, dtype=torch.float64)))
    want = jlc.tree_where(jnp.asarray(mask), jx,
                          jcp.Cplx(jnp.zeros((5, 3)), jnp.ones((5, 3))))
    assert isinstance(sel, Cplx)
    np.testing.assert_array_equal(sel.re.numpy(), np.asarray(want.re))
    np.testing.assert_array_equal(sel.im.numpy(), np.asarray(want.im))
    with pytest.raises(ValueError, match="lower rank"):
        tlc.tree_where(torch.ones(5, 3, dtype=torch.bool), torch.zeros(5),
                       torch.zeros(5))


@pytest.mark.parametrize("kind,weighted", [("l2", True), ("rms", False),
                                           ("max", True)])
def test_declared_norm_parity_with_jax_f64(kind, weighted):
    """error_norm=WeightedNorm on both sides (the driver tier: XLA driver
    there, the port's host driver here): the same steps per trajectory."""
    from vec_ode_tpu import lc as jlc
    from vec_ode_tpu_torch import lc as tlc

    d = 16
    model, M0, M1, psi = _problem(12, d=d)
    weights = tuple(np.linspace(0.5, 2.0, d)) if weighted else None
    kw = dict(rtol=1e-8, min_dt=1e-6, max_dt=0.25)
    jst = JStepper(M0=M0, M1=M1, u_fn=lambda t: jnp.cos(model.w * t),
                   use_pallas=False)
    want = jax_ensemble_solve(
        None, jcp.from_complex(psi, jnp.float64), 0.0, 1.0, stepper=jst,
        ctl=vo.StepControl(**kw), h0=1e-3, save_at=(0.5,),
        error_norm=jlc.WeightedNorm(kind, weights))
    got = ensemble_solve(
        None, convert.state_from_numpy(psi.real, psi.imag, device="cpu"),
        0.0, 1.0, stepper=convert.stepper_from_numpy(M0, M1, model.w,
                                                      device="cpu"),
        ctl=vt.StepControl(**kw), h0=1e-3, save_at=(0.5,),
        error_norm=tlc.WeightedNorm(kind, weights))
    assert got.path == "torch-driver"
    g = convert.solution_to_numpy(got)
    assert (g["status"] == vt.DONE).all()
    for k in COUNTERS:
        np.testing.assert_array_equal(g[k], np.asarray(getattr(want, k)),
                                      err_msg=k)
    for part in ("re", "im"):
        np.testing.assert_allclose(getattr(g["ys"], part),
                                   np.asarray(getattr(want.ys, part)),
                                   rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(g["h_final"], np.asarray(want.h_final),
                               rtol=1e-9)
    # a different norm than the stepper's own raises; so does scaled_error
    st = convert.stepper_from_numpy(M0, M1, model.w, device="cpu")
    y0 = convert.state_from_numpy(psi.real, psi.imag, device="cpu")
    st = dataclasses.replace(st, norm=tlc.WeightedNorm("l2"))
    with pytest.raises(ValueError, match="different norm"):
        ensemble_solve(None, y0, 0.0, 1.0, stepper=st, h0=1e-3,
                       error_norm=tlc.WeightedNorm("max"))
    with pytest.raises(ValueError, match="mutually exclusive"):
        ensemble_solve(None, y0, 0.0, 1.0, stepper=st, h0=1e-3,
                       error_norm=tlc.WeightedNorm("l2"),
                       ctl=vt.StepControl(scaled_error=True))

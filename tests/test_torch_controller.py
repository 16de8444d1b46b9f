"""Controller and time arithmetic of the port against the JAX package:
the same decisions on the same arrays, NaN / inf / zero errors included."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vec_ode_tpu import controller as jc
from vec_ode_tpu import driver as jd
from vec_ode_tpu_torch import controller as tc
from vec_ode_tpu_torch import driver as td

torch.set_num_threads(1)

TORCH = {np.float32: torch.float32, np.float64: torch.float64}


def _inputs(dtype):
    """Random step sizes and error norms spanning accepts and rejects
    around rtol, plus the special values the guards handle."""
    rng = np.random.default_rng(0)
    n = 200
    h = 10.0 ** rng.uniform(-6, 0, n)
    err = 10.0 ** rng.uniform(-14, 0, n)
    prev = 10.0 ** rng.uniform(-14, 0, n)
    special = np.array([0.0, np.nan, np.inf, 1e-4, 1e-300, 0.0, np.nan])
    err[: len(special)] = special
    prev[3: 3 + len(special)] = special
    prev_rej = rng.integers(0, 2, n).astype(bool)
    return (h.astype(dtype), err.astype(dtype), prev.astype(dtype),
            prev_rej)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("pi,rejected", [
    (False, "mask"), (True, None), (True, "mask"), (True, "all"),
    (True, "none"),
])
def test_controller_update_matches_jax(dtype, pi, rejected):
    h, err, prev, prev_rej = _inputs(dtype)
    if rejected == "all":
        prev_rej = np.ones_like(prev_rej)
    elif rejected == "none":
        prev_rej = np.zeros_like(prev_rej)
    ctl_kw = dict(rtol=1e-4, pi=pi)
    jh, jacc = jc.controller_update(
        jnp.asarray(h), jnp.asarray(err), jc.StepControl(**ctl_kw),
        prev_err_norm=jnp.asarray(prev),
        prev_rejected=None if rejected is None else jnp.asarray(prev_rej))
    th, tacc = tc.controller_update(
        torch.as_tensor(h), torch.as_tensor(err), tc.StepControl(**ctl_kw),
        prev_err_norm=torch.as_tensor(prev),
        prev_rejected=None if rejected is None else torch.as_tensor(
            prev_rej))
    assert th.dtype == TORCH[dtype]
    np.testing.assert_array_equal(tacc.numpy(), np.asarray(jacc))
    # pow comes from two libm builds: one ulp apart at most
    np.testing.assert_array_max_ulp(th.numpy(), np.asarray(jh), maxulp=1)


@pytest.mark.parametrize("kw", [
    dict(rtol=0.0), dict(atol=-1.0), dict(min_dt=0.0),
    dict(min_dt=0.5, max_dt=0.5), dict(min_dt=0.5, max_dt=0.1),
])
def test_step_control_validation(kw):
    with pytest.raises(ValueError):
        jc.StepControl(**kw)
    with pytest.raises(ValueError):
        tc.StepControl(**kw)


def test_step_control_defaults_match():
    assert tc.StepControl() == tc.StepControl(
        **{f: getattr(jc.StepControl(), f)
           for f in jc.StepControl.__dataclass_fields__})
    assert tc.StepControl().init_h() == jc.StepControl().init_h()
    assert tc.StepControl().time_compensated is True


@pytest.mark.parametrize("h0", [1e-7, 2.0, float("nan"), [1e-3, 5.0]])
def test_check_h0_rejects_out_of_range(h0):
    ctl = tc.StepControl()
    with pytest.raises(ValueError):
        tc.check_h0(h0, ctl, adaptive=True)
    assert tc.check_h0(h0, ctl, adaptive=False) is h0
    assert tc.check_h0(None, ctl, True) == jc.check_h0(None,
                                                       jc.StepControl(), True)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("strict", [False, True])
def test_end_tolerance_matches_jax(dtype, strict):
    t = np.array([0.0, 0.5, 1.0, -3.0, 7.25, 1e6, -1e12], dtype)
    want = np.asarray(jc.end_tolerance(jnp.asarray(t), strict))
    got = tc.end_tolerance(torch.as_tensor(t), strict).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_comp_time_advance_bitwise(dtype):
    rng = np.random.default_rng(1)
    n = 64
    dts = rng.uniform(1e-4, 3e-2, (300, n)).astype(dtype)
    jt_, jlo = jnp.zeros(n, dtype), jnp.zeros(n, dtype)
    tt_, tlo = torch.zeros(n, dtype=TORCH[dtype]), torch.zeros(
        n, dtype=TORCH[dtype])
    for row in dts:
        jt_, jlo = jd.comp_time_advance(jt_, jlo, jnp.asarray(row))
        tt_, tlo = td.comp_time_advance(tt_, tlo, torch.as_tensor(row))
    itype = np.int32 if dtype == np.float32 else np.int64
    np.testing.assert_array_equal(tt_.numpy().view(itype),
                                  np.asarray(jt_).view(itype))
    np.testing.assert_array_equal(tlo.numpy().view(itype),
                                  np.asarray(jlo).view(itype))

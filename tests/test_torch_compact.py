"""Straggler accounting, compaction and placement of the port
(``parallel.step_efficiency``, ``ensemble_solve_compact``,
``cost_sorted_permutation``, ``inverse_permutation``): the cases of
tests/test_ensemble.py, tests/test_placement.py (single host: shards are
an accounting of the batch axis) and tests/test_r3_review.py, each held
against the JAX package in f64 on the CPU, the stats too."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vec_ode_tpu as vo
from vec_ode_tpu import exp as jexp
from vec_ode_tpu import lc as jlc
from vec_ode_tpu import parallel as jpar
from vec_ode_tpu.models import DrivenDense as JDrivenDense
from vec_ode_tpu.ops import cplx as jcp
from vec_ode_tpu.tableaus import DOPRI5 as JDOPRI5
import vec_ode_tpu_torch as vt
from vec_ode_tpu_torch import exp as texp
from vec_ode_tpu_torch import lc
from vec_ode_tpu_torch.models import DrivenDense
from vec_ode_tpu_torch.ops import fused_rk
from vec_ode_tpu_torch.ops.cplx import Cplx, from_complex
from vec_ode_tpu_torch.parallel import (cost_sorted_permutation,
                                        ensemble_solve,
                                        ensemble_solve_compact,
                                        inverse_permutation, step_efficiency)

torch.set_num_threads(1)

SZ = np.asarray([[0.5, 0.0], [0.0, -0.5]])
SX = np.asarray([[0.0, 0.5], [0.5, 0.0]])


def _counters(sol):
    return [np.asarray(getattr(sol, k)) for k in
            ("status", "n_accept", "n_reject", "n_iters")]


def _same_counters(a, b):
    for x, y in zip(_counters(a), _counters(b)):
        np.testing.assert_array_equal(x, y)


def test_step_efficiency_counter():
    """A heterogeneous ensemble: efficiency < 1, the analytic ratio, and
    the JAX package's."""
    rates = [0.5, 1.0, 4.0, 16.0]
    sol = ensemble_solve(lambda t, y, r: -r * y,
                         torch.ones(4, 1, dtype=torch.float64), 0.0, 1.0,
                         params=torch.tensor(rates, dtype=torch.float64),
                         ctl=vt.StepControl(rtol=1e-8), h0=1e-3)
    jsol = jpar.ensemble_solve(lambda t, y, r: -r * y, jnp.ones((4, 1)),
                               0.0, 1.0, params=jnp.asarray(rates),
                               ctl=vo.StepControl(rtol=1e-8), h0=1e-3)
    ni = sol.n_iters.numpy()
    eff = float(step_efficiency(sol))
    assert abs(eff - ni.sum() / (ni.max() * len(ni))) < 1e-12
    assert eff < 0.9
    assert eff == pytest.approx(float(jpar.step_efficiency(jsol)), abs=1e-12)
    per = step_efficiency(sol, n_shards=2, per_shard=True)
    np.testing.assert_allclose(per.numpy(), np.asarray(
        jpar.step_efficiency(jsol, n_shards=2, per_shard=True)), rtol=1e-12)


def _lz_rhs(t, y):
    psi, v = y
    H = (torch.as_tensor(SZ, dtype=psi.re.dtype) * (v[0] * t)
         + 0.4 * torch.as_tensor(SX, dtype=psi.re.dtype))
    return (Cplx(H @ psi.im, -(H @ psi.re)), torch.zeros_like(v))


def _jlz_rhs(t, y):
    psi, v = y
    H = jnp.asarray(SZ) * (v[0] * t) + 0.4 * jnp.asarray(SX)
    return (jcp.Cplx(H @ psi.im, -(H @ psi.re)), jnp.zeros_like(v))


LZ_B = 32
LZ_KW = dict(h0=1e-2, chunk_iters=16, min_batch=1, bucket_multiple=1)
# the JAX side compiles a loop per bucket size: buckets of 8 keep it to four
LZ_JAX_KW = dict(LZ_KW, bucket_multiple=8)


def _lz_y0():
    psi0 = np.zeros((LZ_B, 2), np.complex128)
    psi0[:, 0] = 1.0
    return psi0, np.linspace(0.5, 8.0, LZ_B)


@functools.cache
def _jax_lz_compact():
    psi0, vs = _lz_y0()
    y0 = (jcp.from_complex(psi0, jnp.float64), jnp.asarray(vs)[:, None])
    ctl = vo.StepControl(rtol=1e-6, min_dt=1e-6, max_dt=0.5, max_steps=20000)
    sol, stats = jpar.ensemble_solve_compact(_jlz_rhs, y0, -8.0, 8.0,
                                             ctl=ctl, **LZ_JAX_KW)
    return _counters(sol), np.asarray(sol.y_final[0].re), stats


def test_ensemble_solve_compact_matches_and_improves():
    """Compaction: the plain path's trajectories, a higher efficiency, and
    the JAX package's counters, states and stats."""
    psi0, vs = _lz_y0()
    y0 = (from_complex(psi0, device="cpu"),
          torch.as_tensor(vs)[:, None])
    ctl = vt.StepControl(rtol=1e-6, min_dt=1e-6, max_dt=0.5,
                         max_steps=20000)
    plain = ensemble_solve(_lz_rhs, y0, -8.0, 8.0, ctl=ctl, h0=1e-2)
    sol, stats = ensemble_solve_compact(_lz_rhs, y0, -8.0, 8.0, ctl=ctl,
                                        **LZ_KW)
    assert bool((sol.status == vt.DONE).all())
    _same_counters(sol, plain)
    np.testing.assert_allclose(sol.y_final[0].re.numpy(),
                               plain.y_final[0].re.numpy(), rtol=0,
                               atol=5e-14)
    assert stats["efficiency"] > float(step_efficiency(plain))
    assert stats["efficiency"] > 0.97
    jc, jyre, jstats = _jax_lz_compact()
    sol8, stats8 = ensemble_solve_compact(_lz_rhs, y0, -8.0, 8.0, ctl=ctl,
                                          **LZ_JAX_KW)
    for s in (sol, sol8):
        for x, y in zip(_counters(s), jc):
            np.testing.assert_array_equal(x, y)
        np.testing.assert_allclose(s.y_final[0].re.numpy(), jyre,
                                   atol=1e-12)
    assert stats8 == jstats


def test_compact_with_fsal_stepper():
    """The FSAL carry is seeded per trajectory and carried through the
    compaction: the plain path's counters and states, bit for bit."""
    rates = torch.tensor([0.5, 1.0, 3.0, 9.0], dtype=torch.float64)
    y0 = (torch.ones(4, 1, dtype=torch.float64), rates[:, None])

    def rhs(t, y):
        x, r = y
        return (-r * x, torch.zeros_like(r))

    st = vt.RungeKutta(vt.DOPRI5, advance_lower=False)
    assert st.has_carry
    ctl = vt.StepControl(rtol=1e-8, min_dt=1e-8, max_dt=0.5)
    sol, _ = ensemble_solve_compact(rhs, y0, 0.0, 1.0, stepper=st, ctl=ctl,
                                    h0=1e-2, chunk_iters=16, min_batch=1,
                                    bucket_multiple=1)
    plain = ensemble_solve(rhs, y0, 0.0, 1.0, stepper=st, ctl=ctl, h0=1e-2)
    assert bool((sol.status == vt.DONE).all())
    _same_counters(sol, plain)
    assert torch.equal(sol.y_final[0], plain.y_final[0])
    jst = vo.RungeKutta(JDOPRI5, advance_lower=False)
    jsol, _ = jpar.ensemble_solve_compact(
        lambda t, y: (-y[1] * y[0], jnp.zeros_like(y[1])),
        (jnp.ones((4, 1)), jnp.asarray(rates.numpy())[:, None]), 0.0, 1.0,
        stepper=jst, ctl=vo.StepControl(rtol=1e-8, min_dt=1e-8, max_dt=0.5),
        h0=1e-2, chunk_iters=16, min_batch=1, bucket_multiple=1)
    np.testing.assert_array_equal(sol.n_accept.numpy(),
                                  np.asarray(jsol.n_accept))


def test_compact_custom_norm_is_per_trajectory():
    """An opaque error norm is applied per lane: the ensemble_solve's
    counters and states with the same norm, and the JAX package's."""
    def rhs(t, y):
        return -y * (1.0 + 0.5 * torch.sin(t))

    y0 = np.random.default_rng(5).uniform(0.5, 2.0, (12, 3))
    ctl = vt.StepControl(rtol=1e-7, min_dt=1e-7, max_dt=0.5, max_steps=4000)
    sol = ensemble_solve(rhs, torch.as_tensor(y0), 0.0, 2.0, ctl=ctl,
                         error_norm=lc.norm_rms)
    sol_c, _ = ensemble_solve_compact(rhs, torch.as_tensor(y0), 0.0, 2.0,
                                      ctl=ctl, error_norm=lc.norm_rms)
    assert bool((sol_c.status == vt.DONE).all())
    _same_counters(sol_c, sol)
    np.testing.assert_allclose(sol_c.y_final.numpy(), sol.y_final.numpy(),
                               rtol=1e-12)
    jsol, _ = jpar.ensemble_solve_compact(
        lambda t, y: -y * (1.0 + 0.5 * jnp.sin(t)), jnp.asarray(y0), 0.0,
        2.0, ctl=vo.StepControl(rtol=1e-7, min_dt=1e-7, max_dt=0.5,
                                max_steps=4000), error_norm=jlc.norm_rms)
    np.testing.assert_array_equal(sol_c.n_accept.numpy(),
                                  np.asarray(jsol.n_accept))


def test_compact_validates_h0_range():
    with pytest.raises(ValueError, match="not inside the range"):
        ensemble_solve_compact(lambda t, y: -y,
                               torch.ones(4, 2, dtype=torch.float64), 0.0,
                               1.0, h0=5.0, ctl=vt.StepControl(max_dt=1.0))


def _psi(B, d, seed):
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((B, d)) + 1j * rng.standard_normal((B, d))
    return z / np.linalg.norm(z, axis=-1, keepdims=True)


def test_compact_with_batched_dense_stepper():
    """The natively batched generic stepper (norm-returning) under
    compaction: ensemble_solve's counters lane for lane, and the JAX
    package's."""
    model = DrivenDense.make(d=8, seed=0)
    psi = _psi(12, 8, 5)
    ctl = vt.StepControl(rtol=1e-6, max_dt=0.25, max_steps=100000)
    kw = dict(stepper=texp.Magnus4(texp.DenseCplxSplit()), ctl=ctl, h0=1e-2)
    op = lambda t: model.op_pair(t, torch.float64, device="cpu")  # noqa
    y0 = from_complex(psi, device="cpu")
    sol_c, stats = ensemble_solve_compact(op, y0, 0.0, 0.4, chunk_iters=8,
                                          min_batch=4, bucket_multiple=4,
                                          **kw)
    sol_p = ensemble_solve(op, y0, 0.0, 0.4, **kw)
    assert stats["efficiency"] > 0 and sol_c.path == "torch-driver"
    _same_counters(sol_c, sol_p)
    np.testing.assert_allclose(sol_c.y_final.re.numpy(),
                               sol_p.y_final.re.numpy(), atol=1e-12)
    jmodel = JDrivenDense.make(d=8, seed=0)
    jsol, jstats = jpar.ensemble_solve_compact(
        lambda t: jmodel.op_pair(t, jnp.float64),
        jcp.from_complex(psi, jnp.float64), 0.0, 0.4,
        stepper=jexp.Magnus4(jexp.DenseCplxSplit()),
        ctl=vo.StepControl(rtol=1e-6, max_dt=0.25, max_steps=100000),
        h0=1e-2, time_dtype=jnp.float64, chunk_iters=8, min_batch=4,
        bucket_multiple=4)
    np.testing.assert_array_equal(sol_c.n_accept.numpy(),
                                  np.asarray(jsol.n_accept))
    np.testing.assert_allclose(sol_c.y_final.re.numpy(),
                               np.asarray(jsol.y_final.re), atol=1e-10)
    assert stats == jstats


def test_compact_main_path_stepper_is_bitwise():
    """The RK main path's stepper under compaction (one step an
    iteration on the compacted batch; on CPU tensors the twin): bitwise
    ensemble_solve's per-step path, padding lanes frozen."""
    model = DrivenDense.make(d=8, seed=0)
    st = fused_rk.FusedModulatedLinearRK.from_driven_dense(
        model, torch.float64, device="cpu")
    psi = _psi(40, 8, 0) * np.linspace(0.1, 4.0, 40)[:, None]
    y0 = from_complex(psi, device="cpu")
    ctl = vt.StepControl(rtol=1e-8, min_dt=1e-6, max_dt=0.25)
    plain = ensemble_solve(None, y0, 0.0, 1.0, stepper=st, ctl=ctl, h0=1e-3)
    before = fused_rk.fused_rk_step.launches
    sol, stats = ensemble_solve_compact(None, y0, 0.0, 1.0, stepper=st,
                                        ctl=ctl, h0=1e-3, chunk_iters=8,
                                        min_batch=3, bucket_multiple=3)
    assert fused_rk.fused_rk_step.launches == before
    _same_counters(sol, plain)
    for a, b in ((sol.y_final.re, plain.y_final.re),
                 (sol.t_final, plain.t_final), (sol.h_final, plain.h_final)):
        assert torch.equal(a, b)
    assert stats["useful_lane_iters"] == int(plain.n_iters.sum())
    assert stats["efficiency"] >= float(step_efficiency(plain))


def _placement_solve(psi, vs):
    sol = ensemble_solve(
        lambda t, y, v: Cplx(
            (torch.as_tensor(SZ) * (v * t) + 0.4 * torch.as_tensor(SX))
            @ y.im,
            -((torch.as_tensor(SZ) * (v * t) + 0.4 * torch.as_tensor(SX))
              @ y.re)),
        from_complex(psi, device="cpu"), -8.0, 8.0,
        ctl=vt.StepControl(rtol=1e-4, min_dt=1e-5, max_dt=0.5,
                           max_steps=100000), h0=1e-2,
        params=torch.as_tensor(vs))
    return sol


def test_cost_sorted_placement_beats_adversarial():
    """Sorting by a cost proxy makes contiguous shards homogeneous: the
    per-shard efficiency (8 shards of the batch axis) rises, and the
    un-permuted lanes are the unsorted run's; the JAX package's counters
    on the same lanes."""
    n_sh, B = 8, 64
    vs = np.random.default_rng(0).permutation(np.linspace(0.4, 8.0, B))
    psi = np.zeros((B, 2), np.complex128)
    psi[:, 0] = 1.0
    bad = _placement_solve(psi, vs)
    eff_bad = float(step_efficiency(bad, n_shards=n_sh))
    assert step_efficiency(bad, n_shards=n_sh, per_shard=True).shape == (
        n_sh,)
    perm = cost_sorted_permutation(-vs)
    np.testing.assert_array_equal(perm, jpar.cost_sorted_permutation(-vs))
    srt = _placement_solve(psi[perm], vs[perm])
    eff_srt = float(step_efficiency(srt, n_shards=n_sh))
    assert eff_srt >= 0.9 and eff_srt > eff_bad + 0.05, (eff_srt, eff_bad)
    inv = inverse_permutation(perm)
    np.testing.assert_array_equal(srt.n_iters.numpy()[inv],
                                  bad.n_iters.numpy())
    np.testing.assert_allclose(srt.y_final.re.numpy()[inv],
                               bad.y_final.re.numpy(), atol=1e-12)


@pytest.mark.parametrize("as_tensor", [False, True])
def test_inverse_permutation_roundtrip(as_tensor):
    rng = np.random.default_rng(1)
    perm = rng.permutation(17)
    inv = inverse_permutation(torch.as_tensor(perm) if as_tensor else perm)
    np.testing.assert_array_equal(inv, jpar.inverse_permutation(perm))
    x = rng.standard_normal(17)
    np.testing.assert_array_equal(x[perm][inv], x)
    cost = torch.as_tensor(rng.standard_normal(17))
    np.testing.assert_array_equal(cost_sorted_permutation(cost),
                                  np.argsort(cost.numpy(), kind="stable"))

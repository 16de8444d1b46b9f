"""The port's sharded ensembles (``ensemble_solve(..., mesh=)``,
``ensemble_mesh``, ``shard_batch``, ``step_efficiency`` over a sharded
Solution) in one 4-process gloo world (``tests/torch_mesh_ranks.py``,
launched once for this file; the ranks import neither jax nor the JAX
package), held against the JAX package's sharded ensembles on
``ensemble_mesh(4)`` of its 8 virtual CPU devices, in f64 on the same
numpy inputs.

The gate: status and every counter equal per trajectory, y_final within
1e-12, h_final within ROADMAP queue 3's measured limits (``H_FINAL``);
every batched field of the port's Solution a DTensor sharded on dim 0; each
rank's rows bit for bit the port's unsharded ``ensemble_solve`` of the
same rows, on the same route."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_mesh_ranks as ranks
import vec_ode_tpu as vo
from vec_ode_tpu import diff as jdiff
from vec_ode_tpu import exp as vexp
from vec_ode_tpu.events import Event, EventConfig
from vec_ode_tpu.models import DrivenDense
from vec_ode_tpu.ops import cplx as cp
from vec_ode_tpu.ops.pallas_rk import FusedModulatedLinearRK
from vec_ode_tpu.parallel import (ensemble_mesh, ensemble_solve,
                                  shard_batch, step_efficiency)

jax.config.update("jax_enable_x64", True)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = ranks.World("mesh", tmp_path_factory.mktemp("mesh_world"))
    yield w
    w.close()


@functools.cache
def mesh4():
    return ensemble_mesh(4)


def _solve(f, y0, t0, tf, **kw):
    mesh = mesh4()
    for k in ("params", "h0"):
        if k in kw and np.ndim(kw[k]):
            kw[k] = shard_batch(kw[k], mesh)
    return ensemble_solve(f, shard_batch(y0, mesh), t0, tf, mesh=mesh, **kw)


CTL8 = vo.StepControl(rtol=1e-8)


def _rhs_projectile(t, s):
    v = jnp.sqrt(s[2] ** 2 + s[3] ** 2)
    return jnp.stack([s[2], s[3], -ranks.DRAG * v * s[2],
                      -ranks.G - ranks.DRAG * v * s[3]])


def _lz_op(t, v):
    sz = jnp.asarray([[0.5, 0.0], [0.0, -0.5]], jnp.float64)
    sx = jnp.asarray([[0.0, 0.5], [0.5, 0.0]], jnp.float64)
    H = v * t * sz + 0.4 * sx
    return cp.Cplx(jnp.zeros_like(H), -H)


def _cplx(z):
    return cp.from_complex(z, jnp.float64)


def _jax_cases():
    d7 = DrivenDense.make(d=8, seed=7)
    rk = FusedModulatedLinearRK.from_driven_dense(
        DrivenDense.make(d=8, seed=9), jnp.float64)
    rk = FusedModulatedLinearRK(M0=rk.M0, M1=rk.M1, u_fn=rk.u_fn,
                                use_pallas=False)
    rates, h0 = ranks.rates_and_h0()
    psi_lz = np.zeros((16, 2), complex)
    psi_lz[:, 0] = 1.0
    return {
        "decay": lambda: _solve(lambda t, y: -y,
                                jnp.asarray(ranks.decay_y0()), 0.0, 1.0,
                                ctl=CTL8, h0=1e-2),
        "pair": lambda: _solve(
            lambda t, y: d7.rhs_pair(t, y, dtype=jnp.float64),
            _cplx(ranks.unit_states(64, 8, 1)), 0.0, 0.5, ctl=CTL8,
            h0=1e-2),
        "fused_rk": lambda: _solve(
            None, _cplx(ranks.unit_states(16, 8, 6)), 0.0, 0.3, stepper=rk,
            ctl=vo.StepControl(rtol=1e-8, max_dt=0.25),
            h0=jnp.full((16,), 0.02, jnp.float64), time_dtype=jnp.float64),
        "magnus_loop": lambda: _solve(
            None, _cplx(ranks.unit_states(16, 8, 0)), 0.0, 0.5,
            stepper=vexp.MagnusModulated4(
                DrivenDense.make(d=8, seed=5).modulated(jnp.float64),
                use_pallas=False),
            ctl=vo.StepControl(rtol=1e-8, min_dt=1e-6, max_dt=0.2),
            h0=1e-2, time_dtype=jnp.float64),
        "generic": lambda: _solve(
            lambda t: d7.op_pair(t, jnp.float64),
            _cplx(ranks.unit_states(16, 8, 2)), 0.0, 0.5,
            stepper=vexp.Magnus4(vexp.DenseCplxSplit()),
            ctl=vo.StepControl(rtol=1e-8, min_dt=1e-6, max_dt=0.2),
            h0=1e-2, time_dtype=jnp.float64),
        "params_h0": lambda: _solve(
            lambda t, y, p: p * y, jnp.ones((16, 2), jnp.float64), 0.0, 1.0,
            ctl=CTL8, params=jnp.asarray(rates), h0=jnp.asarray(h0)),
        "params_exp": lambda: _solve(
            _lz_op, _cplx(psi_lz), -6.0, 6.0,
            stepper=vexp.ExpMidpoint(vexp.DenseCplxSplit()), adaptive=False,
            h0=0.05, params=jnp.asarray(ranks.lz_sweeps())),
        "events": lambda: _solve(
            _rhs_projectile, jnp.asarray(ranks.launch_states()), 0.0, 20.0,
            ctl=vo.StepControl(rtol=1e-8, max_steps=400),
            events=EventConfig(events=(Event(lambda t, s: s[1], direction=-1,
                                             terminal=True),), t_tol=1e-9)),
    }


@functools.cache
def jax_solution(case):
    sol = _jax_cases()[case]()
    assert not jax.tree_util.tree_leaves(sol.y_final)[0].is_fully_replicated
    out = {}
    for k in ranks.FIELDS:
        v = getattr(sol, k, None)
        if v is not None:
            out.update(ranks.flat(k, jax.tree_util.tree_map(np.asarray, v)))
    out["path"] = sol.path
    return out


COUNTERS = ("status", "n_accept", "n_reject", "n_iters")
# ROADMAP queue 3's measured limits: h_final follows the cancelling error
# sum (rtol 1e-9), and its relative difference grows as eps / rtol:
# H_FINAL_TIGHT (3e-8) after an event search, H_FINAL_PAIRS (2e-7) for the
# Magnus-4 error pairs (tests/test_torch_rk.py)
H_FINAL = {"events": 3e-8, "magnus_loop": 2e-7, "generic": 2e-7}
ROUTES = {"decay": "torch-driver", "pair": "torch-driver",
          "fused_rk": "torch-driver", "magnus_loop": "torch-loop",
          "generic": "torch-driver", "params_h0": "torch-driver",
          "params_exp": "torch-driver", "events": "torch-driver"}


@pytest.mark.parametrize("case", sorted(ROUTES))
def test_sharded_ensemble_matches_jax(world, case):
    """Status and counters equal per trajectory, y_final to 1e-12, h_final
    to ``H_FINAL``, event times and states to 1e-10, against the JAX
    package's sharded solve of the same rows."""
    want = jax_solution(case)
    got = world.load(case)[0]
    for k in COUNTERS + ("event_found", "event_count"):
        if k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in ("y_final", "y_final.re", "y_final.im", "t_final"):
        if k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-12,
                                       err_msg=k)
    np.testing.assert_allclose(got["h_final"], want["h_final"],
                               rtol=H_FINAL.get(case, 1e-9))
    for k in ("event_t", "event_t_k", "event_y"):
        if k in want:
            fin = np.isfinite(want[k])
            np.testing.assert_array_equal(np.isfinite(got[k]), fin)
            np.testing.assert_allclose(got[k][fin], want[k][fin], rtol=0,
                                       atol=1e-10, err_msg=k)
    assert got["ts"].shape == want["ts"].shape


@pytest.mark.parametrize("case", sorted(ROUTES))
def test_shards_are_the_unsharded_solve_of_their_rows(world, case):
    """Every batched field comes back a DTensor sharded on dim 0; each
    rank's rows are bit for bit the port's unsharded ensemble_solve of the
    same rows, on the route the rank's own batch takes; every rank's full
    view is the same."""
    per_rank = world.load(case)
    for r, got in enumerate(per_rank):
        assert bool(got["sharded"]), r
        assert bool(got["same_bits"]), r
        assert str(got["path"]) == ROUTES[case], got["path"]
        assert int(got["n_local"]) == per_rank[0]["status"].shape[0] // 4
        for k, v in per_rank[0].items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_batch_must_divide_the_mesh(world):
    messages = [str(a["message"]) for a in world.load("divide")]
    assert all("divide" in m for m in messages), messages
    with pytest.raises(ValueError, match="divide"):
        ensemble_solve(lambda t, y: -y, jnp.ones((10, 2)), 0.0, 1.0,
                       mesh=mesh4(), h0=1e-2)


def test_ensemble_mesh_needs_enough_devices(world):
    """More devices than the world holds: mesh_2d's ValueError."""
    for got in world.load("divide"):
        assert str(got["too_many"]) == "need 8 devices, have 4"


def test_mesh_over_part_of_the_world(world):
    """ensemble_mesh(2) in the world of 4 (the JAX package's
    ensemble_mesh(2) of its 8 devices): ranks 0 and 1 solve, the others
    are refused."""
    mesh2 = ensemble_mesh(2)
    want = ensemble_solve(lambda t, y: -y,
                          shard_batch(jnp.asarray(ranks.decay_y0()[:16]),
                                      mesh2), 0.0, 1.0, ctl=CTL8, h0=1e-2,
                          mesh=mesh2)
    per_rank = world.load("sub_mesh")
    for r, got in enumerate(per_rank):
        assert bool(got["member"]) == (r < 2)
        if r < 2:
            np.testing.assert_array_equal(got["n_accept"],
                                          np.asarray(want.n_accept))
            np.testing.assert_allclose(got["y_final"],
                                       np.asarray(want.y_final), rtol=0,
                                       atol=1e-12)
        else:
            assert "not in the mesh" in str(got["message"])


def test_step_efficiency_of_a_sharded_solution_matches_jax(world):
    sol = ensemble_solve(lambda t, y, k: -k * y, jnp.ones((8, 1)), 0.0, 1.0,
                         params=jnp.asarray(ranks.stiff_rates()), ctl=CTL8,
                         h0=1e-3, mesh=mesh4())
    per = np.asarray(step_efficiency(sol, n_shards=4, per_shard=True))
    total = float(step_efficiency(sol, n_shards=4))
    for got in world.load("efficiency"):
        np.testing.assert_array_equal(got["n_iters"], np.asarray(sol.n_iters))
        np.testing.assert_allclose(got["per_shard"], per, rtol=1e-15)
        np.testing.assert_allclose(float(got["total"]), total, rtol=1e-15)
    assert total < 0.9


def test_adjoint_gradient_summed_over_ranks_matches_jax(world):
    """Data-parallel adjoint (``tests/test_adjoint.py:534``): each rank's
    value and gradient of ``diff.adjoint_solve`` on its rows, summed by an
    all-reduce, equal the replicated solve's and the JAX package's."""
    M, z, theta = ranks.adjoint_inputs()
    basis = cp.Cplx(jnp.asarray(M.real), jnp.asarray(M.imag))

    def coeff(t, th):
        return jnp.stack([jnp.ones_like(jnp.asarray(t)),
                          th[0] * jnp.cos(th[1] * t)], axis=-1)

    def loss(th, y):
        yf = jdiff.adjoint_solve(basis, coeff, th, y, 0.0, 1.0, 32, order=4,
                                 use_pallas=False)
        return jnp.sum(yf.re[:, 0] ** 2 + yf.im[:, 0] ** 2)

    y0 = _cplx(z)
    sh = NamedSharding(mesh4(), P("traj"))
    y0s = cp.Cplx(jax.device_put(y0.re, sh), jax.device_put(y0.im, sh))
    v, g = jax.jit(jax.value_and_grad(loss))(jnp.asarray(theta), y0s)
    want = np.concatenate([[float(v)], np.asarray(g)])
    for got in world.load("adjoint"):
        for k in ("summed", "replicated"):
            np.testing.assert_allclose(got[k][0], want[0], rtol=1e-12)
            np.testing.assert_allclose(got[k][1:], want[1:], rtol=1e-10)


def test_ranks_load_no_jax(world):
    for r, done in enumerate(world.done()):
        assert done == {"bad_modules": [], "failed": 0}, (r, done)

"""The port's state sharding (``parallel.state_parallel``:
``solve_linear_state_sharded``, ``ensemble_solve_state_sharded``,
``local_rows``, ``mesh_2d``) in one 4-process gloo world
(``tests/torch_mesh_ranks.py``, launched once for this file; the ranks
import neither jax nor the JAX package), held against the JAX package's
state-sharded solves on the same sharding of its 8 virtual CPU devices
(``tests/test_state_parallel.py:17,45,78,121``), in f64 on the same numpy
inputs: n_accept and n_reject equal (per trajectory), y_final within rtol
1e-12, h_final within rtol 1e-9 (ROADMAP queue 3's measured limit); and
lockstep: every rank of a state group returns the same status, counters,
t_final and h_final, bit for bit."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_mesh_ranks as ranks
import vec_ode_tpu as vo
from vec_ode_tpu.models import DrivenDense
from vec_ode_tpu.ops import cplx as cp
from vec_ode_tpu.parallel import (ensemble_mesh, ensemble_solve_state_sharded,
                                  local_rows, mesh_2d,
                                  solve_linear_state_sharded)

jax.config.update("jax_enable_x64", True)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = ranks.World("state", tmp_path_factory.mktemp("state_world"))
    yield w
    w.close()


def _assembly(d, seed):
    model = DrivenDense.make(d=d, seed=seed)
    return lambda t: cp.embed(model.op_pair(t, jnp.float64))


def _const4():
    A, y0 = ranks.const_problem(64, 11, 0)
    return solve_linear_state_sharded(
        jnp.asarray(A), jnp.asarray(y0), 0.0, 1.0,
        mesh=ensemble_mesh(4, axis="state"),
        ctl=vo.StepControl(rtol=1e-8, max_dt=0.5), h0=1e-2)


def _const2d():
    A, y0 = ranks.const_problem(32, 12, 1, B=6)
    return ensemble_solve_state_sharded(
        jnp.asarray(A), jnp.asarray(y0), 0.0, 1.0, mesh=mesh_2d(2, 2),
        ctl=vo.StepControl(rtol=1e-8, max_dt=0.5), h0=1e-2)


def _driven4():
    mesh = ensemble_mesh(4, axis="state")
    return solve_linear_state_sharded(
        local_rows(_assembly(8, 3), mesh),
        jnp.asarray(ranks.driven_states(8, None, 5)), 0.0, 1.0, mesh=mesh,
        ctl=vo.StepControl(rtol=1e-8, min_dt=1e-7, max_dt=0.2), h0=1e-2)


def _driven2d():
    mesh = mesh_2d(2, 2)
    return ensemble_solve_state_sharded(
        local_rows(_assembly(4, 4), mesh, axis="state"),
        jnp.asarray(ranks.driven_states(4, 8, 6)), 0.0, 0.7, mesh=mesh,
        ctl=vo.StepControl(rtol=1e-8, min_dt=1e-7, max_dt=0.2), h0=1e-2)


CASES = {"const4": _const4, "const2d": _const2d, "driven4": _driven4,
         "driven2d": _driven2d}
# rank = traj coordinate * 2 + state coordinate on the 2 x 2 mesh
STATE_GROUPS = {"const4": [[0, 1, 2, 3]], "driven4": [[0, 1, 2, 3]],
                "const2d": [[0, 1], [2, 3]], "driven2d": [[0, 1], [2, 3]]}
SCALARS = ("status", "n_accept", "n_reject", "n_iters", "t_final",
           "h_final")


@functools.cache
def jax_solution(case):
    sol = CASES[case]()
    return {k: np.asarray(getattr(sol, k)) for k in
            ("y_final", "ys", "ts") + SCALARS}


@pytest.mark.parametrize("case", sorted(CASES))
def test_state_sharded_matches_jax(world, case):
    want = jax_solution(case)
    got = world.load(case)[0]
    assert (got["status"] == vo.DONE).all()
    for k in ("status", "n_accept", "n_reject", "n_iters"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_allclose(got["y_final"], want["y_final"], rtol=1e-12,
                               atol=1e-14)
    np.testing.assert_allclose(got["ys"], want["ys"], rtol=1e-12,
                               atol=1e-14)
    np.testing.assert_allclose(got["h_final"], want["h_final"], rtol=1e-9)
    np.testing.assert_array_equal(got["t_final"], want["t_final"])
    assert got["ts"].shape == want["ts"].shape


@pytest.mark.parametrize("case", sorted(CASES))
def test_state_groups_run_in_lockstep(world, case):
    """The all-reduced norm gives every rank of a state group the same
    bits, so the same decisions: status, counters, t_final and h_final of
    its trajectories bit for bit, on every rank of the group; the state
    comes back sharded over the state axis (and the batch over traj)."""
    per_rank = world.load(case)
    two_d = case.endswith("2d")
    for group in STATE_GROUPS[case]:
        first = per_rank[group[0]]
        for r in group:
            for k in SCALARS:
                key = ("local." + k) if two_d else k
                np.testing.assert_array_equal(per_rank[r][key], first[key],
                                              err_msg=f"{case} rank {r} {k}")
    want = ("(Shard(dim=0), Shard(dim=1))" if two_d else "(Shard(dim=0),)")
    for got in per_rank:
        assert str(got["placements.y_final"]) == want
        assert str(got["placements.ys"]) == want.replace(
            "dim=1" if two_d else "dim=0", "dim=2" if two_d else "dim=1")


def test_mesh_2d_needs_enough_devices(world):
    for got in world.load("too_big"):
        assert str(got["message"]) == "need 16 devices, have 4"
    with pytest.raises(ValueError, match="devices"):
        mesh_2d(4, 4)


def test_ranks_load_no_jax(world):
    for r, done in enumerate(world.done()):
        assert done == {"bad_modules": [], "failed": 0}, (r, done)

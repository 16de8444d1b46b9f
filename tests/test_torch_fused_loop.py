"""The whole-loop path of the port (ops/fused_loop.py) on the CPU: the
plain twin of the CUDA loop kernel against the JAX package's Pallas loop
kernel (``pallas_loop.fused_loop_integrate`` over ``make_rk_step_builder``,
interpret mode, tile 8, unpacked) and against the port's own host driver,
in f64 on the same numpy inputs. The kernel against the twin on a card:
tests/test_torch_cuda.py."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vec_ode_tpu as vo
from vec_ode_tpu import lc as jlc
from vec_ode_tpu import tableaus as jtab
from vec_ode_tpu.models import DrivenDense as JDrivenDense
from vec_ode_tpu.ops import pallas_loop
from vec_ode_tpu.ops.pallas_rk import FusedModulatedLinearRK as JStepper
import vec_ode_tpu_torch as vt
from vec_ode_tpu_torch import driver, lc
from vec_ode_tpu_torch import tableaus as ttab
from vec_ode_tpu_torch.ops.cplx import Cplx
from vec_ode_tpu_torch.ops.fused_loop import (N_F, N_I, RKStep,
                                              fused_loop_chunk,
                                              fused_loop_integrate)
from vec_ode_tpu_torch.ops.fused_rk import FusedModulatedLinearRK

torch.set_num_threads(1)

B, D, TF = 16, 64, 0.3
BASE = dict(rtol=1e-8, min_dt=1e-6, max_dt=0.25, max_steps=2000)
WEIGHTS = tuple(np.linspace(0.5, 2.0, D))


@dataclasses.dataclass(frozen=True)
class Case:
    ctl: dict = dataclasses.field(default_factory=dict)
    grid: tuple = (0.0, TF)
    tab: str = "rkf45"
    advance_lower: bool = True
    h0_per_row: bool = False
    norm: tuple = None          # (kind, weights) of a WeightedNorm


CASES = {
    "plain": Case(),
    "save_grid": Case(grid=(0.0, 0.075, 0.15, 0.225, TF)),
    "pi": Case(ctl=dict(pi=True)),
    "scaled_error": Case(ctl=dict(scaled_error=True, rtol=1e-6, atol=1e-9)),
    "strict_end_test": Case(ctl=dict(strict_end_test=True),
                            grid=(0.0, 0.1, TF)),
    "plain_time": Case(ctl=dict(time_compensated=False),
                       grid=(0.0, 0.1, TF)),
    "weighted_l2": Case(norm=("l2", WEIGHTS)),
    "weighted_max": Case(norm=("max", None)),
    "dopri5": Case(tab="dopri5"),
    "advance_higher": Case(advance_lower=False),
    "h0_per_row": Case(h0_per_row=True),
    "max_steps": Case(ctl=dict(max_steps=6)),
    "stalled": Case(ctl=dict(max_reject_streak=2, rtol=1e-12)),
}
BOTH = [k for k in CASES if k != "scaled_error"]


def _inputs(case):
    jst = JStepper.from_driven_dense(JDrivenDense.make(d=D, seed=0),
                                     jnp.float64)
    M0, M1 = np.asarray(jst.M0), np.asarray(jst.M1)
    w = float(JDrivenDense.make(d=D, seed=0).w)
    rng = np.random.default_rng(11)
    psi = rng.standard_normal((B, D)) + 1j * rng.standard_normal((B, D))
    psi /= np.linalg.norm(psi, axis=-1, keepdims=True)
    h0 = (10.0 ** rng.uniform(-4, -1, B) if case.h0_per_row else 1e-3)
    if "max_reject_streak" in case.ctl:
        h0 = 0.2   # far too long at rtol 1e-12: rejects in a row
    return M0, M1, w, psi, h0


def _jax_loop(case):
    M0, M1, w, psi, h0 = _inputs(case)
    jctl = vo.StepControl(**{**BASE, **case.ctl})
    wnorm = consts_w = None
    if case.norm is not None:
        wnorm = jlc.WeightedNorm(*case.norm).kernel_parts(D, 2)
        if wnorm[0] is not None:
            consts_w = jnp.asarray(wnorm[0])
    builder = pallas_loop.make_rk_step_builder(
        jtab.TABLEAUS[case.tab], lambda t: jnp.cos(w * t),
        case.advance_lower,
        scaled=(jctl.atol, jctl.rtol) if jctl.scaled_error else None,
        wnorm=wnorm)
    consts = [jnp.asarray(M0), jnp.asarray(M1)]
    if consts_w is not None:
        consts.append(consts_w)
    fs, ist, parts, saves, _ = pallas_loop.fused_loop_integrate(
        jnp.asarray(case.grid), (jnp.asarray(psi.real), jnp.asarray(psi.imag)),
        jnp.asarray(h0), consts, builder, adaptive=True, ctl=jctl,
        persistent=True, tile=8, interpret=True, group=1)
    n_save = len(case.grid) - 2
    saves = np.stack([np.concatenate([np.asarray(saves[2 * g]),
                                      np.asarray(saves[2 * g + 1])], axis=1)
                      for g in range(n_save)]) if n_save else None
    x = np.concatenate([np.asarray(p) for p in parts], axis=1)
    return np.asarray(fs), np.asarray(ist), x, saves


def _step(case, M0, M1, w):
    tctl = vt.StepControl(**{**BASE, **case.ctl})
    wnorm = (None if case.norm is None
             else lc.WeightedNorm(*case.norm).kernel_parts(D, 2))
    return RKStep(M0=torch.as_tensor(M0), M1=torch.as_tensor(M1), w=w,
                  tableau=ttab.TABLEAUS[case.tab],
                  advance_lower=case.advance_lower,
                  scaled=(tctl.atol, tctl.rtol) if tctl.scaled_error
                  else None, wnorm=wnorm), tctl


def _twin_loop(case, **kw):
    M0, M1, w, psi, h0 = _inputs(case)
    step, tctl = _step(case, M0, M1, w)
    x0 = torch.as_tensor(np.concatenate([psi.real, psi.imag], axis=1))
    return fused_loop_integrate(
        torch.tensor(case.grid, dtype=torch.float64), x0,
        torch.as_tensor(h0, dtype=torch.float64), step, ctl=tctl, **kw)


# ist columns: tgt, status, event, n_acc, n_rej, n_it, streak, bits. The
# event column of a row that stopped before its tile's last iteration
# reads EVT_NONE, so it follows the tiling (JAX: tiles of 8; the twin: the
# whole batch) and is left out.
INT_COLS = [0, 1, 3, 4, 5, 6, 7]


@pytest.mark.parametrize("name", list(CASES))
def test_twin_matches_jax_loop_kernel_f64(name):
    case = CASES[name]
    jfs, jist, jx, jsaves = _jax_loop(case)
    fs, ist, x, saves = _twin_loop(case, persistent=True)
    np.testing.assert_array_equal(ist.numpy()[:, INT_COLS],
                                  jist[:, INT_COLS])
    want_status = {"max_steps": vt.ERR_MAX_STEPS,
                   "stalled": vt.ERR_STALLED}.get(name, vt.DONE)
    assert (ist[:, 1] == want_status).all(), ist[:, 1]
    # t, h, prev_h, err_norm, t_lo; x and the saves. The embedded error is
    # a cancelling sum whose last digits follow the matmul summation order
    # (BLAS here, the interpreted kernel's dot there): h, and so t between
    # grid points, carry ~1e-10 of it; the floor covers state components
    # near zero
    np.testing.assert_allclose(fs.numpy()[:, :2], jfs[:, :2], rtol=1e-9)
    np.testing.assert_allclose(x.numpy(), jx, rtol=1e-9, atol=1e-12)
    if jsaves is not None:
        assert (np.abs(jsaves) > 0).any(axis=(1, 2)).all()
        np.testing.assert_allclose(saves.numpy(), jsaves, rtol=1e-9,
                                   atol=1e-12)


@pytest.mark.parametrize("name", BOTH)
def test_twin_matches_host_driver_f64(name):
    """The loop twin and the port's host driver over the stepper's step
    take the same steps: equal counters and status per trajectory."""
    case = CASES[name]
    M0, M1, w, psi, h0 = _inputs(case)
    tctl = vt.StepControl(**{**BASE, **case.ctl})
    st = FusedModulatedLinearRK(
        M0=torch.as_tensor(M0), M1=torch.as_tensor(M1), w=w,
        tableau=ttab.TABLEAUS[case.tab], advance_lower=case.advance_lower,
        norm=None if case.norm is None else lc.WeightedNorm(*case.norm))
    y0 = Cplx(torch.as_tensor(psi.real), torch.as_tensor(psi.imag))
    ref = driver.integrate(st.make_step_fn(), y0,
                           torch.tensor(case.grid, dtype=torch.float64),
                           torch.as_tensor(h0, dtype=torch.float64), ctl=tctl,
                           error_norm=st.error_norm, batch_shape=(B,))
    fs, ist, x, saves = _twin_loop(case, persistent=True)
    for col, k in ((1, "status"), (3, "n_accept"), (4, "n_reject"),
                   (5, "n_iters")):
        assert torch.equal(ist[:, col], getattr(ref, k)), k
    np.testing.assert_allclose(fs[:, 0].numpy(), ref.t_final.numpy(),
                               rtol=1e-15)
    np.testing.assert_allclose(x.numpy(), torch.cat(
        [ref.y_final.re, ref.y_final.im], 1).numpy(), rtol=0, atol=1e-13)


@pytest.mark.parametrize("name", ["save_grid", "pi", "stalled"])
def test_persistent_and_chunked_twins_are_bitwise_equal(name):
    p = _twin_loop(CASES[name], persistent=True)
    c = _twin_loop(CASES[name], persistent=False, chunk=3)
    for a, b in zip(p, c):
        assert torch.equal(a, b)
    assert p[1].shape == (B, N_I) and p[0].shape == (B, N_F)


def test_chunk_runs_the_given_iterations():
    case = CASES["plain"]
    M0, M1, w, psi, h0 = _inputs(case)
    step, tctl = _step(case, M0, M1, w)
    x0 = torch.as_tensor(np.concatenate([psi.real, psi.imag], axis=1))
    grid = torch.tensor(case.grid, dtype=torch.float64)
    fs = torch.stack([torch.zeros(B, dtype=torch.float64),
                      *[torch.full((B,), 1e-3, dtype=torch.float64)] * 2,
                      *[torch.zeros(B, dtype=torch.float64)] * 2], 1)
    ist = torch.zeros(B, N_I, dtype=torch.int32)
    saves = torch.zeros(0, B, 2 * D, dtype=torch.float64)
    fs, ist, x, _ = fused_loop_chunk(grid, fs, ist, x0, saves, step,
                                     ctl=tctl, chunk=4)
    assert (ist[:, 5] == 4).all() and (ist[:, 1] == vt.RUNNING).all()
    with pytest.raises(ValueError, match="chunk"):
        fused_loop_chunk(grid, fs, ist, x, saves, step, ctl=tctl, chunk=0)
    with pytest.raises(ValueError, match="embedded"):
        fused_loop_chunk(grid, fs, ist, x, saves,
                         dataclasses.replace(step, tableau=ttab.RK4),
                         ctl=tctl)


def test_fused_loop_solve_declines_on_the_cpu():
    case = CASES["plain"]
    M0, M1, w, psi, _ = _inputs(case)
    st = FusedModulatedLinearRK(M0=torch.as_tensor(M0),
                                M1=torch.as_tensor(M1), w=w)
    y0 = Cplx(torch.as_tensor(psi.real), torch.as_tensor(psi.imag))
    grid = torch.tensor(case.grid, dtype=torch.float64)
    assert st.fused_loop_solve(y0, grid, 1e-3, ctl=vt.StepControl(),
                               adaptive=True) is None
    # with events and dense output too: the host driver runs them
    ev = vt.EventConfig(events=(vt.Event(vt.LinearObservable(
        w=np.eye(2 * D)[3])),))
    assert st.fused_loop_solve(y0, grid, 1e-3, ctl=vt.StepControl(),
                               adaptive=True, dense=True, events=ev) is None

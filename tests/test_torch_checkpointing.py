"""Checkpoint and resume (``utils.save_state`` / ``load_state``) against
the JAX package's (tests/test_aux.py): a carry saved mid-solve, loaded and
resumed through ``driver.resume`` gives the uninterrupted solve's bits
and the JAX package's numbers, dotted names do not collide, and the
template checks the structure."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vec_ode_tpu as vo
from vec_ode_tpu.rk import rk_step as jrk_step
from vec_ode_tpu.utils.checkpointing import _npz_path
from vec_ode_tpu.utils.checkpointing import load_state as jload_state
from vec_ode_tpu.utils.checkpointing import save_state as jsave_state
import vec_ode_tpu_torch as vt
from vec_ode_tpu_torch import driver
from vec_ode_tpu_torch.models import DrivenDense
from vec_ode_tpu_torch.ops.cplx import from_complex
from vec_ode_tpu_torch.ops.fused_rk import FusedModulatedLinearRK
from vec_ode_tpu_torch.rk import rk_step
from vec_ode_tpu_torch.utils import load_state, save_state
from vec_ode_tpu_torch.utils.checkpointing import _ckpt_path

torch.set_num_threads(1)


def _step_fn(t, x, dt):
    return rk_step(lambda tt, y: -y, t, x, dt, vt.RKF45)


@functools.cache
def _jax_resumed(tmp):
    def step_fn(t, x, dt):
        return jrk_step(lambda tt, y: -y, t, x, dt, vo.RKF45)

    t_grid = vo.make_grid(0.0, 2.0, dtype=jnp.float64)
    ctl = vo.StepControl(rtol=1e-8)
    state = vo.init_state(jnp.asarray(1.0, jnp.float64), t_grid, 1e-2)
    step = jax.jit(functools.partial(vo.step_once, step_fn=step_fn,
                                     adaptive=True, ctl=ctl))
    for _ in range(10):
        state = step(state)
    jsave_state(f"{tmp}/jckpt", state)
    sol = vo.resume(jload_state(f"{tmp}/jckpt", like=state), step_fn,
                    adaptive=True, ctl=ctl)
    return float(sol.y_final), int(sol.n_accept)


def test_resume_matches_uninterrupted(tmp_path):
    grid = driver.make_grid(0.0, 2.0, dtype=torch.float64, device="cpu")
    ctl = vt.StepControl(rtol=1e-8)
    full = driver.integrate(_step_fn, torch.tensor(1.0, dtype=torch.float64),
                            grid, 1e-2, ctl=ctl)
    state = driver.init_state(torch.tensor(1.0, dtype=torch.float64), grid,
                              1e-2)
    for _ in range(10):
        state = driver.step_once(state, _step_fn, adaptive=True, ctl=ctl)
    save_state(tmp_path / "ckpt", state)
    restored = load_state(tmp_path / "ckpt", like=state)
    sol = driver.resume(restored, _step_fn, adaptive=True, ctl=ctl)
    assert int(sol.status) == vt.DONE
    assert float(sol.y_final) == float(full.y_final)
    assert int(sol.n_accept) == int(full.n_accept)
    jy, jn = _jax_resumed(str(tmp_path))
    assert int(sol.n_accept) == jn
    np.testing.assert_allclose(float(sol.y_final), jy, rtol=1e-14)


def test_resume_batched_stepper_with_carry_is_bitwise(tmp_path):
    """A batched carry with a save grid and the compensated stepper's lo
    word: saved after 7 iterations, resumed, bitwise the uninterrupted
    solve."""
    model = DrivenDense.make(d=4, seed=0)
    st = FusedModulatedLinearRK.from_driven_dense(model, torch.float64,
                                                  device="cpu")
    rng = np.random.default_rng(0)
    z = rng.standard_normal((6, 4)) + 1j * rng.standard_normal((6, 4))
    y0 = from_complex(z / np.linalg.norm(z, axis=1, keepdims=True),
                      device="cpu")
    grid = driver.make_grid(0.0, 1.0, [0.3, 0.6], dtype=torch.float64,
                            device="cpu")
    ctl = vt.StepControl(rtol=1e-8, min_dt=1e-6, max_dt=0.25)
    kw = dict(ctl=ctl, error_norm=st.error_norm)
    full = driver.integrate(st.make_step_fn(), y0, grid, 1e-3,
                            batch_shape=(6,), **kw)
    state = driver.init_state(y0, grid, 1e-3, batch_shape=(6,))
    for _ in range(7):
        state = driver.step_once(state, st.make_step_fn(), adaptive=True,
                                 batched=True, **kw)
    save_state(tmp_path / "run.iter7", state)
    sol = driver.resume(load_state(tmp_path / "run.iter7", like=state),
                        st.make_step_fn(), batched=True, **kw)
    for a, b in ((sol.y_final.re, full.y_final.re), (sol.ys.im, full.ys.im),
                 (sol.n_iters, full.n_iters), (sol.h_final, full.h_final)):
        assert torch.equal(a, b)

    comp = vt.RungeKutta(compensated=True)
    f = comp.make_step_fn(lambda t, y: -y)
    x0 = torch.linspace(1.0, 2.0, 3, dtype=torch.float64)
    g2 = driver.make_grid(0.0, 1.0, dtype=torch.float64, device="cpu")
    ref = driver.integrate(f, x0, g2, 1e-2, ctl=ctl,
                           init_carry_fn=comp.make_init_carry(
                               lambda t, y: -y))
    state = driver.init_state(x0, g2, 1e-2, stepper_carry=torch.zeros(3,
                              dtype=torch.float64))
    for _ in range(5):
        state = driver.step_once(state, f, adaptive=True, ctl=ctl)
    save_state(tmp_path / "comp", state)
    got = driver.resume(load_state(tmp_path / "comp", like=state), f,
                        ctl=ctl)
    assert torch.equal(got.y_final, ref.y_final)


def test_checkpoint_names_do_not_collide(tmp_path):
    """Dotted names ('ckpt.step100' and 'ckpt.step200') save to distinct
    files, as the JAX package's _npz_path keeps them apart."""
    a = _ckpt_path(tmp_path / "ckpt.step100")
    b = _ckpt_path(tmp_path / "ckpt.step200")
    assert a != b
    assert a.name == "ckpt.step100.pt" and b.name == "ckpt.step200.pt"
    assert _ckpt_path(tmp_path / "plain.pt").name == "plain.pt"
    assert _npz_path(tmp_path / "ckpt.step100").name == "ckpt.step100.npz"


def test_load_needs_a_matching_template(tmp_path):
    grid = driver.make_grid(0.0, 1.0, dtype=torch.float64, device="cpu")
    state = driver.init_state(torch.ones(2, dtype=torch.float64), grid, 1e-2)
    save_state(tmp_path / "s", state)
    with pytest.raises(ValueError, match="template"):
        load_state(tmp_path / "s")
    other = state._replace(carry=torch.zeros(2, dtype=torch.float64))
    with pytest.raises(ValueError, match="structure"):
        load_state(tmp_path / "s", like=other)
    # each leaf takes the template's type
    like32 = driver.init_state(torch.ones(2, dtype=torch.float32),
                               grid.float(), 1e-2)
    assert load_state(tmp_path / "s", like=like32).x.dtype == torch.float32

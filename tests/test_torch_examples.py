"""The port's seven examples (``vec_ode_tpu_torch.examples``, one for each
script of ``examples/``): each ``main(device="cpu")`` runs in-process at
its JAX twin's size and its own check holds. Those that take more than
~30 s on the CPU carry the ``slow`` marker; ``chip_smoke.py``'s
``[examples]`` phase runs all seven on the card.

And the fault that the Lindblad example met (ROADMAP queue 3): a natively
batched modulated stepper on a (1, d) state on the scalar tier
(``solve_linear``), held against the JAX package's."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vec_ode_tpu as vo
from vec_ode_tpu import exp as vexp
from vec_ode_tpu.models import Lindblad as JLindblad
import vec_ode_tpu_torch as vt
from vec_ode_tpu_torch import exp as texp
from vec_ode_tpu_torch.models import Lindblad

jax.config.update("jax_enable_x64", True)
torch.set_num_threads(1)

# seconds on one CPU thread: hamiltonian_learning 108, impact_events 69,
# pulse_control 51, ensemble_sweep 51; blackbox_fast_path 14,
# lindblad_open_system 8, threshold_events_kernel 5
SLOW = ("hamiltonian_learning", "impact_events", "pulse_control",
        "ensemble_sweep")
FAST = ("blackbox_fast_path", "lindblad_open_system",
        "threshold_events_kernel")


@pytest.mark.parametrize("name", list(FAST) + [
    pytest.param(n, marks=pytest.mark.slow) for n in SLOW])
def test_example_runs_on_the_cpu(name):
    importlib.import_module(f"vec_ode_tpu_torch.examples.{name}").main(
        device="cpu")


def test_modulated_stepper_takes_a_batch_on_the_scalar_tier():
    """``solve_linear`` with ``MagnusModulated4`` on one (1, d^2) density
    matrix (the Lindblad example's call): the step takes the scalar
    carry's one t and dt for the whole batch, as the JAX package's does
    (it raised IndexError before). Counters equal, y_final to 1e-12."""
    d = 3
    rho0 = np.zeros((1, d, d), complex)
    rho0[0, d - 1, d - 1] = 1.0
    ctl = dict(rtol=1e-9, atol=1e-11, min_dt=1e-8, max_dt=0.1)

    jmod = JLindblad.make(d=d, seed=9, gamma=0.25).modulated(
        lambda t: 0.8 * jnp.sin(2.1 * jnp.asarray(t)))
    want = vo.solve_linear(None, 0.0, 0.5, JLindblad.vec_rho(rho0),
                           stepper=vexp.MagnusModulated4(jmod),
                           adaptive=True, ctl=vo.StepControl(**ctl))
    tmod = Lindblad.make(d=d, seed=9, gamma=0.25).modulated(
        lambda t: 0.8 * torch.sin(2.1 * t), torch.float64, device="cpu")
    got = vt.solve_linear(None, 0.0, 0.5, Lindblad.vec_rho(rho0,
                                                           device="cpu"),
                          stepper=texp.MagnusModulated4(tmod),
                          adaptive=True, ctl=vt.StepControl(**ctl))
    for k in ("status", "n_accept", "n_reject", "n_iters"):
        assert int(getattr(got, k)) == int(getattr(want, k)), k
    for part in ("re", "im"):
        np.testing.assert_allclose(
            getattr(got.y_final, part).numpy(),
            np.asarray(getattr(want.y_final, part)), rtol=0, atol=1e-12)

"""In-kernel event detection: stop each trajectory at a population
threshold without leaving the loop kernel.

A Landau-Zener sweep ensemble integrates until each trajectory's excited
population first crosses a threshold. The event function is a DECLARED
observable (``events.QuadraticObservable``: g = sum q_i |x_i|^2 - c), so
the whole regula-falsi search (crossing detection, bracket shrinking,
the terminal stop at DONE_EVENT, the located time and state) runs inside
the loop kernel on the card: the solve is ONE kernel launch (on the CPU,
the kernel's plain twin). An opaque callable would take the host driver
instead, with the same semantics. f32.

    python -m vec_ode_tpu_torch.examples.threshold_events_kernel \\
        [--device cpu]
"""

import numpy as np
import torch

from .. import DONE_EVENT, StepControl, exp
from ..events import Event, EventConfig, QuadraticObservable
from ..models import LandauZener
from ..ops import cplx
from ..parallel import ensemble_solve

B = 256
THRESHOLD = 0.05


def main(device="cuda"):
    lz = LandauZener(v=2.0, delta=0.4)
    mod = lz.modulated(torch.float32, device=device)
    psi0 = np.zeros((B, 2), np.complex64)
    psi0[:, 0] = 1.0
    y0 = cplx.from_complex(psi0, torch.float32, device=device)

    # g(t, psi) = |psi_1|^2 - threshold, rising crossing, terminal
    event = Event(QuadraticObservable(q=[0.0, 1.0], c=THRESHOLD),
                  direction=1, terminal=True)
    cfg = EventConfig(events=(event,), t_tol=1e-4)
    sol = ensemble_solve(
        None, y0, -20.0, 20.0, stepper=exp.MagnusModulated4(mod),
        adaptive=True, h0=1e-2, time_dtype=torch.float32, events=cfg,
        ctl=StepControl(rtol=1e-5, max_steps=4000, min_dt=1e-4,
                        max_dt=1.0))

    want = "cuda-loop-persistent" if device == "cuda" else "torch-loop"
    assert sol.path == want, sol.path
    assert bool((sol.status == DONE_EVENT).all())
    t_hit = sol.event_t[:, 0].cpu().numpy()
    pop = (sol.event_y.re[:, 0, 1] ** 2
           + sol.event_y.im[:, 0, 1] ** 2).cpu().numpy()
    print(f"execution path : {sol.path} (whole solve = 1 kernel launch on "
          f"the card)")
    print(f"threshold hit  : t* = {t_hit[0]:.5f} "
          f"(all {B} trajectories, spread {np.ptp(t_hit):.1e})")
    print(f"population(t*) : {pop[0]:.5f} (threshold {THRESHOLD})")
    assert abs(pop[0] - THRESHOLD) < 1e-3
    return sol


if __name__ == "__main__":
    from . import device_arg

    main(device_arg(__doc__).device)

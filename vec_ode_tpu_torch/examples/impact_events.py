"""Event detection and differentiable event times: the range of a
projectile with quadratic drag.

The impact has no closed form; a terminal event on the altitude z = 0
finds it (scipy's solve_ivp(events=...) tutorial problem):

  1. an ENSEMBLE of launch angles integrates in one batched adaptive
     solve, each trajectory stopping at ITS OWN impact (status
     DONE_EVENT), the impact state recorded;
  2. the range R(angle) = x(t*) at the event is DIFFERENTIATED through
     the solver (``method="scan"``, autograd), and gradient steps find
     the drag-optimal launch angle (below 45 degrees, as physics
     demands). f64.

    python -m vec_ode_tpu_torch.examples.impact_events [--device cpu]
"""

import numpy as np
import torch

from .. import DONE_EVENT, StepControl, solve_ivp
from ..events import Event
from ..parallel import ensemble_solve

G = 9.81      # gravity
K = 0.02      # quadratic drag coefficient
V0 = 50.0     # launch speed


def rhs(t, s):
    # s = [x, z, vx, vz]; quadratic drag opposes the velocity
    v = torch.sqrt(s[2] ** 2 + s[3] ** 2)
    return torch.stack([s[2], s[3], -K * v * s[2], -G - K * v * s[3]])


def launch_state(angle):
    return torch.stack([torch.zeros_like(angle),
                        torch.zeros_like(angle) + 1e-9,
                        V0 * torch.cos(angle), V0 * torch.sin(angle)])


IMPACT = Event(lambda t, s: s[1], direction=-1, terminal=True)
CTL = StepControl(rtol=1e-8, max_steps=400)


def main(device="cuda"):
    # 1. an ensemble of launch angles, one batched event-terminated solve
    angles = torch.as_tensor(np.deg2rad(np.linspace(15.0, 75.0, 13)),
                             dtype=torch.float64, device=device)
    sol = ensemble_solve(rhs, launch_state(angles).T.contiguous(), 0.0, 20.0,
                         ctl=CTL, events=IMPACT)
    assert bool((sol.status == DONE_EVENT).all())
    t_imp = sol.event_t[:, 0].cpu().numpy()
    ranges = sol.event_y[:, 0, 0].cpu().numpy()
    print(" angle[deg]   t_impact[s]   range[m]")
    for a, t, r in zip(np.rad2deg(angles.cpu().numpy()), t_imp, ranges):
        print(f"   {a:6.1f}      {t:7.3f}     {r:8.2f}")

    # 2. the drag-optimal angle, differentiating THROUGH the impact event
    def neg_range(angle):
        s = solve_ivp(rhs, 0.0, 20.0, launch_state(angle), ctl=CTL,
                      method="scan", events=IMPACT)
        return -s.event_y[0][0]

    def grad(angle):
        angle = angle.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(neg_range(angle), angle)
        return g

    angle = torch.tensor(np.deg2rad(40.0), dtype=torch.float64,
                         device=device)
    for _ in range(25):
        angle = angle - 0.002 * grad(angle)
    best = float(np.rad2deg(float(angle)))
    with torch.no_grad():
        best_range = -float(neg_range(angle))
    slope = float(grad(angle))
    print(f"\noptimal launch angle with drag: {best:.2f} deg "
          f"(vacuum: 45.00), range {best_range:.2f} m")
    # with drag the optimum is strictly below 45 degrees
    assert 35.0 < best < 45.0
    # stationarity: dR/dangle ~ 0 at the optimum
    assert abs(slope) < 2.0
    print("OK")
    return best, slope


if __name__ == "__main__":
    from . import device_arg

    main(device_arg(__doc__).device)

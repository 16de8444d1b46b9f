"""Open quantum system: a driven, damped qudit through the Lindblad master
equation on the modulated superoperator path (adaptive Magnus-4 over
A(t) = S0 + u(t) S1 with a callable control u). f64.

    python -m vec_ode_tpu_torch.examples.lindblad_open_system [--device cpu]
"""

import numpy as np
import torch

from .. import StepControl, exp, solve_linear
from ..models import Lindblad


def main(device="cuda"):
    d = 3
    lb = Lindblad.make(d=d, seed=9, gamma=0.25)
    mod = lb.modulated(lambda t: 0.8 * torch.sin(2.1 * t), torch.float64,
                       device=device)

    rho0 = np.zeros((d, d), complex)
    rho0[d - 1, d - 1] = 1.0                     # start fully excited
    v0 = Lindblad.vec_rho(rho0[None], device=device)

    sol = solve_linear(
        None, 0.0, 4.0, v0, stepper=exp.MagnusModulated4(mod),
        adaptive=True,
        ctl=StepControl(rtol=1e-9, atol=1e-11, min_dt=1e-8, max_dt=0.1))
    rho = Lindblad.unvec_rho(sol.y_final)[0]
    pops = np.real(np.diag(rho))
    print(f"accepted steps: {int(sol.n_accept.reshape(-1)[0])}")
    print("final populations:", pops.round(4), " trace:",
          float(np.trace(rho).real))
    assert abs(np.trace(rho).real - 1.0) < 1e-8
    assert pops[d - 1] < 0.6                      # decay happened
    return rho


if __name__ == "__main__":
    from . import device_arg

    main(device_arg(__doc__).device)

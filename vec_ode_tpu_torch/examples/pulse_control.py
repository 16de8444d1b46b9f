"""Quantum optimal control with O(1)-memory gradients.

Optimizes a sine-series pulse to transfer a 4-level system between two
states through the reversible adjoint (``diff.adjoint_solve``, under
``models.PulseControl.infidelity``); 150 Adam steps (``torch.optim.Adam``
through ``diff.fit_loop``) reach a fidelity above 0.98. f64.

    python -m vec_ode_tpu_torch.examples.pulse_control [--device cpu]
"""

import numpy as np
import torch

from ..diff import fit_loop
from ..models import PulseControl
from ..ops import cplx


def main(device="cuda"):
    pc = PulseControl.make(d=4, seed=0, T=5.0, n_modes=6)
    psi0 = cplx.from_complex(np.eye(4)[0][None].astype(complex),
                             torch.float64, device=device)
    tgt = cplx.from_complex(np.eye(4)[2][None].astype(complex),
                            torch.float64, device=device)
    theta = 0.1 * torch.ones(6, dtype=torch.float64, device=device)

    res = fit_loop(
        lambda th: pc.infidelity(th, psi0, tgt, n_steps=192), theta,
        optimizer=lambda p: torch.optim.Adam(p, lr=0.3), n_iters=150,
        verbose_every=25)
    final = float(res.losses[-1])
    print(f"final fidelity: {1 - final:.6f}")
    assert 1 - final > 0.98
    print("pulse coefficients:", res.params.detach().cpu().numpy().round(3))
    return 1 - final


if __name__ == "__main__":
    from . import device_arg

    main(device_arg(__doc__).device)

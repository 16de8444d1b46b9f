"""Hamiltonian learning: gradients with respect to the OPERATOR BASIS.

Recovers an unknown coupling matrix V from state observations of a
driven system H(t) = H0 + cos(w t) V, by gradient descent THROUGH the
solver on the basis matrices (``diff.adjoint_solve(...,
basis_grad=True)``, the reversible adjoint) with ``torch.optim.Adam``
through ``diff.fit_loop``. The "experiment" is only available as a
black-box op_fn, and ``exp.auto_modulated`` recovers its modulated
structure first. f64.

    python -m vec_ode_tpu_torch.examples.hamiltonian_learning [--device cpu]
"""

import numpy as np
import torch

from .. import diff, exp
from ..models import DrivenDense
from ..ops import cplx


def main(device="cuda"):
    d, B, n_steps, T = 8, 32, 64, 2.0
    dtype = torch.float64
    truth = DrivenDense.make(d=d, seed=0, w=1.3)

    # the black-box experiment: auto_modulated recovers its K = 2
    # structure from op_fn samples alone
    mod = exp.auto_modulated(lambda t: truth.op_pair(t, dtype, device=device),
                             0.0, T, device=device)
    assert mod is not None and mod.n_terms == 2
    rng = np.random.default_rng(1)
    psi = rng.standard_normal((B, d)) + 1j * rng.standard_normal((B, d))
    psi /= np.linalg.norm(psi, axis=-1, keepdims=True)
    y0 = cplx.from_complex(psi, dtype, device=device)

    theta = torch.zeros(0, dtype=dtype, device=device)  # fixed coefficients

    def coeff(t, th):
        return torch.stack([torch.ones_like(t), torch.cos(truth.w * t)],
                           dim=-1)

    H0p, Vp = truth.pair_parts(dtype, device=device)
    basis_true = cplx.Cplx(torch.stack([H0p.im, Vp.im]),
                           torch.stack([-H0p.re, -Vp.re]))
    y_obs = diff.adjoint_solve(basis_true, coeff, theta, y0, 0.0, T, n_steps,
                               order=4)

    # learn V (basis element 1) from the observations
    def model_basis(V_re, V_im):
        return cplx.Cplx(torch.stack([basis_true.re[0], V_im]),  # -iH: re =
                         torch.stack([basis_true.im[0], -V_re]))  # im(H)...

    def loss(params):
        V_re, V_im = params
        yf = diff.adjoint_solve(model_basis(V_re, V_im), coeff, theta, y0,
                                0.0, T, n_steps, order=4, basis_grad=True)
        return torch.sum((yf.re - y_obs.re) ** 2 + (yf.im - y_obs.im) ** 2)

    zeros = torch.zeros(d, d, dtype=dtype, device=device)
    res = diff.fit_loop(loss, (zeros, zeros.clone()),
                        optimizer=lambda p: torch.optim.Adam(p, lr=0.05),
                        n_iters=300, verbose_every=50)
    V = torch.as_tensor(truth.V, device=device)
    V_err = max(float((res.params[0] - V.real).abs().max()),
                float((res.params[1] - V.imag).abs().max()))
    print(f"final loss {float(loss(res.params)):.3e}, "
          f"max |V_learned - V_true| = {V_err:.3e}")
    assert V_err < 5e-2, "Hamiltonian learning failed to recover V"
    return V_err


if __name__ == "__main__":
    from . import device_arg

    main(device_arg(__doc__).device)

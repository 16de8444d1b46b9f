"""A black-box operator callback at the loop kernel's speed.

A user hands the solver nothing but ``op_fn(t) -> A(t)`` (a 2-level
Landau-Zener sweep here). Two paths solve that contract:

  1. the generic dense path: per-trajectory exponentials, no structure
     assumed (on the card a launch of the dense chain kernel an
     iteration);
  2. ``exp.auto_modulated``: an SVD over probe samples recovers
     A(t) = c1(t) (-i sz) + c2(t) (-i sx), validated at held-out times,
     with the coefficients fitted as a Chebyshev series (``ChebForm``),
     so that on the card the whole adaptive solve runs in one launch of
     the loop kernel.

Both give the same physics, checked against the closed-form asymptotic
transition probability. f32 on the card, f64 on the CPU.

    python -m vec_ode_tpu_torch.examples.blackbox_fast_path [--device cpu]
"""

import numpy as np
import torch

from .. import DONE, StepControl, exp
from ..models import LandauZener
from ..ops import cplx
from ..parallel import ensemble_solve


def main(device="cuda"):
    dtype = torch.float32 if device == "cuda" else torch.float64
    lz = LandauZener(v=2.0, delta=0.4)

    # the ONLY thing the user provides: an opaque operator callback
    def op_fn(t):
        return lz.op_pair(t, dtype, device=device)

    B = 256
    psi0 = np.zeros((B, 2), np.complex64)
    psi0[:, 0] = 1.0
    y0 = cplx.from_complex(psi0, dtype, device=device)
    ctl = StepControl(rtol=1e-6, max_steps=40000)

    # 1. the generic dense path: right for ANY op_fn
    sol_dense = ensemble_solve(op_fn, y0, -20.0, 20.0,
                               stepper=exp.Magnus4(exp.DenseCplxSplit()),
                               ctl=ctl, h0=0.05, time_dtype=dtype)

    # 2. structure recovery and its Chebyshev coefficient form
    mod = exp.auto_modulated(op_fn, -20.0, 20.0, dtype=dtype, device=device)
    assert mod is not None, "LZ is rank-2 modulated; detection must succeed"
    assert mod.form is not None, "the coefficients fit a Chebyshev series"
    print(f"recovered structure: K = {mod.n_terms} basis matrices, "
          f"coefficient form: {type(mod.form).__name__}")
    sol_fast = ensemble_solve(None, y0, -20.0, 20.0,
                              stepper=exp.MagnusModulated4(mod), ctl=ctl,
                              h0=0.05, time_dtype=dtype)
    print(f"execution path: dense={sol_dense.path}  fast={sol_fast.path}")

    for name, sol in (("dense", sol_dense), ("fast", sol_fast)):
        assert bool((sol.status == DONE).all())
        p_stay = float(sol.y_final.re[0, 0] ** 2 + sol.y_final.im[0, 0] ** 2)
        print(f"{name:5s}: P_stay = {p_stay:.4f}  "
              f"(closed form {lz.p_transition:.4f}), mean accepted steps "
              f"{float(sol.n_accept.double().mean()):.0f}")
        assert abs(p_stay - lz.p_transition) < 0.02
    d = max(float((sol_dense.y_final.re - sol_fast.y_final.re).abs().max()),
            float((sol_dense.y_final.im - sol_fast.y_final.im).abs().max()))
    print(f"max |dense - fast| final-state difference: {d:.2e}")
    print("ok")
    return sol_dense, sol_fast


if __name__ == "__main__":
    from . import device_arg

    main(device_arg(__doc__).device)

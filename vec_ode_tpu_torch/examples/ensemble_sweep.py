"""Landau-Zener parameter sweep: one adaptive Magnus-4 solve per sweep
velocity in one natively batched ensemble (``params=``: the velocity per
trajectory; on the card one launch of the dense chain kernel an
iteration), and with ``--mesh`` the ensemble sharded over the world's
devices. Compares against the asymptotic Landau-Zener formula.

    python -m vec_ode_tpu_torch.examples.ensemble_sweep [--device cpu]
    torchrun --nproc-per-node=N -m vec_ode_tpu_torch.examples.ensemble_sweep \\
        --mesh [--device cpu]
"""

import numpy as np
import torch

from .. import StepControl, exp
from ..ops import cplx
from ..parallel import ensemble_mesh, ensemble_solve


def main(device="cuda", mesh=False):
    # the mesh first: on the card it puts each rank on its own device
    mesh = ensemble_mesh(device=device) if mesh else None
    B, delta, dtype = 16, 0.4, torch.float64
    vs = np.linspace(1.0, 4.0, B)
    psi0 = np.zeros((B, 2), complex)
    psi0[:, 0] = 1.0
    y0 = cplx.from_complex(psi0, dtype, device=device)
    sz = torch.tensor([[0.5, 0.0], [0.0, -0.5]], dtype=dtype, device=device)
    sx = torch.tensor([[0.0, 0.5], [0.5, 0.0]], dtype=dtype, device=device)

    def op_fn(t, v):
        # A(t) = -i H(t), H = v t sz/2 + delta sx/2, per-trajectory v
        H = v * t * sz + delta * sx
        return cplx.Cplx(torch.zeros_like(H), -H)

    kw = dict(stepper=exp.Magnus4(exp.DenseCplxSplit()),
              params=torch.as_tensor(vs, dtype=dtype, device=device),
              ctl=StepControl(rtol=1e-9, min_dt=1e-6, max_dt=0.5,
                              max_steps=100000), h0=1e-2)
    yf = ensemble_solve(op_fn, y0, -25.0, 25.0, mesh=mesh, **kw).y_final
    show = True
    if mesh is not None:
        yf = cplx.Cplx(yf.re.full_tensor(), yf.im.full_tensor())
        show = mesh.get_rank() == 0
    p_stay = (yf.re[:, 0] ** 2 + yf.im[:, 0] ** 2).cpu().numpy()
    p_lz = np.exp(-np.pi * delta**2 / (2 * vs))
    if show:
        print(" v     P(stay)   P_LZ")
        for v, p, pl in zip(vs, p_stay, p_lz):
            print(f"{v:4.2f}  {p:.5f}  {pl:.5f}")
    assert np.all(np.abs(p_stay - p_lz) < 0.02)
    return p_stay


if __name__ == "__main__":
    from . import device_arg

    args = device_arg(__doc__, mesh="shard over ensemble_mesh() (torchrun)")
    main(args.device, mesh=args.mesh)

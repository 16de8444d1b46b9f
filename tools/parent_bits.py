"""The RK main path's step kernel (K1) and solve on this checkout against
another checkout's, on one CUDA card, bit for bit.

    python -m tools.parent_bits PARENT_DIR

Run from the repository root on a machine with one CUDA card and nvcc.
PARENT_DIR holds another checkout of the repository (for example one
unpacked by ``git archive <commit> | tar -x -C build/parent``). Each
checkout runs in a process of its own, from its own directory, with its
own ``chip_smoke.py`` inputs and wrappers (so the two may differ in their
kernels' C entry points): one K1 launch on ``chip_smoke.step_inputs`` at
16 384 x 64c in f32 and at 256 in f64, and the main path's
``ensemble_solve`` at 16 384 x 64c f32 (the drive cos(w t)). It prints
whether the states, error measures, final states and every counter are
the same bits, beside the card's name and power limit, and exits
non-zero if any differs.
"""

from __future__ import annotations

import pathlib
import subprocess
import sys
import tempfile

import torch

RUN = r'''
import sys, torch
sys.path.insert(0, ".")
import chip_smoke as c
out = {}
for name, B, dtype in (("f32", c.N_TRAJ, torch.float32),
                       ("f64", 256, torch.float64)):
    st, t, dt, xw = c.step_inputs(B, c.DIM, dtype)
    x, e = c.fused_rk_step(t, dt, xw, st.M0, st.M1, w=st.w)
    out[name] = (x.cpu(), e.cpu())
st, y0 = c.main_inputs()
sol = c.solve(st, y0)
out["main"] = tuple(a.cpu() for a in (
    sol.y_final.re, sol.y_final.im, sol.t_final, sol.h_final, sol.status,
    sol.n_accept, sol.n_reject, sol.n_iters))
torch.save(out, sys.argv[1])
'''


def run_in(root: pathlib.Path, path: str) -> dict:
    """RUN in a process of its own from ``root``; its results."""
    subprocess.run([sys.executable, "-c", RUN, path], cwd=root, check=True)
    return torch.load(path)


def main() -> None:
    parent = pathlib.Path(sys.argv[1]).resolve()
    here = pathlib.Path(__file__).resolve().parents[1]
    import chip_smoke as cs

    card = cs.device_phase()
    with tempfile.TemporaryDirectory() as tmp:
        ref = run_in(parent, f"{tmp}/parent.pt")
        new = run_in(here, f"{tmp}/this.pt")
    ok = True
    for key, label in (("f32", f"K1 one RKF45 step {cs.N_TRAJ}x{cs.DIM}c "
                               "f32"),
                       ("f64", f"K1 one RKF45 step 256x{cs.DIM}c f64"),
                       ("main", f"RK main path {cs.N_TRAJ}x{cs.DIM}c f32: "
                                "y_final, t_final, h_final, status and "
                                "counters")):
        same = all(torch.equal(a, b) for a, b in zip(ref[key], new[key]))
        ok = ok and same
        extra = (f", {int(new['main'][7].max())} iterations"
                 if key == "main" else "")
        print(f"[parent-bits] {label}: the same bits as {parent.name}: "
              f"{same}{extra} ({card})", flush=True)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()

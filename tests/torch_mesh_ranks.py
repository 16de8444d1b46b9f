"""One rank of the 4-process gloo world that ``tests/test_torch_mesh.py``
and ``tests/test_torch_state_parallel.py`` launch (one world a file):

    python tests/torch_mesh_ranks.py SUITE OUT_DIR RANK WORLD

SUITE is ``mesh`` (sharded ensembles) or ``state`` (state sharding). The
ranks meet through a FileStore under OUT_DIR (no network) and run every
case of the suite in the same order; each case writes
``OUT_DIR/CASE.rRANK.npz`` (or ``CASE.rRANK.err`` with the traceback).
Last, ``done.rRANK.json`` lists the modules of jax and of the JAX package
that the rank loaded: none may be. This module imports only numpy, torch
and the port; the test files import its input functions, so that both
packages see the same numpy inputs.
"""

from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

WORLD = 4
F64 = torch.float64
# seconds from launch to the last rank's exit; a hang (a collective that
# one rank skipped) fails the tests instead of the suite
TIMEOUT = 120.0


class World:
    """The WORLD ranks of one suite, started together; ``load(case)`` waits
    for all of them (killing them at the deadline) and returns each rank's
    arrays of the case, or fails with what the ranks reported."""

    def __init__(self, suite: str, out: pathlib.Path):
        self.out = out
        env = dict(os.environ, OMP_NUM_THREADS="1", GLOO_SOCKET_IFNAME="lo")
        self.deadline = time.monotonic() + TIMEOUT
        self.procs = []
        for r in range(WORLD):
            with open(out / f"rank{r}.log", "w") as log:
                self.procs.append(subprocess.Popen(
                    [sys.executable, __file__, suite, str(out), str(r),
                     str(WORLD)], cwd=ROOT, env=env, stdout=log,
                    stderr=subprocess.STDOUT))
        self.timed_out = False

    def wait(self) -> None:
        for p in self.procs:
            try:
                p.wait(timeout=max(self.deadline - time.monotonic(), 0.1))
            except subprocess.TimeoutExpired:
                self.timed_out = True
                self.close()

    def close(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()

    def logs(self) -> str:
        return "\n".join((self.out / f"rank{r}.log").read_text()[-2000:]
                         for r in range(WORLD))

    def load(self, case: str) -> list:
        self.wait()
        errs = sorted(self.out.glob(f"{case}.r*.err"))
        if errs:
            raise AssertionError(errs[0].read_text())
        paths = [self.out / f"{case}.r{r}.npz" for r in range(WORLD)]
        if not all(p.exists() for p in paths):
            raise AssertionError(
                f"{case}: no result from every rank (timed out: "
                f"{self.timed_out}; exit codes "
                f"{[p.returncode for p in self.procs]})\n{self.logs()}")
        return [dict(np.load(p)) for p in paths]

    def done(self) -> list:
        self.wait()
        return [json.loads((self.out / f"done.r{r}.json").read_text())
                for r in range(WORLD)]

# the inputs, numpy, shared with the test files ----------------------------


def unit_states(B, d, seed):
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((B, d)) + 1j * rng.standard_normal((B, d))
    return z / np.linalg.norm(z, axis=-1, keepdims=True)


def decay_y0():
    return np.random.default_rng(0).uniform(0.5, 1.5, (32, 8))


def rates_and_h0():
    """16 decay rates and per-trajectory first steps."""
    return (np.linspace(-2.0, -0.5, 16),
            np.random.default_rng(5).uniform(0.01, 0.05, 16))


def lz_sweeps():
    return np.linspace(0.5, 4.0, 16)


G, DRAG, V0 = 9.81, 0.02, 50.0


def launch_states():
    """16 projectiles with quadratic drag, launched at 15..75 degrees."""
    a = np.deg2rad(np.linspace(15.0, 75.0, 16))
    return np.stack([np.zeros(16), np.full(16, 1e-9), V0 * np.cos(a),
                     V0 * np.sin(a)], axis=1)


def stiff_rates():
    return np.array([0.5, 1.0, 4.0, 16.0, 0.7, 2.0, 8.0, 32.0])


def adjoint_inputs():
    """The problem of ``tests/test_adjoint.py:534``: a (2, 3, 3) basis of
    -i H, 16 unit states, theta."""
    rng = np.random.default_rng(17)
    Hs = rng.standard_normal((2, 3, 3)) + 1j * rng.standard_normal((2, 3, 3))
    Hs = 0.5 * (Hs + np.conj(np.swapaxes(Hs, -1, -2)))
    M = -1j * Hs
    rng = np.random.default_rng(18)
    z = rng.standard_normal((16, 3)) + 1j * rng.standard_normal((16, 3))
    z /= np.linalg.norm(z, axis=-1, keepdims=True)
    return M, z, np.array([0.8, 2.5])


def const_problem(D, seed_a, seed_y, B=None):
    from vec_ode_tpu_torch.models import stable_dense_matrix

    rng = np.random.default_rng(seed_y)
    y0 = rng.standard_normal(D if B is None else (B, D))
    return stable_dense_matrix(D, seed=seed_a, dtype=None), y0


def driven_states(d, B, seed):
    """Unit states of ``DrivenDense(d)`` in the embedded real layout
    [re | im]: (2d,) for B None, else (B, 2d)."""
    rng = np.random.default_rng(seed)
    shape = (d,) if B is None else (B, d)
    z = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    z /= np.linalg.norm(z, axis=-1, keepdims=True)
    return np.concatenate([z.real, z.imag], axis=-1)


# the port's side -----------------------------------------------------------


def _np(tree):
    from torch.utils import _pytree as pytree

    return pytree.tree_map(lambda a: a.detach().cpu().numpy()
                           if isinstance(a, torch.Tensor) else a, tree)


def flat(prefix, tree) -> dict:
    """Arrays of a Solution's fields or a pytree, keyed name[.re|.im]."""
    out = {}
    if hasattr(tree, "re"):
        out[prefix + ".re"], out[prefix + ".im"] = tree.re, tree.im
    elif tree is not None:
        out[prefix] = tree
    return out


FIELDS = ("ts", "ys", "t_final", "y_final", "status", "n_accept",
          "n_reject", "n_iters", "h_final", "event_t", "event_found",
          "event_y", "event_t_k", "event_count")


class Rank:
    def __init__(self, out: pathlib.Path, rank: int, world: int):
        self.out, self.rank, self.world = out, rank, world

    def save(self, case: str, arrays: dict) -> None:
        np.savez(self.out / f"{case}.r{self.rank}.npz", **arrays)


def _leaves(sol):
    from torch.utils import _pytree as pytree

    return [(k, a) for k in FIELDS
            for a in pytree.tree_leaves(getattr(sol, k, None))
            if isinstance(a, torch.Tensor)]


def sharded_case(r: Rank, case: str, f, y0, t0, tf, *, place=True,
                 **kw) -> None:
    """ensemble_solve on the mesh (inputs placed by shard_batch where
    ``place``, else global), its full view (every rank saves it), whether
    every batched field came back a DTensor sharded on dim 0, and whether
    the rank's rows are bit for bit the unsharded solve of the same rows."""
    from torch.distributed.tensor import DTensor, Shard
    from torch.utils import _pytree as pytree

    from vec_ode_tpu_torch.parallel import (ensemble_mesh, ensemble_solve,
                                            shard_batch)

    mesh = ensemble_mesh(device="cpu")
    batched = {k: v for k, v in kw.items()
               if k in ("params", "h0") and isinstance(v, torch.Tensor)
               and v.ndim}
    args = dict(kw)
    y_in = y0
    if place:
        y_in = shard_batch(y0, mesh)
        args.update({k: shard_batch(v, mesh) for k, v in batched.items()})
    sol = ensemble_solve(f, y_in, t0, tf, mesh=mesh, **args)
    leaves = _leaves(sol)
    sharded = all(isinstance(a, DTensor)
                  and tuple(a.placements) == (Shard(0),) for _, a in leaves)
    b = pytree.tree_leaves(y0)[0].shape[0] // r.world

    def rows(a):
        return a[r.rank * b:(r.rank + 1) * b]

    ref = ensemble_solve(f, pytree.tree_map(rows, y0), t0, tf,
                         **dict(kw, **{k: rows(v) for k, v in
                                       batched.items()}))
    local = [a.to_local() if isinstance(a, DTensor) else a
             for _, a in leaves]
    same = (sol.path == ref.path and all(
        torch.equal(a, c) for a, (_, c) in zip(local, _leaves(ref))))
    arrays = {}
    for k in FIELDS:
        arrays.update(flat(k, _np(pytree.tree_map(
            lambda a: a.full_tensor() if isinstance(a, DTensor) else a,
            getattr(sol, k)))))
    arrays.update(sharded=sharded, same_bits=same, path=sol.path,
                  n_local=b)
    r.save(case, arrays)


def mesh_suite(r: Rank):
    """The sharded ensembles: (case, function) in the order every rank
    runs them."""
    from vec_ode_tpu_torch import StepControl, diff, exp
    from vec_ode_tpu_torch.events import Event, EventConfig
    from vec_ode_tpu_torch.models import DrivenDense
    from vec_ode_tpu_torch.ops import cplx
    from vec_ode_tpu_torch.ops.fused_rk import FusedModulatedLinearRK
    from vec_ode_tpu_torch.parallel import (ensemble_mesh, ensemble_solve,
                                            shard_batch, step_efficiency)

    def t(a):
        return torch.as_tensor(a, dtype=F64)

    ctl8 = StepControl(rtol=1e-8)

    def decay():
        sharded_case(r, "decay", lambda t_, y: -y, t(decay_y0()), 0.0, 1.0,
                     ctl=ctl8, h0=1e-2)

    def pair():
        model = DrivenDense.make(d=8, seed=7)
        y0 = cplx.from_complex(unit_states(64, 8, 1), F64, device="cpu")
        sharded_case(r, "pair",
                     lambda t_, y: model.rhs_pair(t_, y, dtype=F64), y0,
                     0.0, 0.5, ctl=ctl8, h0=1e-2)

    def fused_rk():
        st = FusedModulatedLinearRK.from_driven_dense(
            DrivenDense.make(d=8, seed=9), F64, device="cpu")
        y0 = cplx.from_complex(unit_states(16, 8, 6), F64, device="cpu")
        sharded_case(r, "fused_rk", None, y0, 0.0, 0.3, stepper=st,
                     ctl=StepControl(rtol=1e-8, max_dt=0.25),
                     h0=torch.full((16,), 0.02, dtype=F64),
                     time_dtype=F64)

    def magnus_loop():
        mod = DrivenDense.make(d=8, seed=5).modulated(F64, device="cpu")
        y0 = cplx.from_complex(unit_states(16, 8, 0), F64, device="cpu")
        sharded_case(r, "magnus_loop", None, y0, 0.0, 0.5,
                     stepper=exp.MagnusModulated4(mod),
                     ctl=StepControl(rtol=1e-8, min_dt=1e-6, max_dt=0.2),
                     h0=1e-2, time_dtype=F64)

    def generic():
        model = DrivenDense.make(d=8, seed=7)
        y0 = cplx.from_complex(unit_states(16, 8, 2), F64, device="cpu")
        sharded_case(r, "generic",
                     lambda t_: model.op_pair(t_, F64, device="cpu"), y0,
                     0.0, 0.5, stepper=exp.Magnus4(exp.DenseCplxSplit()),
                     ctl=StepControl(rtol=1e-8, min_dt=1e-6, max_dt=0.2),
                     h0=1e-2, time_dtype=F64)

    def params_h0():
        rates, h0 = rates_and_h0()
        sharded_case(r, "params_h0", lambda t_, y, p: p * y,
                     torch.ones(16, 2, dtype=F64), 0.0, 1.0, ctl=ctl8,
                     params=t(rates), h0=t(h0), place=False)

    def params_exp():
        sz = torch.tensor([[0.5, 0.0], [0.0, -0.5]], dtype=F64)
        sx = torch.tensor([[0.0, 0.5], [0.5, 0.0]], dtype=F64)

        def op(t_, v):
            H = v * t_ * sz + 0.4 * sx
            return cplx.Cplx(torch.zeros_like(H), -H)

        psi0 = np.zeros((16, 2), complex)
        psi0[:, 0] = 1.0
        sharded_case(r, "params_exp", op,
                     cplx.from_complex(psi0, F64, device="cpu"), -6.0, 6.0,
                     stepper=exp.ExpMidpoint(exp.DenseCplxSplit()),
                     adaptive=False, h0=0.05, params=t(lz_sweeps()))

    def events():
        def rhs(t_, s):
            v = torch.sqrt(s[2] ** 2 + s[3] ** 2)
            return torch.stack([s[2], s[3], -DRAG * v * s[2],
                                -G - DRAG * v * s[3]])

        cfg = EventConfig(events=(Event(lambda t_, s: s[1], direction=-1,
                                        terminal=True),), t_tol=1e-9)
        sharded_case(r, "events", rhs, t(launch_states()), 0.0, 20.0,
                     ctl=StepControl(rtol=1e-8, max_steps=400), events=cfg)

    def divide():
        mesh = ensemble_mesh(device="cpu")
        try:
            ensemble_solve(lambda t_, y: -y, torch.ones(10, 2, dtype=F64),
                           0.0, 1.0, mesh=mesh, h0=1e-2)
            msg = ""
        except ValueError as e:
            msg = str(e)
        try:
            ensemble_mesh(2 * r.world, device="cpu")
            too_many = ""
        except ValueError as e:
            too_many = str(e)
        r.save("divide", dict(message=msg, too_many=too_many))

    def sub_mesh():
        # a mesh over ranks 0 and 1 of the 4: the others are not in it
        mesh = ensemble_mesh(2, device="cpu")
        y0 = t(decay_y0())[:16]
        if mesh.get_coordinate() is None:
            try:
                ensemble_solve(lambda t_, y: -y, y0, 0.0, 1.0, mesh=mesh,
                               h0=1e-2)
                msg = ""
            except ValueError as e:
                msg = str(e)
            r.save("sub_mesh", dict(member=False, message=msg))
            return
        sol = ensemble_solve(lambda t_, y: -y, shard_batch(y0, mesh), 0.0,
                             1.0, ctl=ctl8, h0=1e-2, mesh=mesh)
        r.save("sub_mesh", dict(member=True,
                                y_final=sol.y_final.full_tensor().numpy(),
                                n_accept=sol.n_accept.full_tensor().numpy()))

    def efficiency():
        mesh = ensemble_mesh(device="cpu")
        sol = ensemble_solve(lambda t_, y, k: -k * y,
                             torch.ones(8, 1, dtype=F64), 0.0, 1.0,
                             params=t(stiff_rates()), ctl=ctl8, h0=1e-3,
                             mesh=mesh)
        r.save("efficiency", dict(
            per_shard=step_efficiency(sol, n_shards=4,
                                      per_shard=True).numpy(),
            total=step_efficiency(sol, n_shards=4).numpy(),
            n_iters=sol.n_iters.full_tensor().numpy()))

    def adjoint():
        import torch.distributed as dist

        M, z, theta = adjoint_inputs()
        basis = cplx.Cplx(t(M.real), t(M.imag))
        y0 = cplx.from_complex(z, F64, device="cpu")
        b = 16 // r.world

        def coeff(t_, th):
            return torch.stack([torch.ones_like(t_),
                                th[0] * torch.cos(th[1] * t_)], dim=-1)

        def value_and_grad(y):
            th = t(theta).requires_grad_(True)
            yf = diff.adjoint_solve(basis, coeff, th, y, 0.0, 1.0, 32,
                                    order=4)
            v = torch.sum(yf.re[:, 0] ** 2 + yf.im[:, 0] ** 2)
            (g,) = torch.autograd.grad(v, th)
            return torch.cat([v.detach().reshape(1), g])

        mine = value_and_grad(cplx.Cplx(y0.re[r.rank * b:(r.rank + 1) * b],
                                        y0.im[r.rank * b:(r.rank + 1) * b]))
        summed = mine.clone()
        dist.all_reduce(summed)
        r.save("adjoint", dict(summed=summed.numpy(),
                               replicated=value_and_grad(y0).numpy()))

    return [("decay", decay), ("pair", pair), ("fused_rk", fused_rk),
            ("magnus_loop", magnus_loop), ("generic", generic),
            ("params_h0", params_h0), ("params_exp", params_exp),
            ("events", events), ("divide", divide), ("sub_mesh", sub_mesh),
            ("efficiency", efficiency), ("adjoint", adjoint)]


def state_suite(r: Rank):
    """State sharding: (case, function) in the order every rank runs
    them."""
    from vec_ode_tpu_torch import StepControl
    from vec_ode_tpu_torch.models import DrivenDense
    from vec_ode_tpu_torch.ops import cplx
    from vec_ode_tpu_torch.parallel import (ensemble_mesh,
                                            ensemble_solve_state_sharded,
                                            local_rows, mesh_2d,
                                            solve_linear_state_sharded)

    def t(a):
        return torch.as_tensor(a, dtype=F64)

    def save(case, sol):
        from torch.distributed.tensor import DTensor

        arrays = {}
        for k in ("y_final", "ys", "ts", "t_final", "status", "n_accept",
                  "n_reject", "n_iters", "h_final"):
            a = getattr(sol, k)
            if isinstance(a, DTensor):
                arrays["placements." + k] = str(tuple(a.placements))
                arrays["local." + k] = a.to_local().numpy()
                a = a.full_tensor()
            arrays[k] = a.numpy()
        r.save(case, arrays)

    def const4():
        A, y0 = const_problem(64, 11, 0)
        mesh = ensemble_mesh(4, axis="state", device="cpu")
        sol = solve_linear_state_sharded(
            t(A), t(y0), 0.0, 1.0, mesh=mesh,
            ctl=StepControl(rtol=1e-8, max_dt=0.5), h0=1e-2)
        save("const4", sol)

    def const2d():
        A, y0 = const_problem(32, 12, 1, B=6)
        mesh = mesh_2d(2, 2, device="cpu")
        sol = ensemble_solve_state_sharded(
            t(A), t(y0), 0.0, 1.0, mesh=mesh,
            ctl=StepControl(rtol=1e-8, max_dt=0.5), h0=1e-2)
        save("const2d", sol)

    def assembly(d, seed):
        model = DrivenDense.make(d=d, seed=seed)
        return lambda t_: cplx.embed(model.op_pair(t_, F64, device="cpu"))

    def driven4():
        mesh = ensemble_mesh(4, axis="state", device="cpu")
        sol = solve_linear_state_sharded(
            local_rows(assembly(8, 3), mesh), t(driven_states(8, None, 5)),
            0.0, 1.0, mesh=mesh,
            ctl=StepControl(rtol=1e-8, min_dt=1e-7, max_dt=0.2), h0=1e-2)
        save("driven4", sol)

    def driven2d():
        mesh = mesh_2d(2, 2, device="cpu")
        sol = ensemble_solve_state_sharded(
            local_rows(assembly(4, 4), mesh, axis="state"),
            t(driven_states(4, 8, 6)), 0.0, 0.7, mesh=mesh,
            ctl=StepControl(rtol=1e-8, min_dt=1e-7, max_dt=0.2), h0=1e-2)
        save("driven2d", sol)

    def too_big():
        try:
            mesh_2d(4, 4, device="cpu")
            msg = ""
        except ValueError as e:
            msg = str(e)
        r.save("too_big", dict(message=msg))

    return [("const4", const4), ("const2d", const2d), ("driven4", driven4),
            ("driven2d", driven2d), ("too_big", too_big)]


SUITES = {"mesh": mesh_suite, "state": state_suite}


def main(argv) -> int:
    import torch.distributed as dist

    suite, out, rank, world = argv[0], pathlib.Path(argv[1]), int(argv[2]), \
        int(argv[3])
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out / 'store'}",
                            rank=rank, world_size=world)
    r = Rank(out, rank, world)
    failed = 0
    for case, fn in SUITES[suite](r):
        try:
            fn()
        except Exception:  # noqa: BLE001 - each case reports its own failure
            failed += 1
            (out / f"{case}.r{rank}.err").write_text(traceback.format_exc())
    dist.destroy_process_group()
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "vec_ode_tpu"))
    (out / f"done.r{rank}.json").write_text(json.dumps(
        {"bad_modules": bad, "failed": failed}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
